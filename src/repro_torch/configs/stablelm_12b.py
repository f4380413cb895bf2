"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-1_6b; hf]

StableLM-2-12B uses LayerNorm and per-head qk-norm.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100_352,
    norm_type="layernorm",
    qk_norm=True,
)

SMOKE = ModelConfig(
    name="stablelm-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    norm_type="layernorm",
    qk_norm=True,
)
