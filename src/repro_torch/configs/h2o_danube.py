"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]

SWA window 4096 (mistral-style) → qualifies for the long_500k cell.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32_000,
    attn_type="swa",
    sliding_window=4096,
)

SMOKE = ModelConfig(
    name="h2o-danube-smoke",
    family="dense",
    n_layers=2,
    d_model=80,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    attn_type="swa",
    sliding_window=32,
)
