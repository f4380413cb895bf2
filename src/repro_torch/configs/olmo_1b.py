"""olmo-1b [dense] — 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304,
non-parametric LN, tied embeddings. [arXiv:2402.00838; hf]
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50_304,
    norm_type="nonparam_ln",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="olmo-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    norm_type="nonparam_ln",
    tie_embeddings=True,
)
