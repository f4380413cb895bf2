"""mamba2-780m [ssm] — 48L d_model=1536, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060; unverified]

d_inner = 2*d_model = 3072, head_dim 64 → 48 SSD heads, chunked scan 256.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    attn_type="none",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    attn_type="none",
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=16,
    tie_embeddings=True,
)
