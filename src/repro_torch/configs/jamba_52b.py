"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba+attention 1:7 interleave.
[arXiv:2403.19887; hf]

Period-8 super-block: attention at slot 4 (attn_offset=4), Mamba elsewhere;
MoE replaces the MLP on odd slots (every 2nd layer). The Mamba layers use
the stack's SSD (Mamba-2) block with d_state=16 — DESIGN.md records this
Mamba-1→SSD substitution as a hardware adaptation (the SSD chunked form is
the TPU-native formulation).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65_536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    d_ff_expert=14336,
    dispatch_mode="1s",
    attn_every=8,
    attn_offset=4,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    block_pattern=8,
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    n_experts=4,
    top_k=2,
    moe_every=2,
    d_ff_expert=128,
    dispatch_mode="1s",
    dispatch_groups=2,
    attn_every=8,
    attn_offset=4,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=16,
    block_pattern=8,
)
