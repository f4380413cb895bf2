"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Public Maverick interleaves dense/MoE 1:1 with one shared expert, which is
what makes 400B-total / 17B-active consistent with the assigned dims
(48 all-MoE layers would be ≈770B) — see DESIGN.md §Config fidelity.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    rope_theta=500_000.0,
    n_experts=128,
    n_shared_experts=1,
    top_k=1,
    moe_every=2,               # dense/MoE 1:1 interleave
    d_ff_expert=8192,
    dispatch_mode="1s",
    block_pattern=2,
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    family="moe",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    n_experts=8,
    n_shared_experts=1,
    top_k=1,
    moe_every=2,
    d_ff_expert=256,
    dispatch_mode="1s",
    dispatch_groups=2,
    block_pattern=2,
)
