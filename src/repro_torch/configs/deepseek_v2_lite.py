"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 vocab=102400,
MoE 64e top-6, MLA kv_lora=512, 2 shared experts, 1 leading dense layer.
[arXiv:2405.04434; hf]

Assigned header says 64e top-6 (the trailing "160 routed" note is full V2);
we follow the primary spec. Lite has no q-LoRA (q is full-rank). The assigned
d_ff=1408 is kept verbatim for both the dense layer and the experts
(DESIGN.md §Config fidelity notes the public dense-ff is 10944).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    attn_type="mla",
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    d_head=192,                # nope + rope (query head width)
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_every=1,
    first_k_dense=1,
    d_ff_expert=1408,
    dispatch_mode="1s",
    block_pattern=1,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke",
    family="moe",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab_size=512,
    attn_type="mla",
    kv_lora_rank=64,
    qk_rope_dim=16,
    qk_nope_dim=32,
    v_head_dim=32,
    d_head=48,
    n_experts=8,
    n_shared_experts=2,
    top_k=2,
    moe_every=1,
    first_k_dense=1,
    d_ff_expert=192,
    dispatch_mode="1s",
    dispatch_groups=2,
    block_pattern=1,
)
