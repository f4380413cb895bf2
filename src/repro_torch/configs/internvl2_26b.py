"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553, InternViT + InternLM2 backbone. [arXiv:2404.16821; hf]

The InternViT frontend is a stub: the caller passes precomputed
(B, S_img, 6144) patch embeddings as ``frontend_embeds``, which the
stack prepends to the text embeddings (early fusion). Only the
InternLM2-style decoder backbone is modelled. vocab 92553 is odd, so the
head's rows are not 16-byte aligned.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92_553,
    frontend="vision_stub",
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    n_layers=2,
    d_model=96,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=257,            # intentionally non-divisible, like the real one
    frontend="vision_stub",
)
