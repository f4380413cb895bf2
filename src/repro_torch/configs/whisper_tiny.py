"""whisper-tiny [audio] — 4L d_model=384 6H d_ff=1536 vocab=51865, enc-dec,
conv frontend (stub). [arXiv:2212.04356; unverified]

The conv1d frame frontend is a stub: the caller passes precomputed
(B, S_enc, 384) frame embeddings as ``frontend_embeds`` (S_enc = seq_len
// 2, whisper's 2x conv downsampling), which a 4-layer bidirectional
encoder turns into the keys and values of every decoder layer's
cross-attention. Positions are RoPE, as in the rest of the stack, in
place of whisper's learned and sinusoidal embeddings.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    norm_type="layernorm",
    n_enc_layers=4,
    enc_seq_factor=2,
    frontend="audio_stub",
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    norm_type="layernorm",
    n_enc_layers=2,
    enc_seq_factor=2,
    frontend="audio_stub",
)
