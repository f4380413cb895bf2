"""The port's stablelm-12b stack against the JAX package, on the CPU.

At the stablelm SMOKE config (3 layers, LayerNorm, per-head
qk-norm, GQA 4/2, d_model 96) in fp32 and bf16: the tests of
``torch_stack_parity`` (the forward's logits and caches through both
paths, two decode steps, greedy serving, ``loss_fn`` and every gradient
against the reference's, at the tolerances its docstring states); and a
narrow config at stablelm-12b's head dim of 160 (2 layers, 2 heads, KV
1), whose kernel path (the plain version here) is held to the
reference's Pallas path in interpret mode, the cases of
``test_torch_serve.py::test_head_dim_80_forward_matches_jax``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as jtf  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from torch_stack_parity import DTYPES, close, make_pair  # noqa: E402
from torch_stack_parity import ref_cache, tokens  # noqa: E402
from torch_stack_parity import (pair, test_decode_steps,  # noqa: E402,F401
                                test_forward_logits_aux_and_caches,
                                test_generate_greedy,
                                test_loss_fn_and_every_gradient_match_jax)

ARCH = "stablelm-12b"
HD160 = dict(n_layers=2, d_model=320, n_heads=2, n_kv_heads=1, d_head=160,
             d_ff=192)


@pytest.fixture(scope="module")
def arch():
    return ARCH


def test_smoke_config_has_layernorm_and_qk_norm(pair):
    assert pair.tcfg.norm_type == "layernorm" and pair.tcfg.qk_norm
    layer = pair.tp["blocks"][0]
    assert sorted(layer["norm1"]) == ["scale"]
    assert {"q_norm", "k_norm"} <= set(layer["attn"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_head_dim_160_forward_matches_jax(dtype):
    """Logits and raw caches at head dim 160 through the kernel path (the
    plain version on the CPU) against the reference's Pallas path in
    interpret mode."""
    p = make_pair(ARCH, dtype, **HD160)
    assert p.tcfg.d_head == 160
    toks = tokens(p.tcfg, seed=4)
    want, _, jc = jtf.forward(p.jcfg, p.jp, {"tokens": jnp.asarray(toks)},
                              use_pallas=True, want_cache=True)
    got, _, tc = ttf.forward(p.tcfg, p.tp,
                             {"tokens": torch.from_numpy(toks)},
                             use_kernel=True, want_cache=True)
    close(got, want, dtype, "logits")
    for i, c in enumerate(tc["blocks"]):
        for name in ("k", "v"):
            close(c[name], ref_cache(p.tcfg, jc, i)[name], dtype,
                  f"layer {i} {name}")
    assert np.isfinite(got.float().numpy()).all()
