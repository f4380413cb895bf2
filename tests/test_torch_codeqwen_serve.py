"""The port's codeqwen1.5-7b stack against the JAX package, on the CPU.

At the codeqwen SMOKE config (2 layers, MHA 4 heads with the qkv bias,
d_model 64) in fp32 and bf16: the tests of ``torch_stack_parity`` (the
forward's logits and caches through both paths, two decode steps, greedy
serving, ``loss_fn`` and every gradient against the reference's, at the
tolerances its docstring states).
"""
import pytest

pytest.importorskip("torch")
from torch_stack_parity import (pair, test_decode_steps,  # noqa: E402,F401
                                test_forward_logits_aux_and_caches,
                                test_generate_greedy,
                                test_loss_fn_and_every_gradient_match_jax)

ARCH = "codeqwen1.5-7b"


@pytest.fixture(scope="module")
def arch():
    return ARCH


def test_smoke_config_has_the_qkv_bias(pair):
    assert pair.tcfg.qkv_bias and not pair.tcfg.n_experts
    assert sorted(pair.tp["blocks"][0]["attn"]) == [
        "bk", "bq", "bv", "wk", "wo", "wq", "wv"]
    assert float(pair.tp["blocks"][0]["attn"]["bq"].abs().max()) > 0
