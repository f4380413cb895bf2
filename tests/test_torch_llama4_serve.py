"""The port's llama4-maverick stack against the JAX package, on the CPU.

At the llama4-maverick SMOKE config (4 layers, dense and MoE 1:1: MoE of
8 experts top-1 with one shared expert on layers 1 and 3, 1s dispatch
in 2 groups; GQA 4/2, d_model 128) in fp32 and bf16: the tests of
``torch_stack_parity`` (the forward's logits, aux and caches through
both paths, two decode steps, greedy serving, ``loss_fn`` and every
gradient against the reference's, at the tolerances its docstring
states), each MoE call on the reference's routing. In bf16 top-1 routing
flips on near-ties: on the port's own routing its logits sit 1.80 from
the reference's against a max of 4.30, so the tests replay the
reference's routing and hold every row routed otherwise to a tie.
"""
import pytest

torch = pytest.importorskip("torch")
from repro_torch.models import transformer as ttf  # noqa: E402
from torch_stack_parity import (pair, test_decode_steps,  # noqa: E402,F401
                                test_forward_logits_aux_and_caches,
                                test_generate_greedy,
                                test_loss_fn_and_every_gradient_match_jax)

ARCH = "llama4-maverick-400b-a17b"


@pytest.fixture(scope="module")
def arch():
    return ARCH


def test_layers_alternate_dense_and_moe(pair):
    cfg = pair.tcfg
    assert [ttf.layer_kind(cfg, i) for i in range(cfg.n_layers)] == [
        ("attn", "mlp"), ("attn", "moe")] * 2
    moe = pair.tp["blocks"][1]["moe"]
    assert moe["we_gate"].shape[0] == cfg.n_experts == 8
    assert {"ws_gate", "ws_in", "ws_out"} <= set(moe)


def test_launch_serve_cuts_the_depth_on_the_cpu(capsys):
    """``launch/serve --layers 2``: the first two layers (one dense, one
    MoE) of the arch at its width, as the card serves llama4."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--layers", "2", "--device",
                "cpu", "--requests", "3", "--batch", "2", "--prompt-len",
                "24", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "llama4-maverick-smoke on cpu: 2 layers" in out
    assert "done: 9 tokens" in out
