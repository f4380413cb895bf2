"""The port's internvl2-26b stack against the JAX package, on the CPU.

At the internvl2 SMOKE config (2 layers, GQA 4/2, d_model 96, an odd
vocab of 257, like the real one's 92,553) in fp32 and bf16, with the
same seeded fp32 vision prefix of 16 rows (the reference's launcher's)
through both packages: the tests of ``torch_stack_parity`` (the
forward's logits over prefix and text and every cache through both
paths, two decode steps after the prefix's positions, greedy serving
with ``frontend_embeds``, ``loss_fn`` and every gradient on text-only
labels, at the tolerances its docstring states); the prefix prepended in
the model dtype; the loss on the text positions alone; and the launcher,
whose cache arithmetic leaves the last decode steps past the cache's
end, as the reference's does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_parity  # noqa: E402,F401  (each xdist worker's core share)
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from torch_stack_parity import (B, CPU, FE_LEN, S, batches,  # noqa: E402
                                frontend, make_pair, same_dtype, tokens)
from torch_stack_parity import (pair, test_decode_steps,  # noqa: E402,F401
                                test_forward_logits_aux_and_caches,
                                test_generate_greedy,
                                test_loss_fn_and_every_gradient_match_jax)

ARCH = "internvl2-26b"


@pytest.fixture(scope="module")
def arch():
    return ARCH


def test_smoke_config_has_a_vision_prefix_and_an_odd_vocab(pair):
    cfg = pair.tcfg
    assert cfg.frontend == "vision_stub" and not cfg.n_enc_layers
    assert cfg.vocab_size % 2 == 1 and cfg.n_heads // cfg.n_kv_heads == 2
    assert "enc_blocks" not in pair.tp
    assert tuple(pair.tp["lm_head"].shape) == (cfg.d_model, 257)


def test_prefix_is_prepended_in_the_model_dtype(pair):
    """The fp32 prefix is cast to the model dtype and prepended: the
    logits cover its 16 positions and the text's, and the text's last
    position differs from a text-only forward's."""
    toks, fe = tokens(pair.tcfg), frontend(pair.tcfg)
    jb, tb = batches(toks, fe)
    with torch.no_grad():
        got, _, tc = ttf.forward(pair.tcfg, pair.tp, tb, want_cache=True)
        alone, _ = ttf.forward(pair.tcfg, pair.tp, {"tokens": tb["tokens"]})
    want, _ = jtf.forward(pair.jcfg, pair.jp, jb)
    n = FE_LEN["vision_stub"]
    assert tuple(got.shape) == (B, n + S, pair.tcfg.vocab_size)
    same_dtype(got, want, "logits")
    assert tc["blocks"][0]["k"].shape[1] == n + S
    assert tc["blocks"][0]["k"].dtype == getattr(torch, pair.dtype)
    assert not torch.allclose(got[:, -1].float(), alone[:, -1].float())


def test_loss_is_on_the_text_positions_alone(pair):
    """``loss_fn`` with a prefix is the cross entropy of the text
    positions' logits alone, as the reference's."""
    rng = np.random.default_rng(9)
    toks = rng.integers(0, pair.tcfg.vocab_size, (B, S + 1)).astype(np.int32)
    fe = frontend(pair.tcfg, seed=10)
    jb, tb = batches(toks[:, :-1], fe, labels=toks[:, 1:])
    with torch.no_grad():
        loss, m = ttf.loss_fn(pair.tcfg, pair.tp, tb)
        logits, _ = ttf.forward(pair.tcfg, pair.tp, tb)
    text = logits[:, FE_LEN["vision_stub"]:].float()
    ce = torch.nn.functional.cross_entropy(
        text.reshape(-1, text.shape[-1]), tb["labels"].reshape(-1).long())
    np.testing.assert_allclose(float(m["ce"]), float(ce), rtol=1e-5)
    jloss, _ = jtf.loss_fn(pair.jcfg, pair.jp, jb)
    rtol = 1e-5 if pair.dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)


def test_decode_past_the_cache_end_clamps_as_the_reference():
    """The launcher's arithmetic: a cache of prompt + new + 8 positions
    holds 16 prefix rows, so the last steps run past its end; both
    packages overwrite its last slot (``dynamic_update_slice`` clamps)
    and greedy serving gives the same tokens (fp32)."""
    pair = make_pair(ARCH, "float32")
    prompts = tokens(pair.tcfg, seed=11, n=12)
    fe = frontend(pair.tcfg, seed=12)
    new = 12
    max_len = 12 + new + 8            # S_ctx = 28: steps 4-10 run past
    want = jengine.ServeEngine(pair.jcfg, pair.jp, max_len=max_len) \
        .generate(prompts, new, frontend_embeds=fe)
    got = tengine.ServeEngine(pair.tcfg, pair.tp, max_len=max_len,
                              device=CPU).generate(prompts, new,
                                                   frontend_embeds=fe)
    np.testing.assert_array_equal(got, want)


def test_launch_serve_on_the_cpu(capsys):
    """The launcher serves the SMOKE stack to the end with 16 seeded
    prefix rows a request."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--prompt-len", "24",
                "--new-tokens", "10"])
    out = capsys.readouterr().out
    assert "internvl2-smoke on cpu: 2 layers" in out
    assert "done: 30 tokens" in out


def test_a_prefix_that_does_not_fit_the_cache_raises(pair):
    cfg = pair.tcfg
    eng = tengine.ServeEngine(cfg, pair.tp, max_len=20, device=CPU)
    with pytest.raises(ValueError, match="does not fit"):
        eng.generate(tokens(cfg, n=8), 2, frontend_embeds=frontend(cfg))
