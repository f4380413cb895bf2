"""The port's serving path of the ssm family against the JAX package, on
the CPU.

At the mamba2-780m SMOKE config (2 layers, d_model 64, 8 SSD heads of
dim 16, ssm_state 16, chunk 16; prompts of 40 tokens, so the last chunk
is ragged), in fp32 and bf16, with the weights of the reference's
``init_model(cfg, jax.random.key(0))`` carried across by
``params_from_numpy``: the SSM block (kernel path against
``use_pallas=True``, reference path against ``use_pallas=False``, and a
second half continued from the first half's state and conv carries),
``forward`` logits and every raw cache leaf, ``prefill_to_decode_cache``,
two ``decode_step``s, greedy ``ServeEngine.generate`` and the launcher.

Tolerances: fp32 within rtol/atol 1e-5 (sums in another order) and the
same greedy tokens; bf16 within 3e-2 * max|ref|.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

ARCH = "mamba2-780m"
B, S, NEW = 2, 40, 6
CPU = torch.device("cpu")
LEAVES = ("state", "conv_x", "conv_B", "conv_C")


@dataclasses.dataclass
class Pair:
    dtype: str
    jcfg: object
    tcfg: object
    jp: dict
    tp: object


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    dtype = request.param
    jcfg = dataclasses.replace(jregistry.get_smoke_config(ARCH), dtype=dtype,
                               param_dtype=dtype)
    tcfg = dataclasses.replace(tregistry.get_smoke_config(ARCH), dtype=dtype,
                               param_dtype=dtype)
    jp = jtf.init_model(jcfg, jax.random.key(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), CPU)
    return Pair(dtype, jcfg, tcfg, jp, tp)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    else:
        err, lim = np.abs(got - want).max(), 3e-2 * np.abs(want).max()
        assert err <= lim, f"{what}: max abs err {err} > {lim}"


def _tokens(cfg, seed=0, n=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _jt(a, dtype):
    return jnp.asarray(a, jnp.dtype(dtype)), \
        torch.from_numpy(a).to(getattr(torch, dtype))


def _layer(pair, i=0):
    return (pair.tp["blocks"][i]["ssm"],
            jax.tree.map(lambda a: a[i], pair.jp["blocks"]["layer0"]["ssm"]))


def test_params_carry_the_ssm_leaves(pair):
    names = {"w_z", "w_x", "w_B", "w_C", "w_dt", "dt_bias", "conv_x",
             "conv_B", "conv_C", "A_log", "D_skip", "gate_norm", "w_out"}
    for i, blk in enumerate(pair.tp["blocks"]):
        assert set(blk.keys()) == {"norm1", "ssm"}
        assert set(blk["ssm"].keys()) == names
        tp, jp = _layer(pair, i)
        for name in names:
            np.testing.assert_array_equal(_np(tp[name]), _np(jp[name]))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_forward_matches(pair, use_kernel):
    cfg, d = pair.tcfg, pair.dtype
    jx, tx = _jt(np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model), np.float32), d)
    tp, jp = _layer(pair)
    got, gc = tssm.ssm_forward(cfg, tp, tx, use_kernel=use_kernel)
    want, wc = jssm.ssm_forward(pair.jcfg, jp, jx, use_pallas=use_kernel)
    assert got.dtype == getattr(torch, d) and gc["state"].dtype == \
        torch.float32
    _close(got, want, d, "ssm_forward")
    for name in LEAVES:
        _close(gc[name], wc[name], d, name)


def test_ssm_forward_continues_from_a_carry(pair):
    """The second half from the first half's state and conv carries, as
    the reference computes it (both paths)."""
    cfg, d = pair.tcfg, pair.dtype
    jx, tx = _jt(np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model), np.float32), d)
    tp, jp = _layer(pair)
    h = 24
    _, jc = jssm.ssm_forward(pair.jcfg, jp, jx[:, :h])
    _, tc = tssm.ssm_forward(cfg, tp, tx[:, :h])
    for use_kernel in (False, True):
        want, wc = jssm.ssm_forward(
            pair.jcfg, jp, jx[:, h:], use_pallas=use_kernel,
            init_state=jc["state"], conv_carry=jc)
        got, gc = tssm.ssm_forward(
            cfg, tp, tx[:, h:], use_kernel=use_kernel,
            init_state=tc["state"], conv_carry=tc)
        _close(got, want, d, f"continued, use_kernel={use_kernel}")
        for name in LEAVES:
            _close(gc[name], wc[name], d, name)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_and_caches(pair, use_kernel):
    toks = _tokens(pair.tcfg)
    want, _, jc = jtf.forward(pair.jcfg, pair.jp,
                              {"tokens": jnp.asarray(toks)},
                              use_pallas=use_kernel, want_cache=True)
    got, aux, tc = ttf.forward(pair.tcfg, pair.tp,
                               {"tokens": torch.from_numpy(toks)},
                               use_kernel=use_kernel, want_cache=True)
    assert got.dtype == getattr(torch, pair.dtype) and float(aux) == 0.0
    _close(got, want, pair.dtype, "logits")
    for i, c in enumerate(tc["blocks"]):
        assert set(c) == set(LEAVES)
        for name in LEAVES:
            _close(c[name], jc["blocks"]["layer0"][name][i], pair.dtype,
                   f"layer {i} {name}")
    _close(ttf.prefill(pair.tcfg, pair.tp,
                       {"tokens": torch.from_numpy(toks)},
                       use_kernel=use_kernel),
           want[:, -1:], pair.dtype, "prefill")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_raw_cache_holds_only_its_own_bytes(pair, use_kernel):
    """No leaf of a prefill's cache is a view into a larger activation:
    a conv carry sliced from the padded input would keep that whole
    (B, S + K - 1, C) tensor alive, for every layer, while the cache
    lives."""
    toks = torch.from_numpy(_tokens(pair.tcfg))
    _, _, tc = ttf.forward(pair.tcfg, pair.tp, {"tokens": toks},
                           use_kernel=use_kernel, want_cache=True)
    for i, c in enumerate(tc["blocks"]):
        for name in LEAVES:
            t = c[name]
            assert t.untyped_storage().nbytes() == \
                t.numel() * t.element_size(), f"layer {i} {name}"


def test_prefill_to_decode_cache(pair):
    """The conversion alone, on the reference's own raw caches: equal
    (the ssm layers' raw cache is the decode layout), and the zero cache
    has the same leaves, shapes and types."""
    toks = _tokens(pair.tcfg)
    _, _, jc = jtf.forward(pair.jcfg, pair.jp, {"tokens": jnp.asarray(toks)},
                           want_cache=True)
    want = jengine.prefill_to_decode_cache(pair.jcfg, jc, S, S + 8)
    zero = ttf.init_cache(pair.tcfg, B, S + 8, device=CPU)
    raw = {"blocks": [
        {n: torch.tensor(_np(jc["blocks"]["layer0"][n][i])).to(
            zero["blocks"][i][n].dtype) for n in LEAVES}
        for i in range(pair.tcfg.n_layers)]}
    got = tengine.prefill_to_decode_cache(pair.tcfg, raw, S, S + 8)
    for i, c in enumerate(got["blocks"]):
        for n in LEAVES:
            w = want["blocks"]["layer0"][n][i]
            np.testing.assert_array_equal(_np(c[n]), _np(w))
            assert zero["blocks"][i][n].shape == tuple(w.shape)
            assert str(zero["blocks"][i][n].dtype)[6:] == str(w.dtype)


def test_decode_step(pair):
    toks = _tokens(pair.tcfg)
    nxt = _tokens(pair.tcfg, seed=2, n=2)
    S_max = S + 8
    _, _, jc = jtf.forward(pair.jcfg, pair.jp, {"tokens": jnp.asarray(toks)},
                           want_cache=True)
    jcache = jengine.prefill_to_decode_cache(pair.jcfg, jc, S, S_max)
    _, _, tc = ttf.forward(pair.tcfg, pair.tp,
                           {"tokens": torch.from_numpy(toks)},
                           use_kernel=True, want_cache=True)
    tcache = tengine.prefill_to_decode_cache(pair.tcfg, tc, S, S_max)
    for step in range(2):
        want, jcache = jtf.decode_step(pair.jcfg, pair.jp, jcache,
                                       jnp.asarray(nxt[:, step:step + 1]),
                                       S + step)
        got, tcache = ttf.decode_step(pair.tcfg, pair.tp, tcache,
                                      torch.from_numpy(nxt[:, step:step + 1]),
                                      S + step)
        _close(got, want, pair.dtype, f"decode logits {step}")
        for i, c in enumerate(tcache["blocks"]):
            for n in LEAVES:
                _close(c[n], jcache["blocks"]["layer0"][n][i], pair.dtype,
                       f"step {step} layer {i} {n}")


def test_generate_greedy(pair):
    prompts = _tokens(pair.tcfg, seed=3)
    max_len = S + NEW + 8
    want = jengine.ServeEngine(pair.jcfg, pair.jp, max_len=max_len) \
        .generate(prompts, NEW)
    got = tengine.ServeEngine(pair.tcfg, pair.tp, max_len=max_len,
                              device=CPU).generate(prompts, NEW)
    assert got.shape == (B, NEW) and got.dtype == np.int32
    if pair.dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    # bf16: every served token is a maximum, within the tolerance, of the
    # reference's logits for the sequence the port served
    seq = np.concatenate([prompts, got[:, :-1]], 1)
    logits, _ = jtf.forward(pair.jcfg, pair.jp, {"tokens": jnp.asarray(seq)})
    logits = _np(logits)[:, S - 1:]
    picked = np.take_along_axis(logits, got[..., None], -1)[..., 0]
    lim = 3e-2 * np.abs(logits).max()
    assert (logits.max(-1) - picked).max() <= lim


def test_launch_serve_mamba2_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--prompt-len", "40",
                "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "mamba2-smoke on cpu" in out
    assert "done: 9 tokens" in out


def test_full_config_is_the_published_shape():
    cfg = tregistry.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.n_ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_conv,
            cfg.ssm_chunk, cfg.vocab_size) == (48, 1536, 3072, 48, 64, 128,
                                               1, 4, 256, 50_280)
    assert cfg.tie_embeddings and ttf.layer_kind(cfg, 47) == ("ssm", "none")
    assert 7.5e8 < cfg.param_count() < 8.5e8
