"""The port's serving path against the JAX package, on the CPU.

At the olmo-1b and h2o-danube SMOKE configs, in fp32 and bf16, with the
weights of the reference's ``init_model(cfg, jax.random.key(0))``
carried across by ``params_from_numpy``: the layers, ``forward`` logits
and raw caches (kernel path against ``use_pallas=True``, reference path
against ``use_pallas=False``), ``prefill_to_decode_cache``,
``decode_step`` and greedy ``ServeEngine.generate``.

Tolerances: fp32 within rtol/atol 1e-5 (sums in another order) and the
same greedy tokens; bf16 within 3e-2 * max|ref| (the reference's own
Pallas/ref logit gap is 0.013 of 0.68 and 0.057 of 5.06 here).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

ARCHS = ("olmo-1b", "h2o-danube-1.8b")
# the ssm family: test_torch_ssm_serve; MoE + MLA: test_torch_mla_serve;
# the hybrid: test_torch_hybrid_serve; codeqwen, stablelm and llama4:
# test_torch_{codeqwen,stablelm,llama4}_serve
ALL_ARCHS = ARCHS + ("mamba2-780m", "deepseek-v2-lite-16b",
                     "jamba-v0.1-52b", "codeqwen1.5-7b", "stablelm-12b",
                     "llama4-maverick-400b-a17b", "whisper-tiny",
                     "internvl2-26b")
B, S, NEW = 2, 96, 6
CPU = torch.device("cpu")


@dataclasses.dataclass
class Pair:
    dtype: str
    jcfg: object
    tcfg: object
    jp: dict
    tp: object


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    arch, dtype = request.param
    jcfg = dataclasses.replace(jregistry.get_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype)
    tcfg = dataclasses.replace(tregistry.get_smoke_config(arch), dtype=dtype,
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


def test_layers_match(pair):
    cfg, d = pair.tcfg, pair.dtype
    rng = np.random.default_rng(1)
    jx, tx = _jt(rng.standard_normal((B, S, cfg.d_model), np.float32), d)
    norm = pair.tp["blocks"][0]["norm1"]
    jnorm = jax.tree.map(lambda a: a[0], pair.jp["blocks"]["layer0"]["norm1"])
    assert set(norm) == set(jnorm)
    _close(tl.apply_norm(cfg, norm, tx), jl.apply_norm(pair.jcfg, jnorm, jx),
           d, "apply_norm")
    jh, th = _jt(rng.standard_normal((B, S, 4, cfg.d_head), np.float32), d)
    pos = rng.integers(0, 4096, (B, S)).astype(np.int32)
    _close(tl.apply_rope(th.transpose(1, 2), torch.from_numpy(pos)[:, None],
                         cfg.rope_theta).transpose(1, 2),
           jl.apply_rope(jh.swapaxes(1, 2), jnp.asarray(pos)[:, None],
                         cfg.rope_theta).swapaxes(1, 2), d, "apply_rope")
    jmlp = jax.tree.map(lambda a: a[0], pair.jp["blocks"]["layer0"]["mlp"])
    _close(tl.apply_mlp(pair.tp["blocks"][0]["mlp"], tx),
           jl.apply_mlp(jmlp, jx), d, "apply_mlp")


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
        for name in ("k", "v"):
            _close(c[name], jc["blocks"]["layer0"][name][i], pair.dtype,
                   f"layer {i} {name}")
    _close(ttf.prefill(pair.tcfg, pair.tp,
                       {"tokens": torch.from_numpy(toks)},
                       use_kernel=use_kernel),
           want[:, -1:], pair.dtype, "prefill")


def test_prefill_to_decode_cache(pair):
    """The conversion alone, on the reference's own raw caches: equal."""
    toks = _tokens(pair.tcfg)
    _, _, jc = jtf.forward(pair.jcfg, pair.jp, {"tokens": jnp.asarray(toks)},
                           want_cache=True)
    for S_max in (S + 8, 2 * S):
        want = jengine.prefill_to_decode_cache(pair.jcfg, jc, S, S_max)
        raw = {"blocks": [
            {n: torch.tensor(_np(jc["blocks"]["layer0"][n][i])).to(
                getattr(torch, pair.dtype)) for n in ("k", "v")}
            for i in range(pair.tcfg.n_layers)]}
        got = tengine.prefill_to_decode_cache(pair.tcfg, raw, S, S_max)
        for i, c in enumerate(got["blocks"]):
            for n in ("k", "v"):
                np.testing.assert_array_equal(
                    _np(c[n]), _np(want["blocks"]["layer0"][n][i]))


def test_decode_step(pair):
    toks = _tokens(pair.tcfg)
    nxt = _tokens(pair.tcfg, seed=2, n=2)
    S_max = S + 8
    _, _, jc = jtf.forward(pair.jcfg, pair.jp, {"tokens": jnp.asarray(toks)},
                           want_cache=True)
    jcache = jengine.prefill_to_decode_cache(pair.jcfg, jc, S, S_max)
    _, _, tc = ttf.forward(pair.tcfg, pair.tp,
                           {"tokens": torch.from_numpy(toks)},
                           want_cache=True)
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
            for n in ("k", "v"):
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


def test_generate_past_the_cache_end_matches_jax():
    """Decoding past ``max_len``: the reference's dynamic_update_slice
    clamps the write to the last slot, and so must the port (an empty
    slice would drop the new key and value). olmo-1b SMOKE in fp32, 2
    prompts of 16 tokens, max_len 18 < 16 + 8 - 1."""
    jcfg = dataclasses.replace(jregistry.get_smoke_config("olmo-1b"),
                               dtype="float32", param_dtype="float32")
    tcfg = dataclasses.replace(tregistry.get_smoke_config("olmo-1b"),
                               dtype="float32", param_dtype="float32")
    jp = jtf.init_model(jcfg, jax.random.key(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), CPU)
    prompts = _tokens(tcfg, seed=0, n=16)
    want = jengine.ServeEngine(jcfg, jp, max_len=18).generate(prompts, 8)
    got = tengine.ServeEngine(tcfg, tp, max_len=18,
                              device=CPU).generate(prompts, 8)
    np.testing.assert_array_equal(got, want)


HD80 = dict(n_layers=2, n_heads=2, n_kv_heads=1, d_head=80)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def hd80(request):
    """A narrow h2o-like config at h2o-danube-1.8b's head dim of 80 (2
    layers, 2 heads, KV 1, window 32 over 96-token prompts), with the
    reference's weights carried across."""
    dtype = request.param
    jcfg = dataclasses.replace(jregistry.get_smoke_config("h2o-danube-1.8b"),
                               dtype=dtype, param_dtype=dtype, **HD80)
    tcfg = dataclasses.replace(tregistry.get_smoke_config("h2o-danube-1.8b"),
                               dtype=dtype, param_dtype=dtype, **HD80)
    assert tcfg.d_head == 80 and tcfg.attn_type == "swa"
    jp = jtf.init_model(jcfg, jax.random.key(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), CPU)
    return Pair(dtype, jcfg, tcfg, jp, tp)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_head_dim_80_forward_matches_jax(hd80, use_kernel):
    """Logits and raw caches at head dim 80, the kernel path (the plain
    version on the CPU) against the reference's Pallas path in interpret
    mode, the reference path against its reference path."""
    toks = _tokens(hd80.tcfg, seed=4)
    want, _, jc = jtf.forward(hd80.jcfg, hd80.jp,
                              {"tokens": jnp.asarray(toks)},
                              use_pallas=use_kernel, want_cache=True)
    got, _, tc = ttf.forward(hd80.tcfg, hd80.tp,
                             {"tokens": torch.from_numpy(toks)},
                             use_kernel=use_kernel, want_cache=True)
    _close(got, want, hd80.dtype, "logits")
    # the caches in fp32 at 1e-5 * max|cache|: k is rotated by fp32 angles
    # of up to 95 rad, where both libraries sit ~1.1e-5 from a float64
    # rope (and 1.3e-5 from each other) at |k| ~ 1
    for i, c in enumerate(tc["blocks"]):
        for name in ("k", "v"):
            g = _np(c[name])
            w = _np(jc["blocks"]["layer0"][name][i])
            lim = (1e-5 if hd80.dtype == "float32" else 3e-2) \
                * np.abs(w).max()
            assert np.abs(g - w).max() <= lim, (i, name)


def test_head_dim_80_generate_matches_jax(hd80):
    """Greedy serving at head dim 80: the same tokens in fp32; in bf16
    every served token a maximum, within 3e-2 * max|logits|, of the
    reference's logits for the sequence the port served."""
    prompts = _tokens(hd80.tcfg, seed=5)
    max_len = S + NEW + 8
    want = jengine.ServeEngine(hd80.jcfg, hd80.jp, max_len=max_len) \
        .generate(prompts, NEW)
    got = tengine.ServeEngine(hd80.tcfg, hd80.tp, max_len=max_len,
                              device=CPU).generate(prompts, NEW)
    assert got.shape == (B, NEW)
    if hd80.dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    seq = np.concatenate([prompts, got[:, :-1]], 1)
    logits, _ = jtf.forward(hd80.jcfg, hd80.jp, {"tokens": jnp.asarray(seq)})
    logits = _np(logits)[:, S - 1:]
    picked = np.take_along_axis(logits, got[..., None], -1)[..., 0]
    assert (logits.max(-1) - picked).max() <= 3e-2 * np.abs(logits).max()


def test_temperature_sampling_follows_the_seed():
    cfg = tregistry.get_smoke_config("olmo-1b")
    eng = tengine.ServeEngine(cfg, ttf.init_model(cfg, 0, device=CPU),
                              max_len=40, device=CPU)
    prompts = _tokens(cfg, n=16)
    a, b, c = (eng.generate(prompts, 8, greedy=False, temperature=0.8,
                            seed=s) for s in (5, 5, 6))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < cfg.vocab_size


def test_generate_stops_at_eos():
    cfg = tregistry.get_smoke_config("olmo-1b")
    model = ttf.init_model(cfg, 0, device=CPU)
    prompts = _tokens(cfg, n=16)[:1]
    full = tengine.ServeEngine(cfg, model, max_len=40, device=CPU) \
        .generate(prompts, 8)[0]
    eos = int(full[2])
    stop = 1 + next(i for i, t in enumerate(full[1:]) if t == eos)
    got = tengine.ServeEngine(cfg, model, max_len=40, device=CPU,
                              eos_id=eos).generate(prompts, 8)[0]
    np.testing.assert_array_equal(got, full[:stop + 1])


def test_configs_are_the_reference_configs():
    for arch in ALL_ARCHS:
        for get in ("get_config", "get_smoke_config"):
            t = getattr(tregistry, get)(arch)
            j = getattr(jregistry, get)(arch)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.param_count() == j.param_count()
    assert set(tregistry.ARCH_IDS) == set(ALL_ARCHS)
    assert tregistry.ARCH_IDS == jregistry.ARCH_IDS
    fields = {f.name for f in dataclasses.fields(jconfig.ModelConfig)}
    assert fields == {f.name for f in dataclasses.fields(
        tconfig.ModelConfig)}


def test_cells_are_the_reference_cells():
    """The port's cell matrix over its archs: ``shape_cells``,
    ``cell_status`` of every arch and shape, and ``runnable_cells`` with
    and without the skips equal to the reference's rows of those archs,
    in the reference's order."""
    assert tregistry.shape_cells() == {
        k: tconfig.ShapeConfig(**dataclasses.asdict(v))
        for k, v in jregistry.shape_cells().items()}
    for arch in ALL_ARCHS:
        for name, shape in tregistry.shape_cells().items():
            assert tregistry.cell_status(tregistry.get_config(arch), shape) \
                == jregistry.cell_status(
                    jregistry.get_config(arch),
                    jregistry.shape_cells()[name]), (arch, name)
    for skips in (False, True):
        want = [c for c in jregistry.runnable_cells(skips)
                if c[0] in ALL_ARCHS]
        assert tregistry.runnable_cells(skips) == want
    assert ("stablelm-12b", "long_500k", False) == \
        tregistry.runnable_cells(True)[11][:3]


@pytest.mark.parametrize("what", ["hybrid", "moe", "mla", "first_k_dense",
                                  "encoder", "frontend", "unroll"])
def test_unported_parts_raise(what):
    """What the port once left out now runs. The cost-exact unrolled
    attention (``unroll``, the encoder's and the cross-attention's too)
    gives the chunked path's forward within fp32 rounding
    (``test_torch_costexact.py`` holds it to the reference's). The
    other cases hold what the mesh now runs (held to the reference's
    ``shard_map`` in ``test_torch_mesh_*.py``): under a (2, 4) mesh at
    a capacity no shard overflows, the MoE layer, the hybrid stack and
    the vision prefix compute the unpartitioned function, MLA decode
    over a seq-sharded cache gives the unsharded output and cache, and
    deepseek-v2-lite's decode step (a leading dense layer, then expert
    layers dispatched replicated) the unsharded logits."""
    from repro_torch.distributed.mesh import local_mesh
    from repro_torch.models import attention as tattn
    from repro_torch.models import moe as tmoe
    mesh = local_mesh((2, 4), device=CPU)

    def smoke(arch):
        return dataclasses.replace(tregistry.get_smoke_config(arch),
                                   dtype="float32", param_dtype="float32",
                                   capacity_factor=8.0)
    cfg, ds = smoke("olmo-1b"), smoke("deepseek-v2-lite-16b")
    toks = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 8)).astype(np.int32))}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, ds.d_model)).astype(np.float32))

    def same(a, b):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
    if what in ("encoder", "unroll"):
        c = smoke("whisper-tiny") if what == "encoder" else cfg
        batch = dict(toks, frontend_embeds=torch.from_numpy(
            np.random.default_rng(2).standard_normal(
                (2, 4, c.d_model)).astype(np.float32)))
        model = ttf.init_model(c, 0, device=CPU)
        got = ttf.forward(c, model, batch, unroll=True)
        want = ttf.forward(c, model, batch)
        same(got[0], want[0])
        same(got[1], want[1])
    elif what in ("hybrid", "frontend"):
        c = smoke("jamba-v0.1-52b" if what == "hybrid" else "internvl2-26b")
        batch = dict(toks, frontend_embeds=torch.from_numpy(
            np.random.default_rng(2).standard_normal(
                (2, 4, c.d_model)).astype(np.float32)))
        model = ttf.init_model(c, 0, device=CPU)
        want = ttf.forward(c, model, batch)
        got = ttf.forward(c, model, batch, mesh=mesh, dp_entry="data")
        same(got[0], want[0])
        same(got[1], want[1])
    else:
        model = ttf.init_model(ds, 0, device=CPU)
        layer = model["blocks"][1]
        if what == "moe":
            for a, b in zip(tmoe.moe_forward(ds, layer["moe"], x, mesh=mesh,
                                             dp_entry="data"),
                            tmoe.moe_forward(ds, layer["moe"], x)):
                same(a, b)
        elif what == "mla":
            caches = [ttf.init_cache(ds, 2, 16, device=CPU)["blocks"][1]
                      for _ in range(2)]
            for c in caches:
                c["ckv"].copy_(torch.from_numpy(np.random.default_rng(
                    3).standard_normal(c["ckv"].shape).astype(np.float32)))
            got = tattn.mla_decode(ds, layer["attn"], x[:, :1], caches[0],
                                   8, mesh=mesh, dp_entry="data")
            want = tattn.mla_decode(ds, layer["attn"], x[:, :1], caches[1],
                                    8)
            same(got[0], want[0])
            assert torch.equal(caches[0]["ckv"], caches[1]["ckv"])
        else:
            cache = ttf.init_cache(ds, 2, 16, device=CPU)
            tok = toks["tokens"][:, :1]
            got = ttf.decode_step(ds, model, cache, tok, 3, mesh=mesh,
                                  dp_entry="data")[0]
            want = ttf.decode_step(ds, model, ttf.init_cache(
                ds, 2, 16, device=CPU), tok, 3)[0]
            same(got, want)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tregistry.get_smoke_config("olmo-1b")
    model = ttf.init_model(cfg, 0, device="cpu")
    for call in (lambda: ttf.init_model(cfg, 0),
                 lambda: tengine.ServeEngine(cfg, model, max_len=16),
                 lambda: ttf.init_cache(cfg, 1, 16),
                 lambda: serve.main(["--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_launch_serve_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "h2o-danube-1.8b", "--smoke", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--prompt-len", "40",
                "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "h2o-danube-smoke on cpu" in out
    assert "done: 9 tokens" in out
