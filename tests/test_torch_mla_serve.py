"""The port's MLA + MoE serving path against the JAX package, on the CPU.

At the deepseek-v2-lite SMOKE config (3 layers: one leading dense layer,
then two MoE layers; MLA attention, kv_lora 64; 8 experts top-2, 2
shared) in fp32 and bf16, with the weights of the reference's
``init_model(cfg, jax.random.key(0))`` carried across by
``params_from_numpy``: ``mla_forward`` and ``mla_decode``, ``forward``'s
logits, aux and raw ``ckv`` caches (the kernel path, which slots the MoE
records through bucket_slots' wrapper, its plain version here, and the
reference path), ``prefill_to_decode_cache``, ``decode_step`` over 6
tokens (and its kernel path's slot calls), greedy
``ServeEngine.generate``, ``loss_fn`` (forward only) and the weights'
round trips with ``first_k_dense = 1``.

Tolerances, as in ``test_torch_serve.py``: fp32 within rtol/atol 1e-5
(sums in another order) and the same greedy tokens; bf16 within 3e-2 *
max|ref|.

Routing is discrete, so where two experts' router probabilities tie to
within bf16's rounding, the two packages may pick apart, and one token's
output moves by a whole expert's. The stack-level comparisons therefore
record the reference's routing of every MoE call and run the port with
it (``torch_routing.same_routing``): every row the port routes otherwise
must be such a tie (its own probabilities of the two choices within
``torch_routing.TIE``), and in fp32 none may differ. The layer-level
tests of ``test_torch_moe.py`` run each package's own routing.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from torch_routing import recording as _recording  # noqa: E402
from torch_routing import same_routing as _same_routing  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
B, S, NEW = 2, 40, 6
CPU = torch.device("cpu")


@dataclasses.dataclass
class Pair:
    dtype: str
    jcfg: object
    tcfg: object
    jp: dict
    np_params: dict
    tp: object


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    dtype = request.param
    jcfg = dataclasses.replace(jregistry.get_smoke_config(ARCH), dtype=dtype,
                               param_dtype=dtype)
    tcfg = dataclasses.replace(tregistry.get_smoke_config(ARCH), dtype=dtype,
                               param_dtype=dtype)
    jp = jtf.init_model(jcfg, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jp)
    tp = convert.params_from_numpy(tcfg, np_params, CPU)
    return Pair(dtype, jcfg, tcfg, jp, np_params, tp)


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


def _ref_cache(cfg, caches, i):
    """Port layer i's cache in the reference's tree of caches."""
    top, key, b = convert._ref_layer(cfg, i)
    c = caches[top][key]
    return c if b is None else jax.tree.map(lambda a: a[b], c)


def test_layer_kinds(pair):
    cfg = pair.tcfg
    assert [ttf.layer_kind(cfg, i) for i in range(cfg.n_layers)] == \
        [jtf.layer_kind(pair.jcfg, i) for i in range(cfg.n_layers)] == \
        [("mla", "mlp"), ("mla", "moe"), ("mla", "moe")]
    assert sorted(pair.tp["blocks"][0]) == ["attn", "mlp", "norm1", "norm2"]
    assert sorted(pair.tp["blocks"][1]) == ["attn", "moe", "norm1", "norm2"]


def test_mla_forward_and_decode_match_jax(pair):
    """Layer 1's MLA on seeded activations: the prefill output and its
    ``ckv``, then one absorbed decode step at t = S against the padded
    cache, output and updated cache."""
    cfg, d = pair.tcfg, pair.dtype
    jp = pair.np_params["blocks"]["layer0"]["attn"]
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), jp)
    tp = pair.tp["blocks"][1]["attn"]
    rng = np.random.default_rng(1)
    jx, tx = _jt(rng.standard_normal((B, S, cfg.d_model), np.float32), d)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, jc = jattn.mla_forward(pair.jcfg, jp, jx, jnp.asarray(pos))
    got, tc = tattn.mla_forward(cfg, tp, tx, torch.from_numpy(pos.copy()))
    _close(got, want, d, "mla_forward")
    _close(tc["ckv"], jc["ckv"], d, "ckv")
    S_max = S + 8
    jx1, tx1 = _jt(rng.standard_normal((B, 1, cfg.d_model), np.float32), d)
    jcache = {"ckv": jnp.pad(jc["ckv"], ((0, 0), (0, S_max - S), (0, 0)))}
    tcache = {"ckv": torch.nn.functional.pad(tc["ckv"], (0, 0, 0, S_max - S))}
    want, jnew = jattn.mla_decode(pair.jcfg, jp, jx1, jcache, S)
    got, tnew = tattn.mla_decode(cfg, tp, tx1, tcache, S)
    assert tnew["ckv"] is tcache["ckv"]          # written in place
    _close(got, want, d, "mla_decode")
    _close(tnew["ckv"], jnew["ckv"], d, "decode ckv")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_aux_and_caches(pair, use_kernel):
    toks = _tokens(pair.tcfg)
    calls, flips = [], []
    with _recording(calls):
        want, jaux, jc = jtf.forward(pair.jcfg, pair.jp,
                                     {"tokens": jnp.asarray(toks)},
                                     use_pallas=use_kernel, want_cache=True)
    assert len(calls) == 2                       # the two MoE layers
    with _same_routing(calls, pair.dtype, flips):
        got, aux, tc = ttf.forward(pair.tcfg, pair.tp,
                                   {"tokens": torch.from_numpy(toks)},
                                   use_kernel=use_kernel, want_cache=True)
    assert got.dtype == getattr(torch, pair.dtype)
    _close(got, want, pair.dtype, "logits")
    assert float(aux) > 0
    _close(aux, jaux, pair.dtype, "aux")
    for i, c in enumerate(tc["blocks"]):
        assert list(c) == ["ckv"]
        _close(c["ckv"], _ref_cache(pair.tcfg, jc, i)["ckv"], pair.dtype,
               f"layer {i} ckv")
    with _same_routing(calls, pair.dtype, flips):
        last = ttf.prefill(pair.tcfg, pair.tp,
                           {"tokens": torch.from_numpy(toks)},
                           use_kernel=use_kernel)
    _close(last, want[:, -1:], pair.dtype, "prefill")


def test_prefill_to_decode_cache(pair):
    """The conversion alone, on the reference's own raw caches: equal,
    and the zero caches of ``init_cache`` in the same layout."""
    toks = _tokens(pair.tcfg)
    _, _, jc = jtf.forward(pair.jcfg, pair.jp, {"tokens": jnp.asarray(toks)},
                           want_cache=True)
    dt = getattr(torch, pair.dtype)
    for S_max in (S + 8, 2 * S):
        want = jengine.prefill_to_decode_cache(pair.jcfg, jc, S, S_max)
        raw = {"blocks": [
            {"ckv": torch.tensor(_np(_ref_cache(pair.tcfg, jc, i)["ckv"]))
             .to(dt)} for i in range(pair.tcfg.n_layers)]}
        got = tengine.prefill_to_decode_cache(pair.tcfg, raw, S, S_max)
        zero = ttf.init_cache(pair.tcfg, B, S_max, device=CPU)
        for i, c in enumerate(got["blocks"]):
            np.testing.assert_array_equal(
                _np(c["ckv"]), _np(_ref_cache(pair.tcfg, want, i)["ckv"]))
            z = zero["blocks"][i]["ckv"]
            assert z.shape == c["ckv"].shape and z.dtype == dt
    with pytest.raises(ValueError, match="does not fit"):
        tengine.prefill_to_decode_cache(pair.tcfg, raw, S, S - 1)


def test_decode_steps(pair):
    """Six decode steps against the converted caches: logits and every
    layer's ``ckv`` after each step (each package's prefill and steps
    first, with the reference's routing in the port's)."""
    toks = _tokens(pair.tcfg)
    nxt = _tokens(pair.tcfg, seed=2, n=NEW)
    S_max = S + NEW + 2
    calls, flips, want, got = [], [], [], []
    with _recording(calls):
        _, _, jc = jtf.forward(pair.jcfg, pair.jp,
                               {"tokens": jnp.asarray(toks)}, want_cache=True)
        jcache = jengine.prefill_to_decode_cache(pair.jcfg, jc, S, S_max)
        for step in range(NEW):
            logits, jcache = jtf.decode_step(
                pair.jcfg, pair.jp, jcache, jnp.asarray(nxt[:, step:step + 1]),
                S + step)
            want.append((logits, [_ref_cache(pair.tcfg, jcache, i)["ckv"]
                                  for i in range(pair.tcfg.n_layers)]))
    with _same_routing(calls, pair.dtype, flips):
        _, _, tc = ttf.forward(pair.tcfg, pair.tp,
                               {"tokens": torch.from_numpy(toks)},
                               want_cache=True)
        tcache = tengine.prefill_to_decode_cache(pair.tcfg, tc, S, S_max)
        for step in range(NEW):
            logits, tcache = ttf.decode_step(
                pair.tcfg, pair.tp, tcache,
                torch.from_numpy(nxt[:, step:step + 1]), S + step)
            got.append((logits, [c["ckv"].clone()
                                 for c in tcache["blocks"]]))
    for step, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
        _close(gl, wl, pair.dtype, f"decode logits {step}")
        for i, (g, w) in enumerate(zip(gc, wc)):
            _close(g, w, pair.dtype, f"step {step} layer {i} ckv")


def test_decode_step_slots_through_the_wrapper_only_on_the_kernel_path(
        pair, monkeypatch):
    """``decode_step(use_kernel=False)`` slots through the plain version
    only; ``use_kernel=True``, and the engine's step, call bucket_slots'
    wrapper 2 (G + 1) times an MoE layer, at the decode shapes (Tkg = B
    * k / G records at E = 1, cap at E = n_experts); all three give the
    same logits and caches."""
    import types
    calls, real = [], tmoe.slot_ops.bucket_slots

    def counting(ids, n, **kw):
        calls.append((ids.numel(), n))
        return real(ids, n, **kw)

    cfg = pair.tcfg
    toks = _tokens(cfg)
    _, _, raw = ttf.forward(cfg, pair.tp, {"tokens": torch.from_numpy(toks)},
                            want_cache=True)
    nxt = torch.from_numpy(_tokens(cfg, seed=2, n=1))
    engine = tengine.ServeEngine(cfg, pair.tp, max_len=S + 4, device=CPU)
    runs = {
        "plain": lambda c: ttf.decode_step(cfg, pair.tp, c, nxt, S),
        "kernel": lambda c: ttf.decode_step(cfg, pair.tp, c, nxt, S,
                                            use_kernel=True),
        "engine": lambda c: engine._step(pair.tp, c, nxt, S)}
    out = {}
    monkeypatch.setattr(tmoe, "slot_ops", types.SimpleNamespace(
        bucket_slots=counting))
    for name, run in runs.items():
        calls.clear()
        out[name] = run(tengine.prefill_to_decode_cache(cfg, raw, S, S + 4))
        G = max(1, min(cfg.dispatch_groups, B))
        Tkg = B // G * cfg.top_k
        cap = int(cfg.capacity_factor * Tkg) + 1
        moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        want = [] if name == "plain" else \
            [(Tkg, 1), (cap, cfg.n_experts)] * (G + 1) * moe_layers
        assert calls == want, name
    for name in ("kernel", "engine"):
        assert torch.equal(out[name][0], out["plain"][0]), name
        for got, ref in zip(out[name][1]["blocks"],
                            out["plain"][1]["blocks"]):
            assert torch.equal(got["ckv"], ref["ckv"]), name


def test_generate_greedy(pair):
    """The same greedy tokens as the reference's engine, with its routing
    of the prefill and of every decode step (ties apart, as above)."""
    prompts = _tokens(pair.tcfg, seed=3)
    max_len = S + NEW + 8
    calls, flips = [], []
    with _recording(calls):
        want = jengine.ServeEngine(pair.jcfg, pair.jp, max_len=max_len) \
            .generate(prompts, NEW)
    assert len(calls) == 2 * NEW                 # prefill + NEW - 1 steps
    with _same_routing(calls, pair.dtype, flips):
        got = tengine.ServeEngine(pair.tcfg, pair.tp, max_len=max_len,
                                  device=CPU).generate(prompts, NEW)
    assert got.shape == (B, NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_loss_fn_matches_jax(pair):
    """loss = ce + router_aux_coef * aux, forward only."""
    rng = np.random.default_rng(4)
    toks = rng.integers(0, pair.tcfg.vocab_size, (B, S + 1)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    tbatch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
              "labels": torch.from_numpy(toks[:, 1:].copy())}
    jloss, jm = jtf.loss_fn(pair.jcfg, pair.jp, jbatch)
    loss, m = ttf.loss_fn(pair.tcfg, pair.tp, tbatch)
    rtol = 1e-5 if pair.dtype == "float32" else 3e-2
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol)
    np.testing.assert_allclose(
        float(loss), float(m["ce"]) + pair.tcfg.router_aux_coef
        * float(m["aux"]), rtol=1e-6)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_params_round_trip(pair):
    """``params_to_numpy(params_from_numpy(tree)) == tree`` with the
    leading dense layer under ``dense_layers`` (bf16 as its bit
    patterns), and ``ref_tree`` / ``ref_leaves`` invert each other."""
    got = _flat(convert.params_to_numpy(pair.tcfg, pair.tp))
    want = _flat(pair.np_params)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("dense_layers/layer0/mlp/") for k in want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), k)
    names = [n for n, _ in pair.tp.named_parameters()]
    leaves = list(pair.tp.parameters())
    tree = convert.ref_tree(pair.tcfg, zip(names, leaves))
    assert tree["blocks"]["layer0"]["moe"]["we_gate"].shape[0] == \
        pair.tcfg.n_scan_blocks == 2
    assert "moe" not in tree["dense_layers"]["layer0"]
    back = convert.ref_leaves(pair.tcfg, tree, names)
    assert all(torch.equal(a, b) for a, b in zip(back, leaves))


def test_launch_serve_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--prompt-len", "24",
                "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "deepseek-v2-lite-smoke on cpu" in out
    assert "done: 9 tokens" in out


def test_training_the_stack_raises(pair):
    """The MoE and MLA stack trains (``test_torch_moe_train.py``), and
    so does its sharded train step (``test_torch_mesh_train*.py`` hold
    it to the reference's): under a (2, 4) mesh at a capacity no shard
    overflows, one step's loss equals the unsharded step's (rtol 1e-5
    in fp32, 2e-2 in bf16); and so does the cost-exact ``unroll=True``
    step's (``test_torch_costexact.py`` holds it to the reference's)."""
    from repro_torch import config as tconfig
    from repro_torch.distributed.mesh import local_mesh
    from repro_torch.train import train_step as tts
    cfg = dataclasses.replace(pair.tcfg, capacity_factor=8.0)
    run = tconfig.RunConfig(cfg, tconfig.ShapeConfig("t", S, B, "train"))
    batch = {k: torch.from_numpy(_tokens(cfg, seed)) for k, seed in
             (("tokens", 7), ("labels", 8))}
    losses = []
    for mesh, unroll in ((None, False), (local_mesh((2, 4), device=CPU),
                                         False), (None, True)):
        model = convert.params_from_numpy(cfg, pair.np_params, CPU)
        state = tts.init_train_state(cfg, run.train, model)
        step = tts.make_train_step(cfg, run, mesh=mesh,
                                   dp_entry=None if mesh is None else "data",
                                   unroll=unroll)
        losses.append(float(step(state, batch)[1]["loss"]))
    for got in losses[1:]:
        np.testing.assert_allclose(got, losses[0],
                                   rtol=1e-5 if pair.dtype == "float32"
                                   else 2e-2)
