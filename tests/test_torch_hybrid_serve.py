"""The port's hybrid stack (jamba) against the JAX package, on the CPU.

At the jamba SMOKE config (8 layers, one super-block: SSD layers at slots
0-3 and 5-7 with state 16 and chunk 16, GQA attention 4/2 at slot 4; MoE
of 4 experts top-2 on the odd slots, MLP on the even ones), with the
weights of the reference's ``init_model(cfg, jax.random.key(0))``
carried across by ``params_from_numpy``: the layer kinds and the
weights' round trip (fp32 and bf16) and the super-block mapping (layer
``b * 8 + j`` is ``blocks/layer{j}[b]``); each layer on the reference's
input of that layer, prefill and one decode step, its output, aux and
caches (fp32 and bf16); in fp32 the whole stack: ``forward``'s logits,
aux and every layer's raw cache (SSD state and conv carries, attention
k/v; the kernel path, ``use_kernel=True``, and the reference path),
``decode_step`` over 6 tokens and greedy ``ServeEngine.generate``; the
decode caches of ``prefill_to_decode_cache`` (both dtypes) and the
launcher. The hybrid training (``loss_fn``, every gradient, two train
steps, in fp32) is in ``tests/test_torch_hybrid_train.py``, which shares
this file's helpers.

In bf16 the smoke stack is held layer by layer, not whole: on the
reference's input each layer comes within one bf16 step (0.3-0.6 % of
max|out|) of the reference and its caches equal the reference's, but
the random-weight stack amplifies those steps, to 12 % of max|logits|
after eight layers, and the router inputs drift 2-11 %, past what a
routing tie covers.

Routing ties are handled as in ``test_torch_mla_serve.py``
(``torch_routing``): the reference's routing of every MoE call is
recorded and the port runs with it, each row it would route otherwise a
tie within ``torch_routing.TIE``.

Tolerances: outputs and caches within ``TOL`` * max|ref| of each tensor:
3e-2 in bf16, as ``test_torch_ssm_serve.py``, and 1e-4 in fp32, where
eight layers of sums in another order grow the gap from 2e-7 of max at
layer 0's caches to 8e-6 at the logits (past ``test_torch_ssm_serve.py``'s
per-element 1e-5 of two layers); the same greedy tokens. Training
(``tests/test_torch_hybrid_train.py``): loss, ce, aux and the steps'
metrics rtol 1e-5, parameters and moments after two steps atol 5e-5,
rtol 1e-4 (``tests/test_torch_train.py``'s); the gradients within 1e-4 *
max|ref| of each leaf, ``test_torch_train``'s rtol taken over the leaf,
since the embedding's gradient passes all eight layers twice (3.9e-5 of
max at worst, in ``dt_bias``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from torch_routing import recording, same_routing  # noqa: E402

ARCH = "jamba-v0.1-52b"
B, S, NEW = 2, 40, 6
CPU = torch.device("cpu")
# of max|ref| per tensor (module docstring)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
KINDS = [("ssm", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe"),
         ("attn", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe")]


@dataclasses.dataclass
class Pair:
    dtype: str
    jcfg: object
    tcfg: object
    jp: dict
    np_params: dict
    tp: object


def _cfgs(dtype, **kw):
    return tuple(dataclasses.replace(reg.get_smoke_config(ARCH), dtype=dtype,
                                     param_dtype=dtype, **kw)
                 for reg in (jregistry, tregistry))


def _pair(dtype) -> Pair:
    jcfg, tcfg = _cfgs(dtype)
    jp = jtf.init_model(jcfg, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jp)
    tp = convert.params_from_numpy(tcfg, np_params, CPU)
    return Pair(dtype, jcfg, tcfg, jp, np_params, tp)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def f32():
    """The fp32 pair, for the whole-stack checks."""
    return _pair("float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    lim = TOL[dtype] * np.abs(want).max()
    assert err <= lim, f"{what}: max abs err {err} > {lim}"


def _tokens(cfg, seed=0, n=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _ref_cache(cfg, caches, i):
    """Port layer i's subtree in a reference tree (of caches or
    parameters)."""
    top, key, b = convert._ref_layer(cfg, i)
    c = caches[top][key]
    return c if b is None else jax.tree.map(lambda a: a[b], c)


def _close_caches(cfg, got: dict, want: dict, dtype, what):
    for i, c in enumerate(got["blocks"]):
        w = _ref_cache(cfg, want, i)
        assert sorted(c) == sorted(w), (i, sorted(c), sorted(w))
        for k in c:
            _close(c[k], w[k], dtype, f"{what} layer {i} {k}")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_layer_kinds(pair):
    """One period of jamba: SSD layers carry ``norm2`` and an MLP or MoE,
    unlike the ssm family's; attention at slot 4."""
    cfg = pair.tcfg
    assert [ttf.layer_kind(cfg, i) for i in range(cfg.n_layers)] == \
        [jtf.layer_kind(pair.jcfg, i) for i in range(cfg.n_layers)] == KINDS
    for i, (mixer, ff) in enumerate(KINDS):
        want = {"norm1", "norm2", "ssm" if mixer == "ssm" else "attn", ff}
        assert set(pair.tp["blocks"][i]) == want, i


def test_params_round_trip(pair):
    """``params_to_numpy(params_from_numpy(tree)) == tree`` (bf16 as its
    bit patterns), and ``ref_tree`` / ``ref_leaves`` invert each other
    over a stack whose layers differ in kind."""
    got = _flat(convert.params_to_numpy(pair.tcfg, pair.tp))
    want = _flat(pair.np_params)
    assert sorted(got) == sorted(want)
    assert "blocks/layer4/attn/wq" in want and \
        "blocks/layer5/ssm/w_dt" in want and "dense_layers" not in \
        pair.np_params
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), k)
    names = [n for n, _ in pair.tp.named_parameters()]
    leaves = list(pair.tp.parameters())
    back = convert.ref_leaves(pair.tcfg, convert.ref_tree(
        pair.tcfg, zip(names, leaves)), names)
    assert all(torch.equal(a, b) for a, b in zip(back, leaves))


def test_super_blocks_map_to_the_flat_layers():
    """Two super-blocks (16 layers): port layer ``b * 8 + j`` holds
    ``blocks/layer{j}[b]``, and the fp32 logits match the reference's."""
    jcfg, tcfg = _cfgs("float32", n_layers=16)
    assert tcfg.n_scan_blocks == 2
    jp = jtf.init_model(jcfg, jax.random.key(3))
    tree = jax.tree.map(np.asarray, jp)
    model = convert.params_from_numpy(tcfg, tree, CPU)
    for i in (4, 9, 12, 15):
        b, j = divmod(i, 8)
        sub = "attn" if j == 4 else "ssm"
        for leaf, t in model["blocks"][i][sub].items():
            np.testing.assert_array_equal(
                t.numpy(), tree["blocks"][f"layer{j}"][sub][leaf][b])
    toks = _tokens(tcfg)
    calls, flips = [], []
    with recording(calls):
        want, _ = jtf.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    with same_routing(calls, "float32", flips):
        got, _ = ttf.forward(tcfg, model, {"tokens": torch.from_numpy(toks)})
    _close(got, want, "float32", "logits")
    assert not any(flips)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_each_layer_on_the_reference_input(pair, use_kernel):
    """Each layer on the reference's input of that layer (its forward
    run layer by layer): the output, aux and raw cache; then one decode
    step from that cache in decode layout, its output and new cache."""
    cfg, jcfg = pair.tcfg, pair.jcfg
    x = jtf.embed_tokens(jcfg, pair.jp, jnp.asarray(_tokens(cfg)))
    x1 = jtf.embed_tokens(jcfg, pair.jp,
                          jnp.asarray(_tokens(cfg, seed=2, n=1)))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    for i, (mixer, ff) in enumerate(KINDS):
        jp, tp = _ref_cache(cfg, pair.jp, i), pair.tp["blocks"][i]
        calls, flips = [], []
        with recording(calls):
            want, jc, jaux = jtf._layer_forward(
                jcfg, jp, x, jnp.asarray(pos), i, causal=True,
                use_pallas=use_kernel)
            jdec = jengine._convert_layer(jcfg, mixer, jc, S, S + 4)
            wdec, wcache = jtf._layer_decode(jcfg, jp, x1, jdec, S, i)
        assert len(calls) == 2 * (ff == "moe")
        with same_routing(calls, pair.dtype, flips):
            got, tc, aux = ttf._layer_forward(
                cfg, tp, convert._tensor(x, CPU),
                torch.from_numpy(pos.copy()), i, causal=True,
                use_kernel=use_kernel, slot_kernel=use_kernel)
            tdec = tengine._convert_layer(cfg, mixer, tc, S, S + 4)
            gdec, gcache = ttf._layer_decode(cfg, tp, convert._tensor(x1, CPU),
                                             tdec, S, i)
        what = f"layer {i} ({mixer}, {ff})"
        _close(got, want, pair.dtype, what)
        _close(gdec, wdec, pair.dtype, f"{what} decode")
        if ff == "moe":
            _close(aux, jaux, pair.dtype, f"{what} aux")
        for name, g, w in (("cache", tc, jc), ("decode cache", gcache,
                                               wcache)):
            assert sorted(g) == sorted(w), (what, name)
            for k in g:
                _close(g[k], w[k], pair.dtype, f"{what} {name} {k}")
        x = want


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_aux_and_caches(f32, use_kernel):
    toks = _tokens(f32.tcfg)
    calls, flips = [], []
    with recording(calls):
        want, jaux, jc = jtf.forward(f32.jcfg, f32.jp,
                                     {"tokens": jnp.asarray(toks)},
                                     use_pallas=use_kernel, want_cache=True)
    assert len(calls) == 4                       # the four MoE layers
    with same_routing(calls, f32.dtype, flips):
        got, aux, tc = ttf.forward(f32.tcfg, f32.tp,
                                   {"tokens": torch.from_numpy(toks)},
                                   use_kernel=use_kernel, want_cache=True)
    _close(got, want, f32.dtype, "logits")
    assert float(aux) > 0
    _close(aux, jaux, f32.dtype, "aux")
    _close_caches(f32.tcfg, tc, jc, f32.dtype, "prefill")
    with same_routing(calls, f32.dtype, flips):
        last = ttf.prefill(f32.tcfg, f32.tp,
                           {"tokens": torch.from_numpy(toks)},
                           use_kernel=use_kernel)
    _close(last, want[:, -1:], f32.dtype, "prefill")
    assert not any(flips)


def test_prefill_to_decode_cache(pair):
    """The conversion alone, on the reference's own raw caches: equal,
    and the zero caches of ``init_cache`` in the same layout (SSD state
    and conv carries beside k/v)."""
    toks = _tokens(pair.tcfg)
    _, _, jc = jtf.forward(pair.jcfg, pair.jp, {"tokens": jnp.asarray(toks)},
                           want_cache=True)
    raw = {"blocks": [{k: convert._tensor(v, CPU) for k, v in
                       _ref_cache(pair.tcfg, jc, i).items()}
                      for i in range(pair.tcfg.n_layers)]}
    S_max = S + 8
    want = jengine.prefill_to_decode_cache(pair.jcfg, jc, S, S_max)
    got = tengine.prefill_to_decode_cache(pair.tcfg, raw, S, S_max)
    zero = ttf.init_cache(pair.tcfg, B, S_max, device=CPU)
    for i, c in enumerate(got["blocks"]):
        w = _ref_cache(pair.tcfg, want, i)
        assert sorted(c) == sorted(w) == sorted(zero["blocks"][i])
        for k in c:
            np.testing.assert_array_equal(_np(c[k]), _np(w[k]))
            z = zero["blocks"][i][k]
            assert z.shape == c[k].shape and z.dtype == c[k].dtype, (i, k)


def test_decode_steps(f32):
    """Six decode steps against the converted caches: logits and every
    layer's cache after each step, with the reference's routing."""
    toks = _tokens(f32.tcfg)
    nxt = _tokens(f32.tcfg, seed=2, n=NEW)
    S_max = S + NEW + 2
    calls, flips, want, got = [], [], [], []
    with recording(calls):
        _, _, jc = jtf.forward(f32.jcfg, f32.jp,
                               {"tokens": jnp.asarray(toks)}, want_cache=True)
        jcache = jengine.prefill_to_decode_cache(f32.jcfg, jc, S, S_max)
        for step in range(NEW):
            logits, jcache = jtf.decode_step(
                f32.jcfg, f32.jp, jcache, jnp.asarray(nxt[:, step:step + 1]),
                S + step)
            want.append((logits, jcache))
    with same_routing(calls, f32.dtype, flips):
        _, _, tc = ttf.forward(f32.tcfg, f32.tp,
                               {"tokens": torch.from_numpy(toks)},
                               want_cache=True)
        tcache = tengine.prefill_to_decode_cache(f32.tcfg, tc, S, S_max)
        for step in range(NEW):
            logits, tcache = ttf.decode_step(
                f32.tcfg, f32.tp, tcache,
                torch.from_numpy(nxt[:, step:step + 1]), S + step)
            got.append((logits, {"blocks": [
                {k: v.clone() for k, v in c.items()}
                for c in tcache["blocks"]]}))
    for step, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
        _close(gl, wl, f32.dtype, f"decode logits {step}")
        _close_caches(f32.tcfg, gc, wc, f32.dtype, f"step {step}")


def test_generate_greedy(f32):
    """The same greedy tokens as the reference's engine, with its routing
    of the prefill and of every decode step."""
    prompts = _tokens(f32.tcfg, seed=3)
    max_len = S + NEW + 8
    calls, flips = [], []
    with recording(calls):
        want = jengine.ServeEngine(f32.jcfg, f32.jp, max_len=max_len) \
            .generate(prompts, NEW)
    assert len(calls) == 4 * NEW                 # prefill + NEW - 1 steps
    with same_routing(calls, f32.dtype, flips):
        got = tengine.ServeEngine(f32.tcfg, f32.tp, max_len=max_len,
                                  device=CPU).generate(prompts, NEW)
    assert got.shape == (B, NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_launch_serve_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--prompt-len", "24",
                "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "jamba-smoke on cpu" in out
    assert "done: 9 tokens" in out
