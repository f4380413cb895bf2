"""Stack parity tests shared by the per-arch serve test files (they import
JAX).

A test file names its arch in a module fixture ``arch`` and imports the
fixtures and tests below; each runs at that arch's SMOKE config in fp32
and bf16, with the weights of the reference's ``init_model(cfg,
jax.random.key(0))`` carried across by ``params_from_numpy`` and the same
seeded numpy tokens (seeded noise on the leaves the init leaves
constant, ``_perturbed``), and for an arch with a frontend the same
seeded fp32 ``frontend_embeds`` (``frontend``: a VLM's prefix of
``FE_LEN["vision_stub"]`` rows, an audio stack's S // enc_seq_factor
frames, as the reference's ``frontend_geometry`` sizes them):
``forward``'s logits, aux and raw caches (``cross_k``/``cross_v`` too),
each in the reference's dtype, through the
kernel path (``use_kernel=True``, the plain versions on these CPU
tensors, against ``use_pallas=True`` in interpret mode) and the
reference path; two decode steps from the converted caches; greedy
``ServeEngine.generate``; ``loss_fn`` and every gradient against
``jax.value_and_grad``. The reference's runs are made once a module and
dtype (``Pair.ref``).

An MoE stack's MoE calls take the reference's routing
(``torch_routing``): every row the port would route otherwise must be a
tie within ``TIE`` (none in fp32). In bf16 a tie is a gap of bf16's
relative step 2**-8 of a probability, wider than ``torch_routing.TIE``'s
1e-3: at llama4's smoke stack the first MoE layer follows a whole bf16
layer, and there each package's bf16 router probabilities sit up to
1.2e-3 from the fp32 ones of the same weights (``tests/torch_probes.py
router-noise``).

Tolerances: forward, caches and decode as ``test_torch_serve.py``'s
(fp32 rtol/atol 1e-5, sums in another order; bf16 3e-2 * max|ref|), the
same greedy tokens (in bf16 a dense stack's served tokens each a
maximum, within 3e-2 * max|logits|, of the reference's logits for the
sequence served, since one bf16 rounding may reorder two near-equal
logits; an MoE stack on the reference's routing gives the same tokens);
loss, ce and aux rtol 1e-5 in fp32 (``test_torch_train.py``'s) and 2e-2
in bf16 (its bf16 loss); gradients atol 1e-5, rtol 1e-4 in fp32
(``test_torch_train.py``'s) and within 3e-2 * max|ref| of each leaf in
bf16 (the bf16 output tolerance, taken over the leaf).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.configs import registry as tregistry
from repro_torch.models import convert
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine
from torch_routing import recording, same_routing

B, S, NEW = 2, 48, 4
# rows of a VLM's stub prefix (the reference's launcher serves 16)
FE_LEN = {"vision_stub": 16}
# a router probability gap that bf16 rounding may cross (module docstring)
TIE = {"float32": 0.0, "bfloat16": 2**-8}
CPU = torch.device("cpu")
DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass
class Pair:
    dtype: str
    jcfg: object
    tcfg: object
    jp: dict
    tp: object
    ref: dict          # the reference's runs, made once by ``_ref``

    @property
    def moe(self) -> bool:
        return bool(self.tcfg.n_experts)


def _perturbed(tree: dict) -> dict:
    """The tree with seeded noise (0.1 a step) on every leaf that the
    init leaves constant (the qkv biases, norm scales and biases), so
    that the tests see those parameters act."""
    rng = np.random.default_rng(7)

    def noisy(a):
        a = np.asarray(a)
        if a.size < 2 or not (a == a.flat[0]).all():
            return a
        return (a.astype(np.float32)
                + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return jax.tree.map(noisy, tree)


def make_pair(arch: str, dtype: str, **kw) -> Pair:
    jcfg, tcfg = (dataclasses.replace(reg.get_smoke_config(arch),
                                      dtype=dtype, param_dtype=dtype, **kw)
                  for reg in (jregistry, tregistry))
    tree = _perturbed(jtf.init_model(jcfg, jax.random.key(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tcfg, tree, CPU)
    return Pair(dtype, jcfg, tcfg, jp, tp, {})


@pytest.fixture(scope="module", params=DTYPES)
def pair(request, arch):
    return make_pair(arch, request.param)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, dtype, what=""):
    got, want = np32(got), np32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    else:
        err, lim = np.abs(got - want).max(), 3e-2 * np.abs(want).max()
        assert err <= lim, f"{what}: max abs err {err} > {lim}"


def tokens(cfg, seed=0, n=S, b=B):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, n)).astype(np.int32)


def frontend(cfg, b=B, seed=5):
    """Seeded fp32 ``frontend_embeds`` of ``cfg`` (None without a
    frontend): a VLM's ``FE_LEN`` prefix rows, an audio stack's S //
    enc_seq_factor frames."""
    if cfg.frontend == "vision_stub":
        n = FE_LEN["vision_stub"]
    elif cfg.n_enc_layers:
        n = S // max(cfg.enc_seq_factor, 1)
    else:
        return None
    return np.random.default_rng(seed).standard_normal(
        (b, n, cfg.d_model)).astype(np.float32)


def prefix_len(cfg, fe) -> int:
    """Positions a VLM's prefix takes ahead of the text (0 otherwise)."""
    return fe.shape[1] if cfg.frontend == "vision_stub" else 0


def batches(toks, fe=None, **extra):
    """The same batch for both packages: (JAX's, the port's)."""
    jb = {"tokens": jnp.asarray(toks),
          **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"tokens": torch.from_numpy(np.ascontiguousarray(toks)),
          **{k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in extra.items()}}
    if fe is not None:
        jb["frontend_embeds"] = jnp.asarray(fe)
        tb["frontend_embeds"] = torch.from_numpy(fe)
    return jb, tb


def same_dtype(got, want, what=""):
    """A port tensor's dtype is the reference array's."""
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), \
        (what, got.dtype, want.dtype)


def close_caches(got: dict, want: dict, dtype, what=""):
    """Every entry of one layer's cache (k/v, ``cross_k``/``cross_v``),
    in the reference's dtype and within the tolerance."""
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for name in got:
        same_dtype(got[name], want[name], f"{what} {name}")
        close(got[name], want[name], dtype, f"{what} {name}")


def ref_cache(cfg, caches, i):
    """Port layer i's cache in the reference's tree of caches."""
    top, key, b = convert._ref_layer(cfg, i)
    c = caches[top][key]
    return c if b is None else jax.tree.map(lambda a: a[b], c)


def _ref(pair: Pair, name: str, run):
    """``run()`` of the reference, once a pair, with the routing of its
    MoE calls recorded: (result, calls)."""
    if name not in pair.ref:
        calls = []
        with recording(calls):
            out = run()
        pair.ref[name] = (out, calls)
    return pair.ref[name]


@contextlib.contextmanager
def routed(pair: Pair, calls: list):
    """The port's MoE calls on the reference's routing ``calls`` (a
    dense stack makes none)."""
    if not pair.moe:
        assert not calls
        yield
        return
    flips = []
    with same_routing(calls, pair.dtype, flips, TIE[pair.dtype]):
        yield
    if pair.dtype == "float32":
        assert not any(flips), flips


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_aux_and_caches(pair, use_kernel):
    toks = tokens(pair.tcfg)
    jb, tb = batches(toks, frontend(pair.tcfg))
    (want, jaux, jc), calls = _ref(
        pair, f"forward{use_kernel}", lambda: jtf.forward(
            pair.jcfg, pair.jp, jb, use_pallas=use_kernel,
            want_cache=True))
    with routed(pair, calls):
        got, aux, tc = ttf.forward(pair.tcfg, pair.tp, tb,
                                   use_kernel=use_kernel, want_cache=True)
    assert got.dtype == getattr(torch, pair.dtype)
    same_dtype(got, want, "logits")
    close(got, want, pair.dtype, "logits")
    if pair.moe:
        assert float(aux) > 0
        close(aux, jaux, pair.dtype, "aux")
    else:
        assert float(aux) == 0.0
    for i, c in enumerate(tc["blocks"]):
        close_caches(c, ref_cache(pair.tcfg, jc, i), pair.dtype, f"layer {i}")
    with routed(pair, calls):
        last = ttf.prefill(pair.tcfg, pair.tp, tb, use_kernel=use_kernel)
    close(last, want[:, -1:], pair.dtype, "prefill")


def test_decode_steps(pair):
    """Two decode steps from the converted prefill caches: the logits
    and every layer's cache (k/v, ``cross_k``/``cross_v``) after each."""
    toks, nxt = tokens(pair.tcfg), tokens(pair.tcfg, seed=2, n=2)
    fe = frontend(pair.tcfg)
    jb, tb = batches(toks, fe)
    S_ctx = S + (0 if fe is None else prefix_len(pair.tcfg, fe))
    S_max = S_ctx + 4

    def run():
        _, _, jc = jtf.forward(pair.jcfg, pair.jp, jb, want_cache=True)
        cache, out = jengine.prefill_to_decode_cache(pair.jcfg, jc, S_ctx,
                                                     S_max), []
        for step in range(2):
            logits, cache = jtf.decode_step(
                pair.jcfg, pair.jp, cache, jnp.asarray(nxt[:, step:step + 1]),
                S_ctx + step)
            out.append((logits, [ref_cache(pair.tcfg, cache, i)
                                 for i in range(pair.tcfg.n_layers)]))
        return out
    want, calls = _ref(pair, "decode", run)
    with routed(pair, calls):
        _, _, tc = ttf.forward(pair.tcfg, pair.tp, tb, want_cache=True)
        cache = tengine.prefill_to_decode_cache(pair.tcfg, tc, S_ctx, S_max)
        for step, (wl, wc) in enumerate(want):
            logits, cache = ttf.decode_step(
                pair.tcfg, pair.tp, cache,
                torch.from_numpy(nxt[:, step:step + 1]), S_ctx + step)
            same_dtype(logits, wl, f"decode logits {step}")
            close(logits, wl, pair.dtype, f"decode logits {step}")
            for i, (c, w) in enumerate(zip(cache["blocks"], wc)):
                close_caches(c, w, pair.dtype, f"step {step} layer {i}")


def test_generate_greedy(pair):
    prompts = tokens(pair.tcfg, seed=3)
    fe = frontend(pair.tcfg, seed=6)
    max_len = S + NEW + 4 + (0 if fe is None else prefix_len(pair.tcfg, fe))
    want, calls = _ref(pair, "generate", lambda: jengine.ServeEngine(
        pair.jcfg, pair.jp, max_len=max_len).generate(
            prompts, NEW, frontend_embeds=fe))
    with routed(pair, calls):
        got = tengine.ServeEngine(pair.tcfg, pair.tp, max_len=max_len,
                                  device=CPU).generate(
            prompts, NEW, frontend_embeds=fe)
    assert got.shape == (B, NEW) and got.dtype == np.int32
    if pair.dtype == "float32" or pair.moe:
        np.testing.assert_array_equal(got, want)
        return
    seq = np.concatenate([prompts, got[:, :-1]], 1)
    logits, _ = jtf.forward(pair.jcfg, pair.jp, batches(seq, fe)[0])
    logits = np32(logits)[:, -NEW:]
    picked = np.take_along_axis(logits, got[..., None], -1)[..., 0]
    assert (logits.max(-1) - picked).max() <= 3e-2 * np.abs(logits).max()


def _loss_and_grads(pair: Pair, cfg, calls: list, batch: dict):
    """The port's loss, metrics and every gradient (fp32 numpy, the
    reference's tree) of the pair's weights, upcast where ``cfg`` is
    fp32, its MoE
    calls on the reference's routing ``calls`` (ties within the pair's
    dtype's)."""
    up = cfg.param_dtype == "float32"
    model = convert.params_from_numpy(cfg, jax.tree.map(
        lambda a: np.asarray(a, np.float32) if up else np.asarray(a),
        pair.jp), CPU)
    model.requires_grad_(True)
    with routed(pair, calls):
        loss, m = ttf.loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    grads = convert.params_to_numpy(cfg, model, [g.float() for g in grads])
    return loss.detach(), {k: v.detach() for k, v in m.items()}, \
        _flat(grads)


def test_loss_fn_and_every_gradient_match_jax(pair):
    """loss, ce, aux and every gradient leaf. Under ``value_and_grad``
    the reference's scan routes each MoE layer again in the backward
    pass, last layer first: the same ids as the forward's. In bf16 the
    yardstick of a gradient is the fp32 one of the same weights (the
    port's, on the same routing; the fp32 case holds it to the
    reference's): the port's bf16 gradient may be at most twice as far
    from it as the reference's bf16 gradient is, leaf by leaf (1.36-1.58
    at worst over the three smoke stacks: ``tests/torch_probes.py
    bf16-grads``)."""
    rng = np.random.default_rng(4)
    toks = rng.integers(0, pair.tcfg.vocab_size, (B, S + 1)).astype(np.int32)
    jbatch, tbatch = batches(toks[:, :-1], frontend(pair.tcfg, seed=8),
                             labels=toks[:, 1:])
    ((jloss, jm), jgrads), calls = _ref(
        pair, "grads", lambda: jax.value_and_grad(
            lambda p: jtf.loss_fn(pair.jcfg, p, jbatch), has_aux=True)(
                pair.jp))
    n_moe = sum(map(pair.tcfg.is_moe_layer, range(pair.tcfg.n_layers)))
    fwd, bwd = calls[:n_moe], calls[n_moe:]
    assert len(bwd) in (0, n_moe)
    assert all(np.array_equal(a, b) for a, b in zip(fwd, bwd[::-1]))
    loss, m, got = _loss_and_grads(pair, pair.tcfg, fwd, tbatch)
    rtol = 1e-5 if pair.dtype == "float32" else 2e-2
    for k, a, b in (("loss", loss, jloss), ("ce", m["ce"], jm["ce"]),
                    ("aux", m["aux"], jm["aux"])):
        np.testing.assert_allclose(float(a), float(b), rtol=rtol, err_msg=k)
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert sorted(got) == sorted(want)
    if pair.dtype == "float32":
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                       rtol=1e-4, err_msg=k)
        return
    cfg32 = dataclasses.replace(pair.tcfg, dtype="float32",
                                param_dtype="float32")
    truth = _loss_and_grads(pair, cfg32, fwd, tbatch)[2]
    for k in want:
        port = np.abs(got[k] - truth[k]).max()
        ref = np.abs(want[k] - truth[k]).max()
        assert port <= 2 * ref, (k, port, ref)
