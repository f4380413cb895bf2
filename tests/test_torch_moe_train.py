"""The port's training of the MoE and MLA stack against the JAX package,
on the CPU.

At the deepseek-v2-lite SMOKE config (3 layers: one leading dense layer
and two MoE layers of 8 experts top-2 with 2 shared experts, G 2; MLA
attention) in fp32, for dispatch ``1s`` and ``2s``, with the weights of
the reference's ``init_model(cfg, jax.random.key(0))`` carried across by
``params_from_numpy`` and the same seeded numpy batches: ``loss_fn``'s
loss, ce and aux and every gradient leaf against ``jax.value_and_grad``
of the reference's ``loss_fn``; the three remat policies; three steps of
``make_train_step`` at A = 1 and A = 4 against the jitted reference
step. The port's train step slots the MoE records through bucket_slots'
wrapper (its plain version on these CPU tensors); the reference slots
them by an argsort. The layer-level checks, the snapshots and the
launcher are in ``tests/test_torch_moe_train_parts.py``, which shares
this file's helpers.

Tolerances, as ``tests/test_torch_train.py`` states them: loss, ce, aux
and the step's metrics rtol 1e-5 (sums in another order); gradients atol
1e-5, rtol 1e-4; parameters and moments after three steps atol 5e-5,
rtol 1e-4; the remat policies' losses rtol 1e-6 and gradients atol
1e-5, rtol 1e-4.

The shape is B 8 x S 48. At S 32 one parameter element crosses the
steps' tolerance at A = 1 under both dispatch modes (1s and 2s; A = 4
passes): layer 1's ``attn/wo[22, 48]``, 6.7e-5 and 7.0e-5 against a
limit of 6.5e-5. Its gradient at step 0 is float noise in both packages
(2.6e-8 and 2.8e-8 in JAX, 5.4e-8 in the port, against a leaf max of
0.037), and AdamW's first step divides it by its own root (|g| / (|g| +
1e-8): 0.72 against 0.84 of the learning rate), so the noise moves the
parameter by a visible step. At steps 1 and 2 the two gradients agree
(-0.002143 against -0.002144, -0.0005311 against -0.0005317): no port
fault, and the test keeps S 48. ``tests/torch_probes.py s32`` prints
these numbers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.train import train_step as tts  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
B, S, STEPS = 8, 48, 3         # the shape of tests/test_torch_train.py
ACCUM = {1: 8, 4: 2}           # A -> microbatch
CPU = torch.device("cpu")
TCFG = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def _cfgs(dispatch="1s", dtype="float32", **kw):
    return tuple(dataclasses.replace(reg.get_smoke_config(ARCH), dtype=dtype,
                                     param_dtype=dtype,
                                     dispatch_mode=dispatch, **kw)
                 for reg in (jregistry, tregistry))


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _runs(jcfg, tcfg, mb):
    out = []
    for cfgmod, specs, cfg in ((jconfig, jspecs, jcfg),
                               (tconfig, tspecs, tcfg)):
        run = specs.make_run(cfg, cfgmod.ShapeConfig("t", S, B, "train"),
                             cfgmod.MeshConfig((1, 1)), microbatch=mb)
        out.append(dataclasses.replace(run,
                                       train=cfgmod.TrainConfig(**TCFG)))
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _close(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=["1s", "2s"])
def ref(request):
    """The reference's loss, gradients and jitted steps at one dispatch
    mode."""
    jcfg, tcfg = _cfgs(request.param)
    jp = jtf.init_model(jcfg, jax.random.key(0))
    batch = _batch(jcfg)
    jbatch = jax.tree.map(jnp.asarray, batch)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jbatch), has_aux=True)(jp)
    out = dict(jcfg=jcfg, tcfg=tcfg, np_params=jax.tree.map(np.asarray, jp),
               batch=batch, loss=float(loss),
               aux={k: float(v) for k, v in aux.items()},
               grads=_flat(jax.tree.map(np.asarray, grads)), steps={})
    for A, mb in ACCUM.items():
        jrun, _ = _runs(jcfg, tcfg, mb)
        assert jrun.grad_accum_steps == A
        step = jax.jit(jts.make_train_step(jcfg, jrun))
        state = jts.init_train_state(jcfg, jrun.train, jp)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, jbatch)
            metrics.append({k: float(v) for k, v in m.items()})
        out["steps"][A] = dict(
            metrics=metrics, step=int(state.opt.step),
            params=_flat(jax.tree.map(np.asarray, state.params)),
            mu=_flat(jax.tree.map(np.asarray, state.opt.mu)),
            nu=_flat(jax.tree.map(np.asarray, state.opt.nu)))
    return out


def _port_model(ref):
    return params_from_numpy(ref["tcfg"], ref["np_params"], CPU)


def _loss_and_grads(ref, model, **kw):
    loss, aux = ttf.loss_fn(ref["tcfg"], model, _torch_batch(ref["batch"]),
                            **kw)
    return loss, aux, torch.autograd.grad(loss, list(model.parameters()))


def test_loss_fn_and_every_gradient_match_jax(ref):
    """The router (through the gates and the aux loss), the routed and
    the shared experts, MLA and the leading dense layer: every leaf."""
    cfg = ref["tcfg"]
    model = _port_model(ref)
    model.requires_grad_(True)
    loss, aux, grads = _loss_and_grads(ref, model, slot_kernel=True)
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(aux[k].detach()), ref["aux"][k],
                                   rtol=1e-5)
    assert ref["aux"]["aux"] > 0
    got = _flat(params_to_numpy(cfg, model, grads))
    for part in ("router", "we_gate", "we_out", "ws_in", "w_kv_b"):
        assert any(k.endswith(part) and np.abs(got[k]).max() > 0
                   for k in got), part
    _close(got, ref["grads"], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_policies_give_the_same_loss_and_gradients(ref, policy):
    """Under "dots" and "full" the backward pass slots each MoE layer's
    records again: the same loss and gradients as "none"."""
    model = _port_model(ref)
    model.requires_grad_(True)
    vals = {pol: _loss_and_grads(ref, model, slot_kernel=True, remat=pol)
            for pol in ("none", policy)}
    np.testing.assert_allclose(float(vals[policy][0].detach()),
                               float(vals["none"][0].detach()), rtol=1e-6)
    for a, b in zip(vals[policy][2], vals["none"][2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("A", sorted(ACCUM))
def test_train_steps_match_jax(ref, A):
    """Three steps of ``make_train_step`` (full remat, the slots through
    bucket_slots' wrapper) from the same weights on the same batch: the
    metrics of each, then the parameters, both moments and the step."""
    cfg = ref["tcfg"]
    _, run = _runs(ref["jcfg"], cfg, ACCUM[A])
    assert run.grad_accum_steps == A
    step = tts.make_train_step(cfg, run)
    state = tts.init_train_state(cfg, run.train, _port_model(ref))
    batch = _torch_batch(ref["batch"])
    want = ref["steps"][A]
    for i in range(STEPS):
        state, m = step(state, batch)
        assert set(m) == set(want["metrics"][i])
        for k, v in want["metrics"][i].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=1e-5, err_msg=k)
    assert int(state.opt.step) == want["step"] == STEPS
    tol = dict(atol=5e-5, rtol=1e-4)
    _close(_flat(params_to_numpy(cfg, state.params)), want["params"], **tol)
    for k in ("mu", "nu"):
        _close(_flat(params_to_numpy(cfg, state.params,
                                     getattr(state.opt, k))), want[k], **tol)
