"""The port's LM training against the JAX package, on the CPU.

At the olmo-1b, h2o-danube-1.8b (sliding window) and mamba2-780m SMOKE
configs in fp32 (as ``tests/test_train.py`` sets them), with the weights
of the reference's ``init_model(cfg, jax.random.key(0))`` carried across
by ``params_from_numpy`` and the same seeded numpy batches: ``loss_fn``
and every gradient leaf (through ``params_to_numpy``), the three remat
policies and three steps of ``make_train_step`` at A = 1 and A = 4.
The parts that need no reference step (the SSD backward over a full
chunk, the masked and bf16 losses, ``cross_entropy``, the optimizer's
parts, the int8 error feedback, the configs, serving a model that was
trained on, ``launch/train``) are in ``tests/test_torch_train_parts.py``,
which shares this file's helpers.

Tolerances: loss, ce and the step's metrics rtol 1e-5 (sums in another
order); gradients atol 1e-5, rtol 1e-4; parameters and moments after
three steps atol 5e-5, rtol 1e-4 (the reference's own accumulation
tolerance); ``cross_entropy`` rtol 1e-6; the remat policies' losses rtol
1e-6; bf16 loss within 2e-2 relative; compression codes and residuals
exactly.
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
from torch_parity import assert_equal  # noqa: E402

ARCHS = ("olmo-1b", "h2o-danube-1.8b", "mamba2-780m")
B, S, STEPS = 8, 48, 3         # S 48 > h2o-smoke's window of 32
ACCUM = {1: 8, 4: 2}           # A -> microbatch
CPU = torch.device("cpu")
TCFG = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def _cfgs(arch, dtype="float32"):
    return tuple(dataclasses.replace(reg.get_smoke_config(arch), dtype=dtype,
                                     param_dtype=dtype)
                 for reg in (jregistry, tregistry))


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _runs(jcfg, tcfg, mb, b=B, s=S):
    """The reference's and the port's RunConfig at (b, s), microbatch
    ``mb``, with ``TrainConfig(**TCFG)`` (remat "full" by default)."""
    out = []
    for cfgmod, specs, cfg in ((jconfig, jspecs, jcfg),
                               (tconfig, tspecs, tcfg)):
        run = specs.make_run(cfg, cfgmod.ShapeConfig("t", s, b, "train"),
                             cfgmod.MeshConfig((1, 1)), microbatch=mb)
        out.append(dataclasses.replace(run,
                                       train=cfgmod.TrainConfig(**TCFG)))
    return out


def _flat(tree, prefix=""):
    """``{"a/b/c": numpy}`` of a nested dict (either package's tree)."""
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


# ---------------------------------------------------------------------------
# the reference's runs, one module-scoped fixture an arch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    arch = request.param
    jcfg, tcfg = _cfgs(arch)
    jp = jtf.init_model(jcfg, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jp)
    batch = _batch(jcfg)
    jbatch = jax.tree.map(jnp.asarray, batch)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jbatch), has_aux=True)(jp)
    out = dict(arch=arch, jcfg=jcfg, tcfg=tcfg, np_params=np_params,
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


def test_params_to_numpy_inverts_params_from_numpy(ref):
    got = _flat(params_to_numpy(ref["tcfg"], _port_model(ref)))
    want = _flat(ref["np_params"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert_equal(got[k], want[k], k)


def test_loss_fn_and_every_gradient_match_jax(ref):
    cfg = ref["tcfg"]
    model = _port_model(ref)
    model.requires_grad_(True)
    loss, aux = ttf.loss_fn(cfg, model, _torch_batch(ref["batch"]))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(aux[k].detach()), ref["aux"][k],
                                   rtol=1e-5)
    _close(_flat(params_to_numpy(cfg, model, grads)), ref["grads"],
           atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_policies_give_the_same_loss_and_gradients(ref, policy):
    cfg = ref["tcfg"]
    model = _port_model(ref)
    model.requires_grad_(True)
    batch = _torch_batch(ref["batch"])
    vals = {}
    for pol in ("none", policy):
        loss, _ = ttf.loss_fn(cfg, model, batch, remat=pol)
        vals[pol] = (float(loss.detach()), torch.autograd.grad(
            loss, list(model.parameters())))
    np.testing.assert_allclose(vals[policy][0], vals["none"][0], rtol=1e-6)
    for a, b in zip(vals[policy][1], vals["none"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("A", sorted(ACCUM))
def test_train_steps_match_jax(ref, A):
    """Three steps of ``make_train_step`` from the same weights on the
    same batch: the metrics of each, then the parameters, both moments
    and the step counter."""
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
