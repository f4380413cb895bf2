"""The port's hybrid (jamba) training against the JAX package, on the
CPU, at the jamba SMOKE config in fp32 of
``tests/test_torch_hybrid_serve.py`` (whose helpers these tests share):
the hybrid ``loss_fn`` and every gradient against ``jax.value_and_grad``,
and two train steps against the jitted reference step. Hybrid training
is held here only: jamba does not fit one 80 GB card at full width at
any depth that holds an attention layer.

Tolerances, as ``tests/test_torch_hybrid_serve.py`` states them (with
their reasons): loss, ce, aux and the steps' metrics rtol 1e-5,
parameters and moments after two steps atol 5e-5, rtol 1e-4; the
gradients within 1e-4 * max|ref| of each leaf.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from test_torch_hybrid_serve import CPU, _cfgs, _flat  # noqa: E402


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _train_batch(cfg):
    rng = np.random.default_rng(7)
    return {k: rng.integers(0, cfg.vocab_size, (4, 48)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def weights():
    """The fp32 configs of both packages and the reference's weights,
    shared by the file's two tests."""
    jcfg, tcfg = _cfgs("float32")
    return jcfg, tcfg, jtf.init_model(jcfg, jax.random.key(0))


def test_hybrid_loss_and_every_gradient_match_jax(weights):
    jcfg, tcfg, jp = weights
    batch = _train_batch(jcfg)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jp)
    model = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), CPU)
    model.requires_grad_(True)
    got, gaux = ttf.loss_fn(tcfg, model, _torch_batch(batch),
                            slot_kernel=True, remat="full")
    tgrads = torch.autograd.grad(got, list(model.parameters()))
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(gaux[k].detach()), float(aux[k]),
                                   rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, grads))
    have = _flat(convert.params_to_numpy(tcfg, model, tgrads))
    assert sorted(have) == sorted(want)
    for k in want:
        err = np.abs(have[k] - want[k]).max()
        assert err <= 1e-4 * np.abs(want[k]).max(), (k, err)


def test_hybrid_train_steps_match_jax(weights):
    """Two steps of ``make_train_step`` at A = 2 (full remat) against the
    jitted reference step: metrics, parameters and both moments."""
    jcfg, tcfg, jp = weights
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    runs = []
    for cfgmod, specs, cfg in ((jconfig, jspecs, jcfg),
                               (tconfig, tspecs, tcfg)):
        run = specs.make_run(cfg, cfgmod.ShapeConfig("t", 48, 4, "train"),
                             cfgmod.MeshConfig((1, 1)), microbatch=2)
        runs.append(dataclasses.replace(run,
                                        train=cfgmod.TrainConfig(**kw)))
    assert runs[1].grad_accum_steps == 2
    batch = _train_batch(jcfg)
    jstep = jax.jit(jts.make_train_step(jcfg, runs[0]))
    jstate = jts.init_train_state(jcfg, runs[0].train, jp)
    tstep = tts.make_train_step(tcfg, runs[1])
    tstate = tts.init_train_state(tcfg, runs[1].train,
                                  convert.params_from_numpy(
                                      tcfg, jax.tree.map(np.asarray, jp),
                                      CPU))
    for _ in range(2):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, _torch_batch(batch))
        for k, v in jm.items():
            np.testing.assert_allclose(float(tm[k]), float(v), rtol=1e-5,
                                       err_msg=k)
    for got, want in ((None, jstate.params), ("mu", jstate.opt.mu),
                      ("nu", jstate.opt.nu)):
        have = _flat(convert.params_to_numpy(
            tcfg, tstate.params,
            None if got is None else getattr(tstate.opt, got)))
        want = _flat(jax.tree.map(np.asarray, want))
        assert sorted(have) == sorted(want)
        for k in want:
            np.testing.assert_allclose(have[k], want[k], atol=5e-5,
                                       rtol=1e-4, err_msg=f"{got} {k}")
