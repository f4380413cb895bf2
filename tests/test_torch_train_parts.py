"""The port's LM training against the JAX package, on the CPU: the parts
that need no reference step (the helpers and SMOKE configs of
``tests/test_torch_train.py``, which holds the stacks' gradients, remat
policies and train steps): the SSD backward over a full chunk, the
masked and the bf16 loss, ``cross_entropy``, overfitting one batch, the
optimizer's parts, the int8 error feedback, the configs, serving a model
that was trained on, and ``launch/train``'s checkpoint, resume and
refusals.

Tolerances, as ``tests/test_torch_train.py`` states them: loss rtol
1e-5; ``cross_entropy`` rtol 1e-6; bf16 loss within 2e-2 relative;
compression codes and residuals exactly.
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
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compress as tcompress  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from test_torch_train import (ARCHS, CPU, _batch, _cfgs,  # noqa: E402
                              _runs, _torch_batch)
from torch_parity import assert_equal  # noqa: E402


def test_ssd_gradients_stay_finite_over_a_full_chunk():
    """Over a chunk of 256 (mamba2-780m's) the reference's SSD backward
    gives non-finite gradients: its ``where`` keeps the overflowed exp
    above the diagonal, and a zero gradient times inf is NaN. The port
    selects before the exp: the same loss, finite gradients."""
    jcfg, tcfg = (dataclasses.replace(c, ssm_chunk=256)
                  for c in _cfgs("mamba2-780m"))
    jp = jtf.init_model(jcfg, jax.random.key(0))
    batch = _batch(jcfg, b=2, s=256)
    (want, _), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jp)
    assert not all(bool(jnp.isfinite(g).all())
                   for g in jax.tree.leaves(jgrads))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), CPU)
    model.requires_grad_(True)
    loss, _ = ttf.loss_fn(tcfg, model, _torch_batch(batch))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_loss_fn_with_a_loss_mask_matches_jax():
    jcfg, tcfg = _cfgs("olmo-1b")
    jp = jtf.init_model(jcfg, jax.random.key(1))
    batch = _batch(jcfg, seed=3, b=4, s=32)
    mask = np.ones((4, 32), np.float32)
    mask[1, 8:] = 0.0
    mask[3, 2:] = 0.0
    batch["loss_mask"] = mask
    want, waux = jtf.loss_fn(jcfg, jp, jax.tree.map(jnp.asarray, batch))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), CPU)
    got, aux = ttf.loss_fn(tcfg, model, _torch_batch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"]), float(waux["ce"]),
                               rtol=1e-5)


def test_bf16_loss_fn_matches_jax():
    jcfg, tcfg = _cfgs("olmo-1b", "bfloat16")
    jp = jtf.init_model(jcfg, jax.random.key(0))
    batch = _batch(jcfg)
    want, _ = jtf.loss_fn(jcfg, jp, jax.tree.map(jnp.asarray, batch))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), CPU)
    got, _ = ttf.loss_fn(tcfg, model, _torch_batch(batch))
    assert abs(float(got) - float(want)) <= 2e-2 * abs(float(want))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(3, 16, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 16)).astype(np.int32)
    mask = ((rng.random((3, 16)) < 0.6).astype(np.float32) if masked
            else None)
    want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = tl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if masked:      # an all-zero mask divides by 1, as the reference does
        zero = np.zeros_like(mask)
        assert float(tl.cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(zero))) == 0.0


def test_loss_falls_when_overfitting_one_batch():
    """``tests/test_train.py``'s overfit check, on the port alone."""
    _, tcfg = _cfgs("olmo-1b")
    model = ttf.init_model(tcfg, 0, device=CPU)
    _, run = _runs(tcfg, tcfg, 0, b=4, s=32)
    step = tts.make_train_step(tcfg, run)
    state = tts.init_train_state(tcfg, run.train, model)
    batch = _torch_batch(_batch(tcfg, b=4, s=32))
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(30)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.7, losses[::6]


# ---------------------------------------------------------------------------
# the optimizer and the compression, leaf by leaf
# ---------------------------------------------------------------------------

def _leaves(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(16, 24)) * 0.5).astype(dtype),
            "b": rng.normal(size=(24,)).astype(dtype),
            "s": np.asarray(rng.normal(size=()) * 3, dtype)}


def test_lr_schedule_matches_jax():
    for kw in (dict(lr=3e-3, warmup_steps=1, total_steps=20),
               dict(lr=1e-3, warmup_steps=10, total_steps=50),
               dict(lr=2e-4, warmup_steps=0, total_steps=7)):
        jc, tc = jconfig.TrainConfig(**kw), tconfig.TrainConfig(**kw)
        for step in range(0, 60):
            np.testing.assert_allclose(
                float(tadamw.lr_schedule(tc, torch.tensor(step,
                                                          dtype=torch.int32))),
                float(jadamw.lr_schedule(jc, jnp.int32(step))), rtol=1e-6,
                err_msg=f"{kw} {step}")


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _leaves(1)
    want, wnorm = jadamw.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    got, norm = tadamw.clip_by_global_norm(
        [torch.from_numpy(g[k]) for k in sorted(g)], max_norm)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    for k, t in zip(sorted(g), got):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_update_matches_jax(moment_dtype, grad_clip):
    """Three updates from zero moments; bf16 moments compared through
    fp32 at bf16's resolution."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              moment_dtype=moment_dtype, grad_clip=grad_clip)
    jc, tc = jconfig.TrainConfig(**kw), tconfig.TrainConfig(**kw)
    names = sorted(_leaves(0))
    jp = {k: jnp.asarray(v) for k, v in _leaves(0).items()}
    tp = [torch.from_numpy(_leaves(0)[k]) for k in names]
    js, ts_ = jadamw.adamw_init(jp, jc), tadamw.adamw_init(tp, tc)
    for i in range(3):
        g = _leaves(10 + i)
        jp, js, jm = jadamw.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jc)
        tp, ts_, tm = tadamw.adamw_update(
            tp, [torch.from_numpy(g[k]) for k in names], ts_, tc)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
    assert int(ts_.step) == int(js.step) == 3
    mtol = (dict(rtol=1e-6, atol=1e-7) if moment_dtype == "float32"
            else dict(rtol=1e-2, atol=1e-6))
    for i, k in enumerate(names):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)
        for got, want in ((ts_.mu[i], js.mu[k]), (ts_.nu[i], js.nu[k])):
            assert str(got.dtype).endswith(moment_dtype)
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32), **mtol)


def test_ef_compress_matches_jax_over_50_rounds():
    """The same codes, scales and residuals each round (round half to
    even in both), and the long-run mean within 2e-3 of the gradient."""
    g = _leaves(5)
    names = sorted(g)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = [torch.from_numpy(g[k]) for k in names]
    jres, tres = jcompress.init_residuals(jg), tcompress.init_residuals(tg)
    acc = [torch.zeros_like(t) for t in tg]
    for _ in range(50):
        for i, k in enumerate(names):
            jq, jscale = jcompress.compress_int8(jg[k] + jres[k])
            tq, tscale = tcompress.compress_int8(tg[i] + tres[i])
            assert_equal(tq, np.asarray(jq))
            assert float(tscale) == float(jscale)
        jhat, jres = jcompress.ef_compress(jg, jres)
        that, tres = tcompress.ef_compress(tg, tres)
        for i, k in enumerate(names):
            assert_equal(that[i], np.asarray(jhat[k]))
            assert_equal(tres[i], np.asarray(jres[k]))
            acc[i] += that[i]
    for a, t in zip(acc, tg):
        np.testing.assert_allclose((a / 50).numpy(), t.numpy(), atol=2e-3)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}
    assert dataclasses.asdict(tconfig.TrainConfig()) == \
        dataclasses.asdict(jconfig.TrainConfig())
    for name in ("SINGLE_POD", "MULTI_POD"):
        assert dataclasses.asdict(getattr(tconfig, name)) == \
            dataclasses.asdict(getattr(jconfig, name))
    for arch in ARCHS:
        jcfg, tcfg = (reg.get_config(arch) for reg in (jregistry, tregistry))
        assert dataclasses.asdict(tspecs.train_config_for(tcfg)) == \
            dataclasses.asdict(jspecs.train_config_for(jcfg))
        for seq, batch, kind, mb in ((4096, 256, "train", 0),
                                     (512, 8, "train", 4),
                                     (100, 12, "train", 0),
                                     (32768, 32, "prefill", 0),
                                     (1, 6, "train", 0)):
            runs = [specs.make_run(c, m.ShapeConfig("x", seq, batch, kind),
                                   m.MeshConfig((1, 1)), microbatch=mb)
                    for specs, m, c in ((jspecs, jconfig, jcfg),
                                        (tspecs, tconfig, tcfg))]
            assert runs[0].resolved_microbatch() == \
                runs[1].resolved_microbatch()
            assert runs[0].grad_accum_steps == runs[1].grad_accum_steps
    run = tconfig.RunConfig(tregistry.get_config("olmo-1b"),
                            tconfig.SHAPES["train_4k"])
    assert run.mesh == tconfig.SINGLE_POD
    assert tconfig.replace(run, microbatch=4).grad_accum_steps == 64


# ---------------------------------------------------------------------------
# serving a trainable model, and the launcher
# ---------------------------------------------------------------------------

def test_serving_is_unchanged_by_training_state_and_builds_no_graph():
    """``generate`` and ``prefill`` give the same tokens and logits on a
    model before and after ``init_train_state`` made it trainable, and
    after two train steps the same as a frozen copy of the trained
    weights; they return tensors without a ``grad_fn``."""
    _, tcfg = _cfgs("olmo-1b")
    prompts = _batch(tcfg, seed=4, b=2, s=16)["tokens"]
    tokens = {"tokens": torch.from_numpy(prompts)}

    def serve(model):
        out = ServeEngine(tcfg, model, max_len=32, device=CPU).generate(
            prompts, 6)
        logits = ttf.prefill(tcfg, model, tokens)
        assert logits.grad_fn is None and not logits.requires_grad
        return out, logits

    model = ttf.init_model(tcfg, 0, device=CPU)
    before = serve(model)
    _, run = _runs(tcfg, tcfg, 4)
    state = tts.init_train_state(tcfg, run.train, model)
    assert all(p.requires_grad for p in model.parameters())
    after_init = serve(model)
    assert_equal(after_init[0], before[0])
    assert_equal(after_init[1], before[1])
    step = tts.make_train_step(tcfg, run)
    for _ in range(2):
        step(state, _torch_batch(_batch(tcfg)))
    trained = serve(model)
    frozen = params_from_numpy(tcfg, params_to_numpy(tcfg, model), CPU)
    assert not any(p.requires_grad for p in frozen.parameters())
    want = serve(frozen)
    assert_equal(trained[0], want[0])
    assert_equal(trained[1], want[1])
    assert not torch.equal(trained[1], before[1])


def test_launch_train_checkpoints_and_resumes_to_the_same_losses(tmp_path):
    """Six steps with a snapshot every third step; the last snapshot is
    removed (a crash after step 5's), and ``--resume`` from the snapshot
    after step 3 reruns steps 3-5 to the uninterrupted run's losses."""
    args = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps",
            "6", "--batch", "4", "--seq", "32", "--microbatch", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    losses = tlaunch.main(args)
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step-2", "step-5"]
    import shutil
    shutil.rmtree(tmp_path / "step-5")
    resumed = tlaunch.main(args + ["--resume"])
    assert resumed == losses[3:]


@pytest.mark.parametrize("flags", [["--devices", "2"],
                                   ["--devices", "2", "--mesh", "1x2"],
                                   ["--mesh", "2x1"]])
def test_launch_train_refuses_more_than_one_device(flags, capsys):
    """More than one device trains under a mesh of virtual ranks on the
    CPU: ``--devices 2`` is 2 x 1, ``--mesh 1x2`` one data rank and two
    model ranks. A mesh whose D x M is not ``--devices`` is refused, as
    the reference's launcher asserts."""
    args = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
            "--seq", "16", *flags]
    if flags == ["--mesh", "2x1"]:
        with pytest.raises(AssertionError, match="2, 1, 1"):
            tlaunch.main(args)
        return
    losses = tlaunch.main(args)
    mesh = flags[-1] if "--mesh" in flags else "2x1"
    assert f"mesh {mesh}" in capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_launch_train_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--smoke", "--steps", "1"])


def test_make_train_step_refuses_a_mesh():
    """A mesh and a dp entry are taken, and olmo-1b's step (no MoE layer,
    so nothing to shard on one card) under a (2, 4) mesh equals the
    unsharded step's loss; the cost-exact ``unroll=True`` step's loss
    equals it within fp32 rounding (``test_torch_costexact.py`` holds
    it to the reference's)."""
    from repro_torch.distributed.mesh import local_mesh
    jcfg, tcfg = _cfgs("olmo-1b")
    _, run = _runs(tcfg, tcfg, 0)
    np_params = jax.tree.map(np.asarray,
                             jtf.init_model(jcfg, jax.random.key(0)))
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    losses = []
    for kw in ({}, dict(mesh=local_mesh((2, 4), device=CPU),
                        dp_entry="data")):
        state = tts.init_train_state(tcfg, run.train, params_from_numpy(
            tcfg, np_params, CPU))
        losses.append(float(tts.make_train_step(tcfg, run, **kw)(
            state, batch)[1]["loss"]))
    assert losses[0] == losses[1]
    state = tts.init_train_state(tcfg, run.train, params_from_numpy(
        tcfg, np_params, CPU))
    unrolled = float(tts.make_train_step(tcfg, run, unroll=True)(
        state, batch)[1]["loss"])
    np.testing.assert_allclose(unrolled, losses[0], rtol=1e-5)
