"""The port's MoE training, layer-level checks, snapshots and launcher,
against the JAX package on the CPU (the deepseek-v2-lite SMOKE config of
``tests/test_torch_moe_train.py``, whose helpers these tests share; that
file holds the stack's gradients, remat policies and train steps).

The train step slots every MoE layer's records through bucket_slots'
wrapper, twice under full remat; a record dropped at capacity or invalid
gets a zero gradient (``_gather_records`` selects zeros, it does not
keep row 0's clamped gather), and the 1s pipeline's step 0, the expert
GEMM on the empty carry, adds nothing; a layer at capacity factor 0.3
against ``jax.grad`` of the reference's; a MoE train snapshot both ways
between the packages; ``launch/train``'s checkpoint and resume.

Tolerances, as ``tests/test_torch_train.py`` states them: the loss rtol
1e-5, gradients atol 1e-5, rtol 1e-4; snapshots bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.ckpt.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.ckpt.checkpoint import _leaf_key  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim.adamw import AdamWState as JAdam  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.ckpt.checkpoint import _flatten  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from test_torch_moe_train import (ARCH, CPU, _batch, _cfgs,  # noqa: E402
                                  _runs, _torch_batch)
from torch_parity import assert_equal  # noqa: E402


def test_the_train_step_slots_through_the_wrapper(monkeypatch):
    """The train step calls bucket_slots' wrapper for every slotting of
    every MoE layer, twice under full remat (the forward and the
    backward's recompute, on the same ids), and no plain slotting."""
    import types
    jcfg, tcfg = _cfgs()
    calls = []
    real = tmoe.slot_ops.bucket_slots

    def counting(ids, n, **kw):
        calls.append((ids.clone(), n))
        return real(ids, n, **kw)

    def plain(*a, **kw):
        raise AssertionError("the train step slotted through the plain path")

    monkeypatch.setattr(tmoe, "slot_ops",
                        types.SimpleNamespace(bucket_slots=counting))
    monkeypatch.setattr(tmoe, "bucket_slots_ref", plain)
    _, run = _runs(jcfg, tcfg, 0)
    model = ttf.init_model(tcfg, 0, device=CPU)
    step = tts.make_train_step(tcfg, run)
    state = tts.init_train_state(tcfg, run.train, model)
    step.grads(state, _torch_batch(_batch(tcfg)))
    moe_layers = sum(tcfg.is_moe_layer(i) for i in range(tcfg.n_layers))
    G = tcfg.dispatch_groups
    per_layer = 2 * (G + 1)
    assert len(calls) == 2 * moe_layers * per_layer
    fwd, again = calls[:len(calls) // 2], calls[len(calls) // 2:]
    # the backward recomputes the layers last to first
    blocks = [fwd[i:i + per_layer] for i in range(0, len(fwd), per_layer)]
    again_want = [c for blk in reversed(blocks) for c in blk]
    for (a, n), (b, m) in zip(again, again_want):
        assert n == m and torch.equal(a, b)


def test_dropped_and_invalid_records_get_no_gradient():
    """``_gather_records``' backward adds a row's gradient only where a
    valid index gathered it: row 0, where the invalid indices clamp, gets
    only its own valid gathers'."""
    x = torch.randn(5, 3, requires_grad=True)
    idx = torch.tensor([0, -1, 2, -1, 0, 4, -1], dtype=torch.int32)
    tmoe._gather_records(x, idx).sum().backward()
    want = torch.tensor([2.0, 0.0, 1.0, 0.0, 1.0])[:, None].expand(5, 3)
    assert torch.equal(x.grad, want)


def test_the_empty_carry_step_adds_nothing():
    """The 1s pipeline's step 0 runs the expert GEMM on the empty carry
    (every record invalid): its output is zero and gives the experts no
    gradient."""
    _, tcfg = _cfgs()
    p = ttf.init_model(tcfg, 0, device=CPU)["blocks"][1]["moe"]
    p.requires_grad_(True)
    M = 12
    out = tmoe._expert_gemm(tcfg, p, torch.randn(M, tcfg.d_model),
                            torch.full((M,), -1, dtype=torch.int32),
                            torch.zeros(M, dtype=torch.bool))
    assert not bool(out.any())
    grads = torch.autograd.grad(out.sum(), [p["we_gate"], p["we_in"],
                                            p["we_out"]], allow_unused=True)
    assert all(g is None or not bool(g.any()) for g in grads)


@pytest.mark.parametrize("dispatch", ["1s", "2s"])
def test_dropping_layer_gradients_match_jax(dispatch):
    """At capacity factor 0.3 most records drop at their peer bucket:
    ``moe_forward``'s output and the gradients of its input and every
    leaf against ``jax.grad`` of the reference's layer."""
    jcfg, tcfg = _cfgs(dispatch, capacity_factor=0.3)
    jp = jtf.init_model(jcfg, jax.random.key(0))["blocks"]["layer0"]["moe"]
    jp = jax.tree.map(lambda a: a[0], jp)
    x = np.random.default_rng(5).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_forward(jcfg, p, xx)
        return jnp.sum(y * w) + aux
    jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True)
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_forward(tcfg, tp, tx, use_kernel=True)
    tl = (y * torch.from_numpy(w)).sum() + aux
    names = sorted(tp)
    grads = torch.autograd.grad(tl, [tp[k] for k in names] + [tx])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx),
                               atol=1e-5, rtol=1e-4)
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# snapshots and the launcher
# ---------------------------------------------------------------------------

def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _train_states(dtype):
    """The same deepseek-smoke TrainState in each package: parameters of
    the reference's ``init_model`` in ``dtype`` (the router in fp32),
    moments of seeded normals in ``dtype`` for every leaf, as
    ``adamw_init`` makes them, step 5."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp = jtf.init_model(jcfg, jax.random.key(2))
    rng = np.random.default_rng(9)
    mu, nu = (jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape), dtype), jp) for _ in range(2))
    jstate = jts.init_train_state(
        jcfg, jconfig.TrainConfig(moment_dtype=dtype), jp) \
        ._replace(opt=JAdam(jnp.int32(5), mu, nu))
    tstate = tts.init_train_state(
        tcfg, tconfig.TrainConfig(moment_dtype=dtype),
        params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), CPU))
    for dst, tree in ((tstate.opt.mu, mu), (tstate.opt.nu, nu)):
        src = params_from_numpy(tcfg, jax.tree.map(np.asarray, tree), CPU)
        for d, s in zip(dst, src.parameters()):
            d.copy_(s.detach())
    tstate.opt.step.fill_(5)
    return tcfg, jstate, tstate


def _state_leaves(tcfg, tstate) -> dict:
    out = {}
    for path, t in _flatten(tts.state_tree(tcfg, tstate)):
        out["/".join(path)] = _bits(
            t.detach().view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.detach().numpy())
    return out


def _jax_leaves(tree) -> dict:
    return {_leaf_key(p): _bits(jax.device_get(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_train_snapshot_round_trips_both_ways(tmp_path, dtype):
    """A MoE train state (parameters, ``mu`` and ``nu`` with
    ``dense_layers/layer0`` and the stacked ``blocks``) written by the
    port restores in the reference, and the reference's in the port,
    bit for bit."""
    tcfg, jstate, tstate = _train_states(dtype)
    want = _jax_leaves(jstate)
    assert any("dense_layers/layer0" in k for k in want)
    assert any("blocks/layer0/moe/we_gate" in k for k in want)
    CheckpointManager(str(tmp_path / "port")).save(
        5, tts.state_tree(tcfg, tstate), extra={"next_step": 6})
    step, got, extra = JManager(str(tmp_path / "port")).restore(
        jax.eval_shape(lambda: jstate))
    assert (step, extra) == (5, {"next_step": 6})
    have = _jax_leaves(got)
    assert sorted(have) == sorted(want)
    for k in want:
        assert_equal(have[k], want[k], k)

    JManager(str(tmp_path / "ref")).save(5, jstate, extra={"next_step": 6})
    fresh = tts.init_train_state(tcfg,
                                 tconfig.TrainConfig(moment_dtype=dtype),
                                 ttf.init_model(tcfg, 11, device=CPU))
    assert tts.restore_state(CheckpointManager(str(tmp_path / "ref")), tcfg,
                             fresh) == (5, {"next_step": 6})
    have = _state_leaves(tcfg, fresh)
    assert sorted(have) == sorted(want)
    for k in want:
        assert_equal(have[k], want[k], k)


def test_launch_train_checkpoints_and_resumes_to_the_same_losses(tmp_path):
    """``launch/train --arch deepseek-v2-lite-16b --smoke``: six steps
    with a snapshot every third; the last snapshot removed, ``--resume``
    from the one after step 3 reruns steps 3-5 to the same losses."""
    import shutil
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "6",
            "--batch", "4", "--seq", "32", "--microbatch", "2",
            "--dispatch", "2s", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3"]
    losses = tlaunch.main(args)
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step-2", "step-5"]
    shutil.rmtree(tmp_path / "step-5")
    assert tlaunch.main(args + ["--resume"]) == losses[3:]
