"""The port's MoE layer against the JAX package, on the CPU.

At the deepseek-v2-lite SMOKE config's MoE layer (8 experts, 2 shared,
d_model 128), with the weights of the reference's ``init_moe(cfg,
jax.random.key(0))`` carried across and inputs from numpy seeds:
``moe_forward``'s y and aux in fp32 and bf16, "1s" and "2s", top-k 1
and 2, through the kernel's wrapper (its plain version on the CPU) and
through the plain version; the slotting of ``_bucket_indices`` and the
expert grouping bit for bit, invalid records and overflow past the
capacity included; the port's "1s" against its "2s"; and the capacity
drops at ``capacity_factor=0.01``.

Tolerances: fp32 within rtol/atol 1e-5 (sums in another order); bf16
within 3e-2 * max|ref| (a token's k weighted rows are summed in fp32 and
rounded once, where the reference adds them in bf16 one by one);
integers bit for bit.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops as slot_ops  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import _tensor  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
CPU = torch.device("cpu")


def _cfgs(dtype="float32", **kw):
    return tuple(dataclasses.replace(get(ARCH), dtype=dtype,
                                     param_dtype=dtype, **kw)
                 for get in (jregistry.get_smoke_config,
                             tregistry.get_smoke_config))


def _params(jcfg, seed=0):
    jp = jmoe.init_moe(jcfg, jax.random.key(seed))
    return jp, {k: _tensor(np.asarray(v), CPU) for k, v in jp.items()}


def _x(cfg, dtype, shape=(2, 24), seed=1):
    a = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    return jnp.asarray(a, jnp.dtype(dtype)), \
        torch.from_numpy(a).to(getattr(torch, dtype))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["1s", "2s"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_forward_matches_jax(dtype, mode, top_k):
    jcfg, tcfg = _cfgs(dtype, dispatch_mode=mode, top_k=top_k)
    jp, tp = _params(jcfg)
    jx, tx = _x(tcfg, dtype)
    want_y, want_aux = jmoe.moe_forward(jcfg, jp, jx)
    got_y, got_aux = tmoe.moe_forward(tcfg, tp, tx, use_kernel=True)
    assert got_y.dtype == tx.dtype and got_aux.dtype == torch.float32
    _close(got_y, want_y, dtype, "y")
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    # on the CPU the kernel path takes the plain version: the same bits
    plain_y, plain_aux = tmoe.moe_forward(tcfg, tp, tx, use_kernel=False)
    assert torch.equal(plain_y, got_y) and torch.equal(plain_aux, got_aux)


def _ids(seed, n, E, overflow_id=None, invalid_share=0.2):
    """Seeded ids over E buckets, ids at or past E (never slotted) and a
    ``valid`` mask that drops a share of the records; ``overflow_id``
    draws about half of the records into one bucket."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, E, n)
    if overflow_id is not None:
        ids[rng.random(n) < 0.5] = overflow_id
    ids[rng.random(n) < 0.05] = E + rng.integers(0, 3)
    valid = rng.random(n) >= invalid_share
    return ids.astype(np.int32), valid


@pytest.mark.parametrize("n,E,cap,overflow", [
    (48, 1, 61, None),          # a 1s group's peer buckets at tp 1
    (48, 1, 20, None),          # ... past their capacity
    (200, 4, 30, 2),
    (300, 8, 16, 5),            # expert buffers, one hot expert
    (1000, 64, 24, 7),
    (64, 8, 64, None),          # a cap as large as the records
])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_bucket_indices_bit_for_bit(n, E, cap, overflow, use_kernel):
    """The port's slotting (bucket_slots, then the scatter) equals the
    reference's stable argsort + searchsorted bit for bit."""
    ids, valid = _ids(n * E + cap, n, E, overflow)
    want = jmoe._bucket_indices(jnp.asarray(ids), jnp.asarray(valid), E, cap)
    got = tmoe._bucket_indices(torch.from_numpy(ids),
                               torch.from_numpy(valid), E, cap,
                               use_kernel=use_kernel)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() < int(valid.sum()) or overflow is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hot", [None, 3])
def test_expert_gemm_grouping_matches_jax(dtype, hot):
    """``_expert_gemm`` on received records with invalid slots (-1) and,
    with ``hot``, most of them on one expert, past its buffer of cap_e =
    4 * ceil(M / E_loc): each record's result in its slot, the same
    records dropped, against the reference's."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, seed=2)
    M, E = 96, tcfg.n_experts
    cap_e = 4 * -(-M // E)
    rng = np.random.default_rng(11)
    ids = rng.integers(0, E, M)
    if hot is not None:
        ids[rng.random(M) < 0.7] = hot
    ids[rng.random(M) < 0.15] = -1
    ids = ids.astype(np.int32)
    jx, tx = _x(tcfg, dtype, shape=(M,), seed=3)
    want = jmoe._expert_gemm(jcfg, jp, jx, jnp.asarray(ids),
                             jnp.asarray(ids) >= 0)
    for use_kernel in (False, True):
        t_ids = torch.from_numpy(ids)
        got = tmoe._expert_gemm(tcfg, tp, tx, t_ids, t_ids >= 0,
                                use_kernel=use_kernel)
        _close(got, want, dtype, "expert outputs")
        # a dropped or invalid record's row is exactly zero in both
        zero = np.all(np.asarray(want, np.float32) == 0, -1)
        np.testing.assert_array_equal(np.all(_np(got) == 0, -1), zero)
        n_hot = int((ids == hot).sum())
        assert zero[ids == hot].sum() == max(n_hot - cap_e, 0)
        assert (n_hot > cap_e) == (hot is not None)


@pytest.mark.parametrize("top_k", [1, 2])
def test_port_1s_equals_2s(top_k):
    """The decoupled schedule is a pure re-ordering (as
    ``tests/test_moe.py::test_1s_equals_2s_exactly`` holds the
    reference): fp32, 4 groups, no drops."""
    _, cfg1 = _cfgs(dispatch_mode="1s", top_k=top_k, dispatch_groups=4,
                    capacity_factor=8.0)
    cfg2 = dataclasses.replace(cfg1, dispatch_mode="2s")
    _, tp = _params(_cfgs()[0], seed=2)
    _, x = _x(cfg1, "float32", shape=(1, 32), seed=3)
    y1, a1 = tmoe.moe_forward(cfg1, tp, x)
    y2, a2 = tmoe.moe_forward(cfg2, tp, x)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(a1), float(a2), rtol=1e-6)


@pytest.mark.parametrize("mode", ["1s", "2s"])
def test_capacity_drops_match_jax(mode):
    """At ``capacity_factor=0.01`` almost every record drops; the port
    drops the same ones (y equal in fp32, no shared experts), and the
    output is smaller than with the default capacity."""
    jcfg, tcfg = _cfgs(dispatch_mode=mode, capacity_factor=0.01,
                       n_shared_experts=0)
    jp, tp = _params(jcfg, seed=4)
    jx, tx = _x(tcfg, "float32", shape=(1, 64), seed=5)
    want, _ = jmoe.moe_forward(jcfg, jp, jx)
    got, _ = tmoe.moe_forward(tcfg, tp, tx, use_kernel=True)
    _close(got, want, "float32", "y")
    full, _ = tmoe.moe_forward(dataclasses.replace(tcfg, capacity_factor=1.25),
                               tp, tx)
    assert float(got.abs().sum()) < float(full.abs().sum())


def test_aux_loss_balanced_is_one():
    """Uniform routing gives the switch loss its minimum, 1, as the
    reference's does."""
    _, cfg = _cfgs(top_k=1)
    E = cfg.n_experts
    probs = torch.full((64 * E, E), 1.0 / E)
    ids = torch.arange(E, dtype=torch.int32).repeat(64)[:, None]
    np.testing.assert_allclose(float(tmoe._aux_loss(cfg, probs, ids)), 1.0,
                               rtol=1e-5)


def test_the_plain_path_never_reaches_the_wrapper(monkeypatch):
    """``use_kernel=False`` slots through the plain version only; the
    kernel path calls the wrapper twice a pipeline step (G + 1 steps)."""
    calls = []

    def counting(ids, n, **kw):
        calls.append((ids.numel(), n))
        return slot_ops.bucket_slots(ids, n, **kw)

    monkeypatch.setattr(tmoe, "slot_ops", types.SimpleNamespace(
        bucket_slots=counting))
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    _, x = _x(tcfg, "float32")
    tmoe.moe_forward(tcfg, tp, x, use_kernel=False)
    assert calls == []
    tmoe.moe_forward(tcfg, tp, x, use_kernel=True)
    G, T, k = tcfg.dispatch_groups, 48, tcfg.top_k
    Tkg = T // G * k
    cap = int(tcfg.capacity_factor * Tkg) + 1
    assert calls == [(Tkg, 1), (cap, tcfg.n_experts)] * (G + 1)


@pytest.mark.parametrize("what", ["mesh", "dp_entry", "unroll",
                                  "replicated", "a2a"])
def test_sharded_parts_raise(what):
    """``unroll`` runs and changes nothing (the dispatch's steps are a
    Python loop already): the layer bit for bit its ``unroll=False``
    (``test_torch_costexact.py`` holds it to the reference's). The
    sharded parts run (their parity with the reference's ``shard_map`` on
    8 devices is ``test_torch_mesh_moe.py``'s), and each case holds one
    here: the
    layer under a (2, 4) mesh at a capacity no shard overflows equals the
    reference's unsharded layer; ``dp_entry`` without a mesh is ignored,
    as the reference ignores it; the replicated dispatch on one shard
    equals the reference's; ``_a2a`` over "model" delivers block j of
    rank i to rank j as ``lax.all_to_all(x, axis, 0, 0)`` does."""
    from repro_torch.distributed.mesh import local_mesh
    jcfg, tcfg = _cfgs(capacity_factor=8.0)
    jp, tp = _params(jcfg)
    jx, x = _x(tcfg, "float32", shape=(4, 8))
    if what == "unroll":
        for a, b in zip(tmoe.moe_forward(tcfg, tp, x, unroll=True),
                        tmoe.moe_forward(tcfg, tp, x)):
            assert torch.equal(a, b)
    elif what in ("mesh", "dp_entry"):
        want_y, want_aux = jmoe.moe_forward(jcfg, jp, jx, dp_entry="data")
        mesh = local_mesh((2, 4), device=CPU) if what == "mesh" else None
        got_y, got_aux = tmoe.moe_forward(tcfg, tp, x, mesh=mesh,
                                          dp_entry="data")
        _close(got_y, want_y, "float32", what)
        np.testing.assert_allclose(float(got_aux), float(want_aux),
                                   rtol=1e-5)
    elif what == "replicated":
        E = tcfg.n_experts
        ids, gates, _ = jmoe._route(jcfg, jp["router"], jx[0])
        want = jmoe._dispatch_replicated(jcfg, jp, jx[0], ids, gates, E,
                                         None)
        got = tmoe._dispatch_replicated(
            tcfg, tp, x[:1], torch.from_numpy(np.asarray(ids))[None],
            torch.from_numpy(np.asarray(gates))[None], E, None)
        _close(got[0], want, "float32", what)
    else:
        mesh = local_mesh((2, 4), device=CPU)
        blocks = torch.arange(2 * 4 * 4 * 3).reshape(8, 4, 3)
        got = tmoe._a2a(blocks, "model", mesh).view(2, 4, 4, 3)
        want = blocks.view(2, 4, 4, 3).transpose(1, 2)
        assert torch.equal(got, want)
        assert torch.equal(tmoe._a2a(blocks, None), blocks)
