"""The port's fused_map plain version and wrapper against the JAX kernel.

``repro_torch.kernels.fused_map.ref.fused_step_ref`` (the plain version
the CUDA kernel is held to) must equal the reference's Pallas kernel,
run in interpret mode, on every output of every case of the kernel test
matrix — the same matrix ``chip_smoke.py`` holds the CUDA kernel to on
the card. Over the wide matrix (task sizes 1,025-16,384) it must equal
the reference's ``fused_step_ref``: the Pallas kernel's interpret mode
builds L x L compare matrices there. Tolerance 0 (int32 path).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.kernels.fused_map import ops as jops  # noqa: E402
from repro.kernels.fused_map import ref as jref  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.fused_map import ops, ref  # noqa: E402
from torch_parity import assert_equal, to_torch  # noqa: E402

_ARGS = ("keys", "vals", "rep", "task_id", "owner_map", "owner_split",
         "pending_k", "pending_v", "table")
_CASES = [c for c in chip_smoke.fused_matrix() if c[0] != "full_width"]
_WIDE = list(chip_smoke.fused_wide_matrix())


@pytest.mark.parametrize("name,case", _CASES, ids=[c[0] for c in _CASES])
def test_fused_step_ref_matches_pallas_kernel(name, case):
    args, P, cap = case
    got = ref.fused_step_ref(**{k: to_torch(v) for k, v in args.items()},
                             n_procs=P, cap=cap)
    for r in range(P):
        want = jops.fused_map_step(*(jnp.asarray(args[k][r]) for k in _ARGS),
                                   n_procs=P, cap=cap, interpret=True)
        for out, g, w in zip(("table", "bk", "bv", "counts"), got, want):
            assert_equal(g[r], w, f"{name} rank {r} {out}")


@pytest.mark.parametrize("name,case", _WIDE, ids=[c[0] for c in _WIDE])
def test_fused_step_ref_matches_reference_ref_past_1024(name, case):
    args, P, cap = case
    got = ref.fused_step_ref(**{k: to_torch(v) for k, v in args.items()},
                             n_procs=P, cap=cap)
    for r in range(P):
        want = _jax_step(*(jnp.asarray(args[k][r]) for k in _ARGS),
                         n_procs=P, cap=cap)
        for out, g, w in zip(("table", "bk", "bv", "counts"), got, want):
            assert_equal(g[r], w, f"{name} rank {r} {out}")


_jax_step = jax.jit(jref.fused_step_ref, static_argnames=("n_procs", "cap"))


def test_wide_matrix_spans_every_block_of_the_kernel():
    """The wide matrix holds each side of every change of the kernel's
    block (pow2(2 S) pairs 4,096-32,768, the last two through the global
    scratch), cap 1 and 1,024, and the task sizes up to MAX_TASK_SIZE."""
    sizes = {args["keys"].shape[1] for args, _, _ in dict(_WIDE).values()}
    assert {1025, 2048, 2049, 4096, 4097, 8192, 16384} <= sizes
    assert max(sizes) == ops.MAX_TASK_SIZE
    assert {1 << (2 * S - 1).bit_length() for S in sizes} == \
        {4096, 8192, 16384, 32768}
    assert {cap for _, _, cap in dict(_WIDE).values()} >= {1, 1024}


def test_plain_version_takes_task_sizes_past_the_kernel_limit():
    """The plain version takes any task size: on CPU tensors the wrapper
    computes S = 2048 as the reference's Pallas kernel does, on every
    output of every rank."""
    args, P, cap = chip_smoke.fused_case(17, 2, 2048, 4096, 64, [1, 2],
                                         split=True)
    a = {k: to_torch(v).clone() for k, v in args.items()}   # folds in place
    got = ops.fused_map(**a, n_procs=P, cap=cap)
    for r in range(P):
        want = jops.fused_map_step(*(jnp.asarray(args[k][r]) for k in _ARGS),
                                   n_procs=P, cap=cap, interpret=True)
        for out, g, w in zip(("table", "bk", "bv", "counts"), got, want):
            assert_equal(g[r], w, f"S=2048 rank {r} {out}")


def test_wrap_negative_case_differs_by_rep():
    """The matrix's wrap-negative case really exercises the recurrence:
    ranks with rep 1, 2, 3 emit key 3 with -2147483644, 8, -2147483644
    (pushed in a bucket or kept by the overflow fold)."""
    from repro_torch.core.windows import DenseWindow
    args, P, cap = dict(_CASES)["wrap_negative_rep123"]
    a = {k: to_torch(v) for k, v in args.items()}
    table, bk, bv, _ = ref.fused_step_ref(**a, n_procs=P, cap=cap)
    pend = DenseWindow(torch.zeros_like(table)).put(
        a["pending_k"].reshape(P, -1), a["pending_v"].reshape(P, -1)).table
    kept = table - a["table"] - pend
    key3 = [int(kept[r, 3]) + int(bv[r][bk[r] == 3].sum()) for r in range(P)]
    assert key3 == [-2147483644, 8, -2147483644]


def test_wrapper_on_cpu_takes_plain_version_in_place():
    args, P, cap = dict(_CASES)["sweep2"]
    a = {k: to_torch(v) for k, v in args.items()}
    want = ref.fused_step_ref(**a, n_procs=P, cap=cap)
    table = a["table"]
    launches = ops.fused_map.launches
    got = ops.fused_map(**a, n_procs=P, cap=cap)
    assert got[0] is table                     # folded in place
    for g, w in zip(got, want):
        assert_equal(g, w)
    assert ops.fused_map.launches == launches  # the plain version is no launch


def test_use_kernel_true_on_cpu_raises():
    args, P, cap = dict(_CASES)["sweep0"]
    a = {k: to_torch(v) for k, v in args.items()}
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.fused_map(**a, n_procs=P, cap=cap, use_kernel=True)


def test_policy_on_cuda_tensors(monkeypatch):
    """A CUDA tensor takes the kernel on sm_90, demanded or not, and
    raises on any other card — decided without a card by faking one
    (the policy reads a device's capability once, so each fake card
    starts from an empty cache)."""
    fake = types.SimpleNamespace(device=torch.device("cuda", 0))
    monkeypatch.setattr(backend, "_CAPABILITY", {})
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d=None: (9, 0))
    assert backend.use_kernel(fake) is True
    assert backend.use_kernel(fake, require=True) is True
    monkeypatch.setattr(backend, "_CAPABILITY", {})
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d=None: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100")
    with pytest.raises(RuntimeError, match="sm_80"):
        backend.use_kernel(fake)
    assert backend.use_kernel(torch.zeros(1)) is False


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "task"])
def test_wrapper_checks_inputs(bad):
    args, P, cap = dict(_CASES)["sweep0"]
    a = {k: to_torch(v) for k, v in args.items()}
    if bad == "dtype":
        a["vals"] = a["vals"].long()
    elif bad == "shape":
        a["pending_k"] = a["pending_k"][:, :, :-1].contiguous()
    elif bad == "contiguity":
        a["owner_map"] = a["owner_map"].t().contiguous().t()
    else:           # an empty task; above 1024 only the kernel refuses
        a["keys"] = torch.zeros((P, 0), dtype=torch.int32)
        a["vals"] = a["keys"].clone()
    with pytest.raises((TypeError, ValueError)):
        ops.fused_map(**a, n_procs=P, cap=cap)


def test_kernel_source_and_bound_are_wired():
    """The CUDA source exists with its C entry point, and the smoke's
    bound of the full-width step is byte-bound and positive."""
    src = ops.SOURCE.read_text()
    assert 'extern "C" int fused_map_launch(' in src
    assert "fused_map_pallas" in src            # names what it replaces
    args, P, cap = chip_smoke.full_width_case()
    bound_ms, by, work = chip_smoke.fused_bound(args, P, cap)
    assert by == "bytes" and bound_ms > 0 and work["bytes"] > 0
    assert jax.default_backend() == "cpu"


def _window_slots_numpy(args, P, cap):
    """Unique keys and folded window slots of a step without split keys,
    counted directly: an owner's unique keys past the first ``cap`` (in
    key order) overflow, and they and the pending chunk reach the window."""
    sent = 2**31 - 1
    uniq = slots = 0
    for r in range(P):
        k = np.unique(args["keys"][r][args["keys"][r] != sent])
        uniq += k.size
        own = args["owner_map"][r][k]
        over = np.concatenate([k[own == o][cap:] for o in range(P)])
        pend = args["pending_k"][r].ravel()
        slots += np.unique(np.concatenate([pend[pend != sent], over])).size
    return uniq, slots


@pytest.mark.parametrize("name", ["cap1", "all_dup", "near_sat_rep2",
                                  "full_width"])
def test_bound_charges_window_only_where_records_fold(name):
    """The bound reads and writes the window only at the pending chunk's
    keys and the bucket overflow, not at every unique key."""
    args, P, cap = dict(chip_smoke.fused_matrix())[name]
    uniq, slots = chip_smoke.window_slots(args, P, cap)
    assert (uniq, slots) == _window_slots_numpy(args, P, cap)
    pend = sum(np.unique(r[r != 2**31 - 1]).size
               for r in args["pending_k"].reshape(P, -1))
    if name == "cap1":
        assert slots > pend                     # the overflow is counted
    if name == "full_width":
        assert slots == pend                    # no owner overflows there
    _, _, work = chip_smoke.fused_bound(args, P, cap)
    assert work["window_slots"] == slots and work["unique"] == uniq
