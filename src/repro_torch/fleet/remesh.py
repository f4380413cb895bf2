"""Re-mesh a checkpointed job onto a different rank count, exactly.

Counterpart of ``repro/fleet/remesh.py``. A snapshot taken at P_old
ranks is folded onto P_new and resumed mid-stream, and the resumed job's
records equal those of a run that never failed, because:

  * Combine dup-sums records by key across ranks (paper footnote 2's
    ownership transfer), so ANY redistribution of the per-rank dense
    windows is exact, and ``r_old % P_new`` round-robin folding is as
    good as any;
  * task ids are global and the planner is decentralized, so
    re-bucketizing the not-yet-executed assignment is pure arithmetic
    (:func:`repro_torch.ft.elastic.rebucketize_tasks`);
  * the owner map is carry *data*, so folding it (``owner % P_new``) and
    clipping split widths re-targets the reduce side.

The fold runs on the job's device as a plain torch program over the rank
dimension (:func:`fold_program`; the reference's is a ``shard_map``
program, not a Pallas kernel): each new rank sums its group of old
windows with ``sat_add_i32`` (folding near-full int32 count tables must
saturate, not wrap), and the program emits a psum checksum of the folded
windows, wrapped to int32. The host holds it against the independent
numpy twin (:func:`repro_torch.ft.elastic.fold_windows`) before the job
resumes; a disagreement raises :class:`RemeshChecksumError` instead of
resuming from corrupt windows. The program ships through fleetlint like
every engine program (:func:`remesh_program_handles`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.combine import sat_add_i32
from repro_torch.core.kv import KEY_SENTINEL
from repro_torch.core.partition import fold_owner_map, hash_owner_map
from repro_torch.core.windows import EngineCarry
from repro_torch.distributed.collectives import psum
from repro_torch.ft.elastic import fold_windows, rebucketize_tasks

I32_MASK = 0xFFFFFFFF


class RemeshChecksumError(RuntimeError):
    """The device fold and the host numpy twin disagree on the folded
    windows: the re-meshed job would resume from corrupt state, so the
    restore refuses. A framework bug (the two folds are independent
    implementations of one sum), not a user error."""


def _wrap_i32_sum(a) -> int:
    """int32 wrap-around sum of an array: the checksum both sides
    compute (two's complement, so the int64 sum mod 2^32 equals an int32
    accumulation bit for bit)."""
    s = int(np.asarray(a, np.int64).sum()) & I32_MASK
    return s - (1 << 32) if s >= (1 << 31) else s


# -- the device fold program -------------------------------------------------

def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def fold_program(n_old: int, n_new: int, vocab: int, device):
    """The fold on the NEW rank count: ``(groups (P_new, G, vocab),
    owner_map (P_new, vocab), owner_split (P_new, vocab))`` ->
    ``(folded windows, owner map % P_new, split clipped to [1, P_new],
    checksum (P_new,))``, all int32 on ``device``.

    Inputs are host-grouped by destination: ``groups[r % P_new, r //
    P_new] = window[r]`` with ``G = ceil(P_old / P_new)`` and zero
    padding, so each new rank sums exactly its own group (in ascending
    g, the host twin's order). The owner rows are replicated; the
    elementwise ``%`` and clip keep them so, and the checksum (each
    rank's window sum wrapped to int32, then ``psum``) is replicated
    too."""
    n_new, vocab = int(n_new), int(vocab)
    G = -(-int(n_old) // n_new)
    device = torch.device(device)

    def fold(groups, owner_map, owner_split):
        assert tuple(groups.shape) == (n_new, G, vocab), groups.shape
        groups, owner_map, owner_split = (
            x.to(device=device, dtype=torch.int32)
            for x in (groups, owner_map, owner_split))
        t = groups[:, 0]
        for g in range(1, G):
            t = sat_add_i32(t, groups[:, g])
        om = torch.remainder(owner_map, n_new)
        osplit = owner_split.clamp(1, n_new)
        csum = psum(_wrap_i32(t.sum(dim=1, dtype=torch.int64)))
        return t, om, osplit, csum

    return fold


def remesh_program_handles(device=None, n_old: int | None = None,
                           vocab: int = 64, n_new: int = 8) -> list:
    """The fold program as a fleetlint :class:`ProgramHandle` on ``device``
    (the card unless given): the re-mesh path runs through the same
    program rules as the engines (REP001 holds the folded owner map and
    split and the checksum replicated; SPMD001 the checksum's psum over
    the rank dim). Its seeded inputs: count windows in [0, 1000) grouped
    onto ``n_new`` ranks, and the old hash map and split rows replicated
    on every rank."""
    from repro_torch.core.registry import ProgramHandle
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    n_new = int(n_new)
    if n_old is None:
        n_old = 2 * n_new        # a genuine shrink: G = 2
    G = -(-int(n_old) // n_new)
    fold = fold_program(n_old, n_new, vocab, device)

    def run(seed: int):
        rng = np.random.default_rng(seed)
        groups = rng.integers(0, 1000, (n_new, G, vocab)).astype(np.int32)
        om = np.broadcast_to(hash_owner_map(vocab, n_old), (n_new, vocab))
        osplit = np.broadcast_to(rng.integers(1, n_old + 1, (vocab,)),
                                 (n_new, vocab))
        yield fold, tuple(torch.as_tensor(np.ascontiguousarray(a, np.int32))
                          .to(device) for a in (groups, om, osplit))

    return [ProgramHandle(
        name=f"fleet/remesh/fold[{n_old}->{n_new}]", n_procs=n_new, run=run,
        arg_paths=("tables", "owner_map", "owner_split"),
        out_paths=("table", "owner_map", "owner_split", "checksum"),
        replicated_in=("owner_map", "owner_split"),
        replicated_out=("owner_map", "owner_split", "checksum"),
        seeded=("tables", "owner_map", "owner_split"))]


# -- host orchestration ------------------------------------------------------

def _zeros_like_carry() -> EngineCarry:
    """Structure and dtype only, for ``CheckpointManager.restore``: leaf
    shapes come from the npz, so one scalar template restores a snapshot
    taken at ANY rank count, as host arrays."""
    return EngineCarry(*(np.zeros((), np.int32)
                         for _ in EngineCarry._fields))


def _fold_pending(carry: EngineCarry) -> np.ndarray:
    """Old per-rank windows with the in-flight ``pending_*`` chunks
    folded in, int32-saturated: the complete record of every executed
    task. Accumulates in int64 then clips, what the engine's
    ``sat_add_i32`` gives had it drained the chunk (non-negative
    counts)."""
    table = np.asarray(carry.table)
    P_old = table.shape[0]
    acc = table.astype(np.int64)
    pk = np.asarray(carry.pending_k).reshape(P_old, -1)
    pv = np.asarray(carry.pending_v).reshape(P_old, -1)
    for r in range(P_old):
        valid = pk[r] != int(KEY_SENTINEL)
        np.add.at(acc[r], pk[r][valid], pv[r][valid].astype(np.int64))
    i32 = np.iinfo(np.int32)
    return np.clip(acc, i32.min, i32.max).astype(np.int32)


def _check_compat(handle, found: int, extra: dict):
    """The snapshot-compatibility guards of ``JobHandle.restore``, in the
    reference's words: a cross-P fold cannot paper over a backend,
    stealing or partitioner mismatch any more than a same-P restore
    can."""
    saved = extra.get("backend")
    if saved is not None and saved != handle.backend.name:
        raise ValueError(
            f"checkpoint step {found} was taken by backend {saved!r} — "
            f"it cannot elastic-restore into a {handle.backend.name!r} "
            f"handle; resubmit with JobConfig(backend={saved!r})")
    saved_steal = extra.get("stealing")
    if (saved_steal is not None
            and bool(saved_steal) != handle.config.stealing):
        raise ValueError(
            f"checkpoint step {found} was taken with "
            f"stealing={bool(saved_steal)} — resubmit with "
            f"JobConfig(stealing={bool(saved_steal)})")
    saved_part = extra.get("partitioner")
    if saved_part is not None and saved_part != handle.spec.partitioner:
        raise ValueError(
            f"checkpoint step {found} was taken with "
            f"partitioner={saved_part!r} — resubmit with "
            f"JobConfig(partitioner={saved_part!r})")


def fold_inputs(carry: EngineCarry, P_new: int, partitioner: str
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """What the fold program takes for a snapshot's host carry:
    ``(tables, groups, owner_map, owner_split)``, the first the old
    windows with their pending chunks (:func:`_fold_pending`), the rest
    at P_new. Under the hash partitioner the owner rows are the fresh
    P_new rule (the hash rule is P-dependent: the old map % P_new would
    skew ownership); a sampled map reflects the data's skew, which did
    not change, so it is folded."""
    tables = _fold_pending(carry)                    # (P_old, vocab)
    P_old, vocab = tables.shape
    G = -(-P_old // P_new)
    groups = np.zeros((P_new, G, vocab), np.int32)
    for r in range(P_old):
        groups[r % P_new, r // P_new] = tables[r]
    if partitioner == "hash":
        om = hash_owner_map(vocab, P_new)
        osplit = np.ones((vocab,), np.int32)
    else:
        om, osplit = fold_owner_map(np.asarray(carry.owner_map)[0],
                                    np.asarray(carry.owner_split)[0], P_new)
    om, osplit = (np.broadcast_to(np.asarray(a, np.int32), (P_new, vocab))
                  .copy() for a in (om, osplit))
    return tables, groups, om, osplit


def elastic_restore(handle, manager, step: int | None = None):
    """Resume a snapshot taken at ANY rank count into ``handle`` (which
    runs at ``handle.spec.n_procs``, the NEW count).

    A same-P snapshot takes the ordinary seek-and-restore path. A
    cross-P snapshot is folded: pending chunks into the windows (host),
    old windows and owner rows onto the new ranks (:func:`fold_program`
    on the handle's device, its checksum held to the numpy twin), and
    the not-yet-executed tasks re-bucketized round-robin; then
    installed by :meth:`JobHandle.elastic_load`. No input read is
    replayed in either path. Returns the handle."""
    found, extra = manager.peek(step)
    _check_compat(handle, found, extra)
    P_new = handle.spec.n_procs
    _, carry, extra = manager.restore(_zeros_like_carry(), step=found)
    P_old = int(np.asarray(carry.table).shape[0])
    if P_old == P_new:
        return handle.restore(manager, step=found)

    tables, groups, om, osplit = fold_inputs(carry, P_new,
                                             handle.spec.partitioner)
    vocab = tables.shape[1]
    fn = fold_program(P_old, P_new, vocab, handle.device)
    table_new, om_new, os_new, csum = fn(
        *(torch.from_numpy(a) for a in (groups, om, osplit)))
    got = int(csum[0])
    want = _wrap_i32_sum(fold_windows(tables, P_new))
    if got != want:
        raise RemeshChecksumError(
            f"device fold checksum {got} != host twin {want} folding "
            f"{P_old} -> {P_new} ranks (vocab={vocab}) — refusing to "
            "resume from corrupt windows")

    ids, reps = rebucketize_tasks(
        np.asarray(extra["task_ids"], np.int32),
        np.asarray(extra["repeats"], np.int32),
        int(extra["cursor"]), P_new)
    return handle.elastic_load(table_new, om_new[0], os_new[0], ids, reps)
