"""Elastic re-meshing after rank failure: the host half.

A numpy copy of ``repro/ft/elastic.py``: the same functions, with the
same outputs for the same inputs. Two properties of the framework make a
re-mesh cheap:

  * the task planner is decentralized (rank-indexed round-robin, no
    master), so reassigning a dead rank's remaining tasks is pure
    arithmetic (``rebucketize_tasks``);
  * the Combine tree dup-sums records by key across *all* ranks, so
    window ownership need not survive a re-mesh: any distribution of the
    surviving window state onto the new rank count yields the exact
    result (``fold_windows``; paper footnote 2's ownership transfer).

The live subsystem that drives these helpers (fault injection, the
re-mesh of a whole scheduled fleet, the device fold) is
:mod:`repro_torch.fleet`. ``remesh_plan`` picks a trainer's 2-D mesh
shape, ``remesh_fleet`` the engine fleet's 1-D one.
"""
from __future__ import annotations

import numpy as np

from repro_torch.config import MeshConfig

I32_MIN = int(np.iinfo(np.int32).min)
I32_MAX = int(np.iinfo(np.int32).max)   # == core.combine.SAT_MAX


def remesh_plan(n_surviving: int, prefer_model: int = 16) -> MeshConfig:
    """Largest (data, model) mesh fitting the surviving device count.

    Keeps the model axis as close to ``prefer_model`` as divides,
    shrinking data parallelism first (the batch shrinks and parameters
    re-shard; a change of tensor-parallel degree re-lays every weight)."""
    model = prefer_model
    while model > 1 and n_surviving % model:
        model //= 2
    data = n_surviving // model
    if data * model == 0:
        raise ValueError(f"no mesh for {n_surviving} devices")
    return MeshConfig((data, model), ("data", "model"))


def remesh_fleet(n_surviving: int) -> MeshConfig:
    """The engine fleet's layout over the survivors: always the 1-D
    ``("procs",)`` one the MapReduce engines run on (there is no model
    axis to keep, only the rank count changes)."""
    if n_surviving < 1:
        raise ValueError(f"no mesh for {n_surviving} surviving device(s)")
    return MeshConfig((int(n_surviving),), ("procs",))


def fold_windows(tables: np.ndarray, n_new: int) -> np.ndarray:
    """Redistribute per-rank dense Key-Value windows (P_old, vocab) onto
    ``n_new`` ranks by summing old tables round-robin (``out[r % n_new]
    += tables[r]``). Exact because Combine dup-sums by key across ranks.
    Growing (``n_new > P_old``) leaves the extra ranks' windows zero.

    Integer windows of at most 4 bytes saturate at INT32_MAX instead of
    wrapping, the numpy twin of ``repro_torch.core.combine.sat_add_i32``
    (counts are non-negative, so accumulating in int64 and clipping
    equals pairwise saturating adds). Floating and wider windows fold
    plainly."""
    tables = np.asarray(tables)
    P_old, vocab = tables.shape
    if tables.dtype.kind not in "iu" or tables.dtype.itemsize > 4:
        out = np.zeros((n_new, vocab), tables.dtype)
        for r in range(P_old):
            out[r % n_new] += tables[r]
        return out
    acc = np.zeros((n_new, vocab), np.int64)
    for r in range(P_old):
        acc[r % n_new] += tables[r].astype(np.int64)
    return np.clip(acc, I32_MIN, I32_MAX).astype(tables.dtype)


def surviving_ranks(n_procs: int, failed: list[int]) -> list[int]:
    return [r for r in range(n_procs) if r not in set(failed)]


def rebucketize_tasks(task_ids: np.ndarray, repeats: np.ndarray,
                      cursor: int, n_new: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Re-plan the not-yet-consumed tasks of a ``(P_old, T)`` assignment
    onto ``n_new`` ranks: the columns from ``cursor`` on are flattened
    (padding ``-1`` slots dropped), sorted by global task id, and dealt
    round-robin into a fresh ``(n_new, W)`` grid with ``W =
    ceil(remaining / n_new)``, padded with -1 only at its tail. Each task
    keeps its compute-repeat factor, so a re-meshed resume stays exact.

    Returns ``(ids, reps)`` ready for ``SegmentFeed.seek(0, ids, reps)``.
    """
    ids = np.asarray(task_ids, np.int32)
    reps = np.asarray(repeats, np.int32)
    assert ids.shape == reps.shape, "task/repeat grids must align"
    mask = ids[:, cursor:] >= 0
    flat_ids = ids[:, cursor:][mask]
    flat_reps = reps[:, cursor:][mask]
    order = np.argsort(flat_ids, kind="stable")
    flat_ids, flat_reps = flat_ids[order], flat_reps[order]
    n = len(flat_ids)
    W = -(-n // n_new) if n else 0
    grid = np.full((n_new, W), -1, np.int32)
    greps = np.ones((n_new, W), np.int32)
    idx = np.arange(n)
    grid[idx % n_new, idx // n_new] = flat_ids
    greps[idx % n_new, idx // n_new] = flat_reps
    return grid, greps


def fold_job_windows(handle, n_new: int) -> np.ndarray:
    """A mid-job segmented ``JobHandle``'s per-rank windows (pending
    chunk included) folded onto ``n_new`` ranks (:func:`fold_windows`)."""
    return fold_windows(handle.windows(), n_new)
