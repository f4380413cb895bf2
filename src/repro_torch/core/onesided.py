"""MapReduce-1S — the paper's decoupled one-sided engine, ranks as dim 0.

Counterpart of ``repro/core/onesided.py`` (paper §2.1, Fig 1):

  Map + Local Reduce   step t: map_fn -> local_reduce -> bucketize
  one-sided put        the (P, P, cap) buckets swap rank and peer dims
                       (``all_to_all_blocks``); the carry holds the
                       received chunk, folded one step later
  Reduce               incremental: each received chunk is folded into
                       the dense Key-Value window
  ownership transfer   bucket overflow stays local and is folded into the
                       mapper's own window (paper footnote 2)
  Combine              ⌈log2 P⌉-level merge tree (core/combine.py)

The reference's ``lax.scan`` over a segment is a Python loop over its
columns, one step for all P ranks at a time. ``JobSpec.fused_map`` runs
phases II-III of a step as the ``fused_map`` CUDA kernel, which folds
into the carry's window in place; the default path composes the same
torch ops as the kernel's plain version. Both give identical carries.

On a CUDA device the fused step is one CUDA graph (:class:`StepGraphs`),
captured once for each distinct ``max_rep`` on the carry's own buffers
and replayed once a step, as the reference runs a segment as one
compiled program. The CPU and the unfused path run the eager loop.

With ``JobSpec.stealing`` a segment's whole claim schedule is computed
on the host first (``core/steal.py``), from its grid and the carry's
work row, and each step's column is gathered from the schedule: step k
runs on executor e the task that e claimed at step k, wherever its input
lies. Steps then run as above, so the stealing job replays the same
graphs, one a step.

With ``JobSpec.code_rate`` r > 1 (``core/coded.py``) a step consumes
one r-wide column block (:func:`_coded_step`): every member of a code
group maps the same r tasks, and the bucket push becomes the XOR-coded
exchange (``collectives.coded_exchange``). Under stealing, groups claim
whole blocks (``steal.coded_steal_schedule``). With ``JobSpec.coslots``
> 1 the step runs a WorkDomain's composite task space
(``core/workdomain.py``): each task's keys are offset into its member
job's window slice, and ``carry.job_work`` counts each member's executed
repeats. Neither runs the fused step: the reference refuses both with
``fused_map``, so they run the eager loop.
"""
from __future__ import annotations

import time
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import steal
from repro_torch.core.combine import tree_combine
from repro_torch.core.kv import (KEY_SENTINEL, bucketize, local_reduce,
                                 local_reduce_repeated)
from repro_torch.core.partition import lookup_owner
from repro_torch.core.registry import JobSpec, register_backend
from repro_torch.core.windows import (STATUS_REDUCE, DenseWindow,
                                      EngineCarry, combine_records,
                                      init_carry)
from repro_torch.data.feed import Segment
from repro_torch.distributed.collectives import (all_to_all_blocks,
                                                coded_exchange, psum)
from repro_torch.kernels.fused_map import ops as fused_ops
from repro_torch.kernels.fused_map.ops import fused_map


def _step(spec: JobSpec, map_fn: Callable, carry: EngineCarry,
          task, task_id, rep, max_rep: int):
    """One engine step for all ranks: ``task (P, S)``, ``task_id`` and
    ``rep`` (P,), ``max_rep`` the host-known max of ``rep``."""
    P, cap = spec.n_procs, spec.push_cap
    if spec.coslots > 1:
        keys, vals = _composite_map(spec, map_fn, carry, task, task_id,
                                    rep, max_rep)
    else:
        # Phase I: Map (+ simulated imbalance via the repeat factor)
        keys, vals = map_fn(task, task_id, rep, max_rep)
    if spec.fused_map:
        # Phases II+III in one kernel; the window is folded in place
        table, bk, bv, _ = fused_map(
            keys.contiguous(), vals.contiguous(), rep, task_id,
            carry.owner_map, carry.owner_split, carry.pending_k,
            carry.pending_v, carry.table, n_procs=P, cap=cap)
        return carry._replace(table=table, pending_k=all_to_all_blocks(bk),
                              pending_v=all_to_all_blocks(bv),
                              cursor=carry.cursor + 1)
    # Phase II: Local Reduce, re-computed rep[r] times (footnote 5)
    uk, uv = local_reduce_repeated(keys, vals, keys.shape[-1], rep, max_rep)
    owners = lookup_owner(carry.owner_map, carry.owner_split, uk, task_id, P)
    bk, bv, _, (ofk, ofv) = bucketize(uk, uv, P, cap, owners=owners)
    # Phase III (incremental Reduce): fold the previous step's chunk and
    # keep the overflow locally (ownership transfer); in place
    win = DenseWindow(carry.table)
    win.put(carry.pending_k.reshape(P, -1), carry.pending_v.reshape(P, -1))
    win.put(ofk, ofv)
    return carry._replace(pending_k=all_to_all_blocks(bk),
                          pending_v=all_to_all_blocks(bv),
                          cursor=carry.cursor + 1)


def _composite_map(spec: JobSpec, map_fn: Callable, carry: EngineCarry,
                   task, task_id, rep, max_rep: int):
    """Phase I of a WorkDomain's step: the composite id ``slot * costride
    + local`` gives ``map_fn`` the member's local id, every live key is
    offset into the member's window slice (``slot * (vocab //
    coslots)``), and each live task's repeats land in its slot of the
    replicated ``carry.job_work`` row through a psum, as the reference's
    do."""
    base = spec.vocab // spec.coslots
    live = task_id >= 0
    slot = torch.where(live, task_id // spec.costride, 0)
    local_id = torch.where(live, task_id - slot * spec.costride, task_id)
    keys, vals = map_fn(task, local_id, rep, max_rep)
    keys = torch.where(keys == KEY_SENTINEL, keys,
                       keys + (slot * base).unsqueeze(-1))
    # each rank's own repeats in its task's slot; the psum sums them
    own = torch.zeros_like(carry.job_work)
    own.scatter_add_(1, slot.long().unsqueeze(1),
                     torch.where(live, rep, 0).unsqueeze(1))
    carry.job_work.add_(psum(own))
    return keys, vals


def _coded_step(spec: JobSpec, map_fn: Callable, carry: EngineCarry,
                task, task_id, rep, max_rep: int):
    """One step of the coded engine (``code_rate`` r > 1) for all ranks:
    ``task (P, r, S)``, ``task_id``/``rep (P, r)`` one r-wide column
    block, ``max_rep`` the host-known max of its repeats. Every member of
    a code group holds the same block, maps its r tasks (as P·r rows of
    one ``map_fn`` call), reduces each under its repeats and the union
    at ``r * task_size``, and pushes through the XOR-coded exchange; one
    member of each group, rotating with the step, keeps the union's
    bucket overflow."""
    P, cap, r = spec.n_procs, spec.push_cap, spec.code_rate
    rows = rep.reshape(-1)
    keys, vals = map_fn(task.reshape(P * r, -1), task_id.reshape(-1),
                        rows, max_rep)
    uk, uv = local_reduce_repeated(keys, vals, keys.shape[-1], rows,
                                   max_rep)
    uk, uv, _ = local_reduce(uk.reshape(P, -1), uv.reshape(P, -1),
                             r * spec.task_size)
    # the block's first id picks split replicas for the whole union
    owners = lookup_owner(carry.owner_map, carry.owner_split, uk,
                          task_id[:, 0], P)
    bk, bv, _, (ofk, ofv) = bucketize(uk, uv, P, cap, owners=owners)
    rk, rv = coded_exchange(bk, bv, r)
    win = DenseWindow(carry.table)
    win.put(carry.pending_k.reshape(P, -1), carry.pending_v.reshape(P, -1))
    keep = ((carry.cursor % r) == (torch.arange(P, device=uk.device) % r)
            ).unsqueeze(-1)
    win.put(torch.where(keep, ofk, KEY_SENTINEL), torch.where(keep, ofv, 0))
    return carry._replace(pending_k=rk, pending_v=rv,
                          cursor=carry.cursor + 1)


def _coded_segment(spec: JobSpec, map_fn: Callable, carry: EngineCarry,
                   seg: Segment) -> EngineCarry:
    """Advance one coded segment: ``seg`` of width nb·r, block b the
    columns ``[b·r, (b+1)·r)`` and step b."""
    P, n, S = seg.tokens.shape
    r = spec.code_rate
    assert n % r == 0, (n, r)
    nb = n // r

    def blocks(x):
        return x.reshape(P, nb, r, -1).transpose(0, 1)

    max_rep = seg.reps.reshape(P, nb, r).max(axis=(0, 2))
    return _run_steps(spec, map_fn, carry, blocks(seg.tokens),
                      blocks(seg.task_ids).squeeze(-1),
                      blocks(seg.repeats).squeeze(-1), max_rep, None,
                      step=_coded_step)


def _fused_step_into(spec: JobSpec, map_fn: Callable, carry: EngineCarry,
                     task, task_id, rep, max_rep: int):
    """The fused step written into the carry's own buffers (the window,
    the pending chunk, the cursor): what :class:`StepGraphs` captures.
    Equal to ``_step``'s fused carry."""
    keys, vals = map_fn(task, task_id, rep, max_rep)
    _, bk, bv, _ = fused_map(
        keys.contiguous(), vals.contiguous(), rep, task_id, carry.owner_map,
        carry.owner_split, carry.pending_k, carry.pending_v, carry.table,
        n_procs=spec.n_procs, cap=spec.push_cap)
    all_to_all_blocks(bk, out=carry.pending_k)
    all_to_all_blocks(bv, out=carry.pending_v)
    carry.cursor.add_(1)


class StepGraphs:
    """The fused step as CUDA graphs on one carry's buffers: one graph for
    each distinct ``max_rep`` (it sizes ``map_fn``'s repeat pass), each
    holding one ``fused_map`` launch. A step copies its column into one
    static input buffer, ``[tokens (P*S) | task ids (P) | repeats (P)]``,
    and replays; a failed capture or replay raises."""

    def __init__(self, spec: JobSpec, map_fn: Callable, carry: EngineCarry):
        P, S = spec.n_procs, spec.task_size
        self.spec, self.map_fn, self.carry = spec, map_fn, carry
        self.device = carry.table.device
        self.static = torch.empty(P * S + 2 * P, dtype=torch.int32,
                                  device=self.device)
        self.inputs = (self.static[:P * S].view(P, S),
                       self.static[P * S:P * S + P], self.static[P * S + P:])
        self.graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self.replays = 0

    def _capture(self, max_rep: int) -> torch.cuda.CUDAGraph:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):   # the torch ops once, off the carry
            keys, _ = self.map_fn(*self.inputs, max_rep)
            pending = self.carry.pending_k.clone()
            all_to_all_blocks(pending.clone(), out=pending)
            self.carry.cursor.clone().add_(1)
        torch.cuda.current_stream(self.device).wait_stream(side)
        # nvcc, load, smem limit and the scratch of this task size: not in it
        fused_ops.prepare(keys.shape[-1], self.spec.n_procs, self.device)
        graph = torch.cuda.CUDAGraph()
        before = fused_map.captured
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            _fused_step_into(self.spec, self.map_fn, self.carry,
                             *self.inputs, max_rep)
        if fused_map.captured - before != 1:
            raise RuntimeError(f"the step graph holds "
                               f"{fused_map.captured - before} fused_map "
                               f"launches, not 1")
        self.graphs[max_rep] = graph
        return graph

    def step(self, column: torch.Tensor, max_rep: int):
        """One engine step: ``column`` is the step's packed input."""
        self.static.copy_(column)
        graph = self.graphs.get(max_rep) or self._capture(max_rep)
        graph.replay()
        self.replays += 1
        fused_map.launches += 1         # the graph's one fused_map node


def _run_steps(spec: JobSpec, map_fn: Callable, carry: EngineCarry,
               tokens, task_ids, repeats, max_rep,
               graphs: StepGraphs | None,
               stats: StealStats | None = None,
               step: Callable | None = None) -> EngineCarry:
    """Run a segment's steps in order: ``tokens (n, P, S)`` and
    ``task_ids``/``repeats (n, P)`` step-major on the device, ``max_rep``
    (n,) on the host. With ``graphs`` each step replays a graph; without,
    the eager loop runs ``step`` (``_step``; ``_coded_step`` takes
    ``(n, P, r, S)`` and ``(n, P, r)`` blocks). ``stats`` counts the
    repeat passes the steps were given."""
    n = tokens.shape[0]
    max_rep = np.asarray(max_rep).tolist()
    if stats is not None:
        stats.passes += sum(max_rep)
    if graphs is not None:
        packed = torch.cat([tokens.reshape(n, -1), task_ids, repeats], dim=1)
        for column, m in zip(packed.unbind(0), max_rep):
            graphs.step(column, m)
        return graphs.carry
    tokens = tokens.contiguous()
    task_ids = task_ids.contiguous()
    repeats = repeats.contiguous()
    step = step or _step
    for c, m in enumerate(max_rep):
        carry = step(spec, map_fn, carry, tokens[c], task_ids[c],
                     repeats[c], m)
    return carry


def _segment(spec: JobSpec, map_fn: Callable, carry: EngineCarry,
             seg: Segment, graphs: StepGraphs | None = None) -> EngineCarry:
    """Advance one segment: ``seg.tokens (P, n, S)``, ``seg.task_ids``/
    ``seg.repeats`` (P, n) on the device; column c is step c."""
    return _run_steps(spec, map_fn, carry, seg.tokens.transpose(0, 1),
                      seg.task_ids.t(), seg.repeats.t(), seg.max_rep, graphs)


@dataclass
class StealStats:
    """Host-side counters of a stealing engine."""
    segments: int = 0
    schedule_s: float = 0.0    # host seconds computing the schedules and
                               #   staging them for the device
    passes: int = 0            # lockstep repeat passes: the max repeat
                               #   each step was run with, summed


def _psum_own(counts: torch.Tensor) -> torch.Tensor:
    """The ``(P, P)`` progress row that ``counts (P,)`` adds, replicated:
    each rank contributes its own count at its own column and the psum
    sums them, as the reference's psum does."""
    return psum(torch.diag(counts))


def _to_device(host: np.ndarray, device) -> torch.Tensor:
    """A small host array on ``device`` without waiting for the device:
    through pinned memory on a CUDA device (a copy from pageable memory
    would wait for the steps already queued on the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _steal_segment(spec: JobSpec, map_fn: Callable, carry: EngineCarry,
                   seg: Segment, work0: np.ndarray,
                   graphs: StepGraphs | None, stats: StealStats):
    """Advance one segment under work stealing: ``seg`` on the device
    with its host grids, ``work0`` the host mirror of the carry's work
    row. The schedule is computed from the host grids; then, on the
    device, executor e's column at step k is gathered from the segment by
    the slot e claimed: its tokens, global id and repeat (sentinel tokens,
    id -1 and repeat 0 when it idles; it runs ``max(rep, 1)``, as the
    reference's). Every step runs. The carry's ``work`` and ``stolen``
    rows advance on the device by what was gathered, through a psum of
    each rank's own counts (:func:`_psum_own`). Returns the carry and
    the schedule's work row."""
    P, n, S = seg.tokens.shape
    device = seg.tokens.device
    t0 = time.perf_counter()
    sched = steal.steal_schedule(seg.ids, seg.reps, work0=work0)
    live = sched.src_rank >= 0
    # src_col indexes the source rank's compacted row: map it back
    # through that rank's permutation to the segment's column
    perm = steal.compact_columns(seg.ids)
    col = perm[np.maximum(sched.src_rank, 0), np.maximum(sched.src_col, 0)]
    src = np.where(live, sched.src_rank * n + col, -1)
    max_rep = np.maximum(sched.exec_reps, 1).max(axis=0)
    src = _to_device(src.T.astype(np.int32), device)       # (n, P)
    stats.schedule_s += time.perf_counter() - t0
    got = src >= 0
    at = src.clamp(min=0).view(-1)

    def gather(x, fill):
        rows = x.reshape(P * n, -1).index_select(0, at)
        return torch.where(got.view(-1, 1), rows, fill).view(n, P, -1)

    tokens = gather(seg.tokens, KEY_SENTINEL)
    ids = gather(seg.task_ids, -1).view(n, P)
    reps = gather(seg.repeats, 0).view(n, P)
    mine = torch.arange(P, device=device)
    carry.work.add_(_psum_own(reps.sum(dim=0, dtype=torch.int32)))
    carry.stolen.add_(_psum_own((got & (src // n != mine)).sum(
        dim=0, dtype=torch.int32)))
    carry = _run_steps(spec, map_fn, carry, tokens, ids, reps.clamp(min=1),
                       max_rep, graphs, stats)
    stats.segments += 1
    return carry, sched.work


def _coded_steal_segment(spec: JobSpec, map_fn: Callable,
                         carry: EngineCarry, seg: Segment,
                         work0: np.ndarray, stats: StealStats):
    """Advance one coded segment under work stealing: the groups' claims
    over r-wide blocks computed on the host
    (``steal.coded_steal_schedule``), then member m of each executor
    group gathers the whole claimed block from member m of the source
    group (sentinel tokens, ids -1 and repeats 0 when its group idles).
    ``work`` advances by each block's live repeats on every member and
    ``stolen`` by one for a block of another group; steps run with
    ``max(rep, 1)``. Returns the carry and the schedule's work row."""
    P, n, S = seg.tokens.shape
    r = spec.code_rate
    nb = n // r
    device = seg.tokens.device
    t0 = time.perf_counter()
    sched = steal.coded_steal_schedule(seg.ids, seg.reps, r, work0=work0)
    grp = np.repeat(sched.src_group, r, axis=0)             # (P, nb)
    blk = np.repeat(sched.src_block, r, axis=0)
    m = (np.arange(P) % r)[:, None]
    src = np.where(grp >= 0, (grp * r + m) * nb + blk, -1)
    src = _to_device(src.T.astype(np.int32), device)        # (nb, P)
    stats.schedule_s += time.perf_counter() - t0
    got = src >= 0
    at = src.clamp(min=0).view(-1)

    def gather(x, fill):
        rows = x.reshape(P * nb, -1).index_select(0, at)
        return torch.where(got.view(-1, 1), rows, fill).view(nb, P, r, -1)

    tokens = gather(seg.tokens, KEY_SENTINEL)
    ids = gather(seg.task_ids, -1).squeeze(-1)
    reps = gather(seg.repeats, 0).squeeze(-1)
    my_group = torch.arange(P, device=device) // r
    carry.work.add_(_psum_own(torch.where(ids >= 0, reps, 0).sum(
        dim=(0, 2), dtype=torch.int32)))
    carry.stolen.add_(_psum_own((got & (src // (nb * r) != my_group)).sum(
        dim=0, dtype=torch.int32)))
    carry = _run_steps(spec, map_fn, carry, tokens, ids, reps.clamp(min=1),
                       sched.step_reps, None, stats, step=_coded_step)
    stats.segments += 1
    return carry, sched.work


class SegmentFns:
    """One job's engine, unpacked as ``(init_fn, segment_fn, finish_fn)``:
    ``init`` makes the carry and, for the fused step on a CUDA device, the
    :class:`StepGraphs` that write it; ``segment`` advances a segment,
    replaying ``graphs`` when there are any and running the eager loop
    otherwise; ``finish`` releases the graphs, drains and combines. Setting
    ``graphs = None`` after ``init`` runs the eager loop on the card too:
    the graphs' baseline.

    Under ``spec.stealing`` ``host_work`` mirrors the carry's work row on
    the host; ``None`` (after ``init``, or after a carry was installed)
    reads it back from the carry once. ``steal`` counts the schedules'
    host seconds and the lockstep passes the steps ran."""

    def __init__(self, spec: JobSpec, map_fn: Callable, device):
        self.spec, self.map_fn, self.device = spec, map_fn, device
        self.graphs: StepGraphs | None = None
        self.host_work: np.ndarray | None = None
        self.steal = StealStats()

    def __iter__(self):
        return iter((self.init, self.segment, self.finish))

    def init(self) -> EngineCarry:
        carry = init_carry(self.spec, self.device)
        if self.spec.fused_map and torch.device(self.device).type == "cuda":
            self.graphs = StepGraphs(self.spec, self.map_fn, carry)
        self.host_work = None
        return carry

    def segment(self, carry, seg: Segment):
        coded = self.spec.code_rate > 1
        if not self.spec.stealing:
            if coded:
                return _coded_segment(self.spec, self.map_fn, carry, seg)
            return _segment(self.spec, self.map_fn, carry, seg, self.graphs)
        if self.host_work is None:
            self.host_work = carry.work[0].cpu().numpy()
        if coded:
            carry, self.host_work = _coded_steal_segment(
                self.spec, self.map_fn, carry, seg, self.host_work,
                self.steal)
        else:
            carry, self.host_work = _steal_segment(
                self.spec, self.map_fn, carry, seg, self.host_work,
                self.graphs, self.steal)
        return carry

    def finish(self, carry):
        self.graphs = None
        return _finish(self.spec, carry)


def _drain(carry: EngineCarry) -> EngineCarry:
    """Fold the last in-flight chunk; enter STATUS_REDUCE."""
    P = carry.table.shape[0]
    DenseWindow(carry.table).put(carry.pending_k.reshape(P, -1),
                                 carry.pending_v.reshape(P, -1))
    return carry._replace(
        pending_k=torch.full_like(carry.pending_k, KEY_SENTINEL),
        pending_v=torch.zeros_like(carry.pending_v),
        status=torch.full_like(carry.status, STATUS_REDUCE))


def _finish(spec: JobSpec, carry: EngineCarry):
    """Drain, then Combine (phase IV): ``(keys, vals, overflow)`` with
    rank 0's row holding the merged records."""
    carry = _drain(carry)
    keys, vals, overflow = combine_records(carry.table, spec)
    return tree_combine(keys, vals, spec.n_procs, overflow)


@register_backend("1s")
class OneSidedBackend:
    """The decoupled engine behind the ``Backend`` protocol."""

    # honors JobSpec.stealing (work stealing inside a segment,
    # core/steal.py); submit() refuses the flag on backends without this
    supports_stealing = True
    # ... and JobSpec.fused_map (the per-step hot path as one CUDA kernel)
    supports_fused_map = True
    # ... and JobSpec.coslots > 1 (a WorkDomain's composite engine run,
    # core/workdomain.py); the scheduler forms domains over these only
    supports_coschedule = True
    # ... and JobSpec.code_rate > 1 (the coded shuffle, core/coded.py)
    supports_coded = True

    def run_job(self, spec: JobSpec, map_fn: Callable, device, tokens,
                task_ids, repeats):
        """Full job over host arrays tokens (P, T, S) and task_ids/repeats
        (P, T). Returns rank-0 records as host arrays."""
        init_fn, segment_fn, finish_fn = self.make_segment_fns(
            spec, map_fn, device)
        carry = segment_fn(init_fn(),
                           Segment.of(tokens, task_ids, repeats, device))
        keys, vals, _ = finish_fn(carry)
        return keys[0].cpu().numpy(), vals[0].cpu().numpy()

    def trace_handles(self, spec: JobSpec, map_fn: Callable, device,
                      segments: Callable[[int], list], tag: str = ""):
        """Runnable :class:`~repro_torch.core.registry.ProgramHandle`\\ s
        for fleetlint (``repro_torch.analysis``): the segmented triple
        and its replication contract, fed ``segments(seed)``."""
        from repro_torch.core.registry import segment_program_handles
        return segment_program_handles(self, spec, map_fn, device,
                                       segments, tag=tag)

    def make_segment_fns(self, spec: JobSpec, map_fn: Callable, device):
        """``(init_fn, segment_fn, finish_fn)`` — the checkpointable path.
        ``segment_fn(carry, seg)`` advances one feed ``Segment``;
        ``finish_fn(carry)`` returns ``(keys, vals,
        overflow)`` with a leading rank dim, as a :class:`SegmentFns`:
        the fused step replays CUDA graphs on a CUDA device."""
        return SegmentFns(spec, map_fn, device)


def run_job(spec, map_fn, device, tokens, task_ids, repeats):
    from repro_torch.core.registry import get_backend
    return get_backend("1s").run_job(spec, map_fn, device, tokens,
                                     task_ids, repeats)


def make_segment_fns(spec, map_fn, device):
    from repro_torch.core.registry import get_backend
    return get_backend("1s").make_segment_fns(spec, map_fn, device)
