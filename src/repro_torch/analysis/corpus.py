"""The programs and kernels the port's fleetlint runs over (the
counterpart of ``repro/analysis/corpus.py``).

Two halves:

  * the *shipping* matrix — every registered backend x use-case program
    (x stealing, fused, coded and co-scheduled variant) and the re-mesh
    fold as runnable handles at P = :data:`LINT_PROCS`, and the port's six
    kernel wrappers at the reference corpus's shapes and worst-case
    counts, all of which must lint clean;
  * the *mutant* corpus — the reference's seeded program, kernel and ops
    mutants, one firing seed and one near miss per rule, so the tests
    prove each rule both fires and stays quiet. The program mutants run
    at P = :data:`MUTANT_PROCS`; the kernels are ``mutant_kernels``.
"""
from __future__ import annotations

import dataclasses
import functools
import types
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.analysis.mutant_kernels import ops as mutant_ops
from repro_torch.analysis.rules import BlockMap, KernelCheck, LaunchSpec, \
    Operand
from repro_torch.core.registry import JobSpec, ProgramHandle, \
    available_backends, get_backend
from repro_torch.core.usecase import as_map_fn
from repro_torch.core.usecases import Histogram, InvertedIndex, WordCount
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import axis_index, ppermute, psum
from repro_torch.kernels import backend

# -- shipping programs ------------------------------------------------------

# the reference's use-cases at its sizes, one instance each
SHIPPING_CASES = (
    ("wordcount", WordCount(vocab=512)),
    ("histogram", Histogram(vocab=512, n_bins=64)),
    ("invindex", InvertedIndex(queries=(3, 5, 7), n_docs=4,
                               tasks_per_doc=2)),
)
# the ranks the shipping programs run at: the P of the reference's CI
# analysis job, even, so that the coded programs (r = 2) are in the matrix
LINT_PROCS = 8
# columns a seeded segment holds: the reference's ``seg_tasks``
SEG_TASKS = 2
# seeded segments a segment handle runs from init's carry (REP001 after
# each); a finish handle runs them first and finishes their carry
LINT_SEGMENTS = 3


def seeded_segments(spec: JobSpec, device, seed: int) -> list:
    """:data:`LINT_SEGMENTS` feed ``Segment``\\ s of :data:`SEG_TASKS`
    columns, made from ``seed``: the planner's layout (each rank a
    contiguous run of global task ids), repeats in [1, 4], and each
    task's ``task_size`` tokens Zipf-skewed (a 1.3) over the job's
    window, one row a task id. Under ``spec.code_rate`` r the grid is the
    coded one (every member of a code group carries the group's tasks);
    a co-scheduled spec's ``costride`` must cover the ids."""
    from repro_torch.core.coded import replicate_grids
    from repro_torch.data.feed import Segment
    P, S, r = spec.n_procs, spec.task_size, spec.code_rate
    T = SEG_TASKS * LINT_SEGMENTS // r              # tasks a rank
    rng = np.random.default_rng(seed)
    ids = np.arange(P * T, dtype=np.int32).reshape(P, T)
    reps = rng.integers(1, 5, (P, T)).astype(np.int32)
    ids, reps = replicate_grids(ids, reps, r)
    window = spec.vocab // spec.coslots
    corpus = ((rng.zipf(1.3, (P * T, S)) - 1) % window).astype(np.int32)
    tokens = corpus[ids]
    cols = [slice(k * SEG_TASKS, (k + 1) * SEG_TASKS)
            for k in range(LINT_SEGMENTS)]
    return [Segment.of(tokens[:, c], ids[:, c], reps[:, c], device)
            for c in cols]


def shipping_programs(device=None, n_procs: int = LINT_PROCS
                      ) -> list[ProgramHandle]:
    """Every backend x use-case (x variant) as ProgramHandles on ``device``
    (the card unless given), in the reference's order and under its
    names, then the re-mesh fold. The coded programs need an even
    ``n_procs``, as the reference's do."""
    from repro_torch.fleet.remesh import remesh_program_handles
    device = resolve_device(device)
    handles: list[ProgramHandle] = []
    for bname in available_backends():
        backend_ = get_backend(bname)
        for cname, usecase in SHIPPING_CASES:
            variants = [(dict(), "")]
            if getattr(backend_, "supports_stealing", False):
                variants.append((dict(stealing=True), "+steal"))
            if getattr(backend_, "supports_fused_map", False):
                # the fused step is another program (a CUDA graph of the
                # fused_map kernel a step on the card): the same gate
                variants.append((dict(fused_map=True), "+fused"))
                variants.append((dict(stealing=True, fused_map=True),
                                 "+steal+fused"))
            if getattr(backend_, "supports_coded", False) \
                    and n_procs % 2 == 0:
                # the coded exchange at r = 2: code groups need r | P
                variants.append((dict(code_rate=2), "+coded"))
                variants.append((dict(stealing=True, code_rate=2),
                                 "+steal+coded"))
            if getattr(backend_, "supports_coschedule", False):
                # a 2-member WorkDomain's composite program, whose
                # ``carry.job_work`` row is psum-maintained; the stride
                # covers the seeded grid's ids (the reference traces at
                # ``costride=seg_tasks``, where nothing runs)
                stride = n_procs * SEG_TASKS * LINT_SEGMENTS // 2
                for kw, suffix in ((dict(), "+cosched"),
                                   (dict(stealing=True), "+steal+cosched")):
                    variants.append((dict(kw, coslots=2, costride=stride),
                                     suffix))
            for kw, suffix in variants:
                window = usecase.window * kw.get("coslots", 1)
                spec = JobSpec(vocab=window, task_size=8, push_cap=16,
                               n_procs=n_procs, segment=SEG_TASKS, **kw)
                handles.extend(backend_.trace_handles(
                    spec, as_map_fn(usecase), device,
                    functools.partial(seeded_segments, spec, device),
                    tag=f"{bname}/{cname}{suffix}"))
    # the elastic re-mesh fold: its replicated-out contract (folded owner
    # map and split, psum checksum) is what REP001 exists to check
    handles.extend(remesh_program_handles(device, n_new=n_procs))
    return handles


# -- shipping kernels -------------------------------------------------------


def shipping_kernels() -> list[KernelCheck]:
    """Every kernel wrapper in ``kernels/`` as a KernelCheck with the
    reference corpus's shapes and declared worst-case counts. None
    declares a launch spec: their bounds are the card's memcheck."""
    from repro_torch.core.kv import KEY_SENTINEL
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_map import ops as fm
    from repro_torch.kernels.moe_dispatch import ops as moe
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.wordcount_hash import ops as wc

    N, T = 4096, 1024
    S, V, Pn, C = 64, 512, 8, 16         # fused step: shipped engine scale
    f32, i32 = torch.float32, torch.int32

    def zeros(dev, *shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def fused(dev):
        return (fm.fused_map,
                (zeros(dev, Pn, S, dtype=i32), zeros(dev, Pn, S, dtype=i32),
                 torch.ones((Pn,), dtype=i32, device=dev),
                 zeros(dev, Pn, dtype=i32), zeros(dev, Pn, V, dtype=i32),
                 torch.ones((Pn, V), dtype=i32, device=dev),
                 torch.full((Pn, Pn, C), KEY_SENTINEL, dtype=i32, device=dev),
                 zeros(dev, Pn, Pn, C, dtype=i32),
                 zeros(dev, Pn, V, dtype=i32)),
                dict(n_procs=Pn, cap=C))

    return [
        # int32 outputs hold per-key window totals; the engine's record
        # bound under the saturating-combine contract keeps every
        # legitimate total well inside 2^30
        KernelCheck("fused_map", build=fused, worst_count=2 ** 30,
                    ops_module="repro_torch.kernels.fused_map.ops"),
        KernelCheck(
            "wordcount_hash",
            build=lambda dev: (wc.wordcount_hist, (zeros(dev, N, dtype=i32),),
                               dict(vocab=512, hash_mod=8)),
            worst_count=N, ops_module="repro_torch.kernels.wordcount_hash.ops"),
        KernelCheck(
            "moe_dispatch",
            build=lambda dev: (moe.bucket_slots, (zeros(dev, T, dtype=i32),),
                               dict(n_experts=8)),
            worst_count=T, ops_module="repro_torch.kernels.moe_dispatch.ops"),
        KernelCheck(
            "flash_attention",
            build=lambda dev: (fa.flash_attention,
                               (zeros(dev, 1, 128, 4, 64),
                                zeros(dev, 1, 128, 2, 64),
                                zeros(dev, 1, 128, 2, 64)),
                               dict(causal=True)),
            ops_module="repro_torch.kernels.flash_attention.ops"),
        KernelCheck(
            "flash_decode",
            build=lambda dev: (fd.flash_decode,
                               (zeros(dev, 2, 4, 32), zeros(dev, 2, 256, 2, 32),
                                zeros(dev, 2, 256, 2, 32), 100),
                               dict(block_kv=128)),
            ops_module="repro_torch.kernels.flash_decode.ops"),
        KernelCheck(
            "ssd_scan",
            build=lambda dev: (ssd.ssd,
                               (zeros(dev, 1, 128, 2, 4), zeros(dev, 1, 128, 2),
                                zeros(dev, 2), zeros(dev, 1, 128, 1, 8),
                                zeros(dev, 1, 128, 1, 8)),
                               dict(chunk=64)),
            ops_module="repro_torch.kernels.ssd_scan.ops"),
    ]


# -- mutant corpus ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mutant:
    """One seeded corpus entry. ``kind`` selects the checker: ``program``
    -> check_program (``build(device)`` makes its handle), ``kernel`` ->
    check_kernel, ``ops`` -> check_ops_module. ``fires`` is the
    expectation: True for the known-bad seed, False for its near miss."""
    name: str
    rule: str
    fires: bool
    kind: str
    build: Callable = dataclasses.field(compare=False)


# the program mutants' ranks: not 8, their rows' width, so that SPMD001
# can tell a reduction over the rows from one over the ranks
MUTANT_PROCS = 4


def _program(name: str, body: Callable, device, replicated_out=(),
             width: int = 8) -> ProgramHandle:
    """A one-call program over seeded ``(P, width)`` int32 rows in [0,
    1000), rank-varying, into one ``total`` output."""
    device = resolve_device(device)

    def run(seed: int):
        rng = np.random.default_rng(seed)
        x = rng.integers(0, 1000, (MUTANT_PROCS, width)).astype(np.int32)
        yield body, (torch.from_numpy(x).to(device),)

    return ProgramHandle(
        name=name, n_procs=MUTANT_PROCS, run=run, arg_paths=("x0",),
        out_paths=("total",), replicated_out=replicated_out,
        seeded=("x0",))


def _rank_sums(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=1, dtype=torch.int32)


def _ring(x: torch.Tensor) -> list[tuple[int, int]]:
    P = x.shape[0]
    return [(i, (i + 1) % P) for i in range(P)]


def _spmd001(fires: bool, device=None) -> ProgramHandle:
    # the bad twin's psum is over the transposed rows: its dim 0 is the
    # row width, not the rank dim
    def bad(x):
        return psum(x.t())[0]

    def near(x):
        return psum(_rank_sums(x))

    return _program(f"mutant/spmd001/{'rows' if fires else 'procs'}",
                    bad if fires else near, device)


def _spmd002(fires: bool, device=None) -> ProgramHandle:
    def bad(x):
        # one rank's axis_index-derived predicate read to the host: the
        # ranks disagree on whether the psum inside the branch runs
        v = _rank_sums(x)
        if (axis_index(x.shape[0], x.device) % 2 == 0)[0]:
            v = psum(v)
        return v

    def near(x):
        # the same shape of program, but the predicate is itself a psum
        # product: replicated, so every rank takes the same branch
        v = _rank_sums(x)
        if (psum(v) > 0)[0]:
            v = psum(v)
        return v

    return _program(f"mutant/spmd002/{'bad' if fires else 'near'}",
                    bad if fires else near, device)


def _rep001(fires: bool, device=None) -> ProgramHandle:
    # the bad twin drops the psum: a per-rank partial sum flows into an
    # output the handle asserts replicated
    def bad(x):
        return _rank_sums(x)

    def near(x):
        return psum(_rank_sums(x))

    return _program(f"mutant/rep001/{'bad' if fires else 'near'}",
                    bad if fires else near, device,
                    replicated_out=("total",))


def _rep001_fold(fires: bool, device=None) -> ProgramHandle:
    # the elastic fold's failure mode: each rank's folded-window total
    # must be summed to become the fleet total; the bad twin passes it
    # around the ring instead, and ppermute is a shuffle, not a
    # replication (every rank ends holding a different value)
    def bad(x):
        return ppermute(_rank_sums(x), _ring(x))

    def near(x):
        return psum(_rank_sums(x))

    return _program(f"mutant/rep001-fold/{'bad' if fires else 'near'}",
                    bad if fires else near, device,
                    replicated_out=("total",))


def _rep001_crossjob(fires: bool, device=None) -> ProgramHandle:
    # the cross-job row's failure mode: each rank adds the repeats it ran
    # into the member slot of its task, and only a psum turns those
    # partials into the replicated ``carry.job_work`` row; the bad twin
    # passes the row around the ring instead
    def slot_row(x):
        slot = (x[:, :1] % 2).long()       # member slot of the task
        row = torch.zeros((x.shape[0], 2), dtype=torch.int32,
                          device=x.device)
        return row.scatter_add_(1, slot, _rank_sums(x).unsqueeze(1))

    def bad(x):
        return ppermute(slot_row(x), _ring(x))

    def near(x):
        return psum(slot_row(x))

    return _program(
        f"mutant/rep001-crossjob/{'bad' if fires else 'near'}",
        bad if fires else near, device, replicated_out=("total",))


def _rep001_coded(fires: bool, device=None) -> ProgramHandle:
    # the coded exchange's failure mode: the total each rank decodes from
    # the XOR multicast is per-rank partial state, and only a psum makes
    # it the fleet total; the bad twin passes it around the ring instead
    def decoded(x):
        # a received coded entry XOR-ed with locally mapped side info
        return x[:, 0] ^ x[:, -1]

    def bad(x):
        return ppermute(decoded(x), _ring(x))

    def near(x):
        return psum(decoded(x))

    return _program(
        f"mutant/rep001-coded/{'bad' if fires else 'near'}",
        bad if fires else near, device, replicated_out=("total",))


def _rows(shift: int) -> BlockMap:
    """(i + shift, 0) over a 1-D grid: row blocks of a 2-D array."""
    return BlockMap(scale=((1,), (0,)), shift=(shift, 0))


def _tiles(scale: int, shift: int) -> BlockMap:
    """scale * j + shift over a 1-D grid: tiles of a 1-D array."""
    return BlockMap(scale=((scale,),), shift=(shift,))


def _copy_spec(in_map: BlockMap, dtype) -> LaunchSpec:
    return LaunchSpec(grid=(8,), operands=(
        Operand("x", (8, 128), (1, 128), in_map, dtype),
        Operand("out", (8, 128), (1, 128), _rows(0), dtype, output=True)))


def _pal001(fires: bool) -> KernelCheck:
    # the bad twin's input map is i + 1: the last grid step reads a row
    # block past the array
    spec = _copy_spec(_rows(1 if fires else 0), torch.float32)
    return KernelCheck(
        f"mutant/pal001/{'bad' if fires else 'near'}",
        build=lambda dev: (mutant_ops.copy_rows,
                           (torch.zeros((8, 128), device=dev),),
                           dict(spec=spec)),
        worst_count=None, spec=spec)


def _pal001_fused(fires: bool) -> KernelCheck:
    # the fused_map failure mode: a grid streams (vocab,) table tiles
    # while a record block rides along whole; the bad twin's tile map is
    # off by one, so the last grid step reads a tile past the table
    spec = LaunchSpec(grid=(8,), operands=(
        Operand("table", (512,), (64,), _tiles(1, 1 if fires else 0),
                torch.int32),
        Operand("recs", (16,), (16,), _tiles(0, 0), torch.int32),
        Operand("out", (512,), (64,), _tiles(1, 0), torch.int32,
                output=True)))
    return KernelCheck(
        f"mutant/pal001-fused/{'bad' if fires else 'near'}",
        build=lambda dev: (mutant_ops.table_add,
                           (torch.zeros((512,), dtype=torch.int32, device=dev),
                            torch.zeros((16,), dtype=torch.int32, device=dev)),
                           dict(spec=spec)),
        worst_count=10 ** 6, spec=spec)


def _pal002(fires: bool) -> KernelCheck:
    spec = _copy_spec(_rows(0), torch.int32)
    # 2^40 synthetic records cannot fit an int32 accumulator; 10^6 can
    worst = 2 ** 40 if fires else 10 ** 6
    return KernelCheck(
        f"mutant/pal002/{'bad' if fires else 'near'}",
        build=lambda dev: (mutant_ops.copy_rows_i32,
                           (torch.zeros((8, 128), dtype=torch.int32,
                                        device=dev),),
                           dict(spec=spec)),
        worst_count=worst, spec=spec)


def _plain_copy(x):
    return x.clone()


def _launch_copy(x):
    raise NotImplementedError("a mutant module: it has no kernel to launch")


def _pal003(fires: bool) -> types.ModuleType:
    mod = types.ModuleType("mutant_ops")
    if fires:
        def _on_cuda():                        # a private policy copy
            return torch.cuda.is_available()

        def wrapper(x, *, use_kernel: bool = True):   # wrong default too
            try:                               # the hidden fallback
                return _launch_copy(x)
            except NotImplementedError:
                return _plain_copy(x)
        mod._on_cuda = _on_cuda
        _on_cuda.__module__ = mod.__name__
    else:
        mod.backend = backend

        def wrapper(x, *, use_kernel: bool = False):
            if not backend.use_kernel(x, require=use_kernel):
                return _plain_copy(x)
            return _launch_copy(x)
    wrapper.__module__ = mod.__name__   # "defined in" the fake module
    mod.wrapper = wrapper
    return mod


def _programs(name: str, rule: str, make: Callable) -> tuple[Mutant, ...]:
    """A program mutant's bad twin and near twin."""
    return tuple(
        Mutant(f"{name}-{'bad' if fires else 'near'}", rule, fires,
               "program", lambda device=None, f=fires: make(f, device))
        for fires in (True, False))


MUTANTS = (
    *_programs("spmd001", "SPMD001", _spmd001),
    *_programs("spmd002", "SPMD002", _spmd002),
    *_programs("rep001", "REP001", _rep001),
    *_programs("rep001-fold", "REP001", _rep001_fold),
    *_programs("rep001-crossjob", "REP001", _rep001_crossjob),
    *_programs("rep001-coded", "REP001", _rep001_coded),
    Mutant("pal001-bad", "PAL001", True, "kernel", lambda: _pal001(True)),
    Mutant("pal001-near", "PAL001", False, "kernel", lambda: _pal001(False)),
    Mutant("pal001-fused-bad", "PAL001", True, "kernel",
           lambda: _pal001_fused(True)),
    Mutant("pal001-fused-near", "PAL001", False, "kernel",
           lambda: _pal001_fused(False)),
    Mutant("pal002-bad", "PAL002", True, "kernel", lambda: _pal002(True)),
    Mutant("pal002-near", "PAL002", False, "kernel", lambda: _pal002(False)),
    Mutant("pal003-bad", "PAL003", True, "ops", lambda: _pal003(True)),
    Mutant("pal003-near", "PAL003", False, "ops", lambda: _pal003(False)),
)


def run_mutant(mutant: Mutant, device=None) -> list:
    """Run the matching checker over one mutant; returns its findings. A
    program mutant runs on ``device`` (the card unless given), and so is
    a kernel near twin launched; a kernel bad twin never is."""
    from repro_torch.analysis import rules
    device = resolve_device(device)
    if mutant.kind == "program":
        return rules.check_program(mutant.build(device))
    built = mutant.build()
    if mutant.kind == "kernel":
        return rules.check_kernel(built, device)
    if mutant.kind == "ops":
        return rules.check_ops_module(built, mutant.name)
    raise ValueError(f"unknown mutant kind {mutant.kind!r}")
