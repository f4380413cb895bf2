"""The kernels the port's fleetlint runs over (the kernel half of
``repro/analysis/corpus.py``).

Two halves:

  * the *shipping* kernels — the port's six kernel wrappers at the
    reference corpus's representative shapes and worst-case counts, all
    of which must lint clean;
  * the *mutant* corpus — the reference's kernel and ops mutants, one
    firing seed and one near miss per rule, so the tests prove each rule
    both fires and stays quiet. Their kernels are ``mutant_kernels``.
"""
from __future__ import annotations

import dataclasses
import types
from collections.abc import Callable

import torch

from repro_torch.analysis.mutant_kernels import ops as mutant_ops
from repro_torch.analysis.rules import BlockMap, KernelCheck, LaunchSpec, \
    Operand
from repro_torch.device import resolve_device
from repro_torch.kernels import backend

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
    """One seeded corpus entry. ``kind`` selects the checker: ``kernel``
    -> check_kernel, ``ops`` -> check_ops_module. ``fires`` is the
    expectation: True for the known-bad seed, False for its near miss."""
    name: str
    rule: str
    fires: bool
    kind: str
    build: Callable = dataclasses.field(compare=False)


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


MUTANTS = (
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
    kernel near twin is launched on ``device`` (the card unless given); a
    bad twin never is."""
    from repro_torch.analysis import rules
    device = resolve_device(device)
    built = mutant.build()
    if mutant.kind == "kernel":
        return rules.check_kernel(built, device)
    if mutant.kind == "ops":
        return rules.check_ops_module(built, mutant.name)
    raise ValueError(f"unknown mutant kind {mutant.kind!r}")
