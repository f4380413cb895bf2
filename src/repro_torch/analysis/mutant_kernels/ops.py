"""Wrappers of fleetlint's three mutant kernels (``csrc/mutants.cu``).

The counterparts of the TPU kernels of ``repro/analysis/corpus.py``:
``copy_rows`` (``_pal001.fn``), ``table_add`` (``_pal001_fused.fn``) and
``copy_rows_i32`` (``_pal002.fn``). Each takes its launch spec
(:class:`~repro_torch.analysis.rules.LaunchSpec`): the grid, and each
operand's shape, block and affine index map, which the kernel is handed
as data. PAL001 checks that same spec before the linter launches it.

Follows the port's kernel policy (``kernels/backend.py``): a CPU tensor
takes the plain version (``ref.py``), which raises on a block outside
its array; a CUDA tensor the compiled kernel or an error. The wrappers
check the tensors against the spec, but not the maps' bounds: that is
PAL001's work, and a map that leaves its array makes the kernel read or
write outside it (what the card's memcheck must catch).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.analysis.mutant_kernels.ref import (copy_rows_plain,
                                                     table_add_plain)
from repro_torch.kernels import backend

SOURCE = Path(__file__).parent / "csrc" / "mutants.cu"
_ENTRY = {"copy_rows": "copy_rows_launch",
          "copy_rows_i32": "copy_rows_i32_launch",
          "table_add": "table_add_launch"}
_NARGS = {"copy_rows": (2, 13), "copy_rows_i32": (2, 13),
          "table_add": (3, 9)}      # (pointers, ints) before the stream

_FN = {}      # kernel name -> the typed C entry point, resolved at launch


def _launcher(name: str):
    fn = _FN.get(name)
    if fn is None:
        fn = getattr(backend.load(SOURCE), _ENTRY[name])
        ptrs, ints = _NARGS[name]
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN[name] = fn
    return fn


def _check(spec, tensors: dict, rank: int):
    """The tensors against the spec: shapes, dtypes, one device, one grid
    axis, and operands of the given rank."""
    if len(spec.grid) != 1:
        raise ValueError(f"the mutant kernels take a 1-D grid, got "
                         f"{spec.grid}")
    names = [op.name for op in spec.operands]
    if names != [*tensors, "out"]:
        raise ValueError(f"spec operands {names}, expected "
                         f"{[*tensors, 'out']}")
    device = next(iter(tensors.values())).device
    for op in spec.operands:
        if len(op.shape) != rank or len(op.block) != rank:
            raise ValueError(f"operand {op.name}: the kernel takes rank "
                             f"{rank}, got shape {op.shape} block {op.block}")
        if op.name == "out":
            continue
        t = tensors[op.name]
        if tuple(t.shape) != op.shape or t.dtype != op.dtype:
            raise ValueError(f"{op.name} is {tuple(t.shape)} {t.dtype}, the "
                             f"spec says {op.shape} {op.dtype}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{op.name} must be contiguous on {device}")


def _map(op) -> list[int]:
    """(scale, shift) per array dim of a 1-D grid's map."""
    return [v for row, t in zip(op.index.scale, op.index.shift)
            for v in (row[0], t)]


def _check_copy(x, spec, dtype):
    _check(spec, {"x": x}, 2)
    x_op, o_op = spec.operand("x"), spec.operand("out")
    if x.dtype != dtype or o_op.dtype != dtype:
        raise TypeError(f"the copy takes {dtype}, got {x.dtype} -> "
                        f"{o_op.dtype}")
    if x_op.block != o_op.block:
        raise ValueError(f"the copy takes equal blocks, got {x_op.block} "
                         f"and {o_op.block}")


def _launch_copy(name: str, x, spec):
    x_op, o_op = spec.operand("x"), spec.operand("out")
    out = torch.empty(o_op.shape, dtype=x.dtype, device=x.device)
    b0, b1 = x_op.block
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _launcher(name)(x.data_ptr(), out.data_ptr(), spec.grid[0], b0, b1,
                         x_op.shape[1], o_op.shape[1], *_map(x_op),
                         *_map(o_op), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def copy_rows(x, spec, *, use_kernel: bool = False):
    """x: a 2-D float32 array of the spec's shape. Returns the spec's
    output, each output block the input block the maps name
    (``_pal001.fn``). The tensor's device picks kernel or plain version;
    ``use_kernel=True`` demands the kernel and raises on a CPU tensor."""
    _check_copy(x, spec, torch.float32)
    if not backend.use_kernel(x, require=use_kernel):
        return copy_rows_plain(x, spec)
    out = _launch_copy("copy_rows", x, spec)
    copy_rows.launches += 1
    return out


def copy_rows_i32(x, spec, *, use_kernel: bool = False):
    """``copy_rows`` in int32 (``_pal002.fn``)."""
    _check_copy(x, spec, torch.int32)
    if not backend.use_kernel(x, require=use_kernel):
        return copy_rows_plain(x, spec)
    out = _launch_copy("copy_rows_i32", x, spec)
    copy_rows_i32.launches += 1
    return out


def table_add(table, recs, spec, *, use_kernel: bool = False):
    """table, recs: 1-D int32 arrays of the spec's shapes. Returns the
    spec's output: each output tile the table tile its map names plus the
    first entry of the record block its map names (``_pal001_fused.fn``).
    The tensors' device picks kernel or plain version; ``use_kernel=True``
    demands the kernel and raises on CPU tensors."""
    _check(spec, {"table": table, "recs": recs}, 1)
    t_op, r_op, o_op = (spec.operand(n) for n in ("table", "recs", "out"))
    if {t_op.dtype, r_op.dtype, o_op.dtype} != {torch.int32}:
        raise TypeError("table_add takes int32 operands")
    if t_op.block != o_op.block:
        raise ValueError(f"table_add adds equal tiles, got {t_op.block} and "
                         f"{o_op.block}")
    if not backend.use_kernel(table, require=use_kernel):
        return table_add_plain(table, recs, spec)
    out = torch.empty(o_op.shape, dtype=torch.int32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = _launcher("table_add")(
        table.data_ptr(), recs.data_ptr(), out.data_ptr(), spec.grid[0],
        t_op.block[0], r_op.block[0], *_map(t_op), *_map(r_op), *_map(o_op),
        stream)
    if rc != 0:
        raise RuntimeError(f"table_add kernel launch failed: CUDA error {rc}")
    table_add.launches += 1
    return out


copy_rows.launches = 0        # kernel launches so far (not plain calls)
copy_rows_i32.launches = 0
table_add.launches = 0
