"""Plain PyTorch versions of fleetlint's three mutant kernels.

They compute what the TPU kernels of ``repro/analysis/corpus.py``
compute (``_pal001.fn``, ``_pal001_fused.fn``, ``_pal002.fn``), block by
block over the grid of a :class:`~repro_torch.analysis.rules.LaunchSpec`
with its index maps, so a near twin (every map in bounds) gives
``x.clone()`` and ``table + recs[0]``.

A block index outside its array raises ``IndexError``: these versions do
not clamp. JAX's interpret mode does clamp, so its bad ``_pal001`` twin
(input map ``i + 1``) silently returns ``x[7]`` for the last row, where
the CUDA kernel reads past the array and this version raises. PAL001
rules such a map out before any launch.
"""
from __future__ import annotations

import itertools

import torch


def _block(t: torch.Tensor, op, point) -> torch.Tensor:
    """The block of ``t`` that ``op``'s map names at ``point`` (a view)."""
    idx = op.index(point)
    out = t
    for d, (i, n, b) in enumerate(zip(idx, op.shape, op.block, strict=True)):
        if not 0 <= i < -(-n // b):
            raise IndexError(
                f"operand {op.name}: grid point {tuple(point)} maps to block "
                f"index {i} on dim {d}, outside [0, {-(-n // b)})")
        out = out.narrow(d, i * b, min(b, n - i * b))
    return out


def _points(spec):
    return itertools.product(*[range(g) for g in spec.grid])


def copy_rows_plain(x: torch.Tensor, spec) -> torch.Tensor:
    """Output block ``out(g)`` = input block ``x(g)`` at every grid point
    (``_pal001.fn`` in f32, ``_pal002.fn`` in int32)."""
    x_op, o_op = spec.operand("x"), spec.operand("out")
    out = torch.empty(o_op.shape, dtype=o_op.dtype, device=x.device)
    for pt in _points(spec):
        _block(out, o_op, pt).copy_(_block(x, x_op, pt))
    return out


def table_add_plain(table: torch.Tensor, recs: torch.Tensor,
                    spec) -> torch.Tensor:
    """Output tile ``out(j)`` = table tile ``table(j)`` + the first entry
    of record block ``recs(j)`` (``_pal001_fused.fn``: its body reads
    ``r_ref[0]``), int32 with wraparound."""
    t_op, r_op, o_op = (spec.operand(n) for n in ("table", "recs", "out"))
    out = torch.empty(o_op.shape, dtype=o_op.dtype, device=table.device)
    for pt in _points(spec):
        _block(out, o_op, pt).copy_(_block(table, t_op, pt)
                                    + _block(recs, r_op, pt)[0])
    return out
