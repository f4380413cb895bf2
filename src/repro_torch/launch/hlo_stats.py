"""Collective-byte accounting of the port's programs (counterpart of
``repro/launch/hlo_stats.py``, under the same name so a reader finds it).

The reference parses the compiled, partitioned HLO of a program: each
collective's per-device result shape and its replica group size g. An
eager program has no HLO. Here a :class:`CollectiveCounter` is
``distributed.collectives.OBSERVER`` for the length of a program, and
each collective the program performs reports its operand, dtype, the
ranks that hold it and the size g of its axis or axes. One rank's
result is its operand (an all-gather's is g times it), and the wire
bytes use the reference's ring factors (``_WIRE``), kind names and
record keys:

    all-gather         result · (g-1)/g        (result = gathered tensor)
    reduce-scatter     result · (g-1)          (result = scattered shard)
    all-reduce         result · 2(g-1)/g       (psum, pmax, pmean)
    all-to-all         result · (g-1)/g
    collective-permute result                  (point-to-point)

What differs from the reference: only the collectives that the port's
program itself performs are counted. Those are the MoE regions'
(all-reduce, all-to-all, all-gather), the seq-sharded decode caches'
(all-reduce) and the pipeline's permutes and loss sums. The collectives
that XLA's partitioner inserts have no counterpart on one card and are
not counted: FSDP's parameter gathers and the gradient reductions over
``data``.
"""
from __future__ import annotations

import math
from collections import defaultdict

from repro_torch.distributed import collectives

_WIRE = {
    "all-gather": lambda b, g: b * (g - 1) / g,
    "reduce-scatter": lambda b, g: b * (g - 1),
    "all-reduce": lambda b, g: b * 2 * (g - 1) / g,
    "all-to-all": lambda b, g: b * (g - 1) / g,
    "collective-permute": lambda b, g: float(b),
}

# the kind of each reporting collective; ``coded_exchange`` is two
# ``all_to_all_blocks``, which report themselves
KINDS = {
    "psum": "all-reduce", "mesh_psum": "all-reduce",
    "mesh_pmax": "all-reduce", "mesh_pmean": "all-reduce",
    "all_to_all_blocks": "all-to-all", "mesh_all_to_all": "all-to-all",
    "mesh_all_gather": "all-gather",
    "ppermute": "collective-permute",
    "tree_gather_permute": "collective-permute",
    "mesh_ppermute": "collective-permute",
}


class CollectiveCounter:
    """Entered, the collectives' observer: ``records`` holds one dict a
    collective, ``{"kind", "result_bytes", "group", "op", "site"}``
    (``result_bytes`` one rank's, ``group`` its g)."""

    def __init__(self):
        self.records: list[dict] = []

    def __enter__(self):
        if collectives.OBSERVER is not None:
            raise RuntimeError("another observer is watching the "
                               "collectives")
        collectives.OBSERVER = self.record
        return self

    def __exit__(self, *exc):
        collectives.OBSERVER = None
        return False

    def record(self, name: str, shapes: tuple, site: str, *, axis_size: int,
               dtype, ranks: int):
        kind = KINDS.get(name)
        if kind is None:
            return
        b = sum(math.prod(s) for s in shapes) // ranks * dtype.itemsize
        if kind == "all-gather":
            b *= axis_size
        self.records.append({"kind": kind, "result_bytes": b,
                             "group": axis_size, "op": name, "site": site})


def collective_bytes(records) -> dict[str, float]:
    """Per-device wire bytes and op counts per collective kind, in the
    reference's keys: ``{kind: bytes, "<kind>_result_bytes": bytes,
    "total": bytes, "n_<kind>": count}``."""
    out: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for r in records:
        kind, b, g = r["kind"], r["result_bytes"], max(int(r["group"]), 1)
        out[kind] += _WIRE[kind](b, g)
        out[f"{kind}_result_bytes"] += b
        counts[kind] += 1
    rec = dict(out)
    rec["total"] = sum(v for k, v in out.items()
                       if not k.endswith("_result_bytes"))
    for k, c in counts.items():
        rec[f"n_{k}"] = c
    return rec
