"""Run-time SPMD checks over the rank dim: the port's counterpart of the
reference's taint interpreter (``repro/analysis/taint.py``).

The reference proves its program rules on a jaxpr, for every input. The
port's P ranks are dim 0 of each tensor on one device and a program is
Python over torch ops, with no jaxpr to walk, so here the rules are
checked while the program runs on seeded inputs, one program call at a
time. They hold for what those inputs exercise, no more.

  * SPMD001 — every collective reduces or exchanges over the rank dim:
    the operand of ``psum``, ``tree_gather_permute`` and ``ppermute``
    leads with P, those of ``all_to_all_blocks`` and ``coded_exchange``
    with (P, P). :class:`Watch` is the collectives' observer
    (``distributed.collectives.OBSERVER``). A dim that merely has size P
    is taken for the rank dim, so the corpus's mutants use widths other
    than P.
  * SPMD002 — no collective under a branch on a per-rank value. In
    lockstep a per-rank value reaches Python control flow one way only:
    one rank's slice is read to the host. :class:`Watch` is also a
    ``TorchFunctionMode`` that tags a rank slice (one index of dim 0 of a
    tensor whose dim 0 is P, by ``__getitem__`` with an integer — a
    Python or numpy one, or a 0-dim integer tensor —, ``select`` or
    ``unbind``) replicated or varying by whether that tensor's rows are
    all equal at that moment, makes the outputs of an op varying when an
    input is, and records host reads (``bool``, ``int``, ``float``,
    ``index``, ``item``, ``tolist``, ``numpy``) of tagged tensors. A
    collective after a host read of a varying value in the same call is a
    finding at the read. Reads of a whole tensor (every rank's row) are
    not rank-divergent and are not tagged.
  * REP001 — after each call every output the handle asserts replicated
    is equal along dim 0 (:func:`first_differing_rank`).

While a CUDA graph is being captured the mode stands aside (a value
check would break the capture); the observer still records the
collectives the capture issues, once a graph, since a replay runs no
Python.
"""
from __future__ import annotations

import numbers
import os
import sys

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.analysis.findings import Finding
from repro_torch.distributed import collectives

REPLICATED = 0
VARYING = 1

# collectives over the rank dim, by the leading dims of their operands
RANK_DIMS = {"psum": 1, "tree_gather_permute": 1, "ppermute": 1,
             "all_to_all_blocks": 2, "coded_exchange": 2}
HOST_READS = frozenset({"__bool__", "__int__", "__index__", "__float__",
                        "item", "tolist", "numpy"})
_TAG = "_rank_tag"
_SKIP = (os.path.dirname(torch.__file__) + os.sep, __file__)


def tag_of(x) -> int | None:
    return getattr(x, _TAG, None) if isinstance(x, torch.Tensor) else None


def _tag(out, tag: int):
    if isinstance(out, torch.Tensor):
        setattr(out, _TAG, max(tag, tag_of(out) or REPLICATED))
    elif isinstance(out, (tuple, list)):
        for t in out:
            _tag(t, tag)


def _input_tag(args, kwargs) -> int | None:
    """The join of the tags among an op's tensor arguments (one level of
    lists and tuples deep), or None when none is tagged."""
    tags = [tag_of(a) for a in args]
    tags += [tag_of(t) for a in args if isinstance(a, (tuple, list))
             for t in a]
    tags += [tag_of(v) for v in kwargs.values()]
    tags = [t for t in tags if t is not None]
    return max(tags) if tags else None


def _integer_index(idx) -> bool:
    """Whether ``idx`` picks one index of a dim: an integer (not a bool),
    or a 0-dim integer tensor."""
    if isinstance(idx, torch.Tensor):
        return idx.dim() == 0 and not idx.is_floating_point() \
            and not idx.is_complex() and idx.dtype != torch.bool
    return isinstance(idx, numbers.Integral) and not isinstance(idx, bool)


def _rows_equal(x: torch.Tensor) -> bool:
    return bool(torch.equal(x, x[:1].expand_as(x)))


def _user_site() -> str:
    """``file:line (fn)`` of the innermost frame outside torch and this
    module: the program line that made the call."""
    frame = sys._getframe(1)
    while frame.f_back is not None and \
            frame.f_code.co_filename.startswith(_SKIP):
        frame = frame.f_back
    return collectives.site_of(frame)


class Watch(TorchFunctionMode):
    """SPMD001 and SPMD002 over one program call at ``n_procs`` ranks:
    entered, it is the collectives' observer and the torch function
    mode; ``findings`` holds what it saw, ``reads`` the host reads of
    tagged values and ``collectives`` the collectives, in order."""

    def __init__(self, program: str, n_procs: int):
        super().__init__()
        self.program, self.P = program, int(n_procs)
        self.findings: list[Finding] = []
        self.reads: list[tuple[int, str]] = []     # (tag, site)
        self.collectives: list[tuple[str, tuple, str]] = []
        self._cuda = torch.cuda.is_available()

    def __enter__(self):
        if collectives.OBSERVER is not None:
            raise RuntimeError("a lint watch is already observing the "
                               "collectives")
        collectives.OBSERVER = self.collective
        try:
            return super().__enter__()
        except BaseException:
            collectives.OBSERVER = None
            raise

    def __exit__(self, *exc):
        collectives.OBSERVER = None
        return super().__exit__(*exc)

    def _emit(self, rule: str, where: str, message: str):
        self.findings.append(Finding(rule, self.program, where, message))

    # -- the collectives' observer -----------------------------------------

    def collective(self, name: str, shapes: tuple, site: str, **report):
        """The collectives' observer. A named-axis collective of the model
        stack (``mesh_*``, its operands led by the mesh's dims) is
        recorded and checked under SPMD002 alone."""
        self.collectives.append((name, shapes, site))
        lead = RANK_DIMS.get(name, 0)
        for shape in shapes if lead else ():
            if tuple(shape[:lead]) != (self.P,) * lead:
                self._emit(
                    "SPMD001", site,
                    f"collective '{name}' over an operand of shape "
                    f"{tuple(shape)}: its leading "
                    f"{'dim is' if lead == 1 else f'{lead} dims are'} not "
                    f"the rank dim (P = {self.P})")
        for tag, read in self.reads:
            if tag == VARYING:
                self._emit(
                    "SPMD002", read,
                    f"collective '{name}' at {site} follows a host read "
                    "of a rank-varying value in the same program call — "
                    "ranks would disagree on whether to reach it")

    # -- the mode ------------------------------------------------------------

    def _rank_slice(self, name: str, args, kwargs) -> bool:
        x = args[0] if args else None
        if not isinstance(x, torch.Tensor) or x.dim() == 0 \
                or x.shape[0] != self.P:
            return False
        if name == "__getitem__":
            idx = args[1]
            if isinstance(idx, tuple):
                idx = idx[0] if idx else None
            return _integer_index(idx)
        if name == "select":
            dim = args[1] if len(args) > 1 else kwargs.get("dim")
            return dim == 0
        if name == "unbind":
            return (args[1] if len(args) > 1 else kwargs.get("dim", 0)) == 0
        return False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._cuda and torch.cuda.is_current_stream_capturing():
            return func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        tag = _input_tag(args, kwargs)
        if name in HOST_READS and tag is not None:
            self.reads.append((tag, _user_site()))
        out = func(*args, **kwargs)
        if self._rank_slice(name, args, kwargs):
            row = REPLICATED if _rows_equal(args[0]) else VARYING
            _tag(out, max(row, tag or REPLICATED))
        elif tag is not None:
            _tag(out, tag)
        return out


def first_differing_rank(x: torch.Tensor) -> int | None:
    """The first rank whose row of ``x`` differs from rank 0's, or None
    when every row equals it."""
    differs = (x != x[:1]).reshape(x.shape[0], -1).any(dim=1)
    hit = torch.nonzero(differs)
    return int(hit[0, 0]) if hit.numel() else None
