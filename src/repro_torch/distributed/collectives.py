"""Rank-dimension collectives: the reference's named-axis collectives with
the P ranks as dim 0 of every tensor on one device.

Lockstep semantics match ``shard_map``'s, so a tensor ``x`` here equals
the stack of the P per-rank values the reference would hold.

Every collective, of the rank dim or of a named mesh axis, reports to
:data:`OBSERVER` when one is set: fleetlint's program rules
(``repro_torch.analysis.spmd``) set it for the length of one program
call, the dry run's collective counter (``launch/hlo_stats.py``) for
the length of one measured program. Outside those it is ``None`` and
costs one test a call; a CUDA graph's replay runs no Python and never
reaches it.

The model stack's mesh has named axes (``distributed/mesh.py``): its
``shard_map`` (the counterpart of the reference's) blocks each operand
into ``(*mesh.shape, *local_shape)``, and ``mesh_psum``, ``mesh_pmax``,
``mesh_pmean``, ``mesh_axis_index``, ``mesh_all_to_all``,
``mesh_all_gather`` and ``mesh_ppermute`` act on the mesh dim of a
named axis.
"""
from __future__ import annotations

import math
import os
import sys

import torch

# called as OBSERVER(name, operand shapes, "file:line (fn)" of the caller,
# axis_size=g, dtype=..., ranks=R): g ranks take part in each instance of
# the collective, and R ranks hold the operands (their leading dims), so
# one rank's operand is numel / R elements of ``dtype``
OBSERVER = None


def _report(name: str, *operands: torch.Tensor, axis_size: int = 0,
            ranks: int = 0):
    """Tell :data:`OBSERVER` of one collective, at its caller's site (the
    first frame outside this module). ``axis_size`` and ``ranks`` default
    to the rank dim's size (dim 0 of the first operand)."""
    frame = sys._getframe(1)
    while frame.f_code.co_filename == __file__:
        frame = frame.f_back
    P = operands[0].shape[0]
    OBSERVER(name, tuple(tuple(x.shape) for x in operands), site_of(frame),
             axis_size=axis_size or P, dtype=operands[0].dtype,
             ranks=ranks or P)


def site_of(frame) -> str:
    """``file:line (fn)`` of a frame, the file relative to the package's
    parent directory when it lies below it."""
    path = frame.f_code.co_filename
    root = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    if path.startswith(root + os.sep):
        path = os.path.relpath(path, root)
    return f"{path}:{frame.f_lineno} ({frame.f_code.co_name})"


def axis_index(n_procs: int, device) -> torch.Tensor:
    """Each rank's own index: ``(P,)`` int32."""
    return torch.arange(n_procs, dtype=torch.int32, device=device)


def all_to_all_blocks(x: torch.Tensor, out: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Exchange equal blocks. ``x[i]`` is rank i's ``(P, ...)`` send
    buffer, one block per peer; row j of rank i's result is the block
    rank j addressed to rank i, i.e. ``x[j, i]``. Written into ``out``
    when it is given (the receive buffers stay where they are)."""
    assert x.shape[0] == x.shape[1], x.shape
    if OBSERVER is not None:
        _report("all_to_all_blocks", x)
    if out is None:
        return x.transpose(0, 1).contiguous()
    return out.copy_(x.transpose(0, 1))


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over ranks, replicated back to every rank (dtype kept: int32
    sums wrap mod 2^32 as the reference's do)."""
    if OBSERVER is not None:
        _report("psum", x)
    s = x.sum(dim=0, keepdim=True, dtype=x.dtype)
    return s.expand_as(x).contiguous()


def tree_gather_permute(x: torch.Tensor, level: int) -> torch.Tensor:
    """The combine tree's collective permute at ``level`` l: rank i
    receives rank i + 2**l's payload for i a multiple of 2**(l+1) (when
    that sender exists). Every other rank receives zeros, exactly as
    ``lax.ppermute`` delivers to non-receivers."""
    if OBSERVER is not None:
        _report("tree_gather_permute", x)
    P = x.shape[0]
    stride = 1 << level
    rank = torch.arange(P, device=x.device)
    src = rank + stride
    receiver = (rank % (stride * 2) == 0) & (src < P)
    got = x[src.clamp(max=P - 1)]
    mask = receiver.view((P,) + (1,) * (x.dim() - 1))
    return torch.where(mask, got, torch.zeros_like(got))


def ppermute(x: torch.Tensor, pairs) -> torch.Tensor:
    """``lax.ppermute`` over the rank dim: for each ``(src, dst)`` in
    ``pairs`` rank dst receives rank src's value; a rank that receives
    nothing gets zeros. Each destination appears at most once."""
    if OBSERVER is not None:
        _report("ppermute", x)
    P = x.shape[0]
    pairs = [(int(s), int(d)) for s, d in pairs]
    dst = [d for _, d in pairs]
    if len(set(dst)) != len(dst) or not all(
            0 <= r < P for pair in pairs for r in pair):
        raise ValueError(f"ppermute over {P} ranks takes distinct "
                         f"destinations in range, got {pairs}")
    out = torch.zeros_like(x)
    if pairs:
        out[torch.tensor(dst, device=x.device)] = x[torch.tensor(
            [s for s, _ in pairs], device=x.device)]
    return out


def coded_exchange(bk: torch.Tensor, bv: torch.Tensor, code_rate: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One XOR-coded multicast step of the bucket shuffle (Coded
    MapReduce, arXiv 1512.01625; host half in ``repro_torch.core.coded``).

    ``bk``/``bv`` are ``(P, P, cap)``: rank i's bucket for destination q
    at ``[i, q]``, equal on every member of an r-rank code group (the
    group maps the same task block). Each rank ships one coded block to
    its group peers, the XOR of the buckets addressed to them, and the
    buckets of the other groups' destinations it speaks for (member
    ``q % r`` of every group speaks for destination q). Each rank decodes
    its own bucket from its designated peer ``g·r + (m+1) % r`` by
    XOR-ing back the buckets of the rest of its group, which it mapped
    itself. Returns the ``(P, P, cap)`` rows to fold: the decoded bucket
    on the designated peer's row, the speakers' buckets as received, and
    sentinel and 0 on every other row. Keys and values are int32, which
    XOR exactly (``KEY_SENTINEL`` included)."""
    from repro_torch.core.kv import KEY_SENTINEL
    r = int(code_rate)
    P = bk.shape[0]
    assert r > 1 and P % r == 0 and bk.shape[1] == P, (bk.shape, r)
    if OBSERVER is not None:
        _report("coded_exchange", bk, bv)
    me = torch.arange(P, device=bk.device)
    g, m = me // r, me % r
    q = me.view(1, P)
    in_group = (q // r) == g.view(P, 1)                 # (rank, q)
    peer = in_group & (q != me.view(P, 1))
    d = g * r + (m + 1) % r                              # designated peer
    side = peer & (q != d.view(P, 1))
    speak = ~in_group & ((q % r) == m.view(P, 1))

    def group_xor(x, mask):
        # XOR of each rank's r group rows under ``mask``: the rows
        # outside the group are never in a mask, so r - 1 XORs do
        rows = x.reshape(P, P // r, r, -1)[me, g]           # (P, r, cap)
        on = mask.view(P, P // r, r)[me, g].unsqueeze(-1)
        acc = torch.where(on[:, 0], rows[:, 0], 0)
        for j in range(1, r):
            acc = acc ^ torch.where(on[:, j], rows[:, j], 0)
        return acc

    peer3, speak3 = peer.unsqueeze(-1), speak.unsqueeze(-1)
    sk = torch.where(peer3, group_xor(bk, peer).unsqueeze(1),
                     torch.where(speak3, bk, KEY_SENTINEL))
    sv = torch.where(peer3, group_xor(bv, peer).unsqueeze(1),
                     torch.where(speak3, bv, 0))
    gk, gv = all_to_all_blocks(sk), all_to_all_blocks(sv)
    dk = gk[me, d] ^ group_xor(bk, side)
    dv = gv[me, d] ^ group_xor(bv, side)
    mine = (q == d.view(P, 1)).unsqueeze(-1)
    ing = in_group.unsqueeze(-1)
    rk = torch.where(ing, torch.where(mine, dk.unsqueeze(1), KEY_SENTINEL),
                     gk)
    rv = torch.where(ing, torch.where(mine, dv.unsqueeze(1), 0), gv)
    return rk, rv


# ---------------------------------------------------------------------------
# named mesh axes: the reference's ``shard_map`` over a virtual mesh
# ---------------------------------------------------------------------------
#
# A ``distributed.mesh.Mesh`` names its axes; its ranks are virtual, all on
# the one device. Inside ``shard_map`` every operand is blocked into
# ``(*mesh.shape, *local_shape)``: rank (i, j, ...) of the reference holds
# ``x[i, j, ...]``. The forms below act on the mesh dim of a named axis,
# keep autograd's graph (the train step differentiates through them) and
# are the model stack's. Each reports to ``OBSERVER`` with the size of its
# axes and the mesh's rank count.

def _axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _entries(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the operand's "
                         f"{ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def _dims(mesh, axes) -> list[int]:
    axes = _axes(axes)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} is not one of the mesh's "
                             f"{mesh.axis_names}")
    return [mesh.axis_names.index(a) for a in axes]


def block(x: torch.Tensor, spec, mesh, *, view: bool = False
          ) -> torch.Tensor:
    """``x`` as the mesh's ranks hold it under ``spec``: ``(*mesh.shape,
    *local_shape)``, each dim of ``x`` cut into equal blocks over the
    axes its entry names (a tuple entry major to minor), and an axis no
    entry names an ``expand`` (replicated: no copy). With ``view`` the
    result must share ``x``'s memory (an in-place write through it lands
    in ``x``), which holds for a contiguous ``x``."""
    if x.device != mesh.device:
        raise ValueError(f"an operand on {x.device} meets a mesh on "
                         f"{mesh.device}")
    entries = _entries(spec, x.dim())
    split, where, local = [], {}, []
    for n, entry in zip(x.shape, entries):
        axes = _axes(entry)
        k = math.prod(mesh.axis_size(a) for a in axes)
        if n % k:
            raise ValueError(f"dim of {n} does not divide over the mesh "
                             f"axes {axes} ({k} ranks)")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {entries} names axis {a!r} twice")
            _dims(mesh, a)
            where[a] = len(split)
            split.append(mesh.axis_size(a))
        local.append(len(split))
        split.append(n // k)
    y = x.view(split) if view else x.reshape(split)
    perm = []
    for a in mesh.axis_names:
        if a not in where:
            where[a] = y.dim()
            y = y.unsqueeze(-1)
        perm.append(where[a])
    return y.permute(perm + local).expand(*mesh.shape,
                                          *(split[i] for i in local))


def unblock(y: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor of ranks' blocks ``y`` (``(*mesh.shape,
    *local_shape)``) under out-spec ``spec``: the blocks of the axes an
    entry names are joined along its dim; an axis no entry names is
    replicated, and rank 0's block along it is taken."""
    nm = len(mesh.shape)
    entries = _entries(spec, y.dim() - nm)
    named = [a for e in entries for a in _axes(e)]
    _dims(mesh, tuple(named))
    kept = [d for d in range(nm) if mesh.axis_names[d] in named]
    for d in reversed(range(nm)):
        if mesh.axis_names[d] not in named:
            y = y.select(d, 0)
    pos = {mesh.axis_names[d]: k for k, d in enumerate(kept)}
    perm, shape = [], []
    for i, entry in enumerate(entries):
        axes = _axes(entry)
        perm += [pos[a] for a in axes] + [len(kept) + i]
        shape.append(math.prod(mesh.axis_size(a) for a in axes)
                     * y.shape[len(kept) + i])
    return y.permute(perm).reshape(shape)


def shard_map(f, *, mesh, in_specs, out_specs):
    """``f`` over the ranks of ``mesh``, as the reference's ``shard_map``:
    each tensor operand is blocked by its in-spec (``block``), ``f`` runs
    once on the blocks of every rank together (its collectives are the
    named-axis forms here), and each tensor it returns is unblocked by
    its out-spec (``unblock``). A non-tensor operand (a host int) is
    passed as it is."""
    def run(*args):
        blocked = [block(a, s, mesh) if isinstance(a, torch.Tensor) else a
                   for a, s in zip(args, in_specs, strict=True)]
        out = f(*blocked)
        if isinstance(out, tuple):
            return tuple(unblock(o, s, mesh)
                         for o, s in zip(out, out_specs, strict=True))
        return unblock(out, out_specs, mesh)
    return run


def mesh_axis_size(mesh, axis: str) -> int:
    return mesh.axis_size(axis)


def mesh_axis_index(mesh, axis: str, device=None) -> torch.Tensor:
    """Each rank's index along ``axis``: int32 of ``mesh.shape``."""
    d, = _dims(mesh, axis)
    shape = [1] * len(mesh.shape)
    shape[d] = mesh.shape[d]
    return torch.arange(mesh.shape[d], dtype=torch.int32,
                        device=mesh.device if device is None else device) \
        .view(shape).expand(mesh.shape)


def _report_mesh(name: str, x: torch.Tensor, mesh, dims):
    _report(name, x, axis_size=math.prod(mesh.shape[d] for d in dims),
            ranks=mesh.size)


def mesh_psum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """Sum over the ranks of ``axes`` (a name or a tuple), replicated back
    to each of them (a broadcast view)."""
    dims = _dims(mesh, axes)
    if not dims:
        return x
    if OBSERVER is not None:
        _report_mesh("mesh_psum", x, mesh, dims)
    return x.sum(dims, keepdim=True, dtype=x.dtype).expand_as(x)


def mesh_pmax(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    dims = _dims(mesh, axes)
    if not dims:
        return x
    if OBSERVER is not None:
        _report_mesh("mesh_pmax", x, mesh, dims)
    return x.amax(dims, keepdim=True).expand_as(x)


def mesh_pmean(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    dims = _dims(mesh, axes)
    if not dims:
        return x
    if OBSERVER is not None:
        _report_mesh("mesh_pmean", x, mesh, dims)
    return x.mean(dims, keepdim=True, dtype=x.dtype).expand_as(x)


def mesh_all_to_all(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0)``: each rank's local dim 0 holds
    one block a peer along ``axis``; block j of rank i's result is the
    block rank j addressed to rank i (the axis' mesh dim swapped with
    local dim 0)."""
    d, = _dims(mesh, axis)
    nm = len(mesh.shape)
    if x.shape[nm] != mesh.shape[d]:
        raise ValueError(f"all_to_all over {axis!r} ({mesh.shape[d]} ranks) "
                         f"of local dim 0 of size {x.shape[nm]}")
    if OBSERVER is not None:
        _report_mesh("mesh_all_to_all", x, mesh, (d,))
    return x.transpose(d, nm)


def mesh_all_gather(x: torch.Tensor, axis: str, mesh, dim: int = 0
                    ) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: the blocks of
    the ranks along ``axis`` joined along local dim ``dim``, on each of
    them."""
    d, = _dims(mesh, axis)
    if OBSERVER is not None:
        _report_mesh("mesh_all_gather", x, mesh, (d,))
    nm = len(mesh.shape)
    at = nm + dim                          # the local dim in x
    y = x.movedim(d, at - 1).flatten(at - 1, at)
    shape = list(x.shape)
    shape[at] *= x.shape[d]
    return y.unsqueeze(d).expand(shape)


def mesh_ppermute(x: torch.Tensor, axis: str, perm, mesh) -> torch.Tensor:
    """``lax.ppermute(x, axis, perm)``: for each ``(src, dst)`` in
    ``perm`` the ranks at index dst along ``axis`` receive the blocks of
    those at src; a rank that receives nothing gets zeros. Each
    destination appears at most once. Differentiable: its backward pass
    is the reverse permute."""
    d, = _dims(mesh, axis)
    n = mesh.shape[d]
    pairs = [(int(s), int(t)) for s, t in perm]
    dst = [t for _, t in pairs]
    if len(set(dst)) != len(dst) or not all(
            0 <= r < n for pair in pairs for r in pair):
        raise ValueError(f"ppermute over {axis!r} ({n} ranks) takes "
                         f"distinct destinations in range, got {pairs}")
    if OBSERVER is not None:
        _report_mesh("mesh_ppermute", x, mesh, (d,))
    src_of = dict((t, s) for s, t in pairs)
    zero = torch.zeros_like(x.select(d, 0)) if len(pairs) < n else None
    return torch.stack([x.select(d, src_of[r]) if r in src_of else zero
                        for r in range(n)], d)
