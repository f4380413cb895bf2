"""Mixture-of-Experts with the paper's decoupled dispatch (counterpart of
``repro/models/moe.py``).

``router(token) -> expert`` is the paper's ``hash(key) -> owner``:
tokens are key-value records, experts their owners, and expert
parallelism's all_to_all is the shuffle. Two dispatch schedules, as in
the reference:

  "2s"  bulk-synchronous (baseline): route all tokens, one push out,
        the expert GEMMs, one push back;
  "1s"  decoupled (the paper): tokens stream in ``dispatch_groups``
        groups through a software pipeline; step g pushes group g's
        buckets while the expert GEMMs and the return push of group g-1
        run. Same bytes, overlapped schedule.

Both run inside one ``shard_map`` over the whole mesh, as in the
reference: activations enter sequence-sharded over "model" (each shard
owns T_loc tokens), experts are sharded over "model" (EP), the batch
over the data axes. The mesh's ranks are virtual
(``distributed/mesh.py``): inside the region each tensor carries them as
leading dims, which the dispatch flattens into one rank dim R (R = 1
without a mesh, where the push is the identity), and the push
(``_a2a``) is ``collectives.mesh_all_to_all`` over "model", on one card
a swap of two dims. At decode (S = 1, which cannot be sequence-sharded)
the tokens replicate over "model" and ``_dispatch_replicated`` runs.

Both slotting steps of a dispatch, each record's slot in its peer bucket
(``_bucket_indices``) and in its local expert's buffer (``_expert_gemm``),
are ``bucket_slots``: ``slot[t] = #{t' < t : id[t'] == id[t]}``, which
the reference computes with a stable argsort and a searchsorted. With
``use_kernel=True`` they go through the kernel's wrapper (the
hand-written kernel on a CUDA tensor, its plain version on a CPU one),
with ``use_kernel=False`` through the plain version. Under a mesh one
call slots the records of every rank (``_shard_slots``): rank r's ids
are offset by r x the bucket count, and a slot counts equal ids only,
so each rank's slots are the ones its own call would give. The kernel
takes up to ``MAX_EXPERTS`` (256) buckets; past that one call slots each
group of ranks that fits.

The expert GEMMs run once a local expert over the capacity rows of
every rank that holds it (``_swiglu``): the ranks along the data axes
are folded into the rows, so each expert's weights are read once.

Where the reference scatter-adds rows back (an expert's results to
their records, the weighted results to their tokens), the port gathers
each record's row through the inverse of its slot index: the same
function, with no atomics on the card, so both paths give the same bits
there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import P
from repro_torch.kernels.moe_dispatch import ops as slot_ops
from repro_torch.kernels.moe_dispatch.ops import MAX_EXPERTS as MAX_BUCKETS
from repro_torch.kernels.moe_dispatch.ref import bucket_slots_ref
from repro_torch.models.layers import DTYPES, _init

EP_AXIS = "model"


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d = cfg.d_model
    ffe = cfg.d_ff_expert or cfg.d_ff
    E = cfg.n_experts
    dt = DTYPES[cfg.param_dtype]
    s_in, s_out = d ** -0.5, ffe ** -0.5
    p = {
        "router": _init(gen, (d, E), 0.02, torch.float32),
        "we_gate": _init(gen, (E, d, ffe), s_in, dt),
        "we_in": _init(gen, (E, d, ffe), s_in, dt),
        "we_out": _init(gen, (E, ffe, d), s_out, dt),
    }
    if cfg.n_shared_experts:
        ffs = ffe * cfg.n_shared_experts
        p["ws_gate"] = _init(gen, (d, ffs), s_in, dt)
        p["ws_in"] = _init(gen, (d, ffs), s_in, dt)
        p["ws_out"] = _init(gen, (ffs, d), s_out, dt)
    return p


# ---------------------------------------------------------------------------
# routing + bucketing (sender side): the hash -> owner of the paper
# ---------------------------------------------------------------------------

def _route(cfg: ModelConfig, router_w, x_flat):
    """x_flat: (T, D) -> (expert_ids (T, k) int32, gates (T, k), probs
    (T, E)), in fp32."""
    probs = torch.softmax(x_flat.float() @ router_w, -1)
    gates, ids = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return ids.to(torch.int32), gates, probs


def _aux_loss(cfg: ModelConfig, probs, ids, sum_axes=(), mesh=None):
    """Switch-style load-balancing loss of probs (..., T, E) and ids (...,
    T, k); the leading dims are a mesh's ranks inside the MoE region
    (none unsharded). ``sum_axes``: the mesh axes the tokens are sharded
    over; the counts and probability sums psum over them, so the sharded
    loss equals the unpartitioned one exactly (not a mean of means)."""
    E = cfg.n_experts
    T = probs.shape[-2]
    lead = probs.shape[:-2]
    flat = ids.reshape(*lead, -1).long()
    counts = torch.zeros((*lead, E), dtype=torch.float32,
                         device=probs.device).scatter_add_(
        -1, flat, torch.ones(flat.shape, dtype=torch.float32,
                             device=probs.device))
    sum_probs = probs.float().sum(-2)
    n_shards = 1
    for ax in sum_axes:
        counts = coll.mesh_psum(counts, ax, mesh)
        sum_probs = coll.mesh_psum(sum_probs, ax, mesh)
        n_shards *= mesh.axis_size(ax)
    T_tot = T * n_shards
    frac_tokens = counts / max(T_tot * cfg.top_k, 1)
    frac_probs = sum_probs / max(T_tot, 1)
    return E * (frac_tokens * frac_probs).sum(-1)


def shard_slot_calls(ranks: int, n_buckets: int) -> int:
    """bucket_slots calls ``_shard_slots`` makes for ``ranks`` ranks of
    ``n_buckets`` buckets: one for as many ranks as fit the kernel's
    MAX_EXPERTS buckets."""
    return -(-ranks // max(1, MAX_BUCKETS // n_buckets))


def _shard_slots(ids, n_buckets: int, *, use_kernel: bool = False):
    """Each rank's bucket slots of its ids (R, N), one row a rank (an id
    outside [0, n_buckets) is invalid and gets -1): ``slot[r, t] = #{t' <
    t : id[r, t'] == id[r, t]}``. One bucket_slots call (the kernel's
    wrapper with ``use_kernel``, else its plain version) takes the ids of
    as many ranks as fit MAX_EXPERTS buckets, rank r's ids offset by r x
    ``n_buckets``: a slot counts equal ids only, so each rank gets its
    own slots. A single rank's ids go in as they are."""
    fn = slot_ops.bucket_slots if use_kernel else bucket_slots_ref
    R, N = ids.shape
    per = max(1, MAX_BUCKETS // n_buckets)
    out = []
    for lo in range(0, R, per):
        part = ids[lo:lo + per]
        n = part.shape[0]
        if n > 1:
            off = torch.arange(n, dtype=torch.int32,
                               device=ids.device)[:, None] * n_buckets
            part = torch.where((part >= 0) & (part < n_buckets), part + off,
                               -1)
        slots, _ = fn(part.reshape(-1).contiguous(), n * n_buckets)
        out.append(slots.view(n, N))
    return out[0] if len(out) == 1 else torch.cat(out)


def _bucket_indices(shard_ids, valid, tp: int, cap: int, *,
                    use_kernel: bool = False):
    """Slot each record into (tp, cap) peer buckets (sender side), for
    each rank: ``shard_ids``/``valid`` (R, N) or one rank's (N,).

    Returns flat gather indices (R, tp * cap) (or (tp * cap,)) into each
    rank's records, -1 = empty. Overflow records are dropped
    (capacity-factor semantics: a dropped token keeps its residual
    value). Record t sits at ``id[t] * cap + slot[t]`` where ``slot`` is
    ``_shard_slots``' over the ids, -1 for an invalid record."""
    if shard_ids.dim() == 1:
        return _bucket_indices(shard_ids[None], valid[None], tp, cap,
                               use_kernel=use_kernel)[0]
    ids = torch.where(valid, shard_ids, -1).to(torch.int32)
    R, N = ids.shape
    slots = _shard_slots(ids, tp, use_kernel=use_kernel)
    keep = (slots >= 0) & (slots < cap)
    row = tp * cap + 1
    base = torch.arange(R, device=ids.device)[:, None] * row
    flat = torch.where(keep, ids * cap + slots, tp * cap) + base
    rec = torch.arange(N, dtype=torch.int32, device=ids.device).expand(R, N)
    idx = torch.full((R * row,), -1, dtype=torch.int32, device=ids.device)
    idx[flat.reshape(-1)] = torch.where(keep, rec, -1).reshape(-1)
    return idx.view(R, row)[:, :-1]


def _record_slots(idx, n_records: int):
    """The inverse of a slot index ``idx`` (R, S) (slot -> record, -1
    empty): each of ``n_records`` records' slot (R, n_records), -1 for a
    record that holds none (dropped at capacity, or invalid)."""
    R, S = idx.shape
    row = n_records + 1
    pos = torch.full((R * row,), -1, dtype=torch.int32, device=idx.device)
    slot = torch.arange(S, dtype=torch.int32, device=idx.device).expand(R, S)
    base = torch.arange(R, device=idx.device)[:, None] * row
    pos[(torch.where(idx >= 0, idx, n_records) + base).reshape(-1)] = \
        slot.reshape(-1)
    return pos.view(R, row)[:, :-1]


def _gather_records(x, idx):
    """x: (R, T, D); idx: (R, M) with -1 invalid -> (R, M, D), zeros where
    invalid (or one rank's x (T, D) and idx (M,) -> (M, D))."""
    if idx.dim() == 1:
        return _gather_records(x[None], idx[None])[0]
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    out = x[rows, idx.clamp(0, x.shape[1] - 1).long()]
    return torch.where((idx >= 0)[..., None], out, torch.zeros_like(out))


def _swiglu(p, grouped, mesh, fold: bool):
    """The SwiGLU expert GEMMs of every rank's grouped records (R, E_loc,
    cap_e, D). With ``fold`` the weights ``p["we_*"]`` vary along "model"
    alone (EP): they come as the global weights' (tp, E_loc, ...) view
    ((E, ...) without a mesh), and each expert's GEMM runs once over the
    rows of every rank along the other axes, folded into its capacity
    rows, so its weights are read once. Otherwise (expert-TP weights,
    ``expert_tp_axis``) they come blocked (*ranks, E_loc, ...) and each
    rank's run apart."""
    wg, wi, wo = p["we_gate"], p["we_in"], p["we_out"]
    R, E_loc, c, D = grouped.shape
    if not fold:
        def mm(a, w):
            return torch.bmm(a, w.reshape(R * E_loc, *w.shape[-2:]))
        g = grouped.reshape(R * E_loc, c, D)
        h = F.silu(mm(g, wg)) * mm(g, wi)
        return mm(h, wo).view(R, E_loc, c, D)
    ms = tuple(mesh.shape) if mesh is not None else ()
    mi = mesh.axis_names.index(EP_AXIS) if mesh is not None else None
    m = ms[mi] if mi is not None else 1
    wg, wi, wo = (w.reshape(m * E_loc, *w.shape[-2:]) for w in (wg, wi, wo))
    g = grouped.view(*ms, E_loc, c, D)
    g = g.movedim(mi, 0) if mi is not None else g[None]
    g = g.reshape(m, R // m, E_loc, c, D).transpose(1, 2).reshape(
        m * E_loc, R // m * c, D)
    out = torch.bmm(F.silu(torch.bmm(g, wg)) * torch.bmm(g, wi), wo)
    out = out.view(m, E_loc, R // m, c, D).transpose(1, 2)
    if mi is None:
        return out.reshape(R, E_loc, c, D)
    rest = [s for d, s in enumerate(ms) if d != mi]
    return out.reshape(m, *rest, E_loc, c, D).movedim(0, mi) \
        .reshape(R, E_loc, c, D)


def _expert_gemm(cfg: ModelConfig, p, toks, eids, valid, *, mesh=None,
                 use_kernel: bool = False):
    """toks: (R, M, D) each rank's received records; eids: (R, M) their
    local expert ids (or one rank's (M, D) and (M,), unsharded).

    Groups each rank's records into per-local-expert capacity buffers
    (the same slotting as ``_bucket_indices``, over E_loc buffers of
    cap_e), runs the SwiGLU expert GEMMs (``_swiglu``), and returns each
    record's result (zeros for a record dropped or invalid). The
    reference scatter-adds the slots' rows back into zeros; a kept record
    holds one slot, so the port gathers its row instead: the same
    values, with no atomics on the card, and the empty slots' zero rows
    are never summed."""
    if eids.dim() == 1:
        return _expert_gemm(cfg, p, toks[None], eids[None], valid[None],
                            mesh=mesh, use_kernel=use_kernel)[0]
    R, M, D = toks.shape
    E_loc = p["we_gate"].shape[-3]
    cap_e = -(-M // E_loc)            # ceil; all records on one expert is
    cap_e = min(M, int(cap_e * 4))    # the worst case: 4x headroom
    slot_of_record = _bucket_indices(eids, valid, E_loc, cap_e,
                                     use_kernel=use_kernel)
    grouped = _gather_records(toks, slot_of_record).view(R, E_loc, cap_e, D)
    out = _swiglu(p, grouped, mesh, fold=not cfg.expert_tp_axis)
    return _gather_records(out.view(R, E_loc * cap_e, D),
                           _record_slots(slot_of_record, M))


# ---------------------------------------------------------------------------
# dispatch schedules
# ---------------------------------------------------------------------------

def _a2a(x, axis, mesh=None):
    """all_to_all over ``axis`` of each rank's (tp, ...) blocks, x (R,
    tp, ...): block j of rank i's result is the block rank j addressed
    to it. The identity when unpartitioned (``axis`` None)."""
    if axis is None:
        return x
    ms = tuple(mesh.shape)
    y = coll.mesh_all_to_all(x.view(*ms, *x.shape[1:]), axis, mesh)
    return y.reshape(x.shape)


def _combine(back, idx, gates, k: int):
    """Each rank's output (R, T, D) from its returned bucket rows ``back``
    (R, S, D): token t's k records (record t * k + j is its j-th choice;
    ``idx`` (R, S) maps bucket slots to records) weighted by their gates
    (R, T * k), cast to the model dtype first, and summed. The reference
    scatter-adds the weighted rows into y; the port gathers each
    record's row and sums a token's k rows, which is deterministic on
    the card (no atomics) and sums in fp32 before one rounding. A dropped
    record adds nothing."""
    R, Tk = gates.shape
    pos = _record_slots(idx, Tk)
    w = torch.where(pos >= 0, gates, 0.0)
    rows = _gather_records(back, pos) * w[..., None].to(back.dtype)
    return rows.reshape(R, Tk // k, k, -1).sum(2)


def _send(x, ids, idx, tok_of, E_loc: int, tp: int, cap: int):
    """The (R, tp, cap) peer buckets of records slotted by ``idx``: each
    record's token row of x (R, T, D) and its local expert id (-1 for an
    empty slot)."""
    R, Tk = ids.shape
    rec = idx.clamp(0, Tk - 1).long()
    send_tok = _gather_records(x, torch.where(idx >= 0, tok_of[rec], -1))
    send_eloc = torch.where(idx >= 0, ids.gather(1, rec) % E_loc, -1)
    return (send_tok.view(R, tp, cap, x.shape[-1]),
            send_eloc.view(R, tp, cap))


def _dispatch_2s(cfg: ModelConfig, p, x_flat, ids, gates, tp: int,
                 E_loc: int, axis, *, mesh=None, use_kernel: bool = False):
    """Bulk-synchronous EP dispatch (baseline) of each rank's tokens
    x_flat (R, T, D) routed to ids/gates (R, T, k)."""
    R, T, D = x_flat.shape
    k = cfg.top_k
    Tk = T * k
    cap = int(cfg.capacity_factor * Tk / tp) + 1
    dev = x_flat.device
    flat_ids = ids.reshape(R, Tk)
    tok_of = torch.arange(T, dtype=torch.int32, device=dev) \
        .repeat_interleave(k)
    idx = _bucket_indices(flat_ids // E_loc,
                          torch.ones((R, Tk), dtype=torch.bool, device=dev),
                          tp, cap, use_kernel=use_kernel)
    send_tok, send_eloc = _send(x_flat, flat_ids, idx, tok_of, E_loc, tp,
                                cap)
    recv_tok = _a2a(send_tok, axis, mesh)
    recv_eloc = _a2a(send_eloc, axis, mesh).reshape(R, tp * cap)
    out = _expert_gemm(cfg, p, recv_tok.reshape(R, tp * cap, D), recv_eloc,
                       recv_eloc >= 0, mesh=mesh, use_kernel=use_kernel)
    back = _a2a(out.view(R, tp, cap, D), axis, mesh).reshape(R, tp * cap, D)
    # weighted combine into token outputs
    return _combine(back, idx, gates.reshape(R, Tk), k)


def _dispatch_1s(cfg: ModelConfig, p, x_flat, ids, gates, tp: int,
                 E_loc: int, axis, *, mesh=None, use_kernel: bool = False):
    """Decoupled pipelined dispatch: the paper's technique, as the
    reference's scan of G + 1 steps in a Python loop, over each rank's
    tokens x_flat (R, T, D).

    step g:   push buckets(g)
              GEMM recv(g-1)            [overlaps the push]
              push-back out(g-1)
              combine back(g-1) into y
    Step G pushes the last group again (the reference's scan needs a
    uniform body) and drains group G-1; step 0 runs the GEMM on the empty
    carry, as the reference's does, and combines nothing.
    """
    R, T, D = x_flat.shape
    k = cfg.top_k
    G = max(1, min(cfg.dispatch_groups, T))
    assert T % G == 0, (T, G)
    Tg = T // G
    Tkg = Tg * k
    cap = int(cfg.capacity_factor * Tkg / tp) + 1
    dev, dt = x_flat.device, x_flat.dtype
    tok_of = torch.arange(Tg, dtype=torch.int32, device=dev) \
        .repeat_interleave(k)
    all_valid = torch.ones((R, Tkg), dtype=torch.bool, device=dev)

    def bucket_group(g):
        ids_g = ids[:, g * Tg:(g + 1) * Tg].reshape(R, Tkg)
        idx = _bucket_indices(ids_g // E_loc, all_valid, tp, cap,
                              use_kernel=use_kernel)
        send_tok, send_eloc = _send(x_flat[:, g * Tg:(g + 1) * Tg], ids_g,
                                    idx, tok_of, E_loc, tp, cap)
        return (send_tok, send_eloc, idx,
                gates[:, g * Tg:(g + 1) * Tg].reshape(R, Tkg))

    ys = []
    recv_tok = torch.zeros((R, tp, cap, D), dtype=dt, device=dev)
    recv_eloc = torch.full((R, tp, cap), -1, dtype=torch.int32, device=dev)
    idx_p = torch.full((R, tp * cap), -1, dtype=torch.int32, device=dev)
    gates_p = torch.zeros((R, Tkg), dtype=torch.float32, device=dev)
    for g in range(G + 1):
        # (1) push group g's buckets
        send_tok, send_eloc, idx, gates_g = bucket_group(min(g, G - 1))
        r_tok, r_eloc = _a2a(send_tok, axis, mesh), _a2a(send_eloc, axis,
                                                          mesh)
        # (2) expert GEMM of the previous group's received records
        eloc = recv_eloc.reshape(R, tp * cap)
        out = _expert_gemm(cfg, p, recv_tok.reshape(R, tp * cap, D), eloc,
                           eloc >= 0, mesh=mesh, use_kernel=use_kernel)
        # (3) return push
        back = _a2a(out.view(R, tp, cap, D), axis, mesh) \
            .reshape(R, tp * cap, D)
        # (4) weighted combine into the previous group's slice of y
        if g > 0:
            ys.append(_combine(back, idx_p, gates_p, k))
        recv_tok, recv_eloc, idx_p, gates_p = r_tok, r_eloc, idx, gates_g
    return torch.cat(ys, 1)


def _dispatch_replicated(cfg: ModelConfig, p, x_flat, ids, gates,
                         E_loc: int, axis, *, mesh=None,
                         use_kernel: bool = False):
    """Decode-time EP: tokens replicated over the model axis (S = 1 cannot
    be sequence-sharded). Each rank runs its local experts on the tokens
    routed to them (x_flat (R, T, D), ids/gates (R, T, k)) and the
    outputs psum over ``axis``: no all_to_all, the right schedule when a
    step carries few tokens.

    With ``cfg.expert_tp_axis`` (serve sharding) each expert's d_ff is
    also TP-sharded over that axis; expert outputs are partial sums, so
    the psum also reduces over it: no weight gather ever."""
    R, T, D = x_flat.shape
    k = cfg.top_k
    Tk = T * k
    dev = x_flat.device
    shard = (coll.mesh_axis_index(mesh, axis, dev).reshape(R, 1)
             if axis is not None else 0)
    flat_ids = ids.reshape(R, Tk)
    tok_of = torch.arange(T, dtype=torch.int32, device=dev) \
        .repeat_interleave(k)
    mine = (flat_ids // E_loc) == shard
    out = _expert_gemm(cfg, p, x_flat[:, tok_of.long()], flat_ids % E_loc,
                       mine, mesh=mesh, use_kernel=use_kernel)
    w = torch.where(mine, gates.reshape(R, Tk), 0.0)
    y = (out * w[..., None].to(out.dtype)).view(R, T, k, D).sum(2)
    if axis is None:
        return y
    axes = (axis,) + ((cfg.expert_tp_axis,) if cfg.expert_tp_axis else ())
    ms = tuple(mesh.shape)
    return coll.mesh_psum(y.view(*ms, T, D), axes, mesh).reshape(R, T, D)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

EXPERT_KEYS = ("we_gate", "we_in", "we_out")


def moe_forward(cfg: ModelConfig, p, x, *, mesh=None, dp_entry=None,
                unroll: bool = False, use_kernel: bool = False):
    """x: (B, S, D). Returns (y, aux_loss): the routed experts through
    ``cfg.dispatch_mode``'s schedule plus the shared experts, and the
    fp32 load-balancing loss. When ``mesh`` is None the layer runs
    unpartitioned; otherwise inside one ``shard_map`` over the mesh, the
    tokens sequence-sharded over "model" and the batch over ``dp_entry``
    (a mesh's data-parallel axes), the experts EP-sharded over "model"
    (and d_ff over ``cfg.expert_tp_axis``). When S does not divide by
    tp (decode: S = 1) the tokens replicate over "model" and the
    replicated dispatch runs instead. The shared experts run outside the
    region, as in the reference. The pipeline's steps are a Python loop
    already, so ``unroll`` changes nothing."""
    B, S, D = x.shape
    tp = mesh.axis_size(EP_AXIS) if mesh is not None else 1
    seq_shardable = S % tp == 0
    et = cfg.expert_tp_axis or None

    def body(x_blk, *expert_leaves):
        p_blk = dict(zip(EXPERT_KEYS, expert_leaves))
        if mesh is not None and not et:
            # EP weights vary along "model" alone: every rank along the
            # other axes holds the same block, so the GEMMs take the
            # global weights' (tp, E_loc, ...) view (``_swiglu``)
            p_blk = {k: p[k].view(tp, -1, *p[k].shape[1:])
                     for k in EXPERT_KEYS}
        ms = tuple(mesh.shape) if mesh is not None else ()
        R = math.prod(ms)
        axis = EP_AXIS if mesh is not None else None
        E_loc = p_blk["we_gate"].shape[-3]
        Bl, Sl = x_blk.shape[-3:-1]
        T_loc = Bl * Sl
        x_flat = x_blk.reshape(R, T_loc, D)
        gathered = mesh is not None and not seq_shardable and et
        if gathered:
            # serve sharding: every shard sees all tokens so the
            # ffe-partial expert outputs can sum across the TP axis
            x_use = coll.mesh_all_gather(x_flat.view(*ms, T_loc, D), et,
                                         mesh, 0).reshape(R, -1, D)
        else:
            x_use = x_flat
        T_use = x_use.shape[1]
        ids, gates, probs = _route(cfg, p["router"], x_use.reshape(-1, D))
        ids = ids.view(R, T_use, -1)
        gates = gates.view(R, T_use, -1)
        # the axes the tokens are sharded over: the dp entry (batch), and
        # the model axis when the sequence is sharded over it
        sum_axes = ()
        if mesh is not None and not gathered:
            dp_axes = (dp_entry if isinstance(dp_entry, tuple)
                       else (dp_entry,) if dp_entry else ())
            sum_axes = tuple(dp_axes) + ((EP_AXIS,) if seq_shardable
                                         else ())
        aux = _aux_loss(cfg, probs.view(*ms, T_use, -1),
                        ids.view(*ms, T_use, -1), sum_axes, mesh)
        if mesh is not None:                    # replicate the scalar
            aux = coll.mesh_pmean(aux, mesh.axis_names, mesh)
        if mesh is not None and not seq_shardable:
            y = _dispatch_replicated(cfg, p_blk, x_use, ids, gates, E_loc,
                                     axis, mesh=mesh, use_kernel=use_kernel)
            if gathered:
                i = coll.mesh_axis_index(mesh, et, x.device).reshape(R)
                y = y.view(R, -1, T_loc, D)[torch.arange(R, device=x.device),
                                            i.long()]
        else:
            fn = _dispatch_1s if cfg.dispatch_mode == "1s" else _dispatch_2s
            y = fn(cfg, p_blk, x_flat, ids, gates, tp, E_loc, axis,
                   mesh=mesh, use_kernel=use_kernel)
        return y.view(*ms, Bl, Sl, D), aux

    if mesh is None:
        y, aux = body(x, *(p[k] for k in EXPERT_KEYS))
    else:
        seq_entry = EP_AXIS if seq_shardable else None
        w_specs = [P(EP_AXIS, None, et), P(EP_AXIS, None, et),
                   P(EP_AXIS, et, None)]
        y, aux = coll.shard_map(
            body, mesh=mesh,
            in_specs=(P(dp_entry, seq_entry, None), *w_specs),
            out_specs=(P(dp_entry, seq_entry, None), P()),
        )(x, *(p[k] for k in EXPERT_KEYS))

    # shared experts (dense, TP-sharded like a normal MLP)
    if cfg.n_shared_experts:
        g = F.silu(x @ p["ws_gate"])
        h = x @ p["ws_in"]
        y = y + (g * h) @ p["ws_out"]
    return y, aux
