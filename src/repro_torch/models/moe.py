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

Only the unpartitioned layer is ported (``mesh=None``): the push
(``_a2a``) is the identity, and the decode-time replicated dispatch and
the sharded layer raise (ROADMAP Queue 1 item 12).

Both slotting steps of a dispatch, each record's slot in its peer bucket
(``_bucket_indices``) and in its local expert's buffer (``_expert_gemm``),
are ``bucket_slots``: ``slot[t] = #{t' < t : id[t'] == id[t]}``, which
the reference computes with a stable argsort and a searchsorted. With
``use_kernel=True`` they go through the kernel's wrapper (the
hand-written kernel on a CUDA tensor, its plain version on a CPU one),
with ``use_kernel=False`` through the plain version.

Where the reference scatter-adds rows back (an expert's results to
their records, the weighted results to their tokens), the port gathers
each record's row through the inverse of its slot index: the same
function, with no atomics on the card, so both paths give the same bits
there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.moe_dispatch import ops as slot_ops
from repro_torch.kernels.moe_dispatch.ref import bucket_slots_ref
from repro_torch.models.attention import _unported
from repro_torch.models.layers import DTYPES, _init


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


def _aux_loss(cfg: ModelConfig, probs, ids):
    """Switch-style load-balancing loss of the unsharded tokens (the
    reference's ``sum_axes=()``)."""
    E = cfg.n_experts
    T = probs.shape[0]
    counts = torch.zeros((E,), dtype=torch.float32, device=probs.device) \
        .index_add_(0, ids.reshape(-1).long(),
                    torch.ones((ids.numel(),), dtype=torch.float32,
                               device=probs.device))
    frac_tokens = counts / max(T * cfg.top_k, 1)
    frac_probs = probs.float().sum(0) / max(T, 1)
    return E * (frac_tokens * frac_probs).sum()


def _bucket_indices(shard_ids, valid, tp: int, cap: int, *,
                    use_kernel: bool = False):
    """Slot each record into (tp, cap) peer buckets (sender side).

    Returns flat gather indices (tp * cap,) into the record axis, -1 =
    empty. Overflow records are dropped (capacity-factor semantics: a
    dropped token keeps its residual value). Record t sits at ``id[t] *
    cap + slot[t]`` where ``slot`` is bucket_slots' (the kernel's wrapper
    with ``use_kernel=True``, else its plain version) over the ids, -1
    for an invalid record."""
    ids = torch.where(valid, shard_ids, -1).to(torch.int32)
    if use_kernel:
        slots, _ = slot_ops.bucket_slots(ids, tp)
    else:
        slots, _ = bucket_slots_ref(ids, tp)
    keep = (slots >= 0) & (slots < cap)
    flat = torch.where(keep, ids * cap + slots, tp * cap).long()
    rec = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    idx = torch.full((tp * cap + 1,), -1, dtype=torch.int32,
                     device=ids.device)
    idx[flat] = torch.where(keep, rec, -1)
    return idx[:-1]


def _record_slots(idx, n_records: int):
    """The inverse of a slot index ``idx`` (slot -> record, -1 empty):
    each of ``n_records`` records' slot, -1 for a record that holds none
    (dropped at capacity, or invalid)."""
    pos = torch.full((n_records + 1,), -1, dtype=torch.int32,
                     device=idx.device)
    slot = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    pos[torch.where(idx >= 0, idx, n_records).long()] = slot
    return pos[:-1]


def _gather_records(x, idx):
    """x: (T, D); idx: (M,) with -1 invalid -> (M, D), zeros where
    invalid."""
    out = x[idx.clamp(0, x.shape[0] - 1).long()]
    return torch.where((idx >= 0)[:, None], out, torch.zeros_like(out))


def _expert_gemm(cfg: ModelConfig, p, toks, eids, valid, *,
                 use_kernel: bool = False):
    """toks: (M, D) received records; eids: (M,) local expert ids.

    Groups records into per-local-expert capacity buffers (the same
    slotting as ``_bucket_indices``, over E_loc buffers of cap_e), runs
    the SwiGLU expert GEMMs batched over E_loc, and returns each record's
    result (zeros for a record dropped or invalid). The reference
    scatter-adds the slots' rows back into zeros; a kept record holds one
    slot, so the port gathers its row instead: the same values, with no
    atomics on the card, and the empty slots' zero rows are never
    summed."""
    M, D = toks.shape
    E_loc = p["we_gate"].shape[0]
    cap_e = -(-M // E_loc)            # ceil; all records on one expert is
    cap_e = min(M, int(cap_e * 4))    # the worst case: 4x headroom
    slot_of_record = _bucket_indices(eids, valid, E_loc, cap_e,
                                     use_kernel=use_kernel)
    grouped = _gather_records(toks, slot_of_record).reshape(E_loc, cap_e, D)
    g = F.silu(torch.bmm(grouped, p["we_gate"]))
    h = torch.bmm(grouped, p["we_in"])
    out = torch.bmm(g * h, p["we_out"]).reshape(E_loc * cap_e, D)
    return _gather_records(out, _record_slots(slot_of_record, M))


# ---------------------------------------------------------------------------
# dispatch schedules
# ---------------------------------------------------------------------------

def _a2a(x, axis):
    """all_to_all, the identity when unpartitioned (``axis`` None)."""
    if axis is not None:
        raise _unported("the expert-parallel all_to_all (mesh=...)")
    return x


def _combine(back, idx, gates, k: int):
    """A group's output (T, D) from its returned bucket rows ``back``:
    token t's k records (record t * k + j is its j-th choice; ``idx`` maps
    bucket slots to records) weighted by their gates, cast to the model
    dtype first, and summed. The reference scatter-adds the weighted rows
    into y; the port gathers each record's row and sums a token's k
    rows, which is deterministic on the card (no atomics) and sums in
    fp32 before one rounding. A dropped record adds nothing."""
    Tk = gates.shape[0]
    pos = _record_slots(idx, Tk)
    w = torch.where(pos >= 0, gates, 0.0)
    rows = _gather_records(back, pos) * w[:, None].to(back.dtype)
    return rows.reshape(Tk // k, k, -1).sum(1)


def _dispatch_2s(cfg: ModelConfig, p, x_flat, ids, gates, tp: int,
                 E_loc: int, axis, *, use_kernel: bool = False):
    """Bulk-synchronous EP dispatch (baseline)."""
    T, D = x_flat.shape
    k = cfg.top_k
    Tk = T * k
    cap = int(cfg.capacity_factor * Tk / tp) + 1
    dev = x_flat.device
    flat_ids = ids.reshape(-1)
    flat_gates = gates.reshape(-1)
    tok_of = torch.arange(T, dtype=torch.int32, device=dev) \
        .repeat_interleave(k)
    idx = _bucket_indices(flat_ids // E_loc,
                          torch.ones((Tk,), dtype=torch.bool, device=dev),
                          tp, cap, use_kernel=use_kernel)
    rec = idx.clamp(0, Tk - 1).long()
    send_tok = _gather_records(x_flat, torch.where(idx >= 0, tok_of[rec], -1))
    send_eloc = torch.where(idx >= 0, flat_ids[rec] % E_loc, -1)
    recv_tok = _a2a(send_tok.reshape(tp, cap, D), axis)
    recv_eloc = _a2a(send_eloc.reshape(tp, cap), axis).reshape(-1)
    out = _expert_gemm(cfg, p, recv_tok.reshape(-1, D), recv_eloc,
                       recv_eloc >= 0, use_kernel=use_kernel)
    back = _a2a(out.reshape(tp, cap, D), axis).reshape(tp * cap, D)
    # weighted combine into token outputs
    return _combine(back, idx, flat_gates, k)


def _dispatch_1s(cfg: ModelConfig, p, x_flat, ids, gates, tp: int,
                 E_loc: int, axis, *, use_kernel: bool = False):
    """Decoupled pipelined dispatch: the paper's technique, as the
    reference's scan of G + 1 steps in a Python loop.

    step g:   push buckets(g)
              GEMM recv(g-1)            [overlaps the push]
              push-back out(g-1)
              combine back(g-1) into y
    Step G pushes the last group again (the reference's scan needs a
    uniform body) and drains group G-1; step 0 runs the GEMM on the empty
    carry, as the reference's does, and combines nothing.
    """
    T, D = x_flat.shape
    k = cfg.top_k
    G = max(1, min(cfg.dispatch_groups, T))
    assert T % G == 0, (T, G)
    Tg = T // G
    Tkg = Tg * k
    cap = int(cfg.capacity_factor * Tkg / tp) + 1
    dev, dt = x_flat.device, x_flat.dtype
    tok_of = torch.arange(Tg, dtype=torch.int32, device=dev) \
        .repeat_interleave(k)
    all_valid = torch.ones((Tkg,), dtype=torch.bool, device=dev)

    def bucket_group(g):
        x_g = x_flat[g * Tg:(g + 1) * Tg]
        ids_g = ids[g * Tg:(g + 1) * Tg].reshape(-1)
        gates_g = gates[g * Tg:(g + 1) * Tg].reshape(-1)
        idx = _bucket_indices(ids_g // E_loc, all_valid, tp, cap,
                              use_kernel=use_kernel)
        rec = idx.clamp(0, Tkg - 1).long()
        send_tok = _gather_records(x_g, torch.where(idx >= 0, tok_of[rec],
                                                    -1))
        send_eloc = torch.where(idx >= 0, ids_g[rec] % E_loc, -1)
        return (send_tok.reshape(tp, cap, D), send_eloc.reshape(tp, cap),
                idx, gates_g)

    ys = []
    recv_tok = torch.zeros((tp, cap, D), dtype=dt, device=dev)
    recv_eloc = torch.full((tp, cap), -1, dtype=torch.int32, device=dev)
    idx_p = torch.full((tp * cap,), -1, dtype=torch.int32, device=dev)
    gates_p = torch.zeros((Tkg,), dtype=torch.float32, device=dev)
    for g in range(G + 1):
        # (1) push group g's buckets
        send_tok, send_eloc, idx, gates_g = bucket_group(min(g, G - 1))
        r_tok, r_eloc = _a2a(send_tok, axis), _a2a(send_eloc, axis)
        # (2) expert GEMM of the previous group's received records
        eloc = recv_eloc.reshape(-1)
        out = _expert_gemm(cfg, p, recv_tok.reshape(-1, D), eloc, eloc >= 0,
                           use_kernel=use_kernel)
        # (3) return push
        back = _a2a(out.reshape(tp, cap, D), axis).reshape(tp * cap, D)
        # (4) weighted combine into the previous group's slice of y
        if g > 0:
            ys.append(_combine(back, idx_p, gates_p, k))
        recv_tok, recv_eloc, idx_p, gates_p = r_tok, r_eloc, idx, gates_g
    return torch.cat(ys)


def _dispatch_replicated(cfg: ModelConfig, p, x_flat, ids, gates,
                         E_loc: int, axis):
    """Decode-time EP with tokens replicated over the model axis: it runs
    only under a mesh."""
    raise _unported("the replicated decode-time dispatch "
                    "(_dispatch_replicated, mesh=...)")


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def moe_forward(cfg: ModelConfig, p, x, *, mesh=None, dp_entry=None,
                unroll: bool = False, use_kernel: bool = False):
    """x: (B, S, D). Returns (y, aux_loss): the routed experts through
    ``cfg.dispatch_mode``'s schedule plus the shared experts, and the
    fp32 load-balancing loss. Unpartitioned only: ``mesh`` and
    ``dp_entry`` (the data-parallel axes of a mesh) raise, and so does
    ``unroll``, as it does in ``transformer.forward``."""
    if mesh is not None or dp_entry is not None:
        raise _unported("the sharded MoE layer (mesh=..., dp_entry=...)")
    if unroll:
        raise _unported("unroll=True")
    B, S, D = x.shape
    x_flat = x.reshape(-1, D)
    E_loc = p["we_gate"].shape[0]
    ids, gates, probs = _route(cfg, p["router"], x_flat)
    aux = _aux_loss(cfg, probs, ids)
    fn = _dispatch_1s if cfg.dispatch_mode == "1s" else _dispatch_2s
    y = fn(cfg, p, x_flat, ids, gates, 1, E_loc, None,
           use_kernel=use_kernel).reshape(B, S, D)
    if cfg.n_shared_experts:
        g = F.silu(x @ p["ws_gate"])
        h = x @ p["ws_in"]
        y = y + (g * h) @ p["ws_out"]
    return y, aux
