"""Attention: GQA / MHA / sliding-window / MLA, with the prefill and
decode paths (counterpart of ``repro/models/attention.py``).

Layout contracts, as in the reference:
  activations      (B, S, D)
  q/k/v            (B, S, H|KV, hd)
  GQA cache        {"k","v"}: (B, S_max, KV, hd)
  SWA cache        ring buffer, S_max = window
  MLA cache        {"ckv"}: (B, S_max, lora + rope)

Prefill attention goes through the flash_attention kernel's wrapper
(``use_kernel=True``: the kernel on the card, its plain version on the
CPU) or through the chunked ``flash_attention_ref``. MLA's prefill
always takes ``flash_attention_ref``, as the reference's does (its qk
head dim, 192 at deepseek-v2-lite, is not one the kernel takes). Decode
is the reference's flash-decode: online-softmax partials over a cache
slice, combined with a max-stabilised sum. Unsharded the slice is the
whole cache; under a mesh (``mesh=``) the GQA and MLA caches are
sequence-sharded over "model", each shard's partials cover its slice
of the positions and ``combine_partials`` joins them across the axis
(``collectives.shard_map``, the mesh's ranks as leading dims); the SWA
ring stays replicated. MLA decodes absorbed over its compressed cache.

``unroll=True`` routes prefill attention, where the kernel does not take
it, through ``flash_attention_costexact``: the dry run's cost instrument,
a loop over q chunks that touches only the kv slab each chunk can see,
so an eager run's counted FLOPs are the ones the tile-skipping kernel
does, at chunk granularity.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import P
from repro_torch.models.layers import (DTYPES, _init, apply_rope, matmul,
                                       rms_over)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   cross: bool = False) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = DTYPES[cfg.param_dtype]
    dev = gen.device
    s = d ** -0.5
    p = {
        "wq": _init(gen, (d, H * hd), s, dt),
        "wk": _init(gen, (d, KV * hd), s, dt),
        "wv": _init(gen, (d, KV * hd), s, dt),
        "wo": _init(gen, (H * hd, d), (H * hd) ** -0.5, dt),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((H * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((KV * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((KV * hd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    return p


def init_mla(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    nope, rope_d, v_d = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lora = cfg.kv_lora_rank
    dt = DTYPES[cfg.param_dtype]
    s = d ** -0.5
    return {
        "wq": _init(gen, (d, H * (nope + rope_d)), s, dt),
        "w_kv_a": _init(gen, (d, lora + rope_d), s, dt),
        "w_kv_b": _init(gen, (lora, H * (nope + v_d)), lora ** -0.5, dt),
        "wo": _init(gen, (H * v_d, d), (H * v_d) ** -0.5, dt),
        "kv_norm": torch.ones((lora,), dtype=dt, device=gen.device),
    }


# ---------------------------------------------------------------------------
# chunked reference attention
# ---------------------------------------------------------------------------

def _einsum_f32(eq: str, a, b):
    """einsum with fp32 products and sums, as the reference's
    ``preferred_element_type=jnp.float32`` (a product of two bf16 values
    is exact in fp32)."""
    return torch.einsum(eq, a.float(), b.float())


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 512,
                        q_offset: int = 0):
    """Online-softmax chunked attention, with the reference's casts:
    ``q * scale`` goes back to q's dtype and p to v's dtype before the
    PV product.

    q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) with H % KV == 0.
    ``window > 0``: sliding-window (banded), only the KV band each q
    chunk can see is touched. ``q_offset``: absolute position of q[0].
    Returns (B, Sq, H, hd).
    """
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    nq = math.ceil(Sq / q_chunk)
    scale = hd ** -0.5

    # pad both sequence axes to chunk multiples; padded kv is masked via
    # ``kv_pos < Skv``, padded q rows are sliced off at the end
    Sq_pad = nq * q_chunk
    Skv_pad = math.ceil(Skv / kv_chunk) * kv_chunk
    pad_q, pad_kv = (0, 0, 0, 0, 0, Sq_pad - Sq), (0, 0, 0, 0, 0, Skv_pad - Skv)
    q = torch.nn.functional.pad(q, pad_q)
    k = torch.nn.functional.pad(k, pad_kv)
    v = torch.nn.functional.pad(v, pad_kv)
    qg = q.reshape(B, Sq_pad, KV, G, hd)

    if window > 0:
        band = int(min(Skv_pad,
                       (math.ceil((window + q_chunk) / kv_chunk) + 1)
                       * kv_chunk))
    else:
        band = Skv_pad
    nkv = band // kv_chunk
    dev = q.device

    outs = []
    for i in range(nq):
        q_i = (qg[:, i * q_chunk:(i + 1) * q_chunk] * scale).to(q.dtype)
        q_pos = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        if window > 0:
            start = min(max(q_offset + (i + 1) * q_chunk - band, 0),
                        Skv_pad - band)
        else:
            start = 0
        m = torch.full((B, KV, G, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, q_chunk), device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, hd), device=dev)
        for j in range(nkv):
            lo = start + j * kv_chunk
            k_j, v_j = k[:, lo:lo + kv_chunk], v[:, lo:lo + kv_chunk]
            kv_pos = lo + torch.arange(kv_chunk, device=dev)
            s = _einsum_f32("bqkgh,bckh->bkgqc", q_i, k_j)
            mask = (kv_pos[None, :] < Skv).expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])
            if window > 0:
                mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            # rows fully masked so far have m_new == NEG_INF and would get
            # p = exp(0) = 1 on masked entries: zero them explicitly
            p = p.masked_fill(~mask, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _einsum_f32(
                "bkgqc,bckh->bkgqh", p.to(v.dtype), v_j)
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]
        # (B, KV, G, q_chunk, hd) -> (B, q_chunk, H, hd)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, hd)
                    .to(q.dtype))
    return torch.cat(outs, 1)[:, :Sq]


def flash_attention_costexact(q, k, v, *, causal: bool = True,
                              window: int = 0, n_q_chunks: int = 8,
                              q_offset: int = 0):
    """Unrolled, tile-skipping attention: the dry run's cost instrument.

    A Python loop over q chunks of ``c = max(128, ceil(Sq / n_q_chunks))``
    rows; each attends to the kv slab it can see (the causal triangle up
    to its last row, the SWA band from its first row's window), with a
    plain softmax in fp32. Same shapes and casts as
    ``flash_attention_ref``; returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    c = max(128, -(-Sq // n_q_chunks))
    nq = -(-Sq // c)
    scale = hd ** -0.5
    qg = q.reshape(B, Sq, KV, G, hd)
    dev = q.device
    outs = []
    for i in range(nq):
        lo_q = i * c
        hi_q = min(Sq, lo_q + c)
        cq = hi_q - lo_q
        q_i = (qg[:, lo_q:hi_q] * scale).to(q.dtype)
        hi_kv = min(Skv, q_offset + hi_q) if causal else Skv
        lo_kv = max(0, q_offset + lo_q - window + 1) if window > 0 else 0
        s = _einsum_f32("bqkgh,bckh->bkgqc", q_i, k[:, lo_kv:hi_kv])
        q_pos = q_offset + lo_q + torch.arange(cq, device=dev)
        kv_pos = lo_kv + torch.arange(hi_kv - lo_kv, device=dev)
        mask = torch.ones((cq, hi_kv - lo_kv), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        p = torch.softmax(s.masked_fill(~mask, NEG_INF), -1)
        o = _einsum_f32("bkgqc,bckh->bkgqh", p.to(v.dtype),
                        v[:, lo_kv:hi_kv])
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, cq, H, hd)
                    .to(q.dtype))
    return torch.cat(outs, 1)


def attention_dense_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """O(S^2)-memory oracle for tests."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bckh->bkgqc", qg, k).float()
    s = s * hd ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[None] <= q_pos[:, None]
    if window > 0:
        mask &= kv_pos[None] > q_pos[:, None] - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, -1)
    o = torch.einsum("bkgqc,bckh->bkgqh", p.to(v.dtype), v)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


# ---------------------------------------------------------------------------
# flash-decode core
# ---------------------------------------------------------------------------

def _decode_partials(q, k, v, kv_pos, t):
    """Online softmax over a cache slice.

    q: (..., B, H, hd); k/v: (..., B, S_loc, KV, hd) (the leading dims a
    mesh's ranks, or none); kv_pos: (S_loc,) absolute positions, or
    (..., 1, S_loc) a rank's own; t: current length (positions >= t are
    invalid). Returns (o_partial, l, m) for max-stabilized combining.
    """
    H, hd = q.shape[-2:]
    KV = k.shape[-2]
    G = H // KV
    qg = q.reshape(*q.shape[:-2], KV, G, hd) * hd ** -0.5
    s = _einsum_f32("...kgh,...skh->...kgs", qg, k)
    valid = ((kv_pos >= 0) & (kv_pos < t))[..., None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]).masked_fill(~valid, 0.0)
    l = p.sum(-1)
    o = _einsum_f32("...kgs,...skh->...kgh", p.to(v.dtype), v)
    return o, l, m


def combine_partials(o, l, m, axis: str | None, mesh=None):
    """Combine (o, l, m) partials across ``axis`` of ``mesh`` (None: a
    single shard): the global max, then the sums of ``l`` and ``o``
    rescaled to it."""
    if axis is None:
        return o / l.clamp_min(1e-30)[..., None]
    m_glob = coll.mesh_pmax(m, axis, mesh)
    corr = torch.exp(m - m_glob)
    l_glob = coll.mesh_psum(l * corr, axis, mesh)
    o_glob = coll.mesh_psum(o * corr[..., None], axis, mesh)
    return o_glob / l_glob.clamp_min(1e-30)[..., None]


def _shard_positions(mesh, seq_axis: str, S_loc: int, device):
    """Each rank's absolute cache positions (*mesh.shape, 1, S_loc) of a
    cache sequence-sharded over ``seq_axis``: ``idx * S_loc +
    arange(S_loc)``."""
    idx = coll.mesh_axis_index(mesh, seq_axis, device)
    return (idx[..., None] * S_loc + torch.arange(S_loc, device=device)
            ).unsqueeze(-2)


def _seq_sharded(cache, mesh, dp_entry, seq_axis: str):
    """A cache's blocks (*mesh.shape, B_loc, S_loc, ...), a view of it,
    sequence-sharded over ``seq_axis``; its length must divide by the
    axis' size."""
    tp = mesh.axis_size(seq_axis)
    if cache.shape[1] % tp:
        raise ValueError(f"a cache of {cache.shape[1]} positions does not "
                         f"divide over the {tp} shards of {seq_axis!r}: a "
                         f"sequence-sharded cache's length must divide by "
                         f"tp")
    return coll.block(cache, P(dp_entry, seq_axis), mesh, view=True)


def update_cache_sharded(cache, new, t: int, *, mesh, dp_entry,
                         seq_axis: str = "model"):
    """Write one token's entry ``new`` (B, ...) at absolute position t
    into a seq-sharded cache (B, S_max, ...), in place, and return it:
    only the owning shard writes (local position ``t - idx * S_loc`` in
    range), so past the cache's end (t >= S_max) no shard does."""
    c = _seq_sharded(cache, mesh, dp_entry, seq_axis)
    n = coll.block(new, P(dp_entry), mesh)
    d = mesh.axis_names.index(seq_axis)
    nm = len(mesh.shape)
    S_loc = c.shape[nm + 1]
    for idx in range(mesh.axis_size(seq_axis)):
        local = t - idx * S_loc
        if 0 <= local < S_loc:
            c.select(d, idx).select(nm, local).copy_(n.select(d, idx))
    return cache


def decode_attention_sharded(q, cache_k, cache_v, t: int, *, mesh,
                             dp_entry, seq_axis: str = "model"):
    """Flash-decode with the cache sequence-sharded over ``seq_axis``.

    q: (B, H, hd) replicated over the axis; cache: (B, S_max, KV, hd)
    sharded P(dp, seq_axis); t: the current length. The new k/v must
    already be written (``update_cache_sharded``)."""
    B, H, hd = q.shape

    def inner(q_b, k_b, v_b):
        S_loc = k_b.shape[len(mesh.shape) + 1]
        kv_pos = _shard_positions(mesh, seq_axis, S_loc, q.device)
        o, l, m = _decode_partials(q_b, k_b, v_b, kv_pos, t)
        o = combine_partials(o, l, m, seq_axis, mesh)
        return o.reshape(*o.shape[:-3], H, hd).to(q.dtype)

    return coll.shard_map(
        inner, mesh=mesh,
        in_specs=(P(dp_entry, None, None),
                  P(dp_entry, seq_axis, None, None),
                  P(dp_entry, seq_axis, None, None)),
        out_specs=P(dp_entry, None, None),
    )(q, cache_k, cache_v)


# ---------------------------------------------------------------------------
# full attention layer (projections + modes)
# ---------------------------------------------------------------------------

def _qkv(cfg: ModelConfig, p, x, kv_x=None):
    """q from ``x``, k and v from ``kv_x`` (``x`` unless given: the
    encoder output of a cross-attention), each in the dtype JAX's
    promotion gives (fp32 where an fp32 activation meets bf16 weights)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kv_x = x if kv_x is None else kv_x
    Skv = kv_x.shape[1]
    q = matmul(x, p["wq"])
    k = matmul(kv_x, p["wk"])
    v = matmul(kv_x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, Skv, KV, hd)
    v = v.reshape(B, Skv, KV, hd)
    if "q_norm" in p:
        q = rms_over(q, p["q_norm"])
        k = rms_over(k, p["k_norm"])
    return q, k, v


def attention_forward(cfg: ModelConfig, p, x, positions, *, causal=True,
                      use_kernel=False, unroll=False):
    """Train / prefill pass. Returns (out, (k, v)); k/v feed the cache.
    ``use_kernel=True`` routes through the flash_attention kernel's
    wrapper; otherwise ``unroll=True`` through
    ``flash_attention_costexact`` and ``False`` through
    ``flash_attention_ref``, as the reference routes them."""
    q, k, v = _qkv(cfg, p, x)
    q = _rope_bshd(q, positions, cfg.rope_theta)
    k = _rope_bshd(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if cfg.attn_type == "swa" else 0
    if use_kernel:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        o = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    elif unroll:
        o = flash_attention_costexact(q, k, v, causal=causal, window=window)
    else:
        o = flash_attention_ref(q, k, v, causal=causal, window=window)
    B, S, H, hd = q.shape
    return matmul(o.reshape(B, S, H * hd), p["wo"]), (k, v)


def _rope_bshd(x, positions, theta):
    """RoPE on (B, S, N, hd) with positions (B, S). The rotation is
    elementwise, so it runs on the layout as it is and returns it
    contiguous."""
    return apply_rope(x, positions[:, :, None], theta)


def attention_decode(cfg: ModelConfig, p, x, cache: dict, t: int, *,
                     mesh=None, dp_entry=None):
    """One-token decode. x: (B, 1, D); cache {"k","v"}: (B, S_max, KV, hd)
    or the SWA ring (B, W, KV, hd); t: the new token's position.

    Unlike the reference, which returns new arrays, the new k/v are
    written into ``cache`` in place (it is returned as the new cache):
    copying a full-width cache on every token would cost more than the
    step. Under ``mesh`` a GQA cache is sequence-sharded over "model"
    (``update_cache_sharded``, ``decode_attention_sharded``): past its
    end no shard writes, where the unsharded cache overwrites its last
    slot, as the reference's two paths do. The SWA ring stays
    replicated.
    """
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.d_head
    q, k, v = _qkv(cfg, p, x)
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q = _rope_bshd(q, pos, cfg.rope_theta)
    k = _rope_bshd(k, pos, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    if cfg.attn_type == "swa":
        # ring-buffer cache of size window
        W = ck.shape[1]
        slot = t % W
        ck[:, slot:slot + 1] = k
        cv[:, slot:slot + 1] = v
        kv_pos = t - ((slot - torch.arange(W, device=x.device)) % W)
    elif mesh is not None:
        update_cache_sharded(ck, k[:, 0], t, mesh=mesh, dp_entry=dp_entry)
        update_cache_sharded(cv, v[:, 0], t, mesh=mesh, dp_entry=dp_entry)
        o = decode_attention_sharded(q[:, 0], ck, cv, t + 1, mesh=mesh,
                                     dp_entry=dp_entry)
        return o.reshape(B, 1, H * hd).to(x.dtype) @ p["wo"], cache
    else:
        # past the cache's end the reference's dynamic_update_slice clamps
        # the start and overwrites the last slot; so does the port
        slot = min(t, ck.shape[1] - 1)
        ck[:, slot:slot + 1] = k
        cv[:, slot:slot + 1] = v
        kv_pos = torch.arange(ck.shape[1], device=x.device)
    o, l, m = _decode_partials(q[:, 0], ck, cv, kv_pos, t + 1)
    o = combine_partials(o, l, m, None)
    o = o.reshape(B, 1, H * hd).to(x.dtype)
    return o @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek): prefill materialises k/v; decode runs absorbed over the
# compressed cache
# ---------------------------------------------------------------------------

def _mla_expand(cfg: ModelConfig, p, ckv):
    """ckv: (B, S, lora) -> k_nope, v: (B, S, H, nope|v)."""
    B, S, _ = ckv.shape
    H, nope, v_d = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    kv = (ckv @ p["w_kv_b"]).reshape(B, S, H, nope + v_d)
    return kv[..., :nope], kv[..., nope:]


def mla_forward(cfg: ModelConfig, p, x, positions, *, unroll=False):
    """Train / prefill pass. Returns (out, {"ckv": (B, S, lora + rope)}):
    the normed latent and the rotated shared key, which the decode cache
    holds. Attention runs through ``flash_attention_ref`` with v padded to
    the qk head dim, as the reference's does (``flash_attention_costexact``
    under ``unroll``)."""
    B, S, _ = x.shape
    H, lora = cfg.n_heads, cfg.kv_lora_rank
    nope, rope_d, v_d = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, nope + rope_d)
    q_rope = _rope_bshd(q[..., nope:], positions, cfg.rope_theta)
    a = x @ p["w_kv_a"]                                 # (B, S, lora+rope)
    ckv = rms_over(a[..., :lora], p["kv_norm"])
    k_rope = _rope_bshd(a[..., None, lora:], positions,
                        cfg.rope_theta)                 # (B, S, 1, rope)
    k_nope, v = _mla_expand(cfg, p, ckv)
    q_full = torch.cat([q[..., :nope], q_rope], -1)
    k_full = torch.cat([k_nope, k_rope.expand(B, S, H, rope_d)], -1)
    v_pad = torch.nn.functional.pad(v, (0, nope + rope_d - v_d))
    fa = flash_attention_costexact if unroll else flash_attention_ref
    o = fa(q_full, k_full, v_pad, causal=True)[..., :v_d]
    cache = {"ckv": torch.cat([ckv, k_rope[:, :, 0]], -1)}
    return o.reshape(B, S, H * v_d) @ p["wo"], cache


def mla_decode(cfg: ModelConfig, p, x, cache: dict, t: int, *, mesh=None,
               dp_entry=None):
    """Absorbed one-token decode over the compressed cache {"ckv": (B,
    S_max, lora + rope)}: ``w_kv_b``'s key half is folded into q and its
    value half into the output. The new entry is written into ``cache``
    in place, as ``attention_decode`` writes k/v; past the cache's end it
    is not written, as the reference's masked update leaves it. Under
    ``mesh`` the cache is sequence-sharded over "model": the owning shard
    writes the entry, each shard's partials cover its slice and
    ``combine_partials`` joins them."""
    B = x.shape[0]
    H, lora = cfg.n_heads, cfg.kv_lora_rank
    nope, rope_d, v_d = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q = (x @ p["wq"]).reshape(B, 1, H, nope + rope_d)
    q_rope = _rope_bshd(q[..., nope:], pos, cfg.rope_theta)[:, 0]
    a = (x @ p["w_kv_a"])[:, 0]                         # (B, lora+rope)
    ckv_new = rms_over(a[..., :lora], p["kv_norm"])
    kr_new = apply_rope(a[:, None, lora:], pos, cfg.rope_theta)[:, 0]
    entry = torch.cat([ckv_new, kr_new], -1)            # (B, lora+rope)

    w_b = p["w_kv_b"].reshape(lora, H, nope + v_d)
    q_lora = torch.einsum("bhn,lhn->bhl", q[:, 0, :, :nope],
                          w_b[..., :nope])               # (B, H, lora)
    qq = torch.cat([q_lora, q_rope], -1)                # (B, H, lora+rope)

    def partials(qq_b, c_b, kv_pos):
        s = _einsum_f32("...hl,...sl->...hs", qq_b, c_b) \
            * (nope + rope_d) ** -0.5
        valid = (kv_pos < t + 1)[..., None, :]
        s = s.masked_fill(~valid, NEG_INF)
        m = s.amax(-1)
        pr = torch.exp(s - m[..., None]).masked_fill(~valid, 0.0)
        o_l = _einsum_f32("...hs,...sl->...hl", pr.to(c_b.dtype),
                          c_b[..., :lora])
        return o_l, pr.sum(-1), m

    c = cache["ckv"]
    if mesh is not None:
        update_cache_sharded(c, entry, t, mesh=mesh, dp_entry=dp_entry)

        def inner(qq_b, c_b):
            S_loc = c_b.shape[len(mesh.shape) + 1]
            o_l, l, m = partials(qq_b, c_b, _shard_positions(
                mesh, "model", S_loc, x.device))
            return combine_partials(o_l, l, m, "model", mesh).to(x.dtype)

        o_l = coll.shard_map(
            inner, mesh=mesh,
            in_specs=(P(dp_entry, None, None), P(dp_entry, "model", None)),
            out_specs=P(dp_entry, None, None))(qq, c)
    else:
        if t < c.shape[1]:
            c[:, t] = entry
        o_l, l, m = partials(qq, c, torch.arange(c.shape[1],
                                                 device=x.device))
        o_l = combine_partials(o_l, l, m, None).to(x.dtype)
    # un-absorb the value half, in fp32 as the reference does
    o = torch.einsum("bhl,lhv->bhv", o_l.float(), w_b[..., nope:].float())
    return o.reshape(B, 1, H * v_d).to(x.dtype) @ p["wo"], cache
