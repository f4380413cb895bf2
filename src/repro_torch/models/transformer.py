"""The model stack of every family of the reference (counterpart of
``repro/models/transformer.py``).

A model is ``n_layers`` layers between a token embedding and a final
norm with an (optionally tied) head: attention plus SwiGLU MLP in a
dense stack, one Mamba-2 SSD mixer (``models/ssm.py``) and no MLP in an
``ssm`` stack, attention (GQA or MLA) plus an MoE layer
(``models/moe.py``) in a ``moe`` stack, whose ``first_k_dense`` leading
layers carry an MLP instead. A ``hybrid`` stack (jamba) mixes them: an
attention layer every ``attn_every`` layers at ``attn_offset``, an SSD
mixer elsewhere, each followed by an MLP, or by an MoE layer on the
layers ``is_moe_layer`` names. Whisper (``n_enc_layers``) adds a
bidirectional encoder stack and a cross-attention in every decoder
layer; the VLM and audio frontends are stubs,
``batch["frontend_embeds"]`` carrying precomputed patch or frame
embeddings (an early-fused prefix for VLM, the encoder's input for
audio). The reference keeps the leading dense layers apart and scans
super-blocks of ``block_pattern`` layers over a stacked parameter tree;
here the layers are one ``nn.ModuleList``, one
``ModuleDict`` per layer under the reference's leaf names (layer i is
``blocks[i]``, leading dense layers included; encoder layer i is
``enc_blocks[i]``), and the scans are Python loops.

Entry points, as in the reference:
  ``loss_fn``      train forward + CE (``remat`` per layer)
  ``forward``      full-sequence forward (+ raw per-layer caches)
  ``prefill``      last-position logits of ``forward``
  ``decode_step``  one token against the decode caches

``prefill`` and ``decode_step`` run under ``torch.no_grad``: serving
builds no autograd graph, even on a model that a train state made
trainable (``train.train_step.init_train_state``).

``use_kernel=True`` routes prefill attention through the
flash_attention kernel, the SSD scan through ssd_scan and the MoE
layers' slotting through bucket_slots (each the kernel on a CUDA tensor,
its plain version on a CPU one); ``decode_step``'s ``use_kernel``
does the same for its MoE layers' slotting. ``slot_kernel`` of
``forward`` and ``loss_fn`` sends the slotting alone through
bucket_slots (the train step's choice: its slots are integers and need
no backward, while the attention and SSD kernels have none). The
encoder's attention takes the flash_attention kernel too (in fp32, the
frames' dtype); the decoder's cross-attention takes the chunked
``flash_attention_ref`` at prefill, as the reference's does, and the
flash-decode partials over every encoder position at decode.

``mesh`` and ``dp_entry`` run the stack as the reference's does on a
(data, model) mesh (``distributed/mesh.py``, ranks virtual on the one
device): the MoE layers' dispatch and the decode caches' flash-decode
run in ``shard_map`` regions (tokens sequence-sharded and experts
EP-sharded over "model"; GQA and MLA caches sequence-sharded over it),
and everything else computes the unpartitioned function, as GSPMD
does. Whisper's cross-attention stays unsharded, as in the reference.
``unroll=True`` sends prefill attention (the decoder's, MLA's, the
encoder's and the cross-attention) through the cost-exact
``attention.flash_attention_costexact`` where the reference does; the
layer loops are Python loops already, so it changes nothing else.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm,
                                       cross_entropy, dtype_of, embed_tokens,
                                       generator, init_embed, init_mlp,
                                       init_norm, matmul, unembed)


# ---------------------------------------------------------------------------
# layer typing — which sublayers layer i carries
# ---------------------------------------------------------------------------

def layer_kind(cfg: ModelConfig, i: int) -> tuple[str, str]:
    """(mixer, ff) for absolute layer index i.

    mixer: "attn" | "mla" | "ssm";  ff: "mlp" | "moe" | "none"
    """
    if cfg.family == "ssm":
        return "ssm", "none"
    if cfg.family == "hybrid" and not cfg.is_attn_layer(i):
        mixer = "ssm"
    elif cfg.attn_type == "mla":
        mixer = "mla"
    else:
        mixer = "attn"
    return mixer, "moe" if cfg.is_moe_layer(i) else "mlp"


def _check_supported(cfg: ModelConfig):
    for i in range(cfg.n_layers):
        layer_kind(cfg, i)


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's config: plain GQA layers with an MLP, whatever the
    decoder's family."""
    return dataclasses.replace(cfg, attn_type="gqa", n_experts=0,
                               family="dense", block_pattern=1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _frozen(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


def _layers(layers: list) -> nn.ModuleList:
    return nn.ModuleList(
        nn.ModuleDict({k: _frozen(v) for k, v in layer.items()})
        for layer in layers)


class Model(nn.Module):
    """The parameters of a stack under the reference's names:
    ``embed_tokens`` (and ``lm_head`` when untied), ``blocks`` (layer i
    is ``blocks[i]``, a ``ModuleDict`` of ``norm1``, ``attn``, ``norm2``,
    ``mlp`` in a dense stack, ``moe`` in place of ``mlp`` on an MoE
    layer, ``ssm`` in place of ``attn`` on an SSD layer; an ssm stack's
    layers hold ``norm1`` and ``ssm`` alone; with an encoder each also
    holds ``norm_x`` and ``cross``), with an encoder ``enc_blocks`` and
    ``enc_norm``, and ``final_norm``. ``p[name]`` and ``name in p`` read
    it as the reference reads its parameter dict.

    ``tree`` holds tensors: ``{"embed_tokens", ["lm_head"], "blocks":
    [{"norm1": {...}, "attn": {...}, ...}, ...], ["enc_blocks": [...],
    "enc_norm": {...}], "final_norm": {...}}``.
    """

    def __init__(self, tree: dict):
        super().__init__()
        for name in ("embed_tokens", "lm_head"):
            if name in tree:
                self.register_parameter(
                    name, nn.Parameter(tree[name], requires_grad=False))
        self.blocks = _layers(tree["blocks"])
        if "enc_blocks" in tree:
            self.enc_blocks = _layers(tree["enc_blocks"])
            self.enc_norm = _frozen(tree["enc_norm"])
        self.final_norm = _frozen(tree["final_norm"])

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name):
        return name in self._parameters or name in self._modules

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device


def _init_layer(cfg: ModelConfig, gen: torch.Generator, i: int,
                cross: bool = False) -> dict:
    mixer, ff = layer_kind(cfg, i)
    p = {"norm1": init_norm(cfg, gen)}
    if mixer == "ssm":
        p["ssm"] = ssm_mod.init_ssm(cfg, gen)
    elif mixer == "mla":
        p["attn"] = attn.init_mla(cfg, gen)
    else:
        p["attn"] = attn.init_attention(cfg, gen)
    if cross:
        p["norm_x"] = init_norm(cfg, gen)
        p["cross"] = attn.init_attention(cfg, gen, cross=True)
    if ff != "none":
        p["norm2"] = init_norm(cfg, gen)
        if ff == "moe":
            p["moe"] = moe_mod.init_moe(cfg, gen)
        else:
            p["mlp"] = init_mlp(cfg, gen)
    return p


def init_model(cfg: ModelConfig, seed: int = 0, *, device=None) -> Model:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, made
    on ``device`` (cuda unless given; on ``meta`` shapes alone, the dry
    run's ``jax.eval_shape``). The numbers differ from the
    reference's ``jax.random`` ones; carry those across with
    ``convert.params_from_numpy``."""
    _check_supported(cfg)
    device = resolve_device(device)
    gen = generator(device, seed)
    tree = init_embed(cfg, gen)
    cross = cfg.n_enc_layers > 0
    tree["blocks"] = [_init_layer(cfg, gen, i, cross)
                      for i in range(cfg.n_layers)]
    if cross:
        enc_cfg = _enc_cfg(cfg)
        tree["enc_blocks"] = [_init_layer(enc_cfg, gen, 0)
                              for _ in range(cfg.n_enc_layers)]
        tree["enc_norm"] = init_norm(cfg, gen)
    tree["final_norm"] = init_norm(cfg, gen)
    return Model(tree)


# ---------------------------------------------------------------------------
# single layer forward (prefill)
# ---------------------------------------------------------------------------

def _layer_forward(cfg: ModelConfig, p, x, positions, i: int, *,
                   causal: bool, enc_out=None, mesh=None, dp_entry=None,
                   use_kernel: bool = False, slot_kernel: bool = False,
                   unroll: bool = False):
    """Returns (x, cache_dict, aux_loss); aux is 0.0 without MoE.
    ``use_kernel`` is attention's and the SSD's, ``slot_kernel`` the MoE
    layer's slotting's. With ``enc_out`` a layer that holds ``cross``
    attends to it after its mixer, through the chunked
    ``flash_attention_ref`` (as the reference's does under
    ``use_pallas``; ``flash_attention_costexact`` under ``unroll``), and
    its cache gains ``cross_k``/``cross_v``."""
    mixer, ff = layer_kind(cfg, i)
    aux = 0.0
    h = apply_norm(cfg, p["norm1"], x)
    if mixer == "ssm":
        out, cache = ssm_mod.ssm_forward(cfg, p["ssm"], h,
                                         use_kernel=use_kernel)
    elif mixer == "mla":
        out, cache = attn.mla_forward(cfg, p["attn"], h, positions,
                                      unroll=unroll)
    else:
        out, kv = attn.attention_forward(cfg, p["attn"], h, positions,
                                         causal=causal, use_kernel=use_kernel,
                                         unroll=unroll)
        cache = {"k": kv[0], "v": kv[1]}
    x = x + out
    if enc_out is not None and "cross" in p:
        h = apply_norm(cfg, p["norm_x"], x)
        q, k, v = attn._qkv(cfg, p["cross"], h, enc_out)
        fa = (attn.flash_attention_costexact if unroll
              else attn.flash_attention_ref)
        o = fa(q, k, v, causal=False)
        B, S, H, hd = q.shape
        x = x + matmul(o.reshape(B, S, H * hd), p["cross"]["wo"])
        cache["cross_k"], cache["cross_v"] = k, v
    if ff != "none":
        h = apply_norm(cfg, p["norm2"], x)
        if ff == "moe":
            y, aux = moe_mod.moe_forward(cfg, p["moe"], h, mesh=mesh,
                                         dp_entry=dp_entry, unroll=unroll,
                                         use_kernel=slot_kernel)
        else:
            y = apply_mlp(p["mlp"], h)
        x = x + y
    return x, cache, aux


# ---------------------------------------------------------------------------
# whole-stack forward
# ---------------------------------------------------------------------------

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots``: keep the outputs of
    matrix products, recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(name: str, fn, *args):
    """``fn(*args)`` with its activations kept as the reference's
    ``_remat_policy(name)`` keeps a scanned super-block's (one layer
    here): "none" all of them, "dots" the matrix products' outputs,
    "full" none (the layer is recomputed in the backward pass)."""
    if name == "none":
        return fn(*args)
    if name == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=partial(
                              create_selective_checkpoint_contexts,
                              _save_dots))
    if name == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    raise ValueError(f"remat policy {name!r}: expected full, dots or none")


def _encoder_forward(cfg: ModelConfig, params: Model, frames, *,
                     use_kernel=False, remat="none", unroll=False):
    """frames: (B, S_enc, D) stub frame embeddings -> (B, S_enc, D), in
    the frames' dtype (fp32 frames against bf16 weights run in fp32, as
    JAX promotes them): ``n_enc_layers`` layers without the causal mask
    at positions ``arange(S_enc)``, then ``enc_norm``. With
    ``use_kernel`` their attention takes the flash_attention wrapper."""
    enc_cfg = _enc_cfg(cfg)
    B, S_enc, _ = frames.shape
    pos = torch.arange(S_enc, dtype=torch.int32,
                       device=frames.device).expand(B, S_enc)
    x = frames
    for p in params["enc_blocks"]:
        body = partial(_layer_forward, enc_cfg, p, positions=pos, i=0,
                       causal=False, use_kernel=use_kernel, unroll=unroll)
        x = _remat(remat, body, x)[0]
    return apply_norm(cfg, params["enc_norm"], x)


def forward(cfg: ModelConfig, params: Model, batch: dict, *, mesh=None,
            dp_entry=None, use_kernel=False, slot_kernel=None, remat="none",
            want_cache: bool = False, unroll: bool = False):
    """Train / prefill forward. batch: ``tokens`` (B, S_text) on the
    model's device, and optionally ``frontend_embeds``: a VLM's (B,
    S_img, D) prefix, cast to the model dtype and prepended (S = S_img +
    S_text), or an audio stack's (B, S_enc, D) encoder input (S =
    S_text). Returns (logits (B, S, V), aux_loss[, caches]);
    ``caches["blocks"][i]`` holds layer i's raw cache at sequence length
    S (k/v of an attention layer, ``ckv`` of an MLA layer; state and
    conv carries of an ssm layer; ``cross_k``/``cross_v`` (B, S_enc, KV,
    hd) beside k/v with an encoder), which
    ``serve.engine.prefill_to_decode_cache`` turns into decode layout.
    ``remat`` ("none", "dots" or "full") checkpoints each layer's body,
    as the reference does each super-block's; under "dots" and "full"
    the backward pass runs a layer's forward again, its MoE slotting
    included. ``slot_kernel`` (None: as ``use_kernel``) sends the MoE
    layers' slotting through bucket_slots' wrapper. ``mesh`` and
    ``dp_entry`` go to the MoE layers.
    """
    _check_supported(cfg)
    x = embed_tokens(cfg, params, batch["tokens"])
    enc_out = None
    fe = batch.get("frontend_embeds")
    if cfg.frontend == "vision_stub" and fe is not None:
        x = torch.cat([fe.to(x.dtype), x], 1)
    elif cfg.n_enc_layers and fe is not None:
        enc_out = _encoder_forward(cfg, params, fe, use_kernel=use_kernel,
                                   remat=remat, unroll=unroll)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    if slot_kernel is None:
        slot_kernel = use_kernel
    block_caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(params["blocks"]):
        body = partial(_layer_forward, cfg, p, positions=positions, i=i,
                       causal=True, enc_out=enc_out, mesh=mesh,
                       dp_entry=dp_entry, use_kernel=use_kernel,
                       slot_kernel=slot_kernel, unroll=unroll)
        x, c, aux = _remat(remat, body, x)
        if torch.is_tensor(aux):        # an MoE layer's
            aux_total = aux_total + aux
        if want_cache:
            block_caches.append(c)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params, x)
    if want_cache:
        return logits, aux_total, {"blocks": block_caches}
    return logits, aux_total


def loss_fn(cfg: ModelConfig, params: Model, batch: dict, *, mesh=None,
            dp_entry=None, use_kernel=False, slot_kernel=None, remat="none",
            unroll: bool = False):
    """(loss, {"ce", "aux"}) of a batch of ``tokens`` and ``labels``
    (B, S) and an optional ``loss_mask`` (and ``frontend_embeds``, as
    ``forward`` takes them: only the text positions carry loss); loss =
    ce + router_aux_coef * aux, aux the MoE layers' summed load-balancing
    losses (0 without MoE)."""
    logits, aux = forward(cfg, params, batch, mesh=mesh, dp_entry=dp_entry,
                          use_kernel=use_kernel, slot_kernel=slot_kernel,
                          remat=remat, unroll=unroll)
    labels = batch["labels"]
    ce = cross_entropy(logits[:, -labels.shape[1]:], labels,
                       batch.get("loss_mask"))
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# caches / decode
# ---------------------------------------------------------------------------

def _layer_cache_shape(cfg: ModelConfig, i: int, B: int, S_max: int,
                       device, enc_len: int = 0) -> dict:
    """Zero decode cache of one layer: the fp32 SSD state and the conv
    carries (model dtype) of an ssm layer, the compressed ``ckv`` of an
    MLA layer, k/v of an attention layer, and with ``enc_len`` its
    ``cross_k``/``cross_v`` (model dtype, as the reference makes them)."""
    dt = dtype_of(cfg)
    mixer = layer_kind(cfg, i)[0]
    if mixer == "mla":
        width = cfg.kv_lora_rank + cfg.qk_rope_dim
        return {"ckv": torch.zeros((B, S_max, width), dtype=dt,
                                   device=device)}
    if mixer == "ssm":
        di, K = cfg.d_inner, cfg.ssm_conv
        GN = cfg.ssm_groups * cfg.ssm_state
        return {
            "state": torch.zeros((B, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state), dtype=torch.float32,
                                 device=device),
            "conv_x": torch.zeros((B, K - 1, di), dtype=dt, device=device),
            "conv_B": torch.zeros((B, K - 1, GN), dtype=dt, device=device),
            "conv_C": torch.zeros((B, K - 1, GN), dtype=dt, device=device),
        }
    KV, hd = cfg.n_kv_heads, cfg.d_head
    S_cache = min(cfg.sliding_window, S_max) if cfg.attn_type == "swa" \
        else S_max
    c = {name: torch.zeros((B, S_cache, KV, hd), dtype=dt, device=device)
         for name in ("k", "v")}
    if enc_len:
        for name in ("cross_k", "cross_v"):
            c[name] = torch.zeros((B, enc_len, KV, hd), dtype=dt,
                                  device=device)
    return c


def init_cache(cfg: ModelConfig, B: int, S_max: int, enc_len: int = 0, *,
               device=None):
    """Zero decode caches, ``{"blocks": [layer 0's, layer 1's, ...]}``, on
    ``device`` (cuda unless given); ``enc_len`` positions of cross
    keys and values a layer."""
    _check_supported(cfg)
    device = resolve_device(device)
    return {"blocks": [_layer_cache_shape(cfg, i, B, S_max, device, enc_len)
                       for i in range(cfg.n_layers)]}


def _layer_decode(cfg: ModelConfig, p, x, cache: dict, t: int, i: int, *,
                  mesh=None, dp_entry=None, use_kernel=False):
    mixer, ff = layer_kind(cfg, i)
    h = apply_norm(cfg, p["norm1"], x)
    if mixer == "ssm":
        out, new_cache = ssm_mod.ssm_decode(cfg, p["ssm"], h, cache)
    elif mixer == "mla":
        out, new_cache = attn.mla_decode(cfg, p["attn"], h, cache, t,
                                         mesh=mesh, dp_entry=dp_entry)
    else:
        # the cache dict is updated in place and returned: cross_k and
        # cross_v ride along unchanged
        out, new_cache = attn.attention_decode(cfg, p["attn"], h, cache, t,
                                               mesh=mesh, dp_entry=dp_entry)
    x = x + out
    if "cross" in p and "cross_k" in cache:
        h = apply_norm(cfg, p["norm_x"], x)
        B = h.shape[0]
        H, hd = cfg.n_heads, cfg.d_head
        q = (h @ p["cross"]["wq"]).reshape(B, H, hd)
        enc_len = cache["cross_k"].shape[1]
        o, l, m = attn._decode_partials(
            q, cache["cross_k"], cache["cross_v"],
            torch.arange(enc_len, device=h.device), enc_len)
        o = attn.combine_partials(o, l, m, None).reshape(B, 1, H * hd)
        x = x + o.to(x.dtype) @ p["cross"]["wo"]
    if ff != "none":
        h = apply_norm(cfg, p["norm2"], x)
        if ff == "moe":
            y, _ = moe_mod.moe_forward(cfg, p["moe"], h, mesh=mesh,
                                       dp_entry=dp_entry,
                                       use_kernel=use_kernel)
        else:
            y = apply_mlp(p["mlp"], h)
        x = x + y
    return x, new_cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Model, cache, tokens_t, t: int, *,
                mesh=None, dp_entry=None, use_kernel=False,
                unroll: bool = False):
    """One decode step. tokens_t: (B, 1); t: the new token's position (the
    current length). Returns (logits (B, 1, V), new_cache); attention
    and MLA caches are updated in place (see
    ``attention.attention_decode``), an ssm layer's state and carries
    are new tensors. With ``use_kernel=True`` an MoE layer slots its
    records through bucket_slots' wrapper (the kernel on the card, its
    plain version on the CPU), else through the plain version. Under
    ``mesh`` the GQA and MLA caches are sequence-sharded over "model"
    (their length must divide by its size) and the MoE layers dispatch
    replicated over it."""
    _check_supported(cfg)
    x = embed_tokens(cfg, params, tokens_t)
    new_blocks = []
    for i, (p, c) in enumerate(zip(params["blocks"], cache["blocks"])):
        x, nc = _layer_decode(cfg, p, x, c, t, i, mesh=mesh,
                              dp_entry=dp_entry, use_kernel=use_kernel)
        new_blocks.append(nc)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params, x), {"blocks": new_blocks}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Model, batch: dict, *, mesh=None,
            dp_entry=None, use_kernel=False, unroll: bool = False):
    """Full-sequence forward returning last-token logits (B, 1, V)."""
    logits, _ = forward(cfg, params, batch, mesh=mesh, dp_entry=dp_entry,
                        use_kernel=use_kernel, remat="none", unroll=unroll)
    return logits[:, -1:]
