"""Serving engine: prefill -> batched decode with KV-cache management
(counterpart of ``repro/serve/engine.py``).

``make_serve_step`` is the one-token program: one new token against a
max_len-sized cache. ``ServeEngine`` wraps it: batched requests, greedy
or temperature sampling, early-stop bookkeeping.

One deliberate difference from the reference: its engine prefills with
``use_pallas`` left at False, this one prefills and decodes with
``use_kernel=True``, so a served request runs the flash_attention kernel
once per attention layer (GQA or MHA) and prefill, the ssd_scan kernel
once per SSD layer and prefill, and the bucket_slots kernel twice a
pipeline step of every MoE layer, at prefill and at every decode step;
a hybrid stack (jamba) runs all three. An encoder's layers (whisper's)
run flash_attention at prefill too, in the frames' dtype. Both compute
the same function (the kernels are held to it by the tests).

Under a mesh (``ServeEngine(mesh=, dp_entry=)``, ``distributed/mesh.py``)
the engine serves as the reference's does on a (data, model) mesh: the
MoE layers dispatch over "model" (expert-parallel at prefill, replicated
at decode) and the GQA and MLA caches are sequence-sharded over it, so
``max_len`` must divide by the model axis' size.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import Model, layer_kind


# ---------------------------------------------------------------------------
# prefill cache -> decode cache layout
# ---------------------------------------------------------------------------

def _convert_layer(cfg: ModelConfig, kind: str, raw: dict, S: int,
                   S_max: int) -> dict:
    """raw prefill cache (seq length S) -> decode layout (capacity S_max).
    ``kind`` is the layer's mixer, "ssm", "mla" or "attn"."""
    if kind == "ssm":
        return raw  # state + conv carries are already the decode layout
    if kind == "mla":
        _fits(S, S_max)
        return {"ckv": torch.nn.functional.pad(raw["ckv"],
                                               (0, 0, 0, S_max - S))}
    out = {}
    if cfg.attn_type == "swa":
        W = min(cfg.sliding_window, S_max)
        n = min(S, W)
        pos = torch.arange(S - n, S, device=raw["k"].device)  # positions kept
        slots = pos % W
        for name in ("k", "v"):
            x = raw[name]
            ring = x.new_zeros((x.shape[0], W) + x.shape[2:])
            ring[:, slots] = x[:, S - n:]
            out[name] = ring
    else:
        _fits(S, S_max)
        for name in ("k", "v"):
            out[name] = torch.nn.functional.pad(raw[name],
                                                (0, 0, 0, 0, 0, S_max - S))
    for name in ("cross_k", "cross_v"):     # the encoder's, as they are
        if name in raw:
            out[name] = raw[name]
    return out


def _fits(S: int, S_max: int):
    if S > S_max:
        raise ValueError(f"a prefill of {S} tokens does not fit a "
                         f"cache of {S_max}")


def prefill_to_decode_cache(cfg: ModelConfig, caches: dict, S: int,
                            S_max: int) -> dict:
    """Convert ``forward(want_cache=True)`` output to ``decode_step``
    layout, layer by layer as each layer's mixer keeps it (a hybrid
    stack holds SSD states and conv carries beside k/v)."""
    return {"blocks": [
        _convert_layer(cfg, layer_kind(cfg, i)[0], c, S, S_max)
        for i, c in enumerate(caches["blocks"])]}


# ---------------------------------------------------------------------------
# the serve_step program
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig, *, mesh=None, dp_entry=None,
                    unroll: bool = False):
    """serve_step(params, cache, tokens_t (B,1), t) -> (logits, cache):
    one new token with a KV cache of max_len, through the kernel path
    (``use_kernel=True``), as the engine's prefill."""
    def serve_step(params, cache, tokens_t, t):
        return tf.decode_step(cfg, params, cache, tokens_t, t,
                              mesh=mesh, dp_entry=dp_entry, use_kernel=True,
                              unroll=unroll)
    return serve_step


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeEngine:
    """Batched request serving over one model replica, on ``device``
    (cuda unless given; ``params`` must live there, and so must a
    ``mesh``)."""
    cfg: ModelConfig
    params: Model
    max_len: int
    mesh: Any = None
    dp_entry: Any = None
    eos_id: int = -1
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.params.device != self.device:
            raise ValueError(f"params are on {self.params.device}, the "
                             f"engine on {self.device}")
        if self.mesh is not None:
            if self.mesh.device != self.device:
                raise ValueError(f"the mesh is on {self.mesh.device}, the "
                                 f"engine on {self.device}")
            tp = self.mesh.axis_size("model")
            sharded = self.cfg.attn_type != "swa" and any(
                layer_kind(self.cfg, i)[0] != "ssm"
                for i in range(self.cfg.n_layers))
            if sharded and self.max_len % tp:
                raise ValueError(
                    f"max_len {self.max_len} does not divide by the mesh's "
                    f"model axis ({tp}): a mesh's cache length must divide "
                    f"by tp, since the decode caches are sequence-sharded "
                    f"over it")
        self._step = make_serve_step(self.cfg, mesh=self.mesh,
                                     dp_entry=self.dp_entry)
        self._prefill = partial(
            tf.forward, self.cfg, mesh=self.mesh, dp_entry=self.dp_entry,
            use_kernel=True, want_cache=True)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, n_new: int, *,
                 frontend_embeds: np.ndarray | None = None,
                 greedy: bool = True, temperature: float = 1.0,
                 seed: int = 0) -> np.ndarray:
        """prompts: (B, S_prompt) int32 (same length; pad upstream);
        ``frontend_embeds``: a VLM's (B, S_img, D) prefix or an audio
        stack's (B, S_enc, D) frames (``transformer.forward``), whose
        dtype the encoder keeps. Returns (B, n_new) generated ids.
        Sampling draws from a ``torch.Generator`` seeded with ``seed``."""
        B, S = prompts.shape
        batch = {"tokens": torch.from_numpy(
            np.ascontiguousarray(prompts, dtype=np.int32)).to(self.device)}
        if frontend_embeds is not None:
            batch["frontend_embeds"] = torch.as_tensor(frontend_embeds,
                                                       device=self.device)
        logits, _, raw = self._prefill(self.params, batch)
        # a vision prefix takes cache positions ahead of the prompt
        S_ctx = S + (frontend_embeds.shape[1]
                     if self.cfg.frontend == "vision_stub"
                     and frontend_embeds is not None else 0)
        cache = prefill_to_decode_cache(self.cfg, raw, S_ctx, self.max_len)

        gen = torch.Generator(device=self.device).manual_seed(seed)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        outs = [tok]
        done = np.zeros((B,), bool)
        for step in range(n_new - 1):
            logits, cache = self._step(self.params, cache, tok, S_ctx + step)
            if greedy:
                tok = logits[:, -1:].argmax(-1).to(torch.int32)
            else:
                probs = torch.softmax(logits[:, -1].float() / temperature,
                                      -1)
                tok = torch.multinomial(probs, 1, generator=gen).to(
                    torch.int32)
            outs.append(tok)
            if self.eos_id >= 0:
                done |= (tok[:, 0] == self.eos_id).cpu().numpy()
                if done.all():
                    break
        return torch.cat(outs, 1).cpu().numpy()
