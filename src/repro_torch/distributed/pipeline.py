"""Pipeline parallelism across pods, on a GPipe schedule (counterpart of
``repro/distributed/pipeline.py``).

Why pods: the multi-pod mesh's ``pod`` axis is the thin link. Pipelining
the *layers* across pods turns the cross-pod gradient all-reduce of
every parameter into per-microbatch activation sends (point-to-point
permutes), the paper's decoupled push applied at the pod level: partial
results stream forward as they are produced instead of a bulk exchange
at the end.

Mechanics, as in the reference: stage s of the ``stage_axis`` owns the
super-blocks ``[s * nb_loc, (s + 1) * nb_loc)`` of ``block_pattern``
layers (``pp_param_specs``). The wavefront takes M + S - 1 steps; step t
moves microbatch t - s through stage s and hands its output to stage
s + 1 with ``collectives.mesh_ppermute``. Stage 0 takes a fresh
microbatch of the embedded batch. The last stage applies the head and
the cross-entropy to its M finished microbatches, in one product after
the wavefront; every other slot (the other stages', and the bubble,
fraction (S - 1) / (M + S - 1)) computes its head and loss as masked
work, as the reference's do, so the dry run counts the reference's
FLOPs. The loss is the sum of the microbatches' means over their count,
summed over the stage axis (``mesh_psum``).

On one card the stages are virtual ranks: the region is a mesh of the
stage axis alone (the other axes of ``mesh`` shard nothing inside it, as
the reference leaves them to GSPMD), each step runs the stages one after
another, and autograd differentiates through the schedule (the
permute's backward pass is the reverse permute). It runs on the mesh's
device, cuda unless the caller made the mesh elsewhere.

Scope is the reference's: dense stacks. A config with MoE layers, leading
dense layers or an encoder raises ``ValueError`` (PP+EP composition is
future work there).
"""
from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import torch

from repro_torch.config import MeshConfig, ModelConfig, TrainConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import P, param_specs
from repro_torch.models.layers import (DTYPES, apply_norm, cross_entropy,
                                       dtype_of, embed_tokens, unembed)
from repro_torch.models.transformer import _layer_forward, _remat
from repro_torch.optim.adamw import adamw_update


def check_scope(cfg: ModelConfig):
    """Raise unless ``cfg`` is a stack the pipeline takes."""
    why = [w for w, bad in (("MoE layers", cfg.n_experts > 0),
                            ("leading dense layers (first_k_dense)",
                             cfg.first_k_dense > 0),
                            ("an encoder", cfg.n_enc_layers > 0)) if bad]
    if why:
        raise ValueError(
            f"{cfg.name} has {' and '.join(why)}: the pipeline takes dense "
            f"stacks only, as the reference's does (PP+EP composition is "
            f"future work)")


def layers_per_stage(cfg: ModelConfig, n_stages: int) -> int:
    """Layers a stage owns: ``n_scan_blocks / n_stages`` super-blocks of
    ``block_pattern`` layers."""
    nb = cfg.n_scan_blocks
    if nb % n_stages:
        raise ValueError(f"{nb} super-blocks of {cfg.name} do not divide "
                         f"over {n_stages} stages")
    return nb // n_stages * cfg.block_pattern


def _reader(params, accum_dtype):
    """``read(tree)``: a parameter (or a mapping of them, as a layer's)
    as the schedule reads it. With ``accum_dtype`` each parameter of
    another dtype is cast to it once, and every read casts it back: the
    value is the parameter's, and autograd sums the gradients of its
    reads (one a step and stage) in ``accum_dtype``, as the standard
    step sums its microbatches' gradients, before the one cast back."""
    acc = {} if accum_dtype is None else {
        id(p): p.to(accum_dtype) for p in params.parameters()
        if p.dtype != accum_dtype}

    def read(tree):
        if isinstance(tree, torch.Tensor):
            a = acc.get(id(tree))
            return tree if a is None else a.to(tree.dtype)
        return {k: read(v) for k, v in tree.items()}
    return read


def _stage_fwd(cfg: ModelConfig, blocks, first: int, n_layers: int, x,
               positions, *, remat: str, unroll: bool, read):
    """This stage's super-blocks on x, each recomputed in the backward
    pass unless ``remat`` is "none" (the reference checkpoints each
    scanned super-block under any other policy); a layer's parameters
    are read inside it (``_reader``), so recomputed too."""
    def superblock(h, b):
        for i in range(b, b + cfg.block_pattern):
            h = _layer_forward(cfg, read(blocks[i]), h, positions, i,
                               causal=True, unroll=unroll)[0]
        return h

    policy = "none" if remat == "none" else "full"
    for b in range(first, first + n_layers, cfg.block_pattern):
        x = _remat(policy, partial(superblock, b=b), x)
    return x


def gpipe_loss_fn(cfg: ModelConfig, params, batch: dict, *, mesh,
                  n_microbatches: int, stage_axis: str = "pod",
                  remat: str = "full", unroll: bool = False,
                  accum_dtype: torch.dtype | None = None):
    """Pipeline-parallel loss over ``stage_axis`` of ``mesh``: (loss,
    {"ce", "aux"}). ``params`` is the port's ``Model``; ``batch`` holds
    the global ``tokens`` and ``labels`` (B, S) on the mesh's device,
    cut into M = ``n_microbatches`` microbatches of B / M rows.
    ``unroll`` sends the layers' attention through the cost-exact
    ``flash_attention_costexact`` (the dry run's); ``accum_dtype`` sums
    each parameter's gradients over the steps in that dtype
    (``_reader``)."""
    check_scope(cfg)
    n_stages = mesh.axis_size(stage_axis)
    L = layers_per_stage(cfg, n_stages)
    M = n_microbatches
    tokens, labels = batch["tokens"], batch["labels"]
    if tokens.device != mesh.device:
        raise ValueError(f"a batch on {tokens.device} meets a mesh on "
                         f"{mesh.device}")
    B, S = tokens.shape
    if B % M:
        raise ValueError(f"a batch of {B} does not cut into {M} "
                         f"microbatches")
    mb = B // M
    # stage 0's inputs: the batch embedded in one gather, so the
    # embedding's gradient is one scatter over every token, as the
    # unpipelined step's (per-microbatch bf16 partial sums of a frequent
    # token's rows would round apart from it)
    read = _reader(params, accum_dtype)
    head = "lm_head" if "lm_head" in params else "embed_tokens"
    x_mb = embed_tokens(cfg, {"embed_tokens": read(params["embed_tokens"])},
                        tokens).reshape(M, mb, S, cfg.d_model)
    lab_mb = labels.reshape(M, mb, S)
    stages = Mesh((n_stages,), (stage_axis,), mesh.device)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(mb, S)
    blocks = params["blocks"]
    perm = [(i, i + 1) for i in range(n_stages - 1)]     # last send dropped
    last = n_stages - 1

    def ce_of(y, labels, per: int):
        """The summed cross-entropy means of ``y``'s microbatches of
        ``per`` rows, through the final norm and the head."""
        h = apply_norm(cfg, read(params["final_norm"]), y)
        logits = unembed(cfg, {head: read(params[head])}, h)
        return sum(cross_entropy(logits[i:i + per], labels[i:i + per])
                   for i in range(0, y.shape[0], per))

    x_in = torch.zeros((n_stages, mb, S, cfg.d_model), dtype=dtype_of(cfg),
                       device=tokens.device)
    finished = []                   # the last stage's microbatches, in order
    for t in range(M + n_stages - 1):
        ys = []
        for s in range(n_stages):
            m = t - s                       # the microbatch at this stage
            valid = 0 <= m < M
            m_c = min(max(m, 0), M - 1)
            x = x_mb[m_c] if s == 0 else x_in[s].to(x_mb.dtype)
            y = _stage_fwd(cfg, blocks, s * L, L, x, positions, remat=remat,
                           unroll=unroll, read=read)
            if valid and s == last:
                finished.append(y)
            else:
                # masked work: the head and the loss of a slot that does
                # not count, as every stage's in the reference
                with torch.no_grad():
                    ce_of(y, lab_mb[m_c], mb)
            ys.append(y if valid else torch.zeros_like(y))
        x_in = coll.mesh_ppermute(torch.stack(ys), stage_axis, perm, stages)
    # the last stage's head over its M finished microbatches in one
    # product, so each head weight's gradient is one sum over every token,
    # as the unpipelined step's; the loss sums their M means
    y = torch.cat(finished)
    labels_f = lab_mb.reshape(M * mb, S)
    ce_sum = ce_of(y, labels_f, per=mb)
    on_last = torch.arange(n_stages, device=tokens.device) == last
    loss_sum = torch.where(on_last, ce_sum, 0.0)
    tok_sum = torch.where(on_last, float(M), 0.0)
    # only the last stage holds the loss: share it over the stage axis
    loss_sum = coll.mesh_psum(loss_sum, stage_axis, stages)[0]
    tok_sum = coll.mesh_psum(tok_sum, stage_axis, stages)[0]
    loss = loss_sum / tok_sum.clamp_min(1.0)
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=loss.device)}


class StageSpec(NamedTuple):
    """A parameter of the port's ``Model`` under the pipeline: its spec
    (no scan dim) and the stage that owns it (None: every stage)."""
    spec: P
    stage: int | None


def pp_param_specs(params: Any, cfg: ModelConfig, mesh_cfg: MeshConfig,
                   stage_axis: str = "pod"):
    """The baseline specs with the blocks placed on their stage (each pod
    stores only its stage; the optimizer state follows). Over the
    reference's tree (nested dicts of leaves with a ``.shape``): its
    specs, ``P(stage_axis, *spec[1:])`` on every ``blocks`` leaf. Over
    the port's ``Model``, which has no scan dim: ``{name: StageSpec}``,
    ``blocks.i.*`` owned by stage ``i // layers_per_stage``."""
    base = param_specs(params, cfg, mesh_cfg)
    if hasattr(params, "named_parameters"):
        n_stages = mesh_cfg.shape[mesh_cfg.axes.index(stage_axis)]
        L = layers_per_stage(cfg, n_stages)
        return {name: StageSpec(spec, int(name.split(".")[1]) // L
                                if name.startswith("blocks.") else None)
                for name, spec in base.items()}

    def visit(tree, keys):
        if isinstance(tree, dict):
            return {k: visit(v, keys + (k,)) for k, v in tree.items()}
        if "blocks" in keys and len(tree) > 0:
            return P(stage_axis, *tree[1:])
        return tree

    return visit(base, ())


def make_pp_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, mesh,
                       n_microbatches: int, stage_axis: str = "pod"):
    """train_step(state, batch) -> (state, metrics): the pipelined loss's
    gradients (``torch.autograd.grad`` over the parameters, summed over
    the microbatches in ``tcfg.accum_dtype``) and the standard step's
    ``adamw_update``, in place, as
    ``train.train_step.make_train_step`` updates its state; metrics
    ``ce``, ``aux``, ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors."""
    check_scope(cfg)

    def train_step(state, batch: dict):
        leaves = list(state.params.parameters())
        loss, metrics = gpipe_loss_fn(
            cfg, state.params, batch, mesh=mesh,
            n_microbatches=n_microbatches, stage_axis=stage_axis,
            remat=tcfg.remat_policy, accum_dtype=DTYPES[tcfg.accum_dtype])
        grads = torch.autograd.grad(loss, leaves)
        _, _, om = adamw_update(leaves, grads, state.opt, tcfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, dict(metrics, loss=loss.detach(), **om)

    return train_step
