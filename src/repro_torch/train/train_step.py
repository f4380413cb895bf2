"""The train step: microbatched gradient accumulation, remat, AdamW
(counterpart of ``repro/train/train_step.py``).

The reference differentiates ``loss_fn`` with ``jax.value_and_grad``
outside any Pallas kernel (its train step leaves ``use_pallas`` off):
attention runs through ``flash_attention_ref``, the SSD through its
reference scan and the MoE layers slot their records with an argsort.
The port does the same under autograd (``torch.autograd.grad`` over the
model's parameters) with one kernel: ``loss_fn(use_kernel=False,
slot_kernel=True)`` slots the MoE layers' records through bucket_slots'
wrapper, the kernel on a CUDA tensor and its plain version on a CPU
one. The slots are integers, so they need no backward; attention and
the SSD keep their plain, differentiable math, since neither kernel has
a backward. Under ``remat="full"`` or ``"dots"`` the backward pass
slots each MoE layer's records again, on the same ids.

``init_train_state`` makes the model it is handed trainable
(``requires_grad``); serving it still builds no graph
(``transformer.prefill`` and ``decode_step`` run under ``no_grad``, the
engine under ``inference_mode``). A step updates every tensor of the
state in place (parameters, moments, step counter, residuals) and
returns the same state, as the reference's jitted step donates its
input state.

The step runs for every stack the port builds (dense, SWA, ssm, MoE
with MLA, hybrid), unsharded or under a mesh (``mesh=``, ``dp_entry=``;
``distributed/mesh.py``): the MoE layers then dispatch inside the
``shard_map`` region of ``collectives``, whose blocking and named-axis
collectives autograd differentiates through, so the loss and gradients
are the reference's sharded ones (each shard's buckets drop their own
records). ``unroll=True`` sends prefill attention through the
cost-exact ``attention.flash_attention_costexact``, as the reference's
unrolled step does; the accumulation loop is a Python loop already.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.config import ModelConfig, RunConfig, TrainConfig
from repro_torch.models import convert
from repro_torch.models.layers import DTYPES
from repro_torch.models.transformer import Model, loss_fn
from repro_torch.optim import compress as compress_mod
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update


class TrainState(NamedTuple):
    params: Model
    opt: AdamWState
    residual: Any                # int8-compression error feedback (or None)


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     params: Model) -> TrainState:
    params.requires_grad_(True)
    leaves = list(params.parameters())
    res = (compress_mod.init_residuals(leaves)
           if tcfg.compress_cross_pod else None)
    return TrainState(params, adamw_init(leaves, tcfg), res)


def _microbatches(batch: dict, A: int, mb: int):
    for a in range(A):
        yield {k: v[a * mb:(a + 1) * mb] for k, v in batch.items()}


def _accumulate_grads(cfg: ModelConfig, tcfg: TrainConfig, run: RunConfig,
                      params: Model, batch: dict, *, mesh=None,
                      dp_entry=None, unroll: bool = False):
    """(grads, loss, metrics). With A = ``run.grad_accum_steps`` > 1 the
    batch is cut into A microbatches; their gradients are summed in
    ``accum_dtype`` and divided by A (fp32), the loss is their mean and
    the metrics are the last microbatch's."""
    A = run.grad_accum_steps
    leaves = list(params.parameters())

    def grads_of(b):
        loss, metrics = loss_fn(cfg, params, b, mesh=mesh,
                                dp_entry=dp_entry, slot_kernel=True,
                                remat=tcfg.remat_policy, unroll=unroll)
        return loss, metrics, torch.autograd.grad(loss, leaves)

    if A == 1:
        loss, metrics, grads = grads_of(batch)
        return list(grads), loss.detach(), _detached(metrics)

    adt = DTYPES[tcfg.accum_dtype]
    gsum = [torch.zeros(p.shape, dtype=adt, device=p.device)
            for p in leaves]
    lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for mbatch in _microbatches(batch, A, run.resolved_microbatch()):
        loss, metrics, grads = grads_of(mbatch)
        torch._foreach_add_(gsum, grads)
        lsum += loss.detach()
        del grads
    torch._foreach_div_(gsum, A)
    return [g.float() for g in gsum], lsum / A, _detached(metrics)


def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, run: RunConfig, *, mesh=None,
                    dp_entry=None, unroll: bool = False):
    """train_step(state, batch) -> (state, metrics). ``batch``: {tokens,
    labels[, loss_mask]} at global_batch, on the state's device; metrics
    ``ce``, ``aux``, ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors.

    Its two halves are attributes, so a caller can time them apart:
    ``train_step.grads(state, batch) -> (grads, loss, metrics)`` and
    ``train_step.update(state, grads, loss, metrics) -> (state,
    metrics)``; ``train_step(state, batch)`` is the one after the
    other. Under ``mesh`` each microbatch's batch dim must divide over
    ``dp_entry``'s axes."""
    tcfg = run.train

    def grads(state: TrainState, batch: dict):
        return _accumulate_grads(cfg, tcfg, run, state.params, batch,
                                 mesh=mesh, dp_entry=dp_entry, unroll=unroll)

    def update(state: TrainState, grads, loss, metrics):
        if tcfg.compress_cross_pod and state.residual is not None:
            # int8 error feedback on what would cross the pod link
            grads, residual = compress_mod.ef_compress(grads, state.residual)
            for dst, src in zip(state.residual, residual):
                dst.copy_(src)
        _, _, om = adamw_update(state.params.parameters(), grads,
                                state.opt, tcfg)
        return state, dict(metrics, loss=loss, **om)

    def train_step(state: TrainState, batch: dict):
        return update(state, *grads(state, batch))

    train_step.grads, train_step.update = grads, update
    return train_step


# ---------------------------------------------------------------------------
# snapshots under the reference's leaf keys
# ---------------------------------------------------------------------------

def state_tree(cfg: ModelConfig, state: TrainState,
               stack=torch.stack) -> TrainState:
    """The state as the reference's ``TrainState`` tree (its leaf keys
    ``.params/blocks/layer0/attn/wq``, ``.opt/.step``, ``.opt/.mu/...``),
    for ``CheckpointManager.save``/``save_async``: a snapshot crosses
    between the packages both ways. ``stack`` joins each block leaf's
    layers (``convert.ref_tree``)."""
    names = [n for n, _ in state.params.named_parameters()]

    def tree(leaves):
        return convert.ref_tree(cfg, zip(names, leaves), stack)
    params = [p.detach() for p in state.params.parameters()]
    return TrainState(
        tree(params),
        AdamWState(state.opt.step, tree(state.opt.mu), tree(state.opt.nu)),
        None if state.residual is None else tree(state.residual))


def _host_like(parts):
    return torch.empty((len(parts),) + tuple(parts[0].shape),
                       dtype=parts[0].dtype)


@torch.no_grad()
def restore_state(mgr, cfg: ModelConfig, state: TrainState,
                  step: int | None = None) -> tuple[int, dict]:
    """Read a snapshot (the latest unless ``step``) into ``state``'s
    tensors in place; returns (step, extra). The stacked leaves are read
    into host memory and copied layer by layer, so the card never holds
    a second stacked copy."""
    step, tree, extra = mgr.restore(state_tree(cfg, state, _host_like),
                                    step)
    names = [n for n, _ in state.params.named_parameters()]

    def load(dst, src_tree):
        for d, s in zip(dst, convert.ref_leaves(cfg, src_tree, names)):
            d.copy_(s)
    load(list(state.params.parameters()), tree.params)
    state.opt.step.copy_(tree.opt.step)
    load(state.opt.mu, tree.opt.mu)
    load(state.opt.nu, tree.opt.nu)
    if state.residual is not None:
        load(state.residual, tree.residual)
    return step, extra
