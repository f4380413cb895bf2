"""The dry run: every (arch x shape x mesh) cell's program at full width on
``meta`` tensors (counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's train step, prefill or
serve step onto the 16 x 16 and 2 x 16 x 16 production meshes and reads
XLA's memory and cost analyses and the collectives of the partitioned
HLO. The port has no compiler to ask: each cell's program runs once,
eagerly, on ``meta`` tensors over the production mesh (virtual ranks,
``launch/mesh.py``). Meta is the port's ``jax.eval_shape``: shapes and
dtypes, no data, no launch, no memory. The programs take the plain
versions of the kernels (a ``meta`` tensor takes them,
``kernels/backend.use_kernel``), as the reference's dry run leaves
``use_pallas`` off, and run unrolled (``unroll=True``): attention
through the cost-exact ``flash_attention_costexact``.

``measure`` stands in for ``lower_compile`` and reads, under one
``TorchDispatchMode`` (:class:`Meter`) and the collectives' counter:

  * ``memory_analysis``: ``argument_size_in_bytes`` per device, from the
    arguments' specs on the mesh (exact), and ``peak_live_bytes``, the
    most bytes the whole virtual program held at once beyond its
    arguments (storages tracked from allocation to release);
  * ``cost_analysis``: ``flops`` per device, the whole program's count
    over the mesh's size (``flops_total``), by the formulas of
    ``torch.utils.flop_counter`` (``FlopCounterMode``'s registry: matrix
    products, not elementwise work, which XLA's count includes), and
    ``bytes accessed``: every dispatched op's operand and result bytes,
    per device likewise;
  * ``collectives``: ``hlo_stats.collective_bytes`` of what the program
    performed (no GSPMD-inserted collectives: see ``hlo_stats``);
  * ``measure_s``: the host seconds.

Calibration: the reference counts scan bodies once and extrapolates
reduced-depth unrolled programs. An eager run counts every layer, so
``calibrate`` counts the full program directly (its ``full`` record)
and keeps the reference's (nb, A) = (1, 1), (2, 1), (1, 2) programs and
their affine extrapolation as a check that the two agree:

    cost(NB, A) = cost(1,1) + (A-1)·dA + A·(NB-1)·dL
    dL = cost(2,1) - cost(1,1);  dA = cost(1,2) - cost(1,1)

PyTorch's ``meta`` kernels of elementwise ops and reductions run as
Python decompositions, slowly; :class:`Meter` makes those outputs itself
from the broadcast or reduced shape, the dtype the op gives on
one-element CPU tensors (cached per signature) and the layout torch's
kernel would give, which keeps a full-width train step within seconds.

Usage:
    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all [--multipod]
        [--both-meshes] [--no-calibrate] [--variant NAME] [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from functools import partial
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.config import SHAPES, MeshConfig, ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, cell_status, get_config
from repro_torch.distributed.mesh import Mesh, NamedSharding
from repro_torch.distributed.sharding import P
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.hlo_stats import CollectiveCounter, collective_bytes
from repro_torch.launch.mesh import make_production_mesh, mesh_config
from repro_torch.models.transformer import (decode_step, init_model,
                                            layer_kind, prefill)
from repro_torch.train.train_step import init_train_state, make_train_step

META = torch.device("meta")


# ---------------------------------------------------------------------------
# the cells' programs: each build_* returns (fn, args, in_shardings, run)
# ---------------------------------------------------------------------------

def _params_abstract(cfg: ModelConfig):
    return init_model(cfg, 0, device=META)


# §Perf variants, the reference's: ``model`` overrides go into
# ModelConfig, ``remat``/``microbatch`` into the run, ``sharding`` picks
# the distributed/sharding.py rule variant
VARIANTS = {
    "base": {},
    "dots": dict(remat="dots"),
    "dots_a1": dict(remat="dots", microbatch="full"),
    "flatdp": dict(remat="dots", microbatch="full", sharding="flat_dp"),
    "disp2s": dict(remat="dots", microbatch="full",
                   model=dict(dispatch_mode="2s")),
    "disp1s": dict(remat="dots", microbatch="full",
                   model=dict(dispatch_mode="1s")),
    "serve_ep": dict(sharding="serve", model=dict(expert_tp_axis="data")),
    "flatdp_nr": dict(remat="none", microbatch="full", sharding="flat_dp"),
    "a1_nr": dict(remat="none", microbatch="full"),
    # pipeline across pods (multipod only): stages replace cross-pod DP
    "pp_pod": dict(pipeline=True),
}


@dataclasses.dataclass(frozen=True)
class StageSharding:
    """A block leaf under the pipeline: ``spec`` on ``mesh`` (the leaf
    has no scan dim), stored only by the ranks of ``stage`` along
    ``stage_axis``."""
    mesh: Mesh
    spec: tuple
    stage_axis: str
    stage: int


def build_train_pp(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   mesh_cfg: MeshConfig, *, n_microbatches: int = 8):
    """GPipe over the pod axis, flat data-FSDP inside each stage: the
    mesh's ranks re-axised to (data = 256, pod = 2), embed and head
    replicated, as the reference builds it. Like the reference's, the
    program is the pipelined forward and loss (its schedule of
    cross-pod permutes is the point), its layers' attention cost-exact
    (``unroll=True``) as every other cell's."""
    from repro_torch.distributed.pipeline import (gpipe_loss_fn,
                                                  layers_per_stage)
    n_pods = mesh_cfg.shape[0]
    n_data = mesh.size // n_pods
    pmesh = Mesh((n_data, n_pods), ("data", "pod"), mesh.device)
    run = specs_mod.make_run(cfg, shape, mesh_cfg)

    def fn(params, batch):
        return gpipe_loss_fn(cfg, params, batch, mesh=pmesh,
                             n_microbatches=n_microbatches, remat="dots",
                             unroll=True)

    params = _params_abstract(cfg)
    L = layers_per_stage(cfg, n_pods)

    def fsdp(dims):
        spec = [None] * len(dims)
        for i, n in enumerate(dims):
            if n % n_data == 0:
                spec[i] = "data"
                break
        return P(*spec)

    p_sh = {}
    for name, t in params.named_parameters():
        if name in ("embed_tokens", "lm_head"):
            p_sh[name] = NamedSharding(pmesh, P(*([None] * t.dim())))
        elif name.startswith("blocks."):
            p_sh[name] = StageSharding(pmesh, fsdp(t.shape), "pod",
                                       int(name.split(".")[1]) // L)
        else:
            p_sh[name] = NamedSharding(pmesh, fsdp(t.shape))
    batch = specs_mod.input_specs(cfg, shape)
    batch_sh = {k: NamedSharding(pmesh, P("data", *([None] * (v.dim() - 1))))
                for k, v in batch.items()}
    return fn, (params, batch), (p_sh, batch_sh), run


def build_train(cfg: ModelConfig, shape: ShapeConfig, mesh,
                mesh_cfg: MeshConfig, *, unroll=True, microbatch=0,
                remat=None, sharding="default"):
    run = specs_mod.make_run(cfg, shape, mesh_cfg, microbatch=microbatch)
    if remat:
        run = dataclasses.replace(
            run, train=dataclasses.replace(run.train, remat_policy=remat))
    dp = specs_mod.dp_entry_for(shape, mesh_cfg, sharding)
    fn = make_train_step(cfg, run, mesh=mesh, dp_entry=dp, unroll=unroll)
    state = init_train_state(cfg, run.train, _params_abstract(cfg))
    state_sh = specs_mod.state_shardings(cfg, mesh, mesh_cfg, state,
                                         sharding)
    batch = specs_mod.input_specs(cfg, shape)
    batch_sh = specs_mod.batch_shardings(cfg, shape, mesh, mesh_cfg, batch,
                                         sharding)
    return fn, (state, batch), (state_sh, batch_sh), run


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  mesh_cfg: MeshConfig, *, unroll=True,
                  sharding="default", **_):
    dp = specs_mod.dp_entry_for(shape, mesh_cfg)
    fn = partial(prefill, cfg, mesh=mesh, dp_entry=dp, unroll=unroll)
    params = _params_abstract(cfg)
    p_sh = specs_mod.params_shardings(cfg, mesh, mesh_cfg, params, sharding)
    batch = specs_mod.input_specs(cfg, shape)
    batch_sh = specs_mod.batch_shardings(cfg, shape, mesh, mesh_cfg, batch)
    return fn, (params, batch), (p_sh, batch_sh), None


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 mesh_cfg: MeshConfig, *, unroll=True,
                 sharding="default", **_):
    """One serve step at context ``seq_len``, on the plain paths. The
    port's decode takes its position as a host int: the step decodes
    the cache's last position, ``seq_len - 1`` (its work is the same at
    every position). A stack of SSD layers alone reads no position, so
    its step takes none, as XLA drops the reference's unused ``t``."""
    dp = specs_mod.dp_entry_for(shape, mesh_cfg)

    def fn(params, cache, tokens_t, t):
        return decode_step(cfg, params, cache, tokens_t, shape.seq_len - 1,
                           mesh=mesh, dp_entry=dp, use_kernel=False,
                           unroll=unroll)

    params = _params_abstract(cfg)
    p_sh = specs_mod.params_shardings(cfg, mesh, mesh_cfg, params, sharding)
    cache, tok, t = specs_mod.decode_input_specs(cfg, shape)
    cache_sh = specs_mod.cache_shardings(cfg, shape, mesh, mesh_cfg, cache)
    tok_sh = NamedSharding(mesh, P(dp, None))
    t_sh = NamedSharding(mesh, P())
    if all(layer_kind(cfg, i)[0] == "ssm" for i in range(cfg.n_layers)):
        t = t_sh = None
    return fn, (params, cache, tok, t), (p_sh, cache_sh, tok_sh, t_sh), None


def build_cell(cfg, shape, mesh, mesh_cfg, *, unroll=True, microbatch=0,
               remat=None, sharding="default"):
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, mesh_cfg, unroll=unroll,
                           microbatch=microbatch, remat=remat,
                           sharding=sharding)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, mesh_cfg, unroll=unroll,
                             sharding=sharding)
    return build_decode(cfg, shape, mesh, mesh_cfg, unroll=unroll,
                        sharding=sharding)


# ---------------------------------------------------------------------------
# the meter: flops, bytes accessed, live storages
# ---------------------------------------------------------------------------

def _sig(a):
    """What of an argument decides an elementwise op's result dtype."""
    if isinstance(a, torch.Tensor):
        return (a.dtype, a.dim() == 0)
    if isinstance(a, (list, tuple)):
        return tuple(map(_sig, a))
    if a is None or isinstance(a, (bool, str, torch.dtype)):
        return a
    return type(a)


def _one(a):
    """A one-element CPU stand-in of a tensor argument, of its rank."""
    if isinstance(a, torch.Tensor):
        return torch.ones((1,) * a.dim(), dtype=a.dtype)
    return a


def _tensors(args, kwargs) -> list:
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out += [t for t in a if isinstance(t, torch.Tensor)]
    for v in kwargs.values():
        if isinstance(v, torch.Tensor):
            out.append(v)
    return out


def _broadcast(shapes) -> list:
    n = max(map(len, shapes))
    out = [1] * n
    for s in shapes:
        for i, d in enumerate(s, n - len(s)):
            if d != 1:
                out[i] = d
    return out


_POINTWISE, _REDUCTION = torch.Tag.pointwise, torch.Tag.reduction
_aten = torch.ops.aten
_SOFTMAX = (_aten._softmax.default, _aten._log_softmax.default)
_SOFTMAX_BWD = (_aten._softmax_backward_data.default,
                _aten._log_softmax_backward_data.default)
_ARANGE = (_aten.arange.default, _aten.arange.start,
           _aten.arange.start_step)


def _arange_out(args, kwargs):
    """``arange``'s output on meta, or None elsewhere."""
    if kwargs.get("device") != META:
        return None
    start, end, step = ((0, args[0], 1) if len(args) == 1
                        else (*args, 1)[:3])
    dt = kwargs.get("dtype") or (
        torch.int64 if all(isinstance(v, int) for v in (start, end, step))
        else torch.get_default_dtype())
    n = max(0, math.ceil((end - start) / step))
    return torch.empty((n,), dtype=dt, device=META)


def _like(t, dtype=None, memory_format=torch.preserve_format):
    """``torch.empty_like`` on meta; under ``preserve_format`` a
    contiguous ``t``'s strides are kept directly (torch's ``empty_like``
    on meta runs as a Python reference)."""
    if memory_format is torch.preserve_format and t.is_contiguous():
        return torch.empty_strided(t.shape, t.stride(),
                                   dtype=dtype or t.dtype, device=META)
    return torch.empty_like(t, dtype=dtype, memory_format=memory_format)


def _matmul_out(func, args):
    """mm, bmm and addmm's output on meta."""
    if func is _aten.addmm.default:
        args = args[1:]
    a, b = args[0], args[1]
    return torch.empty((*a.shape[:-1], b.shape[-1]), dtype=a.dtype,
                       device=META)


def _cat_format(ts) -> torch.memory_format:
    """``cat``'s output layout: the inputs' when all of them are laid out
    channels-last (4-D) or channels-last-3d (5-D), else contiguous."""
    for fmt, nd in ((torch.channels_last, 4), (torch.channels_last_3d, 5)):
        if all(t.dim() == nd and t.is_contiguous(memory_format=fmt)
               and not t.is_contiguous() for t in ts):
            return fmt
    return torch.contiguous_format


_MATMUL = (_aten.mm.default, _aten.bmm.default, _aten.addmm.default)
# untagged ops whose output has the broadcast shape of their tensors
_SHAPED = (_aten.floor_divide.default, _aten.full_like.default)


class Meter(TorchDispatchMode):
    """Counts what a program dispatches: ``flops`` (the registry of
    ``torch.utils.flop_counter``), ``bytes_accessed`` (operand and result
    bytes of every op that is not a view), ``n_ops``, and ``live`` /
    ``peak`` bytes of the storages allocated inside it, each released
    when its last reference goes. On ``meta`` tensors (``fast_meta``) it
    makes the outputs of elementwise ops, reductions, softmax, ``clone``
    and ``cat`` itself (see the module docstring)."""

    def __init__(self, fast_meta: bool = True):
        super().__init__()
        self.fast_meta = fast_meta
        self.flops = 0
        self.bytes_accessed = 0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, tuple] = {}    # id(storage) -> (bytes, ref)
        self._dtypes: dict = {}

    # -- meta outputs --------------------------------------------------------

    def _dtype(self, func, args, kwargs):
        key = (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
        dt = self._dtypes.get(key)
        if dt is None:
            dt = self._dtypes[key] = func(
                *map(_one, args), **{k: _one(v) for k, v in kwargs.items()}
            ).dtype
        return dt

    def _meta_out(self, func, args, kwargs, ts):
        if func in _MATMUL:
            return _matmul_out(func, args)
        if func is _aten._to_copy.default:
            if kwargs.get("device", META) != META:
                return None
            x = args[0]
            return _like(x, kwargs.get("dtype"),
                         kwargs.get("memory_format", torch.preserve_format))
        if func is _aten.slice_backward.default:
            return torch.empty(args[1], dtype=args[0].dtype, device=META)
        if func in _SOFTMAX:
            x, _, half_to_float = args
            dt = torch.float32 if half_to_float else x.dtype
            return torch.empty(x.shape, dtype=dt, device=META)
        if func in _SOFTMAX_BWD:
            return torch.empty(args[0].shape, dtype=args[3], device=META)
        if func is _aten.clone.default:
            return _like(args[0], memory_format=kwargs.get(
                "memory_format", torch.preserve_format))
        if func is _aten.cat.default:
            ts = [t for t in args[0] if t.dim() > 0 or t.numel() != 0]
            d = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) \
                % ts[0].dim()
            shape = list(ts[0].shape)
            shape[d] = sum(t.shape[d] for t in ts)
            dt = ts[0].dtype
            for t in ts[1:]:
                dt = torch.promote_types(dt, t.dtype)
            return torch.empty(shape, dtype=dt, device=META,
                               memory_format=_cat_format(ts))
        tags = func.tags
        point = _POINTWISE in tags or func in _SHAPED
        if not (point or _REDUCTION in tags) \
                or len(func._schema.returns) != 1:
            return None
        if func._schema.name.endswith("_"):         # in place
            return args[0] if point else None
        if func._schema.is_mutable:
            return None
        dt = self._dtype(func, args, kwargs)
        if point:
            shape = _broadcast([t.shape for t in ts])
            for t in ts:        # the layout of the first full-size operand
                if list(t.shape) == shape:
                    return _like(t, dt)
        else:
            x = args[0]
            bound = dict(zip((a.name for a in func._schema.arguments), args))
            bound.update(kwargs)
            dims = bound.get("dim")
            if dims is None or (isinstance(dims, (list, tuple))
                                and not dims):
                dims = range(x.dim())
            elif isinstance(dims, int):
                dims = (dims,)
            dims = {d % max(x.dim(), 1) for d in dims}
            keep = bound.get("keepdim", False)
            shape = [1 if i in dims else n for i, n in enumerate(x.shape)
                     if keep or i not in dims]
        return torch.empty(shape, dtype=dt, device=META)

    # -- live storages -------------------------------------------------------

    def _track(self, outs, ts):
        """Count the storages ``outs`` hold that no input holds and that
        are not counted already; each is released (``live`` drops) when
        its storage is freed."""
        inputs = None
        for t in outs:
            s = t.untyped_storage()
            key = id(s)
            if key in self._sizes:
                continue
            if inputs is None:
                inputs = {id(t.untyped_storage()) for t in ts}
            if key in inputs:
                continue
            n = s.nbytes()
            self._sizes[key] = (n, weakref.ref(s, partial(self._release,
                                                          key)))
            self.live += n
            self.peak = max(self.peak, self.live)

    def _release(self, key: int, _ref):
        self.live -= self._sizes.pop(key)[0]

    # -- the mode ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ts = _tensors(args, kwargs)
        out = None
        if self.fast_meta:
            if not ts:
                if func in _ARANGE:
                    out = _arange_out(args, kwargs)
            elif all(t.is_meta for t in ts):
                out = self._meta_out(func, args, kwargs, ts)
        if out is None:
            out = func(*args, **kwargs)
        self.n_ops += 1
        if func.is_view:
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        outs = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(t, torch.Tensor)]
        self.bytes_accessed += sum(t.numel() * t.element_size()
                                   for t in (*ts, *outs))
        self._track(outs, ts)
        return out


# ---------------------------------------------------------------------------
# measure (the port's lower + compile)
# ---------------------------------------------------------------------------

def _leaves(args, shardings):
    """(tensor, sharding) pairs of an argument tree and its shardings
    (None: every leaf's None): a ``Model`` pairs by parameter name, dicts
    by key, sequences by position; None and host values are skipped."""
    def sub(key):
        return None if shardings is None else shardings[key]
    if isinstance(args, torch.Tensor):
        yield args, shardings
    elif hasattr(args, "named_parameters"):
        for name, t in args.named_parameters():
            yield t, sub(name)
    elif isinstance(args, dict):
        for k, v in args.items():
            yield from _leaves(v, sub(k))
    elif isinstance(args, (list, tuple)):
        for i, a in enumerate(args):
            yield from _leaves(a, sub(i))


def _device_bytes(t: torch.Tensor, sh) -> int:
    """Bytes of ``t`` one device stores under ``sh`` (None: all of them):
    each dim cut over the axes its spec entry names (rounded up), and a
    stage-owned leaf spread over the stage axis."""
    if sh is None:
        return t.numel() * t.element_size()
    spec = tuple(sh.spec) + (None,) * (t.dim() - len(sh.spec))
    n = t.element_size()
    for size, entry in zip(t.shape, spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= -(-size // math.prod(sh.mesh.axis_size(a) for a in axes))
    if isinstance(sh, StageSharding):
        n /= sh.mesh.axis_size(sh.stage_axis)
    return n


def argument_bytes(args, shardings) -> int:
    """Per-device argument bytes of a program (the reference's
    ``memory_analysis().argument_size_in_bytes``)."""
    return int(sum(_device_bytes(t, sh) for t, sh in _leaves(args,
                                                               shardings)))


def measure(fn, args, in_sh, *, n_devices: int) -> dict[str, Any]:
    """Run ``fn(*args)`` once under the meter and the collectives'
    counter; the record mirrors ``lower_compile``'s (see the module
    docstring). ``in_sh`` None: every argument whole on each device."""
    t0 = time.perf_counter()
    with CollectiveCounter() as cc, Meter() as m:
        out = fn(*args)
        del out
    seconds = time.perf_counter() - t0
    return {
        "measure_s": round(seconds, 3),
        "memory_analysis": {
            "argument_size_in_bytes": float(argument_bytes(args, in_sh)),
            "peak_live_bytes": float(m.peak)},
        "cost_analysis": {
            "flops": m.flops / n_devices,
            "flops_total": float(m.flops),
            "bytes accessed": m.bytes_accessed / n_devices,
            "bytes_accessed_total": float(m.bytes_accessed)},
        "collectives": collective_bytes(cc.records),
        "n_ops": m.n_ops,
    }


def _reduced_cfg(cfg: ModelConfig, nb: int) -> ModelConfig:
    return dataclasses.replace(
        cfg, n_layers=cfg.first_k_dense + nb * cfg.block_pattern)


def _extrapolate(c11, c21, c12, NB: int, A: int, keys=("flops",)):
    """Affine extrapolation of numeric dicts (see module docstring)."""
    out = {}
    for k in keys:
        a = c11.get(k, 0.0)
        dL = c21.get(k, 0.0) - a
        dA = (c12.get(k, 0.0) - a) if c12 else 0.0
        out[k] = a + (A - 1) * dA + A * (NB - 1) * dL
    return out


def calibrate(cfg: ModelConfig, shape: ShapeConfig, mesh,
              mesh_cfg: MeshConfig, *, microbatch=0, remat=None,
              sharding="default", full: dict | None = None
              ) -> dict[str, Any]:
    """The full program's direct count (``full``, measured here unless
    given) beside the reference's extrapolation from the unrolled
    (nb, A) = (1, 1), (2, 1) and (1, 2) programs, and their differences
    (``check``: extrapolated minus direct, 0 when the program is affine
    in both trip counts, as it is)."""
    run = specs_mod.make_run(cfg, shape, mesh_cfg, microbatch=microbatch)
    mb = run.resolved_microbatch()
    A_full = run.grad_accum_steps
    NB_full = cfg.n_scan_blocks

    def one(c: ModelConfig, A: int):
        if shape.kind == "train":
            sh = dataclasses.replace(shape, global_batch=mb * A)
            fn, args, in_sh, _ = build_train(c, sh, mesh, mesh_cfg,
                                             microbatch=mb, remat=remat,
                                             sharding=sharding)
        else:
            fn, args, in_sh, _ = build_cell(c, shape, mesh, mesh_cfg,
                                            sharding=sharding)
        return measure(fn, args, in_sh, n_devices=mesh.size)

    if full is None:
        full = one(cfg, A_full)
    r11 = one(_reduced_cfg(cfg, 1), 1)
    r21 = one(_reduced_cfg(cfg, 2), 1)
    r12 = one(_reduced_cfg(cfg, 1), 2) \
        if (shape.kind == "train" and A_full > 1) else None

    keys = ("flops", "bytes accessed")
    c12 = r12["cost_analysis"] if r12 else None
    cost = _extrapolate(r11["cost_analysis"], r21["cost_analysis"], c12,
                        NB_full, A_full, keys)
    col11, col21 = r11["collectives"], r21["collectives"]
    ckeys = tuple(set(col11) | set(col21) | set(full["collectives"]))
    coll = _extrapolate(col11, col21, r12["collectives"] if r12 else {},
                        NB_full, A_full, ckeys)
    direct = {**{k: full["cost_analysis"][k] for k in keys},
              **{k: full["collectives"].get(k, 0.0) for k in ckeys}}
    got = {**cost, **coll}
    return {
        "microbatch": mb, "grad_accum": A_full, "scan_blocks": NB_full,
        "flops_per_device": full["cost_analysis"]["flops"],
        "hbm_bytes_per_device": full["cost_analysis"]["bytes accessed"],
        "collective_bytes_per_device": full["collectives"],
        "extrapolated": got,
        "check": {k: got[k] - direct[k] for k in got},
        "variants": {"nb1_a1": r11, "nb2_a1": r21,
                     **({"nb1_a2": r12} if r12 else {})},
    }


# ---------------------------------------------------------------------------
# running a cell
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             do_calibrate: bool = True, out_dir: str = "results/dryrun_torch",
             variant: str = "base") -> dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    v = dict(VARIANTS[variant])
    cfg = dataclasses.replace(cfg, **v.pop("model", {}))
    mb = v.pop("microbatch", 0)
    if mb == "full":
        mb = shape.global_batch
    remat = v.pop("remat", None)
    sharding = v.pop("sharding", "default")
    pipeline = v.pop("pipeline", False)
    mesh_name = "multipod" if multi_pod else "singlepod"
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "variant": variant}
    runnable, why = cell_status(cfg, shape)
    if not runnable:
        rec.update(status="skip", reason=why)
        return _emit(rec, out_dir)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=META)
        mesh_cfg = mesh_config(multi_pod=multi_pod)
        if pipeline:
            if not (multi_pod and shape.kind == "train"):
                raise ValueError("pp_pod variant: multipod train cells only")
            fn, args, in_sh, run = build_train_pp(cfg, shape, mesh,
                                                  mesh_cfg)
        else:
            fn, args, in_sh, run = build_cell(cfg, shape, mesh, mesh_cfg,
                                              microbatch=mb, remat=remat,
                                              sharding=sharding)
        rec["full"] = measure(fn, args, in_sh, n_devices=mesh.size)
        if run is not None:
            rec["microbatch"] = run.resolved_microbatch()
            rec["grad_accum"] = run.grad_accum_steps
        if do_calibrate and not multi_pod:
            rec["calibration"] = calibrate(
                cfg, shape, mesh, mesh_cfg, microbatch=mb, remat=remat,
                sharding=sharding, full=rec["full"])
        rec["status"] = "ok"
    except Exception:
        rec["status"] = "fail"
        rec["error"] = traceback.format_exc()[-4000:]
    return _emit(rec, out_dir)


def _emit(rec, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if rec.get("variant", "base") == "base" \
        else f"__{rec['variant']}"
    path = os.path.join(
        out_dir,
        f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec["status"]
    extra = ""
    if status == "ok":
        ca = rec["full"]["cost_analysis"]
        extra = (f" flops/dev={ca['flops']:.3e}"
                 f" measure={rec['full']['measure_s']}s")
    elif status == "fail":
        extra = " " + rec["error"].strip().splitlines()[-1]
    print(f"[dryrun] {rec['arch']} × {rec['shape']} × {rec['mesh']}:"
          f" {status}{extra}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="arch id or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--variant", default="base", choices=sorted(VARIANTS))
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multipod]
    n_fail = 0
    for arch in archs:
        for s in shapes:
            for mp in meshes:
                rec = run_cell(arch, s, multi_pod=mp,
                               do_calibrate=not args.no_calibrate,
                               out_dir=args.out_dir, variant=args.variant)
                n_fail += rec["status"] == "fail"
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
