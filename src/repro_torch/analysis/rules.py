"""Rule implementations: the port's counterpart of
``repro/analysis/rules.py``.

| rule    | checks                                                          |
|---------|-----------------------------------------------------------------|
| SPMD001 | collectives reduce or exchange over the rank dim                |
| SPMD002 | no collective after a host read of a rank-varying value         |
| REP001  | outputs asserted replicated are equal along the rank dim        |
| PAL001  | a kernel's declared block maps stay in bounds over its grid     |
| PAL002  | integer kernel outputs declare a fitting worst-case count       |
| PAL003  | one device policy (``backend.use_kernel``), no hidden fallback  |

``check_program`` runs SPMD001, SPMD002 and REP001 over one
:class:`~repro_torch.core.registry.ProgramHandle`, on seeded inputs at
its P (``analysis/spmd.py``): they hold for what those inputs exercise,
where the reference's proof over the jaxpr holds for every input.

``check_kernel`` runs PAL001..PAL003 over one :class:`KernelCheck`. A
JAX kernel's block maps are read off its traced ``pallas_call``; a CUDA
kernel computes its own offsets, so here the maps are declared: a
:class:`LaunchSpec` gives the grid and, per operand, the array shape,
the block shape and an affine index map, and the wrapper launches with
that same spec. Kernels that declare no spec are bounded by the card's
memcheck instead (``chip_smoke.py``).
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import functools
import importlib
import inspect
import itertools
import math
import textwrap
from collections.abc import Callable

import torch

from repro_torch.analysis import spmd
from repro_torch.analysis.findings import Finding
from repro_torch.core.registry import leaves
from repro_torch.device import resolve_device

# -- programs (SPMD001 / SPMD002 / REP001) ----------------------------------


def _named(handle, paths: tuple, value, what: str) -> dict:
    got = leaves(value)
    if len(got) != len(paths):
        raise ValueError(
            f"{handle.name}: ran with {len(got)} tensor {what}s but the "
            f"handle names {len(paths)} — handle interface out of sync")
    return dict(zip(paths, got))


def _check_seeded(handle, inputs: dict):
    """The inputs the run made itself: those asserted replicated are, and
    every other one differs across ranks (else REP001 would pass
    vacuously). A breach is the harness's fault, so it raises."""
    for path in handle.seeded:
        x = inputs[path]
        if x.dim() == 0 or x.shape[0] != handle.n_procs:
            raise ValueError(f"{handle.name}: input '{path}' of shape "
                             f"{tuple(x.shape)} has no rank dim of "
                             f"{handle.n_procs}")
        same = spmd.first_differing_rank(x) is None
        if same != (path in handle.replicated_in):
            raise ValueError(
                f"{handle.name}: seeded input '{path}' is "
                f"{'replicated' if same else 'rank-varying'}, the handle "
                f"asserts it {'rank-varying' if same else 'replicated'}")


def run_program(handle, seed: int = 0, watched: bool = True):
    """Drive ``handle.run(seed)``, one program call at a time: yields
    ``(inputs, outputs, watch)`` for each call, the tensors by path and
    the :class:`~repro_torch.analysis.spmd.Watch` that observed the call
    (None when not ``watched``)."""
    run = handle.run(seed)
    step = next(run, None)
    while step is not None:
        fn, args = step
        inputs = _named(handle, handle.arg_paths, args, "argument")
        _check_seeded(handle, inputs)
        watch = spmd.Watch(handle.name, handle.n_procs) if watched else None
        with watch or contextlib.nullcontext():
            out = fn(*args)
        yield inputs, _named(handle, handle.out_paths, out, "output"), watch
        try:
            step = run.send(out)
        except StopIteration:
            step = None


def check_program(handle, seed: int = 0) -> list[Finding]:
    """SPMD001, SPMD002 and REP001 over one ProgramHandle, run on its
    inputs made from ``seed`` on the device it was built for; one
    finding a rule and place. At P < 2 every output is trivially equal
    along the rank dim, so it refuses."""
    if handle.n_procs < 2:
        raise ValueError(f"{handle.name}: the program rules need P >= 2 "
                         f"ranks (got {handle.n_procs}); at P = 1 REP001 "
                         "holds vacuously")
    findings: list[Finding] = []

    def emit(f: Finding):
        if all((g.rule, g.where) != (f.rule, f.where) for g in findings):
            findings.append(f)

    for call, (_, outputs, watch) in enumerate(run_program(handle, seed)):
        for f in watch.findings:
            emit(f)
        for path in handle.replicated_out:
            x = outputs[path]
            if x.dim() == 0 or x.shape[0] != handle.n_procs:
                raise ValueError(f"{handle.name}: output '{path}' of shape "
                                 f"{tuple(x.shape)} has no rank dim of "
                                 f"{handle.n_procs}")
            rank = spmd.first_differing_rank(x)
            if rank is not None:
                emit(Finding(
                    "REP001", handle.name, path,
                    f"output '{path}' is asserted replicated but rank "
                    f"{rank}'s row differs from rank 0's after call "
                    f"{call} (e.g. a dropped psum)"))
    return findings

# -- the declared launch ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockMap:
    """An affine block index map: at grid point ``g`` the block index on
    array dim ``d`` is ``sum_a scale[d][a] * g[a] + shift[d]``."""
    scale: tuple[tuple[int, ...], ...]
    shift: tuple[int, ...]

    def __call__(self, point) -> tuple[int, ...]:
        return tuple(sum(s * g for s, g in zip(row, point, strict=True)) + t
                     for row, t in zip(self.scale, self.shift, strict=True))


@dataclasses.dataclass(frozen=True)
class Operand:
    """One array of a launch: its shape, block shape, index map and dtype;
    ``output`` marks what the kernel writes."""
    name: str
    shape: tuple[int, ...]
    block: tuple[int, ...]
    index: BlockMap
    dtype: torch.dtype
    output: bool = False


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """A kernel's grid and its operands, in argument order."""
    grid: tuple[int, ...]
    operands: tuple[Operand, ...]

    def operand(self, name: str) -> Operand:
        return next(op for op in self.operands if op.name == name)


@dataclasses.dataclass(frozen=True)
class KernelCheck:
    """One kernel entry in the corpus.

    ``build(device)`` returns ``(fn, args, kwargs)``: a representative
    call of the wrapper on tensors on ``device``. ``worst_count`` declares
    the largest value any integer output can legitimately hold (PAL002).
    ``ops_module`` points PAL003 at the wrapper module, and ``spec`` is
    the launch the call declares (PAL001), if it declares one."""
    name: str
    build: Callable = dataclasses.field(compare=False)
    worst_count: int | None = None
    ops_module: str | None = None
    spec: LaunchSpec | None = None


def check_kernel(kc: KernelCheck, device=None) -> list[Finding]:
    """PAL001 on the declared spec first, then PAL002 and PAL003. Only a
    kernel with a spec and no finding is launched, on ``device`` (the
    card unless given): a spec that fails PAL001 never runs. A kernel
    without a spec is not launched; its output dtypes come from its plain
    version on the CPU."""
    device = resolve_device(device)
    findings = check_block_bounds(kc.spec, kc.name) if kc.spec else []
    if kc.spec is not None:
        dtypes = [op.dtype for op in kc.spec.operands if op.output]
    else:
        dtypes = [t.dtype for t in _outputs(_call(kc, "cpu"))]
    findings += check_int_capacity(dtypes, kc)
    if kc.ops_module:
        findings += check_ops_module(
            importlib.import_module(kc.ops_module), kc.name)
    if kc.spec is not None and not findings:
        _call(kc, device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    return findings


def _call(kc: KernelCheck, device):
    fn, args, kwargs = kc.build(torch.device(device))
    return functools.partial(fn, **kwargs)(*args)


def _outputs(out) -> list[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


# -- PAL001 ------------------------------------------------------------------

def _grid_points(grid: tuple) -> list:
    """Every grid point when the grid is small; otherwise the corner/mid
    lattice (index maps are affine, so extremes catch the bugs)."""
    if math.prod(grid) <= 4096:
        return list(itertools.product(*[range(g) for g in grid]))
    axes = [sorted({0, g // 2, g - 1}) for g in grid]
    return list(itertools.product(*axes))


def check_block_bounds(spec: LaunchSpec, program: str) -> list[Finding]:
    """PAL001: evaluate every operand's index map over the grid and
    require each block index to stay inside its array. One finding per
    operand, at the first grid point that leaves it."""
    findings = []
    points = _grid_points(spec.grid)
    for opi, op in enumerate(spec.operands):
        limits = [-(-d // b) for d, b in zip(op.shape, op.block, strict=True)]
        for pt in points:
            idx = op.index(pt)
            oob = [(d, i) for d, (i, lim) in enumerate(zip(idx, limits))
                   if i < 0 or i >= lim]
            if oob:
                d, i = oob[0]
                findings.append(Finding(
                    "PAL001", program, f"operand {op.name}",
                    f"operand {opi}: index map sends grid point "
                    f"{pt} to block index {i} on dim {d} (valid "
                    f"range [0, {limits[d]}) for array dim "
                    f"{op.shape[d]}, block {op.block[d]})"))
                break                      # one finding per operand
    return findings


# -- PAL002 ------------------------------------------------------------------

def check_int_capacity(dtypes, kc: KernelCheck) -> list[Finding]:
    """PAL002: every integer output (``dtypes``, in output order) needs a
    declared worst-case count that fits its dtype: silent wraparound is
    how a 2^31-record count reads as negative."""
    findings = []
    for i, dtype in enumerate(dtypes):
        if dtype.is_floating_point or dtype.is_complex or dtype == torch.bool:
            continue
        name = str(dtype).removeprefix("torch.")
        cap = torch.iinfo(dtype).max
        if kc.worst_count is None:
            findings.append(Finding(
                "PAL002", kc.name, f"output {i}",
                f"integer accumulator ({name}) with no declared "
                "worst-case count — declare KernelCheck.worst_count "
                "or widen the dtype"))
        elif kc.worst_count > cap:
            findings.append(Finding(
                "PAL002", kc.name, f"output {i}",
                f"worst-case count {kc.worst_count} exceeds "
                f"{name} capacity {cap} — accumulator can wrap"))
    return findings


# -- PAL003 ------------------------------------------------------------------

PRIVATE_POLICIES = ("_on_gpu", "_on_cuda")
POLICY_HOME = "repro_torch.device"     # the one place that asks for a card


def _tree(obj) -> ast.AST | None:
    try:
        return ast.parse(textwrap.dedent(inspect.getsource(obj)))
    except (OSError, TypeError):
        return None


def _dotted(node) -> str:
    """``a.b.c`` of a Name/Attribute chain, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _calls(tree) -> list[str]:
    return [_dotted(n.func) for n in ast.walk(tree) if isinstance(n, ast.Call)]


def _is_plain(name: str) -> bool:
    """A call of a kernel's plain version: a name with a ``ref`` or
    ``plain`` part (``fused_step_ref``, ``ref.hist_plain``)."""
    return any(p in ("ref", "plain") for p in
               name.rsplit(".", 1)[-1].split("_"))


def check_ops_module(mod, program: str) -> list[Finding]:
    """PAL003 (policy half): a kernel wrapper module decides kernel or
    plain version through the one shared policy,
    ``repro_torch.kernels.backend.use_kernel``. It defines no private
    policy (``_on_gpu``, ``_on_cuda``), asks ``torch.cuda.is_available``
    nowhere (only ``repro_torch/device.py`` does), and no wrapper hides
    its launch in a ``try`` whose handler calls the plain version."""
    from repro_torch.kernels import backend as shared
    findings = []
    where = getattr(mod, "__name__", str(mod))
    for attr in PRIVATE_POLICIES:
        if getattr(mod, attr, None) is not None:
            findings.append(Finding(
                "PAL003", program, where,
                f"module defines a private {attr} policy; use "
                "repro_torch.kernels.backend.use_kernel"))
    own = {attr: fn for attr, fn in vars(mod).items()
           if callable(fn) and getattr(fn, "__module__", None) == where}
    trees = ([_tree(mod)] if getattr(mod, "__file__", None)
             else [_tree(fn) for fn in own.values()])
    if where != POLICY_HOME and any(
            c.endswith("cuda.is_available")
            for t in trees if t is not None for c in _calls(t)):
        findings.append(Finding(
            "PAL003", program, where,
            "module asks torch.cuda.is_available; the device policy is "
            "repro_torch.kernels.backend.use_kernel (and "
            "repro_torch.device for entry points)"))
    wrappers = []
    for attr, fn in own.items():
        if attr.startswith("_"):
            continue
        try:
            params = inspect.signature(fn).parameters
        except (TypeError, ValueError):
            continue
        if "use_kernel" in params:
            wrappers.append((attr, fn))
            findings += check_wrapper_signature(fn, f"{where}.{attr}",
                                                program)
    for attr, fn in wrappers:
        tree = _tree(fn)
        if tree is None:
            continue
        if "backend.use_kernel" not in _calls(tree):
            findings.append(Finding(
                "PAL003", program, f"{where}.{attr}",
                "wrapper has a use_kernel parameter but does not call "
                "repro_torch.kernels.backend.use_kernel"))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Try):
                continue
            plain = sorted({c for h in node.handlers for c in _calls(h)
                            if _is_plain(c)})
            if plain:
                findings.append(Finding(
                    "PAL003", program, f"{where}.{attr}",
                    f"wrapper falls back to the plain version "
                    f"({', '.join(plain)}) in an except handler; a CUDA "
                    "tensor launches the kernel or raises"))
    if wrappers and getattr(mod, "backend", None) is not shared:
        findings.append(Finding(
            "PAL003", program, where,
            "wrapper has a use_kernel parameter but the module does not "
            "use the shared repro_torch.kernels.backend"))
    return findings


def check_wrapper_signature(fn, where: str, program: str) -> list[Finding]:
    """PAL003 (signature half): ``use_kernel`` defaults to False, so that
    the tensor's device alone picks kernel or plain version and True
    demands the kernel."""
    param = inspect.signature(fn).parameters["use_kernel"]
    if param.default is not False:
        return [Finding(
            "PAL003", program, where,
            f"wrapper defaults use_kernel={param.default!r}; the contract "
            "is use_kernel: bool = False, resolved by backend.use_kernel")]
    return []
