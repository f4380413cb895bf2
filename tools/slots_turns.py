#!/usr/bin/env python3
"""Measure the bucket-slot kernel on one CUDA card.

    python tools/slots_turns.py [--sass DIR] [--ablate] [--trace]
                                [--parent OLD_BUCKET_SLOTS_CU]

At the smoke's two full-width shapes (``chip_smoke.slots_inputs``:
deepseek-v2-lite's routing of one served batch, T = 98,304 ids over E =
64 experts; one segment's owner window, T = 2**20 ids over E = P = 8):

  * always: this checkout's kernel (``bucket_slots``) held bit for bit
    to ``bucket_slots_ref`` on the smoke's ``SLOTS_MATRIX`` and
    ``SLOTS_LOOKBACK`` and at both shapes; its time a call by CUDA events
    back to back and by the profiler's device time (``chip_smoke.
    _event_ms`` and ``_device_ms``), so events less device is the host's
    share, and the device activities a call by name; ptxas's registers
    and shared memory of every kernel built;
  * the launch floor: the empty kernel of ``tools/launch_floor.cu``,
    built by the port's backend and launched through ctypes as a wrapper
    launches its kernel, at one CTA and at the kernel's grid of each
    shape (``ops.plan``'s tiles, a CTA of ``ops.THREADS``), by events and
    by device time; and the host's cost of a wrapper's steps (the kernel
    policy, ``torch.empty``, the current stream, the ctypes launch of the
    empty kernel, the whole wrapper), by the host clock, enqueue only;
  * ``--parent``: another ``bucket_slots.cu`` with the three-pass C
    entry point (``bucket_slots_launch(ids, T, E, slots, counts,
    blk_cnt, blk_off, stream)``), e.g. ``git show <commit>:src/
    repro_torch/kernels/moe_dispatch/csrc/bucket_slots.cu``, called step
    for step as its wrapper called it (capability read, zeroed counts,
    two (ceil(T / 1024), E) scratch arrays), held to the plain version
    and timed in turns with this checkout's (parent, change, change,
    parent);
  * ``--ablate``: the variants of ``tools/slots_ablations.cu`` (the
    first design's kernel cut down stage by stage: streaming only, + the
    rank, the whole kernel; ballots in place of ``__match_any_sync``, a
    back-off in the look-back's wait, the unpublished words of a round
    re-read together, 4 or 16 ids a thread), device time at both
    shapes, the whole ones held to the plain version;
  * ``--trace``: this checkout's kernel at each of its ids a thread
    (``ops.ITEMS``, through its C entry point), device time at both
    shapes, and a copy built with ``BUCKET_SLOTS_TRACE`` set, whose CTAs
    write the device's and their SM's clocks at their start, rank,
    publish, look-back and end: per stage the median and the largest
    time over CTAs; then the same for copies of the source with the
    status words' loads and stores changed (``MEMORY_VARIANTS``), at
    the ids a thread the wrapper picks;
  * ``--sass DIR``: ``cuobjdump -sass`` of each built library, written
    into DIR.

Prints one JSON line of the numbers, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

FLOOR = ROOT / "tools" / "launch_floor.cu"
ABLATIONS = ROOT / "tools" / "slots_ablations.cu"
VARIANTS = ("stream", "rank (match)", "rank (ballot)", "whole (match)",
            "whole (ballot)", "whole (ballot, back-off)",
            "whole (ballot, 16 ids a thread)",
            "whole (match, re-read together)",
            "whole (match, re-read together, 16 ids a thread)",
            "whole (match, re-read together, 4 ids a thread)")
PARENT_BLOCK = 1024          # ids (and threads) of a CTA of the three passes
ITERS = 200


def ptxas(built) -> list[str]:
    """The register, shared-memory and spill lines of an nvcc log."""
    return [ln.strip() for ln in built.log.splitlines()
            if "registers" in ln or "smem" in ln or "spill" in ln
            or "Compiling entry" in ln]


def parent_slots(source: Path):
    """The three-pass kernel of ``source`` behind a replica of its
    wrapper, as a call ``fn(ids, E) -> (slots, counts)``."""
    backend = cs._port()[2]
    c = ctypes.CDLL(str(backend.build(source).path)).bucket_slots_launch
    c.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + \
        [ctypes.c_void_p] * 5
    c.restype = ctypes.c_int

    def fn(eids, E):
        if eids.dim() != 1 or eids.dtype != torch.int32:
            raise TypeError("eids must be (T,) int32")
        if torch.cuda.get_device_capability(eids.device) != (9, 0):
            raise RuntimeError("the kernels are built for sm_90a")
        T = eids.numel()
        slots = torch.empty_like(eids)
        counts = torch.zeros((E,), dtype=torch.int32, device=eids.device)
        nb = -(-T // PARENT_BLOCK)
        blk_cnt = torch.empty((nb, E), dtype=torch.int32, device=eids.device)
        blk_off = torch.empty_like(blk_cnt)
        stream = torch.cuda.current_stream(eids.device).cuda_stream
        rc = c(eids.data_ptr(), T, E, slots.data_ptr(), counts.data_ptr(),
               blk_cnt.data_ptr(), blk_off.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"parent bucket_slots failed: CUDA error {rc}")
        return slots, counts
    return fn


def floor_launcher():
    """The empty kernel's launch, ``fn(blocks, threads)``."""
    backend = cs._port()[2]
    c = ctypes.CDLL(str(backend.build(FLOOR).path)).empty_launch
    c.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    c.restype = ctypes.c_int

    def fn(blocks, threads):
        rc = c(blocks, threads, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty_launch failed: CUDA error {rc}")
    return fn


def ablation(variant: int):
    """Variant ``variant`` of ``tools/slots_ablations.cu`` as a call
    ``fn(ids, E) -> (slots, counts)`` with a scratch of its own."""
    backend = cs._port()[2]
    lib = ctypes.CDLL(str(backend.build(ABLATIONS).path))
    c = lib.slots_ablate_launch
    c.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_int] + [ctypes.c_void_p] * 4
    c.restype = ctypes.c_int
    tile = lib.slots_ablate_tile(variant)
    held = {}

    def fn(ids, E):
        T = ids.numel()
        words = 1 + -(-T // tile) * E
        if held.get("n", 0) < words:
            held.update(n=words, scratch=torch.zeros(
                words, dtype=torch.int64, device=ids.device))
        slots = torch.empty_like(ids)
        counts = torch.empty(E, dtype=torch.int32, device=ids.device)
        rc = c(variant, ids.data_ptr(), T, E, slots.data_ptr(),
               counts.data_ptr(), held["scratch"].data_ptr(),
               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"slots_ablate_launch failed: CUDA error {rc}")
        return slots, counts
    return fn


TRACE_POINTS = 11
STAGES = ("start", "rank", "publish", "look-back", "end")   # the stamps


def trace_stats(set_trace, fn, ids, E, tiles: int) -> dict:
    """One call of ``fn`` after a warm-up, its CTAs' stamps written where
    ``set_trace`` points them: per stage, the median and the largest time
    after the first CTA's start (device clock, µs) and the median and
    largest cycles since the CTA's own start; the SMs used and the most
    CTAs an SM ran."""
    buf = torch.zeros(tiles * TRACE_POINTS, dtype=torch.int64,
                      device=ids.device)
    set_trace.argtypes = [ctypes.c_void_p]
    if set_trace(buf.data_ptr()) != 0:
        raise RuntimeError("setting the trace buffer failed")
    fn(ids, E)
    check(fn, ids, E, "traced")
    torch.cuda.synchronize()
    t = buf.view(tiles, TRACE_POINTS).cpu().double()
    ns, cycles = t[:, :5] - t[:, :1].min(), t[:, 6:] - t[:, 6:7]
    out = {"ctas": tiles, "sms": int(t[:, 5].unique().numel()),
           "most_ctas_an_sm": int(torch.bincount(t[:, 5].long()).max())}
    for i, stage in enumerate(STAGES):
        out[stage] = {"us_median": float(ns[:, i].median()) / 1e3,
                      "us_max": float(ns[:, i].max()) / 1e3,
                      "cycles_median": float(cycles[:, i].median()),
                      "cycles_max": float(cycles[:, i].max())}
    return out


def print_trace(what: str, tr: dict):
    print(f"  {what}: {tr['ctas']} CTAs on {tr['sms']} SMs, at most "
          f"{tr['most_ctas_an_sm']} an SM")
    for stage in STAGES:
        x = tr[stage]
        print(f"    {stage}: {x['us_median']:.3f} / {x['us_max']:.3f} us "
              f"after the first start (median / max); "
              f"{x['cycles_median']:.0f} / {x['cycles_max']:.0f} cycles "
              f"after the CTA's own start")


def at_items(items: int, lib=None):
    """This checkout's kernel through its C entry point (``lib``'s: the
    traced copy) at ``items`` ids a thread, as ``fn(ids, E)``, with a
    scratch of its own."""
    ops = cs._slots()[0]
    if lib is None:
        c = ops._launcher()
    else:
        c = lib.bucket_slots_launch
        c.argtypes = ops._launcher().argtypes
        c.restype = ctypes.c_int
    held = {}

    def fn(ids, E):
        T = ids.numel()
        words = 1 + -(-T // (ops.THREADS * items)) * E
        if held.get("n", 0) < words:
            held.update(n=words, scratch=torch.zeros(
                words, dtype=torch.int64, device=ids.device))
        slots = torch.empty_like(ids)
        counts = torch.empty(E, dtype=torch.int32, device=ids.device)
        rc = c(ids.data_ptr(), T, E, items, slots.data_ptr(),
               counts.data_ptr(), held["scratch"].data_ptr(),
               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"bucket_slots_launch failed: CUDA error {rc}")
        return slots, counts
    return fn


LOAD = 'asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"'
STORE = ('asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), '
         '"l"(v)\n               : "memory");')
# copies of the kernel source with the status words' memory operations
# changed: (text of the source, its replacement) pairs
MEMORY_VARIANTS = {
    "fence after each publish": [(STORE, STORE + "\n  __threadfence();")],
    "release stores, acquire loads": [
        (LOAD, LOAD.replace("relaxed", "acquire")),
        (STORE, STORE.replace("relaxed", "release"))],
    "L2-cached loads and stores (.cg)": [
        (LOAD, LOAD.replace("relaxed.gpu.global", "global.cg")),
        (STORE, STORE.replace("relaxed.gpu.global", "global.cg"))],
}


def traced_library(name: str = "traced", changes=()):
    """A copy of this checkout's kernel source with BUCKET_SLOTS_TRACE set
    and ``changes`` made, built like the port's kernels under their build
    directory (untraced too when ``name`` is not "traced")."""
    backend, ops = cs._port()[2], cs._slots()[0]
    backend.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = ops.SOURCE.read_text()
    for old, new in changes:
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {ops.SOURCE.name}")
        text = text.replace(old, new)
    libs = {}
    for traced in (True, False):
        stem = "".join(ch if ch.isalnum() else "_" for ch in name)
        src = backend.BUILD_DIR / f"bucket_slots_{stem}_{int(traced)}.cu"
        src.write_text(("#define BUCKET_SLOTS_TRACE 1\n" if traced else "")
                       + text)
        libs[traced] = ctypes.CDLL(str(backend.build(src).path))
    return libs


def host_us(fn, n: int = 5000) -> float:
    """Host microseconds a call of ``fn``, enqueue only (one sync after
    the whole run, outside the clock)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def sass(so: Path, outdir: Path) -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    text = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"),
                           "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = outdir / f"sass_{so.stem}.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return str(out)


def check(fn, ids, E, what):
    got = fn(ids, E)
    want = cs._slots()[1].bucket_slots_ref(ids, E)
    for g, w, name in zip(got, want, ("slots", "counts")):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: {name} != bucket_slots_ref (max "
                                 f"abs {cs._int_diff(g, w)})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a three-pass "
                    "bucket_slots.cu to time in turns with this checkout's")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--sass", type=Path, metavar="DIR",
                    help="write each library's SASS into DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("slots_turns: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    backend = cs._port()[2]
    ops = cs._slots()[0]
    res: dict = {"ptxas": {}}
    sources = {"change": ops.SOURCE, "floor": FLOOR}
    if args.parent:
        sources["parent"] = args.parent
    if args.ablate:
        sources["ablations"] = ABLATIONS
    for name, src in sources.items():
        b = backend.build(src)
        res["ptxas"][name] = ptxas(b)
        print(f"build {name}: {src.name} {b.seconds:.1f} s")
        for ln in res["ptxas"][name]:
            print(f"  ptxas: {ln}")
        if args.sass:
            res.setdefault("sass", {})[name] = sass(b.path, args.sass)

    fns = {"change": ops.bucket_slots}
    if args.parent:
        fns = {"parent": parent_slots(args.parent), **fns}
    matrix = {**cs.SLOTS_MATRIX, **cs.SLOTS_LOOKBACK}
    for case_name, case in matrix.items():
        ids = torch.from_numpy(cs.slot_ids(case)).to(device)
        for name, fn in fns.items():
            check(fn, ids, case[1], f"{name} {case_name}")
    print(f"== bucket_slots_ref on every SLOTS_MATRIX and SLOTS_LOOKBACK "
          f"case ({len(matrix)}): {', '.join(fns)}")

    floor = floor_launcher()
    source = cs.job_input(cs.N_TOKENS)[0]
    w = cs.FULL
    tokens = torch.from_numpy(source.read(0, w.n_procs * w.segment * w.task))
    for shape, (ids, E) in cs.slots_inputs(device, tokens.to(device)).items():
        T = ids.numel()
        for name, fn in fns.items():
            check(fn, ids, E, f"{name} {shape}")
        calls = {n: (lambda f=f: f(ids, E)) for n, f in fns.items()}
        grid = (ops.plan(T, ops.sm_count(device))[1], ops.THREADS)
        calls["floor_1cta"] = lambda: floor(1, 32)
        calls["floor_grid"] = lambda g=grid: floor(*g)
        ev = cs._in_turns(calls, lambda f: cs._event_ms(f, ITERS))
        dv = cs._in_turns(calls, lambda f: cs._device_ms(f, ITERS)[0])
        acts = {n: cs._device_ms(f, 20)[1:] for n, f in calls.items()}
        bound = cs.slots_bound(T, E)
        r = res[shape] = {
            "T": T, "E": E, "grid": grid, "bound_ms": bound[0],
            "bound_by": bound[1], "event_ms": ev, "device_ms": dv,
            "host_ms": {n: ev[n] - dv[n] for n in calls},
            "device_activities": {n: a[0] for n, a in acts.items()},
            "device_activities_per_call": {n: a[1] for n, a in acts.items()}}
        print(f"{shape} (T {T}, E {E}): == plain; bound {bound[0]:.6f} ms "
              f"({bound[1]})")
        for n in calls:
            print(f"  {n}: events {ev[n]:.5f} ms, device {dv[n]:.5f} ms, "
                  f"host share {r['host_ms'][n]:.5f} ms; "
                  f"{r['device_activities_per_call'][n]:.2f} device "
                  f"activities a call {r['device_activities'][n]}")
        if args.ablate:
            abl = r["ablate_device_ms"] = {}
            for v, label in enumerate(VARIANTS):
                f = ablation(v)
                if label.startswith("whole"):
                    check(f, ids, E, f"ablation {label} {shape}")
                abl[label] = cs._device_ms(lambda f=f: f(ids, E), ITERS)[0]
            print("  ablations (device ms): " + ", ".join(
                f"{k} {v:.5f}" for k, v in abl.items()))
            lib = ctypes.CDLL(str(backend.build(ABLATIONS).path))
            r["ablate_trace"] = trace_stats(
                lib.slots_ablate_set_trace, ablation(10), ids, E,
                -(-T // lib.slots_ablate_tile(10)))
            print_trace("the first design traced (variant 10, one call)",
                        r["ablate_trace"])
        if args.trace:
            lib = traced_library()[True]
            for items in ops.ITEMS:
                f = at_items(items)
                check(f, ids, E, f"{items} ids a thread")
                dev = cs._device_ms(lambda f=f: f(ids, E), ITERS)[0]
                tiles = -(-T // (ops.THREADS * items))
                tr = trace_stats(lib.bucket_slots_set_trace,
                                 at_items(items, lib), ids, E, tiles)
                r.setdefault("items", {})[items] = {"device_ms": dev,
                                                    "trace": tr}
                print_trace(f"{items} ids a thread: device {dev:.5f} ms; "
                            f"traced", tr)
            items, tiles = ops.plan(T, ops.sm_count(device))
            for name, changes in MEMORY_VARIANTS.items():
                libs = traced_library(name, changes)
                f = at_items(items, libs[False])
                check(f, ids, E, name)
                dev = cs._device_ms(lambda f=f: f(ids, E), ITERS)[0]
                tr = trace_stats(libs[True].bucket_slots_set_trace,
                                 at_items(items, libs[True]), ids, E, tiles)
                r.setdefault("memory_variants", {})[name] = {
                    "device_ms": dev, "trace": tr}
                print_trace(f"{name}, {items} ids a thread: device "
                            f"{dev:.5f} ms; traced", tr)

    inputs = cs.slots_inputs(device, tokens.to(device))
    ids, E = inputs["routing"]
    window, E_window = inputs["owner_window"]
    pieces = {
        "use_kernel": lambda: backend.use_kernel(ids),
        "get_device_capability": lambda: torch.cuda.get_device_capability(
            ids.device),
        "torch.empty_like": lambda: torch.empty_like(ids),
        "torch.empty(T + E).split": lambda: torch.empty(
            ids.numel() + E, dtype=torch.int32, device=ids.device).split(
                (ids.numel(), E)),
        "torch.zeros(E)": lambda: torch.zeros((E,), dtype=torch.int32,
                                              device=ids.device),
        "current_stream": lambda: torch.cuda.current_stream(
            ids.device).cuda_stream,
        "ctypes empty_launch": lambda: floor(1, 32),
        "scratch lookup": lambda: ops._scratch(
            ids.device, torch.cuda.current_stream(ids.device).cuda_stream,
            1 + ops.plan(ids.numel(), ops.sm_count(ids.device))[1] * E),
        **{f"wrapper {n}": (lambda f=f: f(ids, E)) for n, f in fns.items()},
        "torch.empty_like, owner window": lambda: torch.empty_like(window),
        **{f"wrapper {n}, owner window": (lambda f=f: f(window, E_window))
           for n, f in fns.items()}}
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        pieces["raw current stream"] = \
            lambda: torch._C._cuda_getCurrentRawStream(ids.device.index)
    res["host_us"] = {n: host_us(f) for n, f in pieces.items()}
    print("host us a call (routing unless named, enqueue only): " + ", ".join(
        f"{n} {v:.2f}" for n, v in res["host_us"].items()))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res["card"] = smi
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
