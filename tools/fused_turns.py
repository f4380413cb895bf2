#!/usr/bin/env python3
"""Measure the fused_map kernel on one CUDA card.

    python tools/fused_turns.py [--parent OLD_FUSED_MAP_CU] [--rounds N]

  * always: this checkout's kernel (``fused_map``) held bit for bit to
    its plain version over the smoke's ``fused_matrix()`` and
    ``fused_wide_matrix()`` (``chip_smoke.phase_kernel_vs_plain``), then
    timed at S 4,096 and 16,384 at fig9's width, rep 1 and 8 on the hot
    rank (``chip_smoke.time_fused_wide``);
  * ``--parent``: another ``fused_map.cu`` whose C entry point
    ``fused_map_launch`` takes no scratch (the kernel before task sizes
    past 1,024, e.g. ``git show <commit>:src/repro_torch/kernels/
    fused_map/csrc/fused_map.cu``), built like the port's kernels, held
    bit for bit to this checkout's at phase 3's width (P 8, S 256, cap 64,
    V 262,144, rep 8 and 16 on rank 0) and timed in turns with it
    (parent, change, change, parent; ``--rounds`` times) by the
    profiler's device time and by CUDA events, 200 launches each.

Prints one JSON line of the numbers, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def parent_fused_map(source: Path):
    """The parent's ``fused_map_launch`` (12 pointers, no scratch), built
    like the port's kernels, as a call with ``ops.fused_map``'s
    arguments and its checks that folds into ``table`` and returns the
    four outputs."""
    _, _, backend, ops, _ = cs._port()
    lib = ctypes.CDLL(str(backend.build(source).path))
    rc = lib.fused_map_prepare()
    if rc != 0:
        raise RuntimeError(f"parent fused_map_prepare: CUDA error {rc}")
    c = lib.fused_map_launch
    c.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    c.restype = ctypes.c_int

    def fn(keys, vals, rep, task_id, owner_map, owner_split, pending_k,
           pending_v, table, *, n_procs, cap):
        ops._check(dict(keys=keys, vals=vals, rep=rep, task_id=task_id,
                        owner_map=owner_map, owner_split=owner_split,
                        pending_k=pending_k, pending_v=pending_v,
                        table=table), n_procs, cap)
        P, S = keys.shape
        bk = torch.empty((P, P, cap), dtype=torch.int32, device=keys.device)
        bv = torch.empty_like(bk)
        counts = torch.empty((P, P), dtype=torch.int32, device=keys.device)
        rc = c(*(t.data_ptr() for t in (keys, vals, rep, task_id, owner_map,
                                         owner_split, pending_k, pending_v,
                                         table, bk, bv, counts)),
               P, S, table.shape[-1], cap,
               torch.cuda.current_stream(keys.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent fused_map launch: CUDA error {rc}")
        return table, bk, bv, counts
    return fn


def turns(fns: dict, measure, rounds: int) -> dict:
    """``measure(fn)`` of each of ``fns`` in turns, forward then backward,
    ``rounds`` times: each name's mean, least and most."""
    got = {n: [] for n in fns}
    for _ in range(rounds):
        for n in list(fns) + list(fns)[::-1]:
            got[n].append(measure(fns[n]))
    return {n: {"mean": sum(v) / len(v), "min": min(v), "max": max(v)}
            for n, v in got.items()}


def against_parent(device, parent: Path, rounds: int) -> dict:
    """This checkout's kernel against the parent's at phase 3's width, at
    rep 8 and 16 on the hot rank: outputs bit-equal, then in turns."""
    _, _, _, ops, _ = cs._port()
    fns = {"parent": parent_fused_map(parent), "change": ops.fused_map}
    out = {}
    for rep0 in (8, 16):
        args, P, cap = cs.fused_case(16, cs.N_PROCS, cs.TASK, cs.VOCAB,
                                     cs.CAP, [rep0] + [1] * (cs.N_PROCS - 1))
        a = cs._on(args, device)
        got = {}
        for name, fn in fns.items():
            b = {**a, "table": a["table"].clone()}
            got[name] = fn(**b, n_procs=P, cap=cap)
        for what, x, y in zip(("table", "bk", "bv", "counts"),
                              got["parent"], got["change"]):
            if not torch.equal(x, y):
                raise AssertionError(f"rep {rep0}: {what} differs from the "
                                     f"parent's")
        calls = {n: (lambda f=f: f(**a, n_procs=P, cap=cap))
                 for n, f in fns.items()}
        out[f"rep{rep0}"] = {
            "device_ms": turns(calls, lambda f: cs._device_ms(f, 200)[0],
                               rounds),
            "event_ms": turns(calls, lambda f: cs._event_ms(f, 200),
                              rounds)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="an older fused_map.cu to time in turns")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_turns: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    built = cs._port()[2].build(cs._port()[3].SOURCE)
    for line in built.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"ptxas: {line.strip()}")
    res = {"matrix_max_abs_err": cs.phase_kernel_vs_plain(
               device, cs.fused_matrix()),
           "wide_max_abs_err": cs.phase_kernel_vs_plain(
               device, cs.fused_wide_matrix())}
    print(f"fused_map == plain over fused_matrix() and fused_wide_matrix() "
          f"(max abs err {res['matrix_max_abs_err']}, "
          f"{res['wide_max_abs_err']})")
    if args.parent:
        res["parent"] = against_parent(device, args.parent, args.rounds)
        for rep, r in res["parent"].items():
            for how in ("device_ms", "event_ms"):
                print(f"S {cs.TASK} {rep} {how}: " + ", ".join(
                    f"{n} {v['mean']:.5f} [{v['min']:.5f}, {v['max']:.5f}]"
                    for n, v in r[how].items()) + "; outputs bit-equal")
    res["wide"] = {S: cs.time_fused_wide(device, S) for S in cs.WIDE_TIMED}
    cs.print_fused_wide(res["wide"])
    print(json.dumps(res))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
