#!/usr/bin/env python3
"""Host seconds of one dry-run cell's program on ``meta`` tensors under
the meter's own meta outputs and under torch's meta kernels.

    PYTHONPATH=src python tools/time_meta_fork.py --arch olmo-1b \
        --shape train_4k [--multipod] [--out FILE]

``launch/dryrun.Meter`` makes the outputs of elementwise ops, reductions,
softmax, ``cat``, ``clone``, copies, matrix products and ``arange`` on
meta tensors itself (``fast_meta=True``, what ``measure`` uses) instead
of running torch's meta kernels (``fast_meta=False``). This builds the
cell's program as ``run_cell`` does (the base variant), runs it once
under each meter, with the meter's outputs first, and prints the seconds
of each, their ratio and the two runs' op counts, FLOPs and peak live
bytes, which must be equal, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch.config import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as dr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cfg, shape = get_config(args.arch), SHAPES[args.shape]
    mesh = dr.make_production_mesh(multi_pod=args.multipod, device=dr.META)
    mesh_cfg = dr.mesh_config(multi_pod=args.multipod)
    rec = {"arch": args.arch, "shape": args.shape,
           "mesh": "multipod" if args.multipod else "singlepod"}
    for name, fast in (("meter", True), ("torch", False)):
        fn, fargs, _, _ = dr.build_cell(cfg, shape, mesh, mesh_cfg)
        t0 = time.perf_counter()
        with dr.Meter(fast_meta=fast) as m:
            out = fn(*fargs)
            del out
        rec[name] = dict(seconds=time.perf_counter() - t0, n_ops=m.n_ops,
                         flops=m.flops, bytes_accessed=m.bytes_accessed,
                         peak=m.peak)
        print(f"{args.arch} x {args.shape} x {rec['mesh']}: {name}'s meta "
              f"outputs {rec[name]['seconds']:.2f} s, {m.n_ops} ops",
              flush=True)
        del fn, fargs
    a, b = rec["meter"], rec["torch"]
    assert all(a[k] == b[k] for k in ("n_ops", "flops", "bytes_accessed",
                                      "peak")), rec
    rec["torch_over_meter"] = b["seconds"] / a["seconds"]
    print(f"torch's over the meter's: {rec['torch_over_meter']:.3f}; op "
          f"counts, FLOPs, bytes accessed and peak live bytes equal")
    line = json.dumps(rec)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
