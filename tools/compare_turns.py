#!/usr/bin/env python3
"""MR-1S against MR-2S, snapshots, key skew, fleets, I/O overlap, the
coded shuffle, cross-job co-scheduling, the elastic fleet, fig9's
imbalance, serving and training.

    python tools/compare_turns.py
        [--phases compare,snapshots,keyskew,fleet,overlap,coded,crossjob,
                  elastic,imbalance,serve,smoke,train,mesh,mesh_train,pp,
                  dryrun,examples]
        [--archs ARCH,...] [--train-archs ARCH,...]
        [--mesh-archs ARCH,...] [--out FILE]

Phases 3b-3j of ``chip_smoke.py`` on their own, on one CUDA card (its
``phase_compare``, ``phase_snapshots``, ``phase_keyskew``,
``phase_fleet``, ``phase_overlap``, ``phase_coded``, ``phase_crossjob``,
``phase_elastic`` and ``phase_imbalance``, at its full width; 3b, 3c,
3e, 3f and 3i on its 2**27-token corpus read once into host memory),
without the smoke's other phases: 2S, 1S and 1S with stealing under the
three repeat grids
and oneshot; a checkpoint every 8th segment in turns, a restore and a
re-plan; each partitioner with and without stealing at two key skews;
the multi-tenant fleets under each policy; resident against streamed
input in turns; fig15's coded arms in turns; fig14's fleets with and
without co-scheduling; fig13's supervised campaigns and the fused job
re-meshed 8 -> 6 -> 8; fig9's arms at S 4096 and the fused job at S
16,384. Every job's records are held to the oracle or to the
uninterrupted or solo job's. ``fused_map`` is built from this
checkout at its first use. ``serve`` is phase 4 (``phase_serves``:
``phase_serve`` with its gates) for each arch of ``--archs`` (default:
every arch of ``SERVE_ARCHS``; ``--archs deepseek-v2-lite-16b`` serves
the MoE stack alone, ``--archs jamba-v0.1-52b`` one period of the hybrid
stack). ``train`` is phase 5 (``phase_trains``: ``phase_train`` with its
checks) for each arch of ``--train-archs`` (default: every arch of
``TRAIN_ARCHS``: olmo-1b, which reaches no kernel, and deepseek-v2-lite
cut to 4 layers, whose MoE layers slot through bucket_slots). ``mesh``
is phase 4m (``phase_mesh_serves``: each arch of ``--mesh-archs``,
default every arch of ``MESH_ARCHS``, served under the virtual 2 x 4
mesh and unsharded), ``mesh_train`` phase 5m (``phase_mesh_trains``:
deepseek-v2-lite at 4 layers under the mesh and unsharded), ``pp``
phase 5p (``phase_pp_trains``: olmo-1b pipelined over the pod axis of a
virtual (pod 2, data 2) mesh and unsharded), ``dryrun`` phase 2f
(``phase_dryrun``: the dry run's cells on meta in a child process, then
olmo-1b's prefill on meta against the card), ``smoke`` phase 4s
(``phase_smoke_serves``: each arch of ``--archs``, default every arch of
the registry, served at its SMOKE config), ``examples`` phase 6
(``phase_examples``: the five ``examples/*_torch.py`` ports in children).

Prints the smoke's lines for each phase, one JSON line of the numbers
(also written to ``--out``), and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="compare,snapshots")
    ap.add_argument("--archs", default="",
                    help="serve's and smoke's archs (default: all)")
    ap.add_argument("--train-archs", default=",".join(cs.TRAIN_ARCHS))
    ap.add_argument("--mesh-archs", default=",".join(cs.MESH_ARCHS))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_turns: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    phases = args.phases.split(",")
    archs = [a for a in args.archs.split(",") if a]
    _, data, _, _, _ = cs._port()
    corpus = (data.read_all(cs.job_input(cs.N_TOKENS)[0])
              if set(phases) - {"keyskew", "coded", "crossjob",
                                "imbalance", "serve",
                                "smoke", "train", "mesh", "mesh_train",
                                "pp", "dryrun", "examples"}
              else None)
    out = {}
    for phase in phases:
        run, show = {
            "compare": (lambda: cs.phase_compare(device, corpus),
                        cs.print_compare),
            "snapshots": (lambda: cs.phase_snapshots(device, corpus),
                          cs.print_snapshots),
            "keyskew": (lambda: cs.phase_keyskew(device),
                        cs.print_keyskew),
            "fleet": (lambda: cs.phase_fleet(device, corpus),
                      cs.print_fleet),
            "overlap": (lambda: cs.phase_overlap(device, corpus),
                        cs.print_overlap),
            "coded": (lambda: cs.phase_coded(device), cs.print_coded),
            "crossjob": (lambda: cs.phase_crossjob(device),
                         cs.print_crossjob),
            "elastic": (lambda: cs.phase_elastic(device, corpus),
                        cs.print_elastic),
            "imbalance": (lambda: cs.phase_imbalance(device),
                          cs.print_imbalance),
            "serve": (lambda: cs.phase_serves(
                device, archs or list(cs.SERVE_ARCHS)),
                      lambda out: None),    # printed arch by arch
            "smoke": (lambda: cs.phase_smoke_serves(device, archs),
                      lambda out: None),    # printed arch by arch
            "examples": (cs.phase_examples, cs.print_examples),
            "train": (lambda: cs.phase_trains(
                device, args.train_archs.split(",")),
                      lambda out: None),    # printed arch by arch
            "mesh": (lambda: cs.phase_mesh_serves(
                device, args.mesh_archs.split(",")),
                     lambda out: None),     # printed arch by arch
            "mesh_train": (lambda: cs.phase_mesh_trains(device),
                           lambda out: None),
            "pp": (lambda: cs.phase_pp_trains(device),
                   lambda out: None),     # printed arch by arch
            "dryrun": (lambda: cs.phase_dryrun(device),
                       cs.print_dryrun)}[phase]
        t0 = time.perf_counter()
        out[phase] = run()
        out[phase]["seconds"] = time.perf_counter() - t0
        show(out[phase])
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
