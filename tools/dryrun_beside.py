#!/usr/bin/env python3
"""Whether the dry run's child moves the numbers of the smoke's phases it
runs beside.

    python tools/dryrun_beside.py [--out FILE]

Phase 2f (a) of ``chip_smoke.py``, the dry run's cells on ``meta``
tensors, runs in a child process (``start_dryrun``) that needs no card,
so it could run on the host beside the card's phases. This script
builds the kernels once, then times what the smoke records in phase 2
and the WordCount job of phase 3, in four turns: alone, beside the
child, beside the child, alone, on one CUDA card. Each turn times
``fused_map`` (``time_fused``), ``flash_attention`` (``time_flash``),
``ssd_scan`` (``time_ssd``), the entry points' cases (``time_entry``),
the near twins' kernels of the lint with their device times, and the
fused WordCount job with its unfused comparison (``phase_job``, its
host-paced feed among them). In each "beside" turn one child runs the
whole turn: started at its start, started again whenever it ends, and
stopped at the turn's end.

Prints, for every number, its four turns and the ratio of the beside
turns' mean to the alone turns' mean, beside the alone turns' own
spread (their larger over their smaller), then one JSON line of it all
and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

TURNS = ("alone", "beside", "beside", "alone")
# the job's walls and rates beside the kernels' times
JOB_KEYS = ("fused_wall", "tokens_per_s", "feed_s_per_segment",
            "fused_wall_at_n_unfused", "eager_wall_at_n_unfused",
            "unfused_wall")


def _times(prefix: str, d: dict, out: dict):
    """The measured times of a timing record (``*ms`` keys, not the
    bounds), flattened under ``prefix``."""
    for k, v in d.items():
        if isinstance(v, dict):
            _times(f"{prefix}{k}.", v, out)
        elif (k.endswith("ms") and k != "bound_ms"
              and isinstance(v, (int, float))):
            out[prefix + k] = float(v)


class Beside:
    """One dry-run child at a time for as long as the ``with`` lasts."""

    def __enter__(self):
        self.stop, self.starts = threading.Event(), 0
        self.thread = threading.Thread(target=self._run)
        self.thread.start()
        return self

    def _run(self):
        while not self.stop.is_set():
            child = cs.start_dryrun()
            self.starts += 1
            while child["proc"].poll() is None and not self.stop.wait(0.2):
                pass
            if child["proc"].poll() is None:
                child["proc"].kill()
                child["proc"].wait()

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()


def one_turn(device, corpus) -> dict:
    out: dict = {}
    _times("fused_map.", cs.time_fused(device), out)
    _times("flash_attention.", cs.time_flash(device), out)
    _times("ssd_scan.", cs.time_ssd(device), out)
    _times("entry.", cs.time_entry(cs.entry_cases(device, corpus)), out)
    lint = cs.phase_lint(device)
    lint_t = cs.time_entry(lint["cases"])
    for name, c in lint["cases"].items():
        dev = cs._in_turns({"kernel": c["run"], "library": c["library"]},
                           lambda f: cs._device_ms(f, 200)[0])
        lint_t[name].update(device_ms=dev["kernel"],
                            library_device_ms=dev["library"])
    _times("lint.", lint_t, out)
    job = cs.phase_job(device, cs.N_TOKENS, cs.N_UNFUSED)
    out.update({f"job.{k}": float(job[k]) for k in JOB_KEYS})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dryrun_beside: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # as the smoke times
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    _, data, _, _, _ = cs._port()
    corpus = data.read_all(cs.job_input(cs.N_TOKENS)[0])
    turns = []
    for kind in TURNS:
        t0 = time.perf_counter()
        if kind == "beside":
            with Beside() as b:
                rec = one_turn(device, corpus)
            starts = b.starts
        else:
            rec, starts = one_turn(device, corpus), 0
        wall = time.perf_counter() - t0
        turns.append(dict(kind=kind, wall_s=wall, children=starts,
                          times=rec))
        print(f"turn {len(turns)} ({kind}): {wall:.1f} s, {starts} "
              f"children started", flush=True)
    rows = {}
    for k in turns[0]["times"]:
        if not all(k in t["times"] for t in turns):
            continue
        v = [t["times"][k] for t in turns]
        alone = [x for x, t in zip(v, TURNS) if t == "alone"]
        beside = [x for x, t in zip(v, TURNS) if t == "beside"]
        rows[k] = dict(turns=v,
                       beside_over_alone=float(np.mean(beside)
                                               / np.mean(alone)),
                       alone_spread=max(alone) / min(alone))
        print(f"{k}: {v} beside/alone {rows[k]['beside_over_alone']:.4f}, "
              f"alone spread {rows[k]['alone_spread']:.4f}")
    line = json.dumps({"turns": turns, "rows": rows})
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
