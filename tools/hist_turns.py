#!/usr/bin/env python3
"""Measure the wordcount histogram kernel on one CUDA card.

    python tools/hist_turns.py [--sass DIR] [--ablate] [--parent OLD_HIST_CU]

At the smoke's full width (2**27 tokens, V = 262,144 in count mode, 8 bins
in owner mode), on the smoke's Zipf(1.3) corpus and on a uniform corpus of
the same size over V (seeded on the card):

  * always: this checkout's kernel (``wordcount_hist``) held bit for bit
    to ``hist_plain`` on the smoke's ``HIST_MATRIX`` and on both corpora
    in both modes, and its time by CUDA events and by the profiler's
    device time (``chip_smoke._event_ms`` and ``_device_ms``), beside the
    read of the corpus by ``torch.amax``;
  * ``--parent``: another ``hist.cu`` with the same C entry point
    (``hist_launch``), e.g. ``git show <commit>:src/repro_torch/kernels/
    wordcount_hash/csrc/hist.cu``, held to the plain version too and timed
    in turns with this checkout's (parent, change, change, parent);
  * ``--ablate``: the old kernel's loop cut down stage by stage
    (``tools/hist_ablations.cu``: loads only, loads and key, loads, key and
    match, the whole loop), device time on the Zipf corpus in both modes;
  * ``--sass DIR``: ``cuobjdump -sass`` of each built kernel, written
    into DIR, and the global loads its loop issues before the first match
    or atomic that uses them.

Prints one JSON line of the numbers, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

ABLATIONS = ROOT / "tools" / "hist_ablations.cu"
MODES = {"count": (cs.VOCAB, 0), "owner": (cs.N_PROCS, cs.N_PROCS)}
STAGES = ("loads", "loads+key", "loads+key+match", "whole loop")


def _c_hist(source: Path, symbol: str = "hist_launch", *extra: int):
    """``symbol`` of ``source`` (``hist_launch``'s arguments, then the
    ints ``extra`` before the stream), built like the port's kernels, as
    a call ``fn(tokens, vocab, hash_mod) -> counts``."""
    backend = cs._port()[2]
    c = getattr(ctypes.CDLL(str(backend.build(source).path)), symbol)
    c.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p] + \
        [ctypes.c_int] * (2 + len(extra)) + [ctypes.c_void_p]
    c.restype = ctypes.c_int

    def fn(tokens, vocab, hash_mod):
        out = torch.zeros(vocab, dtype=torch.int32, device=tokens.device)
        rc = c(tokens.data_ptr(), tokens.numel(), out.data_ptr(), vocab,
               hash_mod, *extra, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{symbol} failed: CUDA error {rc}")
        return out
    return fn


def corpora(device) -> dict:
    """The smoke's Zipf corpus and a uniform one over V, both 2**27."""
    data = cs._port()[1]
    zipf = torch.from_numpy(data.read_all(cs.job_input(cs.N_TOKENS)[0]))
    g = torch.Generator(device=device)
    g.manual_seed(0)
    uniform = torch.randint(0, cs.VOCAB, (cs.N_TOKENS,), generator=g,
                            device=device, dtype=torch.int32)
    return {"zipf": zipf.to(device), "uniform": uniform}


def sass(source: Path, kernel: str, outdir: Path) -> dict:
    """Write ``cuobjdump -sass`` of ``source``'s build into ``outdir``
    and report how many global loads ``kernel`` issues between two matches
    or atomics (MATCH, ATOMS, RED, the ops that use a loaded token): at
    most, and in each stretch, and its opcodes in order."""
    from torch.utils.cpp_extension import CUDA_HOME
    so = cs._port()[2].build(source).path
    text = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"),
                           "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = outdir / f"sass_{source.stem}.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs if kernel in f.split("\n", 1)[0]), "")
    ops = re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
    stretches = [0]
    for o in ops:
        if o.startswith(("MATCH", "ATOMS", "RED")):
            stretches.append(0)
        elif o.startswith("LDG"):
            stretches[-1] += 1
    loads = sorted({o for o in ops if o.startswith("LDG")})
    return {"file": str(out), "instructions": len(ops),
            "ldg_between_uses_max": max(stretches),
            "ldg_between_uses": [k for k in stretches if k],
            "ldg": loads, "opcodes": ops}


def check(fn, tokens, vocab, mod, plain_out, what):
    got = fn(tokens, vocab, mod)
    if not torch.equal(got, plain_out):
        raise AssertionError(f"{what} != hist_plain (max abs "
                             f"{cs._int_diff(got, plain_out)})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="another hist.cu to time in "
                    "turns with this checkout's")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--sass", type=Path, metavar="DIR",
                    help="write each kernel's SASS into DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hist_turns: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    ops, ref = cs._wc()
    res: dict = {}
    if args.sass:
        res["sass"] = {ops.SOURCE.name: sass(ops.SOURCE, "hist_kernel",
                                             args.sass)}
        if args.parent:
            res["sass"]["parent"] = sass(args.parent, "hist_kernel",
                                         args.sass)
        for name, s in res["sass"].items():
            print(f"sass {name}: at most {s['ldg_between_uses_max']} global "
                  f"loads between two uses ({s['ldg']}; stretches "
                  f"{s['ldg_between_uses']}); {s['instructions']} "
                  f"instructions")
            print("  opcodes: " + " ".join(s.pop("opcodes")[:400]))
    matrix = cs.matrix_cases(device, slots={}, decode={})
    cs.check_cases(matrix)
    print(f"hist == hist_plain on every HIST_MATRIX case ({len(matrix)})")
    fns = {"change": ops.wordcount_hist}
    if args.parent:
        fns = {"parent": _c_hist(args.parent), **fns}
    for cname, tokens in corpora(device).items():
        read = cs._device_ms(lambda: torch.amax(tokens), 50)[0]
        res[f"{cname}_amax_device_ms"] = read
        print(f"{cname}: torch.amax over the corpus {read:.4f} ms device")
        for mode, (vocab, mod) in MODES.items():
            want = ref.hist_plain(tokens, vocab, hash_mod=mod)
            for name, fn in fns.items():
                check(fn, tokens, vocab, mod, want, f"{name} {cname} {mode}")
            calls = {n: (lambda f=f: f(tokens, vocab, mod))
                     for n, f in fns.items()}
            ev = cs._in_turns(calls, lambda f: cs._event_ms(f, 50))
            dv = cs._in_turns(calls, lambda f: cs._device_ms(f, 50)[0])
            bound = cs.hist_bound(tokens.numel(), vocab, mod)[0]
            res[f"{cname}_{mode}"] = {"event_ms": ev, "device_ms": dv,
                                      "bound_ms": bound}
            print(f"{cname} {mode}: == plain; " + ", ".join(
                f"{n} {ev[n]:.4f} ms events / {dv[n]:.4f} device"
                for n in calls) + f"; bound {bound:.4f} ms")
            if args.ablate and cname == "zipf":
                abl = {}
                for stage, label in enumerate(STAGES):
                    f = _c_hist(ABLATIONS, "hist_ablate_launch", stage)
                    if stage == 3:
                        check(f, tokens, vocab, mod, want, f"ablation {mode}")
                    abl[label] = cs._device_ms(
                        lambda f=f: f(tokens, vocab, mod), 50)[0]
                res[f"ablate_{mode}"] = abl
                print(f"ablations {mode} (device ms): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in abl.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
