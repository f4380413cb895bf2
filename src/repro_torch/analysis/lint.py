"""fleetlint for the port — ``python -m repro_torch.analysis.lint``.

Modes (those of ``python -m repro.analysis.lint``):

  --all        check the shipping programs AND kernels (the default)
  --programs   only the backend x use-case matrix and the re-mesh fold,
               run on seeded inputs at P = 8 (``corpus.LINT_PROCS``)
               under SPMD001, SPMD002 and REP001
  --kernels    only the kernel wrappers
  --selftest   run the seeded mutant corpus instead (12 program, 8
               kernel and ops mutants): every rule must fire on its
               known-bad seed and stay quiet on the near miss (exit 1
               otherwise); a near twin's kernel is launched on
               ``--device``, a bad twin's never

The program rules are run-time checks over the rank dim
(``analysis/spmd.py``): they hold for what the seeded inputs exercise,
where the reference's taint proof holds for every input.

Output options: ``--json`` (machine-readable findings), ``--verbose``
(per-program and per-kernel progress), ``--waive RULE:SUBSTR``
(repeatable — silence a finding by rule id + a substring of its
provenance, e.g. ``--waive PAL002:moe_dispatch``; waived findings are
still reported, they just do not fail the run). ``--device`` picks where
the programs run and the kernels launch: the card unless the caller
names another (``--device cpu`` runs the plain versions).

Exit status: 0 clean, 1 findings (or selftest failure).
"""
from __future__ import annotations

import argparse
import json
import sys


def _parse_waivers(raw: list[str]) -> list[tuple[str, str]]:
    waivers = []
    for w in raw:
        rule, _, substr = w.partition(":")
        if not rule or not substr:
            raise SystemExit(f"--waive needs RULE:SUBSTR, got {w!r}")
        waivers.append((rule, substr))
    return waivers


def _is_waived(finding, waivers) -> bool:
    return any(finding.rule == rule
               and (substr in finding.program or substr in finding.where)
               for rule, substr in waivers)


def run_programs(device, verbose: bool, out=sys.stderr
                 ) -> tuple[list, int]:
    from repro_torch.analysis import corpus, rules
    findings, checked = [], 0
    for handle in corpus.shipping_programs(device):
        got = rules.check_program(handle)
        findings.extend(got)
        checked += 1
        if verbose:
            status = "ok" if not got else f"{len(got)} finding(s)"
            print(f"  program {handle.name}: {status}", file=out)
    return findings, checked


def run_kernels(device, verbose: bool, out=sys.stderr) -> tuple[list, int]:
    from repro_torch.analysis import corpus, rules
    findings, checked = [], 0
    for kc in corpus.shipping_kernels():
        got = rules.check_kernel(kc, device)
        findings.extend(got)
        checked += 1
        if verbose:
            status = "ok" if not got else f"{len(got)} finding(s)"
            print(f"  kernel {kc.name}: {status}", file=out)
    return findings, checked


def run_selftest(device, verbose: bool, out=sys.stderr) -> bool:
    """Mutant corpus gate: each rule fires on its seed, never on the near
    miss. Returns True when the analyzer passes its own test."""
    from repro_torch.analysis import corpus
    ok = True
    for mutant in corpus.MUTANTS:
        got = corpus.run_mutant(mutant, device)
        fired = any(f.rule == mutant.rule for f in got)
        if mutant.fires:
            good = fired
            expect = f"must fire {mutant.rule}"
        else:
            good = not got          # near miss: NO findings at all
            expect = "must stay quiet"
        ok &= good
        mark = "ok" if good else "FAIL"
        if verbose or not good:
            print(f"  mutant {mutant.name} ({expect}): {mark} "
                  f"[{len(got)} finding(s)]", file=out)
    return ok


def main(argv: list[str] | None = None) -> int:
    from repro_torch.device import resolve_device
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="fleetlint for the port: run-time SPMD checks of the "
                    "shipping programs over the rank dim, and static "
                    "checks of the kernel wrappers and their declared "
                    "launches")
    ap.add_argument("--all", action="store_true",
                    help="programs + kernels (default)")
    ap.add_argument("--programs", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--selftest", action="store_true",
                    help="run the known-bad mutant corpus instead")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--waive", action="append", default=[],
                    metavar="RULE:SUBSTR",
                    help="silence findings of RULE whose program or "
                         "provenance contains SUBSTR (repeatable)")
    ap.add_argument("--device", default=None,
                    help="where programs run and kernels launch "
                         "(default: the card)")
    args = ap.parse_args(argv)
    waivers = _parse_waivers(args.waive)
    device = resolve_device(args.device)

    if args.selftest:
        ok = run_selftest(device, args.verbose)
        print("fleetlint selftest:", "PASS" if ok else "FAIL")
        return 0 if ok else 1

    do_programs = args.programs or args.all or not args.kernels
    do_kernels = args.kernels or args.all or not args.programs
    findings, checked = [], {}
    if do_programs:
        got, n = run_programs(device, args.verbose)
        findings += got
        checked["programs"] = n
    if do_kernels:
        got, n = run_kernels(device, args.verbose)
        findings += got
        checked["kernels"] = n

    live = [f for f in findings if not _is_waived(f, waivers)]
    waived = [f for f in findings if _is_waived(f, waivers)]

    if args.as_json:
        print(json.dumps({
            "checked": checked,
            "findings": [f.to_json() for f in live],
            "waived": [f.to_json() for f in waived],
        }, indent=2))
    else:
        for f in waived:
            print(f"waived  {f}")
        for f in live:
            print(str(f))
        scope = ", ".join(f"{n} {k}" for k, n in checked.items())
        verdict = "clean" if not live else f"{len(live)} finding(s)"
        print(f"fleetlint: {scope} checked — {verdict}"
              + (f" ({len(waived)} waived)" if waived else ""))
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
