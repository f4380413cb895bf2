"""fleetlint for the port: the counterpart of ``repro/analysis``.

The program rules (``rules.check_program``), over the shipping backend x
use-case programs and the re-mesh fold, run on seeded inputs at P = 8:

  * SPMD001 — every collective reduces or exchanges over the rank dim;
  * SPMD002 — no collective after a host read of a rank-varying value in
    the same program call (the only way a per-rank value reaches Python
    control flow in lockstep);
  * REP001  — outputs the engines assert replicated (the claim cursors,
    work and steal rows, ``job_work``, the owner map and split, the
    combine overflow, the re-mesh checksum) are equal along the rank dim
    after every call.

The reference proves these on a jaxpr for every input; the port has no
jaxpr, so they are run-time checks over dim 0 (``spmd.py``) and hold only
what the seeded inputs exercise.

The kernel rules, over the port's hand-written CUDA kernels and their
wrapper modules (``rules.check_kernel``):

  * PAL001 — a kernel's declared block maps stay in bounds over its grid;
  * PAL002 — integer outputs declare a worst-case count that fits them;
  * PAL003 — one device policy: wrappers go through
    ``repro_torch.kernels.backend.use_kernel`` with ``use_kernel=False``,
    no private policy, no fallback to the plain version in a ``try``.

Entry points: ``python -m repro_torch.analysis.lint`` (CLI; ``--device
cpu`` on the CPU, the card otherwise), ``rules.check_program`` /
``rules.check_kernel`` / ``rules.check_ops_module`` (library) and
``corpus.shipping_programs`` / ``corpus.shipping_kernels`` /
``corpus.MUTANTS`` (what they run over).
"""
from repro_torch.analysis.findings import Finding  # noqa: F401
