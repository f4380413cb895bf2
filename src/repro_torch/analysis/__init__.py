"""fleetlint for the port: the kernel half of ``repro/analysis``.

Ported: the three kernel rules, over the port's hand-written CUDA kernels
and their wrapper modules (``rules.py``):

  * PAL001 — a kernel's declared block maps stay in bounds over its grid;
  * PAL002 — integer outputs declare a worst-case count that fits them;
  * PAL003 — one device policy: wrappers go through
    ``repro_torch.kernels.backend.use_kernel`` with ``use_kernel=False``,
    no private policy, no fallback to the plain version in a ``try``.

Not ported yet (ROADMAP Queue 1 item 13): the program rules SPMD001,
SPMD002 and REP001 and their program mutants; ``--programs`` raises.

Entry points: ``python -m repro_torch.analysis.lint`` (CLI),
``rules.check_kernel`` / ``rules.check_ops_module`` (library) and
``corpus.shipping_kernels`` / ``corpus.MUTANTS`` (what they run over).
"""
from repro_torch.analysis.findings import Finding  # noqa: F401
