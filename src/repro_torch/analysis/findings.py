"""One analyzer finding: the port's own copy of the reference's
``repro/analysis/taint.py::Finding``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer finding, keyed by rule id + provenance."""
    rule: str
    program: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.program} @ {self.where}: {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)
