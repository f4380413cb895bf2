"""Elastic fleet supervision: fault injection, re-meshing, recovery.

Counterpart of ``repro/fleet``:

``faults``     — deterministic chaos (:class:`FaultPlan` /
                 :class:`FaultInjector` / :class:`FaultingSource`);
``remesh``     — fold a P_old snapshot onto P_new ranks, exactly
                 (:func:`elastic_restore`, checksum-verified);
``supervisor`` — the tick loop that keeps a scheduler fleet live
                 through all of it (:class:`FleetSupervisor`).
"""
from repro_torch.fleet.faults import (FaultEvent, FaultInjector, FaultPlan,
                                      FaultingSource, InjectedIOError)
from repro_torch.fleet.remesh import (RemeshChecksumError, elastic_restore,
                                      fold_program, remesh_program_handles)
from repro_torch.fleet.supervisor import (FleetEntry, FleetSupervisor,
                                          RecoveryRecord)

__all__ = [
    "FaultEvent", "FaultInjector", "FaultPlan", "FaultingSource",
    "InjectedIOError", "RemeshChecksumError", "elastic_restore",
    "fold_program", "remesh_program_handles", "FleetEntry",
    "FleetSupervisor", "RecoveryRecord",
]
