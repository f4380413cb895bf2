"""The production mesh (counterpart of ``repro/launch/mesh.py``).

A ``distributed.mesh.Mesh`` of virtual ranks: 16 x 16 over ("data",
"model"), or 2 x 16 x 16 over ("pod", "data", "model") across two pods.
Making one touches no device state; the dry run makes it on ``meta``,
where its programs run without data.
"""
from __future__ import annotations

from repro_torch.config import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.distributed.mesh import Mesh, make_mesh


def make_production_mesh(multi_pod: bool = False, device=None) -> Mesh:
    """The single-pod or multi-pod mesh on ``device`` (cuda unless
    given)."""
    return make_mesh(mesh_config(multi_pod=multi_pod), device)


def mesh_config(multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD
