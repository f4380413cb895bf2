"""The port's sharded loss of the hybrid stack against the reference's
on 8 CPU devices (the checks and their tolerances:
``torch_mesh_train.py``): jamba-v0.1's SMOKE stack (SSD layers, one GQA
layer, MoE of 4 experts top-2 on the odd slots; one expert a shard) in
fp32 on a (data 2, model 4) mesh with ``dp_entry="data"``, its sharded
``loss_fn`` and every gradient (each leaf within 1e-4 * max|ref|, as
``test_torch_hybrid_train.py`` holds the unsharded ones). Its own file:
the reference's jitted gradient of the sharded hybrid stack takes
~35 s to compile on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_train as tm  # noqa: E402

ARCH = "jamba-v0.1-52b"


@pytest.fixture(scope="module")
def ref(devices8, tmp_path_factory):
    return tm.reference(devices8, tmp_path_factory.mktemp("mesh_hybrid"),
                        (ARCH,))


def test_sharded_hybrid_loss_and_gradients_match_jax(ref):
    tm.check_loss_and_gradients(ref, ARCH, leaf_rel=1e-4)
