"""The port's sharded loss and train step against the reference's on 8
CPU devices (the checks and their tolerances: ``torch_mesh_train.py``).

On a (data 2, model 4) mesh with ``dp_entry="data"``, in fp32: the
sharded ``loss_fn`` and every gradient of the deepseek-v2-lite (MLA,
MoE) and llama4-maverick (GQA, dense and MoE layers 1:1) SMOKE stacks
at their own ``capacity_factor`` of 1.25, where the sharded losses
differ from the unsharded ones (each shard's buckets drop their own
records). The train steps and the launcher:
``test_torch_mesh_train_step.py``; the hybrid stack:
``test_torch_mesh_hybrid_train.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_train as tm  # noqa: E402

ARCHS = ("deepseek-v2-lite-16b", "llama4-maverick-400b-a17b")


@pytest.fixture(scope="module")
def ref(devices8, tmp_path_factory):
    return tm.reference(devices8, tmp_path_factory.mktemp("mesh_train"),
                        ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_gradients_match_jax(ref, arch):
    tm.check_loss_and_gradients(ref, arch)
