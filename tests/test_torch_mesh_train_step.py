"""The port's sharded train step and launcher against the reference's
on 8 CPU devices (the checks and their tolerances:
``torch_mesh_train.py``): two steps of ``make_train_step(mesh=,
dp_entry="data")`` of the deepseek-v2-lite SMOKE stack in fp32 on a
(data 2, model 4) mesh against the reference's jitted step, and
``launch.train --devices 8 --mesh 2x4`` training on the CPU (its
``--mesh 2x1`` without ``--devices 2`` fails the launcher's D x M = N
check: ``test_torch_train_parts.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_train as tm  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402

ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module")
def ref(devices8, tmp_path_factory):
    return tm.reference(devices8, tmp_path_factory.mktemp("mesh_step"),
                        step_arch=ARCH)


def test_two_sharded_train_steps_match_jax(ref):
    tm.check_train_steps(ref, ARCH)


def test_launch_train_on_a_mesh(capsys):
    losses = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--devices", "8", "--mesh", "2x4", "--steps",
                           "3", "--batch", "4", "--seq", "16"])
    assert "mesh 2x4" in capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
