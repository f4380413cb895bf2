"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``).

The reference runs on the CPU (JAX), the port on the CPU (torch); both
take the same seeded numpy inputs and their outputs are compared as
numpy arrays. The integer MapReduce path is bit-exact: tolerance 0.
"""
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:            # chip_smoke.py lives at the repo root
    sys.path.insert(0, REPO)

SENT = 2**31 - 1

# one constructor expression per use-case, evaluated against each package
USECASES = {
    "wordcount": "WordCount(vocab=300)",
    "histogram": "Histogram(300, 13)",
    "inverted": "InvertedIndex((3, 7, 11, 250), 4, 8)",
}

# the JobResult fields held equal between the packages
STATS = ("n_tasks", "tasks_per_rank", "work_per_rank", "steals_per_rank",
         "partitioner", "n_split_keys", "combine_overflow", "keys",
         "values")


def usecase(pkg, name):
    """``USECASES[name]`` built from ``pkg``'s use-case classes."""
    return eval(USECASES[name], {k: getattr(pkg, k) for k in
                                 ("WordCount", "Histogram",
                                  "InvertedIndex")})


def to_torch(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_equal(got, want, msg=""):
    """Bit-exact comparison of a torch tensor / jax array / numpy array."""
    if hasattr(got, "detach"):
        got = got.detach().cpu().numpy()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


def assert_same_result(got, want):
    """Two JobResults (either package) agree: records, backend, stats."""
    assert got.records == want.records
    assert got.backend == want.backend
    for f in STATS:
        assert_equal(np.asarray(getattr(got, f)),
                     np.asarray(getattr(want, f)), f)
    assert got.imbalance == want.imbalance and got.n_steals == want.n_steals


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time, never at import
    (every xdist worker must collect the same tests)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    return torch.device("cuda", 0)
