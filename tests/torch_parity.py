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



def _share_the_cores():
    """Under pytest-xdist every worker is a process of its own on one
    host, and torch's intra-op pool takes a thread a core in each: 6
    workers on 8 cores ran 48 spinning OpenMP threads, and a smoke
    rehearsal that takes 8 s alone took 488-667 s. So a worker keeps its
    share of the cores (one thread a worker at 6 workers on 8 cores)."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return
    try:
        import torch
    except ImportError:
        return
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // int(workers)))


_share_the_cores()

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


# ---------------------------------------------------------------------------
# the seeded fleet that both packages' JobSchedulers run
# ---------------------------------------------------------------------------

class RecordingPolicy:
    """A scheduler policy that records the name of every job it picks."""

    def __init__(self, inner):
        self.inner, self.name, self.order = inner, inner.name, []

    def pick(self, candidates, tenants):
        job = self.inner.pick(candidates, tenants)
        self.order.append(job.name)
        return job


def fleet_jobs(core, data, P, task):
    """``[(name, tenant, priority, config, dataset, repeats)]``: a
    WordCount, Histogram, InvertedIndex and WordCount job of 1, 1/2, 1/4
    and 3/4 of ``data`` built from ``core``'s classes, two of them in one
    tenant, the last with repeats 1-3 over its grid."""
    jobs = []
    for k, (uc, frac, tenant) in enumerate((
            ("wordcount", 1.0, "batch"), ("histogram", 0.5, "batch"),
            ("inverted", 0.25, "interactive"), ("wordcount", 0.75, "bulk"))):
        part = data[: int(len(data) * frac)]
        cfg = core.JobConfig(usecase(core, uc), backend="1s",
                             task_size=task, push_cap=8 if P > 1 else 256,
                             n_procs=P, segment=2 if P == 1 else 4)
        T = -(-(-(-len(part) // task)) // P)
        reps = (1 + np.arange(P * T) % 3).reshape(P, T) if k == 3 else None
        jobs.append((f"{uc}-{k}", tenant, k % 3, cfg, part, reps))
    return jobs


def run_fleet(core, policy, data, P, task, **device):
    """Run :func:`fleet_jobs` under ``policy`` with ``max_active=3`` and
    a FeedBudget of two segments' bytes; what the parity tests compare:
    the slice order, each job's result summary, the tenants and stats()
    without their host seconds, and each feed's and the budget's
    denials."""
    rec = RecordingPolicy(core.resolve_policy(policy))
    seg = 2 if P == 1 else 4
    sched = core.JobScheduler(policy=rec, max_active=3,
                              max_live_bytes=2 * P * seg * task * 4,
                              **device)
    for name, tenant, prio, cfg, part, reps in fleet_jobs(core, data, P,
                                                          task):
        sched.submit(cfg, part, tenant=tenant, priority=prio, name=name,
                     repeats=reps)
    res = sched.run_until_complete()
    st = sched.stats()
    for row in [*st["tenants"].values(), *st["jobs"]]:
        row.pop("wall")
    return {"order": rec.order,
            "results": {n: result_summary(r) for n, r in res.items()},
            "stats": st,
            "denials": {j.name: j.handle.feed.stats.budget_denials
                        for j in sched.jobs},
            "budget_denials": sched.budget.denials,
            "n_unique_programs": sched.n_unique_programs}


def result_summary(res) -> dict:
    """A JobResult as JSON-able data: what :func:`assert_same_result`
    compares."""
    return {"records": sorted(res.records.items()), "backend": res.backend,
            "imbalance": res.imbalance, "n_steals": res.n_steals,
            **{f: np.asarray(getattr(res, f)).tolist()
               if not isinstance(getattr(res, f), str)
               else getattr(res, f) for f in STATS}}
