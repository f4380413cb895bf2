"""The port's fleet checkpoint, against the JAX package.

``repro_torch.ckpt.FleetCheckpoint`` and ``JobScheduler.checkpoint`` /
``restore`` on ``device="cpu"``: the counterparts of the fleet tests of
``tests/test_scheduler.py`` (restore after a kill mid-fleet, name
sanitizing, the guards) and of ``tests/test_fleet.py``'s manifest
diagnostics; then a fleet snapshot taken mid-fleet by one package's
scheduler and restored by the other's, both ways, finishing with the
uninterrupted fleet's records, with a queued job in it; ``_safe`` equal
to the reference's on lossy names.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro.ckpt import FleetCheckpoint as JFleet  # noqa: E402
from repro_torch.ckpt import FleetCheckpoint, FleetStateError  # noqa: E402
from repro_torch.core import JobScheduler  # noqa: E402
from repro_torch.core.usecases import wordcount_oracle  # noqa: E402

VOCAB, N, TASK = 200, 8192, 512


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(0)
    return rng.integers(0, VOCAB, size=N).astype(np.int32)


def wc_cfg(pkg=core, **kw):
    base = dict(usecase=pkg.WordCount(vocab=VOCAB), backend="1s",
                task_size=TASK, push_cap=256, n_procs=1, segment=2)
    base.update(kw)
    return pkg.JobConfig(**base)


def _fleet(tokens, pkg=core, **kw):
    """Two jobs in two tenants under fair share (the reference test's
    fleet); with ``max_active=2`` a third job waits queued."""
    sched = (JobScheduler(policy="fair", device="cpu", **kw) if pkg is core
             else jcore.JobScheduler(policy="fair", **kw))
    sched.submit(wc_cfg(pkg), tokens, name="a", tenant="ta")
    sched.submit(wc_cfg(pkg), tokens[: N // 2], name="b", tenant="tb")
    if kw.get("max_active"):
        sched.submit(wc_cfg(pkg), tokens[: N // 4], name="c", tenant="tb")
    return sched


def test_restore_after_kill_mid_fleet(tmp_path, tokens):
    s1 = _fleet(tokens)
    s1.run_until_complete(max_slices=5)
    assert all(j.state == "live" for j in s1.jobs)
    work_at_ckpt = {t: s.work for t, s in s1.tenants.items()}
    s1.checkpoint(str(tmp_path / "fleet"))
    for j in s1.jobs:                            # "kill" the process
        j.handle.close()
    s2 = _fleet(tokens)
    s2.restore(str(tmp_path / "fleet"))
    assert {t: s.work for t, s in s2.tenants.items()} == work_at_ckpt
    res = s2.run_until_complete()
    assert res["a"].records == wordcount_oracle(tokens, VOCAB)
    assert res["b"].records == wordcount_oracle(tokens[: N // 2], VOCAB)
    for j in s2.jobs:                            # restore seeks
        assert j.handle.feed.stats.bytes_read < \
            j.handle.plan.n_tasks * TASK * 4


def test_fleet_checkpoint_names_never_collide(tmp_path):
    f = FleetCheckpoint(str(tmp_path / "fleet"))
    assert f.manager("job/1").dir != f.manager("job_1").dir
    assert f.manager("job/1").dir == f.manager("job/1").dir


NAMES = ["a", "job-1", "job/1", "job_1", "x.y", "a b", "ü", "../up",
         "tenant:7", "", "job\\1", "q" * 40 + "/"]


@pytest.mark.parametrize("name", NAMES)
def test_safe_equals_the_reference(name):
    assert FleetCheckpoint._safe(name) == JFleet._safe(name)


def test_update_work_ignores_unobserved_ranks():
    from repro_torch.ft.straggler import ThroughputTracker
    tr = ThroughputTracker(n_procs=3)
    tr.update_work([4, 4, 0], 1.0)
    assert tr.rate[2] == 1.0
    assert tr.rate[0] > 1.0


def test_restore_rejects_missing_resubmission(tmp_path, tokens):
    s1 = _fleet(tokens)
    s1.run_until_complete(max_slices=3)
    s1.checkpoint(str(tmp_path / "fleet"))
    s1.close()
    s2 = JobScheduler(policy="fair", device="cpu")
    s2.submit(wc_cfg(), tokens, name="a", tenant="ta")   # "b" forgotten
    with pytest.raises(ValueError, match="'b'.*not resubmitted"):
        s2.restore(str(tmp_path / "fleet"))


def test_restore_respects_backend_guard(tmp_path, tokens):
    s1 = _fleet(tokens)
    s1.run_until_complete(max_slices=5)
    s1.checkpoint(str(tmp_path / "fleet"))
    s1.close()
    s2 = JobScheduler(policy="fair", device="cpu")
    s2.submit(wc_cfg(backend="2s"), tokens, name="a", tenant="ta")
    s2.submit(wc_cfg(), tokens[: N // 2], name="b", tenant="tb")
    with pytest.raises(ValueError, match="backend"):
        s2.restore(str(tmp_path / "fleet"))


def test_restore_refuses_a_manifest_with_domains(tmp_path, tokens):
    fleet = FleetCheckpoint(str(tmp_path))
    fleet.save_state({"policy": "fair", "jobs": [], "tenants": {},
                      "domains": [{"name": "codomain-0",
                                   "members": ["a", "b"], "stride": 1,
                                   "pack": 2}]})
    # domains are ported: a manifest whose domain members were not
    # resubmitted is refused, naming them
    with pytest.raises(ValueError, match="codomain-0.*'a', 'b'.*not "
                                         "resubmitted"):
        JobScheduler(device="cpu").restore(fleet)


# ---------------------------------------------------------------------------
# the manifest (counterparts of tests/test_fleet.py)
# ---------------------------------------------------------------------------

def test_load_state_missing_manifest_names_dir_and_snapshots(tmp_path):
    fleet = FleetCheckpoint(str(tmp_path))
    fleet.manager("alpha").save(0, {"x": np.zeros((2,), np.int32)})
    fleet.manager("beta").save(0, {"x": np.zeros((2,), np.int32)})
    assert not fleet.has_state()
    with pytest.raises(FleetStateError) as ei:
        fleet.load_state()
    msg = str(ei.value)
    assert str(tmp_path) in msg
    assert "job-alpha" in msg and "job-beta" in msg
    assert "manager" in msg


def test_load_state_corrupt_manifest_is_diagnosed(tmp_path):
    fleet = FleetCheckpoint(str(tmp_path))
    fleet.save_state({"jobs": []})
    assert fleet.has_state()
    with open(os.path.join(str(tmp_path), FleetCheckpoint.STATE),
              "w") as f:
        f.write("{torn")
    with pytest.raises(FleetStateError, match="unreadable"):
        fleet.load_state()


def test_save_state_fsyncs_before_rename(tmp_path, monkeypatch):
    synced = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: synced.append(fd)
                        or real(fd))
    fleet = FleetCheckpoint(str(tmp_path))
    fleet.save_state({"jobs": [1]})
    assert synced
    assert fleet.load_state() == {"jobs": [1]}


# ---------------------------------------------------------------------------
# fleet snapshots across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("taker", ["reference", "port"])
def test_fleet_snapshot_restores_across_the_packages(tmp_path, tokens,
                                                     taker):
    """One package's scheduler runs five slices of a fleet with a queued
    job (``max_active=2``), checkpoints it and is killed; the other's,
    with the same jobs resubmitted, restores it and finishes every job
    with the uninterrupted fleet's records; its tenants resume the
    snapshot's service, the queued job stays queued until it runs."""
    first, second = (jcore, core) if taker == "reference" else (core, jcore)
    want = {n: r.records for n, r in
            _fleet(tokens, core, max_active=2).run_until_complete().items()}
    assert want["c"] == wordcount_oracle(tokens[: N // 4], VOCAB)
    s1 = _fleet(tokens, first, max_active=2)
    s1.run_until_complete(max_slices=5)
    assert [j.state for j in s1.jobs] == ["live", "live", "queued"]
    tenants = {t: (s.segments, s.work) for t, s in s1.tenants.items()}
    s1.checkpoint(str(tmp_path / "fleet"))
    s1.close()
    s2 = _fleet(tokens, second, max_active=2)
    s2.restore(str(tmp_path / "fleet"))
    assert {t: (s.segments, s.work)
            for t, s in s2.tenants.items()} == tenants
    assert [j.state for j in s2.jobs] == ["live", "live", "queued"]
    res = s2.run_until_complete()
    assert {n: r.records for n, r in res.items()} == want
    assert all(j.state == "done" for j in s2.jobs)
