"""Tests of the port that need the card (marker ``cuda``).

They skip where no CUDA card is present, and they import no JAX, so the
GPU host can run them on their own:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from repro_torch.core import JobConfig, WordCount, submit  # noqa: E402
from repro_torch.core import wordcount_oracle  # noqa: E402
from repro_torch.core.planner import gather_segment  # noqa: E402
from repro_torch.data.feed import SegmentFeed  # noqa: E402
from repro_torch.data.source import ZipfSource  # noqa: E402
from repro_torch.kernels.fused_map import ops  # noqa: E402
from torch_parity import assert_equal, cuda_device, to_torch  # noqa: E402,F401


@pytest.mark.cuda
def test_card_is_sm90(cuda_device):
    assert torch.cuda.get_device_capability(cuda_device) == (9, 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,compute_cap",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    assert "9.0" in smi, smi


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card(cuda_device):
    """Bit for bit on every output of every matrix case, near-SAT at
    rep > 1 and the full-width shapes included."""
    assert chip_smoke.phase_kernel_vs_plain(
        cuda_device, chip_smoke.fused_matrix()) == 0.0


@pytest.mark.cuda
def test_cuda_wrapper_launches_and_never_takes_plain(cuda_device,
                                                     monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ops, "fused_step_ref", plain)
    args, P, cap = dict(chip_smoke.fused_matrix())["sweep1"]
    a = {k: to_torch(v).to(cuda_device) for k, v in args.items()}
    before = ops.fused_map.launches
    table, bk, _, counts = ops.fused_map(**a, n_procs=P, cap=cap)
    torch.cuda.synchronize()
    assert ops.fused_map.launches == before + 1
    assert table is a["table"] and bk.is_cuda and counts.shape == (P, P)


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [True, False])
def test_cuda_feed_equals_host_reads(cuda_device, prefetch):
    """Every segment that crosses the pinned double buffer equals the
    host read of the same tasks, with the consumer's stream busy so the
    copies and buffer refills really overlap."""
    from repro_torch.core.planner import plan_input, shard_task_ids
    src = ZipfSource(1 << 18, vocab=5000, seed=1)
    plan = plan_input(src.len_elements(), 64, 4)
    ids = shard_task_ids(plan)
    reps = np.ones_like(ids)
    feed = SegmentFeed(src, plan, ids, reps, segment=16, device=cuda_device,
                       prefetch=prefetch)
    busy = torch.randn(2048, 2048, device=cuda_device)
    start = 0
    try:
        while (seg := feed.next_segment()) is not None:
            busy = busy @ busy.t() / 2048        # keep the stream busy
            want = gather_segment(src, plan, np.pad(
                ids[:, start:start + 16],
                ((0, 0), (0, max(0, start + 16 - ids.shape[1]))),
                constant_values=-1))
            assert_equal(seg.tokens, want)
            assert_equal(seg.task_ids[:, :min(16, ids.shape[1] - start)],
                         ids[:, start:start + 16])
            start += 16
    finally:
        feed.close()
    assert start >= ids.shape[1]
    if prefetch:
        assert feed.stats.prefetch_hits == feed.stats.segments_built - 1


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_job_on_card_equals_cpu(cuda_device, fused):
    data = np.random.default_rng(3).integers(0, 700, 1 << 15).astype(
        np.int32)
    cfg = JobConfig(WordCount(vocab=700), task_size=128, push_cap=16,
                    n_procs=8, segment=4, fused_map=fused)
    reps = np.random.default_rng(4).integers(1, 4, (8, 32)).astype(np.int32)
    gpu = submit(cfg, data, device=cuda_device, repeats=reps)
    gpu.step()
    cpu = submit(cfg, data, device="cpu", repeats=reps)
    cpu.step()
    assert_equal(gpu.windows(), cpu.windows())
    assert gpu.result().records == cpu.result().records == \
        wordcount_oracle(data, 700)
