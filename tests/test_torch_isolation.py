"""The port stands alone, and ``chip_smoke.py`` rehearses on the CPU.

``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor the
JAX package ``repro`` (an AST scan, plus a fresh interpreter that
imports everything and inspects ``sys.modules``). The smoke's phase
functions run here at a tiny width with the kernel phases skipped; its
``main`` refuses to run without a card.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401  (both frameworks in one process, JAX on CPU)

import chip_smoke  # noqa: E402
from torch_parity import REPO  # noqa: E402

PORT = Path(REPO) / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [Path(REPO) / "chip_smoke.py"] + [
    Path(REPO) / "examples" / f"{name}_torch.py"
    for name in ("quickstart", "serve_lm", "train_lm", "skewed_wordcount",
                 "streaming_wordcount", "wordcount_puma")]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_the_scans_cover_the_scheduler_modules():
    """The two checks above reach the scheduler, the budget, the fleet
    checkpoint and the elastic fleet (the scan globs every module; this
    pins that it does)."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"core/scheduler.py", "data/feed.py",
            "ckpt/checkpoint.py", "core/coded.py",
            "core/workdomain.py", "ft/elastic.py", "fleet/remesh.py",
            "fleet/supervisor.py"} <= names


def test_the_scans_cover_the_moe_modules():
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"models/moe.py", "models/attention.py",
            "configs/deepseek_v2_lite.py"} <= names


def test_the_scans_cover_the_new_arch_configs():
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"configs/codeqwen_7b.py", "configs/stablelm_12b.py",
            "configs/llama4_maverick.py", "configs/registry.py"} <= names


def test_the_scans_cover_the_frontend_modules():
    """The two checks above reach the modules that serve whisper-tiny's
    encoder and internvl2-26b's vision prefix."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"configs/whisper_tiny.py", "configs/internvl2_26b.py",
            "launch/specs.py", "launch/serve.py", "models/transformer.py",
            "models/convert.py", "models/layers.py",
            "serve/engine.py"} <= names


TRAINING_MODULES = ("config", "data.pipeline", "data.tokenizer", "optim",
                    "optim.adamw", "optim.compress", "train",
                    "train.train_step", "launch.specs", "launch.train")


def test_the_scans_cover_the_training_modules():
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {m.replace(".", "/") + ("/__init__.py" if m in ("optim", "train")
                                   else ".py")
            for m in TRAINING_MODULES} <= names


def test_importing_everything_loads_no_jax():
    mods = [".".join(p.relative_to(PORT.parent).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import chip_smoke\n"
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
            + "assert not bad, bad\nprint(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(PORT.parent), REPO]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


@pytest.mark.parametrize("first", ["repro_torch.data", "repro_torch.data.feed",
                                   "repro_torch.core"])
def test_each_package_imports_first_in_a_fresh_interpreter(first):
    """No import cycle between the feed, the planner and the Job API: each
    imports first, then the rest, and a job runs."""
    code = (f"import {first}\n"
            "import numpy as np\n"
            "import repro_torch.core as core\n"
            "from repro_torch.data import SegmentFeed\n"
            "cfg = core.JobConfig(core.WordCount(50), task_size=8, n_procs=2)\n"
            "t = np.arange(200, dtype=np.int32) % 50\n"
            "r = core.submit(cfg, t, device='cpu').result()\n"
            "assert r.records == core.wordcount_oracle(t, 50)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(PORT.parent), REPO]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


@pytest.mark.parametrize("first", ["data.pipeline", "data.tokenizer",
                                   "optim", "train", "launch.train"])
def test_training_modules_import_first_in_a_fresh_interpreter(first):
    """Each training package or entry module imports first, then the
    rest, and one step of the launcher trains."""
    code = (f"import repro_torch.{first}\n"
            "import sys\n"
            "from repro_torch.launch.train import main\n"
            "losses = main(['--smoke', '--device', 'cpu', '--steps', '1', "
            "'--batch', '2', '--seq', '8'])\n"
            "assert len(losses) == 1\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(PORT.parent), REPO]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_smoke_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_smoke_alone_fails_without_result(tmp_path):
    """Copied alone into an empty directory, the script fails and prints
    no result (here: no card; on the GPU host: no package to import)."""
    (tmp_path / "chip_smoke.py").write_text(
        (Path(REPO) / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_smoke_phases_rehearse_on_cpu():
    """The smoke's phases at a tiny width on the CPU: the matrix through
    the wrapper (the plain version here), the bound, and the job phase
    with its oracle and fused == unfused checks."""
    cpu = torch.device("cpu")
    cases = [c for c in chip_smoke.fused_matrix() if c[0] != "full_width"]
    assert chip_smoke.phase_kernel_vs_plain(cpu, cases) == 0.0
    w = chip_smoke.Width(vocab=2048, n_procs=4, task=64, cap=16, segment=8)
    job = chip_smoke.phase_job(cpu, 1 << 13, 1 << 12, w)
    assert job["steps"] == 32 and job["launches"] == 0
    assert job["n_unfused"] == 1 << 12 and job["unfused_wall"] > 0
    assert job["n_records"] > 0 and job["imbalance"] > 1.0
    source, reps = chip_smoke.job_input(1 << 13, w)
    assert reps.shape == (4, 32) and reps[0, 0] == 8 and reps[1, 0] == 1
    assert np.asarray(source.read(0, 10)).max() < 2048


def test_smoke_compare_and_snapshot_phases_rehearse_on_cpu():
    """Phases 3b and 3c at a tiny width on the CPU: the three engines
    under each grid against the oracle (checked inside), the stealing
    job's passes and steals equal to the replay's, the oneshot runs and
    the Fig 6 buffers, the snapshots in turns, the restore of the older
    kept snapshot and the halfway re-plan."""
    _, data, _, _, _ = chip_smoke._port()
    cpu = torch.device("cpu")
    w = chip_smoke.Width(vocab=2048, n_procs=4, task=64, cap=16, segment=8)
    corpus = data.read_all(chip_smoke.job_input(1 << 15, w)[0])
    c = chip_smoke.phase_compare(cpu, corpus, w)
    assert c["steps"] == 128
    assert chip_smoke.ENGINES == ("2s", "1s", "1s+steal")
    for grid in chip_smoke.GRIDS:
        row = c[grid]
        assert row["1s"]["launches"] == row["2s"]["launches"] == 0
        assert row["1s+steal"]["launches"] == 0
        assert row["1s"]["segments"] == row["2s"]["segments"] == 16
        assert row["hot_rank_repeats"] >= row["mean_rank_repeats"]
        assert row["wall_2s_over_1s"] > 0
        assert row["wall_2s_over_1s_steal"] > 0
        st, replay = row["1s+steal"]["steal"], row["1s+steal"]["replay"]
        assert st["segments"] == 16 and st["schedule_s"] > 0
        assert st["passes"] == replay["passes"] <= row["lockstep_passes"]
        assert row["1s+steal"]["n_steals"] == replay["steals"]
        assert (replay["steals"] == 0) == (grid == "balanced")
    assert c["unbalanced"]["1s+steal"]["steal"]["passes"] < \
        c["unbalanced"]["lockstep_passes"]
    assert c["unbalanced"]["hot_rank_repeats"] == 8 * 128
    assert c["balanced"]["lockstep_passes"] == 128
    assert c["oneshot"]["2s"]["segments"] == 1
    a = c["oneshot"]["analytic"]
    assert a["send"] == 2 * 4 * 4 * 128 * 16 * 4
    assert a["2s"] - a["1s"] == 2 * a["send"] + a["overflow"] - a["input"]
    full = chip_smoke.fig6_bytes(chip_smoke.N_TOKENS)
    assert round(full["send"] / 1e9, 2) == 2.15
    assert round(full["overflow"] / 1e9, 2) == 1.07
    assert full["2s"] > 5.9e9 > 1.1e9 > full["1s"]
    chip_smoke.print_compare({**c, "seconds": 0.0}, w)
    s = chip_smoke.phase_snapshots(cpu, corpus, w)
    assert len(s["1s"]["plain_s"]) == len(s["1s"]["ckpt_s"]) == 2
    assert s["1s"]["restored_from"] == s["2s"]["restored_from"] == 64
    assert s["replan"]["columns_before"] == 64
    assert s["replan"]["tasks_after"] == 4 * 64
    assert s["replan"]["hot_rank_tasks_after"] < 256 // 8
    chip_smoke.print_snapshots({**s, "seconds": 0.0})


def test_smoke_keyskew_phase_rehearses_on_cpu():
    """Phase 3d at a tiny width on the CPU: every partitioner with and
    without stealing and the 2S job at the largest skew against the
    oracle (checked inside); the pre-pass on the sampled jobs only, split
    keys under split (checked inside) and only there, the model's and the
    windows' max/mean."""
    cpu = torch.device("cpu")
    w = chip_smoke.Width(vocab=2048, n_procs=4, task=64, cap=16, segment=8)
    c = chip_smoke.phase_keyskew(cpu, w, n=1 << 14, skews=(1.3, 1.8))
    assert set(c) == {"n", "1.3", "1.8"}
    for a, jobs in (("1.3", 6), ("1.8", 7)):
        rows = c[a]
        assert len(rows) == jobs + 1 and rows["records"] > 0
        for job, r in rows.items():
            if job == "records":
                continue
            part, backend = job.split(" ")
            assert r["launches"] == 0
            assert ("prepass_s" in r) == (part != "hash")
            assert r["sample_tasks_read"] == (0 if part == "hash" else 16)
            assert (r["n_split_keys"] > 0) == (part == "sampled+split")
            assert (r["n_steals"] > 0) == (backend == "1s+steal")
            assert r["model_imbalance"] >= 1.0
            assert r["window_imbalance"] >= 1.0
            assert len(r["window_records"]) == 4
        assert rows["sampled 1s"]["model_imbalance"] < \
            rows["hash 1s"]["model_imbalance"]
    assert "sampled+split 2s" in c["1.8"]
    chip_smoke.print_keyskew({**c, "seconds": 0.0}, w)


def test_smoke_fleet_phase_rehearses_on_cpu():
    """Phase 3e at a tiny width on the CPU: (a) the three use-cases'
    unfused fleets for each K and policy, (b) the fused WordCount fleet
    over slices of the corpus; every job equal to its solo run, the
    program count and the fifo and priority finish orders (all checked
    inside); no launch, no graph and no pinned byte on the CPU. The
    sizes' rules at full width: (a) fig11's, (b) summing to 2**27 in
    whole tasks, biggest first."""
    _, data, _, _, _ = chip_smoke._port()
    cpu = torch.device("cpu")
    wa = chip_smoke.Width(vocab=512, n_procs=4, task=64, cap=32, segment=1)
    wb = chip_smoke.Width(vocab=2048, n_procs=4, task=64, cap=16, segment=8)
    corpus = data.read_all(chip_smoke.job_input(1 << 15, wb)[0])
    c = chip_smoke.phase_fleet(cpu, corpus, wa, total_a=1 << 14,
                               ks=(1, 4), wb=wb, k_full=4)
    assert set(c["a"]) == {"1", "4"}
    for K, programs in (("1", 1), ("4", 3)):
        row = c["a"][K]
        assert len(row["jobs"]) == int(K)
        for policy in chip_smoke.FLEET_POLICIES:
            r = row[policy]
            assert r["n_unique_programs"] == programs
            assert r["launches"] == r["graphs_captured"] == 0
            assert r["pinned_high_water_bytes"] == 0
            assert r["feed_denials"] == r["budget_denials"]
            assert 0 < r["jain"] <= 1.0 + 1e-12
            assert r["makespan_s"] >= r["p95_latency_s"] > 0
    assert c["a"]["4"]["priority"]["finish_order"] == [
        "job-3", "job-2", "job-1", "job-0"]
    b = c["b"]
    sizes = [j["n_tokens"] for j in b["jobs"]]
    assert sum(sizes) == len(corpus) and sizes == sorted(sizes)[::-1]
    assert all(n % 64 == 0 for n in sizes)
    assert b["steps"] == sum(-(-(-(-n // 64) // 4) // 8) * 8 for n in sizes)
    for policy in chip_smoke.FLEET_POLICIES:
        assert b[policy]["n_unique_programs"] == 1
        assert b[policy]["launches"] == 0
        assert b[policy]["makespan_over_solo_sum"] > 0
    assert b["fifo"]["finish_order"] == [f"job-{k}" for k in range(4)]
    assert "fair_cycle" not in b                  # a card's profile
    full = chip_smoke.fleet_b_sizes(8, chip_smoke.N_TOKENS, chip_smoke.FULL)
    assert sum(full) == 2**27 and all(n % chip_smoke.TASK == 0 for n in full)
    assert full == sorted(full)[::-1] and full[0] > 2**26
    a16 = chip_smoke.fleet_a_sizes(16, chip_smoke.FLEET_A_TOKENS,
                                   chip_smoke.FLEET_A)
    assert len(a16) == 16 and min(a16) == 8 * 1024
    assert 8 * 8 * 1 * 1024 * 4 == 262_144              # (a)'s budget
    assert 4 * 8 * 512 * 256 * 4 == 16_777_216          # (b)'s budget
    chip_smoke.print_fleet({**c, "seconds": 0.0}, wa, wb)


def test_smoke_overlap_phase_rehearses_on_cpu():
    """Phase 3f at a tiny width on the CPU: resident and streamed in
    turns, every run's records equal to the oracle (checked inside), the
    streamed runs served by their prefetch, the resident runs by none."""
    _, data, _, _, _ = chip_smoke._port()
    cpu = torch.device("cpu")
    w = chip_smoke.Width(vocab=2048, n_procs=4, task=64, cap=16, segment=8)
    corpus = data.read_all(chip_smoke.job_input(1 << 15, w)[0])
    c = chip_smoke.phase_overlap(cpu, corpus, w, n=1 << 14)
    assert len(c["resident"]) == len(c["streamed"]) == 2
    for r in c["resident"]:
        assert r["prefetch_hits"] == 0 and r["segments"] == 8
    for r in c["streamed"]:
        assert r["prefetch_hits"] >= r["segments"] - 1 == 7
    assert c["overlap_win"] < 1.0
    chip_smoke.print_overlap({**c, "seconds": 0.0}, w)


def test_smoke_coded_phase_rehearses_on_cpu():
    """Phase 3g at a tiny width on the CPU: every arm's records equal to
    the oracle, no launch, r2+steal equal to the group replay, a group's
    members equal (all checked inside); the modelled bytes' ratios are
    fig15's; no profile off the card."""
    _, data, _, _, _ = chip_smoke._port()
    w = chip_smoke.Width(vocab=300, n_procs=6, task=64, cap=64, segment=0)
    corpus = data.synth_corpus(3072, 300, seed=0)
    c = chip_smoke.phase_coded(torch.device("cpu"), corpus, w,
                               skews=(0.0, 1.6))
    assert c["tasks_per_rank"] == 8
    for row in c["skews"].values():
        assert set(row) == set(chip_smoke.CODED_ARMS)
        for arm, e in row.items():
            assert len(e["walls_s"]) == chip_smoke.CODED_RUNS
            assert e["launches"] == 0 and e["steps"] == 8
            assert e["feed_bytes_read"] == 3072 * 4 * e["r"]
        assert row["r2"]["shuffle_ratio_to_r1"] == pytest.approx(0.6)
        assert row["r3"]["shuffle_ratio_to_r1"] == pytest.approx(0.4)
        assert row["r2+steal"]["passes"] > 0
    assert c["skews"]["1.6"]["r2+steal"]["n_steals"] > 0
    assert "profiles" not in c
    chip_smoke.print_coded({**c, "seconds": 0.0}, w)


def test_smoke_coded_fused_arm_runs_on_r1s_grid():
    """The r1-fused arm is r1's job with the fused step: same task size,
    same repeat grid, so the same records, steps and work rows (on the
    CPU through the kernel's plain version)."""
    _, data, _, _, _ = chip_smoke._port()
    cpu = torch.device("cpu")
    w = chip_smoke.Width(vocab=300, n_procs=6, task=64, cap=64, segment=0)
    corpus = data.synth_corpus(3072, 300, seed=0)
    T = chip_smoke.tasks_per_rank(len(corpus), w)
    reps = data.zipf_skew_repeats(6, T, 1.6, mean_rep=4, seed=1)
    cfgs = {arm: chip_smoke.coded_arm(arm, w) for arm in ("r1", "r1-fused")}
    assert cfgs["r1-fused"].fused_map and not cfgs["r1"].fused_map
    assert cfgs["r1-fused"].task_size == cfgs["r1"].task_size == 64
    got = {arm: chip_smoke.run_coded(cfg, corpus, reps, cpu)["result"]
           for arm, cfg in cfgs.items()}
    a, b = got["r1"], got["r1-fused"]
    assert a.records == b.records and len(a.records) > 0
    assert a.n_tasks == b.n_tasks == 48
    assert a.tasks_per_rank.tolist() == b.tasks_per_rank.tolist()
    assert a.work_per_rank.tolist() == b.work_per_rank.tolist() == \
        reps.sum(axis=1).tolist()
    full = chip_smoke.coded_arm("r1-fused")
    assert full.task_size == chip_smoke.CODED_W.task == 4096


def test_smoke_imbalance_phase_rehearses_on_cpu():
    """Phase 3j at a tiny width on the CPU: every arm under both skews and
    the wide-task job against the oracle and the unfused 1S job, the
    stealing arms against the host replay (checked inside); no launch and
    no kernel time off the card. Its full width is fig9's."""
    _, data, _, _, _ = chip_smoke._port()
    w = chip_smoke.Width(vocab=300, n_procs=4, task=64, cap=64, segment=0)
    corpus = data.synth_corpus(8192, 300, seed=0)
    c = chip_smoke.phase_imbalance(torch.device("cpu"), corpus, w,
                                   skews=(0.0, 1.6), wide_task=256)
    assert c["n"] == 8192 and c["tasks_per_rank"] == 32
    for s, row in c["skews"].items():
        assert row["replay"]["steals"] > 0
        for arm in chip_smoke.IMBALANCE_ARMS:
            e = row[arm]
            assert e["launches"] == 0 and e["steps"] == 32
            assert ("steal" in e) == arm.endswith("+steal")
            assert "kernel_device_ms" not in e
        assert row["wall_2s_over_1s"] > 0 and row["wall_2s_over_1s_fused"] > 0
    hot = c["skews"]["1.6"]
    assert hot["hot_rank_repeats"] > 2 * hot["mean_rank_repeats"]
    assert c["wide"]["task"] == 256 and c["wide"]["steps"] == 8
    w9 = chip_smoke.IMBALANCE_W
    assert (w9.n_procs, w9.task, w9.cap, w9.vocab, w9.segment) == \
        (8, 4096, 1024, 65536, 0)
    assert chip_smoke.tasks_per_rank(chip_smoke.IMBALANCE_N, w9) == 62
    assert chip_smoke.IMBALANCE_WIDE_TASK == 16384
    chip_smoke.print_imbalance({**c, "seconds": 0.0}, w)


def test_smoke_crossjob_phase_rehearses_on_cpu():
    """Phase 3h at a tiny width on the CPU: both fleets, every job equal
    to its solo run, one domain with cross-rank steals and its job_work
    the members' repeats (checked inside)."""
    w = chip_smoke.Width(vocab=512, n_procs=4, task=64, cap=32, segment=1)
    c = chip_smoke.phase_crossjob(torch.device("cpu"), w, total=1 << 14,
                                  ks=(4,))
    row = c["4"]
    assert len(row["jobs"]) == 4
    assert [j["n_tokens"] for j in row["jobs"]] == \
        chip_smoke.fleet_a_sizes(4, 1 << 14, w)
    for label in ("fair", "fair+cosched"):
        r = row[label]
        assert r["makespan_s"] >= r["p95_latency_s"] > 0
        assert 0 < r["jain"] <= 1.0 + 1e-12
    assert row["fair+cosched"]["n_domains"] == 1
    assert row["fair+cosched"]["job_work"] == [j["work"]
                                               for j in row["jobs"]]
    assert "n_domains" not in row["fair"]
    full = chip_smoke.fleet_a_sizes(16, chip_smoke.CROSS_TOTAL,
                                    chip_smoke.CROSS_W)
    assert len(full) == 16 and min(full) == 8 * 1024
    chip_smoke.print_crossjob({**c, "seconds": 0.0}, w)


def test_smoke_elastic_phase_rehearses_on_cpu():
    """Phase 3i at a tiny width on the CPU: (a) fig13's campaigns, every
    job equal to its solo run, both killed arms at P_new, recover
    restoring and restart restarting (checked inside); (b) the fused job
    re-meshed 4 -> 3 -> 4, every arm equal to the uninterrupted job's
    records (== oracle) and the fold's checksum to the twin's (checked
    inside); no launch and no graph on the CPU. fig13's width: each job
    96 columns at P 8."""
    _, data, _, _, _ = chip_smoke._port()
    cpu = torch.device("cpu")
    wa = chip_smoke.Width(vocab=64, n_procs=4, task=16, cap=32, segment=2)
    wb = chip_smoke.Width(vocab=2048, n_procs=4, task=64, cap=16, segment=8)
    corpus = data.read_all(chip_smoke.job_input(1 << 15, wb)[0])
    a = chip_smoke.phase_elastic_fleet(cpu, wa, 2048, 4, 3)
    assert (a["p"], a["p_new"], a["K"]) == (4, 3, 4)
    assert a["clean"]["final_p"] == 4 and not a["clean"]["recoveries"]
    for arm in ("recover", "restart"):
        [r] = a[arm]["recoveries"]
        assert r["tick"] == a["kill_tick"] > 0
        assert r["jobs_restored"] + r["jobs_scratch"] > 0
    assert a["mttr_s"] > 0 and a["recover_over_clean"] > 0
    b = chip_smoke.phase_elastic_job(cpu, corpus, wb, 1 << 15, 3)
    assert b["tasks"] == 512 and b["p8"]["steps"] == 128
    assert b["p8"]["first"]["steps"] == b["p8"]["second"]["steps"] == 64
    assert b["fold"]["windows"] == [4, 2048]
    assert b["fold"]["tasks_left"] == 256
    assert b["fold"]["columns_left"] == 86            # ceil(256 / 3)
    assert b["p6"]["steps"] == 88                     # 11 segments of 8
    assert b["p6p8"]["steps"] == 40
    for arm in ("p8", "p6", "p6p8"):
        assert b[arm]["launches"] == 0
        assert "graphs_captured" not in b[arm]
    a["seconds"] = b["seconds"] = 0.0
    chip_smoke.print_elastic({"a": a, "b": b, "seconds": 0.0}, wa, wb)
    T = chip_smoke.tasks_per_rank(chip_smoke.ELASTIC_TOKENS,
                                  chip_smoke.ELASTIC_W)
    assert T == 96


def test_smoke_flash_and_serve_phases_rehearse_on_cpu():
    """The flash_attention matrix through the wrapper (the plain version
    here), its bound, and the serve phase at a SMOKE config: served
    tokens checked, no kernel launched on the CPU."""
    from repro_torch.configs import get_smoke_config
    cpu = torch.device("cpu")
    errs = chip_smoke.phase_flash_vs_plain(cpu, chip_smoke.FLASH_MATRIX)
    assert set(errs) == set(chip_smoke.FLASH_MATRIX)
    assert max(errs.values()) == 0.0
    _, by, work = chip_smoke.flash_bound(chip_smoke.FLASH_SERVED)
    assert by == "operations" and work["bytes"] == 4 * 8 * 2048 * 16 * 128 * 2
    assert work["flops"] == 4 * 8 * 16 * 128 * (2048 * 2049 // 2)
    _, _, swa = chip_smoke.flash_bound(chip_smoke.FLASH_MATRIX["swa128_f32"])
    assert swa["flops"] == 4 * 4 * 64 * (128 * 129 // 2 + 384 * 128)
    serve = chip_smoke.phase_serve(cpu, get_smoke_config("olmo-1b"),
                                   requests=4, batch=2, prompt_len=64,
                                   new_tokens=4)
    assert serve["launches"] == {"flash_attention": 0}
    assert serve["served_tokens_per_s"] > 0
    assert serve["kernel_vs_ref_err_over_limit"] <= 1.0


def test_smoke_h2o_phases_rehearse_on_cpu():
    """h2o-danube-1.8b's part of the smoke: its full-width flash shapes
    and their bounds (the window of 4096 bites only at S 8192), and its
    serve phase at a narrow config with the served head dim of 80 (one
    batch, as the smoke serves it): served tokens checked, no kernel
    launched on the CPU."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    cpu = torch.device("cpu")
    assert chip_smoke.SERVE_ARCHS["h2o-danube-1.8b"] == chip_smoke.BATCH
    full = get_config("h2o-danube-1.8b")
    B, S, H, KV, hd, causal, window, _ = chip_smoke.FLASH_H2O
    assert (H, KV, hd, window) == (full.n_heads, full.n_kv_heads,
                                   full.d_head, full.sliding_window) \
        and hd == 80 and causal
    _, by, work = chip_smoke.flash_bound(chip_smoke.FLASH_H2O)
    assert by == "operations"
    assert work["flops"] == 4 * B * H * hd * (S * (S + 1) // 2)
    _, _, long = chip_smoke.flash_bound(chip_smoke.FLASH_H2O_LONG)
    S = chip_smoke.FLASH_H2O_LONG[1]
    assert long["flops"] == 4 * H * hd * (window * (window + 1) // 2
                                          + (S - window) * window)
    cfg = dataclasses.replace(get_smoke_config("h2o-danube-1.8b"),
                              n_heads=2, n_kv_heads=1, d_head=80)
    assert list(chip_smoke.serve_kernels(cfg)) == ["flash_attention"]
    serve = chip_smoke.phase_serve(cpu, cfg, requests=2, batch=2,
                                   prompt_len=48, new_tokens=4)
    assert serve["launches"] == {"flash_attention": 0}
    assert serve["served_tokens_per_s"] > 0
    assert serve["kernel_vs_ref_err_over_limit"] <= 1.0


def test_smoke_ssd_and_mamba_serve_phases_rehearse_on_cpu():
    """The ssd_scan matrix through the wrapper (the plain version here),
    the per-layer mixer check, and the mamba2 serve phases at the SMOKE
    config: served tokens checked, no kernel launched on the CPU."""
    from repro_torch.configs import get_smoke_config
    cpu = torch.device("cpu")
    errs = chip_smoke.phase_ssd_vs_plain(cpu, chip_smoke.SSD_MATRIX)
    assert set(errs) == set(chip_smoke.SSD_MATRIX)
    assert max(errs.values()) == 0.0
    cfg = get_smoke_config("mamba2-780m")
    assert list(chip_smoke.serve_kernels(cfg)) == ["ssd_scan"]
    serve = chip_smoke.phase_serve(cpu, cfg, requests=4, batch=2,
                                   prompt_len=40, new_tokens=4)
    assert serve["launches"] == {"ssd_scan": 0}
    assert serve["served_tokens_per_s"] > 0
    assert serve["layer_err_over_limit"] <= 1.0
    assert serve["kernel_vs_ref_err_over_limit"] <= 1.0   # two layers
    assert len(serve["drift"]) == 2
    for d in serve["drift"]:
        assert d["fp32_err_over_limit"] <= 1.0
        assert d["kernel_low_vs_fp32"] <= \
            chip_smoke.SSM_DRIFT_FACTOR * d["ref_low_vs_fp32"]
    mem = serve["memory"]
    assert mem["cache_storage_bytes"] == mem["cache_bytes"] > 0
    assert mem["logits_bytes"] == 2 * 40 * cfg.vocab_size * 2   # bf16


def test_smoke_moe_serve_phase_rehearses_on_cpu():
    """deepseek-v2-lite's part of phase 4 at its SMOKE config (MLA, one
    leading dense layer, two MoE layers): served tokens checked, the
    kernel path's logits against bucket_slots_ref's, every slot call of
    a prefill and of a decode step bit for bit (12 each: two layers x 2
    (G + 1)) at the prefill's and the decode's shapes, that decode
    step's logits equal to the plain path's, no kernel launched on the
    CPU; the launches it expects here and at full width (10 a layer and
    call, 26 MoE layers, a prefill and 31 decode steps) and the served
    shapes there; and the ``kernels`` entry it makes from the card's
    numbers."""
    from repro_torch.configs import get_config, get_smoke_config
    cpu = torch.device("cpu")
    cfg = get_smoke_config(chip_smoke.MOE_ARCH)
    assert chip_smoke.SERVE_ARCHS == dict.fromkeys(
        ("olmo-1b", "mamba2-780m", "h2o-danube-1.8b", chip_smoke.MOE_ARCH,
         chip_smoke.HYBRID_ARCH, "codeqwen1.5-7b", "stablelm-12b",
         chip_smoke.LLAMA4_ARCH, chip_smoke.VISION_ARCH,
         chip_smoke.AUDIO_ARCH), chip_smoke.BATCH)
    assert list(chip_smoke.serve_kernels(cfg)) == ["bucket_slots"]
    serve = chip_smoke.phase_serve(cpu, cfg, requests=2, batch=2,
                                   prompt_len=32, new_tokens=4)
    assert serve["launches"] == {"bucket_slots": 0}
    assert serve["served_tokens_per_s"] > 0
    assert serve["want_launches"] == {"bucket_slots": 2 * 3 * 2 * 4}
    assert serve["kernel_vs_ref_err_over_limit"] <= 1.0
    slots = serve["slots"]
    assert slots["calls"] == slots["decode_calls"] == 12
    assert slots["times"] == {}
    # (Tkg, 1) and (cap at 1.25, 8): the decode's 2 tokens, the prefill's 64
    assert slots["shapes"] == [(2, 1), (3, 8), (64, 1), (81, 8)]
    serve["seconds"] = 0.0
    chip_smoke.print_serve(serve)
    full = get_config(chip_smoke.MOE_ARCH)
    assert chip_smoke.serve_launches(full, 8, 8, 2048, 32) == \
        {"bucket_slots": 10 * 26 * 32}
    assert chip_smoke.slot_shapes(full, 8 * 2048) == \
        [(24_576, 1), (30_721, 64)] * 5
    assert chip_smoke.slot_shapes(full, 8) == [(12, 1), (16, 64)] * 5
    assert chip_smoke.serve_launches(get_config("olmo-1b"), 16, 8, 2048,
                                     32) == {"flash_attention": 32}
    # the kernels line's entry, from numbers shaped as the card's
    t = dict(ms=0.02, plain_ms=1.0, bound_ms=1e-4, bound_by="bytes",
             library_ms=None, device_ms=0.006,
             device_activities_per_call=1.0)
    serve["slots"]["times"] = {"served_T24576_E1": {**t, "bytes": 196_612},
                               "served_T30721_E64": {**t, "bytes": 246_024}}
    entry = {"name": "bucket_slots", "launches": 2, "max_abs_err": 0,
             **t, "shape": "slots_routing", "slots_owner_window": t}
    e = chip_smoke.served_slots_kernel({chip_smoke.MOE_ARCH: serve}, {},
                                       entry)
    arch = chip_smoke.MOE_ARCH
    assert e["launches"] == 0 and e["shape"] == f"{arch} served_T30721_E64"
    assert e["launches_by_path"]["entry points"] == 2
    assert e["served_calls_checked"] == {arch: {"prefill": 12,
                                                "decode_step": 12}}
    assert set(e) >= {f"{arch} served_T24576_E1", "slots_routing",
                      "slots_owner_window", "ms", "plain_ms", "bound_ms",
                      "bound_by", "library_ms"}


def test_smoke_hybrid_serve_and_moe_train_phases_rehearse_on_cpu():
    """jamba-v0.1's part of phase 4 at a narrow bf16 config (one period,
    head dims the kernels take): the three kernels it expects, served
    tokens checked, the mixers on the kernel path's input, the stack
    against fp32 streamed a layer at a time with the bf16 kernel path's
    routing, every slot call bit for bit, no kernel launched on the CPU;
    the launches at full width. Then deepseek-v2-lite's part of phase 5
    at its SMOKE config: the launches it expects (twice a layer's slotting
    under full remat), one microbatch's slots under full remat and remat
    none, and A = 2 against A = 1."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(
        get_smoke_config(chip_smoke.HYBRID_ARCH), d_model=256, n_heads=4,
        n_kv_heads=2, d_head=64, d_ff=256, d_ff_expert=256, ssm_head_dim=64,
        ssm_chunk=64)
    assert list(chip_smoke.serve_kernels(cfg)) == [
        "flash_attention", "ssd_scan", "bucket_slots"]
    serve = chip_smoke.phase_serve(cpu, cfg, requests=3, batch=2,
                                   prompt_len=192, new_tokens=4)
    assert serve["launches"] == dict.fromkeys(serve["want_launches"], 0)
    assert serve["want_launches"] == {"flash_attention": 2, "ssd_scan": 14,
                                      "bucket_slots": 4 * (6 + 3 * 6)
                                      + 4 * (6 + 3 * 4)}
    assert serve["layer_err_over_limit"] <= 1.0
    (d,) = serve["drift"]
    assert d["rows"] == chip_smoke.DRIFT_ROWS and len(d["reroutes"]) == 3
    assert d["kernel_low_vs_fp32"] <= \
        chip_smoke.SSM_DRIFT_FACTOR * d["ref_low_vs_fp32"]
    assert serve["slots"]["calls"] == serve["slots"]["decode_calls"] == 24
    full = dataclasses.replace(get_config(chip_smoke.HYBRID_ARCH),
                               n_layers=chip_smoke.SERVE_LAYERS[
                                   chip_smoke.HYBRID_ARCH])
    assert chip_smoke.serve_launches(full, 8, 8, 2048, 32) == {
        "flash_attention": 1, "ssd_scan": 7, "bucket_slots": 1280}
    assert chip_smoke.slot_shapes(full, 8 * 2048) == \
        [(8_192, 1), (10_241, 16)] * 5
    assert chip_smoke.slot_shapes(full, 8) == [(4, 1), (6, 16)] * 5

    moe = get_smoke_config(chip_smoke.MOE_ARCH)
    t = chip_smoke.phase_train(cpu, moe, seq=64, batch=8, microbatch=4,
                               steps=6, resume_at=0, n_tokens=100_000)
    assert not any(t["launches"].values())
    assert t["want_launches"] == {"bucket_slots": 6 * 2 * 2 * 2 * 6}
    assert t["slots"]["calls_full"] == 2 * t["slots"]["calls_none"] == 24
    assert t["slots"]["shapes"] == [(256, 1), (321, 8)]
    assert t["slots"]["remat_grads_bitwise"]
    assert "resumed" not in t and t["grad_accum"] == 2
    chip_smoke.print_train(t)
    deep = dataclasses.replace(get_config(chip_smoke.MOE_ARCH),
                               n_layers=chip_smoke.TRAIN_LAYERS[
                                   chip_smoke.MOE_ARCH])
    run, _, _ = chip_smoke.train_state(moe, cpu, 512, 8, 4, 1)
    run = dataclasses.replace(run, model=deep)
    assert chip_smoke.train_launches(deep, run, 10) == {
        "bucket_slots": 3 * 10 * 2 * 2 * 10}
    assert chip_smoke.slot_shapes(deep, 4 * 512) == \
        [(3_072, 1), (3_841, 64)] * 5


def test_smoke_new_arch_phases_rehearse_on_cpu():
    """codeqwen1.5-7b's, stablelm-12b's and llama4-maverick's parts of
    phases 2 and 4: the hd-160 flash cases through the wrapper (the plain
    version here), the three served flash shapes against the archs'
    configs and their bounds, the E 128 slots case; then phase 4 at
    narrow configs (codeqwen's SMOKE; stablelm at its head dim of 160;
    llama4 with one dense and one MoE layer of 128 experts top-1 and the
    shared expert): served tokens checked, the kernel path against the
    plain path (llama4's on its routing), every slot call bit for bit,
    no kernel launched on the CPU; and the launches and slot shapes that
    phase 4 expects at full width and its served depths (8 / 40 / 2
    flash_attention, 320 bucket_slots)."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    cpu = torch.device("cpu")
    hd160 = {n: c for n, c in chip_smoke.FLASH_MATRIX.items() if c[4] == 160}
    assert {c[7] for c in hd160.values()} == {"float32", "bfloat16"}
    assert any(not c[5] for c in hd160.values())           # no causal mask
    assert any(c[6] for c in hd160.values())               # a window
    assert any(len(c) > 8 and c[8] > c[1] for c in hd160.values())
    assert any(len(c) > 8 and c[8] < c[1] for c in hd160.values())
    errs = chip_smoke.phase_flash_vs_plain(cpu, hd160)
    assert set(errs) == set(hd160) and max(errs.values()) == 0.0
    timed = chip_smoke.FLASH_TIMED
    for arch in ("codeqwen1.5-7b", "stablelm-12b", chip_smoke.LLAMA4_ARCH):
        full = get_config(arch)
        case = timed[arch]
        assert case in chip_smoke.FLASH_FULL.values()
        assert case[:5] == (chip_smoke.BATCH, chip_smoke.PROMPT_LEN,
                            full.n_heads, full.n_kv_heads, full.d_head)
    bound, by, work = chip_smoke.flash_bound(timed["stablelm-12b"])
    assert by == "operations" and round(work["flops"] / 1e9, 1) == 343.8
    assert round(bound, 4) == 0.3476
    assert chip_smoke.flash_bound(timed["codeqwen1.5-7b"])[2]["flops"] == \
        chip_smoke.flash_bound(timed[chip_smoke.HYBRID_ARCH])[2]["flops"]
    assert chip_smoke.SLOTS_MATRIX["E128_llama4"] == (5121, 128, "invalid")

    stablelm = dataclasses.replace(
        get_smoke_config("stablelm-12b"), n_layers=2, d_model=320,
        n_heads=2, n_kv_heads=1, d_head=160, d_ff=192)
    llama4 = dataclasses.replace(
        get_smoke_config(chip_smoke.LLAMA4_ARCH), n_layers=2,
        n_experts=128)
    for cfg, want in ((get_smoke_config("codeqwen1.5-7b"),
                       {"flash_attention": 2}),
                      (stablelm, {"flash_attention": 2}),
                      (llama4, {"flash_attention": 2,
                                "bucket_slots": 2 * 3 * (1 + 3)})):
        serve = chip_smoke.phase_serve(cpu, cfg, requests=2, batch=2,
                                       prompt_len=48, new_tokens=4)
        assert serve["want_launches"] == want
        assert serve["launches"] == dict.fromkeys(want, 0)
        assert serve["served_tokens_per_s"] > 0
        assert serve["kernel_vs_ref_err_over_limit"] <= 1.0
        assert serve["layer_err_over_limit"] <= 1.0
    assert serve["slots"]["calls"] == serve["slots"]["decode_calls"] == 6
    assert serve["slots"]["shapes"] == [(1, 1), (2, 128), (48, 1),
                                        (61, 128)]
    serve["seconds"] = 0.0
    chip_smoke.print_serve(serve)
    for arch, want in (("codeqwen1.5-7b", {"flash_attention": 8}),
                       ("stablelm-12b", {"flash_attention": 20}),
                       (chip_smoke.LLAMA4_ARCH, {"flash_attention": 2,
                                                 "bucket_slots": 320})):
        full = get_config(arch)
        if arch in chip_smoke.SERVE_LAYERS:
            full = dataclasses.replace(
                full, n_layers=chip_smoke.SERVE_LAYERS[arch])
        assert chip_smoke.serve_launches(full, 8, 8, 2048, 32) == want
    assert [m for m in chip_smoke.layer_kinds(full)] == [
        ("attn", "mlp"), ("attn", "moe")]
    assert chip_smoke.slot_shapes(full, 8 * 2048) == \
        [(4_096, 1), (5_121, 128)] * 5
    assert chip_smoke.slot_shapes(full, 8) == [(2, 1), (3, 128)] * 5
    assert round(full.param_count() / 1e9, 2) == 18.55


def test_smoke_entry_point_phases_rehearse_on_cpu():
    """The hist, bucket_slots and flash_decode matrices through their
    wrappers (the plain versions here), the entry-point phase at a tiny
    width (counts zeroed and read, each output held to its plain
    version, no kernel launched on the CPU), flash_decode's bf16 outputs
    against the control of p rounded to bf16, and the full-width bounds."""
    cpu = torch.device("cpu")
    matrix = chip_smoke.matrix_cases(cpu)
    errs = chip_smoke.check_cases(matrix)
    chip_smoke.check_decode_edges(matrix)
    assert set(errs) == (
        {f"hist_{n}" for n in chip_smoke.HIST_MATRIX}
        | {f"slots_{n}" for n in chip_smoke.SLOTS_MATRIX}
        | {f"decode_{n}" for n in chip_smoke.DECODE_MATRIX})
    assert max(errs.values()) == 0.0
    # the control of p rounded to bf16 moves a large share of the bf16
    # outputs' bits, which the kernel's gate holds it well below
    bits = chip_smoke.check_decode_bits(matrix)
    assert set(bits) == {f"decode_{n}" for n, c in
                         chip_smoke.DECODE_MATRIX.items() if c[6] == "bfloat16"}
    assert all(b["kernel"] == 0.0 and b["p_bf16"] > 0.25
               for b in bits.values())
    assert set(chip_smoke.DECODE_FULL_F32) == {"olmo-1b_f32",
                                               "h2o-danube-1.8b_f32"}
    w = chip_smoke.Width(vocab=2048, n_procs=4, task=64, cap=16, segment=8)
    source, _ = chip_smoke.job_input(1 << 13, w)
    from repro_torch.data import read_all
    cases = chip_smoke.entry_cases(
        cpu, read_all(source), w, routing=(3000, 16),
        decode={"tiny_gqa": (2, 200, 8, 2, 80, 150, "bfloat16")})
    assert set(cases) == {"hist_count", "hist_owner", "hist_count_uniform",
                          "hist_owner_uniform", "slots_routing",
                          "slots_owner_window", "decode_tiny_gqa"}
    entry = chip_smoke.phase_entry(cpu, cases)
    assert entry["launches"] == {"hist": 0, "bucket_slots": 0,
                                 "flash_decode": 0}
    assert set(entry["max_abs_err"]) == set(cases)
    assert set(entry["bits_off"]) == {"decode_tiny_gqa"}
    assert cases["hist_owner"]["run"]().shape == (4,)
    assert int(cases["slots_owner_window"]["run"]()[1].sum()) == 4 * 8 * 64
    assert cases["hist_count"]["library"] is not None
    assert cases["slots_routing"]["library"] is None
    full = chip_smoke.hist_bound(chip_smoke.N_TOKENS, chip_smoke.VOCAB, 0)
    assert full[1] == "bytes" and full[2]["bytes"] == 537_919_488
    routing = chip_smoke.slots_bound(*chip_smoke.ROUTING)
    assert routing[2]["bytes"] == 786_688
    olmo = chip_smoke.decode_bound(chip_smoke.DECODE_FULL["olmo-1b"])
    assert olmo[1] == "bytes" and round(olmo[0], 4) == 0.0407


def test_smoke_train_phase_rehearses_on_cpu():
    """Phase 5 at the olmo-1b SMOKE config on the CPU: two microbatches a
    step, full remat, the snapshot after step 3; its checks (a)-(d) hold
    (inside), no kernel is launched, and the resumed losses equal the
    uninterrupted run's bit for bit here. At full width the run is
    olmo-1b's published shape in bf16 with fp32 moments, A = 2."""
    from repro_torch.configs import get_config, get_smoke_config
    t = chip_smoke.phase_train(torch.device("cpu"),
                               get_smoke_config("olmo-1b"), seq=64, batch=4,
                               microbatch=2, steps=10, n_tokens=50_000)
    assert t["grad_accum"] == 2 and t["remat"] == "full"
    assert len(t["losses"]) == 10 and not any(t["launches"].values())
    assert t["resume_bitwise"] and t["resume_max_rel_diff"] == 0.0
    assert set(t["accum"]) == {"1", "2"}
    assert t["accum_rel"]["loss"] <= chip_smoke.TRAIN_ACCUM_RTOL["loss"]
    assert t["profile"] is None and t["mfu"] is None
    assert t["tokens_per_s"] > 0
    chip_smoke.print_train(t)
    cfg = get_config(chip_smoke.TRAIN_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == \
        (16, 2048, 8192, 50_304)
    assert cfg.param_dtype == "bfloat16"
    assert round(cfg.param_count() / 1e9, 2) == 1.18
    run, _, state = chip_smoke.train_state(
        get_smoke_config("olmo-1b"), torch.device("cpu"),
        chip_smoke.TRAIN_SEQ, chip_smoke.TRAIN_BATCH,
        chip_smoke.TRAIN_MICROBATCH, chip_smoke.TRAIN_STEPS)
    assert run.grad_accum_steps == 2 and run.train.remat_policy == "full"
    assert run.train.moment_dtype == "float32"
    assert (run.train.lr, run.train.warmup_steps, run.train.total_steps) \
        == (3e-3, 1, 20)
    assert state.opt.mu[0].dtype == torch.float32
    tokens = chip_smoke.TRAIN_SEQ * chip_smoke.TRAIN_BATCH
    assert chip_smoke.train_flops(cfg, 512, 8) == \
        6 * cfg.param_count() * tokens + 6 * 16 * 512 * 2048 * tokens


def test_smoke_frontend_phases_rehearse_on_cpu():
    """internvl2-26b's and whisper-tiny's parts of phases 2 and 4: their
    three flash shapes against the archs' configs (whisper's encoder in
    fp32 without the causal mask, bound at the fp32 CUDA-core rate) and
    through the wrapper at a short S (the plain version here); then phase
    4 at their SMOKE configs at a context of 64, split as
    ``frontend_geometry`` splits it (a 16-row prefix and 48 text tokens;
    32 frames and 64 text tokens): served tokens checked, the kernel path
    against the plain path, every encoder and decoder layer's attention
    on the kernel path's input, no kernel launched on the CPU; and the
    launches phase 4 expects at full width (48 and 8 a batch: whisper's
    4 encoder layers count)."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    cpu = torch.device("cpu")
    timed = chip_smoke.FLASH_TIMED
    vis, aud = chip_smoke.VISION_ARCH, chip_smoke.AUDIO_ARCH
    for key, arch, S, causal, dtype in (
            (vis, vis, 2048, True, "bfloat16"),
            (f"{aud} encoder", aud, 1024, False, "float32"),
            (aud, aud, 2048, True, "bfloat16")):
        full = get_config(arch)
        case = timed[key]
        assert case in chip_smoke.FLASH_FULL.values()
        assert case == (chip_smoke.BATCH, S, full.n_heads, full.n_kv_heads,
                        full.d_head, causal, 0, dtype)
    bound, by, work = chip_smoke.flash_bound(timed[vis])
    assert by == "operations" and round(work["flops"] / 1e9, 1) == 412.5
    assert round(bound, 3) == 0.417
    bound, by, work = chip_smoke.flash_bound(timed[f"{aud} encoder"])
    assert work["flops"] == 4 * 8 * 6 * 64 * 1024 * 1024     # every pair
    assert by == "operations" and round(bound, 3) == 0.192   # 67 TFLOP/s
    short = {n: (1, 96) + c[2:] for n, c in chip_smoke.FLASH_FULL.items()
             if n.startswith(("internvl2", "whisper"))}
    assert len(short) == 3
    errs = chip_smoke.phase_flash_vs_plain(cpu, short)
    assert max(errs.values()) == 0.0

    for arch, want, rows, text in ((vis, 2 * 2, 16, 48),
                                   (aud, 2 * (2 + 2), 32, 64)):
        cfg = get_smoke_config(arch)
        serve = chip_smoke.phase_serve(cpu, cfg, requests=3, batch=2,
                                       prompt_len=64, new_tokens=4)
        assert serve["want_launches"] == {"flash_attention": want}
        assert serve["launches"] == {"flash_attention": 0}
        assert (serve["frontend_rows"], serve["text_len"]) == (rows, text)
        assert serve["served_tokens_per_s"] > 0
        assert serve["kernel_vs_ref_err_over_limit"] <= 1.0
        assert serve["layer_err_over_limit"] <= 1.0
        serve["seconds"] = 0.0
        chip_smoke.print_serve(serve)
    # internvl2's bf16 paths drift apart at 48 layers on the card: under
    # its name the stack is held to its own weights in fp32, streamed a
    # layer at a time, its prefix prepended in fp32
    cfg = dataclasses.replace(get_smoke_config(vis), name=vis)
    serve = chip_smoke.phase_serve(cpu, cfg, requests=2, batch=2,
                                   prompt_len=64, new_tokens=4)
    (d,) = serve["drift"]
    assert d["rows"] == chip_smoke.DRIFT_ROWS and d["reroutes"] == [
        {"calls": 0, "rows": 0, "max_gap": 0.0}] * 3
    assert d["fp32_err_over_limit"] <= 1.0
    assert d["kernel_low_vs_fp32"] <= \
        chip_smoke.SSM_DRIFT_FACTOR * d["ref_low_vs_fp32"]
    prompts, fe, ahead = chip_smoke.serve_inputs(get_config(vis), 8, 2048)
    assert prompts.shape == (8, 1536) and fe.shape == (8, 512, 6144)
    assert fe.dtype == np.float32 and ahead == 2048
    prompts, fe, ahead = chip_smoke.serve_inputs(get_config(aud), 8, 2048)
    assert prompts.shape == (8, 2048) and fe.shape == (8, 1024, 384)
    assert ahead == 2048
    for arch, want in ((vis, 24), (aud, 8)):
        full = get_config(arch)
        if arch in chip_smoke.SERVE_LAYERS:
            full = dataclasses.replace(
                full, n_layers=chip_smoke.SERVE_LAYERS[arch])
        assert chip_smoke.serve_launches(full, 8, 8, 2048, 32) == \
            {"flash_attention": want}


def test_the_scans_cover_the_mesh_modules():
    """The import checks reach the virtual mesh, the sharding rules and
    the collectives its shard_map lives in."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"distributed/mesh.py", "distributed/sharding.py",
            "distributed/collectives.py", "launch/specs.py"} <= names


def test_the_mesh_and_its_engines_need_a_card_unless_asked(monkeypatch):
    """``local_mesh`` and ``make_mesh`` are on cuda unless the caller
    names the CPU; without a card they raise. A mesh's operands must live
    on its device: a CPU tensor under a cuda mesh raises (no fallback to
    the CPU), and so does an engine whose mesh is elsewhere."""
    from repro_torch.config import MeshConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import collectives
    from repro_torch.distributed import mesh as tmesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine as eng
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tmesh.local_mesh((2, 4)),
                 lambda: tmesh.make_mesh(MeshConfig((2, 4)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    cpu = tmesh.local_mesh((2, 4), device="cpu")
    assert cpu.device == torch.device("cpu") and cpu.devices.shape == (2, 4)
    cfg = get_smoke_config(chip_smoke.MOE_ARCH)
    model = tf.init_model(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.ServeEngine(cfg, model, max_len=16, mesh=cpu)
    card = tmesh.Mesh((2, 4), ("data", "model"), torch.device("cuda", 0))
    with pytest.raises(ValueError, match="on cuda:0"):
        eng.ServeEngine(cfg, model, max_len=16, mesh=card, device="cpu")
    x = torch.zeros((2, 8, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="meets a mesh on cuda:0"):
        moe.moe_forward(cfg, model["blocks"][1]["moe"], x, mesh=card,
                        dp_entry="data")
    with pytest.raises(ValueError, match="meets a mesh on cuda:0"):
        collectives.block(torch.zeros(8), ("data",), card)


def test_smoke_mesh_phases_rehearse_on_cpu():
    """Phases 4m and 5m at deepseek-v2-lite's SMOKE width on the CPU
    (the kernels' plain versions: no launch), and their counts at the
    full widths the card runs."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    cpu = torch.device("cpu")
    cfg = get_smoke_config(chip_smoke.MOE_ARCH)
    s = chip_smoke.phase_mesh_serve(cpu, cfg, requests=2, prompt_len=16,
                                    new_tokens=2)
    chip_smoke.print_mesh_serve(s)
    assert s["launches"] == {"bucket_slots": 0}
    # 2 MoE layers: 2 pipeline steps of 3 (peer and expert slotting for
    # all 8 shards in one call each), then one replicated decode step
    assert s["want_launches"] == {"bucket_slots": 2 * (3 * 2 + 1)}
    assert s["slots"]["calls"] == 12 and s["slots"]["decode_calls"] == 2
    assert s["slots"]["shapes"] == [(16, 16), (32, 32), (64, 16)]
    assert s["no_drop_factor"] >= cfg.capacity_factor
    assert max(s["against_unsharded"]["err_over_max"].values()) \
        <= chip_smoke.MESH_LOGITS_TOL
    t = chip_smoke.phase_mesh_train(cpu, cfg, seq=16, batch=4, microbatch=2,
                                    steps=2)
    chip_smoke.print_mesh_train(t)
    assert t["launches"] == {}
    assert t["want_launches"] == {"bucket_slots": 2 * 6 * 2 * 2 * 2}
    assert t["step0_rel"] <= chip_smoke.MESH_TRAIN_RTOL

    full = {a: dataclasses.replace(get_config(a), n_layers=n)
            for a, n in chip_smoke.MESH_ARCHS.items()}
    ds, l4 = full[chip_smoke.MOE_ARCH], full[chip_smoke.LLAMA4_ARCH]
    assert chip_smoke.mesh_slot_shapes(ds, 8, 2048) == \
        [(24_576, 32), (30_752, 128)] * 5
    assert chip_smoke.mesh_slot_shapes(ds, 8, 1) == [(192, 128)]
    assert chip_smoke.mesh_slot_shapes(l4, 8, 2048) == \
        [(4_096, 32), (5_152, 256)] * 5
    assert chip_smoke.mesh_serve_launches(ds, 8, 2048, 16) == {
        "bucket_slots": 3 * (10 + 15)}
    assert chip_smoke.mesh_serve_launches(l4, 8, 2048, 16) == {
        "flash_attention": 2, "bucket_slots": 10 + 15}
    # past 256 buckets: one call a group of shards that fits
    wide = dataclasses.replace(l4, n_experts=512)
    assert chip_smoke.mesh_slot_shapes(wide, 8, 1) == [(8, 256)] * 4
    run, _, _ = chip_smoke.train_state(cfg, cpu, 512, 8, 4, 1,
                                       mesh=chip_smoke._mesh(cpu))
    deep = dataclasses.replace(get_config(chip_smoke.MOE_ARCH),
                               n_layers=chip_smoke.TRAIN_LAYERS[
                                   chip_smoke.MOE_ARCH])
    assert chip_smoke.mesh_train_launches(
        deep, dataclasses.replace(run, model=deep), 3) == {
        "bucket_slots": 3 * 10 * 2 * 2 * 3}


def test_smoke_serve_and_examples_phases_rehearse_on_cpu():
    """Phase 4s over every SMOKE config on the CPU (the kernels' plain
    versions: no launch), with the launches the card must show; phase 6
    with one example run on the CPU in its child (each example is held
    to the reference in ``tests/test_torch_examples.py``)."""
    from repro_torch.configs import ARCH_IDS
    cpu = torch.device("cpu")
    s = chip_smoke.phase_smoke_serves(cpu)
    assert set(s) == {*ARCH_IDS, "seconds"}
    for arch in ARCH_IDS:
        assert not any(s[arch]["launches"].values())
        assert s[arch]["logits_err_over_limit"] < float("inf")
    assert [s[a]["fp32_logits_err_over_limit"] is not None
            for a in ARCH_IDS] == [a in chip_smoke.SMOKE_FP32
                                   for a in ARCH_IDS]
    want = {a: s[a]["want_launches"] for a in ARCH_IDS}
    assert want["olmo-1b"] == want["codeqwen1.5-7b"] == \
        want["h2o-danube-1.8b"] == {"flash_attention": 2}
    assert want["stablelm-12b"] == {"flash_attention": 3}
    assert want["whisper-tiny"] == {"flash_attention": 4}   # 2 encoder
    assert want["mamba2-780m"] == {"ssd_scan": 2}
    assert want["jamba-v0.1-52b"]["ssd_scan"] == 7
    assert want["jamba-v0.1-52b"]["flash_attention"] == 1
    assert "flash_attention" not in want["deepseek-v2-lite-16b"]   # MLA
    name = "streaming_wordcount_torch.py"
    ex = chip_smoke.phase_examples([name], extra=("--device", "cpu"))
    chip_smoke.print_examples(ex)
    assert set(ex) == {name, "seconds"}
    assert set(chip_smoke.EXAMPLE_RUNS) == {
        f"{n}_torch.py" for n in ("serve_lm", "train_lm", "skewed_wordcount",
                                  "streaming_wordcount", "wordcount_puma")}
    assert any("MR-1S == MR-2S" in line
               for line in ex["streaming_wordcount_torch.py"]["lines"])
