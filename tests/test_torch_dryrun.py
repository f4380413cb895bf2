"""The port's dry run (``launch/dryrun.py``, ``launch/hlo_stats.py``,
``launch/mesh.py``, ``launch/specs.py``) against the reference's (its
compiled programs in one 4-device subprocess, made once a module).

  * the wire math on ``tests/test_serve_hlo.py``'s sizes, given as
    recorded collectives; ``_extrapolate`` on the reference's numbers
    (78.0) and against the reference's function on seeded dicts;
  * per-device ``argument_size_in_bytes`` equal to the reference's
    ``memory_analysis()`` for the six cells of
    ``tests/test_dryrun_builders.py`` (SMOKE configs,
    ``ShapeConfig("t", 64, 4, kind)``, a (data 2, model 2) mesh);
  * olmo-1b SMOKE prefill's FLOPs equal to a closed form from parameter
    shapes; ``calibrate``'s extrapolation equal to the direct count at
    A = 2; every ``VARIANTS`` entry builds and runs on SMOKE configs; the
    meter's own meta outputs equal torch's meta kernels';
  * at full width on ``meta``: ``run_cell("olmo-1b", "train_4k")``
    without calibration ``ok`` in under 30 s, and ``pp_pod``'s permutes
    in closed form;
  * the kernel policy's meta rule.
"""
import dataclasses
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import MeshConfig, ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed.mesh import local_mesh  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops as sl_ops  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import hlo_stats  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     mesh_config)
from torch_parity import REPO  # noqa: E402

META = torch.device("meta")
MESH = (2, 2)
AXES = ("data", "model")
# the six cells of tests/test_dryrun_builders.py
CELLS = [("olmo-1b", "train"), ("olmo-1b", "prefill"), ("olmo-1b", "decode"),
         ("llama4-maverick-400b-a17b", "train"),
         ("llama4-maverick-400b-a17b", "decode"), ("mamba2-780m", "decode")]
N_SEEDED = 5


def seeded_dicts(i):
    rng = np.random.default_rng(100 + i)
    c11, c21, c12 = ({k: float(rng.integers(1, 1000)) for k in ("flops",
                                                               "b")}
                     for _ in range(3))
    NB, A = (int(x) for x in rng.integers(1, 9, 2))
    return c11, c21, c12, NB, A


def shape_of(kind):
    return ShapeConfig("t", 64, 4, kind)


@pytest.fixture(scope="module")
def ref(devices8, tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    devices8(f"""
        import json, sys
        import jax
        sys.path.insert(0, {REPO!r} + "/tests")
        from repro.config import MeshConfig, ShapeConfig
        from repro.configs.registry import get_smoke_config
        from repro.distributed.mesh import local_mesh
        from repro.launch import dryrun as dr
        from test_torch_dryrun import AXES, CELLS, MESH, N_SEEDED, seeded_dicts

        mesh = local_mesh(MESH, AXES)
        mesh_cfg = MeshConfig(MESH, AXES)
        out = {{"args": {{}}, "extrapolate": []}}
        for arch, kind in CELLS:
            fn, args, in_sh, _ = dr.build_cell(
                get_smoke_config(arch), ShapeConfig("t", 64, 4, kind), mesh,
                mesh_cfg)
            ma = jax.jit(fn, in_shardings=in_sh).lower(
                *args).compile().memory_analysis()
            out["args"][arch + "/" + kind] = int(ma.argument_size_in_bytes)
        for i in range(N_SEEDED):
            c11, c21, c12, NB, A = seeded_dicts(i)
            out["extrapolate"].append(dr._extrapolate(
                c11, c21, c12, NB, A, keys=("flops", "b")))
        with open({str(d / "ref.json")!r}, "w") as f:
            json.dump(out, f)
        print("OK")
    """, n_devices=4)
    import json
    return json.loads((d / "ref.json").read_text())


def mesh():
    return local_mesh(MESH, AXES, device=META)


def mcfg():
    return MeshConfig(MESH, AXES)


# ---------------------------------------------------------------------------
# collective bytes and the extrapolation
# ---------------------------------------------------------------------------

def test_collective_bytes_wire_math():
    rec = [{"kind": "all-reduce", "result_bytes": 32 * 4096 * 4,
            "group": 16},
           {"kind": "all-gather", "result_bytes": 32 * 4096 * 3144 * 2,
            "group": 2},
           {"kind": "all-gather", "result_bytes": 512 * 4, "group": 4},
           {"kind": "reduce-scatter", "result_bytes": 16 * 128 * 4,
            "group": 16},
           {"kind": "collective-permute", "result_bytes": 16 * 4096 * 4,
            "group": 2},
           {"kind": "all-to-all", "result_bytes": 8 * 64 * 2, "group": 8}]
    got = hlo_stats.collective_bytes(rec)
    np.testing.assert_allclose(got["all-reduce"], 2 * 15 / 16 * 32 * 4096 * 4)
    np.testing.assert_allclose(got["all-gather"],
                               0.5 * 32 * 4096 * 3144 * 2 + 3 / 4 * 512 * 4)
    np.testing.assert_allclose(got["reduce-scatter"], 16 * 128 * 4 * 15)
    np.testing.assert_allclose(got["collective-permute"], 16 * 4096 * 4)
    np.testing.assert_allclose(got["all-to-all"], 7 / 8 * 8 * 64 * 2)
    assert got["n_all-gather"] == 2 and got["n_all-reduce"] == 1
    assert got["total"] == sum(got[k] for k in (
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"))


def test_the_counter_records_what_the_collectives_report():
    """One rank's result bytes and the axis size of each named-axis
    collective, an all-gather's result g times its operand; nothing a
    program computes changes under the counter."""
    m = local_mesh((2, 4), AXES, device="cpu")
    x = torch.arange(2 * 4 * 3 * 5, dtype=torch.float32).view(2, 4, 3, 5)
    with hlo_stats.CollectiveCounter() as cc:
        s = collectives.mesh_psum(x, "model", m)
        g = collectives.mesh_all_gather(x, "data", m)
        p = collectives.mesh_ppermute(x, "model", [(0, 1), (1, 2)], m)
        a = collectives.mesh_all_to_all(
            torch.ones((2, 4, 4, 5)), "model", m)
    assert collectives.OBSERVER is None
    assert torch.equal(s, collectives.mesh_psum(x, "model", m))
    assert torch.equal(p[:, 1], x[:, 0]) and torch.equal(p[:, 2], x[:, 1])
    assert not p[:, 0].any() and not p[:, 3].any()
    assert g.shape == (2, 4, 6, 5) and a.shape == (2, 4, 4, 5)
    assert [(r["kind"], r["result_bytes"], r["group"]) for r in cc.records] \
        == [("all-reduce", 60, 4), ("all-gather", 120, 2),
            ("collective-permute", 60, 4), ("all-to-all", 80, 4)]


def test_ppermute_backward_is_the_reverse_permute():
    m = local_mesh((3,), ("pod",), device="cpu")
    x = torch.randn(3, 2, requires_grad=True)
    w = torch.randn(3, 2)
    y = collectives.mesh_ppermute(x, "pod", [(0, 1), (1, 2)], m)
    g, = torch.autograd.grad((y * w).sum(), x)
    assert torch.equal(g, torch.stack([w[1], w[2], torch.zeros(2)]))


def test_extrapolate_on_the_reference_numbers():
    out = dr._extrapolate({"flops": 10.0}, {"flops": 16.0}, {"flops": 17.0},
                          NB=4, A=3, keys=("flops",))
    np.testing.assert_allclose(out["flops"], 78.0)


@pytest.mark.parametrize("i", range(N_SEEDED))
def test_extrapolate_equals_the_reference_function(ref, i):
    c11, c21, c12, NB, A = seeded_dicts(i)
    assert dr._extrapolate(c11, c21, c12, NB, A, keys=("flops", "b")) == \
        ref["extrapolate"][i]


# ---------------------------------------------------------------------------
# the build_* functions on SMOKE configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", CELLS, ids=lambda c: str(c))
def test_argument_bytes_equal_the_reference(ref, arch, kind):
    fn, args, in_sh, _ = dr.build_cell(get_smoke_config(arch),
                                       shape_of(kind), mesh(), mcfg())
    rec = dr.measure(fn, args, in_sh, n_devices=4)
    got = rec["memory_analysis"]["argument_size_in_bytes"]
    assert got == ref["args"][f"{arch}/{kind}"]
    assert rec["cost_analysis"]["flops"] > 0


def test_prefill_flops_equal_the_closed_form():
    """2 x tokens x every 2-D block weight, the tied unembed over every
    position, and the cost-exact slabs' 4 B H hd cq kv."""
    cfg = get_smoke_config("olmo-1b")
    shape = shape_of("prefill")
    fn, args, in_sh, _ = dr.build_cell(cfg, shape, mesh(), mcfg())
    rec = dr.measure(fn, args, in_sh, n_devices=4)
    params = args[0]
    B, S = shape.global_batch, shape.seq_len
    weights = sum(t.numel() for n, t in params.named_parameters()
                  if n.startswith("blocks.") and t.dim() == 2)
    unembed = 2 * B * S * cfg.d_model * cfg.vocab_size
    c = max(128, -(-S // 8))
    slabs = 0
    for lo in range(0, S, c):
        hi = min(S, lo + c)
        slabs += 4 * B * cfg.n_heads * cfg.d_head * (hi - lo) * hi
    want = 2 * B * S * weights + unembed + cfg.n_layers * slabs
    assert rec["cost_analysis"]["flops_total"] == want
    assert rec["cost_analysis"]["flops"] == want / 4


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-lite-16b"])
def test_calibration_extrapolates_to_the_direct_count(arch):
    cfg = dataclasses.replace(get_smoke_config(arch),
                              n_layers=get_smoke_config(arch).first_k_dense
                              + 3)
    shape = ShapeConfig("t", 64, 4, "train")
    cal = dr.calibrate(cfg, shape, mesh(), mcfg(), microbatch=2)
    assert cal["grad_accum"] == 2 and cal["scan_blocks"] == 3
    assert cal["check"]["flops"] == 0.0
    for k, v in cal["check"].items():
        if k != "bytes accessed":
            assert v == 0.0, (k, cal["extrapolated"][k])
    if cfg.n_experts:
        assert cal["collective_bytes_per_device"]["n_all-to-all"] > 0


VARIANT_ARCH = {"disp2s": "deepseek-v2-lite-16b",
                "disp1s": "deepseek-v2-lite-16b",
                "serve_ep": "llama4-maverick-400b-a17b"}


@pytest.mark.parametrize("variant", sorted(dr.VARIANTS))
def test_every_variant_builds_on_smoke_configs(variant, monkeypatch,
                                               tmp_path):
    arch = VARIANT_ARCH.get(variant, "olmo-1b")
    monkeypatch.setattr(dr, "get_config", get_smoke_config)
    monkeypatch.setattr(dr, "SHAPES", {
        "t_train": ShapeConfig("t_train", 64, 8, "train"),
        "t_decode": ShapeConfig("t_decode", 64, 4, "decode")})
    monkeypatch.setattr(dr, "make_production_mesh",
                        lambda multi_pod=False, device=None: local_mesh(
                            (2, 2, 2) if multi_pod else MESH,
                            (("pod",) if multi_pod else ()) + AXES,
                            device=device))
    monkeypatch.setattr(dr, "mesh_config", lambda multi_pod=False:
                        MeshConfig((2, 2, 2), ("pod",) + AXES) if multi_pod
                        else mcfg())
    kind = "t_decode" if variant == "serve_ep" else "t_train"
    rec = dr.run_cell(arch, kind, multi_pod=variant == "pp_pod",
                      do_calibrate=False, variant=variant,
                      out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["full"]["cost_analysis"]["flops"] > 0


@pytest.mark.parametrize("arch,kind", [
    ("olmo-1b", "train"), ("h2o-danube-1.8b", "train"),
    ("codeqwen1.5-7b", "prefill"), ("stablelm-12b", "train"),
    ("mamba2-780m", "train"), ("deepseek-v2-lite-16b", "train"),
    ("deepseek-v2-lite-16b", "decode"),
    ("llama4-maverick-400b-a17b", "train"), ("jamba-v0.1-52b", "train"),
    ("jamba-v0.1-52b", "decode"), ("whisper-tiny", "train"),
    ("internvl2-26b", "train")])
def test_the_meters_meta_outputs_equal_torchs(arch, kind):
    """The meter makes elementwise, reduction, softmax, matmul, clone and
    cat outputs on meta itself: the program's counts and outputs are
    those of torch's own meta kernels."""
    recs, outs = [], []
    for fast in (True, False):
        fn, args, in_sh, _ = dr.build_cell(get_smoke_config(arch),
                                           shape_of(kind), mesh(), mcfg())
        with dr.Meter(fast_meta=fast) as m:
            out = fn(*args)
        recs.append((m.flops, m.bytes_accessed, m.n_ops, m.peak))
        outs.append([(tuple(t.shape), t.dtype) for t in _flat_tensors(out)])
    assert recs[0] == recs[1]
    assert outs[0] == outs[1]


def _flat_tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _flat_tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat_tensors(v)]
    return []


# ---------------------------------------------------------------------------
# full width on meta
# ---------------------------------------------------------------------------

def test_production_mesh():
    m = make_production_mesh(device=META)
    assert m.shape == (16, 16) and m.axis_names == ("data", "model")
    m = make_production_mesh(multi_pod=True, device=META)
    assert m.shape == (2, 16, 16) and m.device == META
    assert mesh_config(multi_pod=True).axes == ("pod", "data", "model")


def test_olmo_train_4k_at_full_width_on_meta(tmp_path):
    t0 = time.perf_counter()
    rec = dr.run_cell("olmo-1b", "train_4k", do_calibrate=False,
                      out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    assert time.perf_counter() - t0 < 30
    assert rec["grad_accum"] == 8
    assert rec["full"]["cost_analysis"]["flops"] > 0
    assert (tmp_path / "olmo-1b__train_4k__singlepod.json").exists()


def test_pp_pod_permutes_in_closed_form(tmp_path):
    """M + S - 1 = 9 permutes of one (B / M, seq, d) bf16 block a rank,
    and the two scalar loss sums."""
    rec = dr.run_cell("olmo-1b", "train_4k", multi_pod=True,
                      do_calibrate=False, variant="pp_pod",
                      out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    col = rec["full"]["collectives"]
    M, S = 8, 2
    assert col["n_collective-permute"] == M + S - 1
    assert col["collective-permute_result_bytes"] == \
        (M + S - 1) * (256 // M) * 4096 * 2048 * 2
    assert col["n_all-reduce"] == 2


def test_a_skipped_cell_is_recorded(tmp_path):
    rec = dr.run_cell("olmo-1b", "long_500k", out_dir=str(tmp_path))
    assert rec["status"] == "skip" and "sub-quadratic" in rec["reason"]


# ---------------------------------------------------------------------------
# the kernel policy's meta rule
# ---------------------------------------------------------------------------

def test_meta_tensors_take_the_plain_version(monkeypatch):
    meta = torch.empty(8, dtype=torch.int32, device=META)
    assert backend.use_kernel(meta) is False
    with pytest.raises(ValueError, match="CUDA tensor"):
        backend.use_kernel(meta, require=True)
    before = sl_ops.bucket_slots.launches
    slots, counts = sl_ops.bucket_slots(meta, 4)
    assert slots.is_meta and sl_ops.bucket_slots.launches == before
    # a CUDA tensor still takes the kernel (a faked sm_90 card)
    fake = types.SimpleNamespace(device=torch.device("cuda", 0))
    monkeypatch.setattr(backend, "_CAPABILITY", {})
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d=None: (9, 0))
    assert backend.use_kernel(fake) is True


def test_smoke_dryrun_child_and_meta_against_the_cpu(monkeypatch, tmp_path):
    """Phase 2f of ``chip_smoke.py`` on the CPU: its child's record of one
    full-width cell, and (b) at olmo's SMOKE width with the CPU in the
    card's place (FLOPs and collectives equal; no allocator peak
    here)."""
    import json
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DRYRUN_CELLS",
                        (("olmo-1b", "decode_32k", False, "base", False),))
    out = tmp_path / "cells.json"
    assert chip_smoke.dryrun_child(str(out)) == 0
    got = json.loads(out.read_text())
    assert [c["status"] for c in got["cells"]] == ["ok"]
    v = chip_smoke.meta_against_card(torch.device("cpu"),
                                     get_smoke_config("olmo-1b"), B=2, S=64)
    assert v["peak_ratio"] is None
    assert v["meta"]["memory_analysis"]["peak_live_bytes"] == \
        v["card_peak_live_bytes"]
