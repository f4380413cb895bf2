"""The port's GPipe schedule (``distributed/pipeline.py``) against the
reference's, on a (pod 2, data 2) mesh (the reference's in one 4-device
subprocess under ``jax.jit``, made once a module).

  * olmo-1b SMOKE in fp32, the reference's weights and a seeded numpy
    batch of 8 x 32 tokens: ``gpipe_loss_fn`` at M = 2, 4 and 8 within
    1e-5 (relative) of the reference's and of the port's ``loss_fn``;
    the gradients at M = 4 within atol 2e-4, rtol 2e-3 of the
    reference's pipelined ones (``tests/test_pipeline.py``'s);
  * six ``make_pp_train_step`` steps of codeqwen1.5-7b SMOKE in fp32,
    each loss within 1e-4 (relative) of the reference's, and falling;
  * ``pp_param_specs`` over the reference's tree equal to the
    reference's; over the port's ``Model``, each block on its stage;
  * port only: the schedule at pod 4 (a 4-layer olmo SMOKE) against
    ``loss_fn``; the permutes it records (M + S - 1 a forward, one
    (mb, seq, d) block each); MoE, ``first_k_dense`` and encoder
    configs raise.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import transformer as jtf  # noqa: E402
from repro_torch.config import MeshConfig, TrainConfig  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.distributed import pipeline as pp  # noqa: E402
from repro_torch.distributed.mesh import local_mesh  # noqa: E402
from repro_torch.launch.hlo_stats import (CollectiveCounter,  # noqa: E402
                                          collective_bytes)
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train.train_step import init_train_state  # noqa: E402
from torch_mesh_train import flat  # noqa: E402

CPU = torch.device("cpu")
MESH = (2, 2)
AXES = ("pod", "data")
B, S = 8, 32
MS = (2, 4, 8)
STEPS = 6
TCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def cfg_of(arch, **kw):
    return dataclasses.replace(tregistry.get_smoke_config(arch),
                               dtype="float32", param_dtype="float32", **kw)


def batch_of(cfg, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def model_of(arch, cfg):
    """The reference's ``init_model(cfg, key(0))`` weights on the CPU."""
    from repro.configs import registry as jregistry
    jcfg = dataclasses.replace(jregistry.get_smoke_config(arch),
                               dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                               n_layers=cfg.n_layers)
    tree = jax.tree.map(np.asarray, jtf.init_model(jcfg, jax.random.key(0)))
    return convert.params_from_numpy(cfg, tree, CPU)


def spec_tree(tree, prefix=""):
    """A tree of specs (either package's) as {"a/b": [entries]}, a tuple
    entry as a list."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(spec_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = [list(e) if isinstance(e, tuple) else e
                               for e in tuple(v)]
    return out


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def ref(devices8, tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    devices8(f"""
        import dataclasses, json, sys
        import numpy as np, jax, jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        sys.path.insert(0, {str(__import__("torch_parity").REPO)!r} + "/tests")
        from repro.config import MeshConfig, TrainConfig
        from repro.configs.registry import get_smoke_config
        from repro.distributed.mesh import local_mesh
        from repro.distributed.pipeline import (gpipe_loss_fn,
            make_pp_train_step, pp_param_specs)
        from repro.models.transformer import init_model, loss_fn
        from repro.optim.adamw import AdamWState
        from repro.train.train_step import TrainState, init_train_state
        from test_torch_pipeline import batch_of, spec_tree, MS, STEPS, TCFG
        from torch_mesh_train import flat

        mesh = local_mesh({MESH!r}, {AXES!r})
        mesh_cfg = MeshConfig({MESH!r}, {AXES!r})
        out, specs = {{}}, {{}}

        def shard(params, cfg):
            sp = pp_param_specs(jax.eval_shape(lambda: params), cfg,
                                mesh_cfg)
            return sp, jax.tree.map(lambda s: NamedSharding(mesh, s), sp)

        cfg = dataclasses.replace(get_smoke_config("olmo-1b"),
                                  dtype="float32", param_dtype="float32")
        params = init_model(cfg, jax.random.key(0))
        batch = {{k: jnp.asarray(v) for k, v in batch_of(cfg, 0).items()}}
        out["loss_fn"] = np.asarray(loss_fn(cfg, params, batch)[0])
        sp, p_sh = shard(params, cfg)
        specs.update(spec_tree(sp))
        p_dev = jax.device_put(params, p_sh)
        for M in MS:
            f = jax.jit(lambda p, b, M=M: gpipe_loss_fn(
                cfg, p, b, mesh=mesh, n_microbatches=M)[0])
            out[f"gpipe/{{M}}"] = np.asarray(f(p_dev, batch))
        g = jax.jit(jax.grad(lambda p, b: gpipe_loss_fn(
            cfg, p, b, mesh=mesh, n_microbatches=4)[0]))(p_dev, batch)
        for k, v in flat(g).items():
            out["grad/" + k] = v

        cfg = dataclasses.replace(get_smoke_config("codeqwen1.5-7b"),
                                  dtype="float32", param_dtype="float32")
        tcfg = TrainConfig(**TCFG)
        params = init_model(cfg, jax.random.key(0))
        state = init_train_state(cfg, tcfg, params)
        _, p_sh = shard(params, cfg)
        state = jax.device_put(state, TrainState(p_sh, AdamWState(
            NamedSharding(mesh, P()), p_sh, p_sh), None))
        step = jax.jit(make_pp_train_step(cfg, tcfg, mesh=mesh,
                                          n_microbatches=4))
        batch = {{k: jnp.asarray(v) for k, v in batch_of(cfg, 1).items()}}
        for i in range(STEPS):
            state, m = step(state, batch)
            out[f"step/{{i}}"] = np.asarray(m["loss"])
        np.savez({str(d / "ref.npz")!r}, **out)
        with open({str(d / "specs.json")!r}, "w") as f:
            json.dump(specs, f)
        print("OK")
    """, n_devices=4)
    got = dict(np.load(d / "ref.npz"))
    got["specs"] = json.loads((d / "specs.json").read_text())
    return got


@pytest.fixture(scope="module")
def olmo():
    cfg = cfg_of("olmo-1b")
    return cfg, model_of("olmo-1b", cfg), torch_batch(batch_of(cfg, 0))


def mesh(shape=MESH):
    return local_mesh(shape, AXES, device=CPU)


@pytest.mark.parametrize("M", MS)
def test_gpipe_loss_matches_the_reference_and_loss_fn(ref, olmo, M):
    cfg, model, batch = olmo
    with torch.no_grad():
        loss, m = pp.gpipe_loss_fn(cfg, model, batch, mesh=mesh(),
                                   n_microbatches=M)
        want = ttf.loss_fn(cfg, model, batch)[0]
    np.testing.assert_allclose(float(loss), float(ref[f"gpipe/{M}"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(want), float(ref["loss_fn"]), rtol=1e-5)
    assert float(m["ce"]) == float(loss) and float(m["aux"]) == 0.0


def test_gpipe_gradients_match_the_reference(ref, olmo):
    cfg, model, batch = olmo
    model.requires_grad_(True)
    try:
        loss, _ = pp.gpipe_loss_fn(cfg, model, batch, mesh=mesh(),
                                   n_microbatches=4)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        model.requires_grad_(False)
    names = [n for n, _ in model.named_parameters()]
    got = flat(convert.ref_tree(cfg, zip(names, grads)))
    want = {k[5:]: v for k, v in ref.items() if k.startswith("grad/")}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], atol=2e-4, rtol=2e-3,
                                   err_msg=k)


def test_pp_train_steps_match_the_reference_and_descend(ref):
    cfg = cfg_of("codeqwen1.5-7b")
    tcfg = TrainConfig(**TCFG)
    state = init_train_state(cfg, tcfg, model_of("codeqwen1.5-7b", cfg))
    step = pp.make_pp_train_step(cfg, tcfg, mesh=mesh(), n_microbatches=4)
    batch = torch_batch(batch_of(cfg, 1))
    losses = []
    for i in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        np.testing.assert_allclose(losses[-1], float(ref[f"step/{i}"]),
                                   rtol=1e-4)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_pp_param_specs_match_the_reference(ref, olmo):
    cfg, model, _ = olmo
    mcfg = MeshConfig(MESH, AXES)
    tree = convert.params_to_numpy(cfg, model)
    got = spec_tree(pp.pp_param_specs(tree, cfg, mcfg))
    assert got == ref["specs"]
    assert any(v[0] == "pod" for k, v in got.items()
               if k.startswith("blocks/"))
    # the port's Model: the same specs without the scan dim, and a stage
    port = pp.pp_param_specs(model, cfg, mcfg)
    L = pp.layers_per_stage(cfg, 2)
    for name, (spec, stage) in port.items():
        if name.startswith("blocks."):
            assert stage == int(name.split(".")[1]) // L
        else:
            assert stage is None


def test_four_stages_match_loss_fn_and_record_the_permutes():
    cfg = cfg_of("olmo-1b", n_layers=4)
    model = ttf.init_model(cfg, 3, device=CPU)
    batch = torch_batch(batch_of(cfg, 2))
    M = 4
    with torch.no_grad(), CollectiveCounter() as cc:
        loss, _ = pp.gpipe_loss_fn(cfg, model, batch,
                                   mesh=mesh((4, 1)), n_microbatches=M)
    with torch.no_grad():
        want = ttf.loss_fn(cfg, model, batch)[0]
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    rec = collective_bytes(cc.records)
    n = M + 4 - 1
    assert rec["n_collective-permute"] == n
    assert rec["collective-permute_result_bytes"] == \
        n * (B // M) * S * cfg.d_model * 4
    assert rec["n_all-reduce"] == 2          # the loss and token sums


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "llama4-maverick-400b-a17b",
                                  "whisper-tiny"])
def test_out_of_scope_configs_raise(arch):
    cfg = cfg_of(arch)
    with pytest.raises(ValueError, match="dense stacks only"):
        pp.check_scope(cfg)
    with pytest.raises(ValueError, match="dense stacks only"):
        pp.make_pp_train_step(cfg, TrainConfig(), mesh=mesh(),
                              n_microbatches=2)


def test_smoke_pp_phase_rehearses_on_cpu():
    """Phase 5p of ``chip_smoke.py`` at olmo's SMOKE width on the CPU:
    its gates hold (step 0 against the unsharded step, the permutes, the
    losses falling, no launch)."""
    import chip_smoke
    cfg = tregistry.get_smoke_config("olmo-1b")
    t = chip_smoke.phase_pp_train(CPU, cfg, seq=32, batch=8, steps=4)
    assert t["step0"]["collectives"]["n_collective-permute"] == 5
    assert t["bubble"] == 0.2
    pp_run = t["runs"]["pipelined"]
    assert len(pp_run["losses"]) == 4 and not pp_run["launches"]
    chip_smoke.print_pp_train(t)
