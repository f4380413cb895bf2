"""The port's ``ServeEngine`` under a mesh against the reference's on 8
CPU devices.

On a (data 2, model 4) mesh with ``dp_entry="data"``, in fp32, the
SMOKE configs of olmo-1b (dense), deepseek-v2-lite (MLA, a leading
dense layer, MoE), llama4-maverick (GQA, dense and MoE layers 1:1) and
jamba-v0.1 (SSD layers, one GQA layer, MoE on the odd slots), with the
weights of the reference's ``init_model(cfg, jax.random.key(0))``
carried across by ``params_from_numpy``: 4 seeded prompts of 16 tokens
(4 a shard: the prefill's MoE layers dispatch expert-parallel), 4 new
tokens (the decode steps' MoE layers dispatch replicated, the GQA and
MLA caches sequence-sharded), a cache of 24 positions. One subprocess
serves each through the reference's ``ServeEngine(mesh=, dp_entry=)``
(jitted) and records its routing of every shard
(``torch_routing.mesh_recording``); the port serves on that routing
(in fp32 no row may route otherwise) and its greedy tokens must equal
the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.distributed.mesh import local_mesh  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from torch_parity import REPO  # noqa: E402
from torch_routing import same_routing  # noqa: E402

MESH = (2, 4)
CPU = torch.device("cpu")
SERVE = ("olmo-1b", "deepseek-v2-lite-16b", "llama4-maverick-400b-a17b",
         "jamba-v0.1-52b")
B, PROMPT, NEW, MAX_LEN = 4, 16, 4, 24


def _cfgs(arch):
    return tuple(dataclasses.replace(get(arch), dtype="float32",
                                     param_dtype="float32")
                 for get in (jregistry.get_smoke_config,
                             tregistry.get_smoke_config))


def _prompts(cfg):
    return np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def ref(devices8, tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_serve")
    devices8(f"""
        import dataclasses, sys
        import numpy as np
        import jax
        sys.path.insert(0, {REPO!r} + "/tests")
        from repro.configs.registry import get_smoke_config
        from repro.distributed.mesh import local_mesh
        from repro.models import transformer as jtf
        from repro.serve.engine import ServeEngine
        from torch_routing import assemble, mesh_recording
        mesh = local_mesh({MESH!r}, ("data", "model"))
        out = {{}}
        for arch in {SERVE!r}:
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      dtype="float32", param_dtype="float32")
            params = jtf.init_model(cfg, jax.random.key(0))
            prompts = np.random.default_rng(5).integers(
                0, cfg.vocab_size, ({B}, {PROMPT})).astype(np.int32)
            calls = []
            with mesh_recording(calls):
                eng = ServeEngine(cfg, params, max_len={MAX_LEN},
                                  mesh=mesh, dp_entry="data")
                out[arch + "/tokens"] = eng.generate(prompts, {NEW})
                jax.effects_barrier()
            routes = assemble(calls, {MESH!r}) if calls else []
            out[arch + "/n_routes"] = np.int32(len(routes))
            for k, r in enumerate(routes):
                out[f"{{arch}}/route{{k}}"] = r
        np.savez({str(d / "ref.npz")!r}, **out)
        print("OK")
    """)
    return dict(np.load(d / "ref.npz"))


@pytest.mark.parametrize("arch", SERVE)
def test_mesh_engine_greedy_tokens_match_jax(ref, arch):
    jcfg, cfg = _cfgs(arch)
    np_params = jax.tree.map(np.asarray,
                             jtf.init_model(jcfg, jax.random.key(0)))
    model = convert.params_from_numpy(cfg, np_params, CPU)
    routes = [ref[f"{arch}/route{k}"]
              for k in range(int(ref[arch + "/n_routes"]))]
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers)) \
        if cfg.n_experts else 0
    assert len(routes) == n_moe * NEW       # the prefill and 3 steps
    flips = []
    eng = tengine.ServeEngine(cfg, model, max_len=MAX_LEN,
                              mesh=local_mesh(MESH, device=CPU),
                              dp_entry="data", device=CPU)
    with same_routing(routes, "float32", flips):
        got = eng.generate(_prompts(cfg), NEW)
    assert not any(flips)
    np.testing.assert_array_equal(got, ref[arch + "/tokens"])


def test_mesh_engine_matches_the_unsharded_engine_without_drops():
    """At a capacity no shard's bucket overflows, the mesh serves the
    unpartitioned function: the same greedy tokens as the engine without
    a mesh."""
    _, cfg = _cfgs("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    from repro_torch.models import transformer as ttf
    model = ttf.init_model(cfg, 0, device=CPU)
    prompts = _prompts(cfg)
    want = tengine.ServeEngine(cfg, model, max_len=MAX_LEN,
                               device=CPU).generate(prompts, NEW)
    got = tengine.ServeEngine(cfg, model, max_len=MAX_LEN,
                              mesh=local_mesh(MESH, device=CPU),
                              dp_entry="data", device=CPU
                              ).generate(prompts, NEW)
    np.testing.assert_array_equal(got, want)
