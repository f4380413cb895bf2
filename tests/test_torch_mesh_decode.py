"""The port's seq-sharded decode caches and its mesh-served stacks
against the reference's ``shard_map`` on 8 CPU devices.

On a (data 2, model 4) mesh with ``dp_entry="data"``, in fp32, weights
from the reference's ``jax.random.key(0)`` inits and inputs from numpy
seeds; one subprocess runs every reference call under ``jax.jit``:

  * ``attention_decode`` (olmo-1b SMOKE, GQA) and ``mla_decode``
    (deepseek-v2-lite SMOKE, the compressed cache) over a cache of
    S_max 16 (S_loc 4 a shard) at t = S_loc - 1, S_loc, S_max - 1 and
    S_max: the caches bit for bit but for the entry written (the owning
    shard writes it at t, where the two packages' projections part in
    the last bits: within 1e-5 * max|entry|; at t = S_max no shard
    writes, so the cache is untouched, where the unsharded GQA cache
    overwrites its last slot), the outputs within 1e-5 * max|ref|;
    ``update_cache_sharded`` on the same entry bit for bit.

The served stacks under the mesh: ``test_torch_mesh_serve.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.distributed.mesh import local_mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
import torch_parity  # noqa: E402,F401  (shares the cores under xdist)

MESH = (2, 4)
CPU = torch.device("cpu")
B, S_MAX = 4, 16
S_LOC = S_MAX // MESH[1]
TS = (S_LOC - 1, S_LOC, S_MAX - 1, S_MAX)
KINDS = {"gqa": "olmo-1b", "mla": "deepseek-v2-lite-16b"}


def _cfgs(arch):
    return tuple(dataclasses.replace(get(arch), dtype="float32",
                                     param_dtype="float32")
                 for get in (jregistry.get_smoke_config,
                             tregistry.get_smoke_config))


def _decode_inputs(kind, cfg):
    """(x, cache) of one decode step: seeded x (B, 1, D) and a seeded
    cache {"k", "v"} (GQA) or {"ckv"} (MLA) of S_MAX positions."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    if kind == "gqa":
        shape = (B, S_MAX, cfg.n_kv_heads, cfg.d_head)
        cache = {n: rng.standard_normal(shape).astype(np.float32)
                 for n in ("k", "v")}
    else:
        shape = (B, S_MAX, cfg.kv_lora_rank + cfg.qk_rope_dim)
        cache = {"ckv": rng.standard_normal(shape).astype(np.float32)}
    return x, cache


@pytest.fixture(scope="module")
def ref(devices8, tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_decode")
    inputs = {}
    for kind, arch in KINDS.items():
        x, cache = _decode_inputs(kind, _cfgs(arch)[0])
        inputs[f"{kind}/x"] = x
        for n, c in cache.items():
            inputs[f"{kind}/cache/{n}"] = c
    inputs["update/new"] = np.random.default_rng(4).standard_normal(
        (B,) + inputs["gqa/cache/k"].shape[2:]).astype(np.float32)
    np.savez(d / "in.npz", **inputs)
    devices8(f"""
        import dataclasses
        import numpy as np
        import jax, jax.numpy as jnp
        from repro.configs.registry import get_smoke_config
        from repro.distributed.mesh import local_mesh
        from repro.models import attention as jattn
        mesh = local_mesh({MESH!r}, ("data", "model"))
        inp = dict(np.load({str(d / "in.npz")!r}))
        out = {{}}

        def cfg_of(arch):
            return dataclasses.replace(get_smoke_config(arch),
                                       dtype="float32",
                                       param_dtype="float32")

        for kind, arch in {KINDS!r}.items():
            cfg = cfg_of(arch)
            init = jattn.init_attention if kind == "gqa" else jattn.init_mla
            fn = (jattn.attention_decode if kind == "gqa"
                  else jattn.mla_decode)
            p = init(cfg, jax.random.key(0))
            cache = {{n.split("/")[-1]: v for n, v in inp.items()
                      if n.startswith(kind + "/cache/")}}
            f = jax.jit(lambda p, x, c, t: fn(cfg, p, x, c, t, mesh=mesh,
                                              dp_entry="data"))
            for t in {TS!r}:
                o, c = f(p, inp[kind + "/x"], cache, jnp.int32(t))
                out[f"{{kind}}/{{t}}/out"] = np.asarray(o)
                for n, v in c.items():
                    out[f"{{kind}}/{{t}}/cache/{{n}}"] = np.asarray(v)
        upd = jax.jit(lambda c, n, t: jattn.update_cache_sharded(
            c, n, t, mesh=mesh, dp_entry="data"))
        for t in {TS!r}:
            out[f"update/{{t}}"] = np.asarray(upd(
                inp["gqa/cache/k"], inp["update/new"], jnp.int32(t)))
        np.savez({str(d / "ref.npz")!r}, **out)
        print("OK")
    """)
    out = dict(np.load(d / "ref.npz"))
    out.update(inputs)
    return out


def _port_attn(kind, cfg, jcfg):
    init = jattn.init_attention if kind == "gqa" else jattn.init_mla
    return {k: torch.from_numpy(np.array(v))
            for k, v in init(jcfg, jax.random.key(0)).items()}


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_sharded_decode_matches_jax(ref, kind, t):
    jcfg, cfg = _cfgs(KINDS[kind])
    p = _port_attn(kind, cfg, jcfg)
    x = torch.from_numpy(ref[f"{kind}/x"])
    names = ("k", "v") if kind == "gqa" else ("ckv",)
    cache = {n: torch.from_numpy(ref[f"{kind}/cache/{n}"].copy())
             for n in names}
    fn = tattn.attention_decode if kind == "gqa" else tattn.mla_decode
    o, c = fn(cfg, p, x, cache, t, mesh=local_mesh(MESH, device=CPU),
              dp_entry="data")
    assert c is cache                     # written in place
    for n in names:
        got, want = c[n].numpy(), ref[f"{kind}/{t}/cache/{n}"]
        rest = np.arange(S_MAX) != t
        np.testing.assert_array_equal(got[:, rest], want[:, rest])
        if t == S_MAX:                    # past the end: untouched
            np.testing.assert_array_equal(got, ref[f"{kind}/cache/{n}"])
        else:
            err = np.abs(got[:, t] - want[:, t]).max()
            assert err <= 1e-5 * np.abs(want[:, t]).max(), err
    want = ref[f"{kind}/{t}/out"]
    err = np.abs(o.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("t", TS)
def test_update_cache_sharded_bit_for_bit(ref, t):
    cache = torch.from_numpy(ref["gqa/cache/k"].copy())
    got = tattn.update_cache_sharded(
        cache, torch.from_numpy(ref["update/new"]), t,
        mesh=local_mesh(MESH, device=CPU), dp_entry="data")
    assert got is cache
    np.testing.assert_array_equal(got.numpy(), ref[f"update/{t}"])


def test_unsharded_gqa_cache_overwrites_its_last_slot_past_the_end(ref):
    """The other path of the same step: without a mesh the GQA write at
    t = S_max lands on the last slot (the reference's clamped update),
    so the two caches part there and only there."""
    jcfg, cfg = _cfgs(KINDS["gqa"])
    p = _port_attn("gqa", cfg, jcfg)
    cache = {n: torch.from_numpy(ref[f"gqa/cache/{n}"].copy())
             for n in ("k", "v")}
    tattn.attention_decode(cfg, p, torch.from_numpy(ref["gqa/x"]), cache,
                           S_MAX)
    for n in ("k", "v"):
        sharded = ref[f"gqa/{S_MAX}/cache/{n}"]
        np.testing.assert_array_equal(cache[n].numpy()[:, :-1],
                                      sharded[:, :-1])
        assert not np.array_equal(cache[n].numpy()[:, -1], sharded[:, -1])


def test_mesh_engine_refuses_a_cache_that_does_not_divide():
    _, cfg = _cfgs("olmo-1b")
    from repro_torch.models import transformer as ttf
    model = ttf.init_model(cfg, 0, device=CPU)
    with pytest.raises(ValueError, match="must divide by tp"):
        tengine.ServeEngine(cfg, model, max_len=S_MAX + 2,
                            mesh=local_mesh(MESH, device=CPU),
                            dp_entry="data", device=CPU)
