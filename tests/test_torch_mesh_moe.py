"""The port's MoE layer under a (data 2, model 4) mesh against the
reference's ``shard_map`` on 8 CPU devices.

At the deepseek-v2-lite (8 experts top-2, 2 shared) and llama4-maverick
(8 experts top-1, 1 shared) SMOKE configs in fp32, with the weights of
the reference's ``init_moe(cfg, jax.random.key(0))`` and inputs from
numpy seeds, ``dp_entry="data"``: one subprocess runs every reference
call under ``jax.jit`` (the sharded layer called eagerly is refused
under jax 0.9) and records its routing of every shard
(``torch_routing.mesh_recording``); the port runs on that routing
(``same_routing``: in fp32 no row may route otherwise).

Held: "1s" and "2s" at ``capacity_factor`` 8.0 (no record drops) and
1.0 (each shard's buckets drop their own records, so the sharded layer
differs from the unsharded one): y within atol/rtol 1e-4 and aux within
rtol 1e-5, as ``tests/test_moe.py`` holds the reference's own sharded
layer; every slotting call of the port (peer buckets and expert
buffers, all shards in one call) bit for bit equal to the reference's
``_bucket_indices`` on each shard's records, the dropped records with
it; the replicated decode dispatch (S = 1) and the expert-TP decode
(``expert_tp_axis="data"``); the gradients of ``sum(y * w)`` with
respect to x and every weight, within atol/rtol 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.distributed.mesh import local_mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import _tensor  # noqa: E402
from torch_parity import REPO  # noqa: E402
from torch_routing import same_routing  # noqa: E402

MESH = (2, 4)
CPU = torch.device("cpu")
DS, L4 = "deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"
SHAPE = (4, 16)                 # B x S: 2 x 4 tokens a shard
CASES = [(a, m, cf) for a in (DS, L4) for m in ("1s", "2s")
         for cf in (8.0, 1.0)]
GRAD_CASES = [(DS, "1s", 1.0), (L4, "2s", 1.0)]
# S = 1 decode: the replicated dispatch, and the expert-TP variant (as
# tests/test_serve_sharding.py runs the reference's: top-2 at 8.0)
DECODE = {"replicated": {}, "expert_tp": dict(expert_tp_axis="data",
                                              top_k=2, capacity_factor=8.0)}
TOL = dict(atol=1e-4, rtol=1e-4)


def _kw(mode, cf):
    return dict(dispatch_mode=mode, capacity_factor=cf)


def _x(d_model, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (d_model,)).astype(np.float32)


def _cfgs(arch, **kw):
    return tuple(dataclasses.replace(get(arch), dtype="float32",
                                     param_dtype="float32", **kw)
                 for get in (jregistry.get_smoke_config,
                             tregistry.get_smoke_config))


def _params(jcfg):
    jp = jmoe.init_moe(jcfg, jax.random.key(0))
    return {k: _tensor(np.asarray(v), CPU) for k, v in jp.items()}


def _grad_w(d_model, seed=9):
    return _x(d_model, SHAPE, seed)


@pytest.fixture(scope="module")
def ref(devices8, tmp_path_factory):
    """Every reference number of the module, from one 8-device
    subprocess: y, aux and the assembled routing of each case, the
    gradients of the GRAD_CASES, and both decode dispatches."""
    d = tmp_path_factory.mktemp("mesh_moe")
    devices8(f"""
        import dataclasses, sys
        import numpy as np
        import jax, jax.numpy as jnp
        sys.path.insert(0, {REPO!r} + "/tests")
        from repro.configs.registry import get_smoke_config
        from repro.distributed.mesh import local_mesh
        from repro.models import moe as jmoe
        from torch_routing import assemble, mesh_recording
        mesh = local_mesh({MESH!r}, ("data", "model"))
        out = {{}}

        def cfg_of(arch, **kw):
            return dataclasses.replace(get_smoke_config(arch),
                                       dtype="float32",
                                       param_dtype="float32", **kw)

        def x_of(D, shape, seed):
            return np.random.default_rng(seed).standard_normal(
                shape + (D,)).astype(np.float32)

        def run(name, cfg, x, grad_w=None):
            p = jmoe.init_moe(cfg, jax.random.key(0))
            calls = []
            with mesh_recording(calls):
                f = jax.jit(lambda p, x: jmoe.moe_forward(
                    cfg, p, x, mesh=mesh, dp_entry="data"))
                y, aux = f(p, x)
                if grad_w is not None:
                    g = jax.jit(jax.grad(lambda p, x: jnp.sum(jmoe.moe_forward(
                        cfg, p, x, mesh=mesh, dp_entry="data")[0] * grad_w),
                        argnums=(0, 1)))(p, x)
                jax.effects_barrier()
            out[name + "/y"] = np.asarray(y)
            out[name + "/aux"] = np.asarray(aux)
            routes = assemble(calls, {MESH!r})
            for k, r in enumerate(routes[:1]):
                out[name + f"/route{{k}}"] = r
            if grad_w is not None:
                out[name + "/gx"] = np.asarray(g[1])
                for k, v in g[0].items():
                    out[name + "/g/" + k] = np.asarray(v)

        for arch, mode, cf in {CASES!r}:
            cfg = cfg_of(arch, dispatch_mode=mode, capacity_factor=cf)
            gw = (x_of(cfg.d_model, {SHAPE!r}, 9)
                  if (arch, mode, cf) in {GRAD_CASES!r} else None)
            run(f"{{arch}} {{mode}} {{cf}}", cfg,
                x_of(cfg.d_model, {SHAPE!r}, 1), gw)
        for arch in ({DS!r}, {L4!r}):
            for kind, kw in {DECODE!r}.items():
                cfg = cfg_of(arch, **kw)
                run(f"{{arch}} {{kind}}", cfg,
                    x_of(cfg.d_model, ({SHAPE[0]}, 1), 2))
        np.savez({str(d / "ref.npz")!r}, **out)
        print("OK")
    """)
    return dict(np.load(d / "ref.npz"))


def _run(arch, name, ref, shape, seed, *, grad=False, spy=None, **kw):
    """The port's layer under the mesh on the reference's routing of
    ``name``: (y, aux[, grads of sum(y * w) w.r.t. x and each weight])."""
    jcfg, tcfg = _cfgs(arch, **kw)
    p = _params(jcfg)
    x = torch.from_numpy(_x(tcfg.d_model, shape, seed))
    if grad:
        for t in (x, *p.values()):
            t.requires_grad_(True)
    flips = []
    mesh = local_mesh(MESH, device=CPU)
    with same_routing([ref[name + "/route0"]], "float32", flips):
        y, aux = tmoe.moe_forward(tcfg, p, x, mesh=mesh, dp_entry="data",
                                  use_kernel=True)
    assert flips == [0]
    if not grad:
        return y, aux
    w = torch.from_numpy(_grad_w(tcfg.d_model))
    names = list(p)
    gs = torch.autograd.grad((y * w).sum(), [x] + [p[k] for k in names])
    return y, aux, dict(zip(["x"] + names, gs))


@pytest.mark.parametrize("arch,mode,cf", CASES)
def test_sharded_moe_matches_jax(ref, arch, mode, cf):
    name = f"{arch} {mode} {cf}"
    y, aux = _run(arch, name, ref, SHAPE, 1, **_kw(mode, cf))
    np.testing.assert_allclose(y.detach().numpy(), ref[name + "/y"], **TOL)
    np.testing.assert_allclose(float(aux), float(ref[name + "/aux"]),
                               rtol=1e-5)


@pytest.mark.parametrize("arch,mode,cf", CASES)
def test_sharded_slots_and_drops_bit_for_bit(ref, arch, mode, cf,
                                             monkeypatch):
    """Every slotting call of the sharded layer (peer buckets and expert
    buffers: one call for all 8 shards' records) equals the reference's
    ``_bucket_indices`` on each shard's records bit for bit; the records
    it leaves out are the dropped ones: some at 1.0, none at 8.0."""
    seen = []
    real = tmoe._bucket_indices

    def spy(ids, valid, n, cap, **kw):
        out = real(ids, valid, n, cap, **kw)
        seen.append((ids.clone(), valid.clone(), n, cap, out.clone()))
        return out

    monkeypatch.setattr(tmoe, "_bucket_indices", spy)
    name = f"{arch} {mode} {cf}"
    _run(arch, name, ref, SHAPE, 1, **_kw(mode, cf))
    G = 2 if mode == "1s" else 0          # smoke configs: 2 groups
    assert len(seen) == 2 * (G + 1)
    vmapped = jax.jit(jax.vmap(jmoe._bucket_indices, (0, 0, None, None)),
                      static_argnums=(2, 3))
    drops = 0
    for ids, valid, n, cap, got in seen:
        assert ids.shape[0] == np.prod(MESH)
        want = vmapped(jnp.asarray(ids.numpy()), jnp.asarray(valid.numpy()),
                       n, cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        drops += int(valid.sum()) - int((got >= 0).sum())
    assert (drops > 0) == (cf == 1.0), drops


@pytest.mark.parametrize("arch,mode,cf", GRAD_CASES)
def test_sharded_moe_gradients_match_jax(ref, arch, mode, cf):
    name = f"{arch} {mode} {cf}"
    _, _, g = _run(arch, name, ref, SHAPE, 1, grad=True, **_kw(mode, cf))
    np.testing.assert_allclose(g.pop("x").numpy(), ref[name + "/gx"], **TOL)
    for k, v in g.items():
        np.testing.assert_allclose(v.numpy(), ref[name + "/g/" + k],
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("kind", list(DECODE))
@pytest.mark.parametrize("arch", [DS, L4])
def test_decode_dispatch_matches_jax(ref, arch, kind):
    """S = 1 does not divide over the model axis: the tokens replicate
    over it and each shard runs its own experts, psummed over "model"
    (and over "data" with the experts' d_ff split over it)."""
    name = f"{arch} {kind}"
    y, aux = _run(arch, name, ref, (SHAPE[0], 1), 2, **DECODE[kind])
    np.testing.assert_allclose(y.numpy(), ref[name + "/y"], **TOL)
    np.testing.assert_allclose(float(aux), float(ref[name + "/aux"]),
                               rtol=1e-5)


def test_the_sharded_layer_differs_from_the_unsharded_at_drops(ref):
    """At 1.0 each shard's capacity drops records the unsharded layer
    keeps (the reason a mesh run's loss is its own); at 8.0 the two
    agree."""
    jcfg, tcfg = _cfgs(DS, **_kw("1s", 1.0))
    p = _params(jcfg)
    x = torch.from_numpy(_x(tcfg.d_model, SHAPE, 1))
    for cf, apart in ((1.0, True), (8.0, False)):
        cfg = dataclasses.replace(tcfg, capacity_factor=cf)
        y, _ = tmoe.moe_forward(cfg, p, x)
        err = np.abs(y.numpy() - ref[f"{DS} 1s {cf}/y"]).max()
        assert (err > 1e-2) == apart, (cf, err)
