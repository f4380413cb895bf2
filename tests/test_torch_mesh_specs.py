"""The port's sharding rules against the reference's, on the CPU.

``param_specs`` in its three variants (default, flat_dp and serve; the
MoE archs' serve variant also with ``expert_tp_axis="data"``) for every
arch of the registry on ``SINGLE_POD`` and ``MULTI_POD``: over the
reference's abstract parameter tree at full width (``jax.eval_shape``
of its ``init_model``) and over the port's ``Model`` at the SMOKE config
(one layer a name, against the reference's stacked leaf of that layer
without its scan dim). The activation, tokens, logits and kv-cache
specs and ``batch_axis_size`` over batch sizes, ``dp_entry_for``, and
the batch, params and cache shardings of ``launch/specs.py``. Every
spec equal to the reference's as a tuple. No devices are needed: the
reference's shardings take a 1 x 1 mesh of the one CPU device (a
NamedSharding does not check a spec against the mesh's sizes).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.distributed import mesh as jmesh  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.distributed import mesh as tmesh  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCHS = list(tregistry.ARCH_IDS)
MESHES = ("SINGLE_POD", "MULTI_POD")
VARIANTS = ("default", "flat_dp", "serve")
CPU = torch.device("cpu")


def _jflat(tree) -> dict:
    """The reference's tree of specs (or shardings) by "/"-joined keys,
    each a tuple."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, jax.sharding.Sharding)))[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            tuple(getattr(v, "spec", v)) for path, v in leaves}


def _tflat(tree, prefix="") -> dict:
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else
                 enumerate(tree)):
        if isinstance(v, (dict, list)):
            out.update(_tflat(v, f"{prefix}{k}/"))
        else:
            out[prefix + str(k)] = tuple(getattr(v, "spec", v))
    return out


def _shapes(tree):
    """The reference's abstract tree with plain shape holders."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return types.SimpleNamespace(shape=tuple(tree.shape))


def _meshes(name):
    return getattr(jconfig, name), getattr(tconfig, name)


def _cfg_pair(arch, get="get_config", **kw):
    return tuple(dataclasses.replace(getattr(reg, get)(arch), **kw)
                 for reg in (jregistry, tregistry))


@pytest.fixture(scope="module")
def abstract():
    """Each arch's abstract reference parameter tree at full width."""
    return {arch: jax.eval_shape(
        lambda c=_cfg_pair(arch)[0]: jtf.init_model(c, jax.random.key(0)))
        for arch in ARCHS}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax_over_the_reference_tree(abstract, arch, mesh):
    jm, tm = _meshes(mesh)
    jc, tc = _cfg_pair(arch)
    variants = [(v, {}) for v in VARIANTS]
    if jc.n_experts:
        variants.append(("serve", dict(expert_tp_axis="data")))
    for variant, kw in variants:
        jcv, tcv = (dataclasses.replace(c, **kw) for c in (jc, tc))
        want = _jflat(jshd.param_specs(abstract[arch], jcv, jm, variant))
        got = _tflat(tshd.param_specs(_shapes(abstract[arch]), tcv, tm,
                                      variant))
        assert got == want, (variant, kw)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax_over_the_model(arch, mesh):
    """Over the port's ``Model`` (one layer a name): each spec is the
    reference's spec of that layer's leaf, its scan dim dropped."""
    jm, tm = _meshes(mesh)
    jc, tc = _cfg_pair(arch, "get_smoke_config")
    model = ttf.init_model(tc, 0, device=CPU)
    ref_tree = jax.eval_shape(lambda: jtf.init_model(jc, jax.random.key(0)))
    for variant in VARIANTS:
        want = _jflat(jshd.param_specs(ref_tree, jc, jm, variant))
        got = tshd.param_specs(model, tc, tm, variant)
        assert sorted(got) == sorted(n for n, _ in model.named_parameters())
        for name, spec in got.items():
            parts = name.split(".")
            if parts[0] in ("blocks", "enc_blocks"):
                top, key, b = convert._ref_layer(tc, int(parts[1]),
                                                 parts[0])
                w = want["/".join([top, key] + parts[2:])]
                w = w if b is None else w[1:]
            else:
                w = want["/".join(parts)]
            assert tuple(spec) == w, (variant, name)


@pytest.mark.parametrize("mesh", MESHES)
def test_activation_and_cache_specs_match_jax(mesh):
    jm, tm = _meshes(mesh)
    for batch in (1, 2, 16, 24, 32, 256, 512, 96):
        for fn in ("activation_spec", "tokens_spec", "batch_axis_size"):
            assert getattr(tshd, fn)(tm, batch) == _tup(
                getattr(jshd, fn)(jm, batch)), (fn, batch)
        for arch in ARCHS:
            jc, tc = _cfg_pair(arch)
            for fn in ("logits_spec", "kv_cache_spec"):
                assert tuple(getattr(tshd, fn)(tc, tm, batch)) == tuple(
                    getattr(jshd, fn)(jc, jm, batch)), (fn, arch, batch)
    assert tmesh.dp_spec(tm) == jmesh.dp_spec(jm)


def _tup(x):
    return tuple(x) if isinstance(x, tuple) else x


@pytest.mark.parametrize("mesh", MESHES)
def test_dp_entry_for_matches_jax(mesh):
    jm, tm = _meshes(mesh)
    for batch in (1, 2, 3, 16, 24, 32, 256, 512, 1024):
        for variant in VARIANTS:
            js = jconfig.ShapeConfig("s", 128, batch, "train")
            ts = tconfig.ShapeConfig("s", 128, batch, "train")
            assert tspecs.dp_entry_for(ts, tm, variant) == \
                jspecs.dp_entry_for(js, jm, variant), (batch, variant)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_launch_shardings_match_jax(arch, mesh):
    """``batch_shardings``, ``params_shardings`` and ``cache_shardings``
    (over the reference's stacked cache tree and over the port's list of
    layers): their specs equal the reference's."""
    jm, tm = _meshes(mesh)
    jc, tc = _cfg_pair(arch, "get_smoke_config")
    jmesh1 = jmesh.local_mesh((1,) * len(jm.shape), jm.axes)
    tmesh1 = tmesh.local_mesh(tm.shape, tm.axes, device=CPU)
    B, S_max = 32, 64
    js = jconfig.ShapeConfig("s", S_max, B, "decode")
    ts = tconfig.ShapeConfig("s", S_max, B, "decode")
    batch = {"tokens": np.zeros((B, S_max), np.int32),
             "frontend_embeds": np.zeros((B, 4, jc.d_model), np.float32)}
    assert _tflat(tspecs.batch_shardings(tc, ts, tmesh1, tm, batch)) == \
        _jflat(jspecs.batch_shardings(jc, js, jmesh1, jm, batch))
    ref_params = jax.eval_shape(lambda: jtf.init_model(jc,
                                                       jax.random.key(0)))
    assert _tflat(tspecs.params_shardings(tc, tmesh1, tm,
                                          _shapes(ref_params))) == \
        _jflat(jspecs.params_shardings(jc, jmesh1, jm, ref_params))
    ref_cache = jax.eval_shape(lambda: jtf.init_cache(jc, B, S_max))
    want = _jflat(jspecs.cache_shardings(jc, js, jmesh1, jm, ref_cache))
    assert _tflat(tspecs.cache_shardings(tc, ts, tmesh1, tm,
                                         _shapes(ref_cache))) == want
    layers = tspecs.cache_shardings(
        tc, ts, tmesh1, tm, ttf.init_cache(tc, B, S_max, device=CPU))
    for i, layer in enumerate(layers["blocks"]):
        top, key, b = convert._ref_layer(tc, i)
        for name, sh in layer.items():
            w = want["/".join([top, key, name])]
            assert tuple(sh.spec) == (w if b is None else w[1:]), (i, name)


def test_shard_params_returns_the_parameters():
    tc = tregistry.get_smoke_config("olmo-1b")
    model = ttf.init_model(tc, 0, device=CPU)
    mesh = tmesh.local_mesh((2, 4), device=CPU)
    assert tshd.shard_params(model, tc, mesh, tconfig.MeshConfig(
        (2, 4), ("data", "model"))) is model
    assert tshd.P("data", None) == ("data", None)
    assert repr(tshd.P("model")) == "P('model',)"
