"""The sharded loss and train step against the reference's, shared by
``test_torch_mesh_train.py`` and ``test_torch_mesh_hybrid_train.py``
(they import JAX).

``reference`` runs, in one 8-device subprocess under ``jax.jit``, the
reference's ``jax.value_and_grad(loss_fn(mesh=, dp_entry="data"))`` on a
(data 2, model 4) mesh for each arch of a file, at its SMOKE config in
fp32 with the weights of ``init_model(cfg, jax.random.key(0))`` and a
seeded batch of 4 x 16 tokens, and optionally two steps of the jitted
``make_train_step(mesh=, dp_entry=)`` (remat none, A = 1, AdamW's eps
1e-4: ``EPS``), recording its
routing of every shard (``torch_routing.mesh_recording``). The
reference's stack is a ``jax.checkpoint`` under every remat policy, so
its backward pass routes each MoE layer again: the port, which keeps
the activations under remat none, runs on the forward's calls.

Tolerances, ``test_torch_train.py``'s: loss, ce and aux rtol 1e-5;
gradient leaves atol 1e-5, rtol 1e-4 (the hybrid stack's within 1e-4 *
max|ref| of each leaf, as ``test_torch_hybrid_train.py`` holds its
unsharded ones); parameters after the steps atol 5e-5, rtol 1e-4.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as jtf
from repro_torch import config as tconfig
from repro_torch.configs import registry as tregistry
from repro_torch.distributed.mesh import local_mesh
from repro_torch.models import convert
from repro_torch.models import transformer as ttf
from repro_torch.train import train_step as tts
from torch_parity import REPO
from torch_routing import same_routing

MESH = (2, 4)
CPU = torch.device("cpu")
B, S, STEPS, LR = 4, 16, 2, 1e-2
# AdamW's eps for the steps: at the default 1e-8 an update divides a
# gradient element of ~1e-7 by its own magnitude, so the last bits of
# the sum decide it (two such elements of deepseek's embedding moved
# 0.004 apart); at 1e-4 such an element moves by ~lr * g / eps
EPS = 1e-4


def cfgs(arch):
    return tuple(dataclasses.replace(get(arch), dtype="float32",
                                     param_dtype="float32")
                 for get in (jregistry.get_smoke_config,
                             tregistry.get_smoke_config))


def batch_of(cfg, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def flat(tree, prefix=""):
    """A nested dict's leaves by their "/"-joined keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def n_moe(cfg) -> int:
    return sum(map(cfg.is_moe_layer, range(cfg.n_layers))) \
        if cfg.n_experts else 0


def reference(devices8, d, archs=(), step_arch=None) -> dict:
    devices8(f"""
        import dataclasses, sys
        import numpy as np
        import jax, jax.numpy as jnp
        sys.path.insert(0, {REPO!r} + "/tests")
        from repro import config as jconfig
        from repro.configs.registry import get_smoke_config
        from repro.distributed.mesh import local_mesh
        from repro.models import transformer as jtf
        from repro.train import train_step as jts
        from torch_mesh_train import batch_of, flat
        from torch_routing import assemble, mesh_recording
        mesh = local_mesh({MESH!r}, ("data", "model"))
        out = {{}}

        def routes_of(calls, name):
            routes = assemble(calls, {MESH!r})
            out[name + "/n_routes"] = np.int32(len(routes))
            for k, r in enumerate(routes):
                out[f"{{name}}/route{{k}}"] = r

        for arch in {tuple(archs)!r}:
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      dtype="float32", param_dtype="float32")
            params = jtf.init_model(cfg, jax.random.key(0))
            batch = {{k: jnp.asarray(v) for k, v in batch_of(cfg, 1).items()}}
            calls = []
            with mesh_recording(calls):
                f = jax.jit(jax.value_and_grad(
                    lambda p, b: jtf.loss_fn(cfg, p, b, mesh=mesh,
                                             dp_entry="data"),
                    has_aux=True))
                (loss, m), g = f(params, batch)
                jax.effects_barrier()
            routes_of(calls, arch)
            out[arch + "/loss"] = np.asarray(loss)
            out[arch + "/ce"] = np.asarray(m["ce"])
            out[arch + "/aux"] = np.asarray(m["aux"])
            out[arch + "/unsharded"] = np.asarray(jax.jit(
                lambda p, b: jtf.loss_fn(cfg, p, b)[0])(params, batch))
            for k, v in flat(g).items():
                out[f"{{arch}}/grad/{{k}}"] = v
        for arch in {(step_arch,) if step_arch else ()!r}:
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      dtype="float32", param_dtype="float32")
            params = jtf.init_model(cfg, jax.random.key(0))
            run = jconfig.RunConfig(cfg, jconfig.ShapeConfig(
                "t", {S}, {B}, "train"), train=jconfig.TrainConfig(
                    lr={LR}, eps={EPS}, warmup_steps=1,
                    remat_policy="none"))
            state = jts.init_train_state(cfg, run.train, params)
            step = jax.jit(jts.make_train_step(cfg, run, mesh=mesh,
                                               dp_entry="data"))
            calls = []
            with mesh_recording(calls):
                for i in range({STEPS}):
                    b = {{k: jnp.asarray(v)
                          for k, v in batch_of(cfg, 10 + i).items()}}
                    state, m = step(state, b)
                    out[f"step/{{i}}/loss"] = np.asarray(m["loss"])
                jax.effects_barrier()
            routes_of(calls, "step")
            for k, v in flat(state.params).items():
                out["step/params/" + k] = v
        np.savez({str(d / "ref.npz")!r}, **out)
        print("OK")
    """)
    return dict(np.load(d / "ref.npz"))


def forward_routes(ref, name, cfg, passes: int = 1) -> list:
    """The routings of the reference's forward passes: ``passes`` runs
    of its forward then its backward, which routes every MoE layer
    again (``jax.checkpoint``), or not."""
    routes = [ref[f"{name}/route{k}"]
              for k in range(int(ref[name + "/n_routes"]))]
    n = n_moe(cfg)
    per = len(routes) // passes
    assert per in (n, 2 * n) and per * passes == len(routes), \
        (len(routes), n, passes)
    return [r for i in range(passes) for r in routes[i * per:i * per + n]]


def model_of(jcfg, tcfg):
    np_params = jax.tree.map(np.asarray,
                             jtf.init_model(jcfg, jax.random.key(0)))
    return convert.params_from_numpy(tcfg, np_params, CPU)


def torch_batch(cfg, seed):
    return {k: torch.from_numpy(v) for k, v in batch_of(cfg, seed).items()}


def check_loss_and_gradients(ref, arch, leaf_rel=None):
    """``leaf_rel``: hold each gradient leaf within ``leaf_rel`` *
    max|ref leaf| instead of atol 1e-5, rtol 1e-4 (the hybrid stack's,
    as ``test_torch_hybrid_train.py`` holds it)."""
    jcfg, tcfg = cfgs(arch)
    model = model_of(jcfg, tcfg)
    model.requires_grad_(True)
    flips = []
    with same_routing(forward_routes(ref, arch, tcfg), "float32", flips):
        loss, m = ttf.loss_fn(tcfg, model, torch_batch(tcfg, 1),
                              mesh=local_mesh(MESH, device=CPU),
                              dp_entry="data")
    assert not any(flips)
    for k, got in (("loss", loss), ("ce", m["ce"]), ("aux", m["aux"])):
        np.testing.assert_allclose(float(got), float(ref[f"{arch}/{k}"]),
                                   rtol=1e-5, err_msg=k)
    # the mesh's own loss: its shards drop records the unsharded keeps
    assert abs(float(ref[arch + "/loss"]) - float(ref[arch + "/unsharded"])) \
        > 1e-4
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = flat(convert.ref_tree(tcfg, zip(names, (g.detach()
                                                  for g in grads))))
    want = {k[len(arch) + 6:]: v for k, v in ref.items()
            if k.startswith(arch + "/grad/")}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if leaf_rel is None:
            np.testing.assert_allclose(v, want[k], atol=1e-5, rtol=1e-4,
                                       err_msg=k)
        else:
            err = np.abs(v - want[k]).max()
            assert err <= leaf_rel * np.abs(want[k]).max(), (k, err)


def check_train_steps(ref, arch):
    jcfg, tcfg = cfgs(arch)
    model = model_of(jcfg, tcfg)
    run = tconfig.RunConfig(tcfg, tconfig.ShapeConfig("t", S, B, "train"),
                            train=tconfig.TrainConfig(
                                lr=LR, eps=EPS, warmup_steps=1,
                                remat_policy="none"))
    state = tts.init_train_state(tcfg, run.train, model)
    step = tts.make_train_step(tcfg, run, mesh=local_mesh(MESH, device=CPU),
                               dp_entry="data")
    flips = []
    with same_routing(forward_routes(ref, "step", tcfg, STEPS), "float32",
                      flips):
        for i in range(STEPS):
            state, m = step(state, torch_batch(tcfg, 10 + i))
            np.testing.assert_allclose(float(m["loss"]),
                                       float(ref[f"step/{i}/loss"]),
                                       rtol=1e-5)
    assert not any(flips)
    names = [n for n, _ in model.named_parameters()]
    got = flat(convert.ref_tree(tcfg, zip(
        names, (p.detach() for p in model.parameters()))))
    for k, v in got.items():
        np.testing.assert_allclose(v, ref["step/params/" + k], atol=5e-5,
                                   rtol=1e-4, err_msg=k)
