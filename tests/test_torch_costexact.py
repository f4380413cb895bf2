"""The cost-exact ``unroll=True`` path against the reference's (its
programs in one 4-device subprocess, made once a module).

  * ``attention.flash_attention_costexact`` on seeded numpy inputs:
    causal and not, a sliding window, GQA, a ``q_offset``, and Sq = 300
    (not a multiple of the 128-row chunk); within 2e-5 in fp32 and
    3e-2 * max|out| in bf16;
  * ``forward``, ``prefill``, ``decode_step`` (from zero caches),
    ``loss_fn`` with every gradient, and one train step with
    ``unroll=True`` against the reference's ``unroll=True``, on the SMOKE
    configs of olmo-1b, h2o-danube (SWA), deepseek-v2-lite (MLA, MoE) and
    whisper-tiny (encoder, cross-attention) in fp32, at 2 x 300 tokens
    (three q chunks, the SWA band cut): logits and loss within 1e-5,
    gradients atol 1e-5 / rtol 1e-4, parameters after the step atol
    5e-5 / rtol 1e-4 (``test_torch_train.py``'s and
    ``torch_mesh_train.py``'s);
  * the port's MoE layer with ``unroll=True`` bit for bit its
    ``unroll=False``, unsharded and on a mesh.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.distributed.mesh import local_mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from torch_mesh_train import flat  # noqa: E402
from torch_parity import REPO  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ("olmo-1b", "h2o-danube-1.8b", "deepseek-v2-lite-16b",
         "whisper-tiny")
B, S = 2, 300
LR, EPS = 1e-2, 1e-4
# (B, Sq, Skv, H, KV, hd, causal, window, q_offset)
CASES = {
    "causal": (2, 256, 256, 4, 4, 32, True, 0, 0),
    "cross": (2, 200, 96, 4, 4, 32, False, 0, 0),
    "window": (1, 512, 512, 4, 4, 32, True, 64, 0),
    "gqa": (2, 256, 256, 8, 2, 32, True, 0, 0),
    "q_offset": (2, 128, 228, 4, 2, 32, True, 0, 100),
    "sq300": (2, 300, 300, 4, 4, 16, True, 0, 0),
    "sq300_window": (1, 300, 300, 4, 2, 16, True, 40, 0),
}
DTYPES = ("float32", "bfloat16")


def qkv_of(case, seed=0):
    b, sq, skv, h, kv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32))


def cfg_of(arch):
    return dataclasses.replace(tregistry.get_smoke_config(arch),
                               dtype="float32", param_dtype="float32")


def batch_of(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_enc_layers:
        b["frontend_embeds"] = rng.standard_normal(
            (B, S // cfg.enc_seq_factor, cfg.d_model)).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def ref(devices8, tmp_path_factory):
    d = tmp_path_factory.mktemp("costexact")
    devices8(f"""
        import dataclasses, sys
        import numpy as np, jax, jax.numpy as jnp
        sys.path.insert(0, {REPO!r} + "/tests")
        from repro import config as jconfig
        from repro.configs.registry import get_smoke_config
        from repro.models import attention as jattn
        from repro.models import transformer as jtf
        from repro.train import train_step as jts
        from test_torch_costexact import (ARCHS, B, CASES, DTYPES, EPS, LR, S,
                                          batch_of, qkv_of)
        from torch_mesh_train import flat
        out = {{}}
        for name, case in CASES.items():
            *_, causal, window, q_offset = case
            for dt in DTYPES:
                q, k, v = (jnp.asarray(a, dt) for a in qkv_of(case))
                o = jattn.flash_attention_costexact(
                    q, k, v, causal=causal, window=window, q_offset=q_offset)
                out[f"fa/{{name}}/{{dt}}"] = np.asarray(o, np.float32)
        for arch in ARCHS:
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      dtype="float32", param_dtype="float32")
            params = jtf.init_model(cfg, jax.random.key(0))
            batch = {{k: jnp.asarray(v) for k, v in batch_of(cfg).items()}}
            fwd = {{k: v for k, v in batch.items() if k != "labels"}}
            logits, aux = jax.jit(lambda p, b: jtf.forward(
                cfg, p, b, unroll=True))(params, fwd)
            out[arch + "/forward"] = np.asarray(logits)
            out[arch + "/aux"] = np.asarray(aux)
            out[arch + "/prefill"] = np.asarray(jax.jit(
                lambda p, b: jtf.prefill(cfg, p, b, unroll=True))(params, fwd))
            enc = (S // cfg.enc_seq_factor) if cfg.n_enc_layers else 0
            cache = jtf.init_cache(cfg, B, S, enc_len=enc)
            lg, _ = jax.jit(lambda p, c, t: jtf.decode_step(
                cfg, p, c, t, 0, unroll=True))(params, cache,
                                               batch["tokens"][:, :1])
            out[arch + "/decode"] = np.asarray(lg)
            (loss, m), g = jax.jit(jax.value_and_grad(
                lambda p, b: jtf.loss_fn(cfg, p, b, unroll=True),
                has_aux=True))(params, batch)
            out[arch + "/loss"] = np.asarray(loss)
            for k, v in flat(g).items():
                out[f"{{arch}}/grad/{{k}}"] = v
            run = jconfig.RunConfig(cfg, jconfig.ShapeConfig(
                "t", S, B, "train"), train=jconfig.TrainConfig(
                    lr=LR, eps=EPS, warmup_steps=1, remat_policy="none"))
            state = jts.init_train_state(cfg, run.train, params)
            state, m = jax.jit(jts.make_train_step(cfg, run, unroll=True))(
                state, batch)
            out[arch + "/step/loss"] = np.asarray(m["loss"])
            for k, v in flat(state.params).items():
                out[f"{{arch}}/step/params/{{k}}"] = v
        np.savez({str(d / "ref.npz")!r}, **out)
        print("OK")
    """, n_devices=4)
    return dict(np.load(d / "ref.npz"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_costexact_attention_matches_the_reference(ref, name, dtype):
    case = CASES[name]
    *_, causal, window, q_offset = case
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt) for a in qkv_of(case))
    got = tattn.flash_attention_costexact(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset)
    assert got.dtype == dt and got.shape == q.shape
    got = got.float().numpy()
    want = ref[f"fa/{name}/{dtype}"]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    else:
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
    # and the chunked reference path agrees with it
    plain = tattn.flash_attention_ref(
        torch.from_numpy(qkv_of(case)[0]), *(torch.from_numpy(a) for a in
                                             qkv_of(case)[1:]),
        causal=causal, window=window, q_offset=q_offset)
    if dtype == "float32":
        np.testing.assert_allclose(got, plain.numpy(), atol=2e-5, rtol=0)


def _model(arch):
    cfg = cfg_of(arch)
    jcfg = dataclasses.replace(jregistry.get_smoke_config(arch),
                               dtype="float32", param_dtype="float32")
    tree = jax.tree.map(np.asarray, jtf.init_model(jcfg, jax.random.key(0)))
    return cfg, convert.params_from_numpy(cfg, tree, CPU)


def _batch(cfg):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch_of(cfg).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_the_reference(ref, arch):
    cfg, model = _model(arch)
    batch = _batch(cfg)
    fwd = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        logits, aux = ttf.forward(cfg, model, fwd, unroll=True)
    close = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), ref[arch + "/forward"],
                               **close)
    np.testing.assert_allclose(float(aux), float(ref[arch + "/aux"]),
                               **close)
    last = ttf.prefill(cfg, model, fwd, unroll=True)
    np.testing.assert_allclose(last.numpy(), ref[arch + "/prefill"], **close)
    enc = (S // cfg.enc_seq_factor) if cfg.n_enc_layers else 0
    cache = ttf.init_cache(cfg, B, S, enc_len=enc, device=CPU)
    lg, _ = ttf.decode_step(cfg, model, cache, batch["tokens"][:, :1], 0,
                            unroll=True)
    np.testing.assert_allclose(lg.numpy(), ref[arch + "/decode"], **close)
    # unroll only re-routes attention: the plain path's logits agree
    with torch.no_grad():
        plain, _ = ttf.forward(cfg, model, fwd)
    np.testing.assert_allclose(logits.numpy(), plain.numpy(), **close)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_and_a_train_step_match_the_reference(ref, arch):
    cfg, model = _model(arch)
    batch = _batch(cfg)
    model.requires_grad_(True)
    loss, _ = ttf.loss_fn(cfg, model, batch, unroll=True)
    np.testing.assert_allclose(float(loss.detach()), float(ref[arch + "/loss"]),
                               rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = flat(convert.ref_tree(cfg, zip(names, grads)))
    pre = arch + "/grad/"
    want = {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)

    run = tconfig.RunConfig(cfg, tconfig.ShapeConfig("t", S, B, "train"),
                            train=tconfig.TrainConfig(
                                lr=LR, eps=EPS, warmup_steps=1,
                                remat_policy="none"))
    state = tts.init_train_state(cfg, run.train, model)
    state, m = tts.make_train_step(cfg, run, unroll=True)(state, batch)
    np.testing.assert_allclose(float(m["loss"]),
                               float(ref[arch + "/step/loss"]), rtol=1e-5)
    got = flat(convert.ref_tree(cfg, zip(
        names, (p.detach() for p in model.parameters()))))
    pre = arch + "/step/params/"
    for k, v in got.items():
        np.testing.assert_allclose(v, ref[pre + k], atol=5e-5, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_moe_layer_unrolled_is_bit_for_bit_the_plain_one(mesh):
    cfg = cfg_of("deepseek-v2-lite-16b")
    model = ttf.init_model(cfg, 0, device=CPU)
    p = model["blocks"][cfg.first_k_dense]["moe"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, 16, cfg.d_model)).astype(np.float32))
    kw = {} if mesh is None else dict(mesh=local_mesh(mesh, device=CPU),
                                      dp_entry="data")
    with torch.no_grad():
        y0, a0 = tmoe.moe_forward(cfg, p, x, **kw)
        y1, a1 = tmoe.moe_forward(cfg, p, x, unroll=True, **kw)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
