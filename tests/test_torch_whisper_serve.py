"""The port's whisper-tiny stack against the JAX package, on the CPU.

At the whisper SMOKE config (2 decoder layers with cross-attention, a
2-layer encoder, LayerNorm, MHA 4 heads, d_model 64) in fp32 and bf16,
with the same seeded fp32 frames (24, S // enc_seq_factor) through both
packages, as the reference's launcher makes them: the tests of
``torch_stack_parity`` (the forward's logits and every cache,
``cross_k``/``cross_v`` included, through both paths, two decode steps,
greedy serving with ``frontend_embeds``, ``loss_fn`` and every gradient,
the encoder's included, on text-only labels, at the tolerances its
docstring states); the encoder's output alone; the dtypes JAX's
promotion gives (fp32 frames against bf16 weights: the encoder, its
output and each layer's ``cross_k``/``cross_v`` in fp32, the decoder's
k/v and logits in bf16); ``init_cache(enc_len)``; the registry, the cell
matrix and ``frontend_geometry`` of all ten archs; and the launcher.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import torch_parity  # noqa: E402,F401  (each xdist worker's core share)
from repro import config as jconfig  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from torch_stack_parity import (batches, close, frontend,  # noqa: E402
                                ref_cache, same_dtype, tokens)
from torch_stack_parity import (pair, test_decode_steps,  # noqa: E402,F401
                                test_forward_logits_aux_and_caches,
                                test_generate_greedy,
                                test_loss_fn_and_every_gradient_match_jax)

ARCH = "whisper-tiny"


@pytest.fixture(scope="module")
def arch():
    return ARCH


def test_smoke_config_has_an_encoder_and_cross_attention(pair):
    cfg = pair.tcfg
    assert cfg.n_enc_layers == 2 and cfg.frontend == "audio_stub"
    assert len(pair.tp["enc_blocks"]) == cfg.n_enc_layers
    layer = pair.tp["blocks"][0]
    assert sorted(layer) == ["attn", "cross", "mlp", "norm1", "norm2",
                             "norm_x"]
    assert sorted(layer["cross"]) == ["wk", "wo", "wq", "wv"]   # no bias
    assert sorted(pair.tp["enc_blocks"][0]) == ["attn", "mlp", "norm1",
                                                "norm2"]
    assert "scale" in pair.tp["enc_norm"]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_encoder_output_alone(pair, use_kernel):
    """``_encoder_forward`` on the frames: fp32 out of fp32 frames in
    both dtypes (bf16 weights meet the frames in fp32, exactly as JAX
    promotes them), so it is held at the fp32 tolerance; the kernel path
    against the reference's Pallas kernel in interpret mode."""
    fe = frontend(pair.tcfg)
    want = jtf._encoder_forward(pair.jcfg, pair.jp, jnp.asarray(fe),
                                use_pallas=use_kernel)
    got = ttf._encoder_forward(pair.tcfg, pair.tp, torch.from_numpy(fe),
                               use_kernel=use_kernel)
    assert got.dtype == torch.float32
    same_dtype(got, want, "enc_out")
    close(got, want, "float32", "enc_out")


def test_dtypes_follow_jax_promotion(pair):
    """fp32 frames: ``enc_out``, ``cross_k`` and ``cross_v`` in fp32 in
    both dtypes, the decoder's k/v and its logits in the model dtype,
    each equal to the reference's."""
    toks, fe = tokens(pair.tcfg), frontend(pair.tcfg)
    jb, tb = batches(toks, fe)
    wl, _, jc = jtf.forward(pair.jcfg, pair.jp, jb, want_cache=True)
    with torch.no_grad():
        gl, _, tc = ttf.forward(pair.tcfg, pair.tp, tb, want_cache=True)
    dt = getattr(torch, pair.dtype)
    assert gl.dtype == dt
    same_dtype(gl, wl, "logits")
    for i, c in enumerate(tc["blocks"]):
        assert c["k"].dtype == c["v"].dtype == dt
        assert c["cross_k"].dtype == c["cross_v"].dtype == torch.float32
        w = ref_cache(pair.tcfg, jc, i)
        for name in c:
            same_dtype(c[name], w[name], f"layer {i} {name}")


def test_init_cache_with_enc_len(pair):
    """``init_cache(enc_len)``: zero caches of the reference's shapes and
    dtypes, ``cross_k``/``cross_v`` among them."""
    want = jtf.init_cache(pair.jcfg, 2, 20, enc_len=12)
    got = ttf.init_cache(pair.tcfg, 2, 20, enc_len=12, device="cpu")
    for i, c in enumerate(got["blocks"]):
        w = {k: v[i] for k, v in want["blocks"]["layer0"].items()}
        assert sorted(c) == sorted(w) == ["cross_k", "cross_v", "k", "v"]
        for name in c:
            assert tuple(c[name].shape) == w[name].shape
            same_dtype(c[name], w[name], name)
            assert not bool(c[name].any())


def test_registry_and_cells_are_the_references_over_all_ten_archs():
    assert tregistry.ARCH_IDS == jregistry.ARCH_IDS
    assert len(tregistry.ARCH_IDS) == 10
    for arch in tregistry.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            assert dataclasses.asdict(getattr(tregistry, get)(arch)) == \
                dataclasses.asdict(getattr(jregistry, get)(arch))
        for name, shape in tregistry.shape_cells().items():
            assert tregistry.cell_status(tregistry.get_config(arch),
                                         shape) == \
                jregistry.cell_status(jregistry.get_config(arch),
                                      jregistry.shape_cells()[name])
    for skips in (False, True):
        assert tregistry.runnable_cells(skips) == \
            jregistry.runnable_cells(skips)


def test_frontend_geometry_is_the_references_for_every_cell():
    assert [tspecs.vlm_prefix_len(n) for n in (64, 2048, 8192, 2**19)] == \
        [jspecs.vlm_prefix_len(n) for n in (64, 2048, 8192, 2**19)]
    seen = {}
    served = ("serve_2k", 2048, 8, "prefill")     # the smoke's phase 4
    for arch in tregistry.ARCH_IDS:
        for tshape, jshape in [*zip(tregistry.shape_cells().values(),
                                    jregistry.shape_cells().values()),
                               (tconfig.ShapeConfig(*served),
                                jconfig.ShapeConfig(*served))]:
            got = tspecs.frontend_geometry(tregistry.get_config(arch), tshape)
            want = jspecs.frontend_geometry(jregistry.get_config(arch),
                                            jshape)
            assert got == want, (arch, tshape.name)
            seen[arch, tshape.name] = got
    assert seen["whisper-tiny", "train_4k"] == (4096, 2048, 2048)
    assert seen["internvl2-26b", "prefill_32k"] == (31_744, 1024, 0)
    assert seen["whisper-tiny", "serve_2k"] == (2048, 1024, 1024)
    assert seen["internvl2-26b", "serve_2k"] == (1536, 512, 0)
    assert seen["olmo-1b", "serve_2k"] == (2048, 0, 0)


def test_launch_serve_on_the_cpu(capsys):
    """The launcher serves the SMOKE stack to the end: ``--prompt-len``
    fp32 frames a request, as the reference's launcher makes them."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--prompt-len", "24",
                "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "whisper-smoke on cpu: 2 layers" in out
    assert "done: 9 tokens" in out
