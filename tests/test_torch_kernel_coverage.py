"""Every shape the serving path hands the flash_attention and ssd_scan
kernels is one they take.

For every arch of the registry, at its published config and at its SMOKE
config, each head dim that a prefill runs through ``flash_attention``
(GQA and MHA layers, an encoder's too; MLA's 192 stays on
``flash_attention_ref``, as the reference's MLA does) has a width in
``fa_ops.supported``, and each SSD layer's (P, N, chunk) satisfies
``ssd_ops.supported``. The shapes are read from the configs as the model
reads them (``kernel_shapes``), and a prefill of each SMOKE config on
the CPU, its kernel calls recorded, shows the model hands the wrappers
exactly those. Head dims past the rule (18, 162, 192) and SSD sizes no
config reaches (P 128, N 64, chunk 24) are refused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402,F401  (puts the repo root on sys.path)
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

CONFIGS = [(arch, kind) for arch in ARCH_IDS for kind in ("full", "smoke")]


def _cfg(arch, kind):
    return (get_config if kind == "full" else get_smoke_config)(arch)


def kernel_shapes(cfg) -> tuple[set, set]:
    """The head dims ``cfg``'s prefill runs through flash_attention and
    the (P, N, chunk) it runs through ssd_scan, from the layer kinds."""
    mixers = {tf.layer_kind(cfg, i)[0] for i in range(cfg.n_layers)}
    hds = {cfg.d_head} if "attn" in mixers or cfg.n_enc_layers else set()
    ssd = ({(cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk)}
           if "ssm" in mixers else set())
    return hds, ssd


@pytest.mark.parametrize("arch,kind", CONFIGS)
def test_every_served_shape_is_one_the_kernels_take(arch, kind):
    cfg = _cfg(arch, kind)
    hds, ssd = kernel_shapes(cfg)
    for hd in hds:
        width = fa_ops.supported(hd)
        assert width is not None and width >= hd, (arch, kind, hd)
    for P, N, chunk in ssd:
        assert ssd_ops.supported(P, N, chunk), (arch, kind, P, N, chunk)
    if cfg.attn_type == "mla":         # the chunked reference, not the kernel
        assert not hds
        if kind == "full":
            assert fa_ops.supported(cfg.d_head) is None      # 192


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_a_smoke_prefill_hands_the_kernels_those_shapes(arch, monkeypatch):
    """The SMOKE prefill on the CPU with the wrappers recording: the head
    dims and SSD shapes it passes are ``kernel_shapes``'."""
    cfg = get_smoke_config(arch)
    seen = {"hd": set(), "ssd": set()}
    fa, ssd = fa_ops.flash_attention, ssd_ops.ssd

    def flash(q, k, v, **kw):
        seen["hd"].add(q.shape[-1])
        return fa(q, k, v, **kw)

    def scan(x, dt, A, B, C, *, chunk, **kw):
        seen["ssd"].add((x.shape[-1], B.shape[-1], chunk))
        return ssd(x, dt, A, B, C, chunk=chunk, **kw)
    monkeypatch.setattr(fa_ops, "flash_attention", flash)
    monkeypatch.setattr(ssd_ops, "ssd", scan)
    model = tf.init_model(cfg, 0, device="cpu")
    prompts, fe = chip_smoke.smoke_inputs(cfg, 2, 32)
    batch = {"tokens": torch.from_numpy(prompts)}
    if fe is not None:
        batch["frontend_embeds"] = torch.from_numpy(fe)
    with torch.inference_mode():
        logits = tf.prefill(cfg, model, batch, use_kernel=True)
    assert bool(torch.isfinite(logits.float()).all())
    assert (seen["hd"], seen["ssd"]) == kernel_shapes(cfg)


def test_the_width_rule():
    """Every hd that is a multiple of 4 from 16 to 160 runs on the
    smallest width that holds it; every other hd (18, 162, 192 among
    them) is refused."""
    widths = {hd: fa_ops.supported(hd) for hd in range(1, 200)}
    assert {hd: w for hd, w in widths.items() if w is not None} == {
        hd: next(w for w in fa_ops.WIDTHS if w >= hd)
        for hd in range(16, 161, 4)}
    assert [widths[hd] for hd in (16, 20, 24, 32, 36, 48, 52, 64, 68, 80,
                                  84, 100, 128, 132, 160)] == \
        [16, 32, 32, 32, 48, 48, 64, 64, 80, 80, 128, 128, 128, 160, 160]
    assert widths[18] is widths[162] is widths[192] is None


@pytest.mark.parametrize("chunk", range(8, 273, 8))
def test_the_ssd_rule(chunk):
    """P 16, 32 and 64 at N 16, 32 and 128, at every chunk that is a
    multiple of 16 up to 256; nothing else (P 128, N 64, chunk 24)."""
    for P in (8, 16, 32, 64, 128):
        for N in (8, 16, 32, 64, 128):
            want = (P in (16, 32, 64) and N in (16, 32, 128)
                    and chunk % 16 == 0 and chunk <= 256)
            assert ssd_ops.supported(P, N, chunk) == want, (P, N, chunk)


def test_the_matrix_covers_every_padded_width():
    """Each width's padded path (an hd narrower than the width that runs
    it) is in the smoke's matrix, causal and not, in both dtypes, and
    every hd there is taken."""
    padded = {(fa_ops.supported(c[4]), c[5], c[7])
              for c in chip_smoke.FLASH_MATRIX.values()
              if fa_ops.supported(c[4]) != c[4]}
    assert padded == {(w, causal, dtype) for w in fa_ops.WIDTHS[1:]
                      for causal in (True, False)
                      for dtype in ("bfloat16", "float32")}
    assert all(fa_ops.supported(c[4]) is not None
               for c in chip_smoke.FLASH_MATRIX.values())


def test_the_matrix_covers_the_smoke_scans():
    shapes = {(c[3], c[4], c[6], c[7]) for c in chip_smoke.SSD_MATRIX.values()}
    for dtype in ("bfloat16", "float32"):
        assert (16, 16, 16, dtype) in shapes
    assert {c[6] for c in chip_smoke.SSD_MATRIX.values()} >= {16, 32, 48, 80}
    assert np.all([ssd_ops.supported(c[3], c[4], c[6])
                   for c in chip_smoke.SSD_MATRIX.values()])
