#!/usr/bin/env python3
"""flash_attention and ssd_scan on one CUDA card: the served shapes in
turns with an older build of the kernels, and the SMOKE shapes.

    python tools/kernel_turns.py [--parent DIR] [--rounds N] [--out FILE]

``--parent DIR`` holds an older ``flash_attention_bf16.cu``,
``flash_attention.cu`` (fp32) and ``ssd_scan_bf16.cu`` (``git show
<commit>:src/repro_torch/kernels/flash_attention/csrc/
flash_attention_bf16.cu`` and the others, under the ignored ``build/``).
Each is built with the same flags as the checkout's
(``kernels/backend.py``), its ``-Xptxas -v`` report printed beside the
checkout's, and called through a replica of its wrapper: the older C
entry points take no ``width`` argument and size the ssd_scan scratch by
the chunk. At the served shapes (olmo-1b's, stablelm-12b's and
internvl2-26b's prefill attention in bf16; whisper-tiny's encoder and
olmo-1b's, h2o-danube-1.8b's and stablelm-12b's attention shapes in
fp32, one a width of 64, 128, 80 and 160; mamba2-780m's and jamba-v0.1's
scans) the two builds run in turns, ``--rounds`` times parent, change,
change, parent, each turn timed by CUDA events over 20 calls and by the
profiler's device time over 20 calls: per build the mean, the least and
the most of its turns, so a difference can be read against the spread.

Then, without a parent, the kernels at the shapes the SMOKE configs hand
them (``chip_smoke.phase_smoke_serve``'s batch of 4 prompts of 64
tokens; internvl2 with its 16-row prefix, whisper's encoder in fp32 over
64 frames): events, device time, the plain version, SDPA for attention
(the library yardstick, never on the port's path) and the bound
(``chip_smoke.flash_bound``, ``ssd_bound``).

Prints a line a shape, one JSON line (also written to ``--out``), and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

SERVED_FLASH = {a: cs.FLASH_TIMED[a] for a in
                ("olmo-1b", "stablelm-12b", cs.VISION_ARCH)}
SERVED_FLASH_F32 = {
    f"{cs.AUDIO_ARCH} encoder": cs.FLASH_WHISPER_ENC,
    **{f"{a} fp32": cs.FLASH_TIMED[a][:7] + ("float32",)
       for a in ("olmo-1b", "h2o-danube-1.8b", "stablelm-12b")}}
SERVED_SSD = {"mamba2-780m": cs.SSD_SERVED, cs.HYBRID_ARCH: cs.SSD_JAMBA}
ITERS = 20


def _report(built) -> list[str]:
    return [line.strip() for line in built.log.splitlines()
            if "registers" in line or "spill" in line
            or "Compiling entry" in line]


def parent_flash(built, entry: str):
    """An older flash_attention build's C entry point, wrapped as the
    older wrapper calls it: flash(q, k, v, causal, window)."""
    fa_fn = getattr(ctypes.CDLL(str(built.path)), entry)
    fa_fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + \
        [ctypes.c_float, ctypes.c_void_p]
    fa_fn.restype = ctypes.c_int

    def flash(q, k, v, causal, window):
        B, Sq, H, hd = q.shape
        o = torch.empty_like(q)
        rc = fa_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   B, Sq, k.shape[1], H, k.shape[2], hd, int(causal),
                   int(window), hd ** -0.5,
                   torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return o
    return flash


def parent_wrappers(parent: Path) -> tuple:
    """The older builds' C entry points, wrapped as the older wrappers
    call them: ({dtype: flash(q, k, v, causal, window)}, ssd(x, dt, A, B,
    C, chunk)), and their ptxas reports."""
    backend = cs._port()[2]
    fa_b = backend.build(parent / "flash_attention_bf16.cu")
    fa32_b = backend.build(parent / "flash_attention.cu")
    ssd_b = backend.build(parent / "ssd_scan_bf16.cu")
    flash = {torch.bfloat16: parent_flash(fa_b,
                                          "flash_attention_bf16_launch"),
             torch.float32: parent_flash(fa32_b,
                                         "flash_attention_f32_launch")}
    ssd_fn = ctypes.CDLL(str(ssd_b.path)).ssd_scan_bf16_launch
    ssd_fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    ssd_fn.restype = ctypes.c_int

    def ssd(x, dt, A, B, C, chunk):
        Bb, S, H, P = x.shape
        N, n_chunks = B.shape[3], -(-S // chunk)
        y = torch.empty_like(x)
        state = torch.empty((Bb, H, P, N), dtype=torch.float32,
                            device=x.device)
        work = torch.empty(Bb * H * n_chunks * P * N, dtype=torch.float32,
                           device=x.device)
        cumdt = torch.empty(Bb * H * n_chunks * 2 * chunk,
                            dtype=torch.float32, device=x.device)
        rc = ssd_fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), y.data_ptr(), state.data_ptr(),
                    work.data_ptr(), cumdt.data_ptr(), Bb, S, H, B.shape[2],
                    P, N, chunk, int(dt.dtype == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return y, state
    return flash, ssd, {"flash_attention_bf16": _report(fa_b),
                        "flash_attention_f32": _report(fa32_b),
                        "ssd_scan_bf16": _report(ssd_b)}


def _both(fn) -> dict:
    return dict(ms=cs._event_ms(fn, ITERS),
                device_ms=cs._device_ms(fn, ITERS)[0])


def turns(fns: dict, rounds: int) -> dict:
    """``rounds`` times a, b, b, a: per name the mean, least and most of
    its turns' event and device ms."""
    got = {n: [] for n in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(rounds):
        for n in order:
            got[n].append(_both(fns[n]))
    out = {}
    for n, runs in got.items():
        for key in ("ms", "device_ms"):
            v = [r[key] for r in runs]
            out.setdefault(n, {})[key] = dict(mean=sum(v) / len(v),
                                              min=min(v), max=max(v))
    return out


def served_turns(parent: Path, rounds: int) -> dict:
    fa_ops, _ = cs._fa()
    ssd_ops, _ = cs._ssd()
    p_flashes, p_ssd, reports = parent_wrappers(parent)
    out = {"reports": reports}
    for arch, case in {**SERVED_FLASH, **SERVED_FLASH_F32}.items():
        q, k, v = cs.flash_inputs(case, "cuda")
        causal, window = case[5:7]
        p_flash = p_flashes[q.dtype]
        got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        same = torch.equal(got, p_flash(q, k, v, causal, window))
        out[f"flash_attention {arch}"] = dict(
            turns(
                {"parent": lambda: p_flash(q, k, v, causal, window),
                 "change": lambda: fa_ops.flash_attention(
                     q, k, v, causal=causal, window=window)}, rounds),
            bits_equal=same, shape=case)
        del q, k, v
    for arch, case in SERVED_SSD.items():
        args = cs.ssd_inputs(case, "cuda")
        chunk = case[6]
        got = ssd_ops.ssd(*args, chunk=chunk)
        want = p_ssd(*args, chunk)
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        out[f"ssd_scan {arch}"] = dict(
            turns({"parent": lambda: p_ssd(*args, chunk),
                   "change": lambda: ssd_ops.ssd(*args, chunk=chunk)},
                  rounds),
            bits_equal=same, shape=case)
        del args
    return out


def smoke_cases() -> tuple[dict, dict]:
    """The flash_attention and ssd_scan cases that 4s's prefills run, by
    arch, in the matrix's tuple form."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.models import transformer as tf
    B, S = cs.SMOKE_BATCH, cs.SMOKE_PROMPT
    flash, ssd = {}, {}
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        mixers = {tf.layer_kind(cfg, i)[0] for i in range(cfg.n_layers)}
        if "attn" in mixers:
            s = S + (cs.SMOKE_PREFIX if cfg.frontend == "vision_stub" else 0)
            window = cfg.sliding_window if cfg.attn_type == "swa" else 0
            flash[arch] = (B, s, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                           True, window, "bfloat16")
        if cfg.n_enc_layers:
            flash[f"{arch} encoder"] = (B, S, cfg.n_heads, cfg.n_heads,
                                        cfg.d_head, False, 0, "float32")
        if "ssm" in mixers:
            ssd[arch] = (B, S, cfg.n_ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state, cfg.ssm_groups, cfg.ssm_chunk,
                         "bfloat16", "bfloat16", None)
    return flash, ssd


def smoke_times() -> dict:
    fa_ops, fa_ref = cs._fa()
    ssd_ops, ssd_ref = cs._ssd()
    flash, ssd = smoke_cases()
    out = {}
    for name, case in flash.items():
        q, k, v = cs.flash_inputs(case, "cuda")
        causal, window = case[5:7]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=case[2] != case[3])
        # h2o's window of 32 over 64 positions: SDPA without a mask would
        # compute another function, so it takes the window's mask
        if window:
            pos = torch.arange(case[1], device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)

            def sdpa():   # noqa: F811
                return torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=case[2] != case[3])
        kernel = lambda: fa_ops.flash_attention(   # noqa: E731
            q, k, v, causal=causal, window=window)
        bound, by, work = cs.flash_bound(case)
        out[f"flash_attention {name}"] = dict(
            **_both(kernel), library_ms=cs._event_ms(sdpa, ITERS),
            library_device_ms=cs._device_ms(sdpa, ITERS)[0],
            plain_ms=cs._event_ms(lambda: fa_ref.flash_attention_plain(
                q, k, v, causal=causal, window=window), 3),
            bound_ms=bound, bound_by=by, shape=case,
            width=fa_ops.supported(case[4]), **work)
    for name, case in ssd.items():
        args = cs.ssd_inputs(case, "cuda")
        chunk = case[6]
        bound, by, work = cs.ssd_bound(case)
        out[f"ssd_scan {name}"] = dict(
            **_both(lambda: ssd_ops.ssd(*args, chunk=chunk)),
            plain_ms=cs._event_ms(
                lambda: ssd_ref.ssd_plain(*args, chunk=chunk), 3),
            library_ms=None, bound_ms=bound, bound_by=by, shape=case, **work)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default="")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = cs._port()[2]
    out = {"reports": {}}
    for what, ops, dtype in (
            ("flash_attention_bf16", cs._fa()[0], torch.bfloat16),
            ("flash_attention_f32", cs._fa()[0], torch.float32),
            ("ssd_scan_bf16", cs._ssd()[0], torch.bfloat16)):
        built = backend.build(ops.SOURCES[dtype])
        out["reports"][what] = _report(built)
        for line in out["reports"][what]:
            print(f"change {what}: {line}")
    if args.parent:
        out["served"] = served_turns(Path(args.parent), args.rounds)
        for what, lines in out["served"]["reports"].items():
            for line in lines:
                print(f"parent {what}: {line}")
        for name, r in out["served"].items():
            if name == "reports":
                continue
            print(f"{name}: bits equal {r['bits_equal']}; " + "; ".join(
                f"{b} events {r[b]['ms']['mean']:.4f} "
                f"[{r[b]['ms']['min']:.4f}, {r[b]['ms']['max']:.4f}] ms, "
                f"device {r[b]['device_ms']['mean']:.4f} "
                f"[{r[b]['device_ms']['min']:.4f}, "
                f"{r[b]['device_ms']['max']:.4f}] ms"
                for b in ("parent", "change")))
    out["smoke"] = smoke_times()
    for name, r in out["smoke"].items():
        lib = ("" if r["library_ms"] is None else
               f", SDPA {r['library_ms']:.4f} ms (device "
               f"{r['library_device_ms']:.4f})")
        print(f"{name} at {r['shape']}: {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms"
              f"{lib}, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
