"""Serve a small model with batched requests (prefill -> batched decode)
on the PyTorch/CUDA port: the run of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch ARCH]
        [--requests N] [--new-tokens N] [--device cpu]

``repro_torch.launch.serve`` at the arch's SMOKE config, batches of 8
requests of 32 prompt tokens, greedy. ``--arch`` takes any arch of
``repro_torch.configs.ARCH_IDS`` (default deepseek-v2-lite-16b); its
prefill runs the flash_attention and ssd_scan kernels at the SMOKE
widths. Runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

ARCH = "deepseek-v2-lite-16b"


def main(arch: str = ARCH, requests: int = 16, new_tokens: int = 24,
         device=None):
    """Serve ``requests`` SMOKE requests of ``arch`` on ``device`` (cuda
    unless given), printing the launcher's lines."""
    from repro_torch.launch import serve as serve_mod
    argv = ["--arch", arch, "--smoke", "--requests", str(requests),
            "--batch", "8", "--prompt-len", "32",
            "--new-tokens", str(new_tokens)]
    if device is not None:
        argv += ["--device", str(device)]
    serve_mod.main(argv)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=ARCH,
                    help="any arch of repro_torch.configs.ARCH_IDS "
                         "(smoke-sized config)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(args.arch, args.requests, args.new_tokens, args.device)
    sys.exit(0)
