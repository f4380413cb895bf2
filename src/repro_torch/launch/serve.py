"""Serving launcher: batched-request generation over one model replica.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --requests 16 --prompt-len 2048 --new-tokens 32      # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --smoke                              # the SMOKE config on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --smoke --device cpu                                 # on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --smoke --device cpu                   # the ssm stack, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-lite-16b --smoke --device cpu   # MoE + MLA
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-lite-16b --requests 8 --prompt-len 2048 \\
        --new-tokens 32                      # 31.3 GB of bf16 weights
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-v0.1-52b --smoke --device cpu      # the hybrid stack
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama4-maverick-400b-a17b --layers 2 --requests 8 \\
        --prompt-len 2048            # one dense and one MoE layer, 37.1 GB
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch internvl2-26b --requests 8 --prompt-len 2048  # 39.7 GB
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch whisper-tiny --requests 8 --prompt-len 2048

``--arch`` takes any arch of ``repro_torch.configs.ARCH_IDS``: olmo-1b,
h2o-danube-1.8b, codeqwen1.5-7b and stablelm-12b (dense; stablelm's head
dim is 160), mamba2-780m (ssm), deepseek-v2-lite-16b (MoE with MLA
attention and one leading dense layer) and llama4-maverick-400b-a17b
(dense and MoE layers 1:1, 128 experts top-1 and a shared expert),
whose MoE layers slot their records through the bucket_slots kernel on
the card, jamba-v0.1-52b (hybrid: SSD and GQA attention layers, MoE
on every other layer), whisper-tiny (a 4-layer encoder over fp32
frames and cross-attention in every decoder layer) and internvl2-26b (a
vision prefix ahead of the prompt). The frontends are stubs: as the
reference's launcher does, a VLM takes 16 seeded prefix rows a request
and an audio stack ``--prompt-len`` seeded fp32 frames. The cache holds
``--prompt-len + --new-tokens + 8`` positions, so with a vision prefix
the last 7 decode steps overwrite the cache's last slot, as the
reference's do. ``--layers N`` serves the first N layers at the
arch's full width: jamba's 32 layers hold ~103 GB of bf16 weights and
llama4's 48 ~795 GB, more than one 80 GB card.

``--smoke`` serves the arch's SMOKE config, on the card as on the CPU:
its head dims (16-32) and SSD scans (P 16, chunk 16) run on the
kernels' narrow instantiations. The weights are random, from
``--seed``. Runs on ``cuda`` unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--layers", type=int, default=0,
                    help="serve the first N layers (default: all)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models.transformer import init_model
    from repro_torch.serve.engine import ServeEngine

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = init_model(cfg, args.seed, device=args.device)
    max_len = args.prompt_len + args.new_tokens + 8
    eng = ServeEngine(cfg, params, max_len=max_len, device=params.device)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.requests, args.prompt_len)).astype(np.int32)
    fe = None
    if cfg.frontend == "vision_stub":
        fe = rng.normal(size=(args.requests, 16, cfg.d_model)).astype(
            np.float32)
    elif cfg.n_enc_layers:
        fe = rng.normal(size=(args.requests, args.prompt_len,
                              cfg.d_model)).astype(np.float32)

    print(f"[serve] {cfg.name} on {eng.device}: {cfg.n_layers} layers, "
          f"{args.requests} requests, "
          f"batch {args.batch}, prompt {args.prompt_len}, "
          f"gen {args.new_tokens}")
    t0 = time.perf_counter()
    n_out = 0
    for lo in range(0, args.requests, args.batch):
        hi = min(args.requests, lo + args.batch)
        out = eng.generate(
            prompts[lo:hi], args.new_tokens,
            frontend_embeds=None if fe is None else fe[lo:hi],
            greedy=args.greedy, seed=args.seed)
        n_out += out.size
        print(f"[serve] batch {lo}-{hi}: first row {out[0, :8].tolist()}")
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    print(f"[serve] done: {n_out} tokens in {wall:.1f}s "
          f"({n_out / wall:,.0f} tok/s incl. the first call's set-up)")


if __name__ == "__main__":
    main()
