"""Training launcher: config -> model -> train state -> double-buffered
batches -> train step (grad accumulation, remat, AdamW) -> async
checkpoints -> throughput tracking -> resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --device cpu --steps 20                       # on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 20 --batch 8 --seq 512 --microbatch 4         # on the card
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v2-lite-16b --smoke --device cpu --dispatch 2s
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v2-lite-16b --smoke --device cpu --devices 8 \\
        --mesh 2x4                                  # a (data, model) mesh

The flags are the reference's (``repro.launch.train``) plus ``--device``
(cuda unless given; no fallback to the CPU). ``--arch`` takes any arch of
the port's registry; an MoE stack trains with ``--dispatch`` 1s or 2s,
its MoE layers slotting their records through the bucket_slots kernel
on the card. At full depth deepseek-v2-lite-16b (fp32 moments, ~188 GB)
and jamba-v0.1-52b do not fit one 80 GB card. ``--devices N --mesh DxM``
(D x M must be N; ``--devices N`` alone is N x 1) trains under a
(data, model) mesh of virtual ranks on the one device, as the
reference's launcher does on N host devices: the batch split over
"data", the MoE layers' tokens and experts over "model"
(``distributed/mesh.py``). ``--ckpt-dir`` writes
a snapshot every ``--ckpt-every`` steps and at the end, under the
reference's leaf keys; ``--resume`` continues from the latest one and
replays the batch sequence from there (``lm_batches(skip=...)``).
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--mesh", default="",
                    help="DxM data x model, e.g. 2x4 (default: devices x 1)")
    ap.add_argument("--dispatch", choices=["1s", "2s"], default="1s")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--vocab", type=int, default=0,
                    help="override vocab (synth data); 0 = config vocab")
    ap.add_argument("--tokens", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import dataclasses
    import time

    import numpy as np

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.config import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data.corpus import lm_token_stream
    from repro_torch.data.pipeline import DoubleBufferedLoader, lm_batches
    from repro_torch.distributed.mesh import local_mesh
    from repro_torch.ft.straggler import ThroughputTracker
    from repro_torch.launch import specs as sp
    from repro_torch.models.transformer import init_model
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              restore_state, state_tree)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = dataclasses.replace(cfg, dispatch_mode=args.dispatch)
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab_size=args.vocab)

    if args.mesh:
        d, m = map(int, args.mesh.split("x"))
    else:
        d, m = args.devices, 1
    assert d * m == args.devices, (d, m, args.devices)
    mesh_cfg = MeshConfig((d, m), ("data", "model"))

    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    run = sp.make_run(cfg, shape, mesh_cfg, microbatch=args.microbatch)
    run = dataclasses.replace(run, train=TrainConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps, seed=args.seed))
    dp = sp.dp_entry_for(shape, mesh_cfg)

    params = init_model(cfg, args.seed, device=args.device)
    device = params.device
    mesh = (local_mesh((d, m), ("data", "model"), device)
            if args.devices > 1 else None)
    print(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params on "
          f"{device}, mesh {d}x{m}, batch {args.batch}x{args.seq}, accum "
          f"{run.grad_accum_steps}, remat {run.train.remat_policy}, "
          f"dispatch {cfg.dispatch_mode}")
    state = init_train_state(cfg, run.train, params)

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=2)
        if args.resume and mgr.latest_step() is not None:
            s, extra = restore_state(mgr, cfg, state)
            start_step = extra.get("next_step", s + 1)
            print(f"[train] resumed from step {s} -> starting {start_step}")

    toks = lm_token_stream(args.tokens, cfg.vocab_size, seed=args.seed)
    it = lm_batches(toks, args.batch, args.seq, seed=args.seed,
                    skip=start_step)
    loader = DoubleBufferedLoader(it, device)

    step_fn = make_train_step(cfg, run, mesh=mesh, dp_entry=dp)
    tracker = ThroughputTracker(n_procs=1)

    t_start = time.perf_counter()
    tokens_per_step = args.batch * args.seq
    losses = []
    for step, batch in zip(range(start_step, args.steps), loader):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        tracker.update(np.asarray([dt]))
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{tokens_per_step / dt:,.0f} tok/s")
        if mgr and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step, state_tree(cfg, state),
                           extra={"next_step": step + 1})
    if mgr:
        # through the same worker, after any save still pending
        mgr.save_async(args.steps - 1, state_tree(cfg, state),
                       extra={"next_step": args.steps})
        mgr.wait()
    wall = time.perf_counter() - t_start
    n_done = args.steps - start_step
    if losses:
        print(f"[train] done: {n_done} steps in {wall:.1f}s "
              f"({n_done * tokens_per_step / wall:,.0f} tok/s), "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
