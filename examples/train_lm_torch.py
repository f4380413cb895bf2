"""Train an LM through the whole stack on the PyTorch/CUDA port (config
-> sharded state -> decoupled-dispatch MoE -> async checkpoints ->
restart): the run of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps N]
        [--dispatch 1s|2s] [--ckpt-dir DIR] [--device cpu]
    PYTHONPATH=src python examples/train_lm_torch.py --full-100m --steps 300

By default llama4-maverick's SMOKE config (dense and MoE layers 1:1)
trains on a (data 2, model 2) mesh of 4 virtual ranks, batch 4 x 64, its
MoE layers dispatched as ``--dispatch`` says (their records slotted by
the bucket_slots kernel on the card). ``--full-100m`` trains the
olmo-family dense ~100M model instead (8 layers, d_model 512, d_ff 2048,
vocabulary 32,000: the port's olmo-1b SMOKE config patched to that
size) on a (data 4, model 2) mesh, batch 8 x 256. Both snapshot into
``--ckpt-dir`` (under the temporary directory by default) and resume
from the latest snapshot there. Runs on the card unless given
``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path


def launcher_argv(full_100m: bool = False, steps: int = 200,
                  dispatch: str = "1s", ckpt_dir=None) -> list[str]:
    """The ``launch.train`` flags of the run, the reference example's."""
    if ckpt_dir is None:
        name = "repro_torch_train_100m" if full_100m else \
            "repro_torch_train_moe"
        ckpt_dir = Path(tempfile.gettempdir()) / name
    if full_100m:
        # olmo-family dense ~100M: 8L x d512 x ff2048, vocab 32k
        return ["--smoke", "--arch", "olmo-1b", "--steps", str(steps),
                "--batch", "8", "--seq", "256", "--devices", "8",
                "--mesh", "4x2", "--vocab", "32000",
                "--ckpt-dir", str(ckpt_dir), "--resume", "--log-every", "10"]
    # llama4-family reduced MoE: the paper's decoupled dispatch inside the
    # train step
    return ["--arch", "llama4-maverick-400b-a17b", "--smoke",
            "--steps", str(steps), "--batch", "4", "--seq", "64",
            "--devices", "4", "--mesh", "2x2", "--dispatch", dispatch,
            "--ckpt-dir", str(ckpt_dir), "--resume", "--log-every", "20"]


def main(full_100m: bool = False, steps: int = 200, dispatch: str = "1s",
         ckpt_dir=None, device=None) -> list[float]:
    """Train on ``device`` (cuda unless given); returns the losses of the
    steps run."""
    from repro_torch.launch import train as train_mod

    argv = launcher_argv(full_100m, steps, dispatch, ckpt_dir)
    if full_100m:
        from repro_torch.configs import olmo_1b
        olmo_1b.SMOKE = dataclasses.replace(
            olmo_1b.SMOKE, n_layers=8, d_model=512, d_ff=2048, n_heads=8,
            n_kv_heads=8, vocab_size=32_000)
    if device is not None:
        argv += ["--device", str(device)]
    return train_mod.main(argv)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dispatch", choices=["1s", "2s"], default="1s")
    ap.add_argument("--ckpt-dir", default=None,
                    help="snapshot directory (default: under the "
                         "temporary directory)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(args.full_100m, args.steps, args.dispatch, args.ckpt_dir,
         args.device)
    sys.exit(0)
