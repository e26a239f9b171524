"""Training CLI: ``python -m repro_torch.launch.train --arch olmo-1b
[--full] [--device cpu]``.

Mirrors ``repro/launch/train.py``: a training job (the reduced config by
default, ``--full`` for the published one) with f32 parameters drawn from
``--seed``, through the fault-tolerant loop: deterministic data, periodic
checkpoints into ``--ckpt-dir``, and ``--resume`` from the latest one.
Prints the reference's JSON summary.  Runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.train.data import DataConfig, synthetic_batch
from repro_torch.train.fault import TrainLoop
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.trainer import init_state, make_train_step


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    opt = make_optimizer(OptimizerConfig(
        name=args.optimizer, lr=args.lr, warmup_steps=10,
        total_steps=max(args.steps, 100)))
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)

    dc = DataConfig(seed=args.seed, vocab_size=cfg.vocab_size,
                    batch=args.batch, seq_len=args.seq)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_state(cfg, opt, gen, dtype=torch.float32, device=device)

    loop = TrainLoop(step_fn, lambda k: synthetic_batch(dc, k),
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    start = None
    if args.resume and args.ckpt_dir:
        try:
            state, start = loop.restore(state)
            print(f"resumed from step {start}")
        except FileNotFoundError:
            pass
    state, report = loop.run(state, args.steps, start_step=start)
    summary = {
        "arch": args.arch, "steps": report.steps_run,
        "first_loss": report.losses[0], "last_loss": report.losses[-1],
        "mean_step_s": sum(report.step_times) / len(report.step_times),
        "stragglers": report.stragglers,
    }
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
