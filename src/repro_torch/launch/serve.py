"""Serving CLI: ``python -m repro_torch.launch.serve --arch olmo-1b
[--device cpu]``.

Mirrors ``repro/launch/serve.py``: spins the continuous-batching engine on
the REDUCED config with f32 weights drawn from ``--seed``, routes a
synthetic request trace through the forest router (trained on the same
device), and prints the engine's stats as JSON.  Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models.registry import get_bundle
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.router import ForestRouter, request_features


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-ctx", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config(args.arch))
    bundle = get_bundle(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = bundle.init(cfg, gen, dtype=torch.float32, device=device)
    engine = ServeEngine(cfg, params, slots=args.slots,
                         max_ctx=args.max_ctx,
                         prompt_buckets=(16, 32, 64), device=device)
    router = ForestRouter(seed=args.seed, device=device)

    rng = np.random.default_rng(args.seed)
    tiers = {0: 0, 1: 0}
    for _ in range(args.requests):
        plen = int(rng.integers(4, 48))
        mnt = int(rng.integers(4, 24))
        feats = request_features(plen, mnt, len(engine._queue),
                                 len(engine._active), 32.0)
        tier = router.route(feats)
        tiers[tier] += 1
        prompt = rng.integers(0, cfg.vocab_size, plen)
        engine.submit(prompt, max_new_tokens=mnt, priority=tier)

    done = engine.run_until_drained()
    stats = engine.stats()
    stats["tier0_interactive"] = tiers[0]
    stats["tier1_batch"] = tiers[1]
    print(json.dumps(stats, indent=2))
    if len(done) != args.requests:
        raise RuntimeError(f"engine dropped requests: {len(done)} of "
                           f"{args.requests} finished")
    return stats


if __name__ == "__main__":
    main()
