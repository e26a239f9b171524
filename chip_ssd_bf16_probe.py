"""How far two correct bf16 paths of a deep SSD stack part on the card.

Run on a machine with a card, from the repository's root:

    python3 chip_ssd_bf16_probe.py

It prints, on an NVIDIA card with TF32 off:

  * for each row count M, the share of bf16 output elements that differ
    from one whole bf16 product ``x @ W`` when the same product is formed
    by column blocks (``in_proj`` [2560, 10576] in 4 blocks, ``out_proj``
    [5120, 2560] in 4), by f32 row-block partials summed and rounded once,
    and by one f32 product rounded once;
  * mamba2-2.7b at full width (64 layers) in bf16, prefill of 2 x 64
    random tokens on (data 2, model 4) positions on the card: the
    held-once path at batch 1 against batch 2 (nothing changes but the
    products' row count), the own-shards path against the held-once one,
    and each against the held-once path over the same weights in f32, as
    the largest |logit difference| and whether each row's argmax agrees.

``chip_smoke.py`` phase 20 (e) / (f) read these numbers to define a bf16
near-tie (``lms_tokens_agree(replay_f32=...)``).  Nothing here is a gate.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch


def mismatch(a: torch.Tensor, b: torch.Tensor) -> str:
    return (f"{(a != b).float().mean().item():.2e} of elements differ, "
            f"max {(a.float() - b.float()).abs().max().item():.3e}")


def products(gen: torch.Generator) -> None:
    D, N, di = 2560, 10576, 5120
    w_in = (torch.randn(D, N, device="cuda", generator=gen)
            / D ** 0.5).bfloat16()
    w_out = (torch.randn(di, D, device="cuda", generator=gen)
             / di ** 0.5).bfloat16()
    for m in (1, 2, 8, 64, 128):
        x = torch.randn(m, D, device="cuda", generator=gen).bfloat16()
        o = torch.randn(m, di, device="cuda", generator=gen).bfloat16()
        whole = x @ w_in
        cols = torch.cat([x @ blk for blk in w_in.chunk(4, dim=1)], -1)
        out = o @ w_out
        out_cols = torch.cat([o @ blk for blk in w_out.chunk(4, dim=1)], -1)
        rows = sum(a.float() @ b.float() for a, b in
                   zip(o.chunk(4, dim=1), w_out.chunk(4, dim=0))).bfloat16()
        f32 = (o.float() @ w_out.float()).bfloat16()
        print(f"[probe] M = {m}: in_proj by column blocks {mismatch(cols, whole)}"
              f"; out_proj by column blocks {mismatch(out_cols, out)}; by f32 "
              f"row partials {mismatch(rows, out)}; one f32 product "
              f"{mismatch(f32, out)}", flush=True)


def mamba2() -> None:
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_plan, shard_params
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.models import get_bundle
    from repro_torch.models import lm as LM
    from repro_torch.train.tree import tree_map

    cfg = get_config("mamba2-2.7b")
    mesh = make_position_mesh((("data", 2), ("model", 4)), "cuda:0")
    held = make_plan(cfg, mesh, decode_batch=2)
    own = make_plan(cfg, mesh, decode_batch=2, own_shards=True)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(3))
    params = get_bundle(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(5))
    f32, _ = LM.lm_prefill(cfg, tree_map(lambda t: t.float(), params), toks,
                           splan=held, ctx=72)
    two, _ = LM.lm_prefill(cfg, params, toks, splan=held, ctx=72)
    one = torch.cat([LM.lm_prefill(cfg, params, toks[i:i + 1], splan=held,
                                   ctx=72)[0] for i in range(2)])
    mine, _ = LM.lm_prefill(cfg, shard_params(params, own), toks, splan=own,
                            ctx=72)

    def gaps(x):
        top = torch.topk(x.float(), 2, dim=-1).values
        return [round(v, 4) for v in (top[:, 0] - top[:, 1]).tolist()]

    def line(what, a, b):
        print(f"[probe] mamba2-2.7b bf16 prefill 2 x 64, {what}: max |logit "
              f"difference| {(a.float() - b.float()).abs().max().item():.4f}, "
              f"argmax equal {(a.argmax(-1) == b.argmax(-1)).tolist()}",
              flush=True)

    line("held once at batch 1 against batch 2", one, two)
    line("own shards against held once", mine, two)
    line("held once against its f32 path", two, f32)
    line("own shards against the held-once f32 path", mine, f32)
    print(f"[probe] top-two gaps: held once bf16 {gaps(two)}, f32 "
          f"{gaps(f32)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ssd_bf16_probe: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_ssd_bf16_probe: src/repro_torch not found beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[probe] on {smi}", flush=True)
    products(torch.Generator(device="cuda").manual_seed(0))
    mamba2()
    return 0


if __name__ == "__main__":
    sys.exit(main())
