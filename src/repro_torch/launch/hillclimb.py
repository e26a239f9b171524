"""Hillclimb driver: count a cell with config overrides and report its
roofline terms (torch; mirrors ``repro/launch/hillclimb.py``).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch llama4-scout-17b-a16e --shape decode_32k \\
        --set moe_decode_ep=true --tag ep-psum-decode \\
        --out experiments/hillclimb.jsonl

The cell is counted on meta by ``launch/dryrun.run_cell`` (terms under the
``H100`` table); importing this module has no side effects.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_override(kv: str):
    k, v = kv.split("=", 1)
    if v.lower() in ("true", "false"):
        return k, v.lower() == "true"
    try:
        return k, int(v)
    except ValueError:
        pass
    try:
        return k, float(v)
    except ValueError:
        return k, v


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    ap.add_argument("--vocab-chunk", type=int, default=16_384)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import run_cell
    overrides = dict(parse_override(kv) for kv in args.set)
    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   opt_name=args.optimizer, vocab_chunk=args.vocab_chunk,
                   overrides=overrides or None,
                   microbatches=args.microbatches)
    rec["tag"] = args.tag
    rec["overrides"] = overrides
    rec["vocab_chunk"] = args.vocab_chunk
    rec["microbatches"] = args.microbatches
    line = json.dumps(rec)
    print(line[:500], flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    if rec["status"] == "failed":
        print(rec.get("traceback", ""), file=sys.stderr)
        return 1
    print(f"[{args.tag}] compute={rec['compute_s']:.4f}s "
          f"memory={rec['memory_s']:.4f}s "
          f"collective={rec['collective_s']:.4f}s "
          f"dominant={rec['dominant']} "
          f"roofline_fraction={rec['roofline_fraction']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
