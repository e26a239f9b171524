"""Dry-run: count every (arch x shape x mesh) cell at full width on meta.

Mirrors ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell's step on 512 forced host devices against ``ShapeDtypeStruct``
inputs and reads XLA's memory and cost analyses and the compiled HLO.  The
port has no compiled program: ``run_cell`` builds the production mesh with
every position on ``meta`` (nothing is allocated and nothing computed),
runs the cell's step once over meta inputs (``input_specs``,
``state_shapes``, ``init`` on meta) under ``launch/hlo_cost.analyze``, and
reports the reference's record keys where they have a counterpart, with
the roofline terms under the ``H100`` table (``docs/torch_dryrun.md``):

  ``trace_s``                      the traced step's wall (for ``lower_s`` /
                                   ``compile_s``);
  ``flops_per_chip``, ``bytes_per_chip``, the collective keys
                                   the whole step's count / positions (an
                                   even split);
  ``memory_analysis``              ``argument_size_in_bytes`` a position's
                                   shards of the arguments by their specs,
                                   ``temp_size_in_bytes`` the traced peak of
                                   live bytes less the arguments, /
                                   positions (an estimate).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
  ... add --multi-pod for the (pod=2, data=16, model=16) mesh.

No ``--keep-hlo`` (there is no HLO), no ``--unroll`` (eager runs every
layer; nothing is counted once for a loop), and no ``XLA_FLAGS``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.dist.sharding import (NamedSharding, P, batch_specs,
                                       cache_specs, make_plan, param_specs)
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import H100, make_production_mesh
from repro_torch.launch.roofline import model_flops, roofline_terms
from repro_torch.models.registry import get_bundle, input_specs
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.trainer import make_train_step, state_shapes
from repro_torch.train.tree import tree_leaves, tree_map

__all__ = ["LONG_OK", "ADAFACTOR_ARCHS", "cell_skip_reason", "build_cell",
           "position_bytes", "run_cell", "main"]

# long_500k needs sub-quadratic attention: runnable for SSM/hybrid and the
# chunked-local iRoPE MoE archs; skipped (and recorded) for pure
# full-attention archs (the reference's DESIGN.md §4).
LONG_OK = {"mamba2-2.7b", "zamba2-2.7b", "llama4-scout-17b-a16e",
           "llama4-maverick-400b-a17b"}

# big models use adafactor so the optimizer state fits 16 GB/chip (the
# reference's §5)
ADAFACTOR_ARCHS = {"llama4-maverick-400b-a17b", "llama4-scout-17b-a16e",
                   "yi-34b", "chameleon-34b"}


def cell_skip_reason(arch: str, shape_name: str) -> str | None:
    if shape_name == "long_500k" and arch not in LONG_OK:
        return ("full-attention arch: 500k decode KV-scan is linear but the "
                "arch has no sub-quadratic path for its 500k context — "
                "skipped per assignment, recorded in EXPERIMENTS.md")
    return None


def position_bytes(tree, specs, mesh) -> int:
    """One position's bytes of ``tree`` laid out by ``specs`` on ``mesh``:
    each leaf's shard (every split even, which the placement checks), its
    elements times their size."""
    return sum(math.prod(NamedSharding(mesh, spec).shard_shape(t.shape))
               * t.element_size() for t, (spec,) in
               zip(tree_leaves(tree),
                   tree_leaves(tree_map(lambda s: (s,), specs))))


def build_cell(arch: str, shape_name: str, mesh, *,
               opt_name: str | None = None, vocab_chunk: int = 16_384,
               overrides=None, microbatches: int = 1):
    """(fn, args, cfg, shape, splan, specs) for one cell: ``fn(*args)`` is
    the cell's step, its arguments meta tensors (the state from
    ``state_shapes``, the batch from ``input_specs``, parameters from
    ``init`` on meta), ``specs`` their layout on ``mesh``."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    bundle = get_bundle(cfg)
    specs = input_specs(cfg, shape)

    if shape.kind == "train":
        splan = make_plan(cfg, mesh)
        opt = make_optimizer(OptimizerConfig(
            name=opt_name or ("adafactor" if arch in ADAFACTOR_ARCHS
                              else "adamw")))
        step = make_train_step(cfg, opt, splan, vocab_chunk=vocab_chunk,
                               microbatches=microbatches)
        state = state_shapes(cfg, opt)
        st_specs = {"params": param_specs(state["params"], mesh),
                    "opt": param_specs(state["opt"], mesh), "step": P()}
        bspecs = {k: batch_specs(splan)[k] for k in specs}
        return step, (state, specs), cfg, shape, splan, (st_specs, bspecs)

    splan = make_plan(cfg, mesh, decode_batch=(
        shape.global_batch if shape.kind == "decode" else None))
    params = bundle.init(cfg, torch.Generator(), dtype=torch.bfloat16,
                         device="meta")
    p_specs = param_specs(params, mesh)

    if shape.kind == "prefill":
        def fn(params, batch):
            return bundle.prefill(cfg, params, batch, splan)
        bspecs = {k: batch_specs(splan)[k] for k in specs}
        return fn, (params, specs), cfg, shape, splan, (p_specs, bspecs)

    # decode
    def fn(params, caches, token):
        return bundle.decode(cfg, params, caches, token, splan)
    c_specs = cache_specs(specs["caches"], splan)
    n_data = splan.block_counts()[0]
    tok_spec = (P(None, None) if shape.global_batch < n_data
                else batch_specs(splan)["tokens"])
    return (fn, (params, specs["caches"], specs["token"]), cfg, shape,
            splan, (p_specs, c_specs, tok_spec))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             opt_name=None, vocab_chunk=16_384, overrides=None,
             microbatches: int = 1) -> dict:
    """Count one cell's step on the production mesh, every position on
    meta; return the reference's dry-run record (module docstring)."""
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "device": "meta"}
    skip = cell_skip_reason(arch, shape_name)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    n_chips = 512 if multi_pod else 256
    try:
        mesh = make_production_mesh(multi_pod, devices=["meta"] * n_chips)
        t0 = time.perf_counter()
        fn, args, cfg, shape, splan, specs = build_cell(
            arch, shape_name, mesh, opt_name=opt_name,
            vocab_chunk=vocab_chunk, overrides=overrides,
            microbatches=microbatches)
        cost = hlo_cost.analyze(fn, *args)
        trace_s = time.perf_counter() - t0

        flops_dev = cost["flops"] / n_chips
        bytes_dev = cost["bytes"] / n_chips
        coll_bytes = cost["collective_bytes"] / n_chips
        arg_pos = sum(position_bytes(a, s, mesh)
                      for a, s in zip(args, specs))
        arg_all = sum(t.numel() * t.element_size()
                      for a in args for t in tree_leaves(a))
        terms = roofline_terms(flops_per_chip=flops_dev,
                               bytes_per_chip=bytes_dev,
                               coll_bytes_per_chip=coll_bytes, peak=H100)
        mflops = model_flops(cfg, shape)
        rec.update({
            "status": "ok",
            "attn_mode": splan.attn_mode,
            "trace_s": round(trace_s, 2),
            "n_chips": n_chips,
            "flops_per_chip": flops_dev,
            "bytes_per_chip": bytes_dev,
            "ops": cost["ops"],
            "collective_bytes_per_chip": coll_bytes,
            "collective_wire_bytes_per_chip":
                cost["collective_wire_bytes"] / n_chips,
            "collective_counts": {k: v / n_chips for k, v in
                                  cost["collective_counts"].items()},
            "collective_bytes_by_kind": {
                k: v / n_chips for k, v in
                cost["collective_bytes_by_kind"].items()},
            "peak_live_bytes": cost["peak_live_bytes"],
            "devices": cost["devices"],
            "ops_off_device": {d: ops for d, ops in
                               cost["ops_by_device"].items()
                               if d != "meta"},
            "memory_analysis": {
                "argument_size_in_bytes": arg_pos,
                "temp_size_in_bytes":
                    max(cost["peak_live_bytes"] - arg_all, 0) / n_chips,
            },
            "model_flops_total": mflops,
            "model_flops_per_chip": mflops / n_chips,
            "useful_flops_ratio": (mflops / n_chips / flops_dev
                                   if flops_dev else 0.0),
            **terms,
            "roofline_fraction": (mflops / n_chips /
                                  H100["peak_flops_bf16"] /
                                  terms["step_s_lower_bound"]
                                  if terms["step_s_lower_bound"] else 0.0),
        })
    except Exception as e:  # noqa: BLE001 (a failure here is a bug in the system)
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--vocab-chunk", type=int, default=16_384)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    out = open(args.out, "a") if args.out else None
    failed = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   opt_name=args.optimizer,
                                   vocab_chunk=args.vocab_chunk)
                    line = json.dumps(rec)
                    print(line[:400] + ("..." if len(line) > 400 else ""),
                          flush=True)
                    if out:
                        out.write(line + "\n")
                        out.flush()
                    if rec["status"] == "failed":
                        failed += 1
                        print(rec.get("traceback", ""), file=sys.stderr)
    finally:
        if out:
            out.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
