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

Two programs can be counted.  By default the step is HELD ONCE: one copy
of every value, the mesh's blocks run one after another, and nothing moves
between positions, so the collective keys hold only the EP exchanges and
the cross-pod all-reduce that step records.  With ``own_shards`` (``--own-
shards``) every position owns its shards (``dist/sharding.Sharded``) and
runs its own piece of the step, and every byte that crosses positions
goes through ``dist/collectives``, which records it: the port's
counterpart of the reference's partitioned program, whose collectives
XLA's partitioner inserts.  The collective keys are then the recorded
moves / positions under the reference's operand and ring-wire
conventions (``launch/hlo_cost.CostMode.collective``).  The default stays
held once because the own-shards count's wall grows with positions x
group size: every position runs its own ops, and every fold and
concatenation of a move runs once a position (olmo-1b ``decode_32k`` on
the (16, 16) mesh counts about 1.1M ops; ``docs/torch_dryrun.md``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
  ... add --multi-pod for the (pod=2, data=16, model=16) mesh, --mesh 2x4
  (DxM or PxDxM) for another mesh of meta positions, --own-shards for
  the partitioned program.

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

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config
from repro_torch.dist.sharding import (AXES, Mesh, NamedSharding, P, Sharded,
                                       batch_specs, cache_specs, make_plan,
                                       param_specs, physical, shard_caches,
                                       shard_params)
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import (H100, make_position_mesh,
                                    make_production_mesh)
from repro_torch.launch.roofline import model_flops, roofline_terms
from repro_torch.models.registry import get_bundle, input_specs
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.trainer import (init_state, make_train_step,
                                       place_state, state_shapes)
from repro_torch.train.tree import tree_leaves, tree_map, tree_map_with_path

__all__ = ["LONG_OK", "ADAFACTOR_ARCHS", "cell_skip_reason", "build_cell",
           "position_bytes", "run_cell", "meta_mesh", "main"]

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
    elements times their size.  A ``Sharded`` leaf is held by its own spec
    (``own_spec`` of ``specs``'), so its shard is its piece."""
    total = 0
    for t, (spec,) in zip(tree_leaves(tree),
                          tree_leaves(tree_map(lambda s: (s,), specs))):
        if isinstance(t, Sharded):
            spec, t = t.spec, torch.empty(t.shape, dtype=t.dtype,
                                          device="meta")
        total += math.prod(NamedSharding(mesh, spec).shard_shape(t.shape)) \
            * t.element_size()
    return total


def _held_bytes(tree) -> int:
    """The bytes every position holds of ``tree`` together: a tensor's
    once (held once), a ``Sharded`` leaf's every piece."""
    return sum(sum(p.numel() * p.element_size() for p in t.pieces.values())
               if isinstance(t, Sharded) else t.numel() * t.element_size()
               for t in tree_leaves(tree))


def _inputs(cfg, shape, device, gen: torch.Generator):
    """``input_specs``' tree on ``device``: meta as it is; on a real device
    seeded from ``gen``: token ids uniform over the vocabulary, frames
    normal, the decode caches empty (zeros, index 0)."""
    specs = input_specs(cfg, shape)
    if device.type == "meta":
        return specs

    def one(path, t):
        if path[0] == "caches":
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        if not t.dtype.is_floating_point:
            return torch.randint(0, cfg.vocab_size, t.shape, dtype=t.dtype,
                                 device=device, generator=gen)
        return torch.randn(t.shape, dtype=t.dtype, device=device,
                           generator=gen)

    return tree_map_with_path(one, specs)


def build_cell(arch: str, shape_name, mesh, *,
               opt_name: str | None = None, vocab_chunk: int = 16_384,
               overrides=None, microbatches: int = 1,
               own_shards: bool = False):
    """(fn, args, cfg, shape, splan, specs) for one cell: ``fn(*args)`` is
    the cell's step, ``specs`` its arguments' layout on ``mesh``.
    ``shape_name`` names one of ``SHAPES``, or is a ``ShapeConfig`` of its
    own.  On a mesh of meta positions the arguments are meta tensors (the
    state from ``state_shapes``, the batch from ``input_specs``,
    parameters from ``init`` on meta); on a mesh of positions on a real
    device (the CPU tests, the card) they are made there from seed 0
    (``init_state`` / ``init``, ``_inputs``), the same step on values.
    With ``own_shards`` the plan's positions own their shards: the state,
    the parameters and the caches are ``Sharded`` pieces on their
    positions' devices (``place_state``, ``shard_params``,
    ``shard_caches``), and the batch and the decode token stay whole on
    the controller, which the steps cut themselves."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    bundle = get_bundle(cfg)
    device = physical(mesh.devices.flat[0])
    gen = torch.Generator(device=device if device.type == "cuda"
                          else "cpu").manual_seed(0)
    specs = _inputs(cfg, shape, device, gen)

    if shape.kind == "train":
        splan = make_plan(cfg, mesh, own_shards=own_shards)
        opt = make_optimizer(OptimizerConfig(
            name=opt_name or ("adafactor" if arch in ADAFACTOR_ARCHS
                              else "adamw")))
        step = make_train_step(cfg, opt, splan, vocab_chunk=vocab_chunk,
                               microbatches=microbatches)
        state = (state_shapes(cfg, opt) if device.type == "meta" else
                 init_state(cfg, opt, gen, device=device))
        st_specs = {"params": param_specs(state["params"], mesh),
                    "opt": param_specs(state["opt"], mesh), "step": P()}
        if own_shards:
            state = place_state(state, mesh, own_shards=True)
        bspecs = {k: batch_specs(splan)[k] for k in specs}
        return step, (state, specs), cfg, shape, splan, (st_specs, bspecs)

    splan = make_plan(cfg, mesh, decode_batch=(
        shape.global_batch if shape.kind == "decode" else None),
        own_shards=own_shards)
    params = bundle.init(cfg, gen, dtype=torch.bfloat16, device=device)
    p_specs = param_specs(params, mesh)
    if own_shards:
        params = shard_params(params, splan)

    if shape.kind == "prefill":
        def fn(params, batch):
            return bundle.prefill(cfg, params, batch, splan)
        bspecs = {k: batch_specs(splan)[k] for k in specs}
        return fn, (params, specs), cfg, shape, splan, (p_specs, bspecs)

    # decode
    def fn(params, caches, token):
        return bundle.decode(cfg, params, caches, token, splan)
    caches = specs["caches"]
    c_specs = cache_specs(caches, splan)
    if own_shards:
        caches = shard_caches(caches, splan)
    n_data = splan.block_counts()[0]
    tok_spec = (P(None, None) if shape.global_batch < n_data
                else batch_specs(splan)["tokens"])
    return (fn, (params, caches, specs["token"]), cfg, shape,
            splan, (p_specs, c_specs, tok_spec))


def run_cell(arch: str, shape_name, *, multi_pod: bool = False,
             opt_name=None, vocab_chunk=16_384, overrides=None,
             microbatches: int = 1, own_shards: bool = False,
             mesh=None) -> dict:
    """Count one cell's step on the production mesh (or ``mesh``, a mesh
    of meta positions), every position on meta; return the reference's
    dry-run record (module docstring).  ``shape_name`` as ``build_cell``
    takes it; ``own_shards``: count the step over positions that own
    their shards (``build_cell``)."""
    rec: dict = {"arch": arch, "shape": getattr(shape_name, "name",
                                               shape_name),
                 "mesh": ("2x16x16" if multi_pod else "16x16")
                 if mesh is None else
                 "x".join(str(n) for n in mesh.devices.shape),
                 "device": "meta", "own_shards": bool(own_shards)}
    skip = cell_skip_reason(arch, rec["shape"])
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    try:
        if mesh is None:
            mesh = make_production_mesh(
                multi_pod, devices=["meta"] * (512 if multi_pod else 256))
        n_chips = mesh.size
        t0 = time.perf_counter()
        fn, args, cfg, shape, splan, specs = build_cell(
            arch, shape_name, mesh, opt_name=opt_name,
            vocab_chunk=vocab_chunk, overrides=overrides,
            microbatches=microbatches, own_shards=own_shards)
        cost = hlo_cost.analyze(fn, *args)
        trace_s = time.perf_counter() - t0

        flops_dev = cost["flops"] / n_chips
        bytes_dev = cost["bytes"] / n_chips
        coll_bytes = cost["collective_bytes"] / n_chips
        arg_pos = sum(position_bytes(a, s, mesh)
                      for a, s in zip(args, specs))
        arg_all = sum(_held_bytes(a) for a in args)
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


def meta_mesh(text: str) -> Mesh:
    """``--mesh``: ``DxM`` a (data, model) mesh, ``PxDxM`` a (pod, data,
    model) one, every position on meta."""
    sizes = [int(n) for n in text.lower().split("x")]
    if len(sizes) not in (2, 3) or min(sizes) < 1:
        raise ValueError(f"--mesh takes DxM or PxDxM, got {text!r}")
    return make_position_mesh(tuple(zip(AXES[3 - len(sizes):], sizes)),
                              "meta")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="DxM or PxDxM meta positions in place of the "
                         "production mesh(es)")
    ap.add_argument("--own-shards", action="store_true",
                    help="count the step over positions that own their "
                         "shards (the partitioned program's collectives)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--vocab-chunk", type=int, default=16_384)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ([(False, meta_mesh(args.mesh))] if args.mesh else
              [(False, None), (True, None)] if args.both_meshes else
              [(args.multi_pod, None)])

    out = open(args.out, "a") if args.out else None
    failed = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mp, mesh in meshes:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   opt_name=args.optimizer,
                                   vocab_chunk=args.vocab_chunk,
                                   own_shards=args.own_shards, mesh=mesh)
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
