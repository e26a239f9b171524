"""Probe the wide-tiled layout of the fused predicated, HummingBird and
QuickScorer kernels and of raw HummingBird and QuickScorer on one NVIDIA
GPU: tree tiles and the layout of x.

    python3 chip_wide_probe.py

At 100,352 rows x 2,000 features (chip_smoke.py's Epsilon shape) and at
Bosch's 968 and Criteo's 10,000 features, over a seeded depth-8 forest
of 500 trees (the raw kernels: its first 16, a rel plan's partition), it
times with CUDA events (one warm-up, then the mean of five launches):

  * the feature-major transpose (``forest_transpose_rows``) alone;
  * each kernel through its launch wrapper, the port's path: the
    transpose, then the wide-tiled kernel over feature-major x;
  * the same kernel built from the same sources with its two x lines
    edited to read row-major x (``ROW_MAJOR_EDITS``: the lane's row and a
    feature stride of 1), called through ctypes on row-major x with no
    transpose, at the same tiles;
  * the fused predicated kernel at other tree tiles, f32 and bf16;
  * each wide-tiled kernel alone on one feature-major x beside builds of
    it edited as ``VARIANT_EDITS`` says (every kernel: the 64 x 64-bit
    offset product in place of ``col_at``'s 32 x 32 -> 64-bit one;
    QuickScorer: two trees a warp at once), in turns.

Every launch is held bit for bit against its plain version.  Each line
carries the card's name and power limit.  It imports nothing of the JAX
package.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ROWS, TREES = 100_352, 500
WIDTHS = ((2000, ROWS), (968, ROWS), (10_000, 65_536))
PRED_TILES = ((256, 8), (256, 16), (256, 32))
PRED_BF16_TILES = ((256, 16), (256, 32), (256, 64))
#: the wide-tiled kernels' two x lines, and what the row-major build reads
ROW_MAJOR_EDITS = (
    ("const unsigned ldx = unsigned(wide_ldx(B));",
     "const unsigned ldx = 1;"),
    ("const float* xb = x + b0 + lane;",
     "const float* xb = x + (b0 + lane < B ? b0 + lane : B - 1) * F;"),
)
#: the wide-tiled QuickScorer walk: a warp's loop over its trees of a tile
QS_WALK = """\
        for (int t = warp; t < bt; t += nw) {
          const Node* tree = nd + t * L;
          int leaf[1];
          qs_exit_leaves<DEPTH, 1>(
              [&](int slot, bool (&right)[1]) {
                const Node n = tree[slot];
                right[0] = goes_right(col_at(xb, n, ldx),
                                      node_threshold(n),
                                      node_default_right(n));
              },
              leaf);
          out_row[t] = leaf_f32(lv[t * L + leaf[0]]);
        }"""
#: ... walking two trees of the tile at once, w and w + W (W warps)
QS_TWO_TREES = """\
        for (int g = warp; g < bt; g += 2 * nw) {
          int t[2], leaf[2];
          const Node* tree[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            t[c] = g + c * nw;
            tree[c] = nd + min(t[c], bt - 1) * L;
          }
          qs_exit_leaves<DEPTH, 2>(
              [&](int slot, bool (&right)[2]) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const Node n = tree[c][slot];
                  right[c] = goes_right(col_at(xb, n, ldx),
                                        node_threshold(n),
                                        node_default_right(n));
                }
              },
              leaf);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (t[c] < bt) out_row[t[c]] = leaf_f32(lv[t[c] * L + leaf[c]]);
          }
        }"""
#: a node's feature of the lane's row at a 64-bit ldx, a 64 x 64-bit
#: offset product
COL_AT64 = """namespace forest {
__device__ inline float col_at64(const float* __restrict__ col, int2 n,
                                 long long ldx) {
  return __ldg(col + node_feature(n) * ldx);
}
__device__ inline float col_at64(const float* __restrict__ col, uint32_t n,
                                 long long ldx) {
  return __ldg(col + (long long)((n & 0xFFFEu) >> 1) * ldx);
}"""
#: ... read in place of ``col_at``, ldx held in 64 bits
LDX64_EDITS = (
    ("namespace forest {", COL_AT64),
    ("const unsigned ldx = unsigned(wide_ldx(B));",
     "const long long ldx = wide_ldx(B);"),
    ("col_at(xb, n, ldx)", "col_at64(xb, n, ldx)"),
)
#: the wide-tiled kernels' variants, timed beside the port's kernel, by
#: library: the 64-bit offset product (every kernel) and two trees a warp
#: at once (QuickScorer)
LIBRARIES = ("forest_predicated", "forest_hummingbird", "forest_quickscorer")
VARIANT_EDITS = {
    "ldx64": {name: LDX64_EDITS for name in LIBRARIES},
    "two_trees": {"forest_quickscorer": ((QS_WALK, QS_TWO_TREES),)},
}


def build_edited(_build, jobs) -> dict:
    """Each job (tag, library, edits) built from the library's source with
    every (old, new) of ``edits`` applied -- each old text once in the
    source -- into ``build/probe_<tag>/``, one nvcc a job, all at once:
    (tag, library) -> CDLL, entry points bound as ``_build`` binds
    them."""
    procs = {}
    for tag, name, edits in jobs:
        out = _build.BUILD_DIR.parent / f"probe_{tag}_{name}"
        out.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, out / header.name)
        src = _build.KERNEL_SOURCES[name][0]
        text = (_build.CSRC / src).read_text()
        for a, b in edits:
            if text.count(a) != 1:
                raise RuntimeError(f"{src}: {a[:60]!r} is not once in the "
                                   f"wide-tiled kernel")
            text = text.replace(a, b)
        (out / src).write_text(text)
        so = out / f"lib{name}.so"
        procs[tag, name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(out / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (tag, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag} {name}: nvcc exit "
                               f"{proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn_name, argtypes in _build.KERNEL_SOURCES[name][1]:
            getattr(lib, fn_name).argtypes = argtypes
            getattr(lib, fn_name).restype = ctypes.c_int
        libs[tag, name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_wide_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.forest import make_forest, tree_slice
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import feature_major
    from repro_torch.kernels.forest_hummingbird import (
        hummingbird_fused, hummingbird_fused_plain, hummingbird_raw,
        hummingbird_raw_plain)
    from repro_torch.kernels.forest_predicated import (predicated_fused,
                                                       predicated_fused_plain)
    from repro_torch.kernels.forest_quickscorer import (
        quickscorer_fused, quickscorer_fused_plain, quickscorer_raw,
        quickscorer_raw_plain)
    from repro_torch.kernels.ops import prepare_inputs

    smi = cs.nvidia_smi_line()
    build_s = _build.build_all()
    edited = build_edited(
        _build, [("row_major", name, ROW_MAJOR_EDITS)
                 for name in _build.KERNEL_SOURCES]
        + [(v, name, edits) for v, per in VARIANT_EDITS.items()
           for name, edits in per.items()])
    print(f"[probe] build {build_s:.3f} s (+ the edited builds); on {smi}",
          flush=True)
    failed = []

    def same(got, want, what):
        err = float((got - want).abs().max())
        ok = torch.equal(cs.bits(got), cs.bits(want))
        if not ok:
            failed.append(what)
        print(f"[probe] check {what}: max_abs_err {err!r} "
              f"{'ok' if ok else 'FAIL'}", flush=True)

    def entry_call(lib, kind, fused, args, tiles, x, B, F):
        """A library's wide-row entry point called through ctypes on x
        (row-major [B, F], or feature-major for the port's layout) -> a
        function returning its out.  QuickScorer's takes no bit-vectors
        (it derives them)."""
        T = args[1].shape[0]
        if kind == "quickscorer":
            args = args[:3]
        narrow = args[1].dim() == 2
        name = (f"forest_{kind}_{'fused' if fused else 'raw'}"
                f"{'_bf16' if narrow else ''}")
        fn = getattr(lib, name)
        out = torch.empty((B,) if fused else (B, T), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            err = fn(x.data_ptr(), *(a.data_ptr() for a in args[1:]),
                     out.data_ptr(), B, F, T, tiles["depth"],
                     tiles["block_b"], tiles["block_t"], 0, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return out
        return call

    def walk_variants(kind, args, tiles, fused, want, tag, x):
        """The kernel alone against each of its ``VARIANT_EDITS`` builds,
        on one feature-major x, in turns (the port's, the variants,
        twice), each launch bit for bit."""
        xt = feature_major(x)
        B, F = x.shape
        name = f"forest_{kind}"
        libs = {"port": _build.load(name),
                **{v: edited[v, name] for v, per in VARIANT_EDITS.items()
                   if name in per}}
        calls = {v: entry_call(lib, kind, fused, args, tiles, xt, B, F)
                 for v, lib in libs.items()}
        ms = {v: [] for v in calls}
        for v, call in calls.items():
            same(call(), want, f"{tag} walk {v}")
        for _ in range(2):
            for v, call in calls.items():
                ms[v].append(cs.cuda_ms(call, warmup=1, reps=5))
        print(f"[probe] {tag} walk, kernel alone on feature-major x, ms "
              f"(two turns): " + ", ".join(
                  f"{v} {a:.4f} / {b:.4f}" for v, (a, b) in ms.items())
              + f"; on {smi}", flush=True)

    runs = (("predicated", True, predicated_fused, predicated_fused_plain),
            ("hummingbird", True, hummingbird_fused,
             hummingbird_fused_plain),
            ("hummingbird", False, hummingbird_raw, hummingbird_raw_plain),
            ("quickscorer", True, quickscorer_fused,
             quickscorer_fused_plain),
            ("quickscorer", False, quickscorer_raw, quickscorer_raw_plain))
    for F, rows in WIDTHS:
        x = cs.card_rows(rows, F, seed=cs.SEED + 30)
        fe, th, dl, lv = cs.make_forest_arrays(
            np.random.default_rng(cs.SEED + 31), integer_leaves=False,
            trees=TREES, depth=cs.DEPTH, features=F)
        f = make_forest(fe, th, lv, default_left=dl, n_features=F,
                        device="cuda")
        t_ms = cs.cuda_ms(lambda: feature_major(x), warmup=1, reps=5)
        print(f"[probe] transpose {rows} x {F}: {t_ms:.4f} ms "
              f"({2 * 4 * rows * F / t_ms / 1e6:.1f} GB/s read + write); on "
              f"{smi}", flush=True)
        for kind, fused, wrapper, plain in runs:
            forest_ = f if fused else tree_slice(f, 0, 16)
            for tree_dtype in ((None, torch.bfloat16) if fused else (None,)):
                tag = (f"{kind} {'fused' if fused else 'raw'} "
                       f"{'bf16' if tree_dtype else 'f32'} F={F}")
                args, tiles = prepare_inputs(kind, forest_, x, fused=fused,
                                             staged=False,
                                             tree_dtype=tree_dtype)
                want = cs.plain_rows(plain, args, cs.DEPTH, 16_384)
                T = args[1].shape[0]
                b, by, _ = cs.bound(kind, rows, F, T, raw=not fused,
                                    record=4 if tree_dtype else 8)
                tile_list = [(tiles["block_b"], tiles["block_t"])]
                if kind == "predicated":
                    tile_list += [t for t in (PRED_BF16_TILES if tree_dtype
                                              else PRED_TILES)
                                  if t not in tile_list and F == 2000]
                for bb, bt in tile_list:
                    kw = dict(tiles, block_b=bb, block_t=bt)
                    same(wrapper(*args, **kw), want,
                         f"{tag} feature-major ({bb}, {bt})")
                    fm = cs.cuda_ms(lambda: wrapper(*args, **kw), warmup=1,
                                    reps=5)
                    call = entry_call(edited["row_major", f"forest_{kind}"],
                                      kind, fused, args, kw, x, rows, F)
                    same(call(), want, f"{tag} row-major ({bb}, {bt})")
                    rm = cs.cuda_ms(call, warmup=1, reps=5)
                    mark = "; the tiling's" if (bb, bt) == tile_list[0] else ""
                    print(f"[probe] {tag} ({bb} threads, {bt}-tree tiles"
                          f"{mark}): feature-major {fm:.4f} ms (transpose "
                          f"included), row-major {rm:.4f} ms, row-major / "
                          f"feature-major {rm / fm:.4f}; bound {b:.4f} ms "
                          f"by {by}; {rows} x {F} x {T}; on {smi}",
                          flush=True)
                walk_variants(kind, args, tiles, fused, want, tag, x)
                del args, want
        del x, f
        torch.cuda.empty_cache()
    print(f"[probe] failed: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
