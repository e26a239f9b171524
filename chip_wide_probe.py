"""Probe the wide-tiled layout of the fused predicated and HummingBird
kernels and of raw HummingBird on one NVIDIA GPU: tree tiles and the
layout of x.

    python3 chip_wide_probe.py

At 100,352 rows x 2,000 features (chip_smoke.py's Epsilon shape) and at
Bosch's 968 and Criteo's 10,000 features, over a seeded depth-8 forest
of 500 trees (raw HummingBird: its first 16, a rel plan's partition), it
times with CUDA events (one warm-up, then the mean of five launches):

  * the feature-major transpose (``forest_transpose_rows``) alone;
  * each kernel through its launch wrapper, the port's path: the
    transpose, then the wide-tiled kernel over feature-major x;
  * the same kernel built from the same sources with its two x lines
    edited to read row-major x (``ROW_MAJOR_EDITS``: the lane's row and a
    feature stride of 1), called through ctypes on row-major x with no
    transpose, at the same tiles;
  * the fused predicated kernel at other tree tiles, f32 and bf16.

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
    ("const long long ldx = wide_ldx(B);", "const long long ldx = 1;"),
    ("const float* xb = x + b0 + lane;",
     "const float* xb = x + (b0 + lane < B ? b0 + lane : B - 1) * F;"),
)


def build_row_major(_build) -> dict:
    """The predicated and HummingBird libraries built with
    ``ROW_MAJOR_EDITS`` applied to their wide-tiled kernels, into
    ``build/probe_row_major/``: name -> CDLL, entry points bound as
    ``_build`` binds them."""
    out = _build.BUILD_DIR.parent / "probe_row_major"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    procs = {}
    for name in ("forest_predicated", "forest_hummingbird"):
        src = _build.KERNEL_SOURCES[name][0]
        text = (_build.CSRC / src).read_text()
        for a, b in ROW_MAJOR_EDITS:
            if text.count(a) != 1:
                raise RuntimeError(f"{src}: {a!r} is not one line of the "
                                   f"wide-tiled kernel")
            text = text.replace(a, b)
        (out / src).write_text(text)
        so = out / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(out / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"row-major {name}: nvcc exit "
                               f"{proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn_name, argtypes in _build.KERNEL_SOURCES[name][1]:
            getattr(lib, fn_name).argtypes = argtypes
            getattr(lib, fn_name).restype = ctypes.c_int
        libs[name] = lib
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
    from repro_torch.kernels.ops import prepare_inputs

    smi = cs.nvidia_smi_line()
    build_s = _build.build_all()
    row_major = build_row_major(_build)
    print(f"[probe] build {build_s:.3f} s (+ the row-major build); on {smi}",
          flush=True)
    failed = []

    def same(got, want, what):
        err = float((got - want).abs().max())
        ok = torch.equal(cs.bits(got), cs.bits(want))
        if not ok:
            failed.append(what)
        print(f"[probe] check {what}: max_abs_err {err!r} "
              f"{'ok' if ok else 'FAIL'}", flush=True)

    def row_major_call(kind, fused, args, tiles):
        """The row-major build's entry point over row-major x -> its out."""
        x, T = args[0], args[1].shape[0]
        narrow = args[1].dim() == 2
        name = (f"forest_{kind}_{'fused' if fused else 'raw'}"
                f"{'_bf16' if narrow else ''}")
        fn = getattr(row_major[f"forest_{kind}"], name)
        out = torch.empty((x.shape[0],) if fused else (x.shape[0], T),
                          device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            err = fn(*(a.data_ptr() for a in args), out.data_ptr(),
                     x.shape[0], x.shape[1], T, tiles["depth"],
                     tiles["block_b"], tiles["block_t"], 0, stream)
            if err:
                raise RuntimeError(f"row-major {name}: CUDA error {err}")
            return out
        return call

    runs = (("predicated", True, predicated_fused, predicated_fused_plain),
            ("hummingbird", True, hummingbird_fused,
             hummingbird_fused_plain),
            ("hummingbird", False, hummingbird_raw, hummingbird_raw_plain))
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
                    call = row_major_call(kind, fused, args, kw)
                    same(call(), want, f"{tag} row-major ({bb}, {bt})")
                    rm = cs.cuda_ms(call, warmup=1, reps=5)
                    mark = "; the tiling's" if (bb, bt) == tile_list[0] else ""
                    print(f"[probe] {tag} ({bb} threads, {bt}-tree tiles"
                          f"{mark}): feature-major {fm:.4f} ms (transpose "
                          f"included), row-major {rm:.4f} ms, row-major / "
                          f"feature-major {rm / fm:.4f}; bound {b:.4f} ms "
                          f"by {by}; {rows} x {F} x {T}; on {smi}",
                          flush=True)
                del args, want
        del x, f
        torch.cuda.empty_cache()
    print(f"[probe] failed: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
