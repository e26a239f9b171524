"""Time two checkouts of the port on one card, in turns.

    python3 chip_ab.py PARENT_DIR [--out DIR]

Runs ``python3 chip_smoke.py`` from PARENT_DIR (the root of another
checkout, for example a parent commit unpacked there with ``git archive``)
and from this checkout, in the order parent, change, change, parent, on
this machine's card.  Each run's whole output goes to
``DIR/<n>-<side>.log`` (default ``chiprun_out/ab``).  The script prints
each run's kernel times (from the ``{"kernels": ...}`` line chip_smoke.py
prints), its rel+reuse query times (each algorithm's runs, over each
table it ran on), its ``infer_rows`` repeats, its ``[tiers]`` runs
(wall time and rows/s of each host- and disk-tier query, and each overlap
fraction), its ``[sparse]`` runs (each x-mode kernel time, and the wall
time and rows/s of each Epsilon, Bosch and Criteo-shaped query), its bf16
tree-tile timings (each fused kernel f32 and bf16 at the HIGGS and Epsilon
shapes) and its ``[load]`` runs (each loader's LoadTiming total, each
external / in-database ratio and its two sides), its ``[obs]``
overhead lines (untraced and traced medians, their ratio), its walls
(``[smoke] wall``, each half's and every ``phase wall`` line) and its
``[part]`` lines (each LM and dry-run part's host wall and CPU time),
then each side's mean per kernel, per run, per phase and per part, and
the change / parent ratio; a side whose script has no such line (a
parent without phase 8b, 9, 10, the bf16 tiles or the part clocks) shows
"n/a".  Any run that fails makes the script exit non-zero.

    python3 chip_ab.py PARENT_DIR --forest-only

runs the forest phases alone (about half a whole run), for changes the
LM and dry-run phases (15-21 and 19 (d)) do not reach: ``chip_smoke.py
--phases forest`` on a side whose script takes ``--phases``; on a side
whose script does not, its ``chip_smoke.main()`` with the phases its
``LM_PHASES`` names replaced by no-ops.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ORDER = ("parent", "change", "change", "parent")
REL_RUN = re.compile(r"\[rel\] infer\(plan='rel\+reuse', algorithm="
                        r"'(\w+)'\) (run \d+) over (\d+) rows .* total "
                        r"([0-9.]+) s")
ROWS = re.compile(r"\[rows\] infer_rows\((\d+) rows.*plan='([^']+)'.*repeat "
                  r"([0-9.]+) s")
TIER_RUN = re.compile(r"\[tiers\] run (.+?): wall_s ([0-9.]+), ([0-9.]+) "
                      r"rows/s")
OVERLAP = re.compile(r"\[tiers\] overlap_fraction (\w+ \w+): (-?[0-9.]+)")
SPARSE_RUN = re.compile(r"\[sparse\] run (.+?): wall_s ([0-9.]+), ([0-9.]+) "
                        r"rows/s")
XMODE = re.compile(r"\[sparse\] xmode (\w+ \w+ F=\d+): staged "
                   r"(does not fit|[0-9.]+ ms), wide ([0-9.]+) ms")
BF16 = re.compile(r"\[timing\] (\w+) bf16 at (\w+) .*?: f32 ([0-9.]+) ms .*?"
                  r"bf16 ([0-9.]+) ms")
LOAD_TIMING = re.compile(r"\[load\] (.+?) LoadTiming parse_s ([0-9.]+), "
                         r"convert_s [0-9.]+, transfer_s [0-9.]+, total_s "
                         r"([0-9.]+)")
OBS = re.compile(r"\[obs\] overhead (.+?): untraced ([0-9.]+) s, traced "
                 r"([0-9.]+) s .*traced / untraced ([0-9.]+)")
LOAD_RATIO = re.compile(r"\[load\] ratio (.+?): external ([0-9.]+) s .* / "
                        r"in-database ([0-9.]+) s .*?= ([0-9.]+)")
#: the wall lines: ``[smoke] wall``, ``[smoke] forest phases wall``,
#: ``[lm] phase wall``, ``[dryrun] (d) part wall``, ``[lm-spmd] (a) wall``
WALL = re.compile(r"^\[([\w-]+)\] ((?:\(\w+\) )?(?:(?:forest|LM) phases |"
                  r"phase |part )?)wall ([0-9.]+) s")
PART = re.compile(r"^\[part\] (\S+ \(.+?\)): wall ([0-9.]+) s, cpu "
                  r"([0-9.]+) s")


#: run a side's chip_smoke.main() with the phases its ``LM_PHASES``
#: names (or, for a script that names none, ``{names}``: this side's)
#: replaced by no-ops; a name the script does not define fails the run.
#: Only a chip_smoke.py without ``--phases`` needs it: it goes, with the
#: text search in command(), once no parent run here lacks the selector
FOREST_ONLY = ("import sys, chip_smoke as c\n"
               "names = getattr(c, 'LM_PHASES', {names!r})\n"
               "missing = [n for n in names if not hasattr(c, n)]\n"
               "if missing:\n"
               "    sys.exit(f'chip_smoke.py has no phase {{missing}}')\n"
               "for n in names:\n"
               "    setattr(c, n, lambda **kw: None)\n"
               "sys.exit(c.main())\n")


def command(root: Path, forest_only: bool) -> list[str]:
    """How to run ``root``'s chip_smoke.py: whole, or its forest phases
    through ``--phases forest`` where the script takes it, else with its
    LM phases patched out (FOREST_ONLY)."""
    if not forest_only:
        return [sys.executable, "chip_smoke.py"]
    if "--phases" in (root / "chip_smoke.py").read_text():
        return [sys.executable, "chip_smoke.py", "--phases", "forest"]
    from chip_smoke import LM_PHASES
    return [sys.executable, "-c", FOREST_ONLY.format(names=LM_PHASES)]


def run(root: Path, log: Path, forest_only: bool = False) -> dict:
    proc = subprocess.run(command(root, forest_only), cwd=root,
                          capture_output=True, text=True, timeout=1500)
    log.write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}/chip_smoke.py exit {proc.returncode}; "
                           f"see {log}")
    return parse(proc.stdout)


def parse(stdout: str) -> dict:
    """What one chip_smoke.py run printed, by kind (see the docstring)."""
    out = {"kernels": None, "rel_s": {}, "rows": {}, "tier_s": {},
           "tier_rows_s": {}, "overlap": {}, "sparse_s": {},
           "sparse_rows_s": {}, "xmode": {}, "bf16": {}, "load_s": {},
           "load_ratio": {}, "obs_s": {}, "obs_ratio": {}, "wall_s": {},
           "part_s": {}, "part_cpu_s": {}}
    for line in stdout.splitlines():
        if line.startswith('{"kernels"'):
            out["kernels"] = {k["name"]: k["ms"]
                              for k in json.loads(line)["kernels"]}
        elif (m := REL_RUN.search(line)):
            algorithm, run_, rows, total = m.groups()
            out["rel_s"][f"{algorithm} {rows} rows {run_}"] = float(total)
        elif (m := ROWS.search(line)):
            out["rows"][f"{m.group(2)} {m.group(1)}"] = float(m.group(3))
        elif (m := TIER_RUN.search(line)):
            out["tier_s"][m.group(1)] = float(m.group(2))
            out["tier_rows_s"][m.group(1)] = float(m.group(3))
        elif (m := OVERLAP.search(line)):
            out["overlap"][m.group(1)] = float(m.group(2))
        elif (m := SPARSE_RUN.search(line)):
            out["sparse_s"][m.group(1)] = float(m.group(2))
            out["sparse_rows_s"][m.group(1)] = float(m.group(3))
        elif (m := XMODE.search(line)):
            name, staged, wide = m.groups()
            if staged != "does not fit":
                out["xmode"][f"{name} staged"] = float(staged.split()[0])
            out["xmode"][f"{name} wide"] = float(wide)
        elif (m := BF16.search(line)):
            kind, where, f32, bf16 = m.groups()
            out["bf16"][f"{kind} {where} f32"] = float(f32)
            out["bf16"][f"{kind} {where} bf16"] = float(bf16)
        elif (m := LOAD_TIMING.search(line)):
            out["load_s"][f"{m.group(1)} parse"] = float(m.group(2))
            out["load_s"][f"{m.group(1)} total"] = float(m.group(3))
        elif (m := LOAD_RATIO.search(line)):
            name, ext, indb, ratio = m.groups()
            out["load_s"][f"{name} external"] = float(ext)
            out["load_s"][f"{name} in-database"] = float(indb)
            out["load_ratio"][name] = float(ratio)
        elif (m := OBS.search(line)):
            what, off, on, ratio = m.groups()
            out["obs_s"][f"{what} untraced"] = float(off)
            out["obs_s"][f"{what} traced"] = float(on)
            out["obs_ratio"][what] = float(ratio)
        elif (m := PART.match(line)):
            out["part_s"][m.group(1)] = float(m.group(2))
            out["part_cpu_s"][m.group(1)] = float(m.group(3))
        elif (m := WALL.match(line)):
            out["wall_s"][f"{m.group(1)} {m.group(2)}".strip()] = float(
                m.group(3))
        elif line.startswith("[report]"):
            out["report"] = line
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/ab"))
    ap.add_argument("--forest-only", action="store_true",
                    help="skip chip_smoke.py's LM and dry-run phases")
    args = ap.parse_args()
    here = Path(__file__).resolve().parent
    args.out.mkdir(parents=True, exist_ok=True)
    runs = []
    for n, side in enumerate(ORDER):
        root = args.parent.resolve() if side == "parent" else here
        res = run(root, args.out / f"{n}-{side}.log", args.forest_only)
        runs.append((side, res))
        print(f"[ab] run {n} {side}: {res.get('report')}", flush=True)
        print(f"[ab] run {n} {side}: kernels ms {json.dumps(res['kernels'])}"
              f"; rel+reuse s {json.dumps(res['rel_s'])}; "
              f"infer_rows repeat s {json.dumps(res['rows'])}; tiers wall s "
              f"{json.dumps(res['tier_s'])}, rows/s "
              f"{json.dumps(res['tier_rows_s'])}, overlap_fraction "
              f"{json.dumps(res['overlap'])}; sparse wall s "
              f"{json.dumps(res['sparse_s'])}, x-mode ms "
              f"{json.dumps(res['xmode'])}; bf16 tiles ms "
              f"{json.dumps(res['bf16'])}; load s "
              f"{json.dumps(res['load_s'])}, ratios "
              f"{json.dumps(res['load_ratio'])}; obs s "
              f"{json.dumps(res['obs_s'])}, traced/untraced "
              f"{json.dumps(res['obs_ratio'])}; walls s "
              f"{json.dumps(res['wall_s'])}; parts wall s "
              f"{json.dumps(res['part_s'])}, cpu s "
              f"{json.dumps(res['part_cpu_s'])}", flush=True)
    for what, unit, prefix in (("kernels", "ms", ""),
                               ("rel_s", "s", "rel+reuse "),
                               ("tier_s", "s", "tiers wall "),
                               ("tier_rows_s", "rows/s", "tiers "),
                               ("overlap", "", "overlap_fraction "),
                               ("xmode", "ms", "xmode "),
                               ("sparse_s", "s", "sparse wall "),
                               ("sparse_rows_s", "rows/s", "sparse "),
                               ("bf16", "ms", "bf16 tiles "),
                               ("load_s", "s", "load "),
                               ("load_ratio", "", "load ratio "),
                               ("obs_s", "s", "obs "),
                               ("obs_ratio", "", "obs traced/untraced "),
                               ("wall_s", "s", "wall "),
                               ("part_s", "s", "part wall "),
                               ("part_cpu_s", "s", "part cpu ")):
        names = {n: None for _, r in runs for n in r[what]}
        for name in names:
            side_t = {s: [r[what].get(name, "n/a") for side, r in runs
                          if side == s] for s in ("parent", "change")}
            if "n/a" in side_t["parent"] + side_t["change"]:
                print(f"[ab] {prefix}{name}: parent {side_t['parent']} "
                      f"{unit}, change {side_t['change']} {unit}",
                      flush=True)
                continue
            p = sum(side_t["parent"]) / 2
            c = sum(side_t["change"]) / 2
            ratio = f"{c / p:.4f}" if p else "n/a"
            print(f"[ab] {prefix}{name}: parent {side_t['parent']} {unit}, "
                  f"change {side_t['change']} {unit}, change/parent {ratio}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
