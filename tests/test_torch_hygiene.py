"""Import hygiene of the port: ``repro_torch`` and the chip scripts import
neither jax nor the JAX package ``repro`` (``repro_torch`` itself is
allowed), and the query engine imports in a process where jax cannot."""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "chip_ab.py",
                             "chip_tiers_probe.py", "chip_ssd_bf16_probe.py",
                             "chip_wide_probe.py")]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


OBS_FILES = sorted((ROOT / "src" / "repro_torch" / "obs").glob("*.py"))


@pytest.mark.parametrize("path", OBS_FILES,
                         ids=[p.name for p in OBS_FILES])
def test_obs_modules_are_stdlib_only(path):
    """The observability plane imports the standard library and itself."""
    roots = _imported_roots(path) - {"repro_torch"}
    assert roots <= set(sys.stdlib_module_names) | {"__future__"}, roots


DIST_FILES = sorted((ROOT / "src" / "repro_torch" / "dist").glob("*.py")) + [
    ROOT / "src" / "repro_torch" / "launch" / "mesh.py"]


@pytest.mark.parametrize("path", DIST_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in DIST_FILES])
def test_mesh_modules_import_nothing_of_db(path):
    """The mesh's axis mapping sits below the database: ``db`` imports
    ``dist``, never the other way."""
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
        elif isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
    bad = {m for m in mods
           if m.startswith(("repro_torch.db", "repro_torch.serve"))}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_query_engine_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch.db.query, repro_torch.kernels.ops, "
            "repro_torch.db.loader, repro_torch.obs, "
            "repro_torch.db.optimizer, repro_torch.launch.roofline, "
            "repro_torch.core.prng, repro_torch.db.train, "
            "repro_torch.serve.router, repro_torch.dist.sharding, "
            "repro_torch.launch.mesh; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr


def _chip_script(name: str):
    """Import the repo-root chip script ``name`` (it imports no jax)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(name)


def test_chip_smoke_names_every_lm_phase():
    """``--phases lm`` runs the phases chip_smoke.py's ``LM_PHASES`` names
    and ``--phases forest`` none of them.  main() runs the LM phases only
    from ``LM_PHASE_TAGS``, whose names LM_PHASES are: each is a function
    of the script that takes nothing but ``smi`` (every forest phase takes
    the launch counter), and main() names no such function itself, so a
    phase added without the forest's arguments must be in that table.  The
    selector's ``all`` is ``forest`` and ``lm`` together, ``lm`` is
    LM_PHASES, and ``all`` is what the script runs with no argument."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    table = next(ast.literal_eval(n.value) for n in tree.body
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "LM_PHASE_TAGS")
    named = tuple(name for name, _ in table)
    used = {x.id for x in ast.walk(funcs["main"])
            if isinstance(x, ast.Name) and isinstance(x.ctx, ast.Load)}

    def smi_only(name: str) -> bool:
        return (not funcs[name].args.args
                and [a.arg for a in funcs[name].args.kwonlyargs] == ["smi"])

    assert set(named) <= funcs.keys() and all(map(smi_only, named))
    assert len(named) == len(set(named))
    assert "LM_PHASE_TAGS" in used
    assert not {name for name in used & funcs.keys() if smi_only(name)}

    smoke = _chip_script("chip_smoke")
    assert smoke.PHASES["lm"] == smoke.LM_PHASES == named
    assert set(smoke.PHASES) == {"all", "forest", "lm"}
    assert set(smoke.PHASES["all"]) == (set(smoke.PHASES["forest"])
                                        | set(smoke.PHASES["lm"]))
    assert not set(smoke.PHASES["forest"]) & set(smoke.PHASES["lm"])
    assert set(smoke.PHASES["forest"]) <= funcs.keys()
    assert smoke.parse_args([]).phases == "all"
    assert smoke.parse_args(["--phases", "lm"]).phases == "lm"


def test_chip_smoke_refuses_an_unknown_phase_selector():
    """An unknown ``--phases`` value exits non-zero before any phase, on
    a machine with or without a card."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--phases", "kernels"], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert "invalid choice: 'kernels'" in proc.stderr
    assert proc.stdout == ""


CANNED_PART = ("[part] lm-spmd (e): wall 123.300 s, cpu 119.875 s (user "
               "112.500, sys 7.375; cpu / wall 0.972), context switches "
               "voluntary 5123 involuntary 77, load 1.20 1.10 0.90, torch "
               "threads 8, affinity 8, device mallocs +12 frees +10 alloc "
               "retries +0 sync_all_streams +0, empty_cache 0.125 s (4 "
               "calls), gc collections +3/+1/+0 in 0.480 s; probe python "
               "loop 16.674 ms, launch 8.379 us; profiled device time "
               "77.300 ms in 6512.000 ms of profiled wall (2 windows)")


def test_chip_ab_reads_walls_and_part_clocks():
    """``chip_ab.parse`` reads a phase wall line, the halves' and the
    smoke's walls (and no other line with a wall in it), and a part
    clock's wall and CPU time, canned and as chip_smoke.py's own
    ``part_clock`` prints it."""
    ab = _chip_script("chip_ab")
    got = ab.parse("\n".join((
        "[lm-spmd] phase wall 388.125 s; on NVIDIA H100 80GB HBM3, "
        "700.00 W",
        "[lm] phase wall 61.500 s",
        "[smoke] forest phases wall 299.910 s",
        "[smoke] LM phases wall 401.280 s",
        "[smoke] wall 701.185 s",
        "[obs] traced host udf predicated_pallas_fused: wall 0.041 s, "
        "span counts {}",
        CANNED_PART)))
    assert got["wall_s"] == {"lm-spmd phase": 388.125, "lm phase": 61.5,
                             "smoke forest phases": 299.91,
                             "smoke LM phases": 401.28, "smoke": 701.185}
    assert got["part_s"] == {"lm-spmd (e)": 123.3}
    assert got["part_cpu_s"] == {"lm-spmd (e)": 119.875}

    smoke = _chip_script("chip_smoke")
    a = smoke.host_counters()
    sum(range(10 ** 5))
    line = smoke.part_line("lm-train", "e olmo-1b", a, smoke.host_counters())
    got = ab.parse(line)
    assert list(got["part_s"]) == ["lm-train (e olmo-1b)"]
    assert got["part_s"]["lm-train (e olmo-1b)"] >= 0.0
    assert got["part_cpu_s"]["lm-train (e olmo-1b)"] >= 0.0
    assert not got["wall_s"]


def test_chip_ab_forest_only_uses_the_selector(tmp_path):
    """``--forest-only`` runs ``chip_smoke.py --phases forest`` on a side
    whose script takes ``--phases``, and patches the LM phases out of one
    whose script does not."""
    ab = _chip_script("chip_ab")
    assert ab.command(ROOT, True)[1:] == ["chip_smoke.py", "--phases",
                                          "forest"]
    assert ab.command(ROOT, False)[1:] == ["chip_smoke.py"]
    (tmp_path / "chip_smoke.py").write_text("def main():\n    return 0\n")
    cmd = ab.command(tmp_path, True)
    assert cmd[1] == "-c" and "setattr(c, n, lambda **kw: None)" in cmd[2]
    assert "lm_spmd_train_phase" in cmd[2]
