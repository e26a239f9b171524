"""Import hygiene of the port: ``repro_torch`` and the chip scripts import
neither jax nor the JAX package ``repro`` (``repro_torch`` itself is
allowed), and the query engine imports in a process where jax cannot."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "chip_ab.py",
                             "chip_tiers_probe.py", "chip_ssd_bf16_probe.py")]


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
