"""The port and chip_smoke.py import neither JAX nor the JAX package."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "pdb2reaction_tpu_torch"

_SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "pdb2reaction_tpu"):
    sys.modules[name] = None          # any import of these now fails
import pdb2reaction_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [k for k, v in sys.modules.items() if v is not None
       and (k.split(".")[0] in ("jax", "jaxlib", "pdb2reaction_tpu"))]
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20      # every module was imported


def test_port_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|pdb2reaction_tpu)\b"
                     r"(?!_torch)", re.M)
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    """No card here: chip_smoke exits non-zero and prints no result; alone
    in a directory it cannot find the package and fails the same way."""
    import torch
    if torch.cuda.is_available():
        return
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


def test_workflow_modules_import_without_jax():
    """The engine, alignment, potential and path modules are among the
    modules the isolation check imports."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = _SCRIPT.replace("print(len(names))", "print(' '.join(names))")
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    for mod in ("engines.gsm", "bio.align", "mlip.potentials",
                "workflows.path_opt", "workflows.common", "cli"):
        assert f"pdb2reaction_tpu_torch.{mod}" in names, mod


_BLOCKED = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "pdb2reaction_tpu", "yaml", "matplotlib",
             "click"):
    sys.modules[name] = None          # any import of these now fails
import pdb2reaction_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for n in names:
    importlib.import_module(n)
print(" ".join(names))
"""


def test_path_search_modules_import_without_yaml_matplotlib_click():
    """The card's installation has no matplotlib (and need not have
    PyYAML or click): every module of the port imports with those three
    blocked as well as JAX."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    for mod in ("runtime.checkpoint", "bio.bonds", "workflows.summary",
                "workflows.trj2fig", "workflows.path_search",
                "mlip.convert", "mlip.uma", "cli", "core.io_pdb",
                "core.io_gjf", "bio.residues", "bio.add_elem",
                "bio.extract", "bio.merge", "engines.bias",
                "workflows.config", "workflows.common", "workflows.allflow",
                "runtime.profiling"):
        assert f"pdb2reaction_tpu_torch.{mod}" in names, mod


def test_path_search_runs_without_matplotlib(tmp_path):
    """path-search with matplotlib (and PyYAML, click, JAX) blocked: the
    two PNGs are skipped with a warning each, everything else is
    written, and the diagram's levels are in summary.yaml."""
    (tmp_path / "A.xyz").write_text(
        "3\nA\nH 0.0 0.0 0.0\nH 0.686 0.0 0.0\nH 2.4 0.0 0.0\n")
    (tmp_path / "B.xyz").write_text(
        "3\nB\nH 0.0 0.0 0.0\nH 1.714 0.0 0.0\nH 2.4 0.0 0.0\n")
    script = _BLOCKED.replace('print(" ".join(names))', """
from pdb2reaction_tpu_torch import cli
cli.main(["path-search", "-i", "A.xyz", "-i", "B.xyz", "-q", "0",
          "--calc-mode", "morse", "--device", "cpu", "--freeze-atoms",
          "0,2", "--max-nodes", "7", "--out-dir", "ps"])
""")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = tmp_path / "ps"
    assert "energy_diagram.png skipped" in r.stdout
    assert "mep_plot.png skipped" in r.stdout
    assert not (out / "energy_diagram.png").exists()
    assert not (out / "mep_plot.png").exists()
    for f in ("mep.trj", "summary.yaml", "summary.log",
              "seg_000_mep/final_geometries.trj", "seg_000_mep/hei.xyz",
              "seg_000_mep/summary.yaml"):
        assert (out / f).exists(), f
    import json
    doc = json.loads((out / "summary.yaml").read_text())
    assert doc["diagram"]["chain"] == "R --> TS1 --> P"


def test_stage4_modules_import_and_run_without_jax_or_yaml(tmp_path):
    """The stage-4 engines and workflows import with JAX, PyYAML,
    matplotlib and click blocked, and ``freq`` writes its
    thermochemistry (JSON, which YAML readers take) without them."""
    (tmp_path / "w.xyz").write_text(
        "3\nwater\nO 0.0 0.0 0.0\nH 0.96 0.02 0.0\nH -0.23 0.93 0.01\n")
    script = _BLOCKED.replace('print(" ".join(names))', """
from pdb2reaction_tpu_torch import cli
try:
    cli.main(["freq", "-i", "w.xyz", "-q", "0", "--calc-mode", "morse",
              "--device", "cpu", "--out-dir", "fq"])
except SystemExit as e:
    assert e.code == 0, e.code
print(" ".join(names))
""")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    for mod in ("engines.dof", "engines.vib", "engines.thermo",
                "engines.rfo", "engines.dimer", "engines.irc",
                "workflows.freq", "workflows.tsopt", "workflows.irc"):
        assert f"pdb2reaction_tpu_torch.{mod}" in names, mod
    import json
    doc = json.loads((tmp_path / "fq" / "thermoanalysis.yaml").read_text())
    assert doc["zpe"] > 0 and doc["n_imag"] >= 0


def test_all_runs_without_jax_yaml_matplotlib_click(tmp_path):
    """The default subcommand (all) on the R/P complex of
    tests/test_extract.py with JAX, PyYAML, matplotlib and click blocked:
    --args-yaml read by the port's own reader, the element preflight,
    every PNG skipped with a warning, the PDB, merge and summary outputs
    written."""
    import shutil
    from test_extract import build_complex_pdb
    r = tmp_path / "R.pdb"
    build_complex_pdb(r)
    (tmp_path / "P.pdb").write_text(r.read_text().replace(
        "1.200   0.000   0.000", "2.300   0.000   0.000"))
    for name in ("R.pdb", "P.pdb"):     # blank element columns: the
        p = tmp_path / name             # preflight repairs them
        p.write_text("\n".join(ln[:76].rstrip() for ln in
                               p.read_text().splitlines()) + "\n")
    (tmp_path / "args.yaml").write_text(
        "# search depth for a short run\nsearch:\n  max_depth: 0\n")
    script = _BLOCKED.replace('print(" ".join(names))', """
from pdb2reaction_tpu_torch import cli
try:
    cli.main(["-i", "R.pdb", "-i", "P.pdb", "--center", "LIG",
              "--ligand-charge", "0", "--calc-mode", "morse", "--device",
              "cpu", "--max-nodes", "7", "--preopt", "False",
              "--args-yaml", "args.yaml", "--out-dir", "all"])
except SystemExit as e:
    assert e.code == 0, e.code
""")
    # one intra-op thread, as tests/test_torch_all.py runs run_all
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = tmp_path / "all"
    assert "energy_diagram_all.png skipped" in r.stdout
    assert "max_depth: 0" in r.stdout
    assert not list(out.rglob("*.png"))
    for f in ("elem_fixed_R.pdb", "stage1_extract/pocket_elem_fixed_R.pdb",
              "stage2_path/mep_full.pdb", "stage3_merged/mep_full.pdb",
              "summary.yaml", "summary.log"):
        assert (out / f).exists(), f
    import json
    doc = json.loads((out / "summary.yaml").read_text())
    assert doc["n_segments"] >= 1 and doc["stage4"] == []
    shutil.rmtree(out)
