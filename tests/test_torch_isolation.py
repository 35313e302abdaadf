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
