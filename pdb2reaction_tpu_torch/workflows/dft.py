"""DFT single point (``dft`` subcommand; ``all --dft True``).

Counterpart of ``pdb2reaction_tpu/workflows/dft.py``:

- RKS for multiplicity 1, UKS otherwise, with density fitting by
  default, through an injectable SCF backend (``backend=``, any object
  with ``kernel(struct, **settings) -> ScfResult``);
- the engines: ``PyscfBackend`` (CPU PySCF, imported at call time; its
  absence raises ImportError naming PySCF) and, with ``engine="mini"``,
  the port's own RHF/STO-3G engine for H and He on ``device``
  (``workflows/minidft.py``);
- ``result.yaml`` with the input, the energy and per-atom rows
  ``[index, element, mulliken, lowdin, iao]`` of charges and spin
  densities (null cells where an analysis is missing, and
  ``population_error`` saying why), written as JSON (valid YAML, read
  back equal by ``yaml.safe_load``; the port carries no PyYAML);
- SCF non-convergence raises ``ScfNotConverged`` (exit code 3) after
  ``result.yaml`` is written.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ..constants import AU2KCALPERMOL
from . import common
from .config import format_elapsed
from .summary import write_summary_yaml

DFT_KW: Dict[str, Any] = {
    "func": "wb97m-v",
    "basis": "def2-svp",
    "density_fit": True,
    "max_cycle": 100,
    "conv_tol": 1e-9,
    "engine": "auto",
    "pop": True,
}


class ScfNotConverged(RuntimeError):
    exit_code = 3


@dataclasses.dataclass
class ScfResult:
    """What the driver needs back from an SCF engine. A per-atom list is
    None when that analysis is unavailable (a null cell in
    ``result.yaml``)."""
    e_tot: float
    converged: bool
    scf_type: str                      # "RKS" | "UKS" | "RHF"
    engine_label: str = "pyscf(cpu)"
    used_gpu: bool = False
    density_fit: bool = True
    mulliken: Optional[List[float]] = None
    lowdin: Optional[List[float]] = None
    iao: Optional[List[float]] = None
    spin_mulliken: Optional[List[float]] = None
    spin_lowdin: Optional[List[float]] = None
    spin_iao: Optional[List[float]] = None
    # why the population cells are null when they are
    population_error: Optional[str] = None


class PyscfBackend:
    """The CPU PySCF engine, on the host's CPU."""

    def __init__(self):
        try:
            import pyscf  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "PySCF is not installed in this environment. The dft "
                "command needs the CPU PySCF engine (no gpu4pyscf backend "
                "is ported); install pyscf, or run the built-in RHF/STO-3G "
                "engine with --engine mini (H and He only).") from e

    def kernel(self, struct, *, charge: int, spin_mult: int, func: str,
               basis: str, density_fit: bool, max_cycle: int,
               conv_tol: float, grid_level: int, pop: bool) -> ScfResult:
        from pyscf import dft as pyscf_dft
        from pyscf import gto

        s = spin_mult
        mol = gto.M(atom=[(sym, tuple(xyz)) for sym, xyz in
                          zip(struct.symbols, struct.coords)],
                    charge=charge, spin=s - 1, basis=basis, unit="Angstrom")
        mf = pyscf_dft.RKS(mol) if s == 1 else pyscf_dft.UKS(mol)
        mf.xc = func
        mf.max_cycle = max_cycle
        mf.conv_tol = conv_tol
        mf.grids.level = grid_level
        if density_fit:
            mf = mf.density_fit()
        e_tot = mf.kernel()
        res = ScfResult(
            e_tot=float(e_tot if e_tot is not None
                        else getattr(mf, "e_tot", np.nan)),
            converged=bool(getattr(mf, "converged", False)),
            scf_type="RKS" if s == 1 else "UKS",
            density_fit=bool(density_fit))
        if not pop:
            return res
        try:
            self._populations(mol, mf, s, res)
        except Exception as e:
            # null cells, the SCF result kept, and the cause recorded
            res.population_error = f"{type(e).__name__}: {e}"
        return res

    @staticmethod
    def _populations(mol, mf, s, res: ScfResult) -> None:
        from pyscf.lo import orth
        dm = mf.make_rdm1()
        _, chg_m = mf.mulliken_pop(verbose=0)
        res.mulliken = [float(c) for c in np.atleast_1d(chg_m)]
        C = orth.orth_ao(mol, "meta_lowdin")
        dm_ao = dm if dm.ndim == 2 else dm[0] + dm[1]
        S = mol.intor("int1e_ovlp")
        pops = np.diag(C.T @ S @ dm_ao @ S @ C)
        labels = mol.ao_labels(fmt=None)

        def on(ia, diag, lab=labels):
            return float(diag[[k for k, x in enumerate(lab)
                               if x[0] == ia]].sum())

        res.lowdin = [float(mol.atom_charge(ia)) - on(ia, pops)
                      for ia in range(mol.natm)]
        if s > 1:
            spins = np.diag(C.T @ S @ (dm[0] - dm[1]) @ S @ C)
            res.spin_lowdin = [on(ia, spins) for ia in range(mol.natm)]
            pm = np.diag((dm[0] - dm[1]) @ S)
            res.spin_mulliken = [on(ia, pm) for ia in range(mol.natm)]
        # IAO populations: intrinsic atomic orbitals of the occupied space,
        # symmetrically orthogonalised, partitioned as Mulliken's
        try:
            from pyscf.lo import iao
            from scipy.linalg import fractional_matrix_power
            mo, occ = mf.mo_coeff, mf.mo_occ
            cocc = mo[:, occ > 0] if s == 1 else mo[0][:, occ[0] > 0]
            a = iao.iao(mol, cocc)
            a = a @ fractional_matrix_power(a.T @ S @ a, -0.5)
            diag = np.diag(a.T @ S @ dm_ao @ S @ a)
            ref = iao.reference_mol(mol).ao_labels(fmt=None)
            res.iao = [float(mol.atom_charge(ia)) - on(ia, diag, ref)
                       for ia in range(mol.natm)]
            if s > 1:
                sd = np.diag(a.T @ S @ (dm[0] - dm[1]) @ S @ a)
                res.spin_iao = [on(ia, sd, ref) for ia in range(mol.natm)]
        except Exception:
            pass


def _round_list(xs, tol=1e-10):
    """Values below ``tol`` in magnitude become 0.0; NaN stays."""
    if xs is None:
        return None
    return [0.0 if (x == x) and abs(x) < tol else float(x) for x in xs]


def run_dft(
    input_path,
    *,
    charge: Optional[int] = None,
    spin: Optional[int] = None,
    func: str = "wb97m-v",
    basis: str = "def2-svp",
    density_fit: bool = True,
    max_cycle: int = 100,
    conv_tol: float = 1e-9,
    grid_level: int = 3,
    pop: bool = True,
    engine: str = "auto",
    device="cuda",
    out_dir="./result_dft/",
    verbose: bool = True,
    backend=None,
    **_ignored,
) -> Dict[str, Any]:
    """The single point of ``input_path`` with ``func``/``basis``; writes
    ``result.yaml`` under ``out_dir``. ``engine="mini"`` takes the RHF /
    STO-3G engine on ``device``; any other engine PySCF on the CPU."""
    t0 = time.time()
    if backend is None:
        if str(engine).lower() == "mini":
            from .minidft import MiniRhfBackend
            backend = MiniRhfBackend(device=device)
        else:
            backend = PyscfBackend()
    struct = common.load_structure(input_path)
    q, s = common.resolve_charge_spin(struct, charge, spin)
    scf = backend.kernel(
        struct, charge=q, spin_mult=s, func=func, basis=basis,
        density_fit=density_fit, max_cycle=max_cycle, conv_tol=conv_tol,
        grid_level=grid_level, pop=pop)
    e_h = float(scf.e_tot)
    e_kcal = e_h * AU2KCALPERMOL

    cols = [_round_list(v) for v in (scf.mulliken, scf.lowdin, scf.iao,
                                     scf.spin_mulliken, scf.spin_lowdin,
                                     scf.spin_iao)]

    def row(i, elem, lists):
        return [i, elem] + [None if v is None else v[i] for v in lists]

    doc: Dict[str, Any] = {
        "input": {
            "input": str(input_path), "charge": q, "multiplicity": s,
            "func": func, "basis": basis, "density_fit": bool(density_fit),
            "max_cycle": max_cycle, "conv_tol": conv_tol,
            "grid_level": grid_level, "engine": engine,
            "scf_type": scf.scf_type,
        },
        "energy": {
            "hartree": e_h, "kcal_per_mol": e_kcal,
            "converged": bool(scf.converged), "engine": scf.engine_label,
            "used_gpu": bool(scf.used_gpu),
        },
        "charges [index, element, mulliken, lowdin, iao]": [
            row(i, el, cols[:3]) for i, el in enumerate(struct.symbols)],
        "spin_densities [index, element, mulliken, lowdin, iao]": [
            row(i, el, cols[3:]) for i, el in enumerate(struct.symbols)],
    }
    if scf.population_error:
        doc["population_error"] = scf.population_error
    out = common.rank_dir(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_summary_yaml(out / "result.yaml", doc)
    if verbose:
        print(f"[dft] E = {e_h:.10f} Ha ({func}/{basis}, {scf.scf_type}, "
              f"{scf.engine_label})")
        print(f"[dft] elapsed {format_elapsed(t0)}")
    # result.yaml is written first, then a non-converged SCF exits 3
    if not scf.converged:
        raise ScfNotConverged(
            f"SCF did not converge after {max_cycle} cycles")
    return {
        "energy_au": e_h, "energy_kcal": e_kcal,
        "functional": func, "basis": basis,
        "charge": q, "multiplicity": s, "scf_type": scf.scf_type,
        "converged": bool(scf.converged),
        "mulliken_charges": cols[0], "meta_lowdin_charges": cols[1],
        "iao_charges": cols[2], "meta_lowdin_spin": cols[4],
        "iao_spin": cols[5], "result_yaml": out / "result.yaml",
    }
