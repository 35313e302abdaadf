"""The port's DFT driver (``workflows/dft.py``, ``workflows/minidft.py``,
the ``dft`` CLI) against the JAX package's:

- the twins of every test of ``tests/test_dft.py``, each driven with the
  same stub SCF backend through both packages' ``run_dft``: the two
  ``result.yaml`` files load (``yaml.safe_load``) to equal documents,
  null population cells and ``population_error`` included; exit code 3
  comes after the file is written;
- the mini RHF/STO-3G engine (float64 torch on the CPU here) against
  the JAX package's numpy ``rhf`` on H2, HeH+ and H3+: energies within
  1e-10 Hartree, Mulliken and Löwdin charges within 1e-8 e, the same
  convergence; the odd-electron, open-shell and heavy-element refusals;
- the ``dft`` CLI: the mini engine through both packages, and exit code
  2 naming PySCF where it is not installed.
"""

import numpy as np
import pytest
import yaml
from click.testing import CliRunner

from pdb2reaction_tpu.cli import cli as jcli
from pdb2reaction_tpu.workflows import dft as jdft
from pdb2reaction_tpu.workflows.minidft import rhf as j_rhf
from pdb2reaction_tpu_torch import cli
from pdb2reaction_tpu_torch.workflows import dft as tdft
from pdb2reaction_tpu_torch.workflows.minidft import rhf

E_TOL, Q_TOL = 1e-10, 1e-8
KCAL = 627.509474063056


class StubBackend:
    """Records the driver's request and returns canned populations as the
    given package's ScfResult."""

    def __init__(self, result_cls, converged=True, e_tot=-76.4,
                 with_pop=True, pop_error=None):
        self.cls, self.converged, self.e_tot = result_cls, converged, e_tot
        self.with_pop, self.pop_error = with_pop, pop_error
        self.calls = []

    def kernel(self, struct, **kw):
        self.calls.append(kw)
        n, s = struct.n_atoms, kw["spin_mult"]
        res = self.cls(e_tot=self.e_tot, converged=self.converged,
                       scf_type="RKS" if s == 1 else "UKS",
                       engine_label="stub", density_fit=kw["density_fit"])
        if self.with_pop and kw["pop"]:
            res.mulliken = [0.1 * i for i in range(n)]
            res.lowdin = [0.2 * i for i in range(n)]
            res.iao = [0.3 * i for i in range(n)]
            if s > 1:
                res.spin_mulliken = [1.0] * n
                res.spin_lowdin = [1.0] * n
                res.spin_iao = [1.0] * n
        res.population_error = self.pop_error
        return res


@pytest.fixture()
def water_xyz(tmp_path):
    p = tmp_path / "w.xyz"
    p.write_text("3\n\nO 0 0 0\nH 0.96 0 0\nH -0.24 0.93 0\n")
    return p


def _both(tmp_path, path, stub_kw=None, **kw):
    """run_dft through both packages with the same stub; (port result,
    JAX result, port backend, the two result.yaml documents)."""
    out = {}
    for tag, mod in (("t", tdft), ("j", jdft)):
        be = StubBackend(mod.ScfResult, **(stub_kw or {}))
        try:
            res = mod.run_dft(path, backend=be, out_dir=tmp_path / tag,
                              verbose=False, **kw)
        except mod.ScfNotConverged as e:
            assert e.exit_code == 3
            res = None
        doc = yaml.safe_load((tmp_path / tag / "result.yaml").read_text())
        out[tag] = (res, be, doc)
    assert out["t"][2] == out["j"][2]
    assert out["t"][1].calls == out["j"][1].calls
    return out["t"][0], out["j"][0], out["t"][1], out["t"][2]


def test_rks_selection_and_result_yaml(water_xyz, tmp_path):
    res, jres, be, doc = _both(tmp_path, water_xyz, charge=0, spin=1)
    kw = be.calls[0]
    assert kw["spin_mult"] == 1 and kw["charge"] == 0
    assert kw["density_fit"] is True and kw["func"] == "wb97m-v"
    assert res["scf_type"] == "RKS"
    assert res["energy_au"] == pytest.approx(-76.4)
    assert res["energy_kcal"] == pytest.approx(-76.4 * KCAL)
    assert {k: v for k, v in res.items() if k != "result_yaml"} == \
        {k: v for k, v in jres.items() if k != "result_yaml"}
    assert doc["energy"]["hartree"] == pytest.approx(-76.4)
    assert doc["energy"]["converged"] is True
    assert doc["energy"]["engine"] == "stub"
    rows = doc["charges [index, element, mulliken, lowdin, iao]"]
    assert rows[0] == [0, "O", 0.0, 0.0, 0.0]
    assert rows[1][:2] == [1, "H"] and rows[1][2] == pytest.approx(0.1)
    spins = doc["spin_densities [index, element, mulliken, lowdin, iao]"]
    assert spins[0] == [0, "O", None, None, None]
    assert doc["input"]["conv_tol"] == 1e-9          # a float, not "1e-09"
    text = (tmp_path / "t" / "result.yaml").read_text()
    assert "[0, \"O\", 0.0, 0.0, 0.0]" in text        # a row on one line


def test_uks_selection_and_spin_tables(water_xyz, tmp_path):
    res, _, be, doc = _both(tmp_path, water_xyz, charge=1, spin=2)
    assert be.calls[0]["spin_mult"] == 2
    assert res["scf_type"] == "UKS"
    spins = doc["spin_densities [index, element, mulliken, lowdin, iao]"]
    assert spins[0] == [0, "O", 1.0, 1.0, 1.0]
    assert res["iao_spin"] == [1.0, 1.0, 1.0]


def test_density_fit_toggle_passthrough(water_xyz, tmp_path):
    _, _, be, doc = _both(tmp_path, water_xyz, charge=0, spin=1,
                          density_fit=False)
    assert be.calls[0]["density_fit"] is False
    assert doc["input"]["density_fit"] is False


def test_nonconvergence_writes_yaml_then_exit3(water_xyz, tmp_path):
    res, jres, _, doc = _both(tmp_path, water_xyz, {"converged": False},
                              charge=0, spin=1)
    assert res is None and jres is None              # both raised, code 3
    assert doc["energy"]["converged"] is False


def test_missing_populations_leave_null_cells(water_xyz, tmp_path):
    _, _, _, doc = _both(tmp_path, water_xyz, {"with_pop": False},
                         charge=0, spin=1)
    rows = doc["charges [index, element, mulliken, lowdin, iao]"]
    assert rows[0] == [0, "O", None, None, None]
    assert "population_error" not in doc


def test_population_error_recorded(water_xyz, tmp_path):
    _, _, _, doc = _both(tmp_path, water_xyz, {
        "with_pop": False, "pop_error": "LinAlgError: singular overlap"},
        charge=0, spin=1)
    assert doc["population_error"] == "LinAlgError: singular overlap"
    rows = doc["charges [index, element, mulliken, lowdin, iao]"]
    assert rows[0] == [0, "O", None, None, None]


SYSTEMS = {
    "H2": ([1, 1], [[0, 0, 0], [0.74, 0, 0]], 0),
    "HeH+": ([2, 1], [[0, 0, 0], [0.772, 0, 0]], 1),
    "H3+": ([1, 1, 1], [[0, 0, 0], [0.87, 0, 0], [0.435, 0.75, 0]], 1),
}


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_mini_engine_matches_jax_rhf(name):
    Z, X, q = SYSTEMS[name]
    a = j_rhf(Z, X, charge=q)
    b = rhf(Z, X, charge=q, device="cpu")
    assert b["converged"] is a["converged"] is True
    assert abs(b["e_tot"] - a["e_tot"]) <= E_TOL
    for k in ("mulliken", "lowdin"):
        assert np.abs(np.subtract(b[k], a[k])).max() <= Q_TOL
    assert abs(sum(b["mulliken"]) - q) <= Q_TOL
    np.testing.assert_allclose(b["mo_energies"], a["mo_energies"],
                               rtol=0, atol=1e-9)
    assert b["n_basis"] == a["n_basis"] == len(Z)


def test_mini_engine_through_both_drivers(tmp_path):
    """The twins of tests/test_dft.py's mini-engine tests: H2 near
    -1.1168 Hartree, HeH+ charges, the documents equal to JAX's but for
    the card flag."""
    p = tmp_path / "h2.xyz"
    p.write_text("2\n\nH 0 0 0\nH 0.74 0 0\n")
    res = tdft.run_dft(p, charge=0, spin=1, engine="mini", device="cpu",
                       out_dir=tmp_path / "t", verbose=False)
    jres = jdft.run_dft(p, charge=0, spin=1, engine="mini",
                        out_dir=tmp_path / "j", verbose=False)
    assert res["energy_au"] == pytest.approx(-1.1168, abs=2e-3)
    assert abs(res["energy_au"] - jres["energy_au"]) <= E_TOL
    assert res["scf_type"] == "RHF" and res["converged"] is True
    assert res["mulliken_charges"] == pytest.approx([0.0, 0.0], abs=1e-8)
    dt = yaml.safe_load((tmp_path / "t" / "result.yaml").read_text())
    dj = yaml.safe_load((tmp_path / "j" / "result.yaml").read_text())
    assert dt["energy"]["engine"] == "mini-rhf(sto-3g)"
    assert "mini-rhf" in dt["population_error"]
    for d in (dt, dj):
        d["energy"].pop("hartree")
        d["energy"].pop("kcal_per_mol")
        d["input"].pop("input")
    assert dt == dj

    heh = tmp_path / "heh.xyz"
    heh.write_text("2\n\nHe 0 0 0\nH 0.772 0 0\n")
    r = tdft.run_dft(heh, charge=1, spin=1, engine="mini", device="cpu",
                     out_dir=tmp_path / "heh", verbose=False)
    assert r["energy_au"] == pytest.approx(-2.8414, abs=5e-3)
    assert sum(r["mulliken_charges"]) == pytest.approx(1.0, abs=1e-8)
    assert r["mulliken_charges"][0] < r["mulliken_charges"][1]

    with pytest.raises(tdft.ScfNotConverged) as ei:
        tdft.run_dft(p, charge=0, spin=1, engine="mini", device="cpu",
                     max_cycle=1, conv_tol=1e-14, out_dir=tmp_path / "nc",
                     verbose=False)
    assert ei.value.exit_code == 3
    doc = yaml.safe_load((tmp_path / "nc" / "result.yaml").read_text())
    assert doc["energy"]["converged"] is False


def test_mini_engine_refusals(tmp_path):
    w = tmp_path / "w.xyz"
    w.write_text("3\n\nO 0 0 0\nH 0.96 0 0\nH -0.24 0.93 0\n")
    with pytest.raises(ValueError, match="s-block"):
        tdft.run_dft(w, charge=0, spin=1, engine="mini", device="cpu",
                     out_dir=tmp_path / "o", verbose=False)
    h2 = tmp_path / "h2.xyz"
    h2.write_text("2\n\nH 0 0 0\nH 0.74 0 0\n")
    with pytest.raises(ValueError, match="closed-shell"):
        tdft.run_dft(h2, charge=0, spin=3, engine="mini", device="cpu",
                     out_dir=tmp_path / "o", verbose=False)
    with pytest.raises(ValueError, match="even positive electron count"):
        rhf([1, 1, 1], [[0, 0, 0], [0.9, 0, 0], [1.8, 0, 0]], charge=0,
            device="cpu")


def test_cli_mini_engine_both_packages(tmp_path):
    p = tmp_path / "h2.xyz"
    p.write_text("2\n\nH 0 0 0\nH 0.74 0 0\n")
    flags = ["dft", "-i", str(p), "-q", "0", "--engine", "mini",
             "--func-basis", "hf/sto-3g"]
    r = CliRunner().invoke(jcli, flags + ["--out-dir", str(tmp_path / "j")])
    assert r.exit_code == 0, r.output
    with pytest.raises(SystemExit) as e:
        cli.main(flags + ["--device", "cpu", "--out-dir",
                          str(tmp_path / "t")])
    assert e.value.code == 0
    dt = yaml.safe_load((tmp_path / "t" / "result.yaml").read_text())
    dj = yaml.safe_load((tmp_path / "j" / "result.yaml").read_text())
    assert dt["energy"]["hartree"] == pytest.approx(-1.1168, abs=2e-3)
    assert abs(dt["energy"]["hartree"] - dj["energy"]["hartree"]) <= E_TOL
    assert (dt["input"]["func"], dt["input"]["basis"]) == ("hf", "sto-3g")
    assert dt["input"] == {**dj["input"], "input": dt["input"]["input"]}


def test_cli_exit2_without_pyscf(water_xyz, capsys):
    try:
        import pyscf  # noqa: F401
        pytest.skip("pyscf is installed: the ImportError path is not reached")
    except ImportError:
        pass
    for engine in ("cpu", "gpu"):
        with pytest.raises(SystemExit) as e:
            cli.main(["dft", "-i", str(water_xyz), "-q", "0", "--engine",
                      engine, "--out-dir", str(water_xyz.parent / "o")])
        assert e.value.code == 2
    cap = capsys.readouterr()
    assert "PySCF" in cap.err
    assert "no gpu4pyscf backend is ported" in cap.out
    r = CliRunner().invoke(jcli, ["dft", "-i", str(water_xyz), "-q", "0"])
    assert r.exit_code == 2
