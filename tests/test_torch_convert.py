"""Port ``mlip/convert.py`` and the factory's ``.pt`` route against the
JAX package's converter and the independent goldens:

- twins of ``tests/test_escn_golden.py``: the configuration inferred
  from the small fixture; its energies and forces through the port's
  plain path in float64 against the goldens of the independent numpy
  executor (``tests/numpy_escn.py``: scipy harmonics, fitted Wigner
  matrices, finite-difference forces) at JAX's bar, 1e-6 eV/atom and
  1e-5 eV/Angstrom (the FD goldens' own accuracy); the real-fairchem
  spellings and the audit; an unmapped tensor; the production-dims
  class (lmax 4, mmax 2, C = 128, 4 experts; the state dict rebuilt
  from its seed, its fingerprint checked) at 1e-6 x n eV and 1e-5
  eV/Angstrom, and float32 (the kernels' type) against float64 at
  JAX's pallas-mega-against-XLA bar (energy rtol 2e-5; forces rtol
  1e-3, atol 2e-5 eV/Angstrom);
- twins of ``tests/test_escn_parity.py``'s converter tests on the torch
  mirror's state dict: the port's converted tree equal, tensor for
  tensor, to the JAX package's converted tree carried across with
  ``params_from_jax``, in every synonym layout; the inferred
  configuration; unconsumed and missing tensors raise; energies and
  forces against the mirror's autograd at 1e-6;
- the ``checkpoint=`` and ``PDB2R_TPU_UMA_PT`` routes of
  ``make_uma_calculator`` on ``device="cpu"``: converted weights, the
  ``converted:<path>`` tag, no surrogate warning; a non-``.pt``
  checkpoint raises;
- gate weights: the gate mirror's state dict converted tensor for
  tensor as the JAX converter's tree, its energy and forces through the
  ``.pt`` route against JAX's ``escn_energy`` (rtol 1e-10) and the
  mirror's autograd (1e-6), and ``from_jax`` carrying a JAX gate
  tree."""

import dataclasses
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pdb2reaction_tpu.mlip import convert as j_convert
from pdb2reaction_tpu.mlip.escn import ESCNConfig as JESCNConfig
from pdb2reaction_tpu_torch.constants import AU2EV, EV2AU, F_EVAA_2_AU
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.mlip import convert
from pdb2reaction_tpu_torch.mlip.from_jax import params_from_jax
from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator

FIXTURES = Path(__file__).parent / "fixtures"
SCRIPTS = Path(__file__).parents[1] / "scripts"


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURES / "escn_golden.npz")


def _sd(g):
    return {k[3:]: torch.as_tensor(g[k]) for k in g.files
            if k.startswith("sd:")}


@pytest.fixture(scope="module")
def golden_pt(golden, tmp_path_factory):
    pt = tmp_path_factory.mktemp("ckpt") / "golden.pt"
    torch.save({"state_dict": _sd(golden)}, pt)
    return pt


def _ev(calc, coords_ang):
    """(energy eV, forces eV/Angstrom [N, 3]) of a calculator."""
    r = calc.get_forces(np.asarray(coords_ang).reshape(-1)
                        / 0.529177210903)
    return r["energy"] * AU2EV, r["forces"].reshape(-1, 3) / F_EVAA_2_AU


def _trees_equal(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _trees_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _trees_equal(x, y, f"{where}[{i}]")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), where


def test_inferred_config_from_golden(golden_pt):
    _, cfg = convert.convert_checkpoint(golden_pt)
    assert (cfg.lmax, cfg.mmax) == (2, 1)
    assert cfg.sphere_channels == 8 and cfg.num_layers == 2
    assert cfg.num_experts == 2
    assert cfg.edge_act == "s2"
    assert cfg.edge_kernel == "pallas-mega"          # the card's default


@pytest.mark.parametrize("i", [0, 1, 2])
def test_converted_golden_energy_forces(golden, golden_pt, i):
    """The .pt route of the factory in float64 on the CPU against the
    independent goldens (charge, spin and task from the fixture)."""
    q, s, t = (int(v) for v in golden[f"struct{i}_cqt"])
    st = Structure(golden[f"struct{i}_numbers"], golden[f"struct{i}_coords"])
    calc = make_uma_calculator(st, checkpoint=str(golden_pt), device="cpu",
                               dtype=torch.float64, charge=q, spin=s,
                               task=t)
    e, f = _ev(calc, st.coords)
    n = st.n_atoms
    assert abs(e - float(golden[f"struct{i}_energy"])) < 1e-6 * n
    assert np.abs(f - golden[f"struct{i}_forces"]).max() < 1e-5


def _fairchem_spelling(k):
    k = k[len("backbone."):]                          # drop namespace
    k = re.sub(r"\.fc_m(\d+)_r\.",
               lambda m: f".so2_m_conv.{int(m.group(1)) - 1}.fc_r.", k)
    k = re.sub(r"\.fc_m(\d+)_i\.",
               lambda m: f".so2_m_conv.{int(m.group(1)) - 1}.fc_i.", k)
    k = re.sub(r"(sphere|source|target|charge|spin|task)"
               r"_embedding\.weight", r"\1_embedding.embedding.weight", k)
    return "model." + k                               # trainer wrapper


def test_synonym_layout_and_audit_of_golden(golden, golden_pt, tmp_path):
    sd = {_fairchem_spelling(k): v for k, v in _sd(golden).items()}
    pt = tmp_path / "fairchem_spelling.pt"
    torch.save({"state_dict": sd}, pt)
    params, cfg = convert.convert_checkpoint(pt)
    assert (cfg.lmax, cfg.mmax) == (2, 1) and cfg.edge_act == "s2"
    ref = np.asarray(golden["sd:backbone.blocks.0.so2_conv_1.fc_m1_r.weight"])
    got = params["blocks"][0]["so2_conv_1"]["fc_m1_r"]["w"]
    assert torch.equal(got, torch.as_tensor(ref.transpose(0, 2, 1)))
    _trees_equal(params, convert.convert_checkpoint(golden_pt)[0])
    rep = convert.audit_checkpoint(pt)
    assert rep["ok"], (rep["missing"], rep["unmapped"][:5])
    assert not rep["unmapped"]
    assert convert.inspect_checkpoint(pt) == {
        k: tuple(v.shape) for k, v in convert._strip(
            {"state_dict": sd}).items()}


def test_audit_reports_unmapped_tensor(golden, tmp_path):
    sd = _sd(golden)
    sd["backbone.some_new_fairchem_module.weight"] = torch.zeros(3, 3)
    pt = tmp_path / "drifted.pt"
    torch.save({"state_dict": sd}, pt)
    rep = convert.audit_checkpoint(pt)
    assert not rep["ok"]
    assert "backbone.some_new_fairchem_module.weight" in rep["unmapped"]
    with pytest.raises(ValueError, match="not consumed"):
        convert.convert_checkpoint(pt)


# ---------------------------------------------------------------------------
# the production-dims golden
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def md(tmp_path_factory):
    sys.path.insert(0, str(SCRIPTS))
    try:
        from make_escn_golden import MD_CFG, make_state_dict
    finally:
        sys.path.remove(str(SCRIPTS))
    g = np.load(FIXTURES / "escn_golden_md.npz")
    sd = make_state_dict(MD_CFG, seed=int(g["cfg_seed"]))
    fp = np.array([float(np.sum(v)) for _, v in sorted(sd.items())][:8])
    np.testing.assert_allclose(fp, g["sd_fingerprint"], rtol=1e-12,
                               err_msg="numpy RNG stream drift")
    pt = tmp_path_factory.mktemp("ckpt_md") / "golden_md.pt"
    torch.save({"state_dict": {k: torch.as_tensor(v)
                               for k, v in sd.items()}}, pt)
    return g, pt


def test_inferred_config_of_md_golden(md):
    _, cfg = convert.convert_checkpoint(md[1])
    assert (cfg.lmax, cfg.mmax) == (4, 2)
    assert cfg.sphere_channels == 128 and cfg.hidden_channels == 64
    assert cfg.num_experts == 4 and cfg.edge_act == "s2"


@pytest.mark.parametrize("i", [0, 1])
def test_md_golden_energy_forces(md, i):
    """The production-dims class through the .pt route: float64 against
    the independent goldens; float32 against float64 at the kernels'
    bar (the card repeats both against K1/K2 in chip_smoke.py)."""
    g, pt = md
    q, s, t = (int(v) for v in g[f"struct{i}_cqt"])
    st = Structure(g[f"struct{i}_numbers"], g[f"struct{i}_coords"])
    out = {}
    for dt in (torch.float64, torch.float32):
        calc = make_uma_calculator(st, checkpoint=str(pt), device="cpu",
                                   dtype=dt, charge=q, spin=s, task=t)
        out[dt] = _ev(calc, st.coords)
    e, f = out[torch.float64]
    assert abs(e - float(g[f"struct{i}_energy"])) < 1e-6 * st.n_atoms
    assert np.abs(f - g[f"struct{i}_forces"]).max() < 1e-5
    e32, f32 = out[torch.float32]
    np.testing.assert_allclose(e32, e, rtol=2e-5)
    np.testing.assert_allclose(f32, f, rtol=1e-3, atol=2e-5)


# ---------------------------------------------------------------------------
# the torch mirror's state dict: the same tree as the JAX converter's
# ---------------------------------------------------------------------------

JCFG = JESCNConfig(lmax=2, mmax=1, sphere_channels=8, hidden_channels=8,
                   edge_channels=8, ffn_hidden=16, num_layers=2,
                   num_experts=2, route_dim=4, num_gauss=8, max_z=20,
                   charge_range=4, spin_range=4, num_tasks=2,
                   max_neighbors=16, dtype=jnp.float64)


@pytest.fixture(scope="module")
def mirror():
    from torch_escn import ESCNTorch
    return ESCNTorch(JCFG, seed=3)


def _jax_tree(sd):
    return params_from_jax(j_convert.convert_state_dict(sd, JCFG))


def test_infer_config_matches_mirror(mirror):
    cfg = convert.infer_config(mirror.state_dict(), dtype=torch.float64)
    for field in ("lmax", "mmax", "sphere_channels", "hidden_channels",
                  "edge_channels", "ffn_hidden", "num_layers", "num_experts",
                  "route_dim", "num_gauss", "max_z", "charge_range",
                  "spin_range", "num_tasks"):
        assert getattr(cfg, field) == getattr(JCFG, field), field
    assert cfg.dtype == torch.float64


def _v_ddp(sd):
    return {f"module.{k}": v for k, v in sd.items()}


def _v_trainer(sd):
    return {f"module.model.{k}": v for k, v in sd.items()}


def _v_modulelist(sd):
    out = {}
    for k, v in sd.items():
        k = re.sub(r"\.fc_m(\d+)_r\.",
                   lambda m: f".so2_m_conv.{int(m.group(1)) - 1}.fc_r.", k)
        k = re.sub(r"\.fc_m(\d+)_i\.",
                   lambda m: f".so2_m_conv.{int(m.group(1)) - 1}.fc_i.", k)
        out[k] = v
    return out


def _v_inner_embedding(sd):
    return {re.sub(r"(sphere|source|target|charge|spin|task)"
                   r"_embedding\.weight",
                   lambda m: f"{m.group(1)}_embedding.embedding.weight",
                   k): v for k, v in sd.items()}


def _v_no_backbone(sd):
    return {k[len("backbone."):] if k.startswith("backbone.") else k: v
            for k, v in sd.items()}


def _v_container(sd):
    return {"state_dict": dict(sd), "epoch": 3, "optimizer": None}


def _v_everything(sd):
    return _v_container(_v_ddp(_v_modulelist(_v_inner_embedding(
        _v_no_backbone(sd)))))


@pytest.mark.parametrize("variant", [
    lambda sd: sd, _v_ddp, _v_trainer, _v_modulelist, _v_inner_embedding,
    _v_no_backbone, _v_container, _v_everything])
def test_converted_tree_matches_jax(mirror, variant):
    """Tensor for tensor the JAX converter's tree through
    params_from_jax, in every key layout."""
    sd = dict(mirror.state_dict())
    ref = _jax_tree(sd)
    for k in ("charge", "spin", "task"):
        ref.pop(k)
    got = convert.convert_state_dict(variant(sd), convert.infer_config(sd))
    _trees_equal(got, ref)


def test_unconsumed_and_missing_tensors_raise(mirror):
    sd = dict(mirror.state_dict())
    sd["backbone.mystery.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="not consumed"):
        convert.convert_state_dict(sd)
    sd = dict(mirror.state_dict())
    del sd["backbone.blocks.1.so2_conv_1.fc_m0.weight"]
    with pytest.raises(KeyError):
        convert.convert_state_dict(sd)


JCFG_GATE = dataclasses.replace(JCFG, edge_act="gate")


@pytest.fixture(scope="module")
def gate_mirror():
    from torch_escn import ESCNTorch
    return ESCNTorch(JCFG_GATE, seed=4)


def test_gate_state_dict_converts_to_jax_tree(gate_mirror):
    """Gate weights (``backbone.blocks.N.gate.{weight,bias}``) go into each
    block's ``gate`` MoLE bank, tensor for tensor the JAX converter's,
    in the plain and the fairchem spellings."""
    sd = dict(gate_mirror.state_dict())
    cfg = convert.infer_config(sd)
    assert cfg.edge_act == "gate"
    ref = params_from_jax(j_convert.convert_state_dict(sd, JCFG_GATE))
    for k in ("charge", "spin", "task"):
        ref.pop(k)
    for variant in (lambda d: d, _v_everything):
        got = convert.convert_state_dict(variant(sd))
        _trees_equal(got, ref)
        assert all(set(b["gate"]) == {"w", "b"} for b in got["blocks"])
    assert convert.convert_state_dict(sd)["blocks"][1]["gate"]["w"].shape \
        == (JCFG.num_experts, JCFG.hidden_channels, JCFG.hidden_channels)


def test_gate_pt_energy_forces_match_jax_and_mirror(gate_mirror, tmp_path):
    """A gate checkpoint through make_uma_calculator(checkpoint=...) in
    float64: energy and forces against the JAX package's escn_energy on
    its own converted tree within rtol 1e-10, and against the mirror's
    autograd at 1e-6 (Hartree, Hartree/Bohr)."""
    import jax
    import jax.tree_util as jtu
    from pdb2reaction_tpu.core.structure import Structure as JStructure
    from pdb2reaction_tpu.core.structure import pad_to as jpad_to
    from pdb2reaction_tpu.mlip.escn import escn_energy as j_energy
    sd = dict(gate_mirror.state_dict())
    pt = tmp_path / "gate.pt"
    torch.save({"state_dict": sd}, pt)
    zs = np.array([6, 6, 8, 1, 1, 7], np.int32)
    xyz = np.random.default_rng(9).normal(scale=1.3, size=(6, 3))
    st = Structure(zs, xyz)
    calc = make_uma_calculator(st, charge=-1, spin=2, task=1,
                               checkpoint=str(pt), device="cpu",
                               dtype=torch.float64)
    assert calc.cfg.edge_act == "gate"
    e_t, f_t = _ev(calc, xyz)
    jp = jtu.tree_map(jnp.asarray, j_convert.convert_state_dict(sd,
                                                               JCFG_GATE))
    jp.update(charge=jnp.asarray(-1.0), spin=jnp.asarray(2.0),
              task=jnp.asarray(1.0))
    sysp = jpad_to(JStructure(zs, xyz), multiple=8)
    e_j, g_j = jax.jit(jax.value_and_grad(
        lambda c: j_energy(c, sysp, jp, JCFG_GATE)))(jnp.asarray(sysp.coords))
    f_j = -np.asarray(g_j)[:len(zs)]
    assert abs(e_t - float(e_j)) <= 1e-10 * abs(float(e_j))
    assert np.abs(f_t - f_j).max() <= 1e-10 * np.abs(f_j).max()
    e_m, f_m = gate_mirror.energy_forces(
        torch.as_tensor(zs, dtype=torch.long), torch.as_tensor(xyz),
        charge=-1, spin=2, task=1)
    assert abs(e_t - float(e_m)) * EV2AU < 1e-6
    np.testing.assert_allclose(f_t * F_EVAA_2_AU, f_m.numpy() * F_EVAA_2_AU,
                               atol=1e-6)


def test_from_jax_carries_gate_tree(gate_mirror):
    """params_from_jax takes a JAX gate tree's per-block gate banks (the
    JAX converter's tree of the gate mirror; the JAX package's seeded
    gate trees go through it in tests/test_torch_escn_branches.py)."""
    tree = j_convert.convert_state_dict(dict(gate_mirror.state_dict()),
                                        JCFG_GATE)
    t = params_from_jax(tree)
    assert len(t["blocks"]) == len(tree["blocks"]) == JCFG.num_layers
    for b_t, b_j in zip(t["blocks"], tree["blocks"]):
        for k in ("w", "b"):
            assert torch.equal(b_t["gate"][k],
                               torch.as_tensor(np.array(b_j["gate"][k])))


def test_pt_checkpoint_routes_on_cpu(mirror, tmp_path, monkeypatch, capsys):
    """checkpoint=x.pt and PDB2R_TPU_UMA_PT serve the converted weights
    (against the mirror's autograd at 1e-6 Hartree and Hartree/Bohr, as
    the JAX factory's test), tagged converted:<path>, with no surrogate
    warning."""
    pt = tmp_path / "uma_mirror.pt"
    torch.save({"state_dict": mirror.state_dict()}, pt)
    zs = np.array([6, 6, 8, 1, 1], np.int32)
    xyz = np.random.default_rng(7).normal(scale=1.3, size=(5, 3))
    st = Structure(zs, xyz)
    e_t, f_t = mirror.energy_forces(torch.as_tensor(zs, dtype=torch.long),
                                    torch.as_tensor(xyz), charge=-1,
                                    spin=2, task=1)
    capsys.readouterr()
    calcs = [make_uma_calculator(st, charge=-1, spin=2, task=1,
                                 checkpoint=str(pt), device="cpu",
                                 dtype=torch.float64)]
    monkeypatch.setenv("PDB2R_TPU_UMA_PT", str(pt))
    calcs.append(make_uma_calculator(st, charge=-1, spin=2, task=1,
                                     device="cpu", dtype=torch.float64))
    assert "SURROGATE" not in capsys.readouterr().err
    for calc in calcs:
        assert calc.weights_source == f"converted:{pt}"
        assert calc.cfg.edge_kernel == "pallas-mega"
        res = calc.get_forces(st.coords_bohr.reshape(-1))
        assert abs(res["energy"] - float(e_t) * EV2AU) < 1e-6
        np.testing.assert_allclose(res["forces"].reshape(-1, 3),
                                   f_t.numpy() * F_EVAA_2_AU, atol=1e-6)
    # params= wins over the variable
    from pdb2reaction_tpu_torch.mlip.escn import (ESCN_CONFIGS,
                                                  init_escn_params)
    w = init_escn_params(ESCN_CONFIGS["escn-test"], seed=0)
    calc = make_uma_calculator(st, model="escn-test", params=w,
                               device="cpu")
    assert calc.weights_source == "given"


def test_non_pt_checkpoint_raises(tmp_path):
    st = Structure(np.array([8, 1, 1]), np.eye(3))
    with pytest.raises(NotImplementedError, match="from_jax"):
        make_uma_calculator(st, model="escn-test",
                            checkpoint=str(tmp_path / "orbax_dir"),
                            device="cpu")
    with pytest.raises(ValueError, match="not both"):
        make_uma_calculator(st, model="escn-test", params={},
                            checkpoint=str(tmp_path / "x.pt"),
                            device="cpu")
