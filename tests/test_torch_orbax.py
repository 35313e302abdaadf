"""Orbax checkpoints in the port (``mlip/orbax_io.py``, ``load_checkpoint``
/ ``save_checkpoint`` / ``last_weights_source`` and the factory's
``checkpoint=`` / ``PDB2R_TPU_CKPT_DIR`` routes of ``mlip/uma.py``)
against the JAX package's, on the CPU at ``small`` and ``escn-test``
widths. Trees are written by JAX's own ``save_checkpoint`` (Orbax) and
by the port's; each package reads the other's bit for bit. Twins of
``tests/test_uma_plumbing.py``'s checkpoint tests. Every test that reads
or writes a tree needs ``tensorstore``."""

import sys

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.mlip import uma as JU
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu.mlip.escn import ESCN_FN_FOR
from pdb2reaction_tpu.mlip.escn import premerge_escn_params as j_premerge
from pdb2reaction_tpu.mlip.model import make_model as j_make_model
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.mlip import uma as TU
from pdb2reaction_tpu_torch.mlip.model import CONFIGS, ModelConfig
from pdb2reaction_tpu_torch.mlip.model import init_params

from test_torch_escn import jax_weights_np
from test_torch_painn import F32_SUM, jax_painn, molecule

MODELS = ["small", "escn-test"]


@pytest.fixture(autouse=True)
def _no_ckpt_env(monkeypatch):
    for k in ("PDB2R_TPU_CKPT_DIR", "PDB2R_TPU_UMA_PT"):
        monkeypatch.delenv(k, raising=False)


def jax_tree(model, seed=3):
    """(numpy weights, JAX energy function, the calculator's parameters
    from the weights) of ``model`` in float64."""
    if model == "small":
        p, cfg = jax_painn("small", jnp.float64, seed=seed)
        return p, j_make_model(cfg)[0], lambda t: t
    p, cfg = jax_weights_np("escn-test", jnp.float64, seed=seed)
    return p, ESCN_FN_FOR(cfg), lambda t: j_premerge(t, cfg)


def leaves_equal(a_tree, b_tree):
    """Same paths, and each leaf of the same dtype, shape and bits."""
    pa = jtu.tree_flatten_with_path(a_tree)[0]
    pb = jtu.tree_flatten_with_path(b_tree)[0]
    assert [k for k, _ in pa] == [k for k, _ in pb]
    for (k, a), (_, b) in zip(pa, pb):
        if isinstance(a, torch.Tensor):
            a = a.numpy()
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", MODELS)
def test_jax_tree_restores_in_the_port(model, tmp_path, capsys):
    pytest.importorskip("tensorstore")
    p, jfn, calc_params = jax_tree(model)
    p = dict(p, charge=np.float32(0.0), spin=np.float32(1.0))
    ckpt = tmp_path / "ckpt"
    JU.save_checkpoint(ckpt, jtu.tree_map(jnp.asarray, p))
    leaves_equal(TU.load_checkpoint(ckpt), JU.load_checkpoint(ckpt))
    zs, xyz = molecule(6, seed=2)
    jp = calc_params(jtu.tree_map(jnp.asarray, p))
    e_j = JCalculator(JStructure(zs, xyz), jfn, params=jp).get_energy(
        JStructure(zs, xyz).coords_bohr.reshape(-1))["energy"]
    capsys.readouterr()
    calc = TU.make_uma_calculator(Structure(zs, xyz), model=model,
                                  checkpoint=str(ckpt), device="cpu",
                                  dtype=torch.float64)
    assert "SURROGATE" not in capsys.readouterr().err
    assert calc.weights_source == f"checkpoint:{ckpt}"
    assert TU.last_weights_source() == calc.weights_source
    e_t = calc.get_energy(Structure(zs, xyz).coords_bohr.reshape(-1))[
        "energy"]
    # the PaiNN-class readout sums the atom energies in float32
    tol = F32_SUM if model == "small" else 1e-12
    assert abs(e_t - e_j) <= tol * abs(e_j)


@pytest.mark.parametrize("model", MODELS)
def test_port_tree_restores_in_jax(model, tmp_path, capsys):
    """The roundtrip twin: a calculator's parameters saved by the port
    come back in JAX bit for bit and give the port's calculator the same
    energy from another seed, with the checkpoint as its source and no
    surrogate warning."""
    pytest.importorskip("tensorstore")
    st = Structure(*molecule(5, seed=1))
    x = st.coords_bohr.reshape(-1)
    calc = TU.make_uma_calculator(st, model=model, seed=3, device="cpu")
    e_ref = calc.get_energy(x)["energy"]
    ckpt = tmp_path / "ckpt"
    TU.save_checkpoint(ckpt, calc.params)
    leaves_equal(calc.params, JU.load_checkpoint(ckpt))
    leaves_equal(calc.params, TU.load_checkpoint(ckpt))
    capsys.readouterr()
    calc2 = TU.make_uma_calculator(st, model=model, seed=99, device="cpu",
                                   checkpoint=str(ckpt))
    assert "SURROGATE" not in capsys.readouterr().err
    assert calc2.weights_source == f"checkpoint:{ckpt}"
    assert calc2.get_energy(x)["energy"] == pytest.approx(e_ref, rel=1e-10)


def test_ckpt_dir_is_picked_up(tmp_path, monkeypatch, capsys):
    pytest.importorskip("tensorstore")
    st = Structure(*molecule(5, seed=1))
    x = st.coords_bohr.reshape(-1)
    ref = TU.make_uma_calculator(st, model="escn-test", seed=4, device="cpu")
    TU.save_checkpoint(tmp_path / "escn-test", ref.params)
    monkeypatch.setenv("PDB2R_TPU_CKPT_DIR", str(tmp_path))
    capsys.readouterr()
    calc = TU.make_uma_calculator(st, model="escn-test", seed=0,
                                  device="cpu")
    assert "SURROGATE" not in capsys.readouterr().err
    assert calc.weights_source == f"ckpt_dir:{tmp_path / 'escn-test'}"
    assert TU.last_weights_source() == calc.weights_source
    assert calc.get_energy(x)["energy"] == ref.get_energy(x)["energy"]
    # a model without a tree there gets the surrogate
    calc = TU.make_uma_calculator(st, model="small", device="cpu")
    assert calc.weights_source.startswith("surrogate-seeded(")
    # params= wins over the directory
    calc = TU.make_uma_calculator(st, model="escn-test", device="cpu",
                                  params=ref.params)
    assert calc.weights_source == "given"


@pytest.mark.parametrize("model", MODELS)
def test_corrupt_tree(model, tmp_path, monkeypatch, capsys):
    """As in JAX: an explicit tree that does not restore raises
    RuntimeError; one under PDB2R_TPU_CKPT_DIR prints the warning and
    falls back to the surrogate."""
    pytest.importorskip("tensorstore")
    st = Structure(*molecule(5, seed=1))
    bad = tmp_path / model
    bad.mkdir()
    (bad / "_METADATA").write_text("{not json")
    with pytest.raises(RuntimeError, match="Failed to restore"):
        TU.make_uma_calculator(st, model=model, checkpoint=str(bad),
                               device="cpu")
    with pytest.raises(RuntimeError, match="Failed to restore"):
        TU.load_checkpoint(tmp_path / "missing", required=True)
    with pytest.raises(RuntimeError):
        JU.load_checkpoint(bad, required=True)
    monkeypatch.setenv("PDB2R_TPU_CKPT_DIR", str(tmp_path))
    capsys.readouterr()
    calc = TU.make_uma_calculator(st, model=model, device="cpu")
    out = capsys.readouterr()
    assert f"[uma] WARNING: checkpoint {bad} could not be restored" \
        in out.out and "falling back to surrogate weights" in out.out
    assert "SURROGATE" in out.err
    assert calc.weights_source.startswith("surrogate-seeded(")


def test_import_error_without_tensorstore(tmp_path, monkeypatch):
    st = Structure(*molecule(5, seed=1))
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    tree = tmp_path / "tree"
    for call in (lambda: TU.load_checkpoint(tree),
                 lambda: TU.load_checkpoint(tree, required=True),
                 lambda: TU.save_checkpoint(tree, {"a": torch.ones(2)}),
                 lambda: TU.make_uma_calculator(st, model="small",
                                                checkpoint=str(tree),
                                                device="cpu")):
        with pytest.raises(ImportError, match="tensorstore") as e:
            call()
        assert str(tree) in str(e.value)


def test_surrogate_warning_and_provenance(capsys):
    st = Structure(*molecule(5, seed=1))
    calc = TU.make_uma_calculator(st, model="small", seed=5, device="cpu")
    err = capsys.readouterr().err
    assert "SURROGATE" in err and "NOT chemically meaningful" in err
    assert calc.weights_source.startswith("surrogate-seeded(")
    assert TU.last_weights_source() == calc.weights_source


def test_train_params_roundtrip(tmp_path):
    """A train step's parameters (mlip/train.py) saved and read back, by
    the port and by JAX, and carried into a calculator."""
    pytest.importorskip("tensorstore")
    from pdb2reaction_tpu_torch.mlip import train as T
    cfg = ModelConfig(hidden=16, n_layers=2, n_radial=4, cutoff=4.0)
    params = init_params(cfg, seed=1)
    params["charge"] = torch.tensor(0.0)
    params["spin"] = torch.tensor(1.0)
    opt = T.adam(1e-2)
    state = opt.init(params)
    rng = np.random.default_rng(0)
    n = 4
    batch = T.TrainBatch(
        torch.as_tensor(rng.integers(1, 9, size=(2, n))),
        torch.as_tensor(rng.uniform(0, 3, size=(2, n, 3)), dtype=torch.float32),
        torch.ones(2, n), torch.zeros(2), torch.zeros(2, n, 3))
    params, state, _ = T.make_train_step(cfg, opt)(params, state, batch)
    ckpt = tmp_path / "trained"
    TU.save_checkpoint(ckpt, params)
    leaves_equal(params, TU.load_checkpoint(ckpt))
    leaves_equal(params, JU.load_checkpoint(ckpt))
    st = Structure(*molecule(5, seed=1))
    calc = TU.make_uma_calculator(
        st, model="small", checkpoint=str(ckpt), device="cpu",
        mp_mode="dense")
    assert calc.params["layers"][0]["upd_vv"].shape == (16, 16)
    torch.testing.assert_close(calc.params["layers"][0]["upd_vv"],
                               params["layers"][0]["upd_vv"], rtol=0,
                               atol=0)
    assert CONFIGS["small"].hidden != 16   # the tree's widths, not the name's
