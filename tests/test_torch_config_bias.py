"""The config machinery and the distance restraints of the port
(``workflows/config.py``, ``engines/bias.py``, ``opt --dist-freeze``)
against the JAX package's:

- ``deep_update`` and ``apply_yaml_overrides`` on the same inputs, and the
  twins of the ``tests/test_config_io.py`` config tests;
- the port's YAML subset reader against ``yaml.safe_load`` on
  ``examples/args.yaml``, on every YAML string that ``tests/test_cli.py``
  and ``tests/test_config_io.py`` write, and on hypothesis-generated
  nested mappings dumped by PyYAML; constructs outside the subset raise;
- ``make_biased_energy_fn`` energy and forces against JAX's on Morse to
  1e-12; the twin of ``test_biased_calculator_shifts_minimum``
  (``tests/test_rfo.py:63``), the targets swapped by assigning
  ``calc.params``;
- a biased escn-test calculator (float64, CPU): forces through the
  wrapped force path, and its analytic Hessian equal to the plain one
  plus the restraint's;
- ``opt --dist-freeze`` through both CLIs on the Morse H3 chain.
"""

import ast
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as hs

from pdb2reaction_tpu.engines.bias import bias_params as j_bias_params
from pdb2reaction_tpu.engines.bias import \
    make_biased_energy_fn as j_make_biased
from pdb2reaction_tpu.mlip import potentials as j_pot
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu.workflows import config as j_config
from pdb2reaction_tpu_torch import cli
from pdb2reaction_tpu_torch.constants import BOHR2ANG
from pdb2reaction_tpu_torch.core import io_xyz
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.engines.bias import (bias_params,
                                                 biased_calculator,
                                                 dist_freeze_pairs,
                                                 make_biased_energy_fn)
from pdb2reaction_tpu_torch.engines.lbfgs import lbfgs_minimize
from pdb2reaction_tpu_torch.mlip import potentials
from pdb2reaction_tpu_torch.mlip.calculator import Calculator
from pdb2reaction_tpu_torch.workflows.config import (
    apply_yaml_overrides, deep_update, format_elapsed, load_yaml_dict,
    normalize_choice, parse_bool, pretty_block, read_yaml)

REPO = Path(__file__).resolve().parents[1]
H3A = "3\nreactant\nH 0.0 0.0 0.0\nH 0.686 0.0 0.0\nH 2.4 0.0 0.0\n"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its host loops make
    thousands of small ops, and under the suite's parallel workers the
    idle-spinning thread pool of each op stalls on busy cores (the
    port's run_all of the fixture took 283 s beside seven busy cores,
    15 s with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# config machinery
# ---------------------------------------------------------------------------

def test_deep_update_nested():
    """Twin of tests/test_config_io.py:14."""
    base = {"a": {"b": 1, "c": 2}, "d": 3}
    deep_update(base, {"a": {"c": 9, "e": 4}})
    assert base == {"a": {"b": 1, "c": 9, "e": 4}, "d": 3}


def test_yaml_override_candidate_paths():
    """Twin of tests/test_config_io.py:20."""
    cfg = {"max_step": 0.3, "thresh": "gau"}
    y = {"opt": {"lbfgs": {"max_step": 0.1}}, "lbfgs": {"thresh": "baker"}}
    apply_yaml_overrides(cfg, y, [("opt", "lbfgs"), ("lbfgs",)])
    assert cfg["max_step"] == 0.1
    assert cfg["thresh"] == "baker"


@pytest.mark.parametrize("cfg,y,cands", [
    ({"a": {"b": 1}, "c": [1]}, {"a": {"b": {"x": 2}}, "c": [2]},
     [("a",), ("c",)]),
    ({"k": 1, "s": {"t": {"u": 1}}}, {"s": {"t": {"v": 2}, "w": 3},
                                      "k": {"z": 1}},
     [("k",), ("s",), ("s", "t"), ("missing", "x")]),
    ({"thresh": "gau"}, {"opt": {"thresh": "baker"},
                         "lbfgs": {"thresh": "never", "keep_last": 3}},
     [("opt",), ("lbfgs",), ("rfo",)]),
])
def test_deep_update_and_overrides_match_jax(cfg, y, cands):
    import copy
    a, b = copy.deepcopy(cfg), copy.deepcopy(cfg)
    assert apply_yaml_overrides(a, y, cands) == \
        j_config.apply_yaml_overrides(b, y, cands)
    a, b = copy.deepcopy(cfg), copy.deepcopy(cfg)
    assert deep_update(a, y) == j_config.deep_update(b, y)


def test_normalize_choice_aliases():
    """Twin of tests/test_config_io.py:28."""
    assert normalize_choice("light") == "lbfgs"
    assert normalize_choice("HEAVY") == "rfo"
    with pytest.raises(ValueError):
        normalize_choice("bogus", choices=("lbfgs", "rfo"))


def test_parse_bool_strict():
    """Twin of tests/test_config_io.py:35."""
    assert parse_bool("True") and parse_bool("true") and parse_bool("1")
    assert not parse_bool("False") and not parse_bool("off")
    with pytest.raises(ValueError):
        parse_bool("maybe")


def test_pretty_block_and_elapsed():
    """Twin of tests/test_config_io.py:42; nested mappings echo as YAML
    would show them."""
    s = pretty_block("opt settings", {"thresh": "gau", "n": 3})
    assert "opt settings" in s and "thresh: gau" in s
    assert format_elapsed(0.0, 3723.5) == "01:02:03.500"
    cfg = {"search": {"opt_mode": "rfo", "preopt": False, "x": None},
           "gs": {"max_nodes": 7}, "inputs": ["a", "b"], "empty": {}}
    s = pretty_block("t", cfg)
    assert "  opt_mode: rfo\n  preopt: false\n  x: null\n" in s
    assert "inputs:\n  - a\n  - b\n" in s and "empty: {}\n" in s
    del cfg["empty"]            # '{}' is a flow mapping: outside the subset
    body = pretty_block("t", cfg).split("--------\n")[-1]
    assert read_yaml(body) == yaml.safe_load(body) == cfg


# ---------------------------------------------------------------------------
# the YAML subset reader
# ---------------------------------------------------------------------------

def _yaml_strings_written_by(path):
    """Every string literal a test writes into a file named ``y``."""
    out = []
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "write_text"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "y"):
            out.append(ast.literal_eval(node.args[0]))
    return out


def test_reader_matches_safe_load_on_the_repo_yaml(tmp_path):
    texts = [(REPO / "examples" / "args.yaml").read_text()]
    for f in ("test_cli.py", "test_config_io.py"):
        texts += _yaml_strings_written_by(REPO / "tests" / f)
    assert len(texts) == 3
    for t in texts:
        assert read_yaml(t) == yaml.safe_load(t)
        p = tmp_path / "a.yaml"
        p.write_text(t)
        assert load_yaml_dict(p) == j_config.load_yaml_dict(p)


SUBSET = """\
# a comment line
top:
  int: 12
  neg: -3
  under: 1_000
  float: 1.5
  exp: 1.0e-05
  bare_exp: 1e-5
  inf: -.inf
  bools: [yes, No, ON, off, True, FALSE]
  nulls: [~, null, Null]
  empty:
  quoted: 'it''s # not a comment'
  dq: "tab\\there \\"q\\" back\\\\slash\\nline"
  url: http://x.y/z#frag    # comment
  colon: a:b
  list:
  - 1
  - two: 2
    three: [3, [4, '5']]
  - - nested
    - [ ]
  same_indent:
  - a
  - b
other: value with spaces
"""


def test_reader_subset_constructs():
    assert read_yaml(SUBSET) == yaml.safe_load(SUBSET)
    assert math.isnan(read_yaml("x: .nan")["x"])
    assert read_yaml("") is None and read_yaml("# only\n\n") is None


@pytest.mark.parametrize("text,said", [
    ("a: &x 1\nb: *x\n", "anchors"),
    ("a: !!str 1\n", "tags"),
    ("a: 1\n---\nb: 2\n", "multi-document"),
    ("%YAML 1.2\n---\na: 1\n", "directives"),
    ("a: |\n  text\n", "block scalars"),
    ("a: >\n  text\n", "block scalars"),
    ("a: {b: 1}\n", "flow mappings"),
    ("a: [b: 1]\n", "flow mappings"),
    ("? complex\n: key\n", "complex keys"),
    ("<<: {a: 1}\n", "merge keys"),
    ("a: plain\n  continued\n", "multi-line"),
    ("a: [1,\n  2]\n", "multi-line flow"),
    ("a: 'open\n  close'\n", "multi-line quoted"),
    ("a:\n\tb: 1\n", "tab"),
    ("a: 0x1f\n", "hexadecimal"),
    ("a: 0o17\n", None),
    ("a: 017\n", "octal"),
    ("a: 1:30\n", "sexagesimal"),
    ("a: 2024-01-02\n", "timestamp"),
    ('a: "caf\\u00e9"\n', "escape"),
    ('a: "\\x41"\n', "escape"),
])
def test_reader_refuses_outside_the_subset(text, said):
    if said is None:            # PyYAML 1.1 reads 0o17 as a string
        assert read_yaml(text) == yaml.safe_load(text)
        return
    with pytest.raises(ValueError, match=said):
        read_yaml(text)


_key = hs.from_regex(r"[a-z][a-z0-9_]{0,7}", fullmatch=True)
_text = hs.text(alphabet="abcxyzABC019 _-.:#'\"/", min_size=0, max_size=12)
_scalar = (hs.none() | hs.booleans() | hs.integers(-10**9, 10**9)
           | hs.floats(allow_nan=False, width=64) | _text)
_value = hs.recursive(
    _scalar,
    lambda kids: (hs.lists(kids, min_size=1, max_size=4)
                  | hs.dictionaries(_key, kids, min_size=1, max_size=4)),
    max_leaves=12)


@settings(max_examples=150, deadline=None)
@given(doc=hs.dictionaries(_key, _value, min_size=1, max_size=5),
       flow=hs.booleans())
def test_reader_matches_safe_load_on_generated_mappings(doc, flow):
    """Nested mappings of the subset's values, dumped by PyYAML in block
    style (lists of scalars optionally in flow style)."""
    text = yaml.safe_dump(doc, default_flow_style=None if flow else False,
                          width=10 ** 6, sort_keys=False)
    if "{" in text:             # PyYAML chose a flow mapping: outside
        with pytest.raises(ValueError, match="flow mappings"):
            read_yaml(text)
        return
    assert read_yaml(text) == yaml.safe_load(text) == doc


# ---------------------------------------------------------------------------
# the restraints
# ---------------------------------------------------------------------------

PAIRS = [(0, 1), (2, 4), (1, 3)]


def _cluster(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=1.2, size=(n, 3))


@pytest.mark.parametrize("k", [10.0, [5.0, 50.0, 0.5]])
def test_biased_energy_and_forces_match_jax(k):
    xyz = _cluster()
    st = Structure.from_symbols(["H", "C", "O", "H", "N"], xyz)
    targets = [1.1, 1.9, 0.7]
    calc = Calculator(st, make_biased_energy_fn(potentials.make_morse(),
                                                PAIRS),
                      params=bias_params(targets, k), device="cpu")
    from pdb2reaction_tpu.core.structure import Structure as JStructure
    jst = JStructure(st.numbers, xyz)
    jcalc = JCalculator(jst, j_make_biased(j_pot.make_morse(), PAIRS),
                        params=j_bias_params(targets, k))
    for shift in (0.0, 0.3):
        cb = (xyz + shift).reshape(-1) / BOHR2ANG
        r, jr = calc.get_forces(cb), jcalc.get_forces(cb)
        assert abs(r["energy"] - float(jr["energy"])) <= 1e-12 * max(
            1.0, abs(float(jr["energy"])))
        np.testing.assert_allclose(r["forces"], np.asarray(jr["forces"]),
                                   rtol=0, atol=1e-12)
    assert dist_freeze_pairs(xyz, PAIRS) == pytest.approx(
        [float(np.linalg.norm(xyz[i] - xyz[j])) for i, j in PAIRS],
        abs=0)


def test_biased_calculator_shifts_minimum():
    """Twin of tests/test_rfo.py:63."""
    st = Structure.from_symbols(["H", "H"], [[0, 0, 0], [0.9, 0, 0]])
    target = 1.2
    fn_biased = make_biased_energy_fn(potentials.make_morse(), [(0, 1)])
    calc = Calculator(st, fn_biased, params=bias_params([target], 20.0),
                      device="cpu")
    res = lbfgs_minimize(calc.au_energy_force_fn(),
                         calc.pad_bohr(st.coords_bohr),
                         calc.system.free_mask,
                         thresh="gau_tight", max_cycles=300)
    x = calc.unpad(res.x) * BOHR2ANG
    d = np.linalg.norm(x[1] - x[0])
    assert 0.64 < d < target
    calc.params = bias_params([target], 500.0)
    res2 = lbfgs_minimize(calc.au_energy_force_fn(),
                          calc.pad_bohr(st.coords_bohr),
                          calc.system.free_mask,
                          thresh="gau_tight", max_cycles=300)
    x2 = calc.unpad(res2.x) * BOHR2ANG
    d2 = np.linalg.norm(x2[1] - x2[0])
    assert abs(d2 - target) < abs(d - target)


def test_biased_escn_hessian_is_plain_plus_restraint():
    """escn-test in float64 on the CPU: the biased calculator wraps both
    closures; its forces are the plain forces plus the restraint's, and
    its analytic Hessian (through the wrapped all-plain closure) the
    plain Hessian plus the restraint's, to 1e-10."""
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    rng = np.random.default_rng(4)
    zs = rng.choice([1, 6, 8], size=7).astype(np.int32)
    st = Structure(zs, rng.normal(scale=1.4, size=(7, 3)), freeze=[6])
    base = make_uma_calculator(st, model="escn-test", device="cpu", seed=0,
                               dtype=torch.float64, freeze_atoms=[6])
    assert base.energy_fn_hessian is not None
    pairs, targets, k = [(0, 1), (2, 5)], [1.0, 2.2], 30.0
    calc = biased_calculator(base, pairs, targets, k)
    assert calc.energy_fn_hessian is not None
    assert calc.energy_fn_hessian is not calc.energy_fn
    assert calc.n_pad == base.n_pad and calc.free_dof_mask.sum() == 18
    alone = Calculator(st, make_biased_energy_fn(lambda c, s, p: 0.0 * c.sum(),
                                                 pairs),
                       params=bias_params(targets, k), freeze_atoms=[6],
                       device="cpu")
    cb = st.coords_bohr.reshape(-1)
    f = calc.get_forces(cb)["forces"]
    np.testing.assert_allclose(
        f, base.get_forces(cb)["forces"] + alone.get_forces(cb)["forces"],
        rtol=0, atol=1e-10)
    H = calc.get_hessian(cb)["hessian"]
    H0 = base.get_hessian(cb)["hessian"]
    Hb = alone.get_hessian(cb)["hessian"]
    np.testing.assert_allclose(H, H0 + Hb, rtol=0, atol=1e-10)
    assert np.abs(Hb).max() > 0.1
    # the targets swap without a rebuild
    calc.params = bias_params([1.5, 1.5], k, base.params)
    alone.params = bias_params([1.5, 1.5], k)
    np.testing.assert_allclose(
        calc.get_forces(cb)["forces"],
        base.get_forces(cb)["forces"] + alone.get_forces(cb)["forces"],
        rtol=0, atol=1e-10)


def test_opt_dist_freeze_cli_matches_jax(tmp_path, monkeypatch):
    """``opt --dist-freeze 1,2 --bias-k 25`` (1-based) on the Morse H3
    chain through both CLIs: the same final geometry."""
    from click.testing import CliRunner
    from pdb2reaction_tpu.cli import cli as jcli
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    flags = ["--dist-freeze", "1,2", "--bias-k", "25.0", "-q", "0",
             "--calc-mode", "morse", "--freeze-atoms", "0,2",
             "--thresh", "gau_tight"]
    r = CliRunner().invoke(jcli, ["opt", "-i", str(a), "--out-dir",
                                  str(tmp_path / "j")] + flags)
    assert r.exit_code == 0, r.output
    monkeypatch.setattr(sys, "argv", ["pdb2r-torch"])
    with pytest.raises(SystemExit) as e:
        cli.main(["opt", "-i", str(a), "--out-dir", str(tmp_path / "p"),
                  "--device", "cpu"] + flags)
    assert e.value.code == 0
    xj = io_xyz.read_xyz(tmp_path / "j" / "final_geometry.xyz").coords
    xp = io_xyz.read_xyz(tmp_path / "p" / "final_geometry.xyz").coords
    np.testing.assert_allclose(xp, xj, rtol=0, atol=1e-6)
    # the restrained pair stays near its start, 0.686 A, not Morse's 0.70
    d0 = np.linalg.norm(xp[1] - xp[0])
    assert abs(d0 - 0.686) < abs(0.7046 - 0.686)
