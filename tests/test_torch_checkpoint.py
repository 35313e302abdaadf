"""Port ``runtime/checkpoint.py`` against the JAX package's:

- the store's round trip, and ``content_key``'s sensitivity to a value,
  to ``extra``, to the shape and to the split across arguments (twins of
  ``tests/test_checkpoint.py``);
- ``content_key`` equal to the JAX package's, byte for byte, on the same
  seeded arrays (and on tensors of them), so a memo written by one
  package is found by the other;
- ``save_state`` / ``load_state`` of a NamedTuple state, with the key
  guard;
- resume through the port's ``path-search`` CLI on Morse H3: the second
  run in the same ``--out-dir`` restores its segments from the memo and
  says "restored from checkpoint"."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from pdb2reaction_tpu.runtime import checkpoint as j_ck
from pdb2reaction_tpu_torch import cli
from pdb2reaction_tpu_torch.runtime.checkpoint import (CheckpointStore,
                                                       content_key,
                                                       load_state,
                                                       save_state)

H3A = "3\nreactant\nH 0.0 0.0 0.0\nH 0.686 0.0 0.0\nH 2.4 0.0 0.0\n"
H3B = "3\nproduct\nH 0.0 0.0 0.0\nH 1.714 0.0 0.0\nH 2.4 0.0 0.0\n"
COMMON = ["-q", "0", "--calc-mode", "morse", "--freeze-atoms", "0,2",
          "--device", "cpu"]


def test_store_roundtrip(tmp_path):
    store = CheckpointStore(tmp_path / "ck")
    meta = {"energies": [1.0, 2.0], "hei_idx": 1}
    arrays = {"images": np.arange(12.0).reshape(2, 2, 3)}
    store.save("seg_a", meta, arrays)
    assert store.has("seg_a")
    m, a = store.load("seg_a")
    assert m["hei_idx"] == 1
    np.testing.assert_allclose(a["images"], arrays["images"])
    # the JAX package's store reads what the port's wrote
    mj, aj = j_ck.CheckpointStore(tmp_path / "ck").load("seg_a")
    assert mj == m
    np.testing.assert_array_equal(aj["images"], a["images"])
    store.delete("seg_a")
    assert not store.has("seg_a")
    assert store.load("missing") is None


def test_content_key_sensitivity():
    a = np.zeros((3, 3))
    b = a.copy()
    b[0, 0] = 1e-9
    assert content_key(a) == content_key(a.copy())
    assert content_key(a) != content_key(b)
    assert content_key(a, extra="gsm") != content_key(a, extra="dmf")


def test_content_key_shape_and_split_sensitivity():
    a = np.arange(12, dtype=float)
    assert content_key(a) != content_key(a.reshape(3, 4))
    assert content_key(a[:6], a[6:]) != content_key(a[:4], a[4:])


@pytest.mark.parametrize("shapes,extra", [
    ([(3, 3)], ""), ([(3, 3), (3, 3)], "gsm"), ([(12,), (5, 3)], "dmf"),
    ([(300, 3), (300, 3)], "gsm"), ([(2, 4, 3)], "x"), ([()], "")])
def test_content_key_matches_jax(shapes, extra):
    """Equal to the JAX package's key on the same seeded arrays: as
    float64 and float32 arrays, and as tensors."""
    rng = np.random.default_rng(len(shapes) + len(extra))
    arrays = [rng.normal(size=s) for s in shapes]
    want = j_ck.content_key(*arrays, extra=extra)
    assert content_key(*arrays, extra=extra) == want
    assert len(want) == 16
    assert content_key(*[torch.as_tensor(a) for a in arrays],
                       extra=extra) == want
    a32 = [a.astype(np.float32) for a in arrays]
    assert content_key(*a32, extra=extra) == j_ck.content_key(*a32,
                                                              extra=extra)


class _State(NamedTuple):
    x: torch.Tensor
    k: torch.Tensor


def test_save_load_state_roundtrip_and_key_guard(tmp_path):
    store = CheckpointStore(tmp_path / "ck")
    st = _State(x=torch.arange(6.0, dtype=torch.float64).reshape(2, 3),
                k=torch.tensor(4))
    save_state(store, "lbfgs", st, meta={"key": "abc"})
    meta, back = load_state(store, "lbfgs", _State, expect_key="abc")
    assert meta["key"] == "abc"
    assert torch.equal(back.x, st.x) and int(back.k) == 4
    assert load_state(store, "lbfgs", _State, expect_key="other") is None
    assert load_state(store, "missing", _State) is None


def test_path_search_cli_resumes_from_memo(tmp_path, capsys):
    a = tmp_path / "A.xyz"
    b = tmp_path / "B.xyz"
    a.write_text(H3A)
    b.write_text(H3B)
    out = tmp_path / "ps"
    args = ["path-search", "-i", str(a), "-i", str(b), "--max-nodes", "6",
            "--out-dir", str(out)] + COMMON
    for run in range(2):
        with pytest.raises(SystemExit) as e:
            cli.main(args)
        assert e.value.code == 0
        said = capsys.readouterr().out
        if run == 0:
            assert any((out / "checkpoint").glob("mep_*.json"))
            assert "restored from checkpoint" not in said
            assert ", 2 MEPs run" in said
    # the second run resumes the completed segments from the memo
    assert "restored from checkpoint" in said
    assert ", 0 MEPs run" in said
