"""The build key of the hand-written kernels (``cuda_build._target``): an
edited source or an edited header of ``csrc/`` must name a new library,
or a stale one would be loaded. Runs on the CPU; nothing is compiled."""

import shutil

import pytest

from pdb2reaction_tpu_torch.mlip import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that cuda_build reads instead of the package's."""
    dst = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, dst)
    monkeypatch.setattr(cuda_build, "CSRC", dst)
    return dst


@pytest.mark.parametrize("name", ["escn_edge", "escn_ffn",
                                  "radial_contract"])
def test_edited_header_names_a_new_library(csrc, name):
    before = cuda_build._target(name)
    assert before == cuda_build._target(name)          # stable
    hdr = csrc / "tf32_mma.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert cuda_build._target(name) != before


def test_edited_source_names_a_new_library(csrc):
    before = {n: cuda_build._target(n) for n in ("escn_edge", "escn_ffn")}
    src = csrc / "escn_edge.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda_build._target("escn_edge") != before["escn_edge"]
    assert cuda_build._target("escn_ffn") == before["escn_ffn"]


def test_sources_include_only_headers_of_csrc():
    """Every quoted include of a source is a header in csrc/, so the key
    covers it."""
    for src in cuda_build.CSRC.glob("*.cu"):
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                assert (cuda_build.CSRC / line.split('"')[1]).is_file()
