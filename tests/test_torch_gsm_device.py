"""The port's GSM device loop (``gsm_mep(loop="device")``,
``engines/gsm.py`` ``make_device_growth`` / ``make_device_relax`` on
``runtime/device_loop.py``) on the CPU, where a cycle is the eager masked
cycle, in float64:

- (a) against the JAX package's ``loop="device"`` on the Morse H3 double
  well with the climbing image and Lanczos tangents, at ``max_nodes`` 9
  and 8 (the mirror-image rule of ``tests/test_torch_gsm.py``): equal
  ``converged``, ``cycles``, ``force_calls`` and ``hei_idx``, images to
  1e-7 Bohr, energies to 1e-9 Hartree;
- (b) against the port's host loop: the same fields, and the images bit
  for bit equal (the device loop starts from the string as given, as both
  host loops do, and runs the same step);
- (c) the grown-only string of the Mueller-Brown curved valley through
  ``make_device_growth`` against JAX's within 1e-7 Bohr, and JAX's bound:
  the relaxed string lies closer to the dense MEP than the grown one;
- (d) the masked cycle: a loop driven a cycle past its stop, and the
  relaxation's cycle without the Lanczos tangent after ``climb_on`` is
  set, leave the state bit for bit unchanged;
- (e) the calculator's ``force_calls`` rises by exactly ``res.force_calls``;
  a warm-up counts nothing, a capture counts once per cycle that took
  effect (``device_loop.per_cycle``);
- (f) ``gsm_loop_default``: "device" for the ``small`` PaiNN model and the
  base ``Calculator``, "host" for ``escn-test`` (the twin of
  ``tests/test_cli.py:312-321``); (g) an unknown ``loop`` raises;
- (h) an escn-test string through ``loop="device"`` against JAX's host
  loop, which JAX holds equal to its device loop: the port's default
  loop in ``tests/test_torch_gsm.py::test_gsm_escn_string_climbs_like_jax``;
- (i) K5's fixed-capacity tile plan (``tile_plan_fixed``) lists exactly
  ``tile_plan``'s tile pairs, and the numpy mirror of the coordinate
  kernel, whose blocks past the count exit, gives the old plan's sums bit
  for bit; ``eigh_jacobi`` against ``torch.linalg.eigh``;
- the CLIs: ``path-opt --gsm-loop device`` against ``--gsm-loop host``
  and JAX's CLI, ``path-search`` and ``all`` with ``--gsm-loop device``,
  and ``"auto"`` following the calculator."""

import numpy as np
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.engines.gsm import gsm_mep as j_gsm
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu_torch.constants import ANG2BOHR, BOHR2ANG
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.engines import gsm as G
from pdb2reaction_tpu_torch.mlip import potentials
from pdb2reaction_tpu_torch.mlip import radial_contract as rcm
from pdb2reaction_tpu_torch.mlip.calculator import Calculator
from pdb2reaction_tpu_torch.runtime import device_loop

from test_torch_gsm import H3_A, H3_B, MB, _h3, _mb_energy, _mb_grad, \
    _mb_hess, _mirror_h3

XA = np.asarray(H3_A, float) * ANG2BOHR
XB = H3_B * ANG2BOHR


def _port(tc, loop, **kw):
    return G.gsm_mep(tc.au_energy_force_batch_fn(), tc.pad_bohr(XA),
                     tc.pad_bohr(XB), tc.system.free_mask,
                     hvp_fn=tc.au_hvp_fn(), loop=loop, **kw)


@pytest.mark.parametrize("max_nodes", [9, 8])
def test_device_loop_matches_jax_device_and_port_host(max_nodes):
    """(a), (b), (e)."""
    kw = dict(max_nodes=max_nodes, max_cycles=300, conv_perp_rms=5e-4,
              climb=True)
    jc, tc = _h3()
    rj = j_gsm(jc.au_energy_force_batch_fn(), jc.pad_bohr(XA),
               jc.pad_bohr(XB), jc.system.free_mask, loop="device",
               hvp_fn=jc.au_hvp_fn(), **kw)
    rd = _port(tc, "device", **kw)
    assert tc.force_calls == rd.force_calls                        # (e)
    M = max_nodes + 2
    assert rd.converged and rj.converged
    assert rd.cycles == rj.cycles
    assert rd.force_calls == rj.force_calls == (rd.cycles + 1) * M
    ji, je = np.asarray(rj.images), np.asarray(rj.energies)
    if max_nodes % 2:
        assert rd.hei_idx == rj.hei_idx
        ti, te = rd.images, rd.energies
    else:
        # the two middle images tie to the last bit: which one climbs is
        # decided by rounding, and XLA and PyTorch round apart
        assert rd.hei_idx == M - 1 - rj.hei_idx
        ti, te = _mirror_h3(rd.images), rd.energies[::-1]
    assert np.abs(ti[:, :3] - ji[:, :3]).max() <= 1e-7
    assert np.abs(te - je).max() <= 1e-9
    # (b): the host loop, bit for bit
    _, th = _h3()
    rh = _port(th, "host", **kw)
    assert (rh.converged, rh.cycles, rh.force_calls, rh.hei_idx) == \
        (rd.converged, rd.cycles, rd.force_calls, rd.hei_idx)
    assert np.abs(rh.images - rd.images).max() <= 1e-12
    assert np.array_equal(rh.images, rd.images)
    assert np.array_equal(rh.energies, rd.energies)


def test_grown_string_matches_jax_and_relax_repairs_it():
    """(c): the grown-only half of ``tests/test_gsm.py``'s curved-valley
    test through the port's ``make_device_growth``."""
    import jax.numpy as jnp
    from pdb2reaction_tpu.engines.gsm import _interp_linear
    from pdb2reaction_tpu.engines.gsm import make_device_growth as j_growth

    def j_efn(coords, system):
        dx = coords[0, 0] - jnp.asarray(MB["x0"])
        dy = coords[0, 1] - jnp.asarray(MB["y0"])
        e = MB["S"] * jnp.sum(jnp.asarray(MB["A"]) * jnp.exp(
            jnp.asarray(MB["a"]) * dx ** 2 + jnp.asarray(MB["b"]) * dx * dy
            + jnp.asarray(MB["c"]) * dy ** 2))
        return e + 0.5 * MB["S"] * coords[0, 2] ** 2

    def newton(p):
        p = np.array(p, float)
        for _ in range(30):
            p = p - np.linalg.solve(_mb_hess(p), _mb_grad(p))
        return p

    mA, mB, sad = (newton(p) for p in ([-0.05, 0.47], [-0.56, 1.44],
                                       [-0.822, 0.624]))
    stA = Structure.from_symbols(["H"], [[mA[0], mA[1], 0.0]])
    stB = Structure.from_symbols(["H"], [[mB[0], mB[1], 0.0]])
    calc = Calculator(stA, _mb_energy, device="cpu")
    x0, x1 = calc.pad_bohr(stA.coords_bohr), calc.pad_bohr(stB.coords_bohr)
    fb = calc.au_energy_force_batch_fn()
    grow = G.make_device_growth(fb, calc.system.free_mask.double(), 0.1,
                                "global", 2e-3, 10, True)
    imgs_g, nl, nr, g, _ = grow(G._interp_linear(x0, x1, 14), 1, 1, 600)
    assert int(nl + nr) == 12 and 0 < int(g) < 600
    jst = JStructure.from_symbols(["H"], [[mA[0], mA[1], 0.0]])
    jc = JCalculator(jst, j_efn)
    jg = j_growth(jc.au_energy_force_batch_fn(),
                  jnp.asarray(jc.system.free_mask), 0.1, "global", 2e-3, 10,
                  True)
    ji, jnl, jnr, jcyc, _ = jg(_interp_linear(jnp.asarray(x0.numpy()),
                                              jnp.asarray(x1.numpy()), 14),
                               jnp.asarray(1), jnp.asarray(1),
                               jnp.asarray(600))
    assert int(g) == int(jcyc) and int(nl) == int(jnl)
    assert np.abs(imgs_g.numpy() - np.asarray(ji)).max() <= 1e-7
    res = G.gsm_mep(fb, x0, x1, calc.system.free_mask, max_nodes=12,
                    max_cycles=600, stop_in_when_full=600,
                    conv_perp_rms=4e-4, perp_thresh=2e-3, climb=True,
                    hvp_fn=calc.au_hvp_fn(), loop="device")
    assert res.converged
    pts = res.images[:, 0, :2] * BOHR2ANG
    pts_g = imgs_g.numpy()[:, 0, :2] * BOHR2ANG
    assert np.linalg.norm(pts[res.hei_idx] - sad) < 0.02
    w, V = np.linalg.eigh(_mb_hess(sad))

    def dense(sign, ds=2e-4):
        q = sad + sign * 1e-3 * V[:, 0]
        out = [q.copy()]
        for _ in range(40000):
            gr = _mb_grad(q)
            if np.linalg.norm(gr) < 1e-4:
                break
            q = q - ds * gr / np.linalg.norm(gr)
            out.append(q.copy())
        return np.array(out)

    ref = np.vstack([dense(1.0), dense(-1.0), sad[None]])

    def maxdev(p):
        return np.sqrt(((p[:, None, :] - ref[None, :, :]) ** 2)
                       .sum(-1)).min(1).max()

    assert maxdev(pts) < 0.06
    assert maxdev(pts) < maxdev(pts_g)


def test_masked_cycle_past_the_stop_is_a_no_op():
    """(d): ``device_loop`` cycles run with the condition false, and the
    relaxation's no-Lanczos cycle once ``climb_on`` is set, change no
    bit of the state."""
    st = (torch.arange(5.0, dtype=torch.float64), torch.tensor(3))

    def cond(s):
        return s[1] < 3

    def body(s):
        return (s[0] * 1.5 + 1.0, s[1] + 1)

    new = device_loop._masked(cond, body, st)
    assert all(torch.equal(a, b) for a, b in zip(new, st))
    out = device_loop.while_loop(lambda s: s[1] < 7, body,
                                 (st[0], torch.tensor(0)))
    assert int(out[1]) == 7
    # past the stop: the loop's own cycle
    again = device_loop._masked(lambda s: s[1] < 7, body, out)
    assert all(torch.equal(a, b) for a, b in zip(again, out))
    # the relaxation's cycle without Lanczos after climb_on is set
    _, tc = _h3()
    fm = tc.system.free_mask.double()
    step = G.make_macro_step(tc.au_energy_force_batch_fn(), fm, 0.1,
                             "global")
    images = G._interp_linear(tc.pad_bohr(XA), tc.pad_bohr(XB), 8)
    E0, _ = tc.au_energy_force_batch_fn()(images)
    cond, body = G._relax_cycle(step, 8, images.shape[1], True, 5e-4, 5e-4,
                                None, 10, fm.repeat_interleave(3))
    s = (images, torch.tensor(4), torch.tensor(True), torch.tensor(False),
         E0, torch.tensor(1e-2, dtype=torch.float64), torch.tensor(300))
    n0 = tc.force_calls
    new = device_loop._masked(lambda q: cond(q) & ~q[2], body, s)
    assert all(torch.equal(a, b) for a, b in zip(new, s))
    assert tc.force_calls == n0 + 8           # eager: the body ran
    # and the loop's flags stop it before any cycle
    cyc = device_loop.Cycle(lambda q: cond(q) & ~q[2], body,
                            tuple(t.clone() for t in s))
    assert cyc.run() == (0, [False])


def test_force_calls_count_once_per_cycle_that_took_effect():
    """(e): the batched closure counts through ``per_cycle``: at once
    outside a capture, nothing at a warm-up, and after a capture once
    for each cycle that took effect."""
    _, tc = _h3()
    eb = tc.au_energy_force_batch_fn()
    x = G._interp_linear(tc.pad_bohr(XA), tc.pad_bohr(XB), 5)
    eb(x)
    assert tc.force_calls == 5
    with device_loop._mode("warm"):
        eb(x)
    assert tc.force_calls == 5
    hooks = []
    with device_loop._mode("capture", hooks):
        eb(x)
    assert tc.force_calls == 5 and len(hooks) == 1
    hooks[0](3)
    assert tc.force_calls == 20
    for n, loop in enumerate(("device", "host")):
        _, c = _h3()
        r = _port(c, loop, max_nodes=4, max_cycles=12, stop_in_when_full=2,
                  conv_perp_rms=5e-4)
        assert c.force_calls == r.force_calls == (r.cycles + 1) * 6


def test_gsm_loop_default_follows_the_calculator():
    """(f), (g)."""
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    st = Structure(np.array([1, 1, 1], np.int32),
                   np.array([[0.0, 0, 0], [0.9, 0, 0], [1.8, 0, 0]]))
    assert make_uma_calculator(st, model="small", device="cpu") \
        .gsm_loop_default == "device"
    assert Calculator(st, potentials.make_morse(), device="cpu") \
        .gsm_loop_default == "device"
    assert make_uma_calculator(st, model="escn-test", device="cpu") \
        .gsm_loop_default == "host"
    _, tc = _h3()
    with pytest.raises(ValueError, match="loop='while'"):
        _port(tc, "while", max_nodes=4)
    with pytest.raises(ValueError, match="on_cycle"):
        _port(tc, "device", max_nodes=4, on_cycle=lambda c, r: None)


@pytest.mark.parametrize("n", [10, 7, 3])
def test_eigh_jacobi_matches_eigh(n):
    """The Lanczos eigensolver a graph can hold, against
    ``torch.linalg.eigh``, on tridiagonal matrices like Lanczos's: random,
    and with the decoupled 1e6 rows of a Krylov breakdown."""
    g = torch.Generator().manual_seed(n)
    a = torch.randn(n, generator=g, dtype=torch.float64)
    b = torch.randn(n - 1, generator=g, dtype=torch.float64)
    if n == 7:
        a[4:], b[3:] = 1e6, 0.0
    T = torch.diag(a) + torch.diag(b, 1) + torch.diag(b, -1)
    w, U = G.eigh_jacobi(T)
    w2, U2 = torch.linalg.eigh(T)
    assert torch.allclose(torch.sort(w).values, w2, rtol=0,
                          atol=1e-13 * float(w2.abs().max()))
    u = U[:, int(torch.argmin(w))]
    assert abs(abs(float(u @ U2[:, 0])) - 1.0) <= 1e-13
    assert torch.allclose(U.T @ U, torch.eye(n, dtype=torch.float64),
                          atol=1e-14)


def _system(P, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 16.0, (P, 3))
    m = (rng.uniform(size=P) > 0.1).astype(np.float32)
    return x, m


def _coords_mirror(plan, x, m, feats, g, rc, R, n_live=None):
    """csrc/radial_contract.cu:rc_coords_pairs + rc_coords_reduce in numpy
    on ``plan``: block b takes pairs[b] unless b >= n_live (it exits);
    its I side's sums go to slot e_IJ, off the diagonal its J side's to
    e_JI; each atom sums its tile's slots in reach-list order."""
    from test_torch_radial_contract import _ladder
    P = x.shape[0]
    perm = plan.perm.numpy().astype(np.int64)
    Pp = plan.n_tiles * rcm.TILE
    T = rcm.TILE

    def padded(a):
        out = np.zeros((Pp,) + a.shape[1:])
        out[:P] = a[perm]
        return out

    xs, ms, fs, gs = padded(x), padded(m), padded(feats), padded(g)
    idx = np.arange(Pp)
    part = np.full((plan.cols.shape[0], T, 3), np.nan)
    for b, (I, J, e_ij, e_ji) in enumerate(plan.pairs.numpy()):
        if n_live is not None and b >= n_live:
            continue
        a_, b_ = slice(I * T, (I + 1) * T), slice(J * T, (J + 1) * T)
        Ssym = (np.einsum("irf,jf->rij", gs[a_], fs[b_])
                + np.einsum("jrf,if->rij", gs[b_], fs[a_]))
        diff = xs[a_][:, None, :] - xs[b_][None, :, :]
        pair = ((idx[a_][:, None] != idx[b_][None, :])
                & (ms[a_][:, None] > 0) & (ms[b_][None, :] > 0))
        Gm, inv = _ladder(diff, pair, Ssym, rc, R, False)
        wd = (Gm * inv)[:, :, None] * diff
        part[e_ij] = wd.sum(1)
        if I != J:
            part[e_ji] = -wd.sum(0)
    rp = plan.row_ptr.numpy()
    dx = np.zeros((Pp, 3))
    for I in range(plan.n_tiles):
        for e in range(rp[I], rp[I + 1]):
            dx[I * T:(I + 1) * T] += part[e]
    out = np.zeros((P, 3))
    out[perm] = dx[:P]
    return out


@pytest.mark.parametrize("P,seed", [(300, 0), (97, 1), (640, 2), (33, 3)])
def test_fixed_tile_plan_lists_tile_plans_pairs(P, seed):
    """(i): the fixed-capacity plan holds ``tile_plan``'s order, boxes,
    CSR and listed pairs in the same slots, its count on the device, and
    -1 in every empty slot; the coordinate kernel's mirror on it, its
    blocks past the count exiting, sums bit for bit as on the old plan
    and agrees with autograd through the plain version."""
    x, m = _system(P, seed)
    xt, mt = torch.tensor(x, dtype=torch.float32), torch.tensor(m)
    old = rcm.tile_plan(xt, mt, 5.0)
    new = rcm.tile_plan_fixed(xt, mt, 5.0)
    T = old.n_tiles
    for f in ("perm", "xm", "lo", "hi", "row_ptr"):
        assert torch.equal(getattr(old, f), getattr(new, f)), f
    n = int(new.n_upper[0])
    nnz = int(old.row_ptr[-1])
    assert n == old.pairs.shape[0]
    assert new.pairs.shape == (T * (T + 1) // 2, 4)
    assert new.cols.shape == (T * T,)
    assert torch.equal(new.pairs[:n], old.pairs)
    assert bool((new.pairs[n:] == -1).all())
    assert torch.equal(new.cols[:nnz], old.cols[:nnz])
    assert new.stats() == old.stats()
    rng = np.random.default_rng(seed)
    R, F = 5, 8
    feats = rng.normal(size=(P, F))
    g = rng.normal(size=(P, R + 1, F))
    d_old = _coords_mirror(old, x, m, feats, g, 5.0, R)
    d_new = _coords_mirror(new, x, m, feats, g, 5.0, R, n_live=n)
    assert np.array_equal(d_old, d_new)
    c = torch.tensor(x, requires_grad=True)
    y = rcm.radial_contract_plain(c, torch.tensor(m, dtype=torch.float64),
                                  torch.tensor(feats), 5.0, R)
    (ref,) = torch.autograd.grad(y, c, torch.tensor(g))
    assert np.abs(d_new - ref.numpy()).max() \
        <= 1e-10 * np.abs(ref.numpy()).max()


# ---- the CLIs --------------------------------------------------------------

COMMON = ["-q", "0", "--calc-mode", "morse", "--freeze-atoms", "0,2"]
H3A = "3\nreactant\nH 0.0 0.0 0.0\nH 0.686 0.0 0.0\nH 2.4 0.0 0.0\n"
H3B = "3\nproduct\nH 0.0 0.0 0.0\nH 1.714 0.0 0.0\nH 2.4 0.0 0.0\n"


def _cli(argv):
    """The port's CLI in this process: its exit code."""
    from pdb2reaction_tpu_torch import cli
    try:
        return cli.main(argv)
    except SystemExit as e:
        return e.code


def _endpoints(tmp_path):
    a, b = tmp_path / "A.xyz", tmp_path / "B.xyz"
    a.write_text(H3A)
    b.write_text(H3B)
    return a, b


def test_path_opt_cli_device_matches_host_and_jax(tmp_path):
    """``path-opt --gsm-loop device`` and ``host`` find the same HEI
    within JAX's 2e-3 (``tests/test_cli.py:294-309``; here bit for bit),
    and JAX's CLI's device loop within it too."""
    from click.testing import CliRunner
    from pdb2reaction_tpu.cli import cli as j_cli
    from pdb2reaction_tpu_torch.core import io_xyz
    a, b = _endpoints(tmp_path)
    hei = {}
    for loop in ("device", "host"):
        out = tmp_path / f"po_{loop}"
        rc = _cli(["path-opt", "-i", str(a), "-i", str(b),
                       "--max-nodes", "8", "--gsm-loop", loop, "--out-dir",
                       str(out), "--device", "cpu"] + COMMON)
        assert rc == 0
        hei[loop] = io_xyz.read_xyz(out / "hei.xyz").coords
    np.testing.assert_allclose(hei["host"], hei["device"], atol=2e-3)
    assert np.array_equal(hei["host"], hei["device"])
    res = CliRunner().invoke(j_cli, [
        "path-opt", "-i", str(a), "-i", str(b), "--max-nodes", "8",
        "--gsm-loop", "device", "--out-dir", str(tmp_path / "jax")]
        + COMMON)
    assert res.exit_code == 0, res.output
    j = io_xyz.read_xyz(tmp_path / "jax" / "hei.xyz").coords
    # the two middle images tie: JAX may climb the mirror image
    mirror = np.array([2.4, 0, 0]) * [1, 1, 1] - j[[2, 1, 0]]
    mirror[:, 1:] = j[[2, 1, 0], 1:]
    assert min(np.abs(hei["device"] - j).max(),
               np.abs(hei["device"] - mirror).max()) <= 2e-3


@pytest.mark.parametrize("cmd", ["path-search", "all"])
def test_search_and_all_cli_run_the_device_loop(tmp_path, monkeypatch, cmd):
    """``path-search`` and ``all`` take ``--gsm-loop device`` into
    ``gs_kw``: every string of the run goes through the device loop."""
    from pdb2reaction_tpu_torch.workflows import path_opt
    loops = []
    real = path_opt.gsm_mep

    def spy(*args, **kw):
        loops.append(kw["loop"])
        return real(*args, **kw)

    monkeypatch.setattr(path_opt, "gsm_mep", spy)
    a, b = _endpoints(tmp_path)
    out = tmp_path / "out"
    argv = ["-i", str(a), "-i", str(b), "--gsm-loop", "device",
            "--max-nodes", "7", "--out-dir", str(out), "--device", "cpu",
            *COMMON]
    if cmd == "path-search":
        rc = _cli(["path-search", "--max-depth", "0", *argv])
    else:
        rc = _cli(["all", "--preopt", "False", *argv])
    assert rc in (0, 3, None)
    assert loops and set(loops) == {"device"}


@pytest.mark.parametrize("default,flag,want", [
    ("device", "auto", "device"), ("host", "auto", "host"),
    ("host", "device", "device"), ("device", "host", "host")])
def test_auto_follows_the_calculator(monkeypatch, default, flag, want):
    """``gs_kw`` loop="auto" resolves through ``gsm_loop_default``; an
    explicit loop wins."""
    from pdb2reaction_tpu_torch.workflows import path_opt
    seen = []
    real = path_opt.gsm_mep

    def spy(*args, **kw):
        seen.append(kw["loop"])
        return real(*args, **kw)

    monkeypatch.setattr(path_opt, "gsm_mep", spy)
    _, tc = _h3()
    tc.gsm_loop_default = default
    A = Structure.from_symbols(["H"] * 3, H3_A, freeze=[0, 2])
    B = Structure.from_symbols(["H"] * 3, H3_B, freeze=[0, 2])
    res = path_opt.run_mep_between(A, B, tc, gs_kw={
        "max_nodes": 4, "loop": flag}, stopt_kw={"max_cycles": 6},
        verbose=False)
    assert seen == [want]
    assert tc.force_calls == res.force_calls
