#!/usr/bin/env python3
"""The PaiNN pallas path on a random normal cloud: both card paths and
every K5 / K6 kernel against float64.

    python3 scripts/gpu_random_cloud.py        # one CUDA card

The system: 96 atoms (H, C, O) at normal coordinates (scale 3 Angstrom,
numpy seed 8; closest pair 0.31 Angstrom), uma-s-1p1 in
mp_mode="pallas" with the weights of ``make_model(cfg, seed=3)``. Prints:

- forces, max|dF| / max|F| against the CPU float64 plain (dense) path, of
  the sharded branch through a one-rank stub (K6 against all columns, no
  collectives), the unsharded pallas call on the card (K5), the CPU
  float32 plain (dense) path, and the pallas mode's own plain path on the
  CPU (float32 whatever the dtype: the same split of the edge-direction
  stream as on the card, without the kernels);
- each K5 and K6 kernel on the cloud's coordinates (forward, feats
  gradient, coordinate gradients; K6 for all rows at offset 0 and for
  rows 32..63) against its plain version in float64 on the card, beside
  the plain version in float32 against the same reference, for a seeded
  stream (div_d False) and the model's first-layer stream B (div_d True);
- the sharded branch again with one part of every K6 call (its forward,
  its feats gradient, its coordinate gradients, or all three) taken from
  the plain version in float64 on the card, the rest from the kernels:
  which kernel's float32 rounding the forces carry; and each part's error
  against float64 inside the force call, on the cotangents the model
  really feeds it (the largest over the call's eight K6 calls).

Exits non-zero without a card. Imports nothing of JAX.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


class OneRank:
    """A sharding of one rank: the sharded pallas branch without
    collectives."""
    rank, size = 0, 1

    @staticmethod
    def replicate_in(x):
        return x

    all_gather_rows = sum_out = replicate_in


def cloud():
    rng = np.random.default_rng(8)
    from pdb2reaction_tpu_torch.core.structure import Structure
    return Structure(rng.choice([1, 6, 8], size=96).astype(np.int32),
                     rng.normal(scale=3.0, size=(96, 3)))


class MixedRect:
    """``radial_contract_rect`` for the sharded branch with the parts named
    in ``swap`` ("fwd", "feats", "coords") from the plain version in
    float64, the others from the kernels; ``errs`` collects each part's
    kernel error against float64 on the call's own inputs and
    cotangents."""

    def __init__(self, rcm, swap):
        import torch
        self.rcm, self.swap, self.errs = rcm, set(swap), {}
        outer = self

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, cr, cc, feats, args):
                ctx.save_for_backward(cr, cc, feats)
                ctx.args = args
                with torch.no_grad():
                    k = outer.kernel(cr, cc, feats, args)
                    p = outer.plain64(cr, cc, feats, args)
                outer.note("fwd", k, p)
                return p.float() if "fwd" in outer.swap else k

            @staticmethod
            def backward(ctx, g):
                cr, cc, feats = ctx.saved_tensors
                with torch.enable_grad():
                    a = [t.detach().requires_grad_(True)
                         for t in (cr, cc, feats)]
                    k = torch.autograd.grad(outer.kernel(*a, ctx.args), a, g)
                    b = [t.detach().double().requires_grad_(True)
                         for t in (cr, cc, feats)]
                    p = torch.autograd.grad(outer.plain64(*b, ctx.args), b,
                                            g.double())
                outer.note("feats", k[2], p[2])
                outer.note("coords", k[0] + k[1], p[0] + p[1])
                pick = [p[i].float() if part in outer.swap else k[i]
                        for i, part in ((0, "coords"), (1, "coords"),
                                        (2, "feats"))]
                return (*pick, None)

        self.fn = Fn

    def kernel(self, cr, cc, feats, args):
        mr, off, mc, rc, R, div_d = args
        return self.rcm.radial_contract_rect(cr, mr, off, cc, mc, feats, rc,
                                             R, div_d)

    def plain64(self, cr, cc, feats, args):
        mr, off, mc, rc, R, div_d = args
        return self.rcm.radial_contract_rect_plain(
            cr.double(), mr.double(), off, cc.double(), mc.double(),
            feats.double(), rc, R, div_d)

    def note(self, part, k, p):
        e = rel(k.detach().double().cpu(), p.detach().cpu())
        self.errs[part] = max(self.errs.get(part, 0.0), e)

    def __call__(self, cr, mr, off, cc, mc, feats, rc, R, div_d=False,
                 plan=None):
        # rows one rank holds: with one rank, all; the coordinates' sum of
        # row and column gradients goes to the same leaf through autograd
        return self.fn.apply(cr, cc, feats, (mr, off, mc, rc, R, div_d))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from pdb2reaction_tpu_torch.mlip import model as tm
    from pdb2reaction_tpu_torch.mlip import radial_contract as rcm
    from pdb2reaction_tpu_torch.mlip.calculator import Calculator
    from pdb2reaction_tpu_torch.mlip.escn import tree_to
    from pdb2reaction_tpu_torch.mlip.model import CONFIGS, make_model
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    from pdb2reaction_tpu_torch.parallel.spatial import (
        make_spatial_energy_fn)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    st = cloud()
    cfg = dataclasses.replace(CONFIGS["uma-s-1p1"], mp_mode="pallas")
    fn, w, _ = make_model(cfg, seed=3)
    wc = tree_to(w, device="cuda")
    cb = st.coords_bohr.reshape(-1)
    ref = make_uma_calculator(st, model="uma-s-1p1", params=w, device="cpu",
                              dtype=torch.float64).get_forces(cb)["forces"]
    paths = {
        "sharded branch, one rank (K6)": Calculator(
            st, make_spatial_energy_fn(cfg, OneRank()), params=wc,
            device="cuda"),
        "unsharded pallas (K5)": Calculator(st, fn, params=wc,
                                            device="cuda"),
        "CPU float32 plain (dense)": make_uma_calculator(
            st, model="uma-s-1p1", params=w, device="cpu",
            dtype=torch.float32),
        "CPU float32 plain (pallas mode)": make_uma_calculator(
            st, model="uma-s-1p1", mp_mode="pallas", params=w,
            device="cpu", dtype=torch.float32),
    }
    forces = {k: c.get_forces(cb)["forces"] for k, c in paths.items()}
    for k, f in forces.items():
        print(f"[cloud] forces, {k}: max|dF|/max|F| against CPU float64 "
              f"{rel(f, ref):.3e}")
    print(f"[cloud] sharded against unsharded on the card: "
          f"{rel(forces['sharded branch, one rank (K6)'], forces['unsharded pallas (K5)']):.3e}")

    # the sharded branch with parts of every K6 call in float64
    kernel_rect = tm.radial_contract_rect
    try:
        for swap in ((), ("fwd",), ("feats",), ("coords",),
                     ("fwd", "feats", "coords")):
            mixed = MixedRect(rcm, swap)
            tm.radial_contract_rect = mixed
            calc1 = Calculator(st, make_spatial_energy_fn(cfg, OneRank()),
                               params=wc, device="cuda")
            f = calc1.get_forces(cb)["forces"]
            print(f"[cloud-swap] sharded branch, K6 parts in float64: "
                  f"{'+'.join(swap) or 'none'}: max|dF|/max|F| against CPU "
                  f"float64 {rel(f, ref):.3e}; the kernels' errors inside "
                  f"the call against float64: " + ", ".join(
                      f"{k} {v:.2e}" for k, v in mixed.errs.items()))
    finally:
        tm.radial_contract_rect = kernel_rect
    # the unsharded path with every K5 contraction in float64: the glue's
    # own float32 error on the card
    kernel_sq = tm.radial_contract
    try:
        tm.radial_contract = lambda c, m, f, rc, R, div_d=False, plan=None: \
            rcm.radial_contract_plain(c.double(), m.double(), f.double(), rc,
                                      R, div_d).float()
        f = Calculator(st, fn, params=wc, device="cuda").get_forces(cb)
        print(f"[cloud-swap] unsharded pallas, every K5 call in float64: "
              f"max|dF|/max|F| against CPU float64 "
              f"{rel(f['forces'], ref):.3e}")
    finally:
        tm.radial_contract = kernel_sq

    calc = paths["unsharded pallas (K5)"]
    x = calc._to_pad_ang(calc.structure.coords_bohr).float()
    mask = calc.system.atom_mask.float()
    P = x.shape[0]
    d = torch.cdist(x[mask > 0].double(), x[mask > 0].double())
    d.fill_diagonal_(np.inf)
    print(f"[cloud] {P} atom slots, closest pair {float(d.min()):.4f} A, "
          f"max|x| {float(x.abs().max()):.3f} A")
    p = calc.params
    with torch.no_grad():
        _, s = tm._embed_nodes(calc.system, p, cfg, mask)
        phi_vs = tm._apply_mlp(p["layers"][0]["phi"], s).chunk(3, -1)[2]
        featsB = torch.cat([x[:, k:k + 1] * phi_vs for k in range(3)]
                           + [phi_vs], -1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    featsA = torch.randn(featsB.shape, generator=gen, device="cuda")
    R, rc = cfg.n_radial, cfg.cutoff
    worst = 0.0
    for label, feats, div_d in (("A", featsA, False), ("B", featsB, True)):
        F = feats.shape[1]
        for kind, off, n in (("K5", 0, P), ("K6", 0, P), ("K6", 32, 32)):
            g = torch.randn(n, R + 1, F, generator=gen, device="cuda")
            outs = []
            for fn_, dt in ((None, torch.float32), ("plain", torch.float32),
                            ("plain", torch.float64)):
                xc = x.to(dt).clone().requires_grad_(True)
                f = feats.to(dt).clone().requires_grad_(True)
                mk = mask.to(dt)
                if kind == "K5":
                    call = (rcm.radial_contract if fn_ is None
                            else rcm.radial_contract_plain)
                    T = call(xc, mk, f, rc, R, div_d)
                    leaves = [f, xc]
                else:
                    xr = x[off:off + n].to(dt).clone().requires_grad_(True)
                    call = (rcm.radial_contract_rect if fn_ is None
                            else rcm.radial_contract_rect_plain)
                    T = call(xr, mk[off:off + n], off, xc, mk, f, rc, R,
                             div_d)
                    leaves = [f, xr, xc]
                grads = torch.autograd.grad(T, leaves, g.to(dt))
                outs.append([T.detach(), *grads])
            torch.cuda.synchronize()
            names = ["fwd", "feats", "coords"] if kind == "K5" else \
                ["fwd", "feats", "rows", "cols"]
            kern = [rel(a.cpu(), b.cpu()) for a, b in zip(outs[0], outs[2])]
            plain = [rel(a.cpu(), b.cpu()) for a, b in zip(outs[1], outs[2])]
            worst = max(worst, *kern)
            print(f"[cloud] {kind} stream {label} (div_d={div_d}), rows "
                  f"{off}..{off + n - 1}: against plain float64, kernel / "
                  f"plain float32: " + ", ".join(
                      f"{nm} {a:.2e} / {b:.2e}"
                      for nm, a, b in zip(names, kern, plain)))
    print(f"[cloud] worst kernel error against plain float64: {worst:.3e} "
          f"(kernel tolerance 1e-4)")


if __name__ == "__main__":
    main()
