#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --quick    # device, build and kernel parity only

Phases (any failure exits non-zero):
1. device: name, count, power limit (nvidia-smi);
2. build: nvcc of every kernel source in pdb2reaction_tpu_torch/csrc,
   all started together, with -Xptxas -v;
3. kernel parity at escn-md shapes on the 300-atom cluster: K1 forward
   and backward (fused_edge_mega), K2 forward and backward
   (fused_node_ffn), each against its plain PyTorch version on the card,
   with its time, the plain version's time and its bound;
4. the main path: make_uma_calculator(model="escn-md", device="cuda") and
   Calculator.get_forces on the 300-atom cluster (ms per call, peak
   memory, kernel launch counts), plus card forces against the plain path
   on the CPU in float64 on a 64-atom cluster with the same weights;
5. the opt workflow (run_opt, L-BFGS) on the 300-atom cluster.

The line before the last is one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}. Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
F32_PEAK = 67e12          # H100 SXM FP32 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor cores, FLOP/s
HBM_RATE = 3.35e12        # H100 SXM HBM3, bytes/s
KERNEL_TOL = 1e-4         # max|kernel - plain| / max|plain| (f32 sums
                          # reordered against the plain path)
FORCE_TOL = 1e-4          # max|F_card - F_cpu64| / max|F_cpu64|

REPLACES = {
    "fused_edge_mega_fwd": "pdb2reaction_tpu/mlip/escn_edge_kernel.py:1147",
    "fused_edge_mega_bwd": "pdb2reaction_tpu/mlip/escn_edge_kernel.py:1274",
    "fused_node_ffn_fwd": "pdb2reaction_tpu/mlip/escn_ffn_kernel.py:68",
    "fused_node_ffn_bwd": "pdb2reaction_tpu/mlip/escn_ffn_kernel.py:82",
}
SOURCES = {
    "fused_edge_mega": "pdb2reaction_tpu_torch/csrc/escn_edge.cu",
    "fused_node_ffn": "pdb2reaction_tpu_torch/csrc/escn_ffn.cu",
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cluster(n_atoms: int = 300, seed: int = 0):
    """Organic-ish composition on a jittered 1.8 Angstrom lattice."""
    rng = np.random.default_rng(seed)
    zs = rng.choice([1, 6, 7, 8, 16], size=n_atoms,
                    p=[0.45, 0.35, 0.08, 0.10, 0.02])
    grid = int(np.ceil(n_atoms ** (1 / 3)))
    pts = np.stack(np.meshgrid(*[np.arange(grid)] * 3), -1).reshape(-1, 3)
    coords = pts[:n_atoms] * 1.8 + rng.normal(scale=0.15, size=(n_atoms, 3))
    return zs.astype(np.int32), coords


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def rel_err(a, b) -> float:
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def abs_err(a, b) -> float:
    return float((a.detach() - b.detach()).abs().max())


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


# ---------------------------------------------------------------------------
# work counts (FLOP) from the shapes
# ---------------------------------------------------------------------------

def k1_flops(cfg, P):
    from pdb2reaction_tpu_torch.mlip.escn_edge_kernel import _dims, _rot_nz
    nl0, nls, U, G = _dims(cfg)
    C, H, Ce, K = (cfg.sphere_channels, cfg.hidden_channels,
                   cfg.edge_channels, cfg.max_neighbors)
    nnz = len(_rot_nz(cfg.lmax, cfg.mmax)[0])
    rows = [nl0] + [2 * nl for nl in nls]
    conv1 = sum(2 * (r * 2 * C + (Ce if i == 0 else 0)) * r * H
                for i, r in enumerate(rows))
    conv2 = sum(2 * (r * H) * (r * C) for r in rows)
    grid = 2 * 2 * G * U * H
    rot_f = 2 * nnz * C * 3                  # source, target, back
    rot_b = 2 * nnz * C * 6                  # g_out, gDpe, gDp (x2), gx (x2)
    E = P * K
    return (E * (conv1 + conv2 + grid + rot_f),
            E * (conv1 + conv2 + 3 * grid // 2 + rot_b))


def k2_flops(M, C, H, G, P):
    return (P * (2 * G * M * C * 2 + 2 * G * C * H * 2),
            P * (2 * G * M * C * 3 + 2 * G * C * H * 3))


def bound_ms(flops, nb):
    t32 = max(flops / F32_PEAK, nb / HBM_RATE) * 1e3
    tbf = max(flops / BF16_PEAK, nb / HBM_RATE) * 1e3
    by = "operations" if flops / F32_PEAK >= nb / HBM_RATE else "bytes"
    return t32, tbf, by


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi_line}")
    return name, count, smi_line


def phase_build():
    from pdb2reaction_tpu_torch.mlip import cuda_build
    t0 = time.perf_counter()
    times = cuda_build.build(["escn_edge", "escn_ffn"], verbose=True)
    for name, rec in cuda_build.BUILD_LOG.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {times} (wall {time.perf_counter() - t0:.1f} s)")


def _leaves(ts):
    return [t.detach().clone().requires_grad_(True) for t in ts]


def phase_kernels(calc, cfg, quick):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
    from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
    from pdb2reaction_tpu_torch.mlip.escn import first_layer_kernel_args
    reps = 3 if quick else 20
    c = calc._to_pad_ang(calc.structure.coords_bohr)
    with torch.no_grad():
        edge_args, ffn_args = first_layer_kernel_args(c, calc.system,
                                                      calc.params, cfg)
    rows = {}

    # ---- K1 --------------------------------------------------------------
    cfg_, x_t, src, es, Dp, Dpe, weights, tables = edge_args
    P = x_t.shape[1]
    dev = x_t.device
    gen = torch.Generator(device=dev).manual_seed(0)
    lv = _leaves([x_t, es, Dp, Dpe])
    lp = _leaves([x_t, es, Dp, Dpe])
    y_k = ek.fused_edge_mega(cfg_, lv[0], src, lv[1], lv[2], lv[3], weights,
                             tables)
    y_p = ek.fused_edge_mega_plain(cfg_, lp[0], src, lp[1], lp[2], lp[3],
                                   weights, tables)
    torch.cuda.synchronize()
    g = torch.randn(y_p.shape, generator=gen, device=dev)
    gk = torch.autograd.grad(y_k, lv, g, retain_graph=True)
    gp = torch.autograd.grad(y_p, lp, g, retain_graph=True)
    torch.cuda.synchronize()
    e_fwd = rel_err(y_k, y_p)
    e_bwd = {n: rel_err(a, b) for n, a, b in
             zip(("x", "es", "Dp", "Dpe"), gk, gp)}
    a_fwd = abs_err(y_k, y_p)
    a_bwd = max(abs_err(a, b) for a, b in zip(gk, gp))
    log(f"[K1] fwd rel err {e_fwd:.3e}, abs {float((y_k - y_p).abs().max()):.3e}"
        f" (max|ref| {float(y_p.abs().max()):.3e}); bwd rel err {e_bwd} "
        f"(tol {KERNEL_TOL})")
    if not (e_fwd <= KERNEL_TOL and max(e_bwd.values()) <= KERNEL_TOL):
        fail("K1 disagrees with its plain version")
    with torch.no_grad():
        t_fwd = cuda_ms(lambda: ek.fused_edge_mega(
            cfg_, x_t, src, es, Dp, Dpe, weights, tables), reps)
        t_fwd_p = cuda_ms(lambda: ek.fused_edge_mega_plain(
            cfg_, x_t, src, es, Dp, Dpe, weights, tables), reps)
    t_bwd = cuda_ms(lambda: torch.autograd.grad(y_k, lv, g,
                                                retain_graph=True), reps)
    t_bwd_p = cuda_ms(lambda: torch.autograd.grad(y_p, lp, g,
                                                  retain_graph=True), reps)
    f_fwd, f_bwd = k1_flops(cfg_, P)
    wts = [w for w in ek._flat_weights(weights)]
    from pdb2reaction_tpu_torch.mlip.escn_edge_kernel import _dims
    nl0, nls, U, G = _dims(cfg_)
    E = src.numel()
    saved = E * U * (cfg_.hidden_channels + cfg_.sphere_channels) * 4
    b_fwd = nbytes(x_t, src, es, Dp, Dpe, *wts, *tables, y_p) + saved
    b_bwd = nbytes(x_t, g, src, Dp, Dpe, *wts, *tables, *gp) + saved
    rows["fused_edge_mega_fwd"] = (a_fwd, t_fwd, t_fwd_p, f_fwd, b_fwd)
    rows["fused_edge_mega_bwd"] = (a_bwd, t_bwd, t_bwd_p, f_bwd, b_bwd)
    del y_k, y_p, gk, gp, lv, lp

    # ---- K2 --------------------------------------------------------------
    cfg_, xn2, fw, ftab = ffn_args
    (xk,) = _leaves([xn2])
    (xp,) = _leaves([xn2])
    o_k = fk.fused_node_ffn(cfg_, xk, fw, ftab)
    o_p = fk.ffn_plain(xp, fw, ftab)
    g2 = torch.randn(o_p.shape, generator=gen, device=dev)
    (dk,) = torch.autograd.grad(o_k, [xk], g2, retain_graph=True)
    (dp,) = torch.autograd.grad(o_p, [xp], g2, retain_graph=True)
    torch.cuda.synchronize()
    e2f, e2b = rel_err(o_k, o_p), rel_err(dk, dp)
    log(f"[K2] fwd rel err {e2f:.3e}, bwd rel err {e2b:.3e} "
        f"(tol {KERNEL_TOL})")
    if not (e2f <= KERNEL_TOL and e2b <= KERNEL_TOL):
        fail("K2 disagrees with its plain version")
    with torch.no_grad():
        t2f = cuda_ms(lambda: fk.fused_node_ffn(cfg_, xn2, fw, ftab), reps)
        t2f_p = cuda_ms(lambda: fk.ffn_plain(xn2, fw, ftab), reps)
    t2b = cuda_ms(lambda: torch.autograd.grad(o_k, [xk], g2,
                                              retain_graph=True), reps)
    t2b_p = cuda_ms(lambda: torch.autograd.grad(o_p, [xp], g2,
                                                retain_graph=True), reps)
    Pn, M, C = xn2.shape
    H = fw[0].shape[1]
    Gn = ftab[0].shape[0]
    f2f, f2b = k2_flops(M, C, H, Gn, Pn)
    rows["fused_node_ffn_fwd"] = (abs_err(o_k, o_p), t2f, t2f_p, f2f,
                                  nbytes(xn2, *fw, *ftab, o_p))
    rows["fused_node_ffn_bwd"] = (abs_err(dk, dp), t2b, t2b_p, f2b,
                                  nbytes(xn2, g2, *fw, *ftab, dp))
    for k, (err, t, tp, fl, nb) in rows.items():
        b32, bbf, by = bound_ms(fl, nb)
        log(f"[kernel] {k}: {t:.3f} ms (plain {tp:.3f} ms), "
            f"{fl / 1e9:.1f} GFLOP, {nb / 1e6:.1f} MB, bound f32 "
            f"{b32:.3f} ms / bf16 {bbf:.3f} ms ({by}); "
            f"{fl / t / 1e9:.2f} TFLOP/s")
    return rows


def phase_force(calc, reps):
    import torch
    from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
    from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
    cb = calc.structure.coords_bohr.reshape(-1)
    for d in (ek.launches, fk.launches):
        for k in d:
            d[k] = 0
    calc.force_calls = 0
    torch.cuda.reset_peak_memory_stats()
    res = calc.get_forces(cb)                # first call (warm-up)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = calc.get_forces(cb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    f = res["forces"]
    if f.shape != (3 * calc.n_atoms,) or not np.all(np.isfinite(f)) \
            or not np.isfinite(res["energy"]):
        fail("force call returned non-finite or mis-shaped output")
    log(f"[force] escn-md, {calc.n_atoms} atoms (P={calc.n_pad}): "
        f"{ms:.2f} ms per get_forces over {reps} calls, peak memory "
        f"{peak:.2f} GiB, E = {res['energy']:.8f} Ha, max|F| = "
        f"{np.abs(f).max():.3e} Ha/Bohr; launches after "
        f"{calc.force_calls} calls: {dict(ek.launches)} {dict(fk.launches)}")
    return ms, peak, res["energy"]


def phase_reference(seed):
    """Card forces against the plain path on the CPU in float64."""
    import torch
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.escn import (ESCN_CONFIGS,
                                                  init_escn_params)
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    zs, xyz = cluster(64, seed=1)
    st = Structure(zs, xyz)
    w = init_escn_params(ESCN_CONFIGS["escn-md"], seed=seed, device="cpu")
    gpu = make_uma_calculator(st, model="escn-md", device="cuda", params=w)
    cpu = make_uma_calculator(st, model="escn-md", device="cpu",
                              dtype=torch.float64, params=w)
    cb = st.coords_bohr.reshape(-1)
    t0 = time.perf_counter()
    rc = cpu.get_forces(cb)
    t_cpu = time.perf_counter() - t0
    rg = gpu.get_forces(cb)
    err = float(np.abs(rg["forces"] - rc["forces"]).max()
                / np.abs(rc["forces"]).max())
    de = abs(rg["energy"] - rc["energy"])
    log(f"[reference] 64 atoms escn-md: card f32 kernels vs CPU f64 plain "
        f"path: max|dF|/max|F| = {err:.3e} (tol {FORCE_TOL}), |dE| = "
        f"{de:.3e} Ha (CPU call {t_cpu:.1f} s)")
    if not err <= FORCE_TOL:
        fail("card forces disagree with the CPU float64 plain path")
    return err, de


def phase_opt(calc, cycles):
    from pdb2reaction_tpu_torch.core.io_xyz import write_xyz
    from pdb2reaction_tpu_torch.workflows.opt import run_opt
    out = os.path.join(HERE, "result_smoke")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "cluster300.xyz")
    write_xyz(path, calc.structure)
    e0 = calc.get_energy(calc.structure.coords_bohr)["energy"]
    t0 = time.perf_counter()
    res = run_opt(path, charge=0, spin=1, model="escn-md", device="cuda",
                  max_cycles=cycles, out_dir=out, calc=calc, verbose=False)
    wall = time.perf_counter() - t0
    log(f"[opt] escn-md L-BFGS, 300 atoms: E {e0:.8f} -> {res['energy']:.8f}"
        f" Ha in {res['cycles']} cycles, {res['force_calls']} force calls, "
        f"{wall:.2f} s wall ({wall / max(res['force_calls'], 1) * 1e3:.1f} "
        f"ms per force call)")
    if not (np.isfinite(res["energy"]) and res["energy"] < e0):
        fail("opt did not lower the energy")
    if not os.path.exists(os.path.join(out, "final_geometry.xyz")):
        fail("opt wrote no final_geometry.xyz")
    return res, wall


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="device, build and kernel parity only")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    sys.path.insert(0, HERE)
    try:
        import pdb2reaction_tpu_torch  # noqa: F401
    except ImportError:
        fail("pdb2reaction_tpu_torch not found: run from a checkout of the "
             "repository")
    name, count, smi_line = phase_device()
    phase_build()

    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
    from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    zs, xyz = cluster(300, seed=0)
    st = Structure(zs, xyz)
    # padded to 320 atom slots (E = 320 * 32 = 10240 edges)
    calc = make_uma_calculator(st, model="escn-md", device="cuda", seed=0,
                               pad_multiple=64)
    log(f"[setup] TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn TF32 {torch.backends.cudnn.allow_tf32}")
    rows = phase_kernels(calc, calc.cfg, args.quick)

    launches = {k: 0 for k in rows}
    if not args.quick:
        # ---- the main path: counts set to 0 just before, read just after
        ms, peak, _ = phase_force(calc, reps=5)
        phase_opt(calc, cycles=10)
        launches = {**ek.launches, **fk.launches}
        never = [k for k, v in launches.items() if v == 0]
        if never:
            fail(f"kernels never launched on the main path: {never}")
        phase_reference(seed=0)

    kern = []
    for k, (err, t, tp, fl, nb) in rows.items():
        b32, _, by = bound_ms(fl, nb)
        base = k.rsplit("_", 1)[0]
        kern.append({"name": k, "route": "cuda", "source": SOURCES[base],
                     "replaces": REPLACES[k], "launches": launches[k],
                     "max_abs_err": err, "ms": t, "plain_ms": tp,
                     "bound_ms": b32, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kern}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
