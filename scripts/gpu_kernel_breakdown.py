#!/usr/bin/env python3
"""Device time of every CUDA kernel inside one force call of the
PyTorch/CUDA port, by kernel name (torch.profiler, CUDA activity).

    python3 scripts/gpu_kernel_breakdown.py [cell ...]   # one CUDA card

Cells (default: all six):
  escn-md       escn-md on the 300-atom cluster of chip_smoke.py (padded
                to 320): K1 (conv_tf32<0, edge_conv>, the grouped 3xTF32
                conv products, 4 launches per layer and direction pair;
                rotate_in, act_fwd, back_ksum, rot_out_bwd, act_bwd,
                gdp_bwd, gx_bwd) and K2 (its own instantiations of the
                same GEMM, conv_tf32<epilogue, node_ffn>, 3 launches a
                forward and 5 a backward, and grid_sum, 1 each);
  escn-md-full  the same with edge_kernel="pallas-full": K3 (conv_tf32,
                rotate_in, act_fwd, back_ksum, rot_out_bwd, act_bwd,
                gdp_bwd, rot_in_bwd), the source gather's backward
                (csr_rows_sum) and K2;
  escn-md-chain the same with edge_kernel="pallas": K4 (conv_tf32, act_fwd,
                act_bwd and its column copies), K2, and the rotations as
                plain PyTorch einsums (cuBLAS batched products);
  painn-pallas  uma-s-1p1 in mp_mode="pallas" on the 4096-atom system:
                K5 (rc_fwd_tc, rc_feats_plan, rc_coords_pairs and
                rc_coords_reduce) and the glue of the call's one tile
                plan;
  painn-rank    one rank's share of the four-rank sharded uma-s-1p1
                pallas call on the 4096-atom system, in one process: rank
                0's 1024 rows against all columns, the collectives
                replaced by local copies (the kernels' work is the
                rank's; the values are not the sharded call's): K6
                (rc_rect_plan_fwd_tc, rc_rect_plan_feats,
                rc_rect_coords_pairs and rc_rect_coords_reduce, all on the
                call's one rect tile plan) and the glue of that plan;
  painn-dense   the default uma-s-1p1 (dense) on the 300-atom cluster.

For each cell: builds the calculator, warms it up, profiles ``n`` force
calls (3, or 2 for painn-pallas and painn-rank), prints the device time per call of each
kernel (everything not named above is the plain PyTorch glue), the sums
of the kernel families of ``FAMILIES`` (K2's launches apart from the edge
kernels' conv products, K5's and K6's launches) and the device-busy share of the profiled window.
Exits non-zero without a card.
"""

import dataclasses
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
CELLS = ("escn-md", "escn-md-full", "escn-md-chain", "painn-pallas",
         "painn-rank", "painn-dense")
LAYOUT = {"escn-md": "pallas-mega", "escn-md-full": "pallas-full",
          "escn-md-chain": "pallas"}
# (label, substrings of the kernel names it sums)
FAMILIES = (("K2 (conv_tf32<., node_ffn> + grid_sum)", ("node_ffn",
                                                        "grid_sum")),
            ("edge conv products (conv_tf32<0, edge_conv>)", ("edge_conv",)),
            ("K5 (rc_fwd_*, rc_feats_plan, rc_coords_pairs + reduce)",
             ("rc_fwd_", "rc_feats_plan", "rc_coords_")),
            ("K6 (rc_rect_plan_fwd_*, rc_rect_plan_feats, "
             "rc_rect_coords_pairs + reduce)", ("rc_rect_",)))


class RankShare:
    """Rank 0 of four with the collectives replaced by local copies: one
    rank's device work of the sharded call in one process."""
    rank, size = 0, 4

    @staticmethod
    def replicate_in(x):
        return x

    sum_out = replicate_in

    @classmethod
    def all_gather_rows(cls, t):
        return t.repeat(cls.size, *[1] * (t.dim() - 1))


def build(cell):
    import chip_smoke
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.model import CONFIGS, make_model
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    if cell in LAYOUT:
        zs, xyz = chip_smoke.cluster(300, seed=0)
        return make_uma_calculator(Structure(zs, xyz), model="escn-md",
                                   device="cuda", seed=0, pad_multiple=64,
                                   edge_kernel=LAYOUT[cell]), 3
    if cell == "painn-dense":
        zs, xyz = chip_smoke.cluster(300, seed=0)
        return make_uma_calculator(Structure(zs, xyz), device="cuda",
                                   seed=0), 3
    zs, xyz = chip_smoke.cluster(4096, seed=0)
    cfg = dataclasses.replace(CONFIGS["uma-s-1p1"], mp_mode="pallas")
    _, w, _ = make_model(cfg, seed=0)
    calc = chip_smoke.pallas_calculator(Structure(zs, xyz), cfg, w)
    if cell == "painn-rank":
        from pdb2reaction_tpu_torch.parallel.spatial import (
            make_spatial_energy_fn)
        calc.energy_fn = make_spatial_energy_fn(cfg, RankShare())
    return calc, 2


def profile_cell(cell, smi):
    import torch
    from torch.profiler import ProfilerActivity, profile
    calc, n = build(cell)
    cb = calc.structure.coords_bohr.reshape(-1)
    for _ in range(2):
        calc.get_forces(cb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            calc.get_forces(cb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev / n / 1e3, ev.count // n, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"# {smi}; {cell}, {calc.n_atoms} atoms (P={calc.n_pad}), per "
          f"force call over {n} profiled calls")
    print(f"# wall {wall / n * 1e3:.2f} ms, device busy {busy:.2f} ms "
          f"({busy / (wall / n * 1e3):.1%})")
    for ms, cnt, name in rows[:30]:
        print(f"{ms:9.3f} ms  x{cnt:<4d} {name[:90]}")
    for label, keys in FAMILIES:
        sel = [r for r in rows if any(k in r[2] for k in keys)]
        if sel:
            print(f"# {label}: {sum(r[0] for r in sel):.3f} ms in "
                  f"{sum(r[1] for r in sel)} launches per call")
    del calc
    torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    cells = sys.argv[1:] or list(CELLS)
    bad = [c for c in cells if c not in CELLS]
    if bad:
        sys.exit(f"unknown cells {bad}: choose from {CELLS}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for cell in cells:
        profile_cell(cell, smi)


if __name__ == "__main__":
    main()
