#!/usr/bin/env python3
"""Device time of every CUDA kernel inside one escn-md force call of the
PyTorch/CUDA port, by kernel name (torch.profiler, CUDA activity).

    python3 scripts/gpu_kernel_breakdown.py      # needs one CUDA card

Builds the escn-md calculator on the 300-atom cluster of chip_smoke.py
(padded to 320), warms it up, profiles three get_forces calls and prints
the device time per call of each kernel (the port's own: sgemm_nn,
rotate_in, act_fwd, back_ksum, rot_out_bwd, act_bwd, gdp_bwd, gx_bwd,
ffn_fwd, ffn_bwd; everything else is the plain PyTorch glue), then the
device-busy share of the profiled window. Exits non-zero without a card.
"""

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    zs, xyz = chip_smoke.cluster(300, seed=0)
    calc = make_uma_calculator(Structure(zs, xyz), model="escn-md",
                               device="cuda", seed=0, pad_multiple=64)
    cb = calc.structure.coords_bohr.reshape(-1)
    for _ in range(2):
        calc.get_forces(cb)
    torch.cuda.synchronize()
    n = 3
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
    print(f"# {smi}; escn-md, 300 atoms (P=320), per force call")
    print(f"# wall {wall / n * 1e3:.2f} ms, device busy {busy:.2f} ms "
          f"({busy / (wall / n * 1e3):.1%})")
    for ms, cnt, name in rows[:30]:
        print(f"{ms:9.3f} ms  x{cnt:<4d} {name[:90]}")


if __name__ == "__main__":
    main()
