"""ms per HVP of the escn-md calculator's Hessian closure on the card.

    python scripts/gpu_hvp_ms.py [ROOT ...]

For each ROOT (a checkout of this repository; default: the one holding
this script), in a process of its own that imports the port from ROOT:
``make_uma_calculator(model="escn-md", device="cuda", seed=0,
pad_multiple=64)`` on ``chip_smoke.py``'s 300-atom cluster (P = 320),
two warm-up HVPs and then ``--reps`` timed ones (default 20) of its
``au_hvp_fn`` (the all-plain Hessian closure) along unit random
tangents, each call synchronised. Prints one JSON line a root (ms per
HVP, median and mean, peak memory) and then the card's name and power
limit. To compare two trees, give them in the order parent, change,
change, parent in one call.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(root, reps):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    import pdb2reaction_tpu_torch
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    if not pdb2reaction_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {pdb2reaction_tpu_torch.__file__}, "
                           f"not from {root}")
    st = Structure(*chip_smoke.cluster(300, seed=0))
    calc = make_uma_calculator(st, model="escn-md", device="cuda", seed=0,
                               pad_multiple=64)
    hvp = calc.au_hvp_fn()
    x = calc.pad_bohr(st.coords_bohr.reshape(-1))
    gen = torch.Generator(device=x.device).manual_seed(0)
    times = []
    for i in range(reps + 2):
        v = torch.randn(x.shape, generator=gen, device=x.device,
                        dtype=x.dtype)
        v /= v.norm()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = hvp(x, v)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"root": root, "n_pad": calc.n_pad, "reps": reps,
                      "ms_median": float(np.median(times)),
                      "ms_mean": float(np.mean(times)),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "hvp_norm": float(out.norm())}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(os.path.abspath(args.one), args.reps)
        return
    rc = 0
    for root in args.roots or [HERE]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", os.path.abspath(root), "--reps",
                            str(args.reps)], cwd=os.path.abspath(root),
                           capture_output=True, text=True)
        # the result lines alone (the factory's weight banner dropped)
        print("\n".join(x for x in r.stdout.splitlines()
                        if x.startswith("{")), flush=True)
        if r.returncode:
            print(r.stderr[-2000:], file=sys.stderr, flush=True)
        rc = rc or r.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    sys.exit(rc)


if __name__ == "__main__":
    main()
