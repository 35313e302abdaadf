#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --quick    # device, build and kernel parity only
                                     # (phases 1-3, 6 and 10)
    python3 chip_smoke.py --chunks   # device, build and phase 22 alone

Phases (any failure exits non-zero):
1. device: name, count, power limit (nvidia-smi);
2. build: nvcc of every kernel source in pdb2reaction_tpu_torch/csrc,
   all started together, with -Xptxas -v;
3. kernel parity at escn-md shapes on the 300-atom cluster: K1 forward
   and backward (fused_edge_mega), K2 forward and backward
   (fused_node_ffn), K3 (fused_edge_block) and K4 (fused_edge_chain)
   forward and backward at the first-layer inputs of the "pallas-full"
   and "pallas" layouts, each against its plain PyTorch version on the
   card, with its time, the plain version's time and its bound (K1-K4 at
   the 3xTF32 route of their products); the conv products alone, timed
   and their TFLOP/s printed ([K1-gemm]); K2's launches one by one, with
   their rates and the peak memory of a K2 launch ([K2-stages]);
4. the escn main path: make_uma_calculator(model="escn-md", device="cuda")
   and Calculator.get_forces on the 300-atom cluster (ms per call, peak
   memory, kernel launch counts, two calls bit for bit equal), then the
   opt workflow (run_opt, L-BFGS) on it;
5. the escn-md force call in the edge_kernel="pallas-full" (K3) and
   "pallas" (K4) layouts on the same cluster and weights, each its own
   path with its own launch counts (ms per call, peak memory, forces
   against the "pallas-mega" path, two calls bit for bit equal; a
   5-cycle opt on the "pallas-full" one), and all three layouts on the
   card against the plain path on the CPU in float64 on a 64-atom
   cluster with the same weights;
6. K5 parity at the uma-s-1p1 pallas-mode shapes (P = 4096, F = 1024,
   R + 1 = 25) on the 4096-atom system: forward, feats gradient and
   coordinate gradient of radial_contract against its plain version, for
   a seeded stream A (div_d False), the real first-layer stream B
   (div_d True) and stream A on the same atoms shuffled; the tile plan's
   statistics (tiles, listed tile pairs and their share, which must not
   pass 25%, pairs per listed tile pair, the plan's build time) in both
   atom orders; the forward's time is the call with its tile plan, the
   kernel alone on a plan beside it; the bound counts the pairs inside
   the cutoff (the work the function needs) at the peak of each kernel's
   route to f32 accuracy (3xTF32 at R + 1 <= 32: ROUTE_PEAK), beside the
   FLOP the kernels compute (the listed tile pairs), with the rate on
   each; then the three kernels and their plain versions timed at
   uma-m-1p1 shapes (F = 2048, R + 1 = 33: the CUDA-core route), with
   their errors ([K5-R33]);
7. the PaiNN kernel path: uma-s-1p1 in mp_mode="pallas" through
   Calculator.get_forces on the 4096-atom system (ms per call, peak
   memory, 8 / 7 / 8 K5 launches and exactly one tile plan per call, two
   calls bit for bit equal) and a 5-cycle run_opt; the dense mode of the
   same weights on the card (ms per call, peak memory, forces against the
   pallas mode);
8. the default path: make_uma_calculator(device="cuda") with no model
   (uma-s-1p1, dense) on the 300-atom cluster;
9. uma-s-1p1 pallas mode on the card against the CPU float64 dense plain
   path on the 64-atom cluster with the same weights;
10. K6 parity at the sharded path's shapes (the 4096-atom system in four
   row blocks of 1024 against all 4096 columns, F = 1024, R + 1 = 25):
   forward, feats gradient and the row and column coordinate gradients
   (one fused launch), all three on the block's rect tile plan, of
   radial_contract_rect against its plain version at each offset
   0/1024/2048/3072 for streams A and B, and the four forward blocks
   stacked against K5's kernel output; the rect plan's statistics (listed
   tile pairs, their share, the GFLOP each kernel computes on them
   against the GFLOP needed, build time) at each offset and for a block
   of the shuffled system, and the plan's stages timed one by one
   ([K6-plan-stages]); the three kernels timed with the block's plan
   given, as the sharded path calls them, and the forward also with the
   plan it builds itself; the bound counts the pairs inside the cutoff
   with one atom in the block, at the 3xTF32 route; then the three
   kernels' CUDA-core routes (R + 1 = 33) against the plain version
   ([K6-R33]);
11. the sharded path: four ranks started with "spawn" on the one card
   (gloo collectives staged through host memory), each building
   make_uma_calculator(uma-s-1p1, mp_mode="pallas", spatial=4) with the
   weights of phase 7: energy and forces against phase 7's unsharded
   call, bit for bit equal on all ranks and across two calls, 8 / 7 / 8
   K6 launches (forward, feats gradient, both coordinate gradients), one
   rect tile plan and no K5 launch per rank and force call, ms per call
   and peak memory per rank (four ranks time-sharing one card), a 5-cycle
   run_opt with the same force calls on every rank; then, in the same
   group, the factory default make_uma_calculator(st, spatial=4)
   (uma-s-1p1, switched to the sharded gather layout) on the 300-atom
   cluster against the unsharded gather mode; then eSCN sharded in the
   same group: escn-md (the default pallas-mega, which takes K3's
   layout under a shard, on the source rows gathered from the
   all-gathered features) on the 300-atom cluster (80 rows a rank) and
   the 4096-atom system (1024 rows a rank), and escn-md-gate at 300
   atoms, each against the unsharded pallas-full call the parent makes
   before the ranks start (SHARD_TOL in energy and forces; there the
   parent also holds K3 to its plain version on rank 0's first-layer
   inputs of both escn-md cases: this rank's P/4 x 32 edges, their
   source rows gathered from all P rows by gather_src, whose backward
   is the source scatter over P rows; values and cotangents within
   KERNEL_TOL), forces bit
   for bit equal on all ranks and across two calls, K3 4 + 4 and K2
   4 + 4 launches per rank and call and no K1 (the gate: K2 only), ms
   per call and peak memory per rank, the collectives of one 4096-atom
   call alone, and a 5-cycle escn-md opt on every rank, rank 0 alone
   writing;
12. the GSM string on phase 4's escn-md calculator, after phase 5: the
   flagship MEP (gsm_mep through au_energy_force_batch_fn, max_nodes=10,
   host loop, climb off, perpendicular RMS < 2e-2 Ha/Bohr; a warm-up,
   then the measured run with its counts set to 0 just before and read
   just after: (cycles + 1) x 12 force calls, counted once on the
   calculator, K1 and K2 launched exactly 4 x force calls, endpoints
   unchanged, energies finite); the climbing image on Lanczos tangents
   (every HVP counted and timed, none may launch a kernel); the analytic
   Hessian at 64 atoms with phase 5's weights (atoms 0 and 1 frozen) on
   the card at HVP chunk 1, three columns against the CPU in float64 and
   float32 (computed by a child process, `chip_smoke.py --p12-cpu OUT`,
   started after the build), and the FD Hessian through the kernels in
   stacked passes; then the path-opt CLI as a subprocess on the card;
13. path-search (run_path_search, escn-md with phase 4's seed-0 weights,
   the 300-atom cluster padded to 320) from A to B, B being A with one H
   moved to 1.05 Angstrom from its nearest C, N or O (the lowest-index H
   within 2.2 Angstrom of one; the bond it forms is checked first):
   max_depth 1, opt threshold gau_loose, max_nodes 10, 10 string cycles,
   climbing image on, no preopt. Counts set to 0 just before the run and
   read just after: K1 and K2 forward launches 4 x (force + energy
   calls), backward 4 x force calls, nothing else, and none inside an
   HVP; the output tree checked (mep.trj, summary.yaml listing every
   segment, summary.log, each segment's trajectory, summary and, when
   reactive, hei.xyz; finite energies and images). Then the path-search
   CLI as a subprocess on the card (max_depth 0, climb off);
14. the production-dims golden (lmax 4, mmax 2, C = 128, 4 experts, 2
   layers; its state dict rebuilt from its seed by
   scripts/make_escn_golden.py and saved as a .pt) through
   make_uma_calculator(checkpoint=...) on the card: K1 and K2 in
   float32, 2 + 2 launches a force call, energies and forces of both
   golden structures against the same weights on the CPU plain path in
   float64 and against the independent numpy executor's goldens
   (energy rtol 2e-5; forces rtol 1e-3, atol 2e-5 eV/Angstrom);
15. stage 4 on escn-md (phase 4's weights, P = 320) from phase 13's TS
   guess (the HEI of its reactive segment with the highest barrier, of
   any segment when none is reactive), the atoms beyond 3 Angstrom of the
   formed bond frozen: run_tsopt light (Hessian dimer, max_cycles 200,
   flatten_max_iter 1) and heavy (RS-I-RFO, max_cycles 100), run_freq
   and run_irc (30 cycles a branch) on the light result, each with its
   counts set to 0 just before and read just after: K1 and K2 forward
   launches 4 x (force + energy calls), backward 4 x force calls, none
   inside a Hessian (one all-plain HVP a free DOF); wall, cycles, calls,
   Hessians and their seconds, the frequencies and the thermochemistry,
   the IRC's host time a cycle outside the force call, peak memory;
   every output file and finite results checked. Then the tsopt (heavy,
   3 cycles), freq and irc (3 cycles) CLIs as three subprocesses at
   once, and the
   Morse H3 engines (RS-I-RFO, the dimer, the IRC) on the card against
   the CPU: equal cycles and force calls, 1e-8 Bohr, 1e-10 Hartree;
16. all (run_all) on an enzyme-like reactant / product PDB pair: the
   active site of scripts/tpu_all_e2e.py (a macrocyclic LIG whose C2-O1
   bond breaks, SER/ASN tips 2.3 Angstrom away, waters; n_res 48, seed
   0) inside an outer GLY/ALA body with blank element columns (4000-6000
   atoms in all), escn-md with phase 4's seed-0 weights: the element
   preflight, extraction on the card (2.6 Angstrom, ligand charge 0),
   path-search (max_depth 1, max_nodes 10), the full-system merge, and
   stage 4 (tsopt, endpoint minimization, IRC, freq) on each reactive
   segment, the pocket atoms beyond 4 Angstrom of C2 and O1 frozen and
   the unconverged parts capped (ALL_CAPS). Counts set to 0 just before
   the run and read just after: K1 and K2 forward launches 4 x (force +
   energy calls), backward 4 x force calls, none inside a Hessian; the
   pocket and full atom counts, every merged PDB at the full atom count,
   the output tree, at least one reactive segment and no stage-4 entry
   holding an error, finite energies, frequencies and thermochemistry;
   each stage's wall and calls, the Hessians, ms per force call and peak
   memory printed. Then the default subcommand (no subcommand: all) as a
   subprocess, stage 4 off;
17. the scans on escn-md (phase 4's weights, P = 320; phase 15's active
   region, the atoms within 3 Angstrom of phase 13's bond, the rest
   frozen; wells of SCAN_K): (a) run_scan, two stages (the bond 0.3
   Angstrom shorter in 0.1 Angstrom steps, then it and a second pair
   together; gau_loose, 20 cycles a step, endopt capped at 10 cycles,
   dump), each stage's last biased frame within SCAN_TOL of its targets,
   then the same call again, every stage resumed from its checkpoint
   with no force call; (b) run_scan_nd, a 3 x 3 L-BFGS grid (15 cycles a
   relaxation, 9 energy calls, surface.csv of 9 rows), then one grid
   point in rfo mode (two biased Hessians); (c) the scan and scan3d
   (2 x 2 x 2) CLIs as subprocesses; (d) run_all on phase 16's reactant
   alone with scan_stages in full-structure indices (LIG C2-O1 to 2.40
   Angstrom, remapped onto the pocket; no preopt or endopt), max_depth
   0, max_nodes 6, 5 string cycles, stage 4 off: the scan product's
   pocket C2-O1 within SCAN1B_TOL of 2.40, the path stage and merged
   PDBs at the full atom count; (e) run_dft's RHF/STO-3G engine on the
   card against the CPU for H2, HeH+ and H3+. Every run has its counts
   set to 0 just before and read just after: K1 and K2 forward launches
   4 x (force + energy calls), backward 4 x force calls, none inside a
   Hessian; wall, calls, ms a force call, Hessians and peak memory
   printed on [scan] lines;
18. delocalized internals and Direct Max Flux on escn-md (phase 4's
   weights, P = 320): (a) run_opt(coord_type="dlc") on the 300-atom
   cluster, 20 cycles, unconstrained and on phase 15's active region
   (the rest frozen, unmoved bit for bit): the primitives, n_dlc,
   cycles, force calls, E before and after (it must drop) and the host
   ms a cycle outside the force call; (b) run_tsopt(heavy,
   coord_type="dlc") from phase 13's TS guess on that active region, 20
   cycles, its two Hessians on the plain path; (c) run_mep_between
   (mep_mode="dmf") on phase 12's flagship pair, 12 images, the heavy
   ball (24 cycles) and the native C++ L-BFGS-B (12 cycles; the library
   built and used): cycles, batched calls, images evaluated, the
   constraint violation, the HEI; (d) at 64 atoms with phase 5's
   weights, 5 DLC L-BFGS cycles and 6 DMF steps of 6 images on the card
   against the CPU float64 plain path, run in a child process started
   after phase 12 (coordinates within 1e-4 of the step taken); (e) the
   path-opt --mep-mode dmf CLI as a subprocess, its DMF keys from
   --args-yaml (P = 304). Every run of (a)-(c) has its counts set to 0
   just before and read just after: K1 and K2 forward launches 4 x
   (force + energy calls), backward 4 x force calls, none inside a
   Hessian; [dlc-dmf] lines;
19. the gate and full eSCN branches and remat_blocks, on the 300-atom
   cluster (P = 320, seed-0 weights), each path with its counts set to 0
   just before and read just after: (a) escn-md-gate and (b) escn-s
   (lmax = mmax = 2, C = h = 64, 2 layers): ms per get_forces over 5
   calls, peak memory, two calls bit for bit equal, launches per force
   call (K2 4 + 4 and 2 + 2, no edge kernel: their edge paths are plain
   in both packages), a 10-cycle L-BFGS opt, and the 64-atom forces
   against the CPU float64 plain path (computed by phase 18d's child
   process after its own runs) within FORCE_TOL; (c) escn-md with
   remat_blocks=True in pallas-mega on phase 4's weights: K1 8 + 4 and
   K2 8 + 4 launches per force call (every forward recomputed in the
   backward), forces bit for bit equal to phase 4's, peak memory and
   ms both ways; [branch] lines;
20. ranks on the card (four started with "spawn", gloo through host
   memory; [ranks] lines, each beside the card's name and power limit):
   (a) phase 12's flagship string with its images over a data axis of
   four (`Calculator(mesh=make_mesh(data=4))`, phase 4's weights): the
   same cycles and force calls as phase 12 on every rank, images and
   energies bit for bit, K1 and K2 launches summed over the ranks equal
   to phase 12's, the wall beside phase 12's; (b) phase 12's 64-atom
   analytic Hessian with its 186 tangents over the four data ranks,
   against phase 12's (bit for bit when the plain path repeats bit for
   bit in one process, which the parent checks first; else within
   SHARD_TOL), the wall beside phase 12's; (c) run_freq on phase 15's TS
   guess (17 active atoms, 51 HVPs) with the calculator sharded over the
   four as model ranks, its Hessian through the sharded plain closure
   and the collectives' double backward: against the parent's unsharded
   run_freq within SHARD_TOL of max|H| and P20_FREQ_TOL cm^-1, bit for
   bit on the four ranks, ms per sharded HVP, peak memory per rank, no
   launch inside the Hessian and K3 4 + 4, K2 4 + 4 outside it; (d) the
   all CLI at phase 16's settings under `torch.distributed.run
   --nproc-per-node 2` with `--workers 2`: summary.yaml equal to phase
   16's (when (a) is bit for bit), the stages' force calls equal, rank
   0's tree the only output, no rank scratch left; (e) where the host
   has two or more cards, (a) again with one rank a card over NCCL,
   else a line saying it did not run;
21. training (mlip/train.py; [train] and [wgrad] lines, each beside the
   card's name and power limit): (a) escn-md at full width, its 8-expert
   banks unmerged, on the plain "xla" route (make_escn_train_step) and
   (b) uma-s-1p1 dense (make_train_step), each on structures of 64 atoms
   (chip_smoke.cluster, jittered; numpy-seeded targets): one step on 2
   structures against the same step on the CPU in float64 (a child
   process started after phase 18: loss rel 1e-4, each gradient leaf, its
   first moment / (1 - b1), within 1e-4 of its max|g|), then 20 Adam
   steps at 3e-3 on 4 / 8 structures that must bring the loss below 0.9
   x its first value, ms per step and peak memory; (c) pallas-mega and
   mp_mode="pallas" steps refused on the card with no launch before the
   raise; (d) dE/dW through K1, K3 and K4 (each with K2) at 300 atoms on
   phase 4's weights, unmerged, against the plain route on the card
   within KERNEL_TOL of each leaf's max, their launches counted, a force
   call with and without weight gradients timed, and phase 4's force
   call again bit for bit; (e) four gloo ranks on the card: one dp 2 x
   tp 2 step of (b) and one dp 2 x ep 2 step of (a) at 1e-3, each in
   float64 and in float32, against the same step in one process (loss
   rel 1e-4; gradients within 1e-6 of each leaf's max in float64, 1e-4
   in float32; parameters within 1e-5 in float64),
   and the tensor-parallel uma-s-1p1 dense calculator at 300 atoms
   (make_mesh(data=2, model=2), shard_params_model) against the
   replicated one (energy rel 1e-6, forces within SHARD_TOL of max|F|,
   the batched call too).
22. chunked batching and Orbax checkpoints ([chunk] and [ckpt] lines):
   (d) whether `tensorstore` imports; without it `checkpoint=<a tree>`
   must raise the ImportError naming it before any launch, with it
   phase 4's weights are written and read back bit for bit; (a) 8 of
   phase 12's string images (its interior) through get_forces_batch at
   batch_chunk 1 and 8 on phase 4's weights: ms a batch, peak memory,
   K1 / K2 launches a batch (32 + 32 against 4 + 4: one stacked pass),
   energies within P22_E_TOL relative and forces within P22_F_TOL of
   max|F|; K1 and K2 at the stacked pass's first-layer shapes against
   their plain versions, their ms a launch and bounds beside phase 3's;
   (b) phase 5's 64-atom Hessians (atoms 0 and 1 frozen): analytic at
   HVP chunk 1 / 8 / 64 and FD through K1 and K2 at FD chunk 1 / 8 / 64,
   wall, peak memory, stacked passes and launches, the chunks against
   chunk 1 (analytic within P22_HESS_TOL of max|H|, FD within twice the
   FD Hessian's own error against the analytic one); (c) HVP batches of
   phase 4's calculator at 300 atoms at C = 1, 8 and the default, ms a
   tangent and peak memory, against single HVPs.

The line before the last is one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}. Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
F32_PEAK = 67e12          # H100 SXM FP32 outside the tensor cores, FLOP/s
TF32_PEAK = 495e12        # H100 SXM dense TF32 tensor cores, FLOP/s
BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor cores, FLOP/s
HBM_RATE = 3.35e12        # H100 SXM HBM3, bytes/s
KERNEL_TOL = 1e-4         # max|kernel - plain| / max|plain| (f32 sums
                          # reordered against the plain path)
FORCE_TOL = 1e-4          # max|F_card - F_cpu64| / max|F_cpu64|
SHARD_TOL = 1e-5          # sharded against unsharded on the card (f32,
                          # the same kernels' sums split over four ranks)
RANKS = 4                 # the sharded phase: four ranks on one card

REPLACES = {
    "fused_edge_mega_fwd": "pdb2reaction_tpu/mlip/escn_edge_kernel.py:1147",
    "fused_edge_mega_bwd": "pdb2reaction_tpu/mlip/escn_edge_kernel.py:1274",
    "fused_edge_block_fwd": "pdb2reaction_tpu/mlip/escn_edge_kernel.py:594",
    "fused_edge_block_bwd": "pdb2reaction_tpu/mlip/escn_edge_kernel.py:657",
    "fused_edge_chain_fwd": "pdb2reaction_tpu/mlip/escn_edge_kernel.py:198",
    "fused_edge_chain_bwd": "pdb2reaction_tpu/mlip/escn_edge_kernel.py:238",
    "fused_node_ffn_fwd": "pdb2reaction_tpu/mlip/escn_ffn_kernel.py:68",
    "fused_node_ffn_bwd": "pdb2reaction_tpu/mlip/escn_ffn_kernel.py:82",
    "radial_contract_fwd": "pdb2reaction_tpu/mlip/pallas_ops.py:129",
    "radial_contract_bwd_feats": "pdb2reaction_tpu/mlip/pallas_ops.py:352",
    "radial_contract_bwd_coords": "pdb2reaction_tpu/mlip/pallas_ops.py:256",
    "radial_contract_rect_fwd": "pdb2reaction_tpu/mlip/pallas_ops.py:474",
    "radial_contract_rect_bwd_feats":
        "pdb2reaction_tpu/mlip/pallas_ops.py:568",
    # one kernel for both coordinate gradients: the rows' and the columns'
    "radial_contract_rect_bwd_coords":
        "pdb2reaction_tpu/mlip/pallas_ops.py:594, "
        "pdb2reaction_tpu/mlip/pallas_ops.py:623",
}
# the peak of the route each kernel takes to f32 accuracy at the shapes
# this script runs, FLOP/s of needed work: K5's and K6's three kernels
# (R + 1 = 25 <= 32), the conv products of K1, K3 and K4
# (95% of their FLOP) and K2's GEMMs (all of its FLOP but the sums over
# the grid) form each product in 3xTF32, three TF32 products per f32 one;
# every other kernel runs f32 on CUDA cores
ROUTE_PEAK = {k: TF32_PEAK / 3 for k in (
    "radial_contract_fwd", "radial_contract_bwd_feats",
    "radial_contract_bwd_coords", "radial_contract_rect_fwd",
    "radial_contract_rect_bwd_feats", "radial_contract_rect_bwd_coords",
    "fused_edge_mega_fwd",
    "fused_edge_mega_bwd", "fused_edge_block_fwd", "fused_edge_block_bwd",
    "fused_edge_chain_fwd", "fused_edge_chain_bwd", "fused_node_ffn_fwd",
    "fused_node_ffn_bwd")}
SOURCES = {
    "fused_edge_mega": "pdb2reaction_tpu_torch/csrc/escn_edge.cu",
    "fused_edge_block": "pdb2reaction_tpu_torch/csrc/escn_edge.cu",
    "fused_edge_chain": "pdb2reaction_tpu_torch/csrc/escn_edge.cu",
    "fused_node_ffn": "pdb2reaction_tpu_torch/csrc/escn_ffn.cu",
    "radial_contract": "pdb2reaction_tpu_torch/csrc/radial_contract.cu",
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


@contextlib.contextmanager
def env_set(**kw):
    """The environment variables ``kw`` set while the block runs."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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

def conv_flops(cfg, E):
    """FLOP of the two conv products over E edges (either direction)."""
    from pdb2reaction_tpu_torch.mlip.escn_edge_kernel import _dims
    nl0, nls, U, G = _dims(cfg)
    C, H, Ce = cfg.sphere_channels, cfg.hidden_channels, cfg.edge_channels
    rows = [nl0] + [2 * nl for nl in nls]
    conv1 = sum(2 * (r * 2 * C + (Ce if i == 0 else 0)) * r * H
                for i, r in enumerate(rows))
    conv2 = sum(2 * (r * H) * (r * C) for r in rows)
    return E * (conv1 + conv2)


def edge_flops(cfg, E, rotations=True):
    """(forward, backward) FLOP of one edge-kernel launch over E edges:
    the conv products and the S2 grid, plus the block-sparse rotations for
    K1 and K3 (``rotations``); K4 runs the chain alone."""
    from pdb2reaction_tpu_torch.mlip.escn_edge_kernel import _dims, _rot_nz
    nl0, nls, U, G = _dims(cfg)
    C, H = cfg.sphere_channels, cfg.hidden_channels
    nnz = len(_rot_nz(cfg.lmax, cfg.mmax)[0])
    grid = 2 * 2 * G * U * H
    rot_f = 2 * nnz * C * 3 if rotations else 0   # source, target, back
    rot_b = 2 * nnz * C * 6 if rotations else 0   # g_out, gDpe, gDp x2, gx x2
    conv = conv_flops(cfg, E)
    return (conv + E * (grid + rot_f), conv + E * (3 * grid // 2 + rot_b))


def gemm_rates(cfg, E, weights, reps):
    """ms and TFLOP/s of the conv products alone (``conv_pair``: the two
    grouped 3xTF32 launches of one direction on K1's layouts, random
    operands), forward and backward; no wrapper, so no launch is counted."""
    import torch
    from pdb2reaction_tpu_torch.mlip import cuda_build as cb
    from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
    nl0, nls, U, G = ek._dims(cfg)
    C, H, Ce = cfg.sphere_channels, cfg.hidden_channels, cfg.edge_channels
    w1, b1, w2, b2, w1t, w2t = ek._pack_weights(weights)
    gen = torch.Generator(device="cuda").manual_seed(6)
    wide = torch.randn(E, U * 2 * C + Ce, generator=gen, device="cuda")
    mid = torch.empty(E, U * H, device="cuda")
    narrow = torch.randn(E, U * C, generator=gen, device="cuda")
    lib = cb.load("escn_edge")
    args = {0: (wide, w1t, b1, w2t, b2, narrow), 1: (narrow, w2, None, w1,
                                                     None, wide)}
    out = []
    for bwd in (0, 1):
        src, wa, ba, wb, bb, dst = args[bwd]
        ms = cuda_ms(lambda: cb.call(
            lib, "conv_pair", E, C, H, Ce, cfg.lmax, cfg.mmax, bwd,
            cb.ptr(src), cb.ptr(wa), cb.ptr(ba), cb.ptr(wb), cb.ptr(bb),
            cb.ptr(mid), cb.ptr(dst), cb.stream_ptr()), reps)
        out.append((ms, conv_flops(cfg, E) / ms / 1e9))
    return out


def k2_flops(M, C, H, G, P):
    return (P * (2 * G * M * C * 2 + 2 * G * C * H * 2),
            P * (2 * G * M * C * 3 + 2 * G * C * H * 3))


def k2_stages(cfg, x, weights, tables, gen, reps):
    """K2's launches one by one at the main path's shapes (``gemm_tf32`` /
    ``grid_sum_cuda``: the kernels of ``k2_fwd`` / ``k2_bwd`` alone, on the
    wrapper's operands; no launch counted), ms and TFLOP/s of the
    function's FLOP (GEMMs) or GB/s of the bytes read and written
    (grid_sum); then the peak memory of one forward and one backward
    launch above what was held before. One log line."""
    import torch
    from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
    o = fk.route_operands(weights, tables)
    P, M, C = x.shape
    G, Mp = o.tgp.shape
    H = o.w1t.shape[0]
    R = G * P
    g = torch.randn(x.shape, generator=gen, device=x.device)
    xc, gc = fk.node_cols(x, Mp), fk.node_cols(g, Mp)
    grid = x.new_empty(G, P * C)
    rows = grid.view(R, C)
    hid = x.new_empty(R, H)
    out = x.new_empty(P, M, C)
    gemm, gsum = fk.gemm_tf32, fk.grid_sum_cuda
    tab, ffn = 2 * G * P * C * M, 2 * R * C * H
    gs_bytes = 4 * (G * P * C + Mp * G + P * M * C)
    steps = {"fwd": [
        ("to-grid", lambda: gemm(o.tgp, xc, c=grid), tab),
        ("hidden silu", lambda: gemm(rows, o.w1t, o.b1, "silu", c=hid), ffn),
        ("out rows", lambda: gemm(hid, o.w2t, o.b2, c=rows), ffn),
        ("grid_sum fg", lambda: gsum(o.fgtp, grid, P, C, M, out), None)],
        "bwd": [
        ("to-grid", lambda: gemm(o.tgp, xc, c=grid), tab),
        ("silu'", lambda: gemm(rows, o.w1t, o.b1, "dsilu", c=hid), ffn),
        ("dy", lambda: gemm(o.fgtp, gc, c=grid), tab),
        ("dpre", lambda: gemm(rows, o.w2, epi="mul", c=hid), ffn),
        ("dgrid", lambda: gemm(hid, o.w1, c=rows), ffn),
        ("grid_sum tg^T", lambda: gsum(o.tgp, grid, P, C, M, out), None)]}
    parts, total = [], {}
    for d, lst in steps.items():
        items = []
        total[d] = 0.0
        for name, fn, fl in lst:
            ms = cuda_ms(fn, reps)
            total[d] += ms
            rate = (f"{fl / ms / 1e9:.1f} TFLOP/s" if fl else
                    f"{gs_bytes / ms / 1e6:.0f} GB/s")
            items.append(f"{name} {ms:.3f} ms ({rate})")
        parts.append(f"{d}: " + ", ".join(items) + f"; sum {total[d]:.3f} ms")
    del grid, rows, hid, out, xc, gc
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    xl = x.clone().requires_grad_(True)
    y = fk.fused_node_ffn(cfg, xl, weights, tables)
    torch.cuda.synchronize()
    peak_f = torch.cuda.max_memory_allocated() - base
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.autograd.grad(y, [xl], g)
    torch.cuda.synchronize()
    peak_b = torch.cuda.max_memory_allocated() - base
    log(f"[K2-stages] P={P}, M={M} (Mp={Mp}), C={C}, H={H}, G={G}; "
        + "; ".join(parts) + f"; peak memory above the inputs: forward "
        f"launch {peak_f / 2 ** 20:.1f} MiB, backward launch "
        f"{peak_b / 2 ** 20:.1f} MiB")
    return total


def bound_ms(flops, nb, name=None):
    """(f32 bound, bf16 bound, what bounds f32) in ms: the larger of the
    bytes over HBM_RATE and the FLOP over the kernel's f32 route's peak
    (``ROUTE_PEAK``, else the CUDA-core peak) or the bf16 peak."""
    rate = ROUTE_PEAK.get(name, F32_PEAK)
    t32 = max(flops / rate, nb / HBM_RATE) * 1e3
    tbf = max(flops / BF16_PEAK, nb / HBM_RATE) * 1e3
    by = "operations" if flops / rate >= nb / HBM_RATE else "bytes"
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
    times = cuda_build.build(["escn_edge", "escn_ffn", "radial_contract"],
                             verbose=True)
    for name, rec in cuda_build.BUILD_LOG.items():
        entry = ""
        for line in rec["log"].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {entry}: {line.strip()}")
    log(f"[build] {times} (wall {time.perf_counter() - t0:.1f} s)")


def _leaves(ts):
    return [t.detach().clone().requires_grad_(True) for t in ts]


def edge_parity(tag, kern, plain, args, at, names, reps, gen):
    """An edge kernel against its plain version on ``args``, whose entries
    at positions ``at`` (named ``names``) are the differentiable inputs:
    values and input cotangents, then CUDA-event times of the forward and
    the backward. Returns (abs err fwd, abs err bwd, ms fwd, plain ms fwd,
    ms bwd, plain ms bwd, output cotangent, plain output and cotangents).
    """
    import torch

    def put(leaves):
        a = list(args)
        for i, t in zip(at, leaves):
            a[i] = t
        return a

    lv = _leaves([args[i] for i in at])
    lp = _leaves([args[i] for i in at])
    y_k = kern(*put(lv))
    y_p = plain(*put(lp))
    torch.cuda.synchronize()
    g = torch.randn(y_p.shape, generator=gen, device=y_p.device)
    gk = torch.autograd.grad(y_k, lv, g, retain_graph=True)
    gp = torch.autograd.grad(y_p, lp, g, retain_graph=True)
    torch.cuda.synchronize()
    e_fwd = rel_err(y_k, y_p)
    e_bwd = {n: rel_err(a, b) for n, a, b in zip(names, gk, gp)}
    eb = ", ".join(f"{n} {v:.3e}" for n, v in e_bwd.items())
    log(f"[{tag}] fwd rel err {e_fwd:.3e}, abs {abs_err(y_k, y_p):.3e} "
        f"(max|ref| {float(y_p.detach().abs().max()):.3e}); bwd rel err {eb} "
        f"(tol {KERNEL_TOL})")
    if not (e_fwd <= KERNEL_TOL and max(e_bwd.values()) <= KERNEL_TOL):
        fail(f"{tag} disagrees with its plain version")
    with torch.no_grad():
        t_fwd = cuda_ms(lambda: kern(*args), reps)
        t_fwd_p = cuda_ms(lambda: plain(*args), reps)
    t_bwd = cuda_ms(lambda: torch.autograd.grad(y_k, lv, g,
                                                retain_graph=True), reps)
    t_bwd_p = cuda_ms(lambda: torch.autograd.grad(y_p, lp, g,
                                                  retain_graph=True), reps)
    a_fwd = abs_err(y_k, y_p)
    a_bwd = max(abs_err(a, b) for a, b in zip(gk, gp))
    return (a_fwd, a_bwd, t_fwd, t_fwd_p, t_bwd, t_bwd_p, g,
            y_p.detach(), [t.detach() for t in gp])


def phase_kernels(calc, cfg, quick):
    """Each kernel against its plain version at the main path's shapes:
    K1 and K2 at the first-layer inputs of the default layout, K3 and K4
    at those of the "pallas-full" and "pallas" layouts (same system and
    weights)."""
    import dataclasses

    import torch
    from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
    from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
    from pdb2reaction_tpu_torch.mlip.escn import first_layer_kernel_args
    reps = 3 if quick else 20
    c = calc._to_pad_ang(calc.structure.coords_bohr)

    def first_layer(edge_kernel):
        with torch.no_grad():
            return first_layer_kernel_args(
                c, calc.system, calc.params,
                dataclasses.replace(cfg, edge_kernel=edge_kernel))

    edge_args, ffn_args, _ = first_layer("pallas-mega")
    rows = {}
    nl0, nls, U, G = ek._dims(cfg)
    H, C = cfg.hidden_channels, cfg.sphere_channels
    dev = c.device
    gen = torch.Generator(device=dev).manual_seed(0)

    def add_rows(base, res, flops, b_fwd, b_bwd):
        a_f, a_b, t_f, t_fp, t_b, t_bp = res[:6]
        rows[f"{base}_fwd"] = (a_f, t_f, t_fp, flops[0], b_fwd)
        rows[f"{base}_bwd"] = (a_b, t_b, t_bp, flops[1], b_bwd)

    # ---- K1 --------------------------------------------------------------
    _, x_t, src, es, Dp, Dpe, weights, tables = edge_args
    wts = [*ek._flat_weights(weights), *tables]
    E = src.numel()
    saved = E * U * (H + C) * 4                     # msg, conv-2 output
    res = edge_parity("K1", ek.fused_edge_mega, ek.fused_edge_mega_plain,
                      edge_args, (1, 3, 4, 5), ("x", "es", "Dp", "Dpe"),
                      reps, gen)
    g, y_p, gp = res[6:]
    add_rows("fused_edge_mega", res, edge_flops(cfg, E),
             nbytes(x_t, src, es, Dp, Dpe, *wts, y_p) + saved,
             nbytes(x_t, g, src, Dp, Dpe, *wts, *gp) + saved)
    del res, g, y_p, gp
    (tf, rf), (tb, rb) = gemm_rates(cfg, E, weights, reps)
    log(f"[K1-gemm] the conv products alone (conv_tf32, one grouped launch "
        f"per conv, 3xTF32), {conv_flops(cfg, E) / 1e9:.1f} GFLOP a "
        f"direction: forward {tf:.3f} ms, {rf:.1f} TFLOP/s; backward "
        f"{tb:.3f} ms, {rb:.1f} TFLOP/s (route peak "
        f"{TF32_PEAK / 3 / 1e12:.0f})")

    # ---- K3: per-edge source and target rows of "pallas-full" -------------
    args3, _, _ = first_layer("pallas-full")
    _, xs_t, xt_t, es, Dp, Dpe, _, _ = args3
    res = edge_parity("K3", ek.fused_edge_block, ek.fused_edge_block_plain,
                      args3, (1, 2, 3, 4, 5), ("xs", "xt", "es", "Dp", "Dpe"),
                      reps, gen)
    g, y_p, gp = res[6:]
    add_rows("fused_edge_block", res, edge_flops(cfg, E),
             nbytes(xs_t, xt_t, es, Dp, Dpe, *wts, y_p) + saved,
             nbytes(xs_t, xt_t, g, Dp, Dpe, *wts, *gp) + saved)
    del res, g, y_p, gp, args3, xs_t, xt_t

    # ---- K4: rotated pair rows of "pallas" --------------------------------
    args4, _, _ = first_layer("pallas")
    _, pr, es, _, _ = args4
    res = edge_parity("K4", ek.fused_edge_chain, ek.fused_edge_chain_plain,
                      args4, (1, 2), ("pr", "es"), reps, gen)
    g, y_p, gp = res[6:]
    add_rows("fused_edge_chain", res, edge_flops(cfg, E, rotations=False),
             nbytes(pr, es, *wts, y_p) + E * U * H * 4,
             nbytes(g, *wts, *gp) + E * U * H * 4)
    del res, g, y_p, gp, args4, pr

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
    del o_k, o_p, dk, dp, xk, xp, g2
    k2_stages(cfg_, xn2, fw, ftab, gen, reps)
    for k, (err, t, tp, fl, nb) in rows.items():
        b32, bbf, by = bound_ms(fl, nb, k)
        route = "3xTF32" if k in ROUTE_PEAK else "f32 CUDA cores"
        log(f"[kernel] {k}: {t:.3f} ms (plain {tp:.3f} ms), "
            f"{fl / 1e9:.1f} GFLOP, {nb / 1e6:.1f} MB, bound at f32 "
            f"accuracy {b32:.3f} ms ({route}, {by}) / bf16 {bbf:.3f} ms; "
            f"{fl / t / 1e9:.2f} TFLOP/s")
    return rows


def zero_escn_counts():
    from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
    from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
    for d in (ek.launches, fk.launches):
        for k in d:
            d[k] = 0


def escn_counts():
    from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
    from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
    return {**ek.launches, **fk.launches}


def phase_force(calc, reps):
    """ms per force call over ``reps`` synchronised calls after one
    warm-up, peak memory, and a further call that must repeat the forces
    bit for bit. Returns (the forces, ms per call)."""
    import torch
    cb = calc.structure.coords_bohr.reshape(-1)
    layout = calc.cfg.edge_kernel
    calc.force_calls = 0
    base = torch.cuda.memory_allocated() / 2 ** 30
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
        fail(f"{layout} force call returned non-finite or mis-shaped output")
    same = np.array_equal(calc.get_forces(cb)["forces"], f)
    log(f"[force] escn-md {layout}, {calc.n_atoms} atoms (P={calc.n_pad}): "
        f"{ms:.2f} ms per get_forces over {reps} calls, peak memory "
        f"{peak:.2f} GiB ({peak - base:.2f} above the {base:.2f} GiB held "
        f"before), E = {res['energy']:.8f} Ha, max|F| = "
        f"{np.abs(f).max():.3e} Ha/Bohr; next call bit for bit equal: "
        f"{same}; launches after {calc.force_calls} calls: {escn_counts()}")
    if not same:
        fail(f"{layout}: two force calls gave different forces")
    return f, ms


def phase_reference(seed):
    """Card forces of each edge-kernel layout against the plain path on
    the CPU in float64, same weights. Returns (the 64-atom structure, its
    weights, the CPU float64 calculator) for phase 12."""
    import torch
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.escn import (EDGE_KERNELS, ESCN_CONFIGS,
                                                  init_escn_params)
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    zs, xyz = cluster(64, seed=1)
    st = Structure(zs, xyz)
    w = init_escn_params(ESCN_CONFIGS["escn-md"], seed=seed, device="cpu")
    cpu = make_uma_calculator(st, model="escn-md", device="cpu",
                              dtype=torch.float64, params=w)
    cb = st.coords_bohr.reshape(-1)
    t0 = time.perf_counter()
    rc = cpu.get_forces(cb)
    t_cpu = time.perf_counter() - t0
    for layout in EDGE_KERNELS:
        gpu = make_uma_calculator(st, model="escn-md", device="cuda",
                                  params=w, edge_kernel=layout)
        rg = gpu.get_forces(cb)
        err = float(np.abs(rg["forces"] - rc["forces"]).max()
                    / np.abs(rc["forces"]).max())
        de = abs(rg["energy"] - rc["energy"])
        log(f"[reference] 64 atoms escn-md {layout}: card f32 kernels vs "
            f"CPU f64 plain path: max|dF|/max|F| = {err:.3e} (tol "
            f"{FORCE_TOL}), |dE| = {de:.3e} Ha (CPU call {t_cpu:.1f} s)")
        if not err <= FORCE_TOL:
            fail(f"{layout} card forces disagree with the CPU float64 plain "
                 "path")
    return st, w, cpu


def phase_opt(calc, cycles, name="escn-md"):
    from pdb2reaction_tpu_torch.core.io_xyz import write_xyz
    from pdb2reaction_tpu_torch.workflows.opt import run_opt
    layout = calc.cfg.edge_kernel
    out = os.path.join(HERE, "result_smoke")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "cluster300.xyz")
    final = os.path.join(out, "final_geometry.xyz")
    if os.path.exists(final):
        os.remove(final)
    write_xyz(path, calc.structure)
    e0 = calc.get_energy(calc.structure.coords_bohr)["energy"]
    t0 = time.perf_counter()
    res = run_opt(path, charge=0, spin=1, model=name, device="cuda",
                  max_cycles=cycles, out_dir=out, calc=calc, verbose=False)
    wall = time.perf_counter() - t0
    log(f"[opt] {name} {layout} L-BFGS, 300 atoms: E {e0:.8f} -> "
        f"{res['energy']:.8f} Ha in {res['cycles']} cycles, "
        f"{res['force_calls']} force calls, {wall:.2f} s wall "
        f"({wall / max(res['force_calls'], 1) * 1e3:.1f} ms per force call)")
    if not (np.isfinite(res["energy"]) and res["energy"] < e0):
        fail(f"{layout} opt did not lower the energy")
    if not os.path.exists(final):
        fail(f"{layout} opt wrote no final_geometry.xyz")
    return res, wall


def phase_layout(st, layout, ref_forces, reps, cycles):
    """The escn-md force call in another edge-kernel layout, its own path:
    counts set to 0 just before and read just after. Forces against the
    "pallas-mega" path's, and the layout's kernels and K2 must launch."""
    import torch
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    base = {"pallas-full": "fused_edge_block", "pallas": "fused_edge_chain"}
    calc = make_uma_calculator(st, model="escn-md", device="cuda", seed=0,
                               pad_multiple=64, edge_kernel=layout)
    zero_escn_counts()
    f, _ = phase_force(calc, reps)
    if cycles:
        phase_opt(calc, cycles)
    launches = escn_counts()                 # read just after the path
    err = float(np.abs(f - ref_forces).max() / np.abs(ref_forces).max())
    log(f"[layout] escn-md {layout} vs pallas-mega on the card, same "
        f"weights: max|dF|/max|F| = {err:.3e} (tol {FORCE_TOL}); launches "
        f"on the path {launches}")
    if not err <= FORCE_TOL:
        fail(f"{layout} forces disagree with the pallas-mega path")
    need = [f"{base[layout]}_fwd", f"{base[layout]}_bwd",
            "fused_node_ffn_fwd", "fused_node_ffn_bwd"]
    never = [k for k in need if launches[k] == 0]
    if never:
        fail(f"kernels never launched on the {layout} path: {never}")
    del calc
    torch.cuda.empty_cache()
    return {k: launches[k] for k in need[:2]}


# ---------------------------------------------------------------------------
# phase 12: the GSM string, HVPs and Hessians on the escn-md calculator
# ---------------------------------------------------------------------------

GSM_CONV = 2.0e-2   # perpendicular-force RMS criterion, Hartree/Bohr: the
                    # criterion the JAX package's bench calibrated for
                    # untrained weights (trained weights: 1e-3)
HESS_TOL = 1e-3     # max|dH| / max|H_cpu64| on the checked columns: the
#                     outer limit; the check holds the card to twice CPU
#                     float32's own error, with a floor of HESS_FLOOR
HESS_FLOOR = 1e-5
MAIN_PATH = ("fused_edge_mega_fwd", "fused_edge_mega_bwd",
             "fused_node_ffn_fwd", "fused_node_ffn_bwd")


def all_counts():
    """Every kernel wrapper's launch count."""
    from pdb2reaction_tpu_torch.mlip import radial_contract as rcm
    return {**escn_counts(), **rcm.launches, **rcm.rect_launches}


def zero_all_counts():
    """Every kernel wrapper's launch count set to 0."""
    from pdb2reaction_tpu_torch.mlip import radial_contract as rcm
    zero_escn_counts()
    for d in (rcm.launches, rcm.rect_launches):
        for k in d:
            d[k] = 0


def moved_counts(before):
    return {k: v - before[k] for k, v in all_counts().items()
            if v != before[k]}


def endpoint_b(xyz, free, seed=1, scale=0.08):
    """The flagship's second endpoint: A plus a seeded normal displacement
    of ``scale`` Angstrom on the free atoms (float32, as the JAX
    package's bench draws it)."""
    rng = np.random.default_rng(seed)
    disp = rng.normal(scale=scale, size=xyz.shape).astype(np.float32)
    return xyz + disp * free[:, None]


def gsm_flagship(calc, xA, xB, ms_force):
    """The flagship MEP through the calculator's batched closure: one
    warm-up, then the measured run with its counts set to 0 just before
    and read just after. Returns the measured run's GsmResult, its wall
    time and its launches."""
    import torch
    from pdb2reaction_tpu_torch.engines.gsm import gsm_mep
    fm = calc.system.free_mask
    eb = calc.au_energy_force_batch_fn()
    kw = dict(max_nodes=10, conv_perp_rms=GSM_CONV, climb=False)
    t0 = time.perf_counter()
    gsm_mep(eb, xA, xB, fm, max_cycles=8, stop_in_when_full=2, **kw)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    trace = []
    zero_escn_counts()
    before = all_counts()
    n0 = calc.force_calls
    t0 = time.perf_counter()
    res = gsm_mep(eb, xA, xB, fm, max_cycles=60, stop_in_when_full=60,
                  on_cycle=lambda c, r: trace.append(r), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = moved_counts(before)
    M = 12
    fc = res.force_calls
    log(f"[gsm] flagship escn-md pallas-mega, {calc.n_atoms} atoms "
        f"(P={calc.n_pad}), host loop, max_nodes=10, climb off, criterion "
        f"perp RMS < {GSM_CONV} Ha/Bohr: {wall:.2f} s wall, {res.cycles} "
        f"cycles, {fc} force calls, converged {res.converged}, final perp "
        f"RMS {res.perp_rms:.4e} Ha/Bohr; {wall / fc * 1e3:.2f} ms per force "
        f"call inside the MEP (phase 4: {ms_force:.2f} ms per get_forces); "
        f"warm-up (8 cycles) {warm:.2f} s; launches {moved}")
    log(f"[gsm] perp RMS by relaxation cycle: "
        f"{[float(f'{r:.4e}') for r in trace]}")
    if fc != (res.cycles + 1) * M:
        fail(f"GSM force calls {fc} != (cycles + 1) x {M}")
    if calc.force_calls - n0 != fc:
        fail(f"the calculator counted {calc.force_calls - n0} force calls "
             f"for the string's {fc}")
    want = {k: 4 * fc for k in MAIN_PATH}
    if moved != want:
        fail(f"GSM launches {moved}, expected {want} (4 layers a call)")
    ends = (res.images[0], res.images[-1])
    if not (np.array_equal(ends[0], xA.cpu().numpy())
            and np.array_equal(ends[1], xB.cpu().numpy())):
        fail("the GSM endpoints moved")
    if not np.all(np.isfinite(res.energies)) \
            or not np.all(np.isfinite(res.images)):
        fail("the GSM string has non-finite energies or images")
    return res, wall, moved


def gsm_climb(calc, xA, xB):
    """The same string with the climbing image on Lanczos tangents; every
    HVP counted and timed, and checked to launch no kernel."""
    import torch
    from pdb2reaction_tpu_torch.engines.gsm import gsm_mep
    hvp = calc.au_hvp_fn()
    st = {"n": 0, "s": 0.0, "moved": {}}

    def counted(x, v):
        before = all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = hvp(x, v)
        torch.cuda.synchronize()
        st["s"] += time.perf_counter() - t0
        st["n"] += 1
        for k, d in moved_counts(before).items():
            st["moved"][k] = st["moved"].get(k, 0) + d
        return out

    n0 = calc.force_calls
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = gsm_mep(calc.au_energy_force_batch_fn(), xA, xB,
                  calc.system.free_mask, max_nodes=10, climb=True,
                  climb_lanczos=True, climb_rms=GSM_CONV,
                  conv_perp_rms=GSM_CONV, lanczos_iters=10, max_cycles=30,
                  stop_in_when_full=30, hvp_fn=counted)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = st["n"]
    log(f"[gsm] climbing image with Lanczos tangents: {wall:.2f} s wall, "
        f"{res.cycles} cycles, {res.force_calls} force calls, converged "
        f"{res.converged}, HEI {res.hei_idx}, final perp RMS "
        f"{res.perp_rms:.4e}; {n} HVPs ({n // 10} Lanczos runs of 10), "
        f"{st['s'] / max(n, 1) * 1e3:.1f} ms per HVP at {calc.n_atoms} atoms "
        f"(the first of a run builds the graph), {st['s'] / max(n // 10, 1):.2f}"
        f" s per Lanczos run; peak memory {peak:.2f} GiB, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held after the "
        f"run; kernel launches inside HVPs: {st['moved']}")
    if n < 10 or n % 10:
        fail(f"the climbing image did not switch on with Lanczos tangents "
             f"({n} HVPs)")
    if st["moved"]:
        fail(f"kernels launched inside HVPs: {st['moved']}")
    if calc.force_calls - n0 != res.force_calls \
            or res.force_calls != (res.cycles + 1) * 12:
        fail("climbing GSM force-call accounting is off")


P12_FROZEN = [0, 1]
P12_COLS = list(range(6, 9))            # atom 2


def hess_columns(st, w, dtype):
    """Phase 12's HVP columns ``P12_COLS`` of the 64-atom Hessian on the
    CPU's plain path in ``dtype``, Hartree/Bohr^2."""
    import torch
    from pdb2reaction_tpu_torch.constants import H_EVAA_2_AU
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    cb = st.coords_bohr.reshape(-1)
    c = make_uma_calculator(st, model="escn-md", device="cpu", dtype=dtype,
                            params=w, freeze_atoms=P12_FROZEN)
    hvp, x = c.au_hvp_fn(), c.pad_bohr(cb)
    out = []
    for k in P12_COLS:
        v = torch.zeros_like(x)
        v.view(-1)[k] = 1.0
        out.append(hvp(x, v).reshape(-1)[:cb.size].double().numpy())
    return np.stack(out) * H_EVAA_2_AU


def p12_cpu_reference(out_path):
    """Phase 12's CPU float64 and float32 columns in their own process
    (``--p12-cpu OUT``, started after the build) while the card works
    through phases 3-5, on phase 5's 64-atom cluster and weights."""
    import torch
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.escn import (ESCN_CONFIGS,
                                                  init_escn_params)
    torch.set_num_threads(6)        # beside the card phases' host work
    st = Structure(*cluster(64, seed=1))
    w = init_escn_params(ESCN_CONFIGS["escn-md"], seed=0, device="cpu")
    t0 = time.perf_counter()
    h64 = hess_columns(st, w, torch.float64)
    t64 = time.perf_counter() - t0
    np.savez(out_path, H64=h64, H32=hess_columns(st, w, torch.float32),
             t64=t64)


def start_cpu_child(flag, name):
    """``chip_smoke.py --<flag> result_smoke/<name>`` in a child process,
    killed at exit if still running: (process, output path)."""
    import atexit
    out = os.path.join(HERE, "result_smoke", name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             f"--{flag}", out], cwd=HERE,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out


def hessians_64(ref64, p12_cpu):
    """The analytic Hessian on the card (all-plain, one HVP a free DOF:
    186, one host copy) against CPU float64 and float32 HVP columns (from
    the child process ``p12_cpu``), and the FD Hessian through the
    kernels, at 64 atoms with atoms 0 and 1 frozen. Returns the analytic
    Hessian and its wall time."""
    import torch
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    st, w, _ = ref64
    frozen = P12_FROZEN
    cb = st.coords_bohr.reshape(-1)
    n3 = cb.size
    gpu = make_uma_calculator(st, model="escn-md", device="cuda", params=w,
                              freeze_atoms=frozen)
    gpu.get_forces(cb)                        # warm-up of the force path
    before = all_counts()
    n0 = gpu.force_calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # one tangent a backward, as phase 20 (b)'s ranks take them (the
    # default chunk split over four ranks); phase 22 (b) runs the chunks
    with env_set(PDB2R_TPU_HVP_CHUNK=1):
        H = gpu.get_hessian(cb)["hessian"]
    torch.cuda.synchronize()
    t_an = time.perf_counter() - t0
    moved = moved_counts(before)
    # get_hessian ends with one force call at the point: its launches and
    # nothing else
    if moved != {k: 4 for k in MAIN_PATH} or gpu.force_calls - n0 != 1:
        fail(f"kernel launches during the analytic Hessian: {moved}")
    fro = np.arange(6)
    if H.shape != (n3, n3) or not np.array_equal(H, H.T) \
            or np.any(H[fro] != 0) or np.any(H[:, fro] != 0) \
            or not np.all(np.isfinite(H)):
        fail("the card Hessian is not symmetric, finite and zero on the "
             "frozen atoms")
    cols = P12_COLS
    ref, waited = p21_wait_cpu(p12_cpu, what="phase 12's")
    H64, H32, t_cpu = ref["H64"], ref["H32"], float(ref["t64"])
    scale = np.abs(H64).max()
    err = float(np.abs(H[:, cols].T - H64).max() / scale)
    err32 = float(np.abs(H32 - H64).max() / scale)
    limit = min(HESS_TOL, max(2 * err32, HESS_FLOOR))
    log(f"[hess] escn-md 64 atoms (atoms 0, 1 frozen), analytic Hessian on "
        f"the card (all-plain f32, {int(gpu.free_dof_mask.sum())} HVPs): "
        f"{t_an:.2f} s; {len(cols)} "
        f"columns (atom 2) against CPU float64: max|dH|/max|H| = "
        f"{err:.3e} (CPU float32's own: {err32:.3e}; pass at <= "
        f"{limit:.3e} = max(2x float32's, {HESS_FLOOR}), outer limit "
        f"{HESS_TOL}); CPU float64 columns {t_cpu:.1f} s in a child "
        f"process (waited {waited:.1f} s here); launches "
        f"during get_hessian: {moved} (its one force call)")
    if not err <= limit:
        fail("the card's analytic Hessian disagrees with CPU float64")
    gpu.hessian_calc_mode = "FiniteDifference"
    n_free = int(gpu.free_dof_mask.sum())
    # the displacements go in chunks (PDB2R_TPU_FD_CHUNK), each one
    # stacked pass through the kernels
    images_fn, passes = gpu.energy_fn_images, []

    def counted(*a):
        passes.append(a[0].shape[0])
        return images_fn(*a)
    counted.max_images = images_fn.max_images
    gpu.energy_fn_images = counted
    before = all_counts()
    n0 = gpu.force_calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Hfd = gpu.get_hessian(cb)["hessian"]
    torch.cuda.synchronize()
    t_fd = time.perf_counter() - t0
    moved = moved_counts(before)
    calls = gpu.force_calls - n0
    err_fd = float(np.abs(Hfd - H).max() / np.abs(H).max())
    log(f"[hess] FD Hessian on the card through the kernels (eps 1e-3 A, "
        f"f32 forces): {t_fd:.2f} s, {calls} force calls (2 x {n_free} "
        f"displaced + 1 at the point) in {len(passes)} stacked passes of "
        f"{passes[:1]} images, max|H_fd - H|/max|H| = {err_fd:.3e} "
        f"(no bound); launches {moved}")
    # stacked passes, else (at FD chunk 1) one launch sequence a call
    want = {k: 4 * (len(passes) or 2 * n_free) + 4 for k in MAIN_PATH}
    if calls != 2 * n_free + 1 or moved != want:
        fail(f"FD Hessian accounting: {calls} calls, launches {moved}, "
             f"expected {want}")
    # a second derivative through the kernels themselves must raise
    c = gpu._to_pad_ang(cb).requires_grad_(True)
    e = gpu.energy_fn(c, gpu.system, gpu.params)
    try:
        torch.autograd.grad(e, c, create_graph=True)
        said = "no error"
    except RuntimeError as ex:
        said = str(ex)
    log(f"[hess] create_graph backward through K1/K2 on the card: {said}")
    if "double backward" not in said:
        fail("a create_graph backward through the kernels did not raise")
    return H, t_an


def path_opt_cli(st, xyzB):
    """``python -m pdb2reaction_tpu_torch path-opt`` on the two endpoints
    as a subprocess on the card."""
    import shutil
    from pdb2reaction_tpu_torch.core.io_xyz import read_xyz_frames, write_xyz
    out = os.path.join(HERE, "result_smoke", "path_opt")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    a, b = os.path.join(out, "A.xyz"), os.path.join(out, "B.xyz")
    write_xyz(a, st)
    write_xyz(b, st.copy(coords=xyzB))
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "pdb2reaction_tpu_torch", "path-opt",
           "-i", a, "-i", b, "--model", "escn-md", "--max-nodes", "10",
           "--max-cycles", "10", "--climb", "False", "-q", "0"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=out, env=env, capture_output=True,
                       text=True, timeout=900)
    wall = time.perf_counter() - t0
    res = os.path.join(out, "result_path_opt")
    trj = os.path.join(res, "final_geometries.trj")
    n = len(read_xyz_frames(trj)) if os.path.exists(trj) else 0
    tail = [ln for ln in r.stdout.splitlines() if ln.startswith("[path-opt]")]
    log(f"[gsm] path-opt CLI (escn-md, 300 atoms, max_nodes=10, 10 cycles, "
        f"climb off) as a subprocess: rc {r.returncode}, {wall:.1f} s with "
        f"start-up, {n} frames in final_geometries.trj; {tail}")
    if r.returncode not in (0, 3):
        fail(f"path-opt exited {r.returncode}: {r.stderr[-3000:]}")
    if n != 12 or not os.path.exists(os.path.join(res, "hei.xyz")):
        fail("path-opt did not write a 12-frame final_geometries.trj and "
             "hei.xyz")


def phase_gsm(calc, ms_force, ref64, p12_cpu):
    """Phase 12: the GSM string on the escn-md calculator of phase 4, the
    Hessians at 64 atoms with phase 5's weights, and path-opt. Returns
    what phase 20 holds its ranks to: the endpoints, the flagship run
    (result, wall, launches) and the 64-atom analytic Hessian (H,
    wall)."""
    import torch
    from pdb2reaction_tpu_torch.constants import ANG2BOHR
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated() / 2 ** 30
    st = calc.structure
    free = calc.system.free_mask[: calc.n_atoms].cpu().numpy()
    xyzB = endpoint_b(st.coords, free)
    xA = calc.pad_bohr(st.coords_bohr)
    xB = calc.pad_bohr(xyzB * ANG2BOHR)
    flagship = gsm_flagship(calc, xA, xB, ms_force)
    gsm_climb(calc, xA, xB)
    hess = hessians_64(ref64, p12_cpu)
    path_opt_cli(st, xyzB)
    log(f"[gsm] phase 12 wall {time.perf_counter() - t0:.1f} s; device "
        f"memory held {held:.2f} GiB before, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB after")
    return {"xA": xA.cpu().numpy(), "xB": xB.cpu().numpy(),
            "gsm": flagship, "hess": hess}


# ---------------------------------------------------------------------------
# phase 13: path-search on escn-md; phase 14: the md golden through .pt
# ---------------------------------------------------------------------------

GOLDEN_RTOL_E = 2e-5    # the JAX package's pallas-mega-against-XLA bar on
GOLDEN_RTOL_F = 1e-3    # the converted production-dims golden: energy
GOLDEN_ATOL_F = 2e-5    # rtol; forces rtol and atol (eV/Angstrom)


def moved_h(zs, xyz):
    """B of the search: A with the lowest-index H whose nearest C, N or O
    lies within 2.2 Angstrom moved to 1.05 Angstrom from that atom along
    their axis. Returns (B, the H's index, the heavy atom's index)."""
    heavy = np.nonzero(np.isin(zs, (6, 7, 8)))[0]
    for i in np.nonzero(zs == 1)[0]:
        d = np.linalg.norm(xyz[heavy] - xyz[i], axis=1)
        if d.min() <= 2.2:
            j = int(heavy[np.argmin(d)])
            out = xyz.copy()
            out[i] = xyz[j] + 1.05 * (xyz[i] - xyz[j]) / d.min()
            return out, int(i), j
    fail("no hydrogen within 2.2 Angstrom of a C, N or O")


class counted_hvps:
    """Every HVP closure a calculator hands out while this is entered is
    counted and timed (synchronised), with the kernel launches made
    inside it."""

    def __init__(self):
        self.n, self.s, self.moved = 0, 0.0, {}

    def __enter__(self):
        from pdb2reaction_tpu_torch.mlip.calculator import Calculator
        self.cls, self.orig = Calculator, Calculator.au_hvp_fn
        outer = self

        def au_hvp_fn(calc):
            hvp = outer.orig(calc)

            def fn(x, v):
                import torch
                before = all_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = hvp(x, v)
                torch.cuda.synchronize()
                outer.s += time.perf_counter() - t0
                outer.n += 1
                for k, d in moved_counts(before).items():
                    outer.moved[k] = outer.moved.get(k, 0) + d
                return out
            return fn

        Calculator.au_hvp_fn = au_hvp_fn
        return self

    def __exit__(self, *exc):
        self.cls.au_hvp_fn = self.orig


def search_files(out, res):
    """The output tree of a path-search run; fails on a missing file, a
    summary that does not list the run's segments or a non-finite
    energy or image."""
    segs = res["segments"]
    for f in ("mep.trj", "summary.yaml", "summary.log"):
        if not os.path.exists(os.path.join(out, f)):
            fail(f"path-search wrote no {f}")
    for i, sg in enumerate(segs):
        d = os.path.join(out, f"seg_{i:03d}_mep")
        need = ["final_geometries.trj", "summary.yaml"] + (
            ["hei.xyz"] if sg.is_reactive else [])
        missing = [f for f in need if not os.path.exists(os.path.join(d, f))]
        if missing:
            fail(f"path-search segment {i} ({sg.kind}) lacks {missing}")
        if not (np.all(np.isfinite(sg.energies))
                and all(np.all(np.isfinite(x)) for x in sg.images_bohr)):
            fail(f"path-search segment {i} has non-finite energies or "
                 "images")
    with open(os.path.join(out, "summary.yaml")) as fh:
        doc = json.load(fh)
    if doc["n_segments"] != len(segs) or len(doc["segments"]) != len(segs):
        fail(f"summary.yaml lists {doc['n_segments']} segments, the run "
             f"returned {len(segs)}")
    return doc


def phase_search(st):
    """Phase 13: run_path_search on escn-md (seed 0, phase 4's weights) at
    300 atoms padded to 320, A -> B with one H moved onto a heavy atom:
    counts set to 0 just before and read just after the run."""
    import shutil
    import torch
    from pdb2reaction_tpu_torch.bio.bonds import compare_structures
    from pdb2reaction_tpu_torch.constants import ANG2BOHR, AU2KCALPERMOL
    from pdb2reaction_tpu_torch.core.io_xyz import write_xyz
    from pdb2reaction_tpu_torch.workflows.path_search import run_path_search
    out = os.path.join(HERE, "result_smoke", "path_search")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    xyzB, h, heavy = moved_h(st.numbers, st.coords)
    bc = compare_structures(st.numbers, st.coords * ANG2BOHR,
                            xyzB * ANG2BOHR)
    if not bc.formed_covalent:
        fail(f"moving H{h} onto atom {heavy} formed no bond")
    a, b = os.path.join(out, "A.xyz"), os.path.join(out, "B.xyz")
    write_xyz(a, st)
    write_xyz(b, st.copy(coords=xyzB))
    torch.cuda.reset_peak_memory_stats()
    zero_all_counts()
    before = all_counts()
    t0 = time.perf_counter()
    with counted_hvps() as hv:
        res = run_path_search(
            [a, b], charge=0, spin=1, model="escn-md", device="cuda", seed=0,
            pad_multiple=64, out_dir=os.path.join(out, "run"), verbose=False,
            search_kw={"max_depth": 1, "opt_thresh": "gau_loose",
                       "preopt": False},
            gs_kw={"max_nodes": 10}, stopt_kw={"max_cycles": 10})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = moved_counts(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fc, ec = res["force_calls"], res["energy_calls"]
    segs = res["segments"]
    kinds = {k: sum(1 for s in segs if s.kind == k)
             for k in ("seg", "kink", "bridge")}
    log(f"[search] escn-md pallas-mega, {st.n_atoms} atoms (P=320), A -> B "
        f"with H{h} moved to 1.05 A from atom {heavy} (formed "
        f"{sorted(bc.formed_covalent)}, broken "
        f"{sorted(bc.broken_covalent)}); max_depth 1, opt gau_loose, "
        f"max_nodes 10, 10 string cycles, climb on, no preopt: "
        f"{wall:.2f} s wall")
    log(f"[search] {len(segs)} segments {kinds}, "
        f"{sum(1 for s in segs if s.is_reactive)} reactive, "
        f"{res['segments_run']} MEPs run; {fc} force calls, {ec} energy "
        f"calls; {hv.n} HVPs in {hv.s:.2f} s ({hv.s / max(hv.n, 1) * 1e3:.1f}"
        f" ms each; launches inside: {hv.moved}); "
        f"{(wall - hv.s) / max(fc + ec, 1) * 1e3:.2f} ms per force or "
        f"energy call over the rest of the wall; launches {moved}; peak "
        f"memory {peak:.2f} GiB")
    log(f"[search] segments: {[(s.kind, s.is_reactive, s.hei_idx, len(s.images_bohr), round(s.barrier_au * AU2KCALPERMOL, 3)) for s in segs]}")
    want = {"fused_edge_mega_fwd": 4 * (fc + ec),
            "fused_edge_mega_bwd": 4 * fc,
            "fused_node_ffn_fwd": 4 * (fc + ec),
            "fused_node_ffn_bwd": 4 * fc}
    if moved != want:
        fail(f"path-search launches {moved}, expected {want} (K1 and K2 "
             "forward 4 x (force + energy calls), backward 4 x force "
             "calls, nothing else)")
    if hv.moved:
        fail(f"kernels launched inside HVPs: {hv.moved}")
    search_files(os.path.join(out, "run"), res)
    return st.copy(coords=xyzB), res, (h, heavy)


def path_search_cli(st, stB):
    """Phase 13b: ``python -m pdb2reaction_tpu_torch path-search`` as a
    subprocess on the card."""
    import shutil
    from pdb2reaction_tpu_torch.core.io_xyz import write_xyz
    out = os.path.join(HERE, "result_smoke", "path_search_cli")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    a, b = os.path.join(out, "A.xyz"), os.path.join(out, "B.xyz")
    write_xyz(a, st)
    write_xyz(b, stB)
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "pdb2reaction_tpu_torch", "path-search",
           "-i", a, "-i", b, "--model", "escn-md", "--max-depth", "0",
           "--max-nodes", "10", "--max-cycles", "10", "--climb", "False",
           "--thresh", "gau_loose", "--preopt", "False", "-q", "0"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=out, env=env, capture_output=True,
                       text=True, timeout=900)
    wall = time.perf_counter() - t0
    res = os.path.join(out, "result_path_search")
    tail = [ln for ln in r.stdout.splitlines()
            if ln.startswith(("[path-search]", "[diagram]"))]
    log(f"[search] path-search CLI (escn-md, 300 atoms, max_depth 0, "
        f"max_nodes 10, 10 cycles, climb off) as a subprocess: rc "
        f"{r.returncode}, {wall:.1f} s with start-up; {tail}")
    if r.returncode != 0:
        fail(f"path-search exited {r.returncode}: {r.stderr[-3000:]}")
    for f in ("mep.trj", "summary.yaml"):
        if not os.path.exists(os.path.join(res, f)):
            fail(f"the path-search CLI wrote no {f}")


def golden_state_dict():
    """The production-dims golden's state dict rebuilt from its seed
    (``scripts/make_escn_golden.py``), its fingerprint checked, and the
    fixture."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    try:
        from make_escn_golden import MD_CFG, make_state_dict
    finally:
        sys.path.pop(0)
    g = np.load(os.path.join(HERE, "tests", "fixtures",
                             "escn_golden_md.npz"))
    sd = make_state_dict(MD_CFG, seed=int(g["cfg_seed"]))
    fp = np.array([float(np.sum(v)) for _, v in sorted(sd.items())][:8])
    if not np.allclose(fp, g["sd_fingerprint"], rtol=1e-12, atol=0):
        fail("the golden state dict's fingerprint drifted (numpy RNG "
             "stream)")
    return sd, g


def phase_golden():
    """Phase 14: the production-dims golden (lmax 4, mmax 2, C = 128, 4
    experts, 2 layers) through make_uma_calculator(checkpoint=x.pt) on
    the card, K1 and K2 in float32, against the same converted weights
    on the CPU plain path in float64 and against the independent numpy
    executor's goldens."""
    import torch
    from pdb2reaction_tpu_torch.constants import AU2EV, F_EVAA_2_AU
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    sd, g = golden_state_dict()
    os.makedirs(os.path.join(HERE, "result_smoke"), exist_ok=True)
    pt = os.path.join(HERE, "result_smoke", "golden_md.pt")
    torch.save({"state_dict": {k: torch.as_tensor(v)
                               for k, v in sd.items()}}, pt)

    def ev(calc, st):
        r = calc.get_forces(st.coords_bohr.reshape(-1))
        return r["energy"] * AU2EV, r["forces"].reshape(-1, 3) / F_EVAA_2_AU

    def worst(e, f, e_ref, f_ref):
        """(|dE| / |E_ref| over GOLDEN_RTOL_E, the largest force excess
        |dF| / (atol + rtol |F_ref|)): both at most 1 to pass."""
        return (abs(e - e_ref) / (GOLDEN_RTOL_E * abs(e_ref)),
                float(np.max(np.abs(f - f_ref) / (
                    GOLDEN_ATOL_F + GOLDEN_RTOL_F * np.abs(f_ref)))))

    for i in range(2):
        q, s, t = (int(v) for v in g[f"struct{i}_cqt"])
        st = Structure(g[f"struct{i}_numbers"], g[f"struct{i}_coords"])
        gpu = make_uma_calculator(st, checkpoint=pt, device="cuda",
                                  charge=q, spin=s, task=t)
        cpu = make_uma_calculator(st, checkpoint=pt, device="cpu",
                                  dtype=torch.float64, charge=q, spin=s,
                                  task=t)
        if gpu.weights_source != f"converted:{pt}" \
                or gpu.cfg.edge_kernel != "pallas-mega":
            fail(f"the .pt route gave {gpu.weights_source}, "
                 f"{gpu.cfg.edge_kernel}")
        zero_all_counts()
        before = all_counts()
        e, f = ev(gpu, st)
        moved = moved_counts(before)
        e64, f64 = ev(cpu, st)
        e_g, f_g = float(g[f"struct{i}_energy"]), g[f"struct{i}_forces"]
        vs64, vsg = worst(e, f, e64, f64), worst(e, f, e_g, f_g)
        log(f"[golden] md struct{i} ({st.n_atoms} atoms, P={gpu.n_pad}, "
            f"q={q} s={s} task={t}) converted .pt on the card (f32 K1/K2): "
            f"E = {e:.8f} eV; against CPU float64 |dE| = {abs(e - e64):.3e} "
            f"eV, max|dF| = {np.abs(f - f64).max():.3e} eV/A; against the "
            f"golden |dE| = {abs(e - e_g):.3e} eV, max|dF| = "
            f"{np.abs(f - f_g).max():.3e} eV/A (CPU float64 against the "
            f"golden {abs(e64 - e_g):.3e} / {np.abs(f64 - f_g).max():.3e}); "
            f"share of the bound used (energy rtol {GOLDEN_RTOL_E}, forces "
            f"rtol {GOLDEN_RTOL_F} atol {GOLDEN_ATOL_F}): vs CPU64 "
            f"{vs64[0]:.3f} / {vs64[1]:.3f}, vs golden {vsg[0]:.3f} / "
            f"{vsg[1]:.3f}; launches {moved}")
        if max(vs64 + vsg) > 1.0:
            fail(f"md golden struct{i}: the card's energy or forces miss "
                 "the bound")
        want = {k: 2 for k in MAIN_PATH}
        if moved != want:
            fail(f"md golden launches {moved}, expected {want} (2 layers)")


# ---------------------------------------------------------------------------
# phase 15: stage 4 (tsopt, freq, irc) on escn-md from phase 13's TS guess
# ---------------------------------------------------------------------------

STAGE4_RADIUS = 3.0     # Angstrom: the active region around the formed bond
ENGINE_X_TOL = 1e-8     # Bohr: the Morse engines on the card against CPU
ENGINE_E_TOL = 1e-10    # Hartree


class stage4_meter:
    """While entered: every analytic Hessian (count, synchronised seconds,
    its HVPs and the kernel launches inside it, which must be none), the
    time inside the engines' force calls (``Calculator._au_eforce``), and
    the IRC branch loops' time and cycles."""

    def __init__(self):
        self.hess, self.hess_s, self.hvps = 0, 0.0, 0
        self.inside, self.force_s = {}, 0.0
        self.irc_s, self.irc_cycles = 0.0, 0

    def __enter__(self):
        import torch
        from pdb2reaction_tpu_torch.engines import irc
        from pdb2reaction_tpu_torch.mlip.calculator import Calculator
        self.saved = [(Calculator, k, Calculator.__dict__[k]) for k in
                      ("_analytic_hessian", "_vjp", "_au_eforce")] + [
            (irc, "_make_branch_runner", irc._make_branch_runner)]
        (_, _, hess), (_, _, vjp0), (_, _, eforce), (_, _, runner) = \
            self.saved
        m = self

        def timed(fn, add):
            def wrapper(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                add(time.perf_counter() - t0)
                return out
            return wrapper

        def analytic_hessian(calc, x):
            before = all_counts()
            out = timed(hess, lambda dt: setattr(m, "hess_s",
                                                 m.hess_s + dt))(calc, x)
            m.hess += 1
            for k, d in moved_counts(before).items():
                m.inside[k] = m.inside.get(k, 0) + d
            return out

        def vjp(c, g, v, batched=False):
            # a chunk of tangents is one batched call
            m.hvps += v.shape[0] if batched else 1
            return vjp0.__func__(c, g, v, batched)

        def add_force(dt):
            m.force_s += dt

        def make_runner(*a, **kw):
            resume = runner(*a, **kw)

            def timed_resume(st, *ra):
                c0 = st.cycle
                out = timed(resume, lambda dt: setattr(
                    m, "irc_s", m.irc_s + dt))(st, *ra)
                m.irc_cycles += out.cycle - c0
                return out
            return timed_resume

        Calculator._analytic_hessian = analytic_hessian
        Calculator._vjp = staticmethod(vjp)
        Calculator._au_eforce = timed(eforce, add_force)
        irc._make_branch_runner = make_runner
        return self

    def __exit__(self, *exc):
        for owner, k, v in self.saved:
            setattr(owner, k, v)


def morse_engines(device):
    """The Morse H3 double well through rfo_optimize (TS mode),
    hessian_dimer and eulerpc_irc on ``device``: (coordinates, energies,
    cycles, force calls) of each."""
    import torch
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.engines.dimer import hessian_dimer
    from pdb2reaction_tpu_torch.engines.irc import eulerpc_irc
    from pdb2reaction_tpu_torch.engines.rfo import rfo_optimize
    from pdb2reaction_tpu_torch.mlip import potentials
    from pdb2reaction_tpu_torch.mlip.calculator import Calculator
    out = {}

    def calc_at(x1):
        st = Structure.from_symbols(["H"] * 3, [[0, 0, 0], [x1, 0, 0],
                                                [2.4, 0, 0]], freeze=[0, 2])
        return Calculator(st, potentials.make_morse(), device=device), st

    c, st = calc_at(1.05)
    H0 = c.get_hessian(st.coords_bohr.reshape(-1))["hessian"]
    r = rfo_optimize(c.au_energy_force_fn(), c.pad_bohr(st.coords_bohr),
                     c.system.free_mask, c.n_atoms, hessian0=H0, mode="ts",
                     roots=[0], thresh="baker", hessian_update="bofill",
                     max_cycles=300)
    if r.x.device.type != torch.device(device).type:
        fail(f"rfo_optimize returned its geometry on {r.x.device}")
    out["rfo"] = (r.x.cpu().numpy(), [r.e], r.cycles, c.force_calls)
    c, st = calc_at(1.05)
    d = hessian_dimer(c, c.pad_bohr(st.coords_bohr), flatten_max_iter=0)
    out["dimer"] = (d.x.cpu().numpy(), [d.e], d.cycles, c.force_calls)
    c, st = calc_at(1.2)
    i = eulerpc_irc(c, c.pad_bohr(st.coords_bohr), max_cycles=80,
                    rms_grad_thresh=5e-4)
    out["irc"] = (np.concatenate([np.stack(b.coords) for b in
                                  (i.forward, i.backward)]),
                  i.forward.energies + i.backward.energies,
                  len(i.forward.coords) + len(i.backward.coords),
                  c.force_calls)
    return out


def morse_card_vs_cpu():
    """Phase 15a: the Morse engines on the card against the CPU: the same
    cycles and force calls, coordinates within ENGINE_X_TOL, energies
    within ENGINE_E_TOL (a tensor left on the wrong device fails here)."""
    gpu, cpu = morse_engines("cuda"), morse_engines("cpu")
    for k in gpu:
        (xg, eg, cg, fg), (xc, ec, cc, fc) = gpu[k], cpu[k]
        dx = float(np.abs(xg - xc).max())
        de = float(np.abs(np.subtract(eg, ec)).max())
        log(f"[stage4] Morse H3 {k} on the card against the CPU: cycles "
            f"{cg} / {cc}, force calls {fg} / {fc}, max|dx| {dx:.2e} Bohr, "
            f"max|dE| {de:.2e} Ha")
        if cg != cc or fg != fc or not dx <= ENGINE_X_TOL \
                or not de <= ENGINE_E_TOL:
            fail(f"the Morse {k} engine on the card disagrees with the CPU")


def stage4_guess(search, bond):
    """Phase 13's TS guess: the HEI of its reactive segment with the
    highest barrier (of any segment's when none is reactive), and the
    active atoms within STAGE4_RADIUS of either atom of the formed bond."""
    from pdb2reaction_tpu_torch.constants import BOHR2ANG
    segs = search["segments"]
    pool = [s for s in segs if s.is_reactive] or segs
    seg = max(pool, key=lambda s: s.barrier_au)
    x = np.asarray(seg.images_bohr[seg.hei_idx]) * BOHR2ANG
    d = np.linalg.norm(x[:, None, :] - x[list(bond)][None], axis=-1)
    active = np.nonzero(d.min(axis=1) <= STAGE4_RADIUS)[0]
    return x, seg, [int(i) for i in range(len(x)) if i not in set(active)]


def stage4_run(tag, run, calc, check_files):
    """One workflow with its counts set to 0 just before and read just
    after: the launch identity, finite results, its outputs."""
    import torch
    n_f, n_e = calc.force_calls, calc.energy_calls
    zero_all_counts()
    before = all_counts()
    with stage4_meter() as m:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fc, ec = calc.force_calls - n_f, calc.energy_calls - n_e
    moved = moved_counts(before)
    per = m.hvps / max(m.hess, 1)
    log(f"[stage4] {tag}: {wall:.2f} s wall; cycles "
        f"{res.get('cycles', '-')}, converged {res.get('converged', '-')}; "
        f"{fc} force calls, {ec} energy calls (the engines' force calls "
        f"{m.force_s:.2f} s); "
        f"{m.hess} Hessians in {m.hess_s:.2f} s, {per:.0f} HVPs each; "
        f"launches {moved}")
    want = {"fused_edge_mega_fwd": 4 * (fc + ec),
            "fused_edge_mega_bwd": 4 * fc,
            "fused_node_ffn_fwd": 4 * (fc + ec),
            "fused_node_ffn_bwd": 4 * fc}
    if moved != {k: v for k, v in want.items() if v}:
        fail(f"{tag}: launches {moved}, expected {want} (K1 and K2 "
             "forward 4 x (force + energy calls), backward 4 x force calls)")
    if m.inside:
        fail(f"{tag}: kernels launched inside Hessians: {m.inside}")
    missing = [f for f in check_files if not os.path.exists(f)]
    if missing:
        fail(f"{tag} wrote no {missing}")
    return res, m, wall


def phase_stage4(calc, st, search, bond, smi_line):
    """Phase 15: run_tsopt (light, then heavy), run_freq and run_irc on
    escn-md (phase 4's weights, P = 320) from phase 13's TS guess, with
    the atoms beyond STAGE4_RADIUS of the formed bond frozen; the three
    CLI subcommands as subprocesses; the Morse engines on the card
    against the CPU."""
    import shutil
    import torch
    from pdb2reaction_tpu_torch.core.io_xyz import write_xyz
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    from pdb2reaction_tpu_torch.workflows.freq import run_freq
    from pdb2reaction_tpu_torch.workflows.irc import run_irc
    from pdb2reaction_tpu_torch.workflows.tsopt import run_tsopt
    t_phase = time.perf_counter()
    out = os.path.join(HERE, "result_smoke", "stage4")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    x, seg, freeze = stage4_guess(search, bond)
    guess = st.copy(coords=x)
    gpath = os.path.join(out, "ts_guess.xyz")
    write_xyz(gpath, guess)
    n_act = st.n_atoms - len(freeze)
    log(f"[stage4] {smi_line}; TS guess: the HEI (image {seg.hei_idx}) of "
        f"a {seg.kind} segment (reactive {seg.is_reactive}, barrier "
        f"{seg.barrier_au:.6f} Ha); active region: {n_act} atoms within "
        f"{STAGE4_RADIUS} A of atoms {list(bond)}, {len(freeze)} frozen")
    c4 = make_uma_calculator(guess, model="escn-md", device="cuda",
                             params=calc.params, pad_multiple=64,
                             freeze_atoms=freeze)
    torch.cuda.reset_peak_memory_stats()
    kw = dict(charge=0, verbose=False, calculator=c4)
    dl = os.path.join(out, "light")
    ra, _, _ = stage4_run("(a) tsopt light (Hessian dimer, max_cycles 200, "
                          "flatten_max_iter 1)", lambda: run_tsopt(
                              gpath, opt_mode="light", max_cycles=200,
                              hessian_dimer_kw={"flatten_max_iter": 1},
                              out_dir=dl, **kw), c4,
                          [os.path.join(dl, f) for f in (
                              "final_geometry.xyz", "imag_mode.trj")])
    dh = os.path.join(out, "heavy")
    rb, _, _ = stage4_run("(b) tsopt heavy (RS-I-RFO, max_cycles 100)",
                          lambda: run_tsopt(gpath, opt_mode="heavy",
                                            max_cycles=100, out_dir=dh,
                                            **kw), c4,
                          [os.path.join(dh, f) for f in (
                              "final_geometry.xyz", "imag_mode.trj")])
    ts_path = os.path.join(dl, "final_geometry.xyz")
    df = os.path.join(out, "freq")
    rc, _, _ = stage4_run("(c) freq on (a)'s geometry", lambda: run_freq(
        ts_path, out_dir=df, **kw), c4, [os.path.join(df, f) for f in (
            "frequencies_cm-1.txt", "thermoanalysis.yaml")])
    di = os.path.join(out, "irc")
    rd, m_irc, _ = stage4_run("(d) irc from (a)'s geometry (max_cycles 30 "
                              "a branch)", lambda: run_irc(
                                  ts_path, out_dir=di, max_cycles=30, **kw),
                              c4, [os.path.join(di, f) for f in (
                                  "finished_irc.trj", "forward_irc.trj",
                                  "backward_irc.trj", "irc_data.npz")])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for tag, r in (("tsopt light", ra), ("tsopt heavy", rb)):
        log(f"[stage4] {tag}: E = {r['energy']:.8f} Ha, n_imag "
            f"{r['n_imag']}, lowest mode "
            f"{np.min(r['freqs_cm']) if len(r['freqs_cm']) else 'none'} "
            f"cm-1")
        if not (np.isfinite(r["energy"]) and np.all(np.isfinite(
                r["coords_bohr"])) and np.all(np.isfinite(r["freqs_cm"]))):
            fail(f"{tag}: non-finite energy, geometry or frequency")
    th = rc["thermo"]
    n_imag = int((rc["freqs_cm"] < 0).sum())
    log(f"[stage4] freq: {len(rc['freqs_cm'])} modes, {n_imag} imaginary, "
        f"lowest {np.min(rc['freqs_cm']):.1f} cm-1; thermo at 298.15 K: "
        f"ZPE {th.zpe:.6f} Ha, G - E = {th.gibbs_corr:.6f} Ha, G = "
        f"{th.gibbs:.8f} Ha")
    if not (np.all(np.isfinite(rc["freqs_cm"])) and np.isfinite(th.gibbs)
            and np.all(np.isfinite(rc["hessian"]))):
        fail("freq: non-finite frequencies, Hessian or thermochemistry")
    ir = rd["result"]
    host = (m_irc.irc_s - m_irc.force_s) / max(m_irc.irc_cycles, 1)
    log(f"[stage4] irc: forward {len(ir.forward.coords)} / backward "
        f"{len(ir.backward.coords)} points (converged "
        f"{ir.forward.converged} / {ir.backward.converged}); branch loops "
        f"{m_irc.irc_s:.2f} s over {m_irc.irc_cycles} cycles, "
        f"{host * 1e3:.1f} ms a cycle outside the force call (DWI field, "
        f"corrector, predictor, Bofill)")
    if not (np.all(np.isfinite(rd["energies"])) and all(
            np.all(np.isfinite(f)) for f in rd["frames_bohr"])):
        fail("irc: non-finite energies or frames")
    log(f"[stage4] peak memory over (a)-(d) {peak:.2f} GiB")
    irc_cycle_alone(st.n_atoms, freeze)
    stage4_cli(gpath, ts_path, freeze)
    morse_card_vs_cpu()
    log(f"[stage4] phase 15 wall {time.perf_counter() - t_phase:.1f} s")
    return gpath, freeze


def irc_cycle_alone(n_atoms, freeze, reps=3):
    """A steady IRC cycle's integration alone at the phase's size (3N
    mass-weighted coordinates, its freeze list): the corrector's four
    midpoint passes and 500 Euler sub-steps on a DWI surface of seeded
    points and symmetric Hessians, 584 field evaluations, through the
    engine's own functions. Median of ``reps`` synchronised runs."""
    import torch
    from pdb2reaction_tpu_torch.engines.irc import (_sym, dwi_field,
                                                    integrate_cycle)
    n3 = 3 * n_atoms
    gen = torch.Generator().manual_seed(0)
    free = torch.ones(n_atoms, 3, dtype=torch.float64)
    free[freeze] = 0.0
    free = free.reshape(-1).cuda()

    def rnd(*shape):
        return torch.randn(*shape, generator=gen,
                           dtype=torch.float64).cuda()

    Q = rnd(2, n3) * free
    field = dwi_field(Q, rnd(2), rnd(2, n3) * 1e-2 * free,
                      torch.stack([_sym(rnd(n3, n3)), _sym(rnd(n3, n3))]),
                      free)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = integrate_cycle(field, Q[0], Q[1], 0.1, 500, free)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(q).all()):
        fail("the IRC cycle's integration gave non-finite coordinates")
    log(f"[stage4] one steady IRC cycle's integration alone at 3N = {n3} "
        f"(corrector + 500 Euler sub-steps, 584 DWI field evaluations): "
        f"{sorted(times)[len(times) // 2] * 1e3:.1f} ms (median of "
        f"{reps}; {[round(t * 1e3, 1) for t in times]})")


def stage4_cli(gpath, ts_path, freeze):
    """Phase 15e: ``tsopt --opt-mode heavy --max-cycles 3``, ``freq`` and
    ``irc --max-cycles 3`` as subprocesses on the card (escn-md, seed 0,
    the same freeze list), the three at once: exit codes and outputs.
    tsopt exits 3 when its three cycles end unconverged, and that is
    reported, not required."""
    import torch
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    base = ["--model", "escn-md", "-q", "0", "--freeze-atoms",
            ",".join(map(str, freeze))]
    out = os.path.dirname(gpath)
    runs = (("tsopt", gpath, ["--opt-mode", "heavy", "--max-cycles", "3"],
             (0, 3), ("final_geometry.xyz", "imag_mode.trj")),
            ("freq", ts_path, [], (0,),
             ("frequencies_cm-1.txt", "thermoanalysis.yaml")),
            ("irc", ts_path, ["--max-cycles", "3"], (0,),
             ("finished_irc.trj", "irc_data.npz")))
    torch.cuda.empty_cache()        # room for the three processes' own
    procs = []
    t0 = time.perf_counter()
    try:
        for cmd, src, extra, _, _ in runs:
            d = os.path.join(out, f"cli_{cmd}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "stdout.txt"), "w") as fo, \
                    open(os.path.join(d, "stderr.txt"), "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "pdb2reaction_tpu_torch", cmd,
                     "-i", src, "--out-dir", d] + base + extra, cwd=out,
                    env=env, stdout=fo, stderr=fe, text=True))
        walls = []
        for p in procs:
            p.wait(timeout=max(t0 + 600 - time.perf_counter(), 1))
            walls.append(time.perf_counter() - t0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (cmd, _, _, ok, files), p, wall in zip(runs, procs, walls):
        d = os.path.join(out, f"cli_{cmd}")
        with open(os.path.join(d, "stdout.txt")) as fh:
            tail = [ln for ln in fh.read().splitlines()
                    if ln.startswith(f"[{cmd}")][-2:]
        log(f"[stage4] {cmd} CLI as a subprocess (the three at once): rc "
            f"{p.returncode}, done {wall:.1f} s after their start; {tail}")
        if p.returncode not in ok:
            with open(os.path.join(d, "stderr.txt")) as fh:
                fail(f"the {cmd} CLI exited {p.returncode}: "
                     f"{fh.read()[-3000:]}")
        missing = [f for f in files if not os.path.exists(
            os.path.join(d, f))]
        if missing:
            fail(f"the {cmd} CLI wrote no {missing}")


# ---------------------------------------------------------------------------
# phase 16: all on an enzyme-like PDB pair
# ---------------------------------------------------------------------------

ALL_ACTIVE_RADIUS = 4.0   # Angstrom around the ligand's C2 and O1: the
                          # pocket atoms farther from both are frozen
ALL_BODY_SPACING = 4.0    # Angstrom: the outer protein body's lattice
ALL_BODY_RADII = (10.0, 25.0)
ALL_CAPS = {"string cycles (max_cycles)": 20,
            "tsopt max_cycles_total": 10, "tsopt flatten_max_iter": 10,
            "endpoint minimization max_cycles": 20, "irc max_cycles": 10}
ALL_KINKS = 10            # search_kw max_consecutive_kinks (default 2)
ALL_POCKET_ATOMS = 202    # the JAX package's extract_api pocket of the
                          # active site, which the body leaves unchanged
                          # (held on the CPU in tests/test_torch_all.py)


def _pdb_atom(serial, name, resname, chain, resseq, xyz, record="ATOM",
              element=None):
    return dict(record=record, serial=serial, name=name, resname=resname,
                chain=chain, resseq=resseq, element=element or name[0],
                occupancy=1.0, bfactor=0.0, x=xyz[0], y=xyz[1], z=xyz[2])


def _fib_sphere(n):
    """Fibonacci sphere directions: evenly spaced residue placements."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta), np.cos(phi)], -1)


def build_enzyme_pdb(path, *, n_res=48, n_wat=12, stretch=None, seed=0):
    """The active site of ``scripts/tpu_all_e2e.py`` (the same text on the
    same arguments): a 35-carbon macrocyclic LIG with O1 on its C2 at
    1.30 Angstrom (``stretch`` moves O1 out: the product), SER / ASN side
    chains whose tips sit 2.3 Angstrom from the ligand and a shell of
    waters. Returns the atom count."""
    from pdb2reaction_tpu_torch.core import io_pdb
    rng = np.random.default_rng(seed)
    atoms = []
    serial = [0]

    def add(name, resname, chain, resseq, xyz, record="ATOM", element=None):
        serial[0] += 1
        atoms.append(_pdb_atom(serial[0], name, resname, chain, resseq,
                               tuple(xyz), record=record, element=element))

    lig_xyz = []
    for k in range(12):
        a = 2 * np.pi * k / 12
        lig_xyz.append((4.2 * np.cos(a), 4.2 * np.sin(a), 0.7))
    for k in range(12):
        a = 2 * np.pi * (k + 0.5) / 12
        lig_xyz.append((4.2 * np.cos(a), 4.2 * np.sin(a), -0.7))
    for xyz in ((0.0, 0.0, 0.0), (1.5, 0, 0), (-1.5, 0, 0), (0, 1.5, 0),
                (0, -1.5, 0), (0, 0, 1.4), (0, 0, -1.4),
                (2.85, 0, 0.7), (-2.85, 0, -0.7), (0, 2.85, -0.7),
                (0, -2.85, 0.7)):
        lig_xyz.append(xyz)
    lig_xyz = np.asarray(lig_xyz)
    c1 = lig_xyz[0]
    u1 = np.array([1.0, 0.0, 0.0])
    o1 = c1 + (stretch if stretch else 1.30) * u1
    resseq = 500
    for i, xyz in enumerate(lig_xyz):
        add(f"C{i + 2}", "LIG", "A", resseq, xyz, record="HETATM",
            element="C")
    add("O1", "LIG", "A", resseq, o1, record="HETATM", element="O")
    # residues and waters see both O1 positions, so R and P place them
    # alike and nothing sits on the dissociation path
    lig_all = np.vstack([lig_xyz, (c1 + 1.30 * u1)[None],
                         (c1 + 2.40 * u1)[None]])

    def surface_tip(u, offset):
        ts = np.arange(0.0, 14.0, 0.05)
        pts = ts[:, None] * u[None]
        dmin = np.linalg.norm(pts[:, None] - lig_all[None], axis=-1).min(1)
        inside = np.nonzero(dmin < offset)[0]
        k = inside[-1] if inside.size else 0
        return ts[min(k + 1, len(ts) - 1)] * u

    dirs = _fib_sphere(n_res + n_wat)
    wat_dirs, res_dirs = dirs[:n_wat], dirs[n_wat:]
    tips = []

    def clashes(pt, lim=2.2):
        return any(np.linalg.norm(pt - t) < lim for t in tips)

    for ri, u in enumerate(res_dirs):
        tip = surface_tip(u, 2.3)
        if clashes(tip):
            continue
        tips.append(tip)
        p = np.cross(u, [0.0, 0.0, 1.0])
        if np.linalg.norm(p) < 0.3:
            p = np.cross(u, [1.0, 0.0, 0.0])
        p /= np.linalg.norm(p)
        jitter = rng.normal(scale=0.03, size=3)
        resseq = 10 + ri
        if ri % 2 == 0:   # SER: OG (tip) - CB - CA - backbone
            add("OG", "SER", "A", resseq, tip + jitter, element="O")
            cb = tip + 1.43 * u
            ca = cb + 1.54 * u
            add("CB", "SER", "A", resseq, cb, element="C")
            add("CA", "SER", "A", resseq, ca, element="C")
            add("N", "SER", "A", resseq, ca + 1.46 * (0.8 * u + 0.6 * p),
                element="N")
            c = ca + 1.52 * (0.8 * u - 0.6 * p)
            add("C", "SER", "A", resseq, c, element="C")
            add("O", "SER", "A", resseq, c + 1.23 * u, element="O")
        else:             # ASN: OD1 (tip) - CG (+ND2) - CB - CA - backbone
            add("OD1", "ASN", "A", resseq, tip + jitter, element="O")
            cg = tip + 1.25 * u
            add("CG", "ASN", "A", resseq, cg, element="C")
            add("ND2", "ASN", "A", resseq, cg + 1.33 * (0.87 * u + 0.5 * p),
                element="N")
            cb = cg + 1.52 * (0.87 * u - 0.5 * p)
            ca = cb + 1.54 * u
            add("CB", "ASN", "A", resseq, cb, element="C")
            add("CA", "ASN", "A", resseq, ca, element="C")
            add("N", "ASN", "A", resseq, ca + 1.46 * (0.8 * u + 0.6 * p),
                element="N")
            c = ca + 1.52 * (0.8 * u - 0.6 * p)
            add("C", "ASN", "A", resseq, c, element="C")
            add("O", "ASN", "A", resseq, c + 1.23 * u, element="O")

    for wi, u in enumerate(wat_dirs):
        w = surface_tip(u, 2.45)
        if clashes(w):
            continue
        tips.append(w)
        add("O", "HOH", "A", 800 + wi,
            w + rng.normal(scale=0.05, size=3),
            record="HETATM", element="O")

    lines = [io_pdb.format_pdb_line(a, (a["x"], a["y"], a["z"]))
             for a in atoms]
    with open(path, "w") as fh:
        fh.write("\n".join(lines + ["END"]) + "\n")
    return len(atoms)


def add_outer_body(path, seed=1):
    """Append the outer protein body to the PDB at ``path``: GLY and ALA
    residues in full backbone (N, CA, C, O; CB for ALA) on a jittered
    cubic lattice of ALL_BODY_SPACING between the radii ALL_BODY_RADII
    around the ligand, lattice points within 4.2 Angstrom of an atom of
    the active site left out (a residue reaches 2.2 Angstrom from its
    point), element columns blank (the preflight repairs them). Returns
    (atoms added, the smallest distance from a body atom to a ligand
    atom)."""
    from pdb2reaction_tpu_torch.core import io_pdb
    rng = np.random.default_rng(seed)
    lines = [ln for ln in open(path).read().splitlines() if ln != "END"]
    site = io_pdb.parse_pdb_atoms(path)
    sxyz = np.array([[a["x"], a["y"], a["z"]] for a in site])
    lig = sxyz[[a["resname"] == "LIG" for a in site]]
    r0, r1 = ALL_BODY_RADII
    n = int(np.ceil(r1 / ALL_BODY_SPACING))
    ax = np.arange(-n, n + 1) * ALL_BODY_SPACING
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    rad = np.linalg.norm(pts, axis=1)
    pts = pts[(rad >= r0) & (rad <= r1)]
    pts = pts + rng.uniform(-0.3, 0.3, size=pts.shape)
    d_site = np.linalg.norm(pts[:, None] - sxyz[None], axis=-1).min(1)
    pts = pts[d_site > 4.2]
    offsets = {"N": (-1.2, 0.4, 0.0), "CA": (0.0, 0.0, 0.0),
               "C": (1.2, 0.5, 0.0), "O": (1.3, 1.7, 0.0),
               "CB": (-0.1, -0.8, 1.3)}
    serial = len(site)
    body = []
    for k, p in enumerate(pts):
        resname = "ALA" if k % 2 else "GLY"
        for name in ("N", "CA", "C", "O") + (("CB",) if k % 2 else ()):
            serial += 1
            xyz = p + np.asarray(offsets[name]) + rng.normal(scale=0.05,
                                                             size=3)
            body.append(xyz)
            lines.append(io_pdb.format_pdb_line(dict(
                record="ATOM", serial=serial, name=name, resname=resname,
                chain="B", resseq=1000 + k, element=""), xyz))
    with open(path, "w") as fh:
        fh.write("\n".join(lines + ["END"]) + "\n")
    body = np.asarray(body)
    return len(body), float(np.linalg.norm(body[:, None] - lig[None],
                                           axis=-1).min())


def all_pair(out):
    """R.pdb and P.pdb of phase 16 under ``out``; returns their paths,
    the atom count and the body's smallest distance to the ligand."""
    r, p = os.path.join(out, "R.pdb"), os.path.join(out, "P.pdb")
    n_site = build_enzyme_pdb(r, n_res=48, seed=0)
    build_enzyme_pdb(p, n_res=48, stretch=2.40, seed=0)
    n_body, d_lig = add_outer_body(r)
    add_outer_body(p)
    return r, p, n_site, n_body, d_lig


def all_active(r, p, scratch):
    """The pocket indices to freeze: the port's extraction of the pair
    (deterministic, as run_all's will be) and the pocket atoms farther
    than ALL_ACTIVE_RADIUS from the ligand's C2 and O1 in both models."""
    from pdb2reaction_tpu_torch.bio.extract import extract_api
    from pdb2reaction_tpu_torch.core import io_pdb
    outs = [os.path.join(scratch, f"pocket_{k}.pdb") for k in "RP"]
    extract_api([r, p], "LIG", outs, ligand_charge=0, device="cuda")
    near = None
    for o in outs:
        atoms = io_pdb.parse_pdb_atoms(o)
        x = np.array([[a["x"], a["y"], a["z"]] for a in atoms])
        ends = [i for i, a in enumerate(atoms) if a["resname"] == "LIG"
                and a["name"] in ("C2", "O1")]
        if len(ends) != 2:
            fail(f"the pocket {o} lacks the ligand's C2 or O1")
        d = np.linalg.norm(x[:, None] - x[ends][None], axis=-1).min(1)
        m = d <= ALL_ACTIVE_RADIUS
        near = m if near is None else near | m
    if len(near) != ALL_POCKET_ATOMS:
        fail(f"the extraction on the card gave a {len(near)}-atom pocket, "
             f"not the reference's {ALL_POCKET_ATOMS}")
    return [i for i in range(len(near)) if not near[i]], len(near)


def all_checks(out, res, n_full, n_pocket):
    """The output tree, atom counts and finite results of the run."""
    from pdb2reaction_tpu_torch.core import io_pdb
    summary = json.load(open(os.path.join(out, "summary.yaml")))
    need = ["summary.log", "stage2_path/mep.trj", "stage2_path/mep_full.pdb",
            "stage3_merged/mep_full.pdb"]
    need += [f"stage1_extract/pocket_elem_fixed_{k}.pdb" for k in "RP"]
    missing = [f for f in need if not os.path.exists(os.path.join(out, f))]
    if missing:
        fail(f"all wrote no {missing}")
    pocket = io_pdb.read_pdb(os.path.join(
        out, "stage1_extract", "pocket_elem_fixed_R.pdb"))
    if pocket.n_atoms != n_pocket:
        fail(f"run_all's pocket has {pocket.n_atoms} atoms, the phase's "
             f"own extraction {n_pocket}")
    fulls = [os.path.join(r, f) for r, _, fs in os.walk(out) for f in fs
             if f.endswith("_full.pdb")]
    for f in fulls:
        text = open(f).read()
        models = max(text.count("MODEL "), 1)
        n = text.count("\nATOM  ") + text.count("\nHETATM") + \
            text.startswith(("ATOM", "HETATM"))
        if n != models * n_full:
            fail(f"{f}: {n} atom records in {models} models, not "
                 f"{n_full} each")
    seg4 = [s for s in summary["stage4"]]
    if not any(s["reactive"] for s in summary["segments"]) or not seg4:
        fail("all found no reactive segment (stage 4 ran on none)")
    errors = [(e["segment"], k) for e in seg4 for k, v in e.items()
              if isinstance(v, dict) and "error" in v]
    if errors:
        fail(f"stage-4 entries hold errors: {errors} ({seg4})")
    for e in seg4:
        d = os.path.join(out, f"stage4_seg_{e['segment']:03d}")
        files = ["hei_guess.xyz", "tsopt/final_geometry.xyz",
                 "ts_final.xyz", "reactant_opt.xyz", "product_opt.xyz",
                 "irc.trj"] + [f"freq/{t}/{f}" for t in
                               ("reactant", "ts", "product")
                               for f in ("frequencies_cm-1.txt",
                                         "thermoanalysis.yaml")]
        missing = [f for f in files if not os.path.exists(os.path.join(d,
                                                                       f))]
        if missing:
            fail(f"segment {e['segment']} lacks {missing}")
        vals = [e["tsopt"]["energy_au"], *e["endpoints"].values(),
                *e["irc"]["endpoints_au"]]
        for t in ("reactant", "ts", "product"):
            th = json.load(open(os.path.join(d, "freq", t,
                                             "thermoanalysis.yaml")))
            fr = np.loadtxt(os.path.join(d, "freq", t,
                                         "frequencies_cm-1.txt"))
            vals += [e["thermo"][t]["G_au"], e["thermo"][t]["ZPE_au"],
                     th["gibbs"], *np.atleast_1d(fr)]
        if not np.all(np.isfinite(vals)):
            fail(f"segment {e['segment']}: non-finite energies, "
                 "frequencies or thermochemistry")
    return summary, len(fulls)


def phase_all(smi_line):
    """Phase 16: run_all on the enzyme-like R/P pair (escn-md, seed 0,
    pocket atoms beyond ALL_ACTIVE_RADIUS of the reacting C2-O1 frozen)
    with its counts set to 0 just before and read just after; then the
    default subcommand as a subprocess."""
    import shutil
    import torch
    from pdb2reaction_tpu_torch.constants import AU2KCALPERMOL
    from pdb2reaction_tpu_torch.workflows.allflow import run_all
    t_phase = time.perf_counter()
    out = os.path.join(HERE, "result_smoke", "all")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(os.path.join(out, "pre"))
    r, p, n_site, n_body, d_lig = all_pair(out)
    n_full = n_site + n_body
    freeze, n_pocket = all_active(r, p, os.path.join(out, "pre"))
    log(f"[all] {smi_line}; R/P: the {n_site}-atom active site of "
        f"scripts/tpu_all_e2e.py (n_res 48, seed 0; P with C2-O1 at 2.40 "
        f"A) plus a {n_body}-atom GLY/ALA body (blank element columns, "
        f"{ALL_BODY_RADII[0]}-{ALL_BODY_RADII[1]} A, nearest to the ligand "
        f"{d_lig:.2f} A): {n_full} atoms; pocket {n_pocket} atoms, "
        f"{n_pocket - len(freeze)} active (within {ALL_ACTIVE_RADIUS} A of "
        f"C2 or O1), {len(freeze)} frozen")
    log(f"[all] caps: {ALL_CAPS}; search max_depth 1, opt gau_loose, no "
        f"preopt; max_consecutive_kinks raised from 2 to {ALL_KINKS} (an "
        f"untrained surrogate may make every refinement a kink)")
    torch.cuda.reset_peak_memory_stats()
    zero_all_counts()
    before = all_counts()
    with stage4_meter() as m:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_all(
            [r, p], center="LIG", ligand_charge=0, model="escn-md",
            device="cuda", seed=0, pad_multiple=64, freeze_atoms=freeze,
            tsopt=True, do_freq=True, preopt=False, verbose=False,
            out_dir=os.path.join(out, "run"), gs_kw={"max_nodes": 10},
            max_cycles=ALL_CAPS["string cycles (max_cycles)"],
            search_kw={"max_depth": 1, "opt_thresh": "gau_loose",
                       "max_consecutive_kinks": ALL_KINKS},
            tsopt_kw={"max_cycles_total":
                      ALL_CAPS["tsopt max_cycles_total"],
                      "flatten_max_iter": ALL_CAPS["tsopt flatten_max_iter"]},
            opt_post_kw={"max_cycles":
                         ALL_CAPS["endpoint minimization max_cycles"]},
            irc_kw={"max_cycles": ALL_CAPS["irc max_cycles"]})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    moved = moved_counts(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fc, ec = res["force_calls"], res["energy_calls"]
    calc = res["calculator"]
    log(f"[all] run_all: {wall:.2f} s wall, {fc} force calls, {ec} energy "
        f"calls (P = {calc.n_pad}); {m.hess} Hessians in {m.hess_s:.2f} s "
        f"({m.hvps} HVPs, {m.hvps / max(m.hess, 1):.0f} each); the engines' "
        f"force calls {m.force_s:.2f} s, "
        f"{m.force_s / max(fc, 1) * 1e3:.2f} ms each; peak memory "
        f"{peak:.2f} GiB; launches {moved}")
    for name, ph in res["force_call_phases"].items():
        log(f"[all] stage {name}: {ph['seconds']:.2f} s, {ph['calls']} "
            f"force calls, {ph['energy_calls']} energy calls")
    want = {"fused_edge_mega_fwd": 4 * (fc + ec),
            "fused_edge_mega_bwd": 4 * fc,
            "fused_node_ffn_fwd": 4 * (fc + ec),
            "fused_node_ffn_bwd": 4 * fc}
    if moved != want:
        fail(f"all: launches {moved}, expected {want} (K1 and K2 forward "
             "4 x (force + energy calls), backward 4 x force calls, "
             "nothing else)")
    if m.inside:
        fail(f"all: kernels launched inside Hessians: {m.inside}")
    summary, n_merged = all_checks(os.path.join(out, "run"), res, n_full,
                                   n_pocket)
    segs = summary["segments"]
    log(f"[all] {len(segs)} segments "
        f"({sum(1 for s in segs if s['reactive'])} reactive): "
        f"{[(s['kind'], s['reactive'], s['barrier_kcal']) for s in segs]}; "
        f"chain {summary['diagram']['chain']}; {n_merged} merged PDBs of "
        f"{n_full} atoms a frame")
    for e in summary["stage4"]:
        ts = e["tsopt"]
        log(f"[all] segment {e['segment']}: tsopt converged "
            f"{ts['converged']}, n_imag {ts['n_imag']}, barrier "
            f"{(ts['energy_au'] - e['endpoints']['reactant']) * AU2KCALPERMOL:.2f}"
            f" kcal/mol over the minimized reactant; IRC ends "
            f"{e['irc']['matches_minima']}; G (Ha) "
            f"{ {t: round(v['G_au'], 6) for t, v in e['thermo'].items()} }")
    del res, calc
    torch.cuda.empty_cache()
    cli = all_cli(r, p, freeze, n_full)
    log(f"[all] phase 16 wall {time.perf_counter() - t_phase:.1f} s")
    return dict(moved), cli


def all_cli(r, p, freeze, n_full):
    """Phase 16b: ``python -m pdb2reaction_tpu_torch -i R.pdb -i P.pdb
    --center LIG --ligand-charge 0 --model escn-md ...`` with no
    subcommand (the default all), stage 4 off, as a subprocess on the
    card: rc 0 and the tree through stage3_merged. Returns its arguments
    after the module name, its output tree and its standard output."""
    out = os.path.join(os.path.dirname(r), "cli")
    os.makedirs(out)
    y = os.path.join(out, "args.yaml")
    with open(y, "w") as fh:
        fh.write("search:\n  max_depth: 0\n  opt_thresh: gau_loose\n"
                 f"  max_consecutive_kinks: {ALL_KINKS}\n")
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    args = ["-i", r, "-i", p, "--center", "LIG", "--ligand-charge", "0",
            "--model", "escn-md", "--max-nodes", "6", "--max-cycles", "5",
            "--preopt", "False", "--freeze-atoms",
            ",".join(map(str, freeze)), "--args-yaml", y]
    cmd = [sys.executable, "-m", "pdb2reaction_tpu_torch", *args,
           "--out-dir", os.path.join(out, "result_all")]
    t0 = time.perf_counter()
    rr = subprocess.run(cmd, cwd=out, env=env, capture_output=True,
                        text=True, timeout=600)
    tail = [ln for ln in rr.stdout.splitlines()
            if ln.startswith(("[all]", "[diagram]"))][-2:]
    log(f"[all] the default subcommand (all; escn-md, max_depth 0 from "
        f"--args-yaml, max_nodes 6, 5 string cycles, stage 4 off) as a "
        f"subprocess: rc {rr.returncode}, {time.perf_counter() - t0:.1f} s "
        f"with start-up; {tail}")
    if rr.returncode != 0:
        fail(f"the all CLI exited {rr.returncode}: {rr.stderr[-3000:]}")
    res = os.path.join(out, "result_all")
    need = ["elem_fixed_R.pdb", "stage1_extract/pocket_elem_fixed_R.pdb",
            "stage2_path/mep.trj", "stage2_path/mep_full.pdb",
            "stage3_merged/mep_full.pdb", "summary.yaml", "summary.log"]
    missing = [f for f in need if not os.path.exists(os.path.join(res, f))]
    if missing:
        fail(f"the all CLI wrote no {missing}")
    with open(os.path.join(res, "stage3_merged", "mep_full.pdb")) as fh:
        text = fh.read()
    n = text.count("\nATOM  ") + text.count("\nHETATM")
    if n != text.count("MODEL ") * n_full:
        fail("the all CLI's merged MEP does not carry the full atom count")
    return args, res, rr.stdout


# ---------------------------------------------------------------------------
# phase 17: the scans, stage 1b of all and the mini DFT engine on the card
# ---------------------------------------------------------------------------

SCAN_K = 300.0          # eV/Angstrom^2: wells stiff enough that a relaxed
                        # step ends within SCAN_TOL of its target
SCAN_TOL = 0.02         # Angstrom: a stage's last biased frame
SCAN1B_TOL = 0.05       # Angstrom: stage 1b's product at its target
DFT_E_TOL = 1e-10       # Hartree: the mini engine on the card against the
DFT_Q_TOL = 1e-8        # CPU (charges in e)
H2_RHF = -1.1168        # Hartree: RHF/STO-3G H2 at 0.74 A (JAX's bar)


def scan_run(tag, run):
    """One scan workflow with its counts set to 0 just before and read
    just after: the launch identity over its force and energy calls (the
    result's), none inside a Hessian; its wall, Hessians and ms a force
    call printed."""
    import torch
    zero_all_counts()
    before = all_counts()
    torch.cuda.reset_peak_memory_stats()
    with stage4_meter() as m:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fc, ec = res["force_calls"], res["energy_calls"]
    moved = moved_counts(before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[scan] {tag}: {wall:.2f} s wall; {fc} force calls, {ec} energy "
        f"calls, {m.force_s / max(fc, 1) * 1e3:.2f} ms a force call; "
        f"{m.hess} Hessians in {m.hess_s:.2f} s ({m.hvps} HVPs); peak "
        f"memory {peak:.2f} GiB; launches {moved}")
    want = {"fused_edge_mega_fwd": 4 * (fc + ec),
            "fused_edge_mega_bwd": 4 * fc,
            "fused_node_ffn_fwd": 4 * (fc + ec),
            "fused_node_ffn_bwd": 4 * fc}
    if moved != {k: v for k, v in want.items() if v}:
        fail(f"{tag}: launches {moved}, expected {want} (K1 and K2 forward "
             "4 x (force + energy calls), backward 4 x force calls)")
    if m.inside:
        fail(f"{tag}: kernels launched inside Hessians: {m.inside}")
    return res, m, wall


def _pair_near(x, active, exclude, want=2.5):
    """The pair of active atoms outside ``exclude`` whose distance is the
    closest to ``want`` Angstrom."""
    cand = [i for i in active if i not in exclude]
    best = None
    for a in range(len(cand)):
        for b in range(a + 1, len(cand)):
            i, j = cand[a], cand[b]
            d = abs(float(np.linalg.norm(x[i] - x[j])) - want)
            if best is None or d < best[0]:
                best = (d, i, j)
    return best[1], best[2]


def phase_scans(calc, st, bond, smi_line):
    """Phase 17: run_scan (two stages, then again from its checkpoints),
    run_scan_nd (a 3 x 3 L-BFGS grid, then one RFO point), the scan and
    scan3d CLIs, run_all's stage 1b on phase 16's reactant alone and
    run_dft's mini engine, on escn-md with phase 4's weights."""
    import shutil
    from pdb2reaction_tpu_torch.core.io_xyz import read_xyz, write_xyz
    from pdb2reaction_tpu_torch.workflows.scan import run_scan
    from pdb2reaction_tpu_torch.workflows.scan_nd import run_scan_nd
    t_phase = time.perf_counter()
    out = os.path.join(HERE, "result_smoke", "scans")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    x = st.coords
    d = np.linalg.norm(x[:, None, :] - x[list(bond)][None], axis=-1)
    active = [int(i) for i in np.nonzero(d.min(axis=1) <= STAGE4_RADIUS)[0]]
    freeze = [i for i in range(st.n_atoms) if i not in set(active)]
    h, heavy = bond
    p2 = _pair_near(x, active, set(bond))
    p3 = _pair_near(x, active, set(bond) | set(p2))

    def dist(c, p):
        return float(np.linalg.norm(c[p[0]] - c[p[1]]))

    d0, d2, d3 = dist(x, bond), dist(x, p2), dist(x, p3)
    path = os.path.join(out, "A.xyz")
    write_xyz(path, st)
    log(f"[scan] {smi_line}; escn-md pallas-mega, {st.n_atoms} atoms "
        f"(P = 320), phase 4's weights; active region {len(active)} atoms "
        f"within {STAGE4_RADIUS} A of H{h} or atom {heavy}, {len(freeze)} "
        f"frozen; pairs {tuple(bond)} at {d0:.3f} A, {p2} at {d2:.3f} A, "
        f"{p3} at {d3:.3f} A; wells k = {SCAN_K} eV/A^2")
    kw = dict(charge=0, model="escn-md", device="cuda", params=calc.params,
              pad_multiple=64, freeze_atoms=freeze, bias_k=SCAN_K,
              verbose=False)

    # (a) run_scan: two stages, then the same call from the checkpoints
    stages = [[(h, heavy, d0 - 0.3)],
              [(h, heavy, d0 - 0.4), (p2[0], p2[1], d2 - 0.2)]]
    sdir = os.path.join(out, "scan")

    def scan():
        return run_scan(path, stages, relax_thresh="gau_loose",
                        relax_max_cycles=20, endopt=True, opt_max_cycles=10,
                        dump=True, out_dir=sdir, **kw)

    ra, _, _ = scan_run("(a) run_scan, 2 stages (0.1 A steps, gau_loose, "
                        "20 cycles a step, endopt capped at 10)", scan)
    for si, (stage, res) in enumerate(zip(stages, ra["stages"])):
        last = np.asarray(res["frames_bohr"][-2]) * 0.529177210903
        off = [abs(dist(last, (i, j)) - t) for i, j, t in stage]
        log(f"[scan] stage {si + 1}: {len(res['frames_bohr']) - 1} steps "
            f"and the endopt; last biased frame off its targets by "
            f"{[round(o, 4) for o in off]} A; E {res['energies']}")
        if max(off) > SCAN_TOL or not np.all(np.isfinite(res["energies"])):
            fail(f"scan stage {si + 1} ended {max(off):.4f} A off its "
                 f"targets (limit {SCAN_TOL}) or with non-finite energies")
    need = ["stage_01.trj", "stage_02.trj", "final_geometry.xyz", "scan.trj"]
    missing = [f for f in need if not os.path.exists(os.path.join(sdir, f))]
    if missing:
        fail(f"run_scan wrote no {missing}")
    rb, _, _ = scan_run("(a) the same run_scan again (from its checkpoints)",
                        scan)
    if rb["force_calls"] != 0 or not np.array_equal(rb["coords_bohr"],
                                                    ra["coords_bohr"]):
        fail(f"the rerun made {rb['force_calls']} force calls or ended "
             "elsewhere: the checkpoints were not resumed")

    # (b) run_scan_nd: a 3 x 3 L-BFGS grid, then one RFO grid point
    axes = [{"pair": tuple(bond), "values": [d0, d0 - 0.1, d0 - 0.2]},
            {"pair": p2, "values": [d2, d2 - 0.1, d2 - 0.2]}]
    gdir = os.path.join(out, "grid")
    rg, _, _ = scan_run("(b) run_scan_nd, 3 x 3 grid, lbfgs, 15 cycles a "
                        "relaxation", lambda: run_scan_nd(
                            path, axes, relax_mode="lbfgs",
                            relax_max_cycles=15, out_dir=gdir, **kw))
    rows = np.loadtxt(os.path.join(gdir, "surface.csv"), delimiter=",",
                      skiprows=1)
    log(f"[scan] grid energies (Ha): {rg['surface'][:, 2].tolist()}")
    if rows.shape != (9, 3) or rg["energy_calls"] != 9 or not np.all(
            np.isfinite(rg["surface"])):
        fail(f"the grid gave {rows.shape} rows, {rg['energy_calls']} "
             "energy calls, or non-finite energies")
    one = [{"pair": tuple(bond), "values": [d0 - 0.1]},
           {"pair": p2, "values": [d2 - 0.1]}]
    rr, m_rfo, _ = scan_run("(b) run_scan_nd, one grid point, rfo from the "
                            "biased exact Hessian, 5 cycles", lambda:
                            run_scan_nd(path, one, relax_mode="rfo",
                                        relax_max_cycles=5,
                                        out_dir=os.path.join(out, "rfo"),
                                        **kw))
    if m_rfo.hess != 2 or m_rfo.hvps != 2 * 3 * len(active) \
            or not np.all(np.isfinite(rr["surface"])):
        fail(f"the RFO grid point ran {m_rfo.hess} Hessians of "
             f"{m_rfo.hvps} HVPs in all (expected 2 of {3 * len(active)})")

    # (c) the scan and scan3d CLIs as subprocesses
    scan_cli(out, path, freeze, bond, p2, p3, d0, d2, d3)
    # (d) all with --scan-lists on phase 16's reactant alone
    scan_all(out)
    # (e) the mini DFT engine on the card against the CPU
    mini_dft_card(out)
    log(f"[scan] phase 17 wall {time.perf_counter() - t_phase:.1f} s")


def scan_cli(out, path, freeze, bond, p2, p3, d0, d2, d3):
    """Phase 17c: ``scan`` (one stage, no preopt or endopt, --dump) and
    ``scan3d`` (a 2 x 2 x 2 grid: spans of 0.1 A at a 0.15 A maximum
    step, 5 cycles a relaxation) as subprocesses
    on the card: exit codes and outputs."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    base = ["--model", "escn-md", "-q", "0", "--freeze-atoms",
            ",".join(map(str, freeze)), "--bias-k", str(SCAN_K)]

    def one_based(p, t, *rest):
        return ",".join(str(v) for v in (p[0] + 1, p[1] + 1, t) + rest)

    runs = (("scan", ["--scan-list", one_based(bond, round(d0 - 0.2, 4)),
                      "--preopt", "False", "--endopt", "False",
                      "--relax-max-cycles", "10", "--dump", "True"],
             ("stage_01.trj", "final_geometry.xyz", "scan.trj"), None),
            ("scan3d", ["--scan", one_based(bond, round(d0 - 0.1, 4), 0.15),
                        "--scan", one_based(p2, round(d2 - 0.1, 4), 0.15),
                        "--scan", one_based(p3, round(d3 - 0.1, 4), 0.15),
                        "--preopt", "False", "--thresh", "gau_loose",
                        "--relax-max-cycles", "5"], ("surface.csv",), 8))
    for cmd, extra, files, n_rows in runs:
        d = os.path.join(out, f"cli_{cmd}")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "pdb2reaction_tpu_torch",
                            cmd, "-i", path, "--out-dir", d] + base + extra,
                           cwd=out, env=env, capture_output=True, text=True,
                           timeout=600)
        tail = [ln for ln in r.stdout.splitlines()
                if ln.startswith(f"[{cmd}")][-2:]
        log(f"[scan] (c) the {cmd} CLI as a subprocess: rc {r.returncode}, "
            f"{time.perf_counter() - t0:.1f} s with start-up; {tail}")
        if r.returncode != 0:
            fail(f"the {cmd} CLI exited {r.returncode}: {r.stderr[-3000:]}")
        missing = [f for f in files if not os.path.exists(
            os.path.join(d, f))]
        if missing:
            fail(f"the {cmd} CLI wrote no {missing}")
        if n_rows is not None:
            rows = np.loadtxt(os.path.join(d, "surface.csv"), delimiter=",",
                              skiprows=1)
            if rows.shape != (n_rows, 4) or not np.all(np.isfinite(rows)):
                fail(f"the {cmd} CLI's surface.csv has shape {rows.shape}")


def scan_all(out):
    """Phase 17d: run_all on phase 16's reactant PDB alone with
    scan_stages in full-structure indices (LIG C2-O1 to 2.40 A), remapped
    onto the pocket; the pocket atoms beyond ALL_ACTIVE_RADIUS of C2 and
    O1 frozen; max_depth 0, max_nodes 6, 5 string cycles, stage 4 off."""
    from pdb2reaction_tpu_torch.bio.extract import extract_api
    from pdb2reaction_tpu_torch.core import io_pdb
    from pdb2reaction_tpu_torch.core.io_xyz import read_xyz
    from pdb2reaction_tpu_torch.workflows.allflow import run_all
    d = os.path.join(out, "all")
    os.makedirs(os.path.join(d, "pre"))
    r = os.path.join(d, "R.pdb")
    n_site = build_enzyme_pdb(r, n_res=48, seed=0)
    n_body, _ = add_outer_body(r)
    n_full = n_site + n_body
    full = io_pdb.parse_pdb_atoms(r)
    ends = [i for n in ("C2", "O1") for i, a in enumerate(full)
            if a["resname"] == "LIG" and a["name"] == n]
    pre = os.path.join(d, "pre", "pocket.pdb")
    extract_api([r], "LIG", [pre], ligand_charge=0, device="cuda")
    patoms = io_pdb.parse_pdb_atoms(pre)
    pends = [i for n in ("C2", "O1") for i, a in enumerate(patoms)
             if a["resname"] == "LIG" and a["name"] == n]
    px = np.array([[a["x"], a["y"], a["z"]] for a in patoms])
    near = np.linalg.norm(px[:, None] - px[pends][None], axis=-1).min(1)
    freeze = [int(i) for i in np.nonzero(near > ALL_ACTIVE_RADIUS)[0]]
    log(f"[scan] (d) all with --scan-lists: R alone ({n_full} atoms), LIG "
        f"C2 / O1 = full-structure atoms {ends} (serials "
        f"{[i + 1 for i in ends]}), pocket ({len(patoms)} atoms) atoms "
        f"{pends}; {len(patoms) - len(freeze)} active within "
        f"{ALL_ACTIVE_RADIUS} A of them")
    run_dir = os.path.join(d, "run")
    res, _, _ = scan_run(
        "(d) run_all, stage 1b (C2-O1 1.30 -> 2.40 A, 0.1 A steps, 15 "
        "cycles a step, no preopt or endopt) and path-search (max_depth 0, "
        "max_nodes 6, 5 string cycles), stage 4 off", lambda: run_all(
            [r], center="LIG", ligand_charge=0, model="escn-md",
            device="cuda", seed=0, pad_multiple=64, freeze_atoms=freeze,
            scan_stages=[[(ends[0], ends[1], 2.40)]], preopt=False,
            verbose=False, out_dir=run_dir, gs_kw={"max_nodes": 6},
            max_cycles=5, search_kw={"max_depth": 0,
                                     "opt_thresh": "gau_loose",
                                     "max_consecutive_kinks": ALL_KINKS},
            scan_kw={"preopt": False, "endopt": False,
                     "relax_max_cycles": 15, "bias_k": SCAN_K}))
    for name, ph in res["force_call_phases"].items():
        log(f"[scan] (d) stage {name}: {ph['seconds']:.2f} s, "
            f"{ph['calls']} force calls, {ph['energy_calls']} energy calls")
    pocket = io_pdb.parse_pdb_atoms(os.path.join(
        run_dir, "stage1_extract", "pocket_elem_fixed_R.pdb"))
    if [(a["name"], a["resname"], a["resseq"]) for a in pocket] != \
            [(a["name"], a["resname"], a["resseq"]) for a in patoms]:
        fail("run_all's pocket differs from the phase's own extraction")
    prod = read_xyz(os.path.join(run_dir, "stage1b_scan",
                                 "scan_product.xyz")).coords
    got = float(np.linalg.norm(prod[pends[0]] - prod[pends[1]]))
    log(f"[scan] (d) scan_product.xyz: pocket C2-O1 {got:.4f} A (target "
        f"2.40); input {float(np.linalg.norm(px[pends[0]] - px[pends[1]])):.4f} A")
    if abs(got - 2.40) > SCAN1B_TOL:
        fail(f"stage 1b's product holds C2-O1 at {got:.4f} A, not 2.40 +- "
             f"{SCAN1B_TOL}: the scan did not drive the pocket's pair")
    need = ["stage2_path/mep.trj", "stage2_path/mep_full.pdb",
            "stage3_merged/mep_full.pdb", "summary.yaml", "summary.log"]
    missing = [f for f in need if not os.path.exists(os.path.join(run_dir,
                                                                   f))]
    if missing:
        fail(f"all with --scan-lists wrote no {missing}")
    with open(os.path.join(run_dir, "stage2_path", "mep_full.pdb")) as fh:
        text = fh.read()
    n = text.count("\nATOM  ") + text.count("\nHETATM") + \
        text.startswith(("ATOM", "HETATM"))
    if n != max(text.count("MODEL "), 1) * n_full:
        fail("the merged MEP of all --scan-lists lacks the full atom count")
    with open(os.path.join(run_dir, "summary.yaml")) as fh:
        segs = json.load(fh)["segments"]
    log(f"[scan] (d) {len(segs)} segments from the input to the scan "
        f"product: {[(s['kind'], s['reactive']) for s in segs]}")


def mini_dft_card(out):
    """Phase 17e: run_dft's RHF/STO-3G engine on the card and on the CPU
    for H2, HeH+ and H3+."""
    from pdb2reaction_tpu_torch.workflows.dft import run_dft
    mols = {"H2": ("2\n\nH 0 0 0\nH 0.74 0 0\n", 0),
            "HeH+": ("2\n\nHe 0 0 0\nH 0.772 0 0\n", 1),
            "H3+": ("3\n\nH 0 0 0\nH 0.87 0 0\nH 0.435 0.75 0\n", 1)}
    for name, (text, q) in mols.items():
        p = os.path.join(out, f"{name}.xyz")
        with open(p, "w") as fh:
            fh.write(text)
        got = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            got[dev] = run_dft(p, charge=q, spin=1, engine="mini",
                               device=dev, verbose=False, out_dir=os.path.join(
                                   out, f"dft_{name}_{dev}"))
            got[dev]["s"] = time.perf_counter() - t0
        g, c = got["cuda"], got["cpu"]
        de = abs(g["energy_au"] - c["energy_au"])
        dq = max(float(np.abs(np.subtract(g[k], c[k])).max())
                 for k in ("mulliken_charges", "meta_lowdin_charges"))
        log(f"[scan] (e) mini RHF/STO-3G {name}: E {g['energy_au']:.10f} Ha "
            f"on the card ({g['s'] * 1e3:.1f} ms), |dE| {de:.2e} Ha and "
            f"max|dq| {dq:.2e} e against the CPU")
        if not (de <= DFT_E_TOL and dq <= DFT_Q_TOL and g["converged"]):
            fail(f"the mini engine on the card disagrees with the CPU on "
                 f"{name}")
        if name == "H2" and abs(g["energy_au"] - H2_RHF) > 2e-3:
            fail(f"H2 at {g['energy_au']:.6f} Ha, not {H2_RHF} +- 2e-3")


# ---------------------------------------------------------------------------
# phase 18: delocalized internals and Direct Max Flux on escn-md
# ---------------------------------------------------------------------------

DLC_CYCLES = 20         # phase 18a / 18b cycle caps
DMF_IMAGES = 12         # phase 18c: the flagship string's 12 images
# the DMF runs' depth, cut to keep the whole script inside its limit
DMF_DEVICE_CYCLES = 24  # heavy-ball steps (8 per multiplier update)
DMF_NATIVE_CYCLES = 12  # L-BFGS-B iterations (at most 4 per update)
P18_X_TOL = 1e-4        # max|x_card - x_cpu64| / max|step of x_cpu64|
P18_CPU = {"dlc_cycles": 5, "dmf_images": 6, "dmf_cycles": 6}


def p18_reference_inputs():
    """Phase 18d's 64-atom inputs: phase 5's cluster and weights, and the
    DMF pair (A, A + phase 12's 0.08 Angstrom seeded displacement)."""
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.escn import (ESCN_CONFIGS,
                                                  init_escn_params)
    zs, xyz = cluster(64, seed=1)
    st = Structure(zs, xyz)
    w = init_escn_params(ESCN_CONFIGS["escn-md"], seed=0, device="cpu")
    return st, w, endpoint_b(xyz, np.ones(len(zs)))


def p18_runs(calc, xyzB):
    """5 DLC L-BFGS cycles (thresh "never") and 6 DMF heavy-ball steps of
    6 images on ``calc``: a dict of numpy arrays."""
    from pdb2reaction_tpu_torch.constants import ANG2BOHR
    from pdb2reaction_tpu_torch.engines.dlc import dlc_lbfgs_minimize
    from pdb2reaction_tpu_torch.engines.dmf import dmf_mep, fbenm_interpolate
    st = calc.structure
    x0 = calc.pad_bohr(st.coords_bohr)
    r = dlc_lbfgs_minimize(calc.au_energy_force_fn(), x0, st.numbers,
                           calc.n_atoms, thresh="never",
                           max_cycles=P18_CPU["dlc_cycles"])
    xB = calc.pad_bohr(xyzB * ANG2BOHR)
    start = fbenm_interpolate(x0, xB, P18_CPU["dmf_images"],
                              calc.system.numbers, calc.system.atom_mask)
    d = dmf_mep(calc, x0, xB, n_images=P18_CPU["dmf_images"],
                max_cycles=P18_CPU["dmf_cycles"])
    return {"dlc_x0": x0.cpu().numpy(), "dlc_x": r.x.cpu().numpy(),
            "dlc_e": r.e, "dlc_cycles": r.cycles,
            "dmf_start": start.cpu().numpy(), "dmf_images": d.images,
            "dmf_energies": d.energies, "dmf_cycles": d.cycles}


def p18_cpu_reference(out_path):
    """The CPU float64 plain path of phase 18d, run in its own process
    (``--p18-cpu OUT``) while the card works through phases 13-17; saved
    as an .npz."""
    import torch
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    torch.set_num_threads(3)        # beside the card phases' host work
    st, w, xyzB = p18_reference_inputs()
    cpu = make_uma_calculator(st, model="escn-md", device="cpu",
                              dtype=torch.float64, params=w)
    t0 = time.perf_counter()
    res = p18_runs(cpu, xyzB)
    res["seconds"] = time.perf_counter() - t0
    res["force_calls"] = cpu.force_calls
    np.savez(out_path, **res)
    # phase 19's 64-atom references, after phase 18d's own
    p19_cpu_reference(os.path.join(os.path.dirname(out_path),
                                   "p19_cpu.npz"))


def start_p18_cpu():
    """Start phase 18d's CPU reference (then phase 19's) in a child
    process; it is killed at exit if still running."""
    import atexit
    out = os.path.join(HERE, "result_smoke", "p18_cpu.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    for f in (out, os.path.join(os.path.dirname(out), "p19_cpu.npz")):
        if os.path.exists(f):
            os.remove(f)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--p18-cpu", out], cwd=HERE,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out, time.perf_counter()


class dlc_probe:
    """While entered: each DlcSpace built (primitives, n_dlc, seconds)."""

    def __enter__(self):
        from pdb2reaction_tpu_torch.engines import dlc
        self.spaces = []
        self.init0 = dlc.DlcSpace.__init__
        probe = self

        def init(sp, *a, **kw):
            t0 = time.perf_counter()
            probe.init0(sp, *a, **kw)
            probe.spaces.append((sum(map(len, sp.prims)), sp.n_dlc,
                                 sp.n_free, time.perf_counter() - t0))
        dlc.DlcSpace.__init__ = init
        return self

    def __exit__(self, *exc):
        from pdb2reaction_tpu_torch.engines import dlc
        dlc.DlcSpace.__init__ = self.init0


def p18_run(tag, run, calc, files=()):
    """One phase-18 run with its counts set to 0 just before and read just
    after: K1 and K2 forward 4 x (force + energy calls), backward 4 x
    force calls, none inside a Hessian; its files written."""
    import torch
    n_f, n_e = calc.force_calls, calc.energy_calls
    zero_all_counts()
    before = all_counts()
    with stage4_meter() as m, dlc_probe() as p:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fc, ec = calc.force_calls - n_f, calc.energy_calls - n_e
    moved = moved_counts(before)
    log(f"[dlc-dmf] {tag}: {wall:.2f} s wall; {fc} force calls, {ec} "
        f"energy calls, {m.force_s:.2f} s inside them "
        f"({m.force_s / max(fc, 1) * 1e3:.2f} ms a call); {m.hess} "
        f"Hessians in {m.hess_s:.2f} s, {m.hvps} HVPs; launches {moved}")
    want = {"fused_edge_mega_fwd": 4 * (fc + ec),
            "fused_edge_mega_bwd": 4 * fc,
            "fused_node_ffn_fwd": 4 * (fc + ec),
            "fused_node_ffn_bwd": 4 * fc}
    if moved != {k: v for k, v in want.items() if v} or fc == 0:
        fail(f"{tag}: launches {moved}, expected {want} (K1 and K2 forward "
             "4 x (force + energy calls), backward 4 x force calls)")
    if m.inside:
        fail(f"{tag}: kernels launched inside Hessians: {m.inside}")
    missing = [f for f in files if not os.path.exists(f)]
    if missing:
        fail(f"{tag} wrote no {missing}")
    return res, m, p, wall


def p18_dlc(calc, st, out, freeze, tag):
    """18a: run_opt(coord_type="dlc") on the 300-atom cluster."""
    from pdb2reaction_tpu_torch.core.io_xyz import read_xyz
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    from pdb2reaction_tpu_torch.workflows.opt import run_opt
    c = calc if not freeze else make_uma_calculator(
        st, model="escn-md", device="cuda", params=calc.params,
        pad_multiple=64, freeze_atoms=freeze)
    path = os.path.join(out, "cluster300.xyz")
    d = os.path.join(out, f"opt_{tag}")
    e0 = c.get_energy(st.coords_bohr)["energy"]
    res, m, p, wall = p18_run(
        f"(a) run_opt coord_type=dlc, {tag}, max_cycles {DLC_CYCLES}",
        lambda: run_opt(path, charge=0, spin=1, coord_type="dlc",
                        max_cycles=DLC_CYCLES, freeze_atoms=freeze,
                        auto_freeze_links=False, out_dir=d, calc=c,
                        verbose=False), c,
        [os.path.join(d, "final_geometry.xyz")])
    n_prims, n_dlc, n_free, t_init = p.spaces[0]
    cyc = max(res["cycles"], 1)
    host = (wall - m.force_s - t_init) / cyc
    log(f"[dlc-dmf] (a) {tag}: {n_prims} primitives, n_dlc {n_dlc} over "
        f"{n_free} free DOFs (U built in {t_init:.2f} s on the host's CPU); "
        f"{res['cycles']} cycles, {res['force_calls']} force calls, "
        f"converged {res['converged']}; E {e0:.8f} -> {res['energy']:.8f} "
        f"Ha; {host * 1e3:.1f} ms a cycle outside the force call (B by "
        f"jacrev, solves, back-transformation) against "
        f"{m.force_s / max(res['force_calls'], 1) * 1e3:.1f} ms a force call")
    if not (np.isfinite(res["energy"]) and res["energy"] < e0):
        fail(f"DLC L-BFGS ({tag}) did not lower the energy")
    x0 = read_xyz(path).coords_bohr          # the input as run_opt read it
    if freeze and not np.array_equal(res["coords_bohr"][freeze],
                                     x0[freeze]):
        fail("DLC L-BFGS moved a frozen atom")
    return host


def p18_dmf(calc, st, xyzB, solver, cycles):
    """18c: run_mep_between(mep_mode="dmf") on phase 12's flagship pair."""
    from pdb2reaction_tpu_torch import native
    from pdb2reaction_tpu_torch.workflows.path_opt import run_mep_between
    stB = st.copy(coords=xyzB)
    calls = [0]
    solve0 = native.lbfgsb_minimize

    def counted(*a, **kw):
        calls[0] += 1
        return solve0(*a, **kw)

    native.lbfgsb_minimize = counted
    try:
        res, m, _, wall = p18_run(
            f"(c) DMF {solver}, {DMF_IMAGES} images, max_cycles {cycles}",
            lambda: run_mep_between(st, stB, calc, mep_mode="dmf",
                                    dmf_kw={"n_images": DMF_IMAGES,
                                            "max_cycles": cycles,
                                            "solver": solver},
                                    verbose=False), calc)
    finally:
        native.lbfgsb_minimize = solve0
    batches = res.force_calls // DMF_IMAGES
    log(f"[dlc-dmf] (c) DMF {solver}: {res.cycles} cycles, {batches} "
        f"batched calls, {res.force_calls} images evaluated, constraint "
        f"violation {res.constraint_violation:.3e} Bohr, HEI {res.hei_idx}, "
        f"converged {res.converged}, {wall:.2f} s wall "
        f"({(wall - m.force_s) / max(batches, 1) * 1e3:.1f} ms a batch "
        f"outside the force calls)")
    if res.force_calls != batches * DMF_IMAGES or not (
            np.all(np.isfinite(res.energies))
            and np.all(np.isfinite(res.images))):
        fail(f"DMF {solver}: partial batches or non-finite results")
    if solver == "native" and not (calls[0] == 6 and "nlp_solver" in
                                   native._LIBS and os.path.exists(
                                       native.target("nlp_solver"))):
        fail(f"the native solver was not built and used ({calls[0]} "
             "solves)")
    return res


def p18_card_vs_cpu(ref64, proc, npz, t_start):
    """18d: the 64-atom runs on the card against the CPU float64 plain
    path of the child process, same weights."""
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    st, w, _ = ref64
    xyzB = endpoint_b(st.coords, np.ones(st.n_atoms))
    gpu = make_uma_calculator(st, model="escn-md", device="cuda", params=w)
    t0 = time.perf_counter()
    got = p18_runs(gpu, xyzB)
    t_card = time.perf_counter() - t0
    try:
        stdout, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail("phase 18d's CPU reference did not finish within 600 s of the "
             "card's part")
    waited = time.perf_counter() - t0 - t_card
    if proc.returncode != 0 or not os.path.exists(npz):
        fail(f"phase 18d's CPU reference failed: {stdout[-3000:]}")
    ref = np.load(npz)
    dx = np.abs(got["dlc_x"] - ref["dlc_x"]).max()
    step = np.abs(ref["dlc_x"] - ref["dlc_x0"]).max()
    di = np.abs(got["dmf_images"] - ref["dmf_images"]).max()
    dstep = np.abs(ref["dmf_images"] - ref["dmf_start"]).max()
    log(f"[dlc-dmf] (d) 64 atoms, card f32 kernels against the CPU float64 "
        f"plain path (same weights): DLC {got['dlc_cycles']} cycles, "
        f"max|dx| {dx:.3e} Bohr over a step of {step:.3e} ({dx / step:.3e} "
        f"relative), |dE| {abs(got['dlc_e'] - float(ref['dlc_e'])):.3e} Ha; "
        f"DMF {got['dmf_cycles']} steps of {P18_CPU['dmf_images']} images, "
        f"max|dx| {di:.3e} Bohr over a step of {dstep:.3e} "
        f"({di / dstep:.3e} relative), max|dE| "
        f"{np.abs(got['dmf_energies'] - ref['dmf_energies']).max():.3e} Ha "
        f"(tol {P18_X_TOL} relative); card {t_card:.1f} s, CPU process "
        f"{float(ref['seconds']):.1f} s for {int(ref['force_calls'])} force "
        f"calls, started {t0 - t_start:.1f} s before the card's part, "
        f"waited {waited:.1f} s for it")
    if not (dx <= P18_X_TOL * step and di <= P18_X_TOL * dstep
            and int(ref["dlc_cycles"]) == got["dlc_cycles"]):
        fail("phase 18d: the card's DLC or DMF path left the CPU float64 "
             "one")


def dmf_cli(st, xyzB):
    """18e: ``path-opt --mep-mode dmf`` as a subprocess, its DMF keys from
    the dmf: section of --args-yaml (P = 304)."""
    import shutil
    from pdb2reaction_tpu_torch.core.io_xyz import read_xyz_frames, write_xyz
    out = os.path.join(HERE, "result_smoke", "dmf_cli")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    a, b = os.path.join(out, "A.xyz"), os.path.join(out, "B.xyz")
    write_xyz(a, st)
    write_xyz(b, st.copy(coords=xyzB))
    y = os.path.join(out, "args.yaml")
    with open(y, "w") as fh:
        fh.write("dmf:\n  n_images: 8\n  max_cycles: 12\n")
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "pdb2reaction_tpu_torch", "path-opt",
           "-i", a, "-i", b, "--model", "escn-md", "--mep-mode", "dmf",
           "--args-yaml", y, "-q", "0"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=out, env=env, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    res = os.path.join(out, "result_path_opt")
    trj = os.path.join(res, "final_geometries.trj")
    n = len(read_xyz_frames(trj)) if os.path.exists(trj) else 0
    tail = [ln for ln in r.stdout.splitlines()
            if ln.startswith(("[path-opt] HEI", "[dmf]"))]
    log(f"[dlc-dmf] (e) path-opt --mep-mode dmf CLI (escn-md, 300 atoms, "
        f"dmf: n_images 8, max_cycles 12) as a subprocess: rc "
        f"{r.returncode}, {wall:.1f} s with start-up, {n} frames; {tail}")
    if r.returncode not in (0, 3):
        fail(f"path-opt --mep-mode dmf exited {r.returncode}: "
             f"{r.stderr[-3000:]}")
    if n != 8 or not os.path.exists(os.path.join(res, "hei.xyz")) or \
            not any("12 cycles, 104 DMF force calls" in ln for ln in tail):
        fail("path-opt --mep-mode dmf did not run 12 cycles of 8 images or "
             "did not write final_geometries.trj and hei.xyz")


def phase_dlc_dmf(calc, st, search, bond, ref64, cpu_ref, smi_line):
    """Phase 18: DLC L-BFGS (unconstrained and on phase 15's active
    region) and DLC RS-I-RFO from phase 13's TS guess through the opt and
    tsopt workflows, DMF (heavy ball and the native L-BFGS-B) on phase
    12's flagship pair through run_mep_between, the 64-atom card runs
    against the CPU float64 child process, and the DMF path-opt CLI."""
    import shutil
    import torch
    from pdb2reaction_tpu_torch.core.io_xyz import read_xyz, write_xyz
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    from pdb2reaction_tpu_torch.workflows.tsopt import run_tsopt
    t_phase = time.perf_counter()
    out = os.path.join(HERE, "result_smoke", "dlc_dmf")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    write_xyz(os.path.join(out, "cluster300.xyz"), st)
    x = st.coords
    d = np.linalg.norm(x[:, None, :] - x[list(bond)][None], axis=-1)
    active = set(np.nonzero(d.min(axis=1) <= STAGE4_RADIUS)[0].tolist())
    freeze = [i for i in range(st.n_atoms) if i not in active]
    log(f"[dlc-dmf] {smi_line}; escn-md pallas-mega, {st.n_atoms} atoms "
        f"(P = {calc.n_pad}), phase 4's weights; active region "
        f"{len(active)} atoms, {len(freeze)} frozen")
    torch.cuda.reset_peak_memory_stats()
    # (a) DLC L-BFGS through run_opt, unconstrained and constrained
    h_all = p18_dlc(calc, st, out, [], "unconstrained")
    h_act = p18_dlc(calc, st, out, freeze, "active region")
    # (b) DLC RS-I-RFO through run_tsopt from phase 13's TS guess
    xg, seg, freeze_g = stage4_guess(search, bond)
    guess = st.copy(coords=xg)
    gpath = os.path.join(out, "ts_guess.xyz")
    write_xyz(gpath, guess)
    c4 = make_uma_calculator(guess, model="escn-md", device="cuda",
                             params=calc.params, pad_multiple=64,
                             freeze_atoms=freeze_g)
    dt = os.path.join(out, "tsopt_dlc")
    rb, mb, pb, _ = p18_run(
        f"(b) run_tsopt heavy coord_type=dlc, max_cycles {DLC_CYCLES}",
        lambda: run_tsopt(gpath, opt_mode="heavy", coord_type="dlc",
                          max_cycles=DLC_CYCLES, out_dir=dt, charge=0,
                          verbose=False, calculator=c4), c4,
        [os.path.join(dt, f) for f in ("final_geometry.xyz",
                                       "imag_mode.trj")])
    log(f"[dlc-dmf] (b) {pb.spaces[0][0]} primitives, n_dlc "
        f"{pb.spaces[0][1]}; {rb['cycles']} cycles, converged "
        f"{rb['converged']}; {mb.hess} Hessians of "
        f"{mb.hvps // max(mb.hess, 1)} HVPs on the plain path "
        f"({mb.hess_s:.2f} s); E = "
        f"{rb['energy']:.8f} Ha, {rb['n_imag']} imaginary modes, lowest "
        f"{np.min(rb['freqs_cm']) if len(rb['freqs_cm']) else 'none'} cm-1")
    if mb.hvps != mb.hess * 3 * (st.n_atoms - len(freeze_g)) or not (
            np.isfinite(rb["energy"])
            and np.all(np.isfinite(rb["coords_bohr"]))):
        fail("DLC RS-I-RFO: Hessians of the wrong size or non-finite "
             "results")
    if not np.array_equal(rb["coords_bohr"][freeze_g],
                          read_xyz(gpath).coords_bohr[freeze_g]):
        fail("DLC RS-I-RFO moved a frozen atom")
    # (c) DMF on the flagship pair, heavy ball and native L-BFGS-B
    free = calc.system.free_mask[: calc.n_atoms].cpu().numpy()
    xyzB = endpoint_b(st.coords, free)
    p18_dmf(calc, st, xyzB, "device", DMF_DEVICE_CYCLES)
    p18_dmf(calc, st, xyzB, "native", DMF_NATIVE_CYCLES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # (d) the 64-atom card runs against the CPU float64 child process
    p18_card_vs_cpu(ref64, *cpu_ref)
    # (e) the DMF path-opt CLI
    dmf_cli(st, xyzB)
    log(f"[dlc-dmf] DLC host work a cycle outside the force call: "
        f"{h_all * 1e3:.1f} ms unconstrained, {h_act * 1e3:.1f} ms on the "
        f"active region; peak memory over (a)-(c) {peak:.2f} GiB; phase 18 "
        f"wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 19: the gate and full branches and remat_blocks on the card
# ---------------------------------------------------------------------------

P19_MODELS = ("escn-md-gate", "escn-s")
P19_CYCLES = 10          # 19a / 19b L-BFGS cycles
# launches per force call on each path: (a) gate and (b) full run their
# edge paths plain (no edge kernel in either package) and K2 each layer;
# (c) remat launches every forward twice a layer
P19_WANT = {
    "escn-md-gate": {"fused_node_ffn_fwd": 4, "fused_node_ffn_bwd": 4},
    "escn-s": {"fused_node_ffn_fwd": 2, "fused_node_ffn_bwd": 2},
    "escn-md remat": {"fused_edge_mega_fwd": 8, "fused_edge_mega_bwd": 4,
                      "fused_node_ffn_fwd": 8, "fused_node_ffn_bwd": 4},
}


def p19_weights(model, device="cpu"):
    from pdb2reaction_tpu_torch.mlip.escn import (ESCN_CONFIGS,
                                                  init_escn_params)
    return init_escn_params(ESCN_CONFIGS[model], seed=0, device=device)


def p19_cpu_reference(out_path):
    """19a / 19b's CPU float64 plain-path forces on phase 5's 64-atom
    cluster with each model's seed-0 weights; run by phase 18d's child
    process after its own runs."""
    import torch
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    st = Structure(*cluster(64, seed=1))
    res = {}
    for model in P19_MODELS:
        cpu = make_uma_calculator(st, model=model, device="cpu",
                                  dtype=torch.float64,
                                  params=p19_weights(model))
        t0 = time.perf_counter()
        r = cpu.get_forces(st.coords_bohr.reshape(-1))
        res[f"{model}/forces"] = r["forces"]
        res[f"{model}/energy"] = r["energy"]
        res[f"{model}/seconds"] = time.perf_counter() - t0
    np.savez(out_path, **res)


def branch_force(tag, calc, reps):
    """One phase-19 force path: counts set to 0 just before and read just
    after; ms per get_forces over ``reps`` calls after a warm-up, peak
    memory, a further call bit for bit equal, launches per force call.
    Returns (forces, ms, peak GiB, launches per call, launches)."""
    import torch
    cb = calc.structure.coords_bohr.reshape(-1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    zero_escn_counts()
    calc.force_calls = 0
    res = calc.get_forces(cb)                # first call (warm-up)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = calc.get_forces(cb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    f = res["forces"]
    same = np.array_equal(calc.get_forces(cb)["forces"], f)
    launches = escn_counts()                 # read just after the path
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_call = {k: v / calc.force_calls for k, v in launches.items() if v}
    log(f"[branch] {tag}, {calc.n_atoms} atoms (P = {calc.n_pad}): "
        f"{ms:.2f} ms per get_forces over {reps} calls, peak memory "
        f"{peak:.2f} GiB ({peak - base:.2f} above the {base:.2f} GiB held "
        f"before), E = {res['energy']:.8f} Ha; next call bit for bit "
        f"equal: {same}; launches per force call {per_call}")
    if f.shape != (3 * calc.n_atoms,) or not np.all(np.isfinite(f)) \
            or not np.isfinite(res["energy"]):
        fail(f"{tag}: non-finite or mis-shaped forces")
    if not same:
        fail(f"{tag}: two force calls gave different forces")
    return f, ms, peak, per_call, launches


def launch_identity(launches, want, force_calls, energy_calls):
    """The launches of a run of ``force_calls`` force and ``energy_calls``
    energy calls on a path with ``want`` launches per force call: each
    forward once more per energy call, nothing else launched."""
    return all(launches[k] == v * (force_calls + (energy_calls if
                                                  k.endswith("_fwd") else 0))
               for k, v in want.items()) \
        and not any(launches[k] for k in launches if k not in want)


def phase_branches(calc, st, f_mega, ms_force, smi_line):
    """Phase 19: (a) escn-md-gate and (b) escn-s on the 300-atom cluster
    (P = 320, seed-0 weights), their force calls, a 10-cycle L-BFGS opt
    each and their 64-atom forces against phase 18d's CPU float64 child;
    (c) escn-md with remat_blocks=True in pallas-mega on phase 4's
    weights, bit for bit phase 4's forces. Returns the launches of the
    three paths."""
    import dataclasses

    import torch
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.escn import escn_energy_fn
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    t_phase = time.perf_counter()
    log(f"[branch] {smi_line}; phase 19 on the 300-atom cluster, seed-0 "
        "weights")
    npz = os.path.join(HERE, "result_smoke", "p19_cpu.npz")
    if not os.path.exists(npz):
        fail("phase 19's CPU float64 references are missing (phase 18d's "
             "child process)")
    ref = np.load(npz)
    st64 = Structure(*cluster(64, seed=1))
    total = {}
    for tag, model in zip("ab", P19_MODELS):
        c = make_uma_calculator(st, model=model, device="cuda",
                                params=p19_weights(model), pad_multiple=64,
                                weights_source="surrogate-seeded")
        _, ms, _, per_call, launches = branch_force(f"({tag}) {model}", c,
                                                    reps=5)
        c.force_calls = c.energy_calls = 0
        zero_escn_counts()                   # just before the opt
        phase_opt(c, P19_CYCLES, name=model)
        opt_launches = escn_counts()         # read just after the opt
        want = P19_WANT[model]
        if per_call != want:
            fail(f"{model}: launches per force call {per_call}, want {want}")
        if not launch_identity(opt_launches, want, c.force_calls,
                               c.energy_calls):
            fail(f"{model} opt: launches {opt_launches} for "
                 f"{c.force_calls} force and {c.energy_calls} energy calls, "
                 f"want {want} a force call, forwards also an energy call")
        for k in set(launches) | set(opt_launches):
            total[k] = total.get(k, 0) + launches[k] + opt_launches[k]
        del c
        gpu = make_uma_calculator(st64, model=model, device="cuda",
                                  params=p19_weights(model))
        rg = gpu.get_forces(st64.coords_bohr.reshape(-1))
        fr = ref[f"{model}/forces"]
        err = float(np.abs(rg["forces"] - fr).max() / np.abs(fr).max())
        de = abs(rg["energy"] - float(ref[f"{model}/energy"]))
        log(f"[branch] ({tag}) {model} 64 atoms, card f32 vs the CPU f64 "
            f"plain path (child process, "
            f"{float(ref[f'{model}/seconds']):.1f} s): max|dF|/max|F| = "
            f"{err:.3e} (tol {FORCE_TOL}), |dE| = {de:.3e} Ha; its 300-atom "
            f"force call {ms:.2f} ms, {ms / ms_force:.2f}x phase 4's "
            f"{ms_force:.2f} ms")
        if not err <= FORCE_TOL:
            fail(f"{model} card forces disagree with the CPU float64 plain "
                 "path")
        del gpu
        torch.cuda.empty_cache()
    # (c) remat_blocks on phase 4's calculator and weights
    cfg_r = dataclasses.replace(calc.cfg, remat_blocks=True)
    calc_r = make_uma_calculator(st, model="escn-md", device="cuda",
                                 params=calc.params, pad_multiple=64,
                                 weights_source="surrogate-seeded")
    calc_r.energy_fn, calc_r.cfg = escn_energy_fn(cfg_r), cfg_r
    f0, ms0, peak0, _, _ = branch_force("(c) escn-md pallas-mega, remat off",
                                        calc, reps=5)
    f_r, ms_r, peak_r, per_call, launches = branch_force(
        "(c) escn-md pallas-mega, remat_blocks=True", calc_r, reps=5)
    same = np.array_equal(f_r, f_mega) and np.array_equal(f_r, f0)
    log(f"[branch] (c) remat_blocks: forces bit for bit phase 4's: {same}; "
        f"{ms_r:.2f} ms against {ms0:.2f} ms per get_forces "
        f"({ms_r / ms0:.2f}x), peak memory {peak_r:.2f} GiB against "
        f"{peak0:.2f} GiB; phase 19 wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not same:
        fail("remat_blocks changed the forces")
    if per_call != P19_WANT["escn-md remat"]:
        fail(f"remat launches per force call {per_call}, want "
             f"{P19_WANT['escn-md remat']}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    del calc_r
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# PaiNN-class uma-s-1p1: K5 and the pallas-mode path
# ---------------------------------------------------------------------------

def k5_pairs(x, mask, cutoff):
    """Ordered pairs (i != j, both atoms real) inside the cutoff: the only
    pairs whose adjacency is not zero."""
    import torch
    d = torch.sqrt(torch.clamp(
        ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1), min=1e-12))
    real = mask > 0
    within = (d <= cutoff) & real[:, None] & real[None, :]
    within.fill_diagonal_(False)
    return int(within.sum())


def k5_flops(pairs, R1, F, plan):
    """(forward, feats gradient, coordinate gradient) FLOP per launch:
    what the function needs, 2 R1 F per pair inside the cutoff (one S
    product for the coordinate gradient: S2[i, j] = S1[j, i]), and what
    the kernels compute on the tile plan's listed tile pairs (``plan``:
    TilePlan.stats)."""
    need = 2 * pairs * R1 * F
    return ((need, need, need),
            (plan["fwd_flop"], plan["fwd_flop"], plan["coords_flop"]))


def pallas_calculator(st, cfg, w):
    from pdb2reaction_tpu_torch.mlip.calculator import Calculator
    from pdb2reaction_tpu_torch.mlip.escn import tree_to
    from pdb2reaction_tpu_torch.mlip.model import make_energy_fn
    calc = Calculator(st, make_energy_fn(cfg),
                      params=tree_to(w, device="cuda"), device="cuda",
                      weights_source="surrogate-seeded")
    calc.cfg = cfg
    return calc


def k5_streams(calc):
    """Coordinates, mask, a seeded stream A [P, 4C] and the real
    first-layer stream B = [x_k phi_vs]_k | phi_vs of the pallas model."""
    import torch
    from pdb2reaction_tpu_torch.mlip import model as tm
    cfg, p = calc.cfg, calc.params
    x = calc._to_pad_ang(calc.structure.coords_bohr).float()
    mask = calc.system.atom_mask.float()
    with torch.no_grad():
        _, s = tm._embed_nodes(calc.system, p, cfg, mask)
        phi_vs = tm._apply_mlp(p["layers"][0]["phi"], s).chunk(3, -1)[2]
        featsB = torch.cat([x[:, k:k + 1] * phi_vs for k in range(3)]
                           + [phi_vs], -1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    featsA = torch.randn(featsB.shape, generator=gen, device="cuda")
    return x, mask, featsA, featsB


def phase_k5(calc, quick):
    """K5 forward / feats gradient / coordinate gradient against the plain
    version at the pallas path's shapes, for both streams."""
    import torch
    from pdb2reaction_tpu_torch.mlip import radial_contract as rcm
    reps = 2 if quick else 5
    cfg = calc.cfg
    rc, R = cfg.cutoff, cfg.n_radial
    x0, mask0, featsA, featsB = k5_streams(calc)
    P, F = featsA.shape
    gen = torch.Generator(device="cuda").manual_seed(2)
    g = torch.randn(P, R + 1, F, generator=gen, device="cuda")
    names = ("radial_contract_fwd", "radial_contract_bwd_feats",
             "radial_contract_bwd_coords")
    # the same system in a shuffled atom order: the tile plan restores it
    sh = torch.randperm(P, generator=torch.Generator().manual_seed(4)).cuda()
    plans = {}
    for label, xx, mm in (("lattice order", x0, mask0),
                          ("shuffled", x0[sh], mask0[sh])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = rcm.tile_plan(xx, mm, rc)
        torch.cuda.synchronize()
        plans[label] = plan.stats(R + 1, F)
        plans[label]["ms"] = (time.perf_counter() - t0) * 1e3
    got = {k: [] for k in names}
    for label, feats, div_d, x, mask in (
            ("A", featsA, False, x0, mask0), ("B", featsB, True, x0, mask0),
            ("A shuffled", featsA[sh], False, x0[sh], mask0[sh])):
        outs = []
        for fn in (rcm.radial_contract, rcm.radial_contract_plain):
            c = x.clone().requires_grad_(True)
            f = feats.clone().requires_grad_(True)
            T = fn(c, mask, f, rc, R, div_d)
            df, dc = torch.autograd.grad(T, [f, c], g)
            outs.append((T.detach(), df, dc))
            del T
        torch.cuda.synchronize()
        errs = [(abs_err(a, b), rel_err(a, b)) for a, b in zip(*outs)]
        del outs
        log(f"[K5] stream {label} (div_d={div_d}, P={P}, F={F}, "
            f"R+1={R + 1}): rel err fwd {errs[0][1]:.3e}, feats "
            f"{errs[1][1]:.3e}, coords {errs[2][1]:.3e} (tol {KERNEL_TOL})")
        if max(e[1] for e in errs) > KERNEL_TOL:
            fail(f"K5 stream {label} disagrees with its plain version")
        # the forward's time is the call: its tile plan and the kernel;
        # the kernel alone on a plan built beforehand beside it
        plan = rcm.tile_plan(x, mask, rc)
        with torch.no_grad():
            t = [cuda_ms(lambda: rcm.radial_contract(
                    x, mask, feats, rc, R, div_d), reps, warm=1),
                 cuda_ms(lambda: rcm.radial_contract_plain(
                    x, mask, feats, rc, R, div_d), reps, warm=1)]
            t_kern = cuda_ms(lambda: rcm.contract_on_plan(
                plan, feats, rc, R, div_d), reps, warm=1)
        del plan
        for wrt in ("feats", "coords"):
            for fn in (rcm.radial_contract, rcm.radial_contract_plain):
                c = x.clone().requires_grad_(wrt == "coords")
                f = feats.clone().requires_grad_(wrt == "feats")
                T = fn(c, mask, f, rc, R, div_d)
                leaf = c if wrt == "coords" else f
                t.append(cuda_ms(lambda: torch.autograd.grad(
                    T, [leaf], g, retain_graph=True), reps, warm=1))
                del T
        if label in ("A", "B"):       # the rows' times: streams A and B
            for i, k in enumerate(names):
                got[k].append((errs[i][0], t[2 * i], t[2 * i + 1]))
        log(f"[K5] stream {label}: kernel / plain ms fwd {t[0]:.2f} / "
            f"{t[1]:.2f} (the call with its tile plan; the kernel alone "
            f"{t_kern:.2f}, the plan {t[0] - t_kern:.2f}, one a force "
            f"call), feats {t[2]:.2f} / {t[3]:.2f}, coords {t[4]:.2f} / "
            f"{t[5]:.2f}")
    pairs = k5_pairs(x0, mask0, rc)
    log(f"[K5] {pairs} ordered pairs inside {rc} A of {P * (P - 1)} "
        f"({100 * pairs / (P * (P - 1)):.2f}%, {pairs / P:.1f} per atom)")
    for label, st in plans.items():
        log(f"[K5-plan] {label}: {st['tiles']} tiles of 32, "
            f"{st['listed']} listed tile pairs of {st['tiles'] ** 2} "
            f"({100 * st['share']:.2f}%; {st['listed_upper']} with I <= J), "
            f"{pairs / st['listed']:.1f} pairs inside the cutoff per listed "
            f"tile pair (of 1024); plan built in {st['ms']:.2f} ms")
        if st["share"] > 0.25:
            fail(f"the tile plan ({label}) lists more than 25% of tile pairs")
    flops, computed = k5_flops(pairs, R + 1, F, plans["lattice order"])
    c_b, m_b, f_b, g_b = (nbytes(x0), nbytes(mask0), nbytes(featsA),
                          nbytes(g))
    byts = (c_b + m_b + f_b + g_b, c_b + m_b + g_b + f_b,
            c_b + m_b + f_b + g_b + c_b)
    rows = {}
    for k, fl, fc, nb in zip(names, flops, computed, byts):
        v = got[k]
        rows[k] = (max(e for e, _, _ in v), sum(t for _, t, _ in v) / len(v),
                   sum(tp for _, _, tp in v) / len(v), fl, nb)
        b32, bbf, by = bound_ms(fl, nb, k)
        route = "3xTF32" if k in ROUTE_PEAK else "f32 CUDA cores"
        log(f"[kernel] {k}: {rows[k][1]:.3f} ms (plain {rows[k][2]:.3f} ms;"
            f" mean of streams A and B), needed {fl / 1e9:.1f} GFLOP "
            f"(pairs inside the cutoff), computed {fc / 1e9:.1f} GFLOP "
            f"(listed tile pairs), {nb / 1e6:.1f} MB, bound at f32 accuracy "
            f"{b32:.3f} ms "
            f"({route}, {by}) / bf16 {bbf:.3f} ms; computed at "
            f"{fc / rows[k][1] / 1e9:.2f} TFLOP/s, needed at "
            f"{fl / rows[k][1] / 1e9:.2f} TFLOP/s")
    return rows


def phase_k5_r33(calc, quick):
    """K5's three kernels and their plain versions at uma-m-1p1 shapes on
    the 4096-atom system (F = 4C = 2048, R + 1 = 33: the CUDA-core route of
    each kernel), stream A: errors and times, one log line."""
    import torch
    from pdb2reaction_tpu_torch.mlip import radial_contract as rcm
    from pdb2reaction_tpu_torch.mlip.model import CONFIGS
    cfg = CONFIGS["uma-m-1p1"]
    rc, R, F = cfg.cutoff, cfg.n_radial, 4 * cfg.hidden
    reps = 1 if quick else 2
    x, mask, _, _ = k5_streams(calc)
    P = x.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    feats = torch.randn(P, F, generator=gen, device="cuda")
    g = torch.randn(P, R + 1, F, generator=gen, device="cuda")
    outs, t = [], []
    for fn in (rcm.radial_contract, rcm.radial_contract_plain):
        c = x.clone().requires_grad_(True)
        f = feats.clone().requires_grad_(True)
        T = fn(c, mask, f, rc, R)
        outs.append((T.detach(), *torch.autograd.grad(T, [f, c], g)))
        del T
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(*outs)]
    del outs
    with torch.no_grad():
        for fn in (rcm.radial_contract, rcm.radial_contract_plain):
            t.append(cuda_ms(lambda: fn(x, mask, feats, rc, R), reps,
                             warm=1))
    for wrt in ("feats", "coords"):
        for fn in (rcm.radial_contract, rcm.radial_contract_plain):
            c = x.clone().requires_grad_(wrt == "coords")
            f = feats.clone().requires_grad_(wrt == "feats")
            T = fn(c, mask, f, rc, R)
            leaf = c if wrt == "coords" else f
            t.append(cuda_ms(lambda: torch.autograd.grad(
                T, [leaf], g, retain_graph=True), reps, warm=1))
            del T
    need = 2 * k5_pairs(x, mask, rc) * (R + 1) * F
    log(f"[K5-R33] uma-m-1p1 shapes (P={P}, F={F}, R+1={R + 1}, CUDA "
        f"cores): kernel / plain ms fwd {t[0]:.2f} / {t[1]:.2f} (the call "
        f"with its tile plan), feats {t[2]:.2f} / {t[3]:.2f}, coords "
        f"{t[4]:.2f} / {t[5]:.2f}; rel err fwd {errs[0]:.3e}, feats "
        f"{errs[1]:.3e}, coords {errs[2]:.3e} (tol {KERNEL_TOL}); needed "
        f"{need / 1e9:.1f} GFLOP a launch, bound {need / F32_PEAK * 1e3:.3f}"
        f" ms at the f32 CUDA-core peak")
    if max(errs) > KERNEL_TOL:
        fail("K5 at uma-m-1p1 shapes disagrees with its plain version")
    del g, feats
    torch.cuda.empty_cache()


def phase_pallas(st, w, reps, cycles):
    """The PaiNN kernel path: uma-s-1p1 pallas mode, force calls and opt;
    K5 counts set to 0 just before and read just after. Returns the K5
    launches and the first calls' (energy, forces)."""
    import dataclasses

    import torch
    from pdb2reaction_tpu_torch.core.io_xyz import write_xyz
    from pdb2reaction_tpu_torch.mlip import radial_contract as rcm
    from pdb2reaction_tpu_torch.mlip.model import CONFIGS
    from pdb2reaction_tpu_torch.workflows.opt import run_opt
    cfg = dataclasses.replace(CONFIGS["uma-s-1p1"], mp_mode="pallas")
    calc = pallas_calculator(st, cfg, w)
    cb = st.coords_bohr.reshape(-1)
    for k in rcm.launches:
        rcm.launches[k] = 0
    rcm.plans["built"] = 0
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
        fail("pallas force call returned non-finite or mis-shaped output")
    per_call = {k: v / calc.force_calls for k, v in rcm.launches.items()}
    log(f"[pallas] uma-s-1p1 pallas, {calc.n_atoms} atoms "
        f"(P={calc.n_pad}): {ms:.1f} ms per get_forces over {reps} calls, "
        f"peak memory {peak:.2f} GiB, E = {res['energy']:.8f} Ha, max|F| "
        f"= {np.abs(f).max():.3e} Ha/Bohr; K5 launches per force call "
        f"{per_call}; tile plans per force call "
        f"{rcm.plans['built'] / calc.force_calls:g} (their statistics: "
        f"[K5-plan], lattice order)")
    want = dict(zip(rcm.launches, (8, 7, 8)))
    if per_call != want:
        fail(f"K5 launches per force call {per_call}, want {want}")
    if rcm.plans["built"] != calc.force_calls:
        fail(f"{rcm.plans['built']} tile plans in {calc.force_calls} force "
             "calls, want one a call")
    again = calc.get_forces(cb)["forces"]
    log(f"[pallas] next call bit for bit equal: {np.array_equal(again, f)}")
    if not np.array_equal(again, f):
        fail("pallas: two force calls gave different forces")

    out = os.path.join(HERE, "result_smoke")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"cluster{calc.n_atoms}.xyz")
    write_xyz(path, st)
    e0 = res["energy"]
    final = os.path.join(out, "final_geometry.xyz")
    if os.path.exists(final):
        os.remove(final)
    t0 = time.perf_counter()
    ro = run_opt(path, charge=0, spin=1, model="uma-s-1p1", device="cuda",
                 max_cycles=cycles, out_dir=out, calc=calc, verbose=False)
    wall = time.perf_counter() - t0
    launches = dict(rcm.launches)            # read just after the path
    log(f"[pallas-opt] uma-s-1p1 pallas L-BFGS, {calc.n_atoms} atoms: E "
        f"{e0:.8f} -> {ro['energy']:.8f} Ha in {ro['cycles']} cycles, "
        f"{ro['force_calls']} force calls, {wall:.2f} s wall "
        f"({wall / max(ro['force_calls'], 1) * 1e3:.1f} ms per force "
        f"call); K5 launches on the path {launches}")
    if not (np.isfinite(ro["energy"]) and ro["energy"] < e0):
        fail("pallas opt did not lower the energy")
    if not os.path.exists(final):
        fail("pallas opt wrote no final_geometry.xyz")
    never = [k for k, v in launches.items() if v == 0]
    if never:
        fail(f"K5 kernels never launched on the pallas path: {never}")

    # the dense mode of the same weights, timed and its peak memory read
    # the same way, with the pallas calculator freed first
    n_atoms = calc.n_atoms
    del calc, ro
    torch.cuda.empty_cache()
    dense = pallas_calculator(st, dataclasses.replace(cfg, mp_mode="dense"),
                              w)
    torch.cuda.reset_peak_memory_stats()
    rd = dense.get_forces(cb)                # first call (warm-up)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        rd = dense.get_forces(cb)
    torch.cuda.synchronize()
    ms_d = (time.perf_counter() - t0) / reps * 1e3
    peak_d = torch.cuda.max_memory_allocated() / 2 ** 30
    err = float(np.abs(f - rd["forces"]).max() / np.abs(rd["forces"]).max())
    log(f"[dense] uma-s-1p1 dense, {n_atoms} atoms, same weights: "
        f"{ms_d:.1f} ms per get_forces over {reps} calls, peak memory "
        f"{peak_d:.2f} GiB (pallas: {ms:.1f} ms, {peak:.2f} GiB)")
    log(f"[pallas-vs-dense] {n_atoms} atoms on the card, same weights:"
        f" max|dF|/max|F| = {err:.3e} (tol {FORCE_TOL}), |dE| = "
        f"{abs(res['energy'] - rd['energy']):.3e} Ha")
    if not err <= FORCE_TOL:
        fail("pallas-mode forces disagree with the dense mode")
    del dense
    torch.cuda.empty_cache()
    return launches, (res["energy"], f)


def phase_default(st, reps):
    """make_uma_calculator with no model: uma-s-1p1, dense."""
    import torch
    from pdb2reaction_tpu_torch.mlip.model import CONFIGS
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    calc = make_uma_calculator(st, device="cuda")
    if calc.cfg != CONFIGS["uma-s-1p1"]:
        fail(f"the default model is not uma-s-1p1 (dense): {calc.cfg}")
    cb = st.coords_bohr.reshape(-1)
    res = calc.get_forces(cb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = calc.get_forces(cb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    if not np.all(np.isfinite(res["forces"])):
        fail("default-path forces are not finite")
    log(f"[default] make_uma_calculator() -> uma-s-1p1 dense, "
        f"{calc.n_atoms} atoms (P={calc.n_pad}): {ms:.2f} ms per "
        f"get_forces over {reps} calls")


def phase_reference_painn(seed):
    """uma-s-1p1 pallas mode on the card against the CPU float64 dense
    plain path, same weights."""
    import dataclasses

    import torch
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.model import CONFIGS, init_params
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    zs, xyz = cluster(64, seed=1)
    st = Structure(zs, xyz)
    cfg = dataclasses.replace(CONFIGS["uma-s-1p1"], mp_mode="pallas")
    w = init_params(cfg, seed=seed)
    w["charge"], w["spin"] = torch.tensor(0.0), torch.tensor(1.0)
    gpu = pallas_calculator(st, cfg, w)
    cpu = make_uma_calculator(st, model="uma-s-1p1", device="cpu",
                              dtype=torch.float64, params=w)
    cb = st.coords_bohr.reshape(-1)
    rc, rg = cpu.get_forces(cb), gpu.get_forces(cb)
    err = float(np.abs(rg["forces"] - rc["forces"]).max()
                / np.abs(rc["forces"]).max())
    log(f"[reference] 64 atoms uma-s-1p1: card pallas f32 kernels vs CPU "
        f"f64 dense plain path: max|dF|/max|F| = {err:.3e} (tol "
        f"{FORCE_TOL}), |dE| = {abs(rg['energy'] - rc['energy']):.3e} Ha")
    if not err <= FORCE_TOL:
        fail("pallas-mode card forces disagree with the CPU float64 path")


# ---------------------------------------------------------------------------
# atom-axis sharding: K6 and the sharded path
# ---------------------------------------------------------------------------

K6_NAMES = ("radial_contract_rect_fwd", "radial_contract_rect_bwd_feats",
            "radial_contract_rect_bwd_coords")


def k6_pairs(x, mask, cutoff, off, n):
    """Ordered pairs (row i of the block off .. off + n - 1, any column j
    != i, both atoms real) inside the cutoff: the pairs whose adjacency in
    the block is not zero."""
    import torch
    d = torch.sqrt(torch.clamp(
        ((x[off:off + n, None, :] - x[None, :, :]) ** 2).sum(-1), min=1e-12))
    real = mask > 0
    within = (d <= cutoff) & real[off:off + n, None] & real[None, :]
    idx = torch.arange(n, device=x.device)
    within[idx, off + idx] = False
    return int(within.sum())


def k6_plan_stats(rcm, x, mask, off, Pr, rc, R1, F):
    """The rect tile plan of rows off .. off + Pr - 1 against all columns:
    (plan, its statistics with the build time in ms)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = rcm.rect_tile_plan(x[off:off + Pr], mask[off:off + Pr], off, x,
                              mask, rc)
    torch.cuda.synchronize()
    st = plan.stats(R1, F)
    st["ms"] = (time.perf_counter() - t0) * 1e3
    return plan, st


def k6_plan_stages(rcm, x, mask, Pr, rc, reps=5):
    """The rect tile plan's build timed stage by stage (host clock, the
    card synchronised around each stage), at each row block of the
    system; one log line, the mean over the blocks and ``reps`` builds."""
    import torch
    tot = {}
    for _ in range(reps):
        for off in range(0, x.shape[0], Pr):
            st = {}
            rcm.rect_tile_plan(x[off:off + Pr], mask[off:off + Pr], off, x,
                               mask, rc, stages=st)
            for k, v in st.items():
                tot[k] = tot.get(k, 0.0) + v
    torch.cuda.synchronize()
    n = reps * (x.shape[0] // Pr)
    log(f"[K6-plan-stages] rect plan of a {Pr}-row block, ms (mean of {n} "
        f"builds): " + ", ".join(f"{k} {v / n:.2f}" for k, v in tot.items())
        + f"; sum {sum(tot.values()) / n:.2f}")


def phase_k6(calc, quick):
    """K6 forward / feats gradient / fused row and column coordinate
    gradients against the plain version at the sharded path's shapes, for
    both streams at every offset; the rect plans' statistics; the four
    forward blocks stacked against K5's kernel output; the coordinate
    kernel's CUDA-core route at R + 1 = 33."""
    import torch
    from pdb2reaction_tpu_torch.mlip import radial_contract as rcm
    reps = 1 if quick else 3
    cfg = calc.cfg
    rc, R = cfg.cutoff, cfg.n_radial
    x, mask, featsA, featsB = k5_streams(calc)
    P, F = featsA.shape
    Pr = P // RANKS
    gen = torch.Generator(device="cuda").manual_seed(3)
    g = torch.randn(Pr, R + 1, F, generator=gen, device="cuda")
    got = {k: [] for k in K6_NAMES}        # (abs err, ms, plain ms)
    fns = (rcm.radial_contract_rect, rcm.radial_contract_rect_plain)
    plans = {off: k6_plan_stats(rcm, x, mask, off, Pr, rc, R + 1, F)
             for off in range(0, P, Pr)}
    for label, feats, div_d in (("A", featsA, False), ("B", featsB, True)):
        with torch.no_grad():
            T_sq = rcm.radial_contract(x, mask, feats, rc, R, div_d)
        blocks = []
        for off in range(0, P, Pr):
            rows = slice(off, off + Pr)
            outs = []
            for fn in fns:
                cr = x[rows].clone().requires_grad_(True)
                cc = x.clone().requires_grad_(True)
                f = feats.clone().requires_grad_(True)
                T = fn(cr, mask[rows], off, cc, mask, f, rc, R, div_d)
                outs.append((T.detach(),
                             *torch.autograd.grad(T, [f, cr, cc], g)))
                del T
            torch.cuda.synchronize()
            errs = [(abs_err(a, b), rel_err(a, b)) for a, b in zip(*outs)]
            blocks.append(outs[0][0])
            del outs
            log(f"[K6] stream {label} (div_d={div_d}), rows {off}..."
                f"{off + Pr - 1} of {P}: rel err fwd {errs[0][1]:.3e}, "
                f"feats {errs[1][1]:.3e}, rows {errs[2][1]:.3e}, cols "
                f"{errs[3][1]:.3e} (the rows and columns from one launch; "
                f"tol {KERNEL_TOL})")
            if max(e[1] for e in errs) > KERNEL_TOL:
                fail(f"K6 stream {label} at offset {off} disagrees with its "
                     "plain version")
            args = (x[rows], mask[rows], off, x, mask, feats, rc, R, div_d)
            plan = plans[off][0]
            # the forward with the block's plan given (as the sharded path
            # calls it) and with the plan it builds itself
            with torch.no_grad():
                t = [cuda_ms(lambda: fns[0](*args, plan=plan), reps, warm=1),
                     cuda_ms(lambda: fns[1](*args), reps, warm=1)]
                t_own = cuda_ms(lambda: fns[0](*args), reps, warm=1)
            # feats; then both coordinate gradients, the kernel on the
            # block's plan
            for leaves in ((5,), (0, 3)):
                for fn, kw in ((fns[0], {"plan": plan}), (fns[1], {})):
                    a = list(args)
                    for at in leaves:
                        a[at] = a[at].clone().requires_grad_(True)
                    T = fn(*a, **kw)
                    t.append(cuda_ms(lambda: torch.autograd.grad(
                        T, [a[at] for at in leaves], g, retain_graph=True),
                        reps, warm=1))
                    del T
            errs[2] = max(errs[2], errs[3])
            for i, k in enumerate(K6_NAMES):
                got[k].append((errs[i][0], t[2 * i], t[2 * i + 1]))
            log(f"[K6] stream {label}, rows {off}...: kernel / plain ms fwd "
                f"{t[0]:.2f} / {t[1]:.2f} (the call building its own plan "
                f"{t_own:.2f}), feats {t[2]:.2f} / {t[3]:.2f}, rows and cols "
                f"{t[4]:.2f} / {t[5]:.2f} (one launch); the kernels on the "
                "block's plan")
        stacked = torch.cat(blocks)
        e_sq = rel_err(stacked, T_sq)
        log(f"[K6] stream {label}: the four forward blocks stacked against "
            f"K5's kernel output: rel err {e_sq:.3e} (tol 1e-5)")
        if not e_sq <= 1e-5:
            fail(f"K6 blocks of stream {label} disagree with K5")
        del blocks, stacked, T_sq
    pairs = [k6_pairs(x, mask, rc, off, Pr) for off in range(0, P, Pr)]
    need = 2 * (sum(pairs) / len(pairs)) * (R + 1) * F
    log(f"[K6] ordered pairs inside {rc} A with one atom in the block, per "
        f"block: {pairs} (mean {sum(pairs) / len(pairs):.0f} of "
        f"{Pr * (P - 1)})")
    sh = torch.randperm(P, generator=torch.Generator().manual_seed(4)).cuda()
    shuffled = k6_plan_stats(rcm, x[sh], mask[sh], 0, Pr, rc, R + 1, F)[1]
    for label, st in [*((f"rows {o}...", v[1]) for o, v in plans.items()),
                      ("shuffled system, rows 0...", shuffled)]:
        log(f"[K6-plan] {label}: {st['row_tiles']} x {st['col_tiles']} "
            f"tiles, {st['listed']} listed tile pairs "
            f"({100 * st['share']:.2f}%), each kernel computes "
            f"{st['flop'] / 1e9:.2f} GFLOP against {need / 1e9:.2f} "
            f"needed; plan built in {st['ms']:.2f} ms")
    k6_plan_stages(rcm, x, mask, Pr, rc)
    computed = sum(v[1]["flop"] for v in plans.values()) / RANKS
    geo = 16 * (Pr + P)                     # rows and columns: xyz + mask
    f_b, t_b = nbytes(featsA), nbytes(g)
    byts = (geo + f_b + t_b, geo + t_b + f_b, geo + f_b + t_b + 12 * (Pr + P))
    rows = {}
    for k, nb in zip(K6_NAMES, byts):
        v = got[k]
        rows[k] = (max(e for e, _, _ in v), sum(t for _, t, _ in v) / len(v),
                   sum(tp for _, _, tp in v) / len(v), need, nb)
        b32, bbf, by = bound_ms(need, nb, k)
        log(f"[kernel] {k}: {rows[k][1]:.3f} ms (plain {rows[k][2]:.3f} ms;"
            f" mean of 4 offsets x streams A and B, the block's plan "
            f"given), needed {need / 1e9:.2f} GFLOP (pairs inside the "
            f"cutoff), computed {computed / 1e9:.1f} GFLOP (listed tile "
            f"pairs), {nb / 1e6:.1f} MB, bound at f32 accuracy {b32:.3f} "
            f"ms (3xTF32, {by}) / bf16 {bbf:.3f} ms; computed at "
            f"{computed / rows[k][1] / 1e9:.2f} TFLOP/s")
    log(f"[K6] forward and feats gradient on the rect plan: "
        f"{rows['radial_contract_rect_fwd'][1]:.3f} and "
        f"{rows['radial_contract_rect_bwd_feats'][1]:.3f} ms a launch; the "
        "every-pair kernels they replace took 8.37 / 8.32 and 7.23 / 7.19 "
        "ms a launch (PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W)")
    del g
    phase_k6_r33(rcm, x, mask, Pr)
    return rows


def phase_k6_r33(rcm, x, mask, Pr):
    """K6's three kernels on their CUDA-core routes (R + 1 = 33, the
    uma-m-1p1 radial width) against the plain version, one row block of
    the 4096-atom system at a narrow F: errors and times (the kernels on
    the block's plan), one log line."""
    import torch
    from pdb2reaction_tpu_torch.mlip.model import CONFIGS
    cfg = CONFIGS["uma-m-1p1"]
    rc, R, F, off = cfg.cutoff, cfg.n_radial, 64, Pr
    gen = torch.Generator(device="cuda").manual_seed(6)
    feats = torch.randn(x.shape[0], F, generator=gen, device="cuda")
    g = torch.randn(Pr, R + 1, F, generator=gen, device="cuda")
    rows = slice(off, off + Pr)
    plan = rcm.rect_tile_plan(x[rows], mask[rows], off, x, mask, rc)
    outs, t = [], []
    for fn, kw in ((rcm.radial_contract_rect, {"plan": plan}),
                   (rcm.radial_contract_rect_plain, {})):
        cr = x[rows].clone().requires_grad_(True)
        cc = x.clone().requires_grad_(True)
        f = feats.clone().requires_grad_(True)
        T = fn(cr, mask[rows], off, cc, mask, f, rc, R, **kw)
        outs.append((T.detach(),
                     *torch.autograd.grad(T, [f, cr, cc], g,
                                          retain_graph=True)))
        with torch.no_grad():
            t.append(cuda_ms(lambda: fn(x[rows], mask[rows], off, x, mask,
                                        feats, rc, R, **kw), 2, warm=1))
        for leaves in ([f], [cr, cc]):
            t.append(cuda_ms(lambda: torch.autograd.grad(
                T, leaves, g, retain_graph=True), 2, warm=1))
        del T
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(*outs)]
    log(f"[K6-R33] uma-m-1p1 radial width (rows {off}... of {x.shape[0]}, "
        f"F={F}, R+1={R + 1}, CUDA cores, the block's plan given): kernel / "
        f"plain ms fwd {t[0]:.2f} / {t[3]:.2f}, feats {t[1]:.2f} / "
        f"{t[4]:.2f}, both coordinate gradients {t[2]:.2f} / {t[5]:.2f}; "
        f"rel err fwd {errs[0]:.3e}, feats {errs[1]:.3e}, rows "
        f"{errs[2]:.3e}, cols {errs[3]:.3e} (tol {KERNEL_TOL})")
    if max(errs) > KERNEL_TOL:
        fail("K6 at R+1 = 33 disagrees with the plain version")


def spatial_rank(group, out_dir):
    """This rank's part of the sharded phase; returns its numbers and
    writes its forces."""
    import dataclasses

    import torch
    from pdb2reaction_tpu_torch.core.io_xyz import write_xyz
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip import radial_contract as rcm
    from pdb2reaction_tpu_torch.mlip.model import CONFIGS, make_model
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    from pdb2reaction_tpu_torch.workflows.opt import run_opt
    zs4, xyz4 = cluster(4096, seed=0)
    st4 = Structure(zs4, xyz4)
    _, w4, _ = make_model(dataclasses.replace(CONFIGS["uma-s-1p1"],
                                              mp_mode="pallas"), seed=0)
    calc = make_uma_calculator(st4, model="uma-s-1p1", mp_mode="pallas",
                               spatial=RANKS, params=w4,
                               weights_source="surrogate-seeded")
    cb = st4.coords_bohr.reshape(-1)
    for d in (rcm.launches, rcm.rect_launches):   # just before the path
        for k in d:
            d[k] = 0
    torch.cuda.reset_peak_memory_stats()
    res = calc.get_forces(cb)                # first call (warm-up)
    torch.cuda.synchronize()
    n_plans = rcm.plans["rect_built"]
    t0 = time.perf_counter()
    for _ in range(2):
        res = calc.get_forces(cb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 2 * 1e3
    plans_per_call = (rcm.plans["rect_built"] - n_plans) / 2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_call = {k: v / calc.force_calls
                for k, v in {**rcm.rect_launches, **rcm.launches}.items()}
    again = calc.get_forces(cb)["forces"]
    # the collectives of one force call alone, as the model calls them:
    # 8 all-gathers of this rank's [P/4, 4C] stream, 7 of them also
    # backward (the reduce-scatter built from an all-gather)
    t = torch.randn(calc.n_pad // RANKS, 4 * CONFIGS["uma-s-1p1"].hidden,
                    device=group.device, requires_grad=True)
    g = torch.randn(calc.n_pad, t.shape[1], device=group.device)
    for timed in (False, True):              # a warm-up round first
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        group.all_gather_rows(t.detach())
        for _ in range(7):
            torch.autograd.grad(group.all_gather_rows(t), [t], g)
        torch.cuda.synchronize()
    comm_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(out_dir, "cluster4096.xyz")
    if group.rank == 0:
        write_xyz(path, st4)
    torch.distributed.barrier()
    t0 = time.perf_counter()
    ro = run_opt(path, charge=0, spin=1, model="uma-s-1p1", calc=calc,
                 max_cycles=5, out_dir=os.path.join(out_dir, "opt"),
                 verbose=False)
    opt_wall = time.perf_counter() - t0
    launches = {**rcm.rect_launches, **rcm.launches}   # just after
    np.save(os.path.join(out_dir, f"forces{group.rank}.npy"), res["forces"])
    del calc
    torch.cuda.empty_cache()

    # the factory default in the same group: uma-s-1p1 (dense), switched
    # to the sharded gather layout, against the unsharded gather mode
    zs, xyz = cluster(300, seed=0)
    st = Structure(zs, xyz)
    c1 = make_uma_calculator(st, spatial=RANKS)
    c0 = make_uma_calculator(st, mp_mode="gather")
    cb3 = st.coords_bohr.reshape(-1)
    r1, r0 = c1.get_forces(cb3), c0.get_forces(cb3)
    err_g = float(np.abs(r1["forces"] - r0["forces"]).max()
                  / np.abs(r0["forces"]).max())
    err_ge = abs(r1["energy"] - r0["energy"]) / abs(r0["energy"])
    factory = [c1.cfg.mp_mode, c1.n_pad, err_g,
               abs(r1["energy"] - r0["energy"]), err_ge]
    del c0, c1
    torch.cuda.empty_cache()
    escn = spatial_escn(group, out_dir)
    return {"escn": escn, "rank": group.rank, "device": str(group.device),
            "backend": group.backend, "energy": res["energy"], "ms": ms,
            "comm_ms": comm_ms,
            "peak_gib": peak, "per_call": per_call,
            "plans_per_call": plans_per_call,
            "repeat": bool(np.array_equal(again, res["forces"])),
            "opt": [ro["energy"], ro["force_calls"],
                                      ro["cycles"], opt_wall,
                                      [str(q) for q in ro["outputs"]]],
            "launches": launches, "e0": res["energy"],
            "factory": factory}


# the sharded eSCN cases of phase 11: (tag, model, atoms, padding multiple)
SHARD_ESCN = (("escn-md 300", "escn-md", 300, 64),
              ("escn-md 4096", "escn-md", 4096, 8),
              ("escn-md-gate 300", "escn-md-gate", 300, 64))
# launches per rank and force call on the sharded eSCN paths: K3 (the
# default pallas-mega under a shard) and K2 four layers each; the gate's
# edge path is plain
SHARD_ESCN_WANT = {
    "escn-md": {"fused_edge_block_fwd": 4, "fused_edge_block_bwd": 4,
                "fused_node_ffn_fwd": 4, "fused_node_ffn_bwd": 4},
    "escn-md-gate": {"fused_node_ffn_fwd": 4, "fused_node_ffn_bwd": 4},
}


class RankView:
    """Rank ``rank`` of RANKS in one process, for a kernel check at the
    sharded path's shapes: the coordinates come in replicated already,
    and the all-gather of the first layer's normalised features returns
    ``rows`` [P, M*C], the unsharded call's (this rank's own slab held
    to them)."""
    size = RANKS

    def __init__(self, rank, rows):
        self.rank, self.rows = rank, rows

    @staticmethod
    def replicate_in(x):
        return x

    def all_gather_rows(self, t):
        n = t.shape[0]
        mine = self.rows[self.rank * n:(self.rank + 1) * n]
        if rel_err(t.reshape(n, -1), mine) > KERNEL_TOL:
            fail("a rank's first-layer rows differ from the unsharded "
                 "call's")
        return self.rows.reshape((-1,) + tuple(t.shape[1:]))


def k3_gathered(cfg, rows, src, live, xt_t, es, Dp, Dpe, w, tabs):
    """K3 as the sharded path calls it: source rows gathered from the
    rows of all ranks by ``gather_src`` (its backward is the
    deterministic source scatter over all P rows)."""
    from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
    return ek.fused_edge_block(cfg, ek.gather_src(rows, src, live).T, xt_t,
                               es, Dp, Dpe, w, tabs)


def k3_gathered_plain(cfg, rows, src, live, xt_t, es, Dp, Dpe, w, tabs):
    """Plain version of ``k3_gathered``: ``rows[src]`` and plain K3."""
    from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
    return ek.fused_edge_block_plain(cfg, rows[src].T, xt_t, es, Dp, Dpe,
                                     w, tabs)


def shard_k3_parity(tag, calc):
    """K3 against its plain version on rank 0's first-layer inputs of
    the sharded path (P/RANKS x K edges, sources gathered from all P
    rows), built from the unsharded calculator ``calc``: values and the
    cotangents of the rows, targets, edge scalars and rotations. Returns
    (abs err fwd, abs err bwd)."""
    import dataclasses

    import torch
    from pdb2reaction_tpu_torch.mlip.escn import first_layer_kernel_args
    c = calc._to_pad_ang(calc.structure.coords_bohr)
    cfg = dataclasses.replace(calc.cfg, edge_kernel="pallas-mega")
    with torch.no_grad():
        _, _, (rows, _, _) = first_layer_kernel_args(c, calc.system,
                                                     calc.params, cfg)
        args, _, (rows, src, live) = first_layer_kernel_args(
            c, calc.system, calc.params, cfg, shard=RankView(0, rows))
    _, xs_t, xt_t, es, Dp, Dpe, w, tabs = args
    gen = torch.Generator(device=c.device).manual_seed(0)
    res = edge_parity(f"K3-shard {tag}", k3_gathered, k3_gathered_plain,
                      (cfg, rows, src, live, xt_t, es, Dp, Dpe, w, tabs),
                      (1, 4, 5, 6, 7), ("rows", "xt", "es", "Dp", "Dpe"),
                      3, gen)
    log(f"[K3-shard] {tag} atoms, rank 0 of {RANKS}: {xs_t.shape[1]} edges "
        f"over {rows.shape[0]} source rows; abs err fwd {res[0]:.3e}, bwd "
        f"{res[1]:.3e}; gather + K3 {res[2]:.3f} ms (plain {res[3]:.3f} "
        f"ms), backward {res[4]:.3f} ms (plain {res[5]:.3f} ms)")
    return res[0], res[1]


def shard_escn_refs(out):
    """The unsharded "pallas-full" call of each sharded eSCN case, made
    in the parent before the ranks start; its energy and forces go to
    ``out``. For escn-md, K3 at rank 0's sharded shapes against its
    plain version (``shard_k3_parity``) too; returns (the references,
    K3's largest abs errors fwd and bwd there)."""
    import torch
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    refs = {}
    k3_err = [0.0, 0.0]
    for tag, model, n, pad in SHARD_ESCN:
        st = Structure(*cluster(n, seed=0))
        calc = make_uma_calculator(st, model=model, device="cuda",
                                   params=p19_weights(model),
                                   pad_multiple=pad, edge_kernel="pallas-full",
                                   weights_source="surrogate-seeded")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = calc.get_forces(st.coords_bohr.reshape(-1))
        torch.cuda.synchronize()
        refs[tag] = (r["energy"], r["forces"],
                     (time.perf_counter() - t0) * 1e3,
                     torch.cuda.max_memory_allocated() / 2 ** 30)
        np.save(os.path.join(out, f"ref {tag}.npy"), r["forces"])
        if model == "escn-md":
            k3_err = [max(a, b) for a, b in zip(k3_err,
                                                shard_k3_parity(tag, calc))]
        del calc
        torch.cuda.empty_cache()
    return refs, k3_err


def spatial_escn(group, out_dir):
    """This rank's eSCN part of the sharded phase: each SHARD_ESCN case
    sharded over the group (ms per call, peak memory, launches per call,
    a repeat), the collectives of one escn-md call alone, and a 5-cycle
    opt of escn-md at 300 atoms."""
    import torch
    from pdb2reaction_tpu_torch.core.io_xyz import write_xyz
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    from pdb2reaction_tpu_torch.workflows.opt import run_opt
    out = {}
    for tag, model, n, pad in SHARD_ESCN:
        st = Structure(*cluster(n, seed=0))
        calc = make_uma_calculator(st, model=model, spatial=RANKS,
                                   params=p19_weights(model),
                                   pad_multiple=pad,
                                   weights_source="surrogate-seeded")
        cb = st.coords_bohr.reshape(-1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_escn_counts()                   # just before the path
        calc.force_calls = 0
        res = calc.get_forces(cb)            # first call (warm-up)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            res = calc.get_forces(cb)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 2 * 1e3
        again = calc.get_forces(cb)["forces"]
        launches = escn_counts()             # just after
        np.save(os.path.join(out_dir, f"{tag} {group.rank}.npy"),
                res["forces"])
        out[tag] = {"energy": res["energy"], "ms": ms,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "repeat": bool(np.array_equal(again, res["forces"])),
                    "per_call": {k: v / calc.force_calls
                                 for k, v in launches.items() if v},
                    "launches": launches, "n_pad": calc.n_pad}
        if tag == "escn-md 4096":
            # the collectives of one call alone, as the model calls them:
            # 4 all-gathers of this rank's [P/4, M*C] rows, each also
            # backward (the reduce-scatter built from an all-gather)
            M = (calc.cfg.lmax + 1) ** 2
            t = torch.randn(calc.n_pad // RANKS,
                            M * calc.cfg.sphere_channels,
                            device=group.device, requires_grad=True)
            g = torch.randn(calc.n_pad, t.shape[1], device=group.device)
            for _ in range(2):               # a warm-up round first
                torch.distributed.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(4):
                    torch.autograd.grad(group.all_gather_rows(t), [t], g)
                torch.cuda.synchronize()
            out["comm_ms"] = (time.perf_counter() - t0) * 1e3
        del calc
        torch.cuda.empty_cache()
    # a 5-cycle sharded opt of escn-md at 300 atoms: every rank the same
    # loop, rank 0 alone writes
    st = Structure(*cluster(300, seed=0))
    calc = make_uma_calculator(st, model="escn-md", spatial=RANKS,
                               params=p19_weights("escn-md"),
                               pad_multiple=64,
                               weights_source="surrogate-seeded")
    path = os.path.join(out_dir, "cluster300.xyz")
    if group.rank == 0:
        write_xyz(path, st)
    torch.distributed.barrier()
    e0 = calc.get_energy(st.coords_bohr)["energy"]
    calc.force_calls = calc.energy_calls = 0
    zero_escn_counts()                       # just before the opt
    t0 = time.perf_counter()
    ro = run_opt(path, charge=0, spin=1, model="escn-md", calc=calc,
                 max_cycles=5, out_dir=os.path.join(out_dir, "escn_opt"),
                 verbose=False)
    out["opt"] = [e0, ro["energy"], calc.force_calls, ro["cycles"],
                  time.perf_counter() - t0,
                  [str(q) for q in ro["outputs"]], escn_counts(),
                  calc.energy_calls]
    return out


def spatial_worker(rank, port, out_dir):
    """One rank of the sharded phase (started with "spawn"); an exception
    goes to rank<r>.err and a non-zero exit code."""
    import traceback
    try:
        sys.path.insert(0, HERE)
        from pdb2reaction_tpu_torch.parallel import init_spatial, shutdown
        group = init_spatial(RANKS, rank, device="cuda",
                             init_method=f"tcp://127.0.0.1:{port}",
                             timeout_s=300)
        out = spatial_rank(group, out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        shutdown()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def phase_spatial(ref, k6_ms, rows):
    """Four ranks of the sharded path on the card; any rank that fails
    fails the run. ``k6_ms``: K6's ms per launch from phase 10, alone on
    the card. K3's rows in ``rows`` take the larger error of phase 3's
    check and the check at the sharded shapes. Returns the K6 launches
    on the path and the K3 and K2 launches of its eSCN part, over all
    ranks."""
    import shutil
    import socket

    import torch
    import torch.multiprocessing as mp
    e_ref, f_ref = ref
    out = os.path.join(HERE, "result_smoke", "spatial")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    escn_refs, k3_err = shard_escn_refs(out)
    for k, e in zip(("fused_edge_block_fwd", "fused_edge_block_bwd"),
                    k3_err):
        rows[k] = (max(rows[k][0], e),) + tuple(rows[k][1:])
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=spatial_worker, args=(r, port, out))
             for r in range(RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = t0 + 600
    for p in procs:
        p.join(timeout=max(deadline - time.perf_counter(), 1))
    wall = time.perf_counter() - t0
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = [open(os.path.join(out, f)).read() for f in sorted(os.listdir(out))
            if f.endswith(".err")]
    if errs or any(p.exitcode != 0 for p in procs):
        fail(f"sharded phase: exit codes {[p.exitcode for p in procs]}; "
             + "\n".join(errs))
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json")))
             for r in range(RANKS)]
    forces = [np.load(os.path.join(out, f"forces{r}.npy"))
              for r in range(RANKS)]
    err = float(np.abs(forces[0] - f_ref).max() / np.abs(f_ref).max())
    de = abs(ranks[0]["energy"] - e_ref)
    err_e = de / abs(e_ref)
    same = all(np.array_equal(forces[0], f) for f in forces) \
        and len({r["energy"] for r in ranks}) == 1
    log(f"[spatial] uma-s-1p1 pallas, 4096 atoms, {RANKS} ranks on one card "
        f"({ranks[0]['backend']} collectives staged through host memory, "
        f"{ranks[0]['device']}), {wall:.1f} s for the phase: against the "
        f"unsharded pallas call max|dF|/max|F| = {err:.3e} (tol "
        f"{SHARD_TOL}), |dE| = {de:.3e} Ha, |dE|/|E| = {err_e:.3e} (tol "
        f"{SHARD_TOL}); forces bit for bit equal on all "
        f"ranks: {same}; two calls bit for bit equal on every rank: "
        f"{all(r['repeat'] for r in ranks)}")
    for r in ranks:
        log(f"[spatial] rank {r['rank']}: {r['ms']:.1f} ms per get_forces "
            f"(four ranks time-sharing one card), peak memory "
            f"{r['peak_gib']:.2f} GiB, the collectives of one call alone "
            f"{r['comm_ms']:.1f} ms; launches per force call "
            f"{r['per_call']}, rect tile plans per call "
            f"{r['plans_per_call']}")
    # the four contexts time-slice the card, so a rank's kernel spans
    # overlap the others': the card work is counted from phase 10's times
    work = RANKS * sum(ranks[0]["per_call"][k] * k6_ms[k] for k in K6_NAMES)
    log(f"[spatial] K6 work of the {RANKS} ranks at the kernels' times alone "
        f"on the card: {work:.1f} ms per force call, "
        f"{100 * work / ranks[0]['ms']:.1f}% of the {ranks[0]['ms']:.1f} ms "
        "wall time per call; the rest is the host-staged gathers, "
        "context switching between the ranks and the glue")
    if not (err <= SHARD_TOL and err_e <= SHARD_TOL and same
            and all(r["repeat"] for r in ranks)):
        fail("the sharded force call (energy or forces) disagrees with the "
             "unsharded one, between ranks or between calls")
    want = dict(zip(K6_NAMES, (8, 7, 8)))
    for r in ranks:
        pc = r["per_call"]
        if any(pc[k] != v for k, v in want.items()) or any(
                pc[k] != 0 for k in pc if k not in want) \
                or r["plans_per_call"] != 1:
            fail(f"rank {r['rank']}: launches per force call {pc} and "
                 f"{r['plans_per_call']} rect tile plans, want {want}, no "
                 "K5 launch and one plan")
    opts = [r["opt"] for r in ranks]
    log(f"[spatial-opt] 5-cycle L-BFGS on every rank: E {ranks[0]['e0']:.8f}"
        f" -> {opts[0][0]:.8f} Ha in {opts[0][2]} cycles, force calls per "
        f"rank {[o[1] for o in opts]}, {opts[0][3]:.2f} s wall on rank 0; "
        f"written by rank 0 alone: {[o[4] for o in opts]}")
    if len({(o[0], o[1], o[2]) for o in opts}) != 1 \
            or not opts[0][0] < ranks[0]["e0"] or not opts[0][4] \
            or any(o[4] for o in opts[1:]):
        fail("the sharded opt differs between ranks, did not lower the "
             "energy, or was written by another rank than 0")
    fac = [r["factory"] for r in ranks]
    log(f"[spatial-default] make_uma_calculator(st, spatial={RANKS}) on "
        f"300 atoms: mode {fac[0][0]}, P = {fac[0][1]}; against the "
        f"unsharded gather mode max|dF|/max|F| = "
        f"{max(f[2] for f in fac):.3e} (tol {SHARD_TOL}), |dE| = "
        f"{max(f[3] for f in fac):.3e} Ha, |dE|/|E| = "
        f"{max(f[4] for f in fac):.3e} (tol {SHARD_TOL})")
    if fac[0][0] != "gather" or max(max(f[2], f[4]) for f in fac) > SHARD_TOL:
        fail("the sharded factory default (energy or forces) disagrees with "
             "the unsharded gather mode")
    never = [k for k in K6_NAMES if any(r["launches"][k] == 0
                                        for r in ranks)]
    if never:
        fail(f"K6 kernels never launched on the sharded path: {never}")
    total = {k: sum(r["launches"][k] for r in ranks) for k in K6_NAMES}
    for k, v in spatial_escn_checks(out, [r["escn"] for r in ranks],
                                    escn_refs).items():
        total[k] = total.get(k, 0) + v
    return total


def spatial_escn_checks(out, ranks, refs):
    """The sharded eSCN cases of every rank against the parent's
    unsharded pallas-full calls; returns their launches over all
    ranks."""
    total = {}
    for tag, model, n, _ in SHARD_ESCN:
        e_ref, f_ref, ms_ref, peak_ref = refs[tag]
        forces = [np.load(os.path.join(out, f"{tag} {r}.npy"))
                  for r in range(RANKS)]
        err = float(np.abs(forces[0] - f_ref).max() / np.abs(f_ref).max())
        err_e = abs(ranks[0][tag]["energy"] - e_ref) / abs(e_ref)
        same = all(np.array_equal(forces[0], f) for f in forces) \
            and len({r[tag]["energy"] for r in ranks}) == 1
        repeat = all(r[tag]["repeat"] for r in ranks)
        log(f"[spatial-escn] {tag} atoms, {RANKS} ranks on one card "
            f"(P = {ranks[0][tag]['n_pad']}, "
            f"{ranks[0][tag]['n_pad'] // RANKS} rows a rank): against the "
            f"unsharded pallas-full call ({ms_ref:.1f} ms with its first-call "
            f"set-up, peak {peak_ref:.2f} GiB) max|dF|/max|F| = {err:.3e}, "
            f"|dE|/|E| = {err_e:.3e} (tol {SHARD_TOL}); forces bit for bit "
            f"equal on all ranks: {same}; two calls bit for bit equal on "
            f"every rank: {repeat}")
        for i, r in enumerate(ranks):
            log(f"[spatial-escn] {tag} rank {i}: "
                f"{r[tag]['ms']:.1f} ms per get_forces (four ranks "
                f"time-sharing one card), peak memory "
                f"{r[tag]['peak_gib']:.2f} GiB; launches per force call "
                f"{r[tag]['per_call']}")
        if not (err <= SHARD_TOL and err_e <= SHARD_TOL and same and repeat):
            fail(f"sharded {tag}: energy or forces disagree with the "
                 "unsharded call, between ranks or between calls")
        want = SHARD_ESCN_WANT[model]
        bad = [r[tag]["per_call"] for r in ranks if r[tag]["per_call"] != want]
        if bad:
            fail(f"sharded {tag}: launches per force call {bad[0]}, want "
                 f"{want} (and no K1)")
        for r in ranks:
            for k, v in r[tag]["launches"].items():
                total[k] = total.get(k, 0) + v
    log(f"[spatial-escn] the collectives of one escn-md 4096-atom call "
        f"alone (4 all-gathers of [1024, 3200] rows and their backwards): "
        f"{[round(r['comm_ms'], 1) for r in ranks]} ms by rank")
    opts = [r["opt"] for r in ranks]
    o = opts[0]
    log(f"[spatial-escn-opt] escn-md 300 atoms, 5-cycle L-BFGS on every "
        f"rank: E {o[0]:.8f} -> {o[1]:.8f} Ha in {o[3]} cycles, force calls "
        f"per rank {[q[2] for q in opts]}, {o[4]:.2f} s wall on rank 0; "
        f"written by rank 0 alone: {[q[5] for q in opts]}; launches on "
        f"rank 0 {o[6]}")
    if len({(q[1], q[2], q[3]) for q in opts}) != 1 or not o[1] < o[0] \
            or not o[5] or any(q[5] for q in opts[1:]):
        fail("the sharded eSCN opt differs between ranks, did not lower the "
             "energy, or was written by another rank than 0")
    want = SHARD_ESCN_WANT["escn-md"]
    for q in opts:
        if not launch_identity(q[6], want, q[2], q[7]):
            fail(f"the sharded eSCN opt's launches {q[6]} for {q[2]} force "
                 f"and {q[7]} energy calls, want {want} a force call, "
                 "forwards also an energy call, and no K1")
        for k, v in q[6].items():
            total[k] = total.get(k, 0) + v
    return total


# ---------------------------------------------------------------------------
# phase 20: the data axis and the Hessian over ranks
# ---------------------------------------------------------------------------

P20_RANKS = 4
P20_FREQ_TOL = 0.1      # cm^-1: sharded against unsharded frequencies


def _np(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def p20_gsm(mesh, inp):
    """(a) / (e): phase 12's flagship string with its images over the data
    axis, its counts set to 0 just before the measured run and read just
    after."""
    import torch
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.engines.gsm import gsm_mep
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    calc = make_uma_calculator(Structure(*inp["st300"]), model="escn-md",
                               params=inp["params"], pad_multiple=64,
                               mesh=mesh, weights_source="phase 4")
    dev = calc.device
    xA = torch.as_tensor(inp["xA"], device=dev)
    xB = torch.as_tensor(inp["xB"], device=dev)
    eb = calc.au_energy_force_batch_fn()
    fm = calc.system.free_mask
    kw = dict(max_nodes=10, conv_perp_rms=GSM_CONV, climb=False)
    gsm_mep(eb, xA, xB, fm, max_cycles=2, stop_in_when_full=2, **kw)
    zero_escn_counts()
    n0 = calc.force_calls
    torch.distributed.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gsm_mep(eb, xA, xB, fm, max_cycles=60, stop_in_when_full=60, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"images": np.stack([_np(x) for x in res.images]),
            "energies": _np(res.energies), "cycles": res.cycles,
            "force_calls": res.force_calls,
            "calc_calls": calc.force_calls - n0, "wall": wall,
            "launches": {k: v for k, v in escn_counts().items() if v},
            "backend": mesh.data.backend, "device": str(dev)}


def p20_hessian(mesh, inp):
    """(b): the 64-atom analytic Hessian of phase 12 with its free-DOF
    tangents over the data axis."""
    import torch
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    st = Structure(*inp["st64"])
    cb = st.coords_bohr.reshape(-1)
    calc = make_uma_calculator(st, model="escn-md", params=inp["w64"],
                               freeze_atoms=[0, 1], mesh=mesh)
    calc.get_forces(cb)                       # warm-up of the force path
    zero_escn_counts()
    torch.distributed.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    H = calc.get_hessian(cb)["hessian"]
    torch.cuda.synchronize()
    return {"H": H, "wall": time.perf_counter() - t0,
            "launches": {k: v for k, v in escn_counts().items() if v}}


def p20_freq(mesh, inp, out_dir):
    """(c): run_freq on phase 15's TS guess with the calculator sharded
    over the model axis: its Hessian through the sharded plain closure,
    timed alone, and the launches outside it."""
    import torch
    from pdb2reaction_tpu_torch.core.io_xyz import read_xyz
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    from pdb2reaction_tpu_torch.workflows.freq import run_freq
    calc = make_uma_calculator(read_xyz(inp["gpath"]), model="escn-md",
                               params=inp["params"], pad_multiple=64,
                               freeze_atoms=inp["freeze"],
                               spatial=mesh.shape["model"],
                               weights_source="phase 4")
    analytic = calc._analytic_hessian
    inside = {}

    def timed(cb):
        before = escn_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        H = analytic(cb)
        torch.cuda.synchronize()
        inside["s"] = time.perf_counter() - t0
        inside["moved"] = {k: v - before[k] for k, v in escn_counts().items()
                           if v != before[k]}
        return H

    calc._analytic_hessian = timed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_escn_counts()
    t0 = time.perf_counter()
    r = run_freq(inp["gpath"], calculator=calc, charge=0, verbose=False,
                 out_dir=os.path.join(out_dir, "freq"))
    wall = time.perf_counter() - t0
    return {"H": r["hessian"], "freqs": r["freqs_cm"], "wall": wall,
            "hess_s": inside["s"], "inside": inside["moved"],
            "n_hvp": int(calc.free_dof_mask.sum()), "n_pad": calc.n_pad,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": {k: v for k, v in escn_counts().items() if v}}


def p20_worker(rank, world, port, out_dir, cases):
    """One rank of phase 20 (started with "spawn"): ``cases`` of (a) and
    (b) on a data axis of ``world`` ranks, (c) on a model axis of
    ``world`` ranks; an exception goes to rank<r>.err and a non-zero exit
    code."""
    import pickle
    import traceback
    try:
        sys.path.insert(0, HERE)
        import torch
        from pdb2reaction_tpu_torch.parallel import (initialize_distributed,
                                                     make_mesh, shutdown)
        initialize_distributed(f"127.0.0.1:{port}", world, rank,
                               device="cuda", timeout_s=300)
        inp = torch.load(os.path.join(out_dir, "in.pt"), weights_only=False,
                         map_location=f"cuda:{torch.cuda.current_device()}")
        out = {}
        if "a" in cases:
            out["a"] = p20_gsm(make_mesh(data=world), inp)
        if "b" in cases:
            out["b"] = p20_hessian(make_mesh(data=world), inp)
        if "c" in cases:
            out["c"] = p20_freq(make_mesh(model=world), inp, out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
        shutdown()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def p20_spawn(out, world, cases, limit):
    """``world`` ranks of ``p20_worker`` on the cases; their results in
    rank order and the wall time. Any rank that fails fails the run."""
    import pickle
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=p20_worker,
                         args=(r, world, port, out, cases))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=max(t0 + limit - time.perf_counter(), 1))
    wall = time.perf_counter() - t0
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = [open(os.path.join(out, f)).read() for f in sorted(os.listdir(out))
            if f.endswith(".err")]
    if errs or any(p.exitcode != 0 for p in procs):
        fail(f"phase 20 ({cases}): exit codes {[p.exitcode for p in procs]}; "
             + "\n".join(errs))
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            ranks.append(pickle.load(fh))
    return ranks, wall


def p20_gsm_checks(tag, ranks, p12, smi_line):
    """(a) / (e) against phase 12's single-process run: the same cycles
    and force calls, images and energies bit for bit, K1 and K2 launches
    summed over the ranks equal to phase 12's. Returns the sums and
    whether every rank matched phase 12 bit for bit."""
    res12, wall12, moved12 = p12["gsm"]
    img12 = np.stack([_np(x) for x in res12.images])
    e12 = _np(res12.energies)
    total = {}
    for r in ranks:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    bits = all(np.array_equal(r["images"], img12)
               and np.array_equal(r["energies"], e12) for r in ranks)
    same = all((r["cycles"], r["force_calls"], r["calc_calls"])
               == (res12.cycles, res12.force_calls, res12.force_calls)
               for r in ranks)
    dx = max(float(np.abs(r["images"] - img12).max()) for r in ranks)
    de = max(float(np.abs(r["energies"] - e12).max()) for r in ranks)
    walls = [r["wall"] for r in ranks]
    log(f"[ranks] {tag}: {smi_line}; {len(ranks)} data ranks "
        f"({ranks[0]['backend']}, {ranks[0]['device']} on rank 0): wall "
        f"{max(walls):.2f} s (ranks {[round(w, 2) for w in walls]}) against "
        f"phase 12's one process {wall12:.2f} s; {ranks[0]['cycles']} "
        f"cycles, {ranks[0]['force_calls']} force calls on every rank "
        f"(phase 12: {res12.cycles}, {res12.force_calls}); images and "
        f"energies bit for bit phase 12's: {bits} (max|dx| {dx:.3e} Bohr, "
        f"max|dE| {de:.3e} Ha); launches summed over the ranks {total} "
        f"(phase 12: {moved12})")
    if not same:
        fail(f"{tag}: cycles or force calls differ from phase 12's")
    if not bits:
        fail(f"{tag}: the string over the data axis is not phase 12's bit "
             "for bit")
    if total != moved12:
        fail(f"{tag}: K1/K2 launches summed over the ranks {total} != "
             f"phase 12's {moved12}")
    return total, bits


def p20_cli(p16, a_bits, smi_line):
    """(d): ``python -m torch.distributed.run --nproc-per-node 2 -m
    pdb2reaction_tpu_torch ... --workers 2`` at phase 16's CLI settings,
    against phase 16's single-process run: summary.yaml, the stages'
    force calls, one output tree and no scratch directory left."""
    import shutil
    import socket
    args, one_dir, one_out = p16
    out = os.path.join(HERE, "result_smoke", "ranks", "cli")
    shutil.rmtree(out, ignore_errors=True)
    tmp = os.path.join(out, "tmp")
    os.makedirs(tmp)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, TMPDIR=tmp, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    two_dir = os.path.join(out, "result_all")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           "2", "--master-addr", "127.0.0.1", "--master-port", str(port),
           "-m", "pdb2reaction_tpu_torch", *args, "--workers", "2",
           "--out-dir", two_dir]
    t0 = time.perf_counter()
    rr = subprocess.run(cmd, cwd=out, env=env, capture_output=True,
                        text=True, timeout=600)
    wall = time.perf_counter() - t0
    if rr.returncode != 0:
        fail(f"the all CLI under torch.distributed.run exited "
             f"{rr.returncode}: {rr.stderr[-3000:]}")

    def tree(d):
        return sorted(os.path.relpath(os.path.join(a, f), d)
                      for a, _, fs in os.walk(d) for f in fs)

    def report(text):
        lines = text.splitlines()
        at = [i for i, ln in enumerate(lines) if ln.startswith("phase ")]
        rows = []
        for ln in lines[at[0] + 1:] if at else []:
            tok = ln.split()
            if len(tok) < 5 or not tok[1].isdigit():
                break
            rows.append(tuple(tok[:3]))
        return rows

    with open(os.path.join(one_dir, "summary.yaml")) as fh:
        s1 = json.load(fh)
    with open(os.path.join(two_dir, "summary.yaml")) as fh:
        s2 = json.load(fh)
    calls1, calls2 = report(one_out), report(rr.stdout)
    stray = [f for f in os.listdir(out) if f not in ("result_all", "tmp")]
    # torch.distributed.run keeps its own torchelastic_* directory there
    scratch = [f for f in os.listdir(tmp) if f.startswith("pdb2r_rank")]
    log(f"[ranks] (d) {smi_line}; the all CLI (phase 16's settings) under "
        f"torch.distributed.run --nproc-per-node 2 with --workers 2: rc "
        f"{rr.returncode}, {wall:.1f} s with start-up; summary.yaml equal "
        f"to phase 16's single-process run: {s1 == s2}; the stages' force "
        f"calls {calls2} (phase 16: {calls1}); one output tree, phase 16's "
        f"files: {tree(two_dir) == tree(one_dir)}; stray entries "
        f"{stray}; rank scratch left in TMPDIR {scratch}; the stage "
        f"log printed {rr.stdout.count('[all] pipeline complete')} time(s)")
    if not calls1 or calls1 != calls2:
        fail("the all CLI over two data ranks counted other force calls")
    if a_bits and s1 != s2:
        fail("the all CLI over two data ranks wrote another summary.yaml")
    if tree(two_dir) != tree(one_dir) or stray or scratch \
            or rr.stdout.count("[all] pipeline complete") != 1:
        fail("the all CLI over two ranks left other files than rank 0's "
             "tree, a scratch directory or a second log")


def phase_ranks(calc, p12, ref64, p15, p16, smi_line):
    """Phase 20: the data axis and the Hessian over ranks. Returns the
    launches of its paths summed over the ranks."""
    import shutil

    import torch
    from pdb2reaction_tpu_torch.core.io_xyz import read_xyz
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    from pdb2reaction_tpu_torch.workflows.freq import run_freq
    t_phase = time.perf_counter()
    out = os.path.join(HERE, "result_smoke", "ranks")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    st64, w64, _ = ref64
    gpath, freeze = p15
    st = calc.structure
    torch.save({"params": calc.params, "st300": (st.numbers, st.coords),
                "xA": p12["xA"], "xB": p12["xB"],
                "st64": (st64.numbers, st64.coords), "w64": w64,
                "gpath": gpath, "freeze": freeze},
               os.path.join(out, "in.pt"))
    # (b) first in one process: does the plain path repeat bit for bit?
    H12, t12 = p12["hess"]
    cb = st64.coords_bohr.reshape(-1)
    one = make_uma_calculator(st64, model="escn-md", params=w64,
                              freeze_atoms=[0, 1])
    with env_set(PDB2R_TPU_HVP_CHUNK=1):      # as phase 12 and the ranks
        H_again = one.get_hessian(cb)["hessian"]
    repeats = bool(np.array_equal(H_again, H12))
    del one
    # (c)'s reference: run_freq on the TS guess in one process
    c1 = make_uma_calculator(read_xyz(gpath), model="escn-md",
                             params=calc.params, pad_multiple=64,
                             freeze_atoms=freeze)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rf = run_freq(gpath, calculator=c1, charge=0, verbose=False,
                  out_dir=os.path.join(out, "freq_one"))
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    del c1
    torch.cuda.empty_cache()
    # (a), (b) and (c) in one group of four ranks on the card
    ranks, wall = p20_spawn(out, P20_RANKS, "abc", limit=400)
    log(f"[ranks] {P20_RANKS} ranks started with spawn on the card, "
        f"{wall:.1f} s for (a)-(c) with start-up")
    total, a_bits = p20_gsm_checks("(a) data axis, the flagship string",
                                   [r["a"] for r in ranks], p12, smi_line)
    Hs = [r["b"]["H"] for r in ranks]
    err_b = max(float(np.abs(H - H12).max() / np.abs(H12).max()) for H in Hs)
    bits_b = all(np.array_equal(H, H12) for H in Hs)
    same_b = all(np.array_equal(H, Hs[0]) for H in Hs)
    log(f"[ranks] (b) {smi_line}; the 64-atom analytic Hessian with its "
        f"{int(np.count_nonzero(np.abs(H12).sum(1)))} free-DOF tangents "
        f"over {P20_RANKS} data ranks: "
        f"{max(r['b']['wall'] for r in ranks):.2f} s against phase 12's "
        f"one process {t12:.2f} s; max|dH|/max|H| against phase 12's "
        f"{err_b:.3e}, bit for bit {bits_b}; the plain path repeats bit for "
        f"bit in one process: {repeats}; the same bits on every rank: "
        f"{same_b}; launches (its one force call) "
        f"{[r['b']['launches'] for r in ranks]}")
    if not same_b or err_b > SHARD_TOL or (repeats and not bits_b):
        fail("(b) the Hessian over data ranks differs between ranks or "
             "from the single-process one")
    for r in ranks:
        for k, v in r["b"]["launches"].items():
            total[k] = total.get(k, 0) + v
    c = [r["c"] for r in ranks]
    H0, f0 = rf["hessian"], rf["freqs_cm"]
    err_c = max(float(np.abs(x["H"] - H0).max() / np.abs(H0).max())
                for x in c)
    df = max(float(np.abs(x["freqs"] - f0).max()) for x in c)
    same_c = all(np.array_equal(x["H"], c[0]["H"]) for x in c)
    ms_hvp = c[0]["hess_s"] / c[0]["n_hvp"] * 1e3
    want_c = {k: 4 for k in ("fused_edge_block_fwd", "fused_edge_block_bwd",
                             "fused_node_ffn_fwd", "fused_node_ffn_bwd")}
    log(f"[ranks] (c) {smi_line}; run_freq on phase 15's TS guess "
        f"({st.n_atoms} atoms, P = {c[0]['n_pad']}, "
        f"{len(st.coords) - len(freeze)} active) sharded over "
        f"{P20_RANKS} model ranks: {c[0]['wall']:.2f} s, the Hessian "
        f"{c[0]['hess_s']:.2f} s = {c[0]['n_hvp']} HVPs at {ms_hvp:.1f} ms "
        f"each through the sharded plain closure (one process: run_freq "
        f"{t_one:.2f} s); max|dH|/max|H| against one process {err_c:.3e} "
        f"(tol {SHARD_TOL}), max|dfreq| {df:.4f} cm-1 (tol {P20_FREQ_TOL});"
        f" the same bits on every rank: {same_c}; peak memory per rank "
        f"{[round(x['peak_gib'], 2) for x in c]} GiB; launches inside the "
        f"Hessian {[x['inside'] for x in c]}, outside it (its one force "
        f"call) {[x['launches'] for x in c]}")
    if err_c > SHARD_TOL or df > P20_FREQ_TOL or not same_c:
        fail("(c) the sharded Hessian or frequencies disagree with the "
             "unsharded run_freq, or between ranks")
    if any(x["inside"] or x["launches"] != want_c for x in c):
        fail(f"(c) launches: a kernel inside the Hessian, or other than "
             f"{want_c} outside it")
    for x in c:
        for k, v in x["launches"].items():
            total[k] = total.get(k, 0) + v
    p20_cli(p16, a_bits, smi_line)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        n = min(P20_RANKS, n_cards)
        d_e = os.path.join(out, "cards")
        os.makedirs(d_e)
        shutil.copy(os.path.join(out, "in.pt"), d_e)
        ranks_e, _ = p20_spawn(d_e, n, "a", limit=300)
        e_total, _ = p20_gsm_checks(f"(e) {n} cards over NCCL, one rank a "
                                    f"card", [r["a"] for r in ranks_e],
                                    p12, smi_line)
        log(f"[ranks] (e) wall {max(r['a']['wall'] for r in ranks_e):.2f} s"
            f" on {n} cards against (a)'s "
            f"{max(r['a']['wall'] for r in ranks):.2f} s on one")
        for k, v in e_total.items():
            total[k] = total.get(k, 0) + v
    else:
        log(f"[ranks] (e) the host has {n_cards} card: the NCCL data axis "
            "over several cards did not run")
    log(f"[ranks] phase 20 wall {time.perf_counter() - t_phase:.1f} s")
    return total


# ---- phase 21: training ----------------------------------------------------
P21_ATOMS = 64          # atoms a training structure
P21_STEPS = 20          # Adam steps of (a) and (b)
P21_LR = 3e-3           # JAX tests/test_train.py's rate
P21_CMP = 2             # structures of the card-against-CPU step
P21_SEED = 21           # the weights' seed
P21_TP_TOL = 1e-6       # tensor-parallel energy, relative (forces SHARD_TOL)
P21_LOSS_TOL = 1e-4     # a sharded step's loss against one process, rel
P21_PARAM_TOL = 1e-5    # its parameters after the step, absolute
P21_MODELS = {"escn": (21, 4), "painn": (121, 8)}   # batch seed, size
# (e)'s steps run at JAX tests/test_train.py's sharded rate, in float64
# and in float32. The parameters after a step are held in float64 only:
# in float32 Adam's first update, lr g / (|g| + 1e-8), turns the rounding
# of a gradient element that cancels to ~1e-8 (terms of ~1e-2 summed in
# another order over ranks) into parameter differences above 1e-5
# (2.6e-5 on the CPU for uma-s-1p1's data split alone). The gradients
# (first moments) are held in both.
P21_SHARD_LR = 1e-3
P21_SHARD_DTYPES = ("float64", "float32")
P21_GRAD_TOL = {"float64": 1e-6,   # (e)'s gradients, of each leaf's max
                "float32": 1e-4}   # (3.5e-5 measured, uma-s-1p1 dense)


def p21_batch(kind, n=None, device="cpu", dtype=None):
    """``n`` structures of P21_ATOMS atoms (``cluster`` with seeds from
    the kind's batch seed, jittered by 0.05 Angstrom) and numpy-seeded
    targets: each energy the sum of its atoms' reference energies (one
    normal draw of 0.5 eV an element: what a fine-tune's per-element
    offsets absorb), forces 0.02 x normal (eV/Angstrom, the seeded
    escn-md's own scale)."""
    import torch
    from pdb2reaction_tpu_torch.mlip.train import TrainBatch
    seed, size = P21_MODELS[kind]
    n = size if n is None else n
    rng = np.random.default_rng(seed)
    zs, xs = zip(*(cluster(P21_ATOMS, seed=seed + i) for i in range(n)))
    xs = [x + rng.normal(scale=0.05, size=x.shape) for x in xs]
    eps = 0.5 * rng.normal(size=101)
    e = np.array([eps[z].sum() for z in zs])
    f = 0.02 * rng.normal(size=(n, P21_ATOMS, 3))
    dt = dtype or torch.float32
    batch = TrainBatch(torch.as_tensor(np.stack(zs), dtype=torch.long),
                       torch.as_tensor(np.stack(xs), dtype=dt),
                       torch.ones(n, P21_ATOMS, dtype=dt),
                       torch.as_tensor(e, dtype=dt),
                       torch.as_tensor(f, dtype=dt))
    return TrainBatch(*(t.to(device) for t in batch))


def p21_model(kind, device="cpu", dtype=None):
    """(cfg, params, step maker) of (a) / (b): escn-md at full width with
    its banks unmerged on the plain "xla" route, or uma-s-1p1 dense; the
    seeded float32 weights, cast to ``dtype``."""
    import dataclasses

    import torch
    from pdb2reaction_tpu_torch.mlip import train as T
    from pdb2reaction_tpu_torch.mlip.escn import (ESCN_CONFIGS,
                                                  init_escn_params, tree_to)
    from pdb2reaction_tpu_torch.mlip.model import CONFIGS, make_model
    if kind == "escn":
        cfg = dataclasses.replace(ESCN_CONFIGS["escn-md"], edge_kernel="xla")
        p = init_escn_params(cfg, seed=P21_SEED)
        p.update(charge=torch.tensor(0.0), spin=torch.tensor(1.0),
                 task=torch.tensor(0.0))
        make, sharded = T.make_escn_train_step, T.make_escn_sharded_train_step
    else:
        cfg = CONFIGS["uma-s-1p1"]
        _, p, _ = make_model(cfg, seed=P21_SEED)
        make, sharded = T.make_train_step, T.make_sharded_train_step
    cfg, p = p21_cast(kind, cfg, tree_to(p, device=device),
                      dtype or torch.float32)
    return cfg, p, make, sharded


def p21_cast(kind, cfg, p, dt):
    """(cfg, params) of ``kind`` computing in ``dt`` (PaiNN keeps its
    atom reference energies float32, as its readout sums them)."""
    import dataclasses

    from pdb2reaction_tpu_torch.mlip.escn import tree_to
    p = tree_to(p, dtype=dt)
    if kind == "painn":
        p["atom_ref"] = p["atom_ref"].float()
    return dataclasses.replace(cfg, dtype=dt), p


def p21_first_step(kind, device, dtype, n):
    """One Adam step of ``kind`` on the first ``n`` structures: (loss, the
    step's gradients as its first moments / (1 - b1), seconds)."""
    from pdb2reaction_tpu_torch.mlip import train as T
    cfg, p, make, _ = p21_model(kind, device, dtype)
    opt = T.adam(P21_LR)
    batch = p21_batch(kind, n, device, dtype)
    t0 = time.perf_counter()
    _, state, loss = make(cfg, opt)(p, opt.init(p), batch)
    sec = time.perf_counter() - t0
    return float(loss), [m / (1 - opt.b1) for m in state.mu], sec


def p21_cpu_reference(out_path):
    """(a) / (b)'s one step in float64 on the CPU on P21_CMP structures,
    in its own process (``--p21-cpu OUT``, started after phase 18) while
    the card works through phases 19 and 20."""
    import torch
    torch.set_num_threads(3)        # beside the card phases' host work
    res = {}
    for kind in P21_MODELS:
        loss, grads, sec = p21_first_step(kind, "cpu", torch.float64,
                                          P21_CMP)
        res[f"{kind}/loss"] = loss
        res[f"{kind}/seconds"] = sec
        for i, g in enumerate(grads):
            res[f"{kind}/g{i}"] = g.numpy()
    np.savez(out_path, **res)


def start_p21_cpu():
    """Start (a) / (b)'s CPU float64 steps in a child process."""
    return start_cpu_child("p21-cpu", "p21_cpu.npz")


def p21_wait_cpu(cpu_ref, limit=400, what="phase 21's"):
    """The child's results, once it has ended (at most ``limit`` s), and
    the seconds waited for them."""
    proc, npz = cpu_ref
    t0 = time.perf_counter()
    try:
        stdout, _ = proc.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"{what} CPU reference did not finish within {limit} s")
    if proc.returncode != 0 or not os.path.exists(npz):
        fail(f"{what} CPU reference failed: {stdout[-3000:]}")
    return np.load(npz), time.perf_counter() - t0


def p21_train(kind, ref, smi_line):
    """(a) or (b): the card's step on P21_CMP structures against the CPU
    float64 one, then P21_STEPS steps on the whole batch."""
    import torch
    from pdb2reaction_tpu_torch.mlip import train as T
    tag = {"escn": "(a) escn-md, xla", "painn": "(b) uma-s-1p1, dense"}[kind]
    loss, grads, _ = p21_first_step(kind, "cuda", torch.float32, P21_CMP)
    l64 = float(ref[f"{kind}/loss"])
    err_l = abs(loss - l64) / abs(l64)
    errs = []
    for i, g in enumerate(grads):
        g64 = ref[f"{kind}/g{i}"]
        s = np.abs(g64).max()
        if s > 0:
            errs.append(float(np.abs(g.double().cpu().numpy() - g64).max()
                              / s))
    log(f"[train] {tag} {smi_line}: one step on {P21_CMP} structures of "
        f"{P21_ATOMS} atoms, card f32 (TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}) against CPU f64: loss "
        f"{loss:.6f} / {l64:.6f}, rel {err_l:.3e} (tol 1e-4); max over "
        f"{len(errs)} gradient leaves of max|dg|/max|g| {max(errs):.3e} "
        f"(tol 1e-4; CPU step {float(ref[f'{kind}/seconds']):.1f} s)")
    if not err_l <= 1e-4 or not max(errs) <= 1e-4:
        fail(f"{tag}: the card's train step disagrees with the CPU float64 "
             "step")
    cfg, p, make, _ = p21_model(kind, "cuda")
    opt = T.adam(P21_LR)
    step = make(cfg, opt)
    batch = p21_batch(kind, device="cuda")
    state = opt.init(p)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for k in range(P21_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, state, loss = step(p, state, batch)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_par = sum(x.numel() for x in T.tree_leaves(p))
    log(f"[train] {tag} {smi_line}: {P21_STEPS} Adam steps at {P21_LR} on "
        f"{len(batch.energy)} structures of {P21_ATOMS} atoms, {n_par} "
        f"parameters: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
        f"({losses[-1] / losses[0]:.3f} x; must be < 0.9); ms per step "
        f"{np.median(ms[1:]):.1f} (median of {P21_STEPS - 1}; first "
        f"{ms[0]:.1f}); peak memory {peak:.2f} GiB ({peak - base:.2f} above "
        f"the {base:.2f} GiB held before)")
    if not np.all(np.isfinite(losses)) or not losses[-1] < 0.9 * losses[0]:
        fail(f"{tag}: {P21_STEPS} steps did not bring the loss below 0.9 x "
             "its first value")


def p21_refusals(smi_line):
    """(c): a kernel configuration's step raises on the card before any
    launch."""
    import dataclasses

    import torch
    from pdb2reaction_tpu_torch.mlip import train as T
    for kind, over in (("escn", dict(edge_kernel="pallas-mega")),
                       ("painn", dict(mp_mode="pallas"))):
        cfg, p, make, _ = p21_model(kind, "cuda")
        cfg = dataclasses.replace(cfg, **over)
        opt = T.adam(P21_LR)
        zero_all_counts()
        try:
            make(cfg, opt)(p, opt.init(p), p21_batch(kind, 1, "cuda"))
        except RuntimeError as e:
            msg = str(e)
        else:
            fail(f"(c) {over}: the train step ran on the card")
        moved = {k: v for k, v in all_counts().items() if v}
        log(f"[train] (c) {over} {smi_line}: refused, launches before the "
            f"raise {moved}: {msg[:120]}...")
        if moved or "edge_kernel=" not in msg and "mp_mode=" not in msg:
            fail(f"(c) {over}: a launch before the refusal, or a message "
                 "that names no plain configuration")
        del p
    torch.cuda.empty_cache()


P21_LAYOUTS = ("pallas-mega", "pallas-full", "pallas")


def p21_wgrad(calc, f_mega, smi_line):
    """(d): dE/dW through K1, K3 and K4 (each with K2) against the plain
    route on the card, phase 4's weights unmerged; the force call with
    and without weight gradients. Returns the launches."""
    import dataclasses

    import torch
    from pdb2reaction_tpu_torch.mlip import train as T
    from pdb2reaction_tpu_torch.mlip.escn import (escn_energy,
                                                  init_escn_params)
    cfg0 = calc.cfg
    p = init_escn_params(cfg0, seed=0, device="cuda")
    p.update(charge=torch.tensor(0.0), spin=torch.tensor(1.0),
             task=torch.tensor(0.0))
    system = calc.system
    c0 = system.coords.float()

    def wgrad(layout, coords=False):
        cfg = dataclasses.replace(cfg0, edge_kernel=layout)
        leaves = [x.detach().requires_grad_(True) for x in
                  T.tree_leaves(p)]
        c = c0.clone().requires_grad_(coords)
        e = escn_energy(c, system, T._with_leaves(p, leaves), cfg)
        want = leaves + ([c] if coords else [])
        return torch.autograd.grad(e, want, allow_unused=True)

    ref = wgrad("xla")
    total = {}
    for layout in P21_LAYOUTS:
        zero_all_counts()
        got = wgrad(layout)
        torch.cuda.synchronize()
        moved = {k: v for k, v in all_counts().items() if v}
        err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got, ref)
                  if b is not None and b.abs().max() > 0)
        log(f"[wgrad] (d) {layout} {smi_line}: dE/dW of {len(ref)} leaves "
            f"at {calc.n_atoms} atoms (P = {calc.n_pad}) against the plain "
            f"route on the card: max over leaves of max|dg|/max|g| "
            f"{err:.3e} (tol {KERNEL_TOL}); launches {moved}")
        if not err <= KERNEL_TOL:
            fail(f"(d) {layout}: weight cotangents disagree with the plain "
                 "route")
        for k, v in moved.items():
            total[k] = total.get(k, 0) + v
    # the force call with and without weight gradients (pallas-mega)
    for with_w in (True, False):
        def call():
            if with_w:
                return wgrad("pallas-mega", coords=True)[-1]
            c = c0.clone().requires_grad_(True)
            cfg = dataclasses.replace(cfg0, edge_kernel="pallas-mega")
            return torch.autograd.grad(escn_energy(c, system, p, cfg), c)[0]
        zero_all_counts()
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        moved = {k: v for k, v in all_counts().items() if v}
        for k, v in moved.items():
            total[k] = total.get(k, 0) + v
        how = "with" if with_w else "without"
        log(f"[wgrad] (d) pallas-mega force call {how} weight gradients "
            f"{smi_line}: {ms:.2f} ms (4 calls, launches {moved})")
    zero_all_counts()
    same = np.array_equal(calc.get_forces(
        calc.structure.coords_bohr.reshape(-1))["forces"], f_mega)
    for k, v in all_counts().items():
        if v:
            total[k] = total.get(k, 0) + v
    log(f"[wgrad] (d) phase 4's force call again, no weight requiring grad: "
        f"bit for bit phase 4's forces: {same}")
    if not same:
        fail("(d) the force call no longer repeats phase 4's forces")
    del p
    torch.cuda.empty_cache()
    return total


def p21_diff(leaves, ref, rel=False):
    """max|a - b| over the leaves; ``rel``: each over its max|b|."""
    out = 0.0
    for a, b in zip(leaves, ref):
        d = float((a.detach().cpu() - b).abs().max())
        if rel:
            d = d / float(b.abs().max()) if b.abs().max() > 0 else d
        out = max(out, d)
    return out


P21_SHARD_N = {"painn": 8, "escn": 4}    # (e)'s batches: 4 / 2 a data rank


def p21_shard_ref(kind, model, dtype):
    """(e)'s single-process step on the card in ``dtype`` (a name) of
    ``model`` (p21_model's): its loss, the parameters after it and its
    first moments, on the host."""
    import torch
    from pdb2reaction_tpu_torch.mlip import train as T
    dt = getattr(torch, dtype)
    cfg, p, make, _ = model
    cfg, p = p21_cast(kind, cfg, p, dt)
    opt = T.adam(P21_SHARD_LR)
    p1, st, loss = make(cfg, opt)(p, opt.init(p), p21_batch(
        kind, P21_SHARD_N[kind], "cuda", dt))
    return {"loss": float(loss), "params": [x.cpu() for x in
                                            T.tree_leaves(p1)],
            "mu": [m.cpu() for m in st.mu]}


def p21_rank_step(kind, model, dt, mesh, device, ref):
    """One sharded step of (e) on this rank: ``model`` (p21_model's, its
    float32 weights) in ``dt`` against one process's ``ref``."""
    import torch
    from pdb2reaction_tpu_torch.mlip import train as T
    from pdb2reaction_tpu_torch.parallel import unshard
    cuda = device == "cuda"
    cfg, p, _, sharded = model
    cfg, p = p21_cast(kind, cfg, p, dt)
    opt = T.adam(P21_SHARD_LR)
    step, laid, state = sharded(cfg, opt, mesh, p, opt.init(p))
    del p
    batch = p21_batch(kind, P21_SHARD_N[kind], device, dt)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new, state, loss = step(laid, state, batch)
    if cuda:
        torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return {"loss": float(loss), "seconds": sec,
            "dparam": p21_diff(T.tree_leaves(unshard(new)), ref["params"]),
            "dgrad": p21_diff(T.tree_leaves(unshard(
                T._with_leaves(new, state.mu))), ref["mu"], rel=True),
            "laid": sum(1 for x in T._leaves(new)
                        if type(x).__name__ == "Shard"),
            "peak": torch.cuda.max_memory_allocated() / 2 ** 30
            if cuda else 0.0}


def p21_worker(rank, world, port, out_dir, device="cuda"):
    """One rank of (e): the dp x tp PaiNN step (data 2 x model 2), the
    dp x ep eSCN step (data 2 x expert 2) and the tensor-parallel
    calculator, each against the parent's single-process results
    (``device`` "cpu" rehearses it without a card)."""
    import pickle
    import traceback
    try:
        sys.path.insert(0, HERE)
        import torch
        from pdb2reaction_tpu_torch.core.structure import Structure
        from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
        from pdb2reaction_tpu_torch.parallel import (initialize_distributed,
                                                     make_mesh, shutdown)
        initialize_distributed(f"127.0.0.1:{port}", world, rank,
                               device=device, timeout_s=300)
        cuda = device == "cuda"
        inp = torch.load(os.path.join(out_dir, "in.pt"), weights_only=False)
        out = {}
        for kind, mesh in (("painn", make_mesh(data=2, model=2)),
                           ("escn", make_mesh(data=2, expert=2))):
            model = p21_model(kind, device)
            for dtype in P21_SHARD_DTYPES:
                out[kind, dtype] = p21_rank_step(
                    kind, model, getattr(torch, dtype), mesh, device,
                    inp[kind][dtype])
            del model
        mesh = make_mesh(data=2, model=2)
        st = Structure(*inp["st"])
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        calc = make_uma_calculator(st, mesh=mesh, device=device)
        calc.shard_params_model()
        cb = st.coords_bohr.reshape(-1)
        r = calc.get_forces(cb)
        rb = calc.get_forces_batch(np.stack([cb, cb + 0.01]))
        out["tp"] = {"energy": r["energy"], "forces": r["forces"],
                     "batch": rb["energy"], "batch_f": rb["forces"][0],
                     "peak": torch.cuda.max_memory_allocated() / 2 ** 30
                     if cuda else 0.0}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
        shutdown()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def p21_ranks(smi_line):
    """(e): four gloo ranks on the card against one process."""
    import pickle
    import shutil
    import socket

    import torch
    import torch.multiprocessing as mp
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    out = os.path.join(HERE, "result_smoke", "training")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    st = Structure(*cluster(300, seed=0))
    first = {}
    for kind in P21_MODELS:
        model = p21_model(kind, "cuda")
        first[kind] = {dtype: p21_shard_ref(kind, model, dtype)
                       for dtype in P21_SHARD_DTYPES}
        del model
    torch.cuda.empty_cache()
    torch.save({**first, "st": (st.numbers, st.coords)},
               os.path.join(out, "in.pt"))
    ref = make_uma_calculator(st)
    cb = st.coords_bohr.reshape(-1)
    r0 = ref.get_forces(cb)
    del ref
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=p21_worker, args=(r, RANKS, port, out))
             for r in range(RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=max(t0 + 300 - time.perf_counter(), 1))
    wall = time.perf_counter() - t0
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = [open(os.path.join(out, f)).read() for f in sorted(os.listdir(out))
            if f.endswith(".err")]
    if errs or any(p.exitcode != 0 for p in procs):
        fail(f"phase 21 (e): exit codes {[p.exitcode for p in procs]}; "
             + "\n".join(errs))
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            ranks.append(pickle.load(fh))
    for (kind, tag), dtype in itertools.product(
            (("painn", "dp 2 x tp 2, uma-s-1p1 dense"),
             ("escn", "dp 2 x ep 2, escn-md xla")), P21_SHARD_DTYPES):
        rs = [x[kind, dtype] for x in ranks]
        l1 = first[kind][dtype]["loss"]
        err_l = max(abs(x["loss"] - l1) / abs(l1) for x in rs)
        dp = max(x["dparam"] for x in rs)
        dg = max(x["dgrad"] for x in rs)
        held = dtype == "float64"       # the parameters: float64 only
        log(f"[train] (e) {tag} {smi_line}: one {dtype} step at "
            f"{P21_SHARD_LR} on {P21_SHARD_N[kind]} structures over {RANKS} "
            f"gloo ranks of one card against one process: loss rel "
            f"{err_l:.3e} (tol {P21_LOSS_TOL}), max|dparam| {dp:.3e} "
            f"({f'tol {P21_PARAM_TOL}' if held else 'not held: eps'}), "
            f"gradients (first moments) max|dg|/max|g| {dg:.3e} (tol "
            f"{P21_GRAD_TOL[dtype]}); laid-out leaves a rank "
            f"{[x['laid'] for x in rs]}; step "
            f"{max(x['seconds'] for x in rs):.2f} s, peak memory a rank "
            f"{[round(x['peak'], 2) for x in rs]} GiB")
        if not err_l <= P21_LOSS_TOL or (held and not dp <= P21_PARAM_TOL) \
                or not dg <= P21_GRAD_TOL[dtype] \
                or not all(x["laid"] for x in rs):
            fail(f"(e) {tag}, {dtype}: the sharded step disagrees with one "
                 "process's")
    tp = [x["tp"] for x in ranks]
    f0 = r0["forces"]
    err_e = max(abs(x["energy"] - r0["energy"]) / abs(r0["energy"])
                for x in tp)
    err_f = max(float(np.abs(x["forces"] - f0).max() / np.abs(f0).max())
                for x in tp)
    err_b = max(max(abs(x["batch"][0] - r0["energy"]) / abs(r0["energy"]),
                    float(np.abs(x["batch_f"] - f0).max()
                          / np.abs(f0).max())) for x in tp)
    log(f"[train] (e) tensor-parallel uma-s-1p1 dense calculator, "
        f"{st.n_atoms} atoms, mesh data 2 x model 2, shard_params_model "
        f"{smi_line}: energy rel {err_e:.3e} (tol {P21_TP_TOL}), max|dF|/"
        f"max|F| {err_f:.3e} (tol {SHARD_TOL}), batched call {err_b:.3e}; "
        f"peak memory a rank {[round(x['peak'], 2) for x in tp]} GiB; "
        f"ranks' wall {wall:.1f} s with start-up")
    if not err_e <= P21_TP_TOL or not err_f <= SHARD_TOL \
            or not err_b <= SHARD_TOL:
        fail("(e) the tensor-parallel calculator disagrees with the "
             "replicated one")


def phase_training(calc, f_mega, cpu_ref, smi_line):
    """Phase 21: training. Returns the launches of (d)."""
    import torch
    t_phase = time.perf_counter()
    ref, waited = p21_wait_cpu(cpu_ref)
    log(f"[train] phase 21 waited {waited:.1f} s for the CPU float64 child")
    for kind in P21_MODELS:
        p21_train(kind, ref, smi_line)
    torch.cuda.empty_cache()
    p21_refusals(smi_line)
    launches = p21_wgrad(calc, f_mega, smi_line)
    p21_ranks(smi_line)
    log(f"[train] phase 21 wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- phase 22: chunked batching and Orbax checkpoints -----------------------
# [chunk] and [ckpt] lines. Images, HVP tangents and FD displacements in
# chunks (mlip/calculator.py): a chunk of escn-md images is one stacked
# pass (the images along the atom axis, K1 and K2 launched once a layer
# for the chunk), a chunk of tangents one batched backward of the plain
# path. Energies of stacked images against one at a time: relative
# P22_E_TOL; forces: P22_F_TOL of max|F| (f32, the same kernels on wider
# launches); a batched HVP against single ones: P22_HVP_TOL of max|Hv|.
P22_IMAGES = 8
P22_E_TOL = 1e-6
P22_F_TOL = 1e-5
P22_HVP_TOL = 1e-5
# analytic Hessian chunks against chunk 1, relative to max|H|: a float32
# bar (a batched backward runs other GEMM shapes than a single one; 3.2e-7
# measured at chunk 8 on the card), not the 1e-8 the CPU's float64 holds
# (1e-12 there, tests/test_torch_batch_chunk.py)
P22_HESS_TOL = 1e-6


def p22_string_images(calc, p12):
    """Eight images [8, 3N] Bohr: phase 12's final string's images 2-9
    (its interior), or, where phase 12 did not run, eight images
    interpolated between its endpoints."""
    from pdb2reaction_tpu_torch.constants import ANG2BOHR
    n = calc.n_atoms
    if p12 is not None:
        imgs = np.asarray(p12["gsm"][0].images)[2:2 + P22_IMAGES]
        return imgs[:, :n].reshape(P22_IMAGES, -1)
    st = calc.structure
    free = calc.system.free_mask[:n].cpu().numpy()
    a = st.coords * ANG2BOHR
    b = endpoint_b(st.coords, free) * ANG2BOHR
    t = np.linspace(0.1, 0.9, P22_IMAGES)[:, None, None]
    return ((1 - t) * a + t * b).reshape(P22_IMAGES, -1)


def p22_images(calc, X, smi_line, reps=3):
    """(a) the images through ``get_forces_batch`` at batch_chunk 1 and 8
    on phase 4's weights: ms a batch, peak memory, launches a batch, and
    the chunks held to each other. Returns the launches of the measured
    batches."""
    import torch
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    out, launched = {}, {}
    for chunk in (1, P22_IMAGES):
        c = make_uma_calculator(calc.structure, model="escn-md",
                                device="cuda", params=calc.params,
                                pad_multiple=64, batch_chunk=chunk)
        c.get_forces_batch(X)                       # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        before = all_counts()
        n0 = c.force_calls
        t0 = time.perf_counter()
        for _ in range(reps):
            r = c.get_forces_batch(X)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        moved = moved_counts(before)
        for k, v in moved.items():
            launched[k] = launched.get(k, 0) + v
        per = {k: v // reps for k, v in moved.items()}
        passes = -(-P22_IMAGES // chunk)
        want = {k: 4 * passes for k in MAIN_PATH}
        log(f"[chunk] (a) escn-md pallas-mega, {P22_IMAGES} string images "
            f"of {calc.n_atoms} atoms (P = {calc.n_pad}) at batch_chunk "
            f"{chunk}: {ms:.2f} ms a batch ({ms / P22_IMAGES:.2f} ms an "
            f"image), peak {peak:.2f} GiB ({base:.2f} held before); "
            f"launches a batch {per}; {smi_line}")
        if per != want or c.force_calls - n0 != reps * P22_IMAGES:
            fail(f"batch_chunk {chunk}: launches {per} (want {want}), "
                 f"{c.force_calls - n0} force calls")
        out[chunk] = (r, ms)
        del c
        torch.cuda.empty_cache()
    r1, r8 = out[1][0], out[P22_IMAGES][0]
    de = float(np.abs(r8["energy"] - r1["energy"]).max()
               / np.abs(r1["energy"]).max())
    df = float(np.abs(r8["forces"] - r1["forces"]).max()
               / np.abs(r1["forces"]).max())
    log(f"[chunk] (a) stacked against one at a time: energies rel "
        f"{de:.3e} (tol {P22_E_TOL}), forces {df:.3e} of max|F| (tol "
        f"{P22_F_TOL}); {out[1][1] / out[P22_IMAGES][1]:.2f}x the "
        f"one-image rate")
    if not (de <= P22_E_TOL and df <= P22_F_TOL):
        fail("stacked images disagree with one image at a time")
    return launched


def p22_stacked_kernels(calc, X, rows, reps=5):
    """K1 and K2 at batch_chunk 8's shapes (the first layer of the stacked
    pass: P = 8 x 320 rows, E = 8 x 10240 edges) against their plain
    versions, their ms a launch and bounds beside phase 3's one-image
    launch."""
    import torch
    from pdb2reaction_tpu_torch.constants import BOHR2ANG
    from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
    from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
    from pdb2reaction_tpu_torch.mlip.escn import first_layer_kernel_args
    cfg = calc.cfg
    xs = torch.zeros((P22_IMAGES, calc.n_pad, 3), dtype=torch.float32,
                     device="cuda")
    xs[:, :calc.n_atoms] = torch.as_tensor(
        X.reshape(P22_IMAGES, -1, 3) * BOHR2ANG, device="cuda")
    with torch.no_grad():
        edge_args, ffn_args, _ = first_layer_kernel_args(
            xs, calc.system, calc.params, cfg)
    gen = torch.Generator(device="cuda").manual_seed(22)
    _, x_t, src, es, Dp, Dpe, weights, tables = edge_args
    nl0, nls, U, G = ek._dims(cfg)
    H, C = cfg.hidden_channels, cfg.sphere_channels
    E = src.numel()
    wts = [*ek._flat_weights(weights), *tables]
    saved = E * U * (H + C) * 4
    res = edge_parity("chunk K1", ek.fused_edge_mega,
                      ek.fused_edge_mega_plain, edge_args, (1, 3, 4, 5),
                      ("x", "es", "Dp", "Dpe"), reps, gen)
    g, y_p, gp = res[6:]
    fl = edge_flops(cfg, E)
    k1 = {"fused_edge_mega_fwd": (res[2], fl[0], nbytes(
              x_t, src, es, Dp, Dpe, *wts, y_p) + saved),
          "fused_edge_mega_bwd": (res[4], fl[1], nbytes(
              x_t, g, src, Dp, Dpe, *wts, *gp) + saved)}
    del res, g, y_p, gp
    cfg_, xn2, fw, ftab = ffn_args
    (xk,) = _leaves([xn2])
    (xp,) = _leaves([xn2])
    o_k = fk.fused_node_ffn(cfg_, xk, fw, ftab)
    o_p = fk.ffn_plain(xp, fw, ftab)
    g2 = torch.randn(o_p.shape, generator=gen, device="cuda")
    (dk,) = torch.autograd.grad(o_k, [xk], g2, retain_graph=True)
    (dp,) = torch.autograd.grad(o_p, [xp], g2, retain_graph=True)
    e2f, e2b = rel_err(o_k, o_p), rel_err(dk, dp)
    log(f"[chunk K2] fwd rel err {e2f:.3e}, bwd rel err {e2b:.3e} "
        f"(tol {KERNEL_TOL})")
    if not (e2f <= KERNEL_TOL and e2b <= KERNEL_TOL):
        fail("K2 at the stacked shapes disagrees with its plain version")
    with torch.no_grad():
        t2f = cuda_ms(lambda: fk.fused_node_ffn(cfg_, xn2, fw, ftab), reps)
    t2b = cuda_ms(lambda: torch.autograd.grad(o_k, [xk], g2,
                                              retain_graph=True), reps)
    Pn, M, _ = xn2.shape
    f2f, f2b = k2_flops(M, C, fw[0].shape[1], ftab[0].shape[0], Pn)
    k1["fused_node_ffn_fwd"] = (t2f, f2f, nbytes(xn2, *fw, *ftab, o_p))
    k1["fused_node_ffn_bwd"] = (t2b, f2b, nbytes(xn2, g2, *fw, *ftab, dp))
    for k, (t, fl_, nb) in k1.items():
        b32, _, by = bound_ms(fl_, nb, k)
        one = ""
        if k in rows:
            b1, _, _ = bound_ms(rows[k][3], rows[k][4], k)
            one = f" (one image: {rows[k][1]:.3f} ms, bound {b1:.3f})"
        log(f"[chunk] stacked launch {k} (P = {Pn}, E = {E}): {t:.3f} ms "
            f"a launch, {t / P22_IMAGES:.3f} ms an image{one}; bound "
            f"{b32:.3f} ms ({by}); {fl_ / t / 1e9:.2f} TFLOP/s")
    del o_k, o_p, dk, dp, xk, xp, g2, edge_args, ffn_args
    torch.cuda.empty_cache()


def p22_hessians(st64, w64, smi_line):
    """(b) phase 5's 64-atom cluster and weights (atoms 0 and 1 frozen):
    the analytic Hessian at HVP chunk 1 / 8 / 64 and the FD Hessian
    through K1 and K2 at FD chunk 1 / 8 / 64, wall and peak memory, the
    chunks against chunk 1. Returns the FD Hessians' launches."""
    import torch
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    cb = st64.coords_bohr.reshape(-1)
    gpu = make_uma_calculator(st64, model="escn-md", device="cuda",
                              params=w64, freeze_atoms=[0, 1])
    gpu.get_forces(cb)
    n_free = int(gpu.free_dof_mask.sum())
    images_fn = gpu.energy_fn_images
    passes = []

    def counted(*a):
        passes.append(a[0].shape[0])
        return images_fn(*a)
    counted.max_images = images_fn.max_images
    gpu.energy_fn_images = counted
    launched, H = {}, {}
    for mode, env in (("Analytical", "PDB2R_TPU_HVP_CHUNK"),
                      ("FiniteDifference", "PDB2R_TPU_FD_CHUNK")):
        gpu.hessian_calc_mode = mode
        for chunk in (1, 8, 64):
            passes.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = all_counts()
            n0 = gpu.force_calls
            t0 = time.perf_counter()
            with env_set(**{env: chunk}):
                H[mode, chunk] = gpu.get_hessian(cb)["hessian"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            moved = moved_counts(before)
            calls = gpu.force_calls - n0
            if mode == "Analytical":
                want = {k: 4 for k in MAIN_PATH}     # get_hessian's forces
                ok = calls == 1 and not passes
            else:
                for k, v in moved.items():
                    launched[k] = launched.get(k, 0) + v
                # stacked passes, at chunk 1 a launch sequence a call
                want = {k: 4 * (len(passes) or 2 * n_free) + 4
                        for k in MAIN_PATH}
                ok = (calls == 2 * n_free + 1 and len(passes) == (
                    0 if chunk == 1 else -(-2 * n_free // chunk)))
            log(f"[chunk] (b) 64 atoms, {mode} Hessian at chunk {chunk}: "
                f"{wall:.2f} s, peak {peak:.2f} GiB, {calls} force calls, "
                f"{len(passes)} stacked passes, launches {moved}; "
                f"{smi_line}")
            if not ok or moved != want:
                fail(f"{mode} Hessian at chunk {chunk}: {calls} calls, "
                     f"{len(passes)} passes, launches {moved} (want {want})")
    h1 = H["Analytical", 1]
    scale = np.abs(h1).max()
    # two FD Hessians, each within the FD's own float32 error of the
    # analytic one, part by at most twice it
    fd_err = float(np.abs(H["FiniteDifference", 1] - h1).max() / scale)
    for mode, tol in (("Analytical", P22_HESS_TOL),
                      ("FiniteDifference", 2 * fd_err)):
        for chunk in (8, 64):
            d = float(np.abs(H[mode, chunk] - H[mode, 1]).max() / scale)
            log(f"[chunk] (b) {mode} chunk {chunk} against chunk 1: "
                f"max|dH|/max|H| = {d:.3e} (tol {tol:.3e}"
                + (", twice the FD Hessian's own error against the analytic "
                   "one)" if mode != "Analytical" else ")"))
            if not d <= tol:
                fail(f"the {mode} Hessian at chunk {chunk} disagrees with "
                     "chunk 1")
    return launched


def p22_hvp300(calc, smi_line):
    """(c) HVP batches on phase 4's calculator at 300 atoms (P = 320): C
    tangents in one batched backward of the plain path at C = 1, 8 and
    the default, ms a tangent and peak memory over the graph; the batch
    against single HVPs."""
    import torch
    from pdb2reaction_tpu_torch.mlip.calculator import HVP_CHUNK_DEFAULT
    cb = calc.structure.coords_bohr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c, g = calc._grad_graph(calc._to_pad_ang(cb), calc.system, calc.params)
    torch.cuda.synchronize()
    graph = torch.cuda.max_memory_allocated() / 2 ** 30
    sizes = sorted({1, 8, HVP_CHUNK_DEFAULT})
    V_all = torch.zeros((max(sizes), c.numel()), dtype=c.dtype,
                        device=c.device)
    V_all[torch.arange(max(sizes)), torch.arange(max(sizes)) * 7] = 1.0
    V_all = V_all.view(-1, *c.shape)
    singles = torch.stack([calc._vjp(c, g, v) for v in V_all[:8]])
    for C in sizes:
        V = V_all[:C]

        def run():
            if C == 1:
                return calc._vjp(c, g, V[0])[None]
            return calc._vjp(c, g, V, batched=True)
        hv = run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(run, reps=2, warm=0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        k = min(C, 8)
        err = rel_err(hv[:k], singles[:k])
        log(f"[chunk] (c) escn-md HVPs at {calc.n_atoms} atoms (P = "
            f"{calc.n_pad}), plain path, {C} tangents a batched backward: "
            f"{ms / C:.2f} ms a tangent ({ms:.1f} ms the batch), peak "
            f"{peak:.2f} GiB ({graph:.2f} GiB with the graph alone); first "
            f"{k} rows against single HVPs {err:.3e} (tol {P22_HVP_TOL}); "
            f"{smi_line}")
        if not err <= P22_HVP_TOL:
            fail(f"a batch of {C} HVPs disagrees with single ones")
        del hv, V
        torch.cuda.empty_cache()
    del c, g, V_all, singles
    torch.cuda.empty_cache()


def p22_ckpt(calc):
    """(d) Orbax trees: with tensorstore, phase 4's weights written and
    read back bit for bit; without it, ``checkpoint=`` raising the
    ImportError that names tensorstore before any launch."""
    import shutil

    import torch
    from pdb2reaction_tpu_torch.mlip.uma import (load_checkpoint,
                                                 make_uma_calculator,
                                                 save_checkpoint)
    try:
        import tensorstore  # noqa: F401
        have = True
    except ImportError:
        have = False
    tree = os.path.join(HERE, "result_smoke", "ckpt_escn_md")
    log(f"[ckpt] tensorstore imports: {have}")
    if not have:
        before = all_counts()
        try:
            make_uma_calculator(calc.structure, model="escn-md",
                                device="cuda", checkpoint=tree)
            said = None
        except ImportError as e:
            said = str(e)
        moved = moved_counts(before)
        log(f"[ckpt] checkpoint={tree}: ImportError {said!r}; launches "
            f"before it {moved}")
        if said is None or "tensorstore" not in said or moved:
            fail("an Orbax checkpoint without tensorstore did not raise the "
                 "ImportError naming it before any launch")
        return
    shutil.rmtree(tree, ignore_errors=True)
    t0 = time.perf_counter()
    save_checkpoint(tree, calc.params)
    back = load_checkpoint(tree, required=True)
    wall = time.perf_counter() - t0
    leaves, bad = 0, []

    def walk(a, b, path):
        nonlocal leaves
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,))
        else:
            leaves += 1
            x = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)
            y = np.asarray(b)
            if x.dtype != y.dtype or x.shape != y.shape \
                    or not np.array_equal(x, y):
                bad.append(path)
    walk(calc.params, back, ())
    log(f"[ckpt] phase 4's weights written and read back ({leaves} leaves, "
        f"{wall:.2f} s): {len(bad)} differ")
    if bad:
        fail(f"Orbax round trip changed leaves {bad[:5]}")
    shutil.rmtree(tree, ignore_errors=True)


def phase_chunks(calc, p12, st64, w64, rows, smi_line):
    """Phase 22: chunked batching and Orbax checkpoints. Returns the
    launches counted in (a) and (b)'s FD Hessians."""
    import torch
    t0 = time.perf_counter()
    p22_ckpt(calc)
    X = p22_string_images(calc, p12)
    launched = p22_images(calc, X, smi_line)
    p22_stacked_kernels(calc, X, rows)
    for k, v in p22_hessians(st64, w64, smi_line).items():
        launched[k] = launched.get(k, 0) + v
    p22_hvp300(calc, smi_line)
    torch.cuda.empty_cache()
    log(f"[chunk] phase 22 wall {time.perf_counter() - t0:.1f} s")
    return launched


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="device, build and kernel parity only")
    ap.add_argument("--p18-cpu", default=None, metavar="OUT",
                    help=argparse.SUPPRESS)   # phase 18d's CPU child
    ap.add_argument("--p21-cpu", default=None, metavar="OUT",
                    help=argparse.SUPPRESS)   # phase 21's CPU child
    ap.add_argument("--p12-cpu", default=None, metavar="OUT",
                    help=argparse.SUPPRESS)   # phase 12's CPU child
    ap.add_argument("--chunks", action="store_true",
                    help="device, build and phase 22 alone (images "
                         "interpolated between phase 12's endpoints)")
    args = ap.parse_args()
    if args.p18_cpu:
        sys.path.insert(0, HERE)
        p18_cpu_reference(args.p18_cpu)
        return
    if args.p21_cpu:
        sys.path.insert(0, HERE)
        p21_cpu_reference(args.p21_cpu)
        return
    if args.p12_cpu:
        sys.path.insert(0, HERE)
        p12_cpu_reference(args.p12_cpu)
        return
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
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    zs, xyz = cluster(300, seed=0)
    st = Structure(zs, xyz)
    # padded to 320 atom slots (E = 320 * 32 = 10240 edges)
    calc = make_uma_calculator(st, model="escn-md", device="cuda", seed=0,
                               pad_multiple=64)
    log(f"[setup] TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn TF32 {torch.backends.cudnn.allow_tf32}")
    if args.chunks:
        from pdb2reaction_tpu_torch.mlip.escn import (ESCN_CONFIGS,
                                                      init_escn_params)
        zero_all_counts()
        phase_chunks(calc, None, Structure(*cluster(64, seed=1)),
                     init_escn_params(ESCN_CONFIGS["escn-md"], seed=0),
                     {}, smi_line)
        print(smi_line, flush=True)
        return
    # phase 12's CPU Hessian columns, in a child process from here on:
    # they overlap phases 3-5 on the card
    p12_cpu = None if args.quick else start_cpu_child("p12-cpu",
                                                      "p12_cpu.npz")
    rows = phase_kernels(calc, calc.cfg, args.quick)

    import dataclasses
    from pdb2reaction_tpu_torch.mlip.model import CONFIGS, make_model
    zs4, xyz4 = cluster(4096, seed=0)
    st4 = Structure(zs4, xyz4)                # P = 4096, no padding
    cfg_p = dataclasses.replace(CONFIGS["uma-s-1p1"], mp_mode="pallas")
    _, w4, _ = make_model(cfg_p, seed=0)
    calc4 = pallas_calculator(st4, cfg_p, w4)
    rows.update(phase_k5(calc4, args.quick))
    phase_k5_r33(calc4, args.quick)
    k6_rows = phase_k6(calc4, args.quick)
    rows.update(k6_rows)
    del calc4
    torch.cuda.empty_cache()

    launches = {k: 0 for k in rows}
    if not args.quick:
        # ---- the escn main path: counts set to 0 just before, read just
        # after
        zero_escn_counts()
        f_mega, ms_force = phase_force(calc, reps=5)
        phase_opt(calc, cycles=10)
        main_path = ("fused_edge_mega_fwd", "fused_edge_mega_bwd",
                     "fused_node_ffn_fwd", "fused_node_ffn_bwd")
        launches.update({k: escn_counts()[k] for k in main_path})
        never = [k for k in main_path if launches[k] == 0]
        if never:
            fail(f"kernels never launched on the main path: {never}")
        # ---- the K3 and K4 layouts, each its own path and counts
        launches.update(phase_layout(st, "pallas-full", f_mega, reps=5,
                                     cycles=5))
        launches.update(phase_layout(st, "pallas", f_mega, reps=5,
                                     cycles=0))
        ref64 = phase_reference(seed=0)
        # ---- the GSM path on the escn-md calculator: its own counts
        p12 = phase_gsm(calc, ms_force, ref64, p12_cpu)
        # ---- phase 18d's CPU float64 reference, in a child process from
        # here on: its ~50 CPU force calls overlap phases 13-17, not phase
        # 12's CPU float64 Hessian columns
        cpu_ref = start_p18_cpu()
        # ---- path-search (its own counts), its CLI, the md golden
        t0 = time.perf_counter()
        stB, search, bond = phase_search(st)
        path_search_cli(st, stB)
        phase_golden()
        log(f"[search] phases 13-14 wall {time.perf_counter() - t0:.1f} s")
        # ---- stage 4 from phase 13's TS guess: its own counts
        p15 = phase_stage4(calc, st, search, bond, smi_line)
        # ---- all on the enzyme-like PDB pair: its own counts
        _, p16 = phase_all(smi_line)
        # ---- the scans, stage 1b and the mini DFT engine: their own counts
        phase_scans(calc, st, bond, smi_line)
        # ---- DLC and DMF: their own counts
        phase_dlc_dmf(calc, st, search, bond, ref64, cpu_ref, smi_line)
        # ---- phase 21's CPU float64 train steps, in a child process
        # from here on, beside phases 19 and 20
        p21_cpu = start_p21_cpu()
        # ---- the gate and full branches and remat: their own counts
        for k, v in phase_branches(calc, st, f_mega, ms_force,
                                   smi_line).items():
            launches[k] += v
        # ---- the PaiNN kernel path (its own counts), default path, check
        k5_launches, ref4 = phase_pallas(st4, w4, reps=3, cycles=5)
        launches.update(k5_launches)
        phase_default(st, reps=3)
        phase_reference_painn(seed=0)
        # ---- the sharded path: four ranks, their own counts (K6; K3 and
        # K2 of its eSCN part)
        for k, v in phase_spatial(
                ref4, {k: v[1] for k, v in k6_rows.items()}, rows).items():
            launches[k] += v
        # ---- the data axis and the Hessian over ranks: their own counts
        for k, v in phase_ranks(calc, p12, ref64, p15, p16,
                                smi_line).items():
            launches[k] += v
        # ---- training: its own counts (the kernels' weight cotangents)
        for k, v in phase_training(calc, f_mega, p21_cpu,
                                   smi_line).items():
            launches[k] += v
        # ---- chunked batching (stacked images, batched Hessians) and
        # Orbax checkpoints: their own counts
        for k, v in phase_chunks(calc, p12, ref64[0], ref64[1], rows,
                                 smi_line).items():
            launches[k] += v

    kern = []
    for k, (err, t, tp, fl, nb) in rows.items():
        b32, _, by = bound_ms(fl, nb, k)
        base = next(b for b in SOURCES if k.startswith(b))
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
