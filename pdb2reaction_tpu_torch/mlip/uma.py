"""UMA-class calculator factory: the eSCN branch of the JAX package's
``make_uma_calculator``.

Weights: the caller's ``params`` (for example JAX weights carried across
with ``from_jax.params_from_jax``), else the deterministic seeded
surrogate, announced by a loud warning because its energies mean nothing
chemically. The MoLE expert banks are merged once with the system's
(task, charge, spin) routing (exact). Only eSCN configurations
(``escn*``) are ported; the PaiNN-class default ``uma-s-1p1`` is a later
port item.

The device defaults to CUDA, where the force path runs the hand-written
K1/K2 kernels. Asking for CUDA without a card raises; CPU runs only when
the caller asks for it and takes the plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Sequence

import torch

from ..core.structure import Structure
from .calculator import Calculator
from .escn import (ESCN_CONFIGS, escn_energy_fn, init_escn_params,
                   premerge_escn_params, tree_to)

def _warn_surrogate(model: str, seed: int) -> str:
    """Loud warning when the weights are the seeded surrogate; returns the
    weights-source tag."""
    tag = f"surrogate-seeded(model={model}, seed={seed})"
    print("=" * 70 + "\n"
          f"WARNING: no pretrained weights given for model '{model}'.\n"
          "Running with DETERMINISTIC SEEDED SURROGATE weights - energies "
          "and\nforces are NOT chemically meaningful. Pass real weights as "
          "params=.\n" + "=" * 70, file=sys.stderr)
    return tag


def resolve_device(device) -> torch.device:
    """The requested device; CUDA without a card raises (no fallback).
    On CUDA both TF32 switches are turned off, so the plain f32 paths
    around the kernels (edge MLP, Wigner recursion) stay full f32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain CPU path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def make_uma_calculator(
    structure: Structure,
    *,
    model: str = "escn-md",
    charge: int = 0,
    spin: int = 1,
    freeze_atoms: Optional[Sequence[int]] = None,
    params: Optional[dict] = None,
    seed: int = 0,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    max_neigh: Optional[int] = None,
    radius: Optional[float] = None,
    weights_source: Optional[str] = None,
    pad_multiple: int = 8,
) -> Calculator:
    """Calculator for a named eSCN configuration. ``dtype`` is the model's
    compute type (the CUDA kernels take float32; float64 runs the plain
    path). ``params`` may be raw or premerged."""
    if not model.startswith("escn"):
        raise NotImplementedError(
            f"model {model!r}: only the eSCN configurations are ported; the "
            "PaiNN-class model is ROADMAP.md queue 1 item 11")
    dev = resolve_device(device)
    cfg = dataclasses.replace(ESCN_CONFIGS[model], dtype=dtype)
    if max_neigh or radius:
        cfg = dataclasses.replace(
            cfg, max_neighbors=int(max_neigh) if max_neigh
            else cfg.max_neighbors,
            cutoff=float(radius) if radius else cfg.cutoff)
    if params is None:
        params = init_escn_params(cfg, seed=seed, device=dev)
        source = _warn_surrogate(model, seed)
    else:
        params = tree_to(params, device=dev)
        source = weights_source or "given"
    params = tree_to(dict(params), dtype=dtype)
    params["charge"] = torch.as_tensor(float(charge))
    params["spin"] = torch.as_tensor(float(spin))
    params["task"] = torch.as_tensor(float(params.get("task", 0)))
    params = premerge_escn_params(params, cfg)
    calc = Calculator(structure, escn_energy_fn(cfg), params=params,
                      freeze_atoms=freeze_atoms, pad_multiple=pad_multiple,
                      device=dev, weights_source=source)
    calc.cfg = cfg
    return calc
