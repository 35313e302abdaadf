"""UMA-class calculator factory: the port of the JAX package's
``make_uma_calculator`` for both backbones.

``model`` names a PaiNN-class configuration (``mlip/model.py``:
``uma-s-1p1``, the default as in the JAX package, ``uma-m-1p1``,
``small``, ``uma-s-1p1-bf16``) or an eSCN one (``escn*``). Weights, in
this order: the caller's ``params`` (for example JAX weights carried
across with ``from_jax.params_from_jax``); a fairchem-style ``.pt``
checkpoint, given as ``checkpoint`` or else named by the
``PDB2R_TPU_UMA_PT`` variable, converted by ``mlip/convert.py`` with
the eSCN configuration inferred from its tensor shapes (``model`` is
then not read) and tagged ``converted:<path>``; an Orbax tree of the JAX
package (``save_checkpoint``), given as any other ``checkpoint`` (read
with ``required=True``, tagged ``checkpoint:<path>``) or else found at
``PDB2R_TPU_CKPT_DIR/<model>`` (read with ``required=False``, tagged
``ckpt_dir:<path>``), carried across by ``from_jax.params_from_jax``
with the requested charge and spin; else the deterministic seeded
surrogate, announced by a loud warning because its energies mean
nothing chemically. ``last_weights_source()`` gives the tag of the
latest calculator built, as in the JAX package. Orbax trees are read
and written through ``tensorstore`` (``mlip/orbax_io.py``); without it
a tree raises ImportError. For eSCN the MoLE expert banks are merged once
with the system's (task, charge, spin) routing (exact), and
``edge_kernel`` (else
the ``PDB2R_TPU_ESCN_KERNEL`` variable, else "pallas-mega") picks the
message layout: "pallas-mega" (K1), "pallas-full" (K3) or "pallas" (K4),
as in the JAX factory, or "xla", the all-plain variant.

Second derivatives (the analytic Hessian, HVPs) never reach a kernel:
the kernels' autograd functions have no double backward. As in the JAX
factory, the eSCN calculator gets the all-plain variant
(``edge_kernel="xla"``) as its ``energy_fn_hessian`` whenever its force
path runs a kernel (the gate and full configurations too: their edge
paths are plain, their node FFN is K2), and the PaiNN pallas mode gets
itself on K5's plain version; dense and gather differentiate themselves.
``hessian_calc_mode`` "auto" resolves to "Analytical", as in the JAX
factory (an FD Hessian through f32 kernel forces is noise-limited).

The device defaults to CUDA, where the force path runs the hand-written
kernels. Asking for CUDA without a card raises; CPU runs only when the
caller asks for it and takes the plain PyTorch versions.

``spatial=n > 1`` shards the atom axis over the n ranks of the process
group ``parallel.init_spatial`` joined (for example under ``torchrun
--nproc-per-node n``), as the JAX factory shards it over its mesh: the
PaiNN-class ``mp_mode="pallas"`` runs K6 on each rank's rows, its other
modes switch to the sharded gather layout; eSCN runs ``escn_energy`` on
each rank's rows with the MoLE banks premerged, "pallas-mega" taking K3
on the gathered source rows. The padding multiple becomes
lcm(pad_multiple, n) and the device is the group's. Every rank builds
the same calculator and gets the same forces. Its Hessian closure is the
sharded plain route (``parallel.spatial.make_spatial_hessian_energy_fn``),
so Hessians and HVPs run over the ranks too.

``mesh`` (``parallel.make_mesh``) goes to the ``Calculator``: with a data
axis of n > 1 and no model axis, image batches, Hessian tangents and FD
displacements are split over the n ranks. Beside ``spatial > 1`` the
data axis is off, as in the JAX factory, and the mesh's model axis must
be ``spatial``. With ``spatial`` 1 a model axis builds a replicated
calculator, as the JAX factory does; ``Calculator.shard_params_model()``
then lays its parameters' feature columns over the axis (tensor
parallelism, the same results), and every rank of a model group takes
part in every evaluation.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..core.structure import Structure
from ..parallel.distributed import current_group
from ..parallel.spatial import (make_spatial_energy_fn,
                                make_spatial_hessian_energy_fn)
from . import orbax_io
from .calculator import Calculator, resolve_device
from .convert import convert_checkpoint
from .escn import (ESCN_CONFIGS, check_edge_kernel, escn_energy_fn,
                   escn_energy_images_fn, init_escn_params,
                   premerge_escn_params, tree_to)
from .from_jax import params_from_jax
from .model import (CONFIGS, init_params, make_energy_fn,
                    make_hessian_energy_fn)


def load_checkpoint(path, *, required: bool = False) -> Optional[dict]:
    """Restore a parameter tree written by the JAX package's (or this
    module's) ``save_checkpoint``: nested dicts and lists of numpy arrays
    and Python numbers, as stored.

    ``required=True`` (an explicitly requested checkpoint) raises
    RuntimeError on any restore failure: a corrupt, missing or unreadable
    tree never silently degrades to surrogate weights. Otherwise the
    failure is printed and None returned. Without ``tensorstore`` it
    raises ImportError either way."""
    path = Path(path).resolve()
    orbax_io._tensorstore(path)
    try:
        return orbax_io.read_tree(path)
    except (FileNotFoundError, ValueError, KeyError, TypeError, OSError) as e:
        if required:
            raise RuntimeError(
                f"Failed to restore requested checkpoint {path}: {e}") from e
        print(f"[uma] WARNING: checkpoint {path} could not be restored "
              f"({e}); falling back to surrogate weights")
        return None


def save_checkpoint(path, params) -> None:
    """Write ``params`` (tensors, arrays, numbers in nested dicts and
    lists; for example a calculator's ``params`` or a train step's) as an
    Orbax tree at ``path``, replacing it, which the JAX package's
    ``load_checkpoint`` restores."""
    orbax_io.write_tree(path, params)


_LAST_WEIGHTS_SOURCE: Optional[str] = None


def last_weights_source() -> Optional[str]:
    """The weights-source tag of the latest UMA-class calculator built in
    this process (None before the first)."""
    return _LAST_WEIGHTS_SOURCE


def _record_weights_source(tag: str) -> None:
    global _LAST_WEIGHTS_SOURCE
    _LAST_WEIGHTS_SOURCE = tag


def _spatial_group(spatial: int, device):
    """The process group of ``spatial`` ranks, checked against the
    requested device type."""
    group = current_group()
    if group is None or group.size != spatial:
        have = "none" if group is None else f"{group.size} ranks"
        raise RuntimeError(
            f"spatial={spatial} needs a process group of {spatial} ranks "
            f"(have {have}): launch with `torchrun --nproc-per-node "
            f"{spatial} -m pdb2reaction_tpu_torch <command> ... --spatial "
            f"{spatial}`, or call pdb2reaction_tpu_torch.parallel."
            "init_spatial(...) in every rank first")
    if torch.device(device).type != group.device.type:
        raise ValueError(f"device={device!r}, but the process group runs "
                         f"on {group.device}")
    return group


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


def make_uma_calculator(
    structure: Structure,
    *,
    model: str = "uma-s-1p1",
    charge: int = 0,
    spin: int = 1,
    freeze_atoms: Optional[Sequence[int]] = None,
    params: Optional[dict] = None,
    checkpoint: Optional[str] = None,
    task: Optional[int] = None,
    seed: int = 0,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    max_neigh: Optional[int] = None,
    radius: Optional[float] = None,
    weights_source: Optional[str] = None,
    pad_multiple: int = 8,
    spatial: Optional[int] = None,
    edge_kernel: Optional[str] = None,
    mp_mode: Optional[str] = None,
    hessian_calc_mode: str = "auto",
    return_partial_hessian: bool = False,
    hessian_double: bool = True,
    fd_step: float = 1.0e-3,
    mesh=None,
    batch_chunk: Optional[int] = None,
) -> Calculator:
    """Calculator for a named configuration. ``dtype`` is the model's
    compute type (None: the configuration's own; the CUDA kernels take
    float32, and the PaiNN pallas mode computes in float32 whatever it
    is). ``params`` may be raw or premerged (eSCN). ``mp_mode`` picks the
    PaiNN-class layout (None: the configuration's own). ``task`` is the
    eSCN task index of the routing (None: ``params["task"]``, else 0).
    ``batch_chunk`` is the images a chunk of an image batch holds (None:
    ``PDB2R_TPU_BATCH_CHUNK``, else 1); an unsharded eSCN calculator
    stacks a chunk's images into one pass (``escn_energy_images``), its
    FD displacements too."""
    spatial = int(spatial or 1)
    if checkpoint is not None and params is not None:
        raise ValueError("give params= or a checkpoint, not both")
    if checkpoint is not None and not str(checkpoint).endswith(".pt"):
        orbax_path, pt_path = checkpoint, None
    else:
        orbax_path = None
        pt_path = checkpoint or (None if params is not None
                                 else os.environ.get("PDB2R_TPU_UMA_PT"))
    escn = bool(pt_path) or model.startswith("escn")
    if escn and mp_mode:
        raise ValueError("mp_mode picks a PaiNN-class layout; eSCN models "
                         "take edge_kernel")
    if mesh is not None and spatial > 1 and mesh.shape["model"] != spatial:
        raise ValueError(f"spatial={spatial}, but the mesh's model axis is "
                         f"{mesh.shape['model']}: give the same atom-axis "
                         "size to both")
    group = _spatial_group(spatial, device) if spatial > 1 else None
    if mesh is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device={device!r}, but the mesh runs on "
                         f"{mesh.device}")
    dev = resolve_device(group.device if group else
                         mesh.device if mesh is not None else device)
    if pt_path:
        params, cfg = convert_checkpoint(pt_path)
        weights_source = f"converted:{pt_path}"
    elif escn:
        cfg = ESCN_CONFIGS[model]
    elif model in CONFIGS:
        cfg = CONFIGS[model]
    else:
        raise KeyError(f"unknown model {model!r}: one of "
                       f"{sorted(CONFIGS) + sorted(ESCN_CONFIGS)}")
    root = os.environ.get("PDB2R_TPU_CKPT_DIR")
    tree = None
    # an Orbax tree: the explicit one (fatal when unreadable), else
    # PDB2R_TPU_CKPT_DIR/<model> (unreadable: a warning and the surrogate)
    if orbax_path:
        tree = load_checkpoint(orbax_path, required=True)
        weights_source = f"checkpoint:{orbax_path}"
    elif not pt_path and params is None and root \
            and (Path(root) / model).exists():
        tree = load_checkpoint(Path(root) / model)
        weights_source = f"ckpt_dir:{Path(root) / model}"
    if tree is not None:
        params = params_from_jax(tree)
    cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype)
    if mp_mode:
        cfg = dataclasses.replace(cfg, mp_mode=str(mp_mode))
    if group and not escn and cfg.mp_mode != "pallas":
        # the sharded layouts: K6 for pallas, the gather layout otherwise
        cfg = dataclasses.replace(cfg, mp_mode="gather")
    if max_neigh or radius:
        cfg = dataclasses.replace(
            cfg, max_neighbors=int(max_neigh) if max_neigh
            else cfg.max_neighbors,
            cutoff=float(radius) if radius else cfg.cutoff)
    ek = edge_kernel or os.environ.get("PDB2R_TPU_ESCN_KERNEL")
    if escn and ek:
        cfg = dataclasses.replace(cfg, edge_kernel=str(ek))
        check_edge_kernel(cfg)
    if params is None:
        params = (init_escn_params(cfg, seed=seed, device=dev) if escn
                  else init_params(cfg, seed=seed))
        source = _warn_surrogate(model, seed)
    else:
        source = weights_source or "given"
    _record_weights_source(source)
    params = tree_to(dict(params), device=dev)
    params = tree_to(params, dtype=cfg.dtype)
    params["charge"] = torch.as_tensor(float(charge))
    params["spin"] = torch.as_tensor(float(spin))
    fn_h = fn_images = None
    if escn:
        params["task"] = torch.as_tensor(float(
            task if task is not None else params.get("task", 0)))
        params = premerge_escn_params(params, cfg)
        if group:
            fn = make_spatial_energy_fn(cfg, group)
            fn_h = make_spatial_hessian_energy_fn(cfg, group)
        else:
            fn = escn_energy_fn(cfg)
            fn_images = escn_energy_images_fn(cfg)
            if cfg.edge_kernel != "xla":
                fn_h = escn_energy_fn(dataclasses.replace(
                    cfg, edge_kernel="xla"))
    else:
        params["atom_ref"] = params["atom_ref"].float()
        if group:
            fn = make_spatial_energy_fn(cfg, group)
            if cfg.mp_mode == "pallas":
                fn_h = make_spatial_hessian_energy_fn(cfg, group)
        else:
            fn = make_energy_fn(cfg)
            if cfg.mp_mode == "pallas":
                fn_h = make_hessian_energy_fn(cfg)
    if group:
        pad_multiple = math.lcm(int(pad_multiple), spatial)
    if hessian_calc_mode == "auto":
        hessian_calc_mode = "Analytical"
    calc = Calculator(structure, fn, params=params,
                      freeze_atoms=freeze_atoms,
                      hessian_calc_mode=hessian_calc_mode,
                      return_partial_hessian=return_partial_hessian,
                      hessian_double=hessian_double, fd_step=fd_step,
                      pad_multiple=pad_multiple, device=dev,
                      weights_source=source, energy_fn_hessian=fn_h,
                      mesh=mesh, batch_chunk=batch_chunk,
                      energy_fn_images=fn_images)
    calc.cfg = cfg
    calc.spatial = spatial
    return calc
