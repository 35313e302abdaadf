"""Carry eSCN and PaiNN-class weights from the JAX package into the port.

The JAX package's parameter tree, converted to numpy first (for example
``jax.tree_util.tree_map(np.asarray, params)``), maps one to one onto the
port's tree: the same nested dicts and lists, the same key names, and the
same ``[in, out]`` orientation of every linear. Both raw trees (MoLE
expert banks ``[experts, in, out]``) and premerged ones (2-D linears) are
taken, and so are the gate configurations' per-block ``gate`` MoLE
banks. The PaiNN-class tree (``mlip/model.py``: ``embed_z``, ``embed_q``,
``embed_s``, ``atom_ref``, ``readout``, ``layers``) is told apart by its
keys. This module needs numpy only; it never imports JAX.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

_REQUIRED = ("sphere_embedding", "source_embedding", "target_embedding",
             "charge_embedding", "spin_embedding", "task_embedding",
             "router", "edge_mlp", "edge_degree_proj", "blocks",
             "energy_norm", "energy_head", "atom_ref")
_BLOCK = ("norm_1", "so2_conv_1", "so2_conv_2", "norm_2", "ffn")
_PAINN = ("embed_z", "embed_q", "embed_s", "atom_ref", "readout", "layers")
_PAINN_LAYER = ("phi", "w_radial", "upd_vu", "upd_vv", "upd_mlp")


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    arr = np.asarray(tree)
    t = torch.as_tensor(np.array(arr), device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def _painn_from_jax(np_params, device, dtype):
    missing = [k for k in _PAINN if k not in np_params]
    if missing:
        raise KeyError(f"not a PaiNN-class parameter tree: missing "
                       f"{missing}")
    for i, lp in enumerate(np_params["layers"]):
        bad = [k for k in _PAINN_LAYER if k not in lp]
        if bad:
            raise KeyError(f"layers[{i}] lacks {bad}")
    out: Any = _convert({k: np_params[k] for k in _PAINN}, device, dtype)
    # the JAX package keeps the reference energies in float32
    out["atom_ref"] = out["atom_ref"].float()
    for k, default in (("charge", 0.0), ("spin", 1.0)):
        out[k] = torch.as_tensor(float(np.asarray(np_params.get(k, default))))
    return out


def params_from_jax(np_params: dict, device="cpu",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The port's parameter dict from a numpy copy of a JAX eSCN or
    PaiNN-class tree (told apart by the keys).

    ``dtype`` casts every floating array (None keeps each array's own;
    the PaiNN ``atom_ref`` stays float32 as in JAX); ``charge``, ``spin``
    and (eSCN) ``task`` come across as 0-d tensors on the CPU (``task``
    defaults to 0 when absent)."""
    if "embed_z" in np_params:
        return _painn_from_jax(np_params, device, dtype)
    missing = [k for k in _REQUIRED if k not in np_params]
    if missing:
        raise KeyError(f"not an eSCN parameter tree: missing {missing}")
    for i, blk in enumerate(np_params["blocks"]):
        bad = [k for k in _BLOCK if k not in blk]
        if bad:
            raise KeyError(f"blocks[{i}] lacks {bad}")
    out: Any = _convert({k: v for k, v in np_params.items()
                         if k not in ("charge", "spin", "task")},
                        device, dtype)
    for k, default in (("charge", 0.0), ("spin", 1.0), ("task", 0.0)):
        out[k] = torch.as_tensor(float(np.asarray(np_params.get(k, default))))
    return out
