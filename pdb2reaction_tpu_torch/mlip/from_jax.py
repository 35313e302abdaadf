"""Carry eSCN and PaiNN-class weights from the JAX package into the port.

The JAX package's parameter tree, converted to numpy first (for example
``jax.tree_util.tree_map(np.asarray, params)``), maps one to one onto the
port's tree: the same nested dicts and lists, the same key names, and the
same ``[in, out]`` orientation of every linear. Both raw trees (MoLE
expert banks ``[experts, in, out]``) and premerged ones (2-D linears) are
taken, and so are the gate configurations' per-block ``gate`` MoLE
banks. The PaiNN-class tree (``mlip/model.py``: ``embed_z``, ``embed_q``,
``embed_s``, ``atom_ref``, ``readout``, ``layers``) is told apart by its
keys. ``adam_state_from_jax`` carries an ``optax.adam`` state across
too, so a fine-tune started in the JAX package continues in the port
(``mlip/train.py``). This module needs numpy only; it never imports JAX.
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


def _find_adam(state):
    """The ``ScaleByAdamState`` (anything with ``count``, ``mu`` and
    ``nu``) inside an optax state: optax.adam's is the tuple
    ``(ScaleByAdamState, EmptyState)``."""
    if all(hasattr(state, k) for k in ("count", "mu", "nu")):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


def _moments(tree, np_tree):
    """One moment tensor per trainable leaf of the port's ``tree`` in the
    optimizer's order, each from the same path of ``np_tree`` (zeros
    where the JAX tree has no such leaf: a routing scalar the port adds,
    which never gets a gradient)."""
    from ..parallel.mesh import at_path, map_tree
    from .train import _trainable, tree_leaves

    def moment(path, x):
        if not _trainable(x):
            return x
        arr = at_path(np_tree, path)
        if arr is None:
            return torch.zeros_like(x)
        arr = np.asarray(arr)
        if arr.shape != tuple(x.shape):
            raise ValueError(f"a moment of shape {arr.shape} for a "
                             f"parameter of shape {tuple(x.shape)}")
        return torch.as_tensor(np.array(arr)).to(x)
    return tree_leaves(map_tree(tree, moment))


def adam_state_from_jax(np_state, params):
    """The port's ``train.AdamState`` from a numpy copy of an
    ``optax.adam`` state (for example ``jax.tree_util.tree_map(
    np.asarray, opt_state)``): its step ``count`` and its moments ``mu``
    and ``nu``, matched to the port's ``params`` (whole, as
    ``params_from_jax`` gives them) path by path, on each parameter's
    device and dtype. A sharded step cuts the moments to its blocks
    (``train.make_sharded_train_step``)."""
    from .train import AdamState
    st = _find_adam(np_state)
    if st is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the "
                         "optimizer state")
    return AdamState(torch.as_tensor(int(np.asarray(st.count)),
                                     dtype=torch.int32),
                     _moments(params, st.mu), _moments(params, st.nu))
