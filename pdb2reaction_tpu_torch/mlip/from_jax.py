"""Carry eSCN weights from the JAX package into the port.

The JAX package's parameter tree, converted to numpy first (for example
``jax.tree_util.tree_map(np.asarray, params)``), maps one to one onto the
port's tree: the same nested dicts and lists, the same key names, and the
same ``[in, out]`` orientation of every linear. Both raw trees (MoLE
expert banks ``[experts, in, out]``) and premerged ones (2-D linears) are
taken. This module needs numpy only; it never imports JAX.
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


def params_from_jax(np_params: dict, device="cpu",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The port's parameter dict from a numpy copy of a JAX eSCN tree.

    ``dtype`` casts every floating array (None keeps each array's own);
    ``charge``, ``spin`` and ``task`` come across as 0-d tensors (``task``
    defaults to 0 when absent)."""
    missing = [k for k in _REQUIRED if k not in np_params]
    if missing:
        raise KeyError(f"not an eSCN parameter tree: missing {missing}")
    for i, blk in enumerate(np_params["blocks"]):
        bad = [k for k in _BLOCK if k not in blk]
        if bad:
            raise KeyError(f"blocks[{i}] lacks {bad}")
        if "gate" in blk:
            raise NotImplementedError(
                "gate-activation weights: see ROADMAP.md queue 0 item 2")
    out: Any = _convert({k: v for k, v in np_params.items()
                         if k not in ("charge", "spin", "task")},
                        device, dtype)
    for k, default in (("charge", 0.0), ("spin", 1.0), ("task", 0.0)):
        out[k] = torch.as_tensor(float(np.asarray(np_params.get(k, default))))
    return out
