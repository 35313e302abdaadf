"""Orbax checkpoint trees, read and written without JAX or Orbax.

The JAX package hands trained weights over as the tree Orbax's
``StandardCheckpointer`` writes (``save_checkpoint`` of its
``mlip/uma.py``). Its layout, as Orbax writes it with OCDBT on and
zarr v3 off:

- ``_METADATA``: JSON whose ``tree_metadata`` maps each leaf to its
  ``key_metadata`` (the path: ``key_type`` 2 a dict key, 1 a sequence
  index) and its ``value_metadata`` (``value_type``: "jax.Array",
  "np.ndarray" or "scalar" for a Python number);
- ``_CHECKPOINT_METADATA``: the handler's name and the timestamps;
- an OCDBT key-value store at the root (``manifest.ocdbt``, ``d/``)
  holding one zarr v2 array a leaf under the leaf's path joined by ".",
  each one chunk of its whole shape, zstd level 1.

``tensorstore`` (a C++ library with Python bindings, not a JAX library)
reads and writes that store; it is imported only here and only when a
tree is read or written. Where it is missing the call raises an
ImportError naming it and the tree's path.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

DICT_KEY, SEQ_INDEX = 2, 1
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")


def _tensorstore(path):
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            f"the Orbax checkpoint {path} is read and written through the "
            "tensorstore package, which is not installed; install "
            "tensorstore, or convert the tree to a fairchem-style .pt "
            "checkpoint") from e
    return tensorstore


def _spec(ts_root: str, name: str) -> Dict[str, Any]:
    return {"driver": "zarr",
            "kvstore": {"driver": "ocdbt",
                        "base": {"driver": "file", "path": ts_root},
                        "path": name + "/",
                        "config": {"max_inline_value_bytes": 1024,
                                   "max_decoded_node_bytes": 100000000}}}


def read_tree(path) -> Any:
    """The tree at ``path``: nested dicts and lists of numpy arrays (each
    leaf with its stored dtype and shape) and Python numbers (the
    "scalar" leaves). Raises FileNotFoundError for a missing tree and
    ValueError for one that does not parse or whose arrays do not read."""
    path = Path(path).resolve()
    ts = _tensorstore(path)
    meta_file = path / "_METADATA"
    if not meta_file.is_file():
        raise FileNotFoundError(f"no Orbax tree at {path} (no _METADATA)")
    meta = json.loads(meta_file.read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr v3 trees are not read")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: trees without OCDBT are not read")
    leaves: List[Tuple[List[Tuple[str, int]], Any]] = []
    ctx = ts.Context()
    for entry in meta["tree_metadata"].values():
        keys = [(str(k["key"]), int(k["key_type"]))
                for k in entry["key_metadata"]]
        name = ".".join(k for k, _ in keys)
        try:
            arr = ts.open(_spec(str(path), name), open=True,
                          context=ctx).result().read().result()
        except Exception as e:  # tensorstore raises its own kinds
            raise ValueError(f"{path}: leaf {name!r} does not read: {e}") \
                from e
        arr = np.asarray(arr)
        if entry["value_metadata"]["value_type"] == "scalar":
            arr = arr.item()
        leaves.append((keys, arr))
    return _rebuild(leaves)


def _rebuild(leaves):
    """Nested containers from (path, leaf) pairs: a level whose keys are
    sequence indices becomes a list in index order."""
    root: Dict[Any, Any] = {}
    kinds: Dict[int, int] = {}
    for keys, leaf in leaves:
        node = root
        for depth, (k, kind) in enumerate(keys):
            kinds[id(node)] = kind
            if depth == len(keys) - 1:
                node[k] = leaf
            else:
                node = node.setdefault(k, {})

    def fix(node):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v) for k, v in node.items()}
        if kinds.get(id(node)) == SEQ_INDEX:
            return [out[k] for k in sorted(out, key=int)]
        return out
    return fix(root)


def _flatten(tree, prefix=()) -> List[Tuple[Tuple[Tuple[str, int], ...],
                                            Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + ((str(k), DICT_KEY),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + ((str(i), SEQ_INDEX),))
        return out
    return [(prefix, tree)]


def _as_numpy(leaf):
    """(array, value_type) of one leaf."""
    if isinstance(leaf, bool) or not isinstance(
            leaf, (int, float, np.ndarray, np.generic, torch.Tensor)):
        raise TypeError(f"an Orbax leaf must be a tensor, an array or a "
                        f"number, not {type(leaf).__name__}")
    if isinstance(leaf, (int, float)):
        return np.asarray(leaf), "scalar"
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16), \
                "jax.Array"
        return t.numpy(), "jax.Array"
    return np.asarray(leaf), "np.ndarray"


def write_tree(path, tree) -> None:
    """Write ``tree`` (nested dicts and lists of tensors, numpy arrays and
    Python numbers) as an Orbax tree at ``path``, replacing what is
    there: tensors as "jax.Array" leaves, numpy arrays as "np.ndarray",
    numbers as "scalar", the layout the JAX package's ``save_checkpoint``
    writes, which its ``load_checkpoint`` restores bit for bit (arrays as
    numpy arrays: the tree records no device sharding). The tree goes to a temporary sibling first and is renamed into place
    whole."""
    path = Path(path).resolve()
    ts = _tensorstore(path)
    leaves = _flatten(tree)
    tmp = path.with_name(path.name + ".orbax-checkpoint-tmp-" +
                         str(os.getpid()))
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    ctx = ts.Context()
    tree_meta = {}
    t0 = time.time_ns()
    for keys, leaf in leaves:
        arr, kind = _as_numpy(leaf)
        if arr.size == 0:
            raise ValueError(f"leaf {'.'.join(k for k, _ in keys)!r} has "
                             "no elements: Orbax saves no such array")
        arr = np.array(arr, order="C")  # 0-d stays 0-d
        name = ".".join(k for k, _ in keys)
        dtype = ("bfloat16" if arr.dtype.name == "bfloat16"
                 else arr.dtype.str)
        spec = _spec(str(tmp), name)
        spec["metadata"] = {
            "shape": list(arr.shape), "chunks": list(arr.shape),
            "dtype": dtype, "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "fill_value": None,
            "filters": None, "order": "C", "zarr_format": 2}
        store = ts.open(spec, create=True, context=ctx).result()
        store.write(arr).result()
        value = {"value_type": kind, "skip_deserialize": False}
        if kind == "jax.Array":
            value["write_shape"] = list(arr.shape)
        tree_meta[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": kind_}
                             for k, kind_ in keys],
            "value_metadata": value}
    (tmp / "_METADATA").write_text(json.dumps({
        "tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None}))
    (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": _HANDLER, "metrics": {},
        "performance_metrics": {}, "init_timestamp_nsecs": t0,
        "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)
