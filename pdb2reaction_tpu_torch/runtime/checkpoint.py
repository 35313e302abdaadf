"""Checkpoint and resume for long-running workflows.

Counterpart of ``pdb2reaction_tpu/runtime/checkpoint.py``, in numpy:

- array state is stored as ``.npz``, metadata (configs, indices, hashes)
  as JSON next to it;
- stages are keyed by a content hash of their inputs (``content_key``,
  the JAX package's key byte for byte on the same arrays), so a resumed
  run continues only the same computation;
- path-search keeps its per-segment MEP memo here;
- in a run over several ranks, what a store reads (``load``, ``has``) is
  rank 0's and is broadcast to the other ranks (``parallel.agree``),
  whose stores live in their private scratch trees: every rank resumes
  alike.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..parallel.distributed import agree


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def content_key(*arrays, extra: str = "") -> str:
    """16 hex digits of a SHA-256 over each array's shape and dtype
    header and its float64 bytes, then ``extra``: the same bytes under
    another shape, or split otherwise across the arguments, give another
    key."""
    h = hashlib.sha256()
    for a in arrays:
        a = _numpy(a).astype(np.float64, copy=False)
        h.update(f"|{a.shape}:{a.dtype}|".encode())
        h.update(np.ascontiguousarray(a))
    h.update(extra.encode())
    return h.hexdigest()[:16]


def save_state(store: "CheckpointStore", name: str, state,
               meta: Optional[Dict[str, Any]] = None) -> None:
    """Snapshot a NamedTuple-of-arrays engine state: the loop carry is
    the restart file."""
    arrays = {f: _numpy(getattr(state, f)) for f in state._fields}
    store.save(name, {**(meta or {}), "_fields": list(state._fields)},
               arrays)


def load_state(store: "CheckpointStore", name: str, cls,
               expect_key: Optional[str] = None):
    """A state saved by :func:`save_state` as (meta, state) with CPU
    tensors, or None: also when ``expect_key`` differs from the
    stored key (a different computation never resumes from a stale dump)
    or the fields differ."""
    rec = store.load(name)
    if rec is None:
        return None
    meta, arrays = rec
    if expect_key is not None and meta.get("key") != expect_key:
        return None
    if set(meta.get("_fields", [])) != set(cls._fields):
        return None
    state = cls(**{f: torch.as_tensor(arrays[f]) for f in cls._fields})
    return meta, state


class CheckpointStore:
    """A directory of ``<name>.json`` metadata and ``<name>.npz`` arrays."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _paths(self, name: str):
        return self.dir / f"{name}.json", self.dir / f"{name}.npz"

    def save(self, name: str, meta: Dict[str, Any],
             arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
        jp, ap = self._paths(name)
        if arrays:
            np.savez_compressed(ap, **{k: np.asarray(v)
                                       for k, v in arrays.items()})
        jp.write_text(json.dumps(meta, default=float))

    def load(self, name: str):
        """(meta, arrays) or None, as rank 0 reads them."""
        return agree(self._load(name))

    def _load(self, name: str):
        jp, ap = self._paths(name)
        if not jp.exists():
            return None
        meta = json.loads(jp.read_text())
        arrays = {}
        if ap.exists():
            with np.load(ap) as z:
                arrays = {k: z[k] for k in z.files}
        return meta, arrays

    def has(self, name: str) -> bool:
        return agree(self._paths(name)[0].exists())

    def delete(self, name: str) -> None:
        for p in self._paths(name):
            p.unlink(missing_ok=True)
