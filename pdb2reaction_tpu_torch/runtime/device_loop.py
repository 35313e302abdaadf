"""Device loops: the counterpart of ``jax.lax.while_loop`` for this package.

``while_loop(cond, body, state)`` runs ``state <- body(state)`` while
``cond(state)`` holds, over a tuple of tensors. One cycle is the masked
update

    state <- where(cond(state), body(state), state)

so a cycle run after the stop changes nothing, bit for bit.

- On the CPU (the plain version) the masked cycle runs eagerly and
  ``cond`` is read after every cycle.
- On CUDA one cycle is captured into a ``torch.cuda.CUDAGraph`` and
  replayed. The state lives in static buffers that the cycle writes in
  place. Before the capture the cycle runs once on a side stream on a
  copy of the state (the warm-up), which builds the kernels, fills the
  constant tables and settles the cuBLAS handles. Replays read the flag
  lagged: after each replay a non-blocking copy of ``cond`` goes to
  pinned host memory and an event is recorded, and replay i + 2 is queued
  only once replay i's event has passed. The card always has the next
  cycle queued, and at most one cycle runs after the stop, as a no-op.
  A capture or replay error raises; nothing carries on eagerly on the card.

A cycle's host side effects (a force-call counter) run at warm-up and
capture only. Code inside a cycle registers them with ``per_cycle(fn)``:
outside a capture ``fn(1)`` runs at once; inside the warm-up it is
dropped; inside a capture it is kept, and after the replays the loop calls
``fn(n)`` with the n cycles that took effect. Kernel launch counters are
Python too and count at the warm-up and the capture only: ``Cycle.stats``
gives the launches a capture recorded and the replays, and a graph's
launches are the first times the second.

``Cycle`` is the building block: one masked cycle over given static
buffers, with ``run`` returning the cycles that took effect and the last
flags read. Several cycles may share the same buffers and one memory pool
(the GSM relaxation switches from a cycle without the Lanczos tangent to
one with it). ``while_loop`` caches its cycles by ``key``, as the JAX
package caches its jitted loops per closure and settings; ``clear_cache``
drops them and their graphs' memory.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# "warm" during a warm-up, "capture" during a capture, else None; the
# side effects a capture registered
_MODE: List[Optional[str]] = [None]
_HOOKS: List[List[Callable]] = [[]]
_CACHE: Dict[object, "Cycle"] = {}


def capturing() -> bool:
    """True while a cycle runs for its warm-up or its capture."""
    return _MODE[0] is not None


def per_cycle(fn: Callable[[int], None]) -> None:
    """Register the host side effect of one cycle: ``fn(n)`` does what n
    cycles do (module docstring)."""
    if _MODE[0] is None:
        fn(1)
    elif _MODE[0] == "capture":
        _HOOKS[0].append(fn)


@contextlib.contextmanager
def _mode(mode, hooks=None):
    _MODE[0] = mode
    _HOOKS[0] = hooks if hooks is not None else []
    try:
        yield
    finally:
        _MODE[0] = None
        _HOOKS[0] = []


def _launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count."""
    from ..mlip import escn_edge_kernel, escn_ffn_kernel, radial_contract
    return {**escn_edge_kernel.launches, **escn_ffn_kernel.launches,
            **radial_contract.launches, **radial_contract.rect_launches}


def _masked(cond, body, state):
    """The state after one masked cycle."""
    c = cond(state)
    new = body(state)
    if len(new) != len(state):
        raise ValueError(f"the body returned {len(new)} tensors for a state "
                         f"of {len(state)}")
    return tuple(torch.where(c, n, s) for n, s in zip(new, state))


class Cycle:
    """One masked cycle ``state <- where(cond(state), body(state),
    state)`` over the static buffers ``state`` (written in place).
    ``flags(state)`` -> bool [k] is read after every cycle; the loop stops
    when its first entry is False (default: ``cond`` alone). On CUDA the
    cycle is captured at construction, into ``pool`` when given."""

    def __init__(self, cond: Callable, body: Callable,
                 state: Sequence[torch.Tensor], *,
                 flags: Optional[Callable] = None, pool=None):
        self.cond, self.body = cond, body
        self.flags = flags or (lambda st: cond(st).reshape(1))
        self.state = tuple(state)
        self.cuda = self.state[0].is_cuda
        self.replays = 0          # every replay, no-op cycles included
        self.effective = 0        # cycles that took effect
        self.launches: Dict[str, int] = {}
        self.capture_ms = 0.0
        if self.cuda:
            self._capture(pool)

    def _capture(self, pool) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), _mode("warm"):
            copy = tuple(t.clone() for t in self.state)
            self.flags(_masked(self.cond, self.body, copy))
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        del copy
        hooks: List[Callable] = []
        before = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with _mode("capture", hooks), torch.cuda.graph(self.graph,
                                                       pool=pool):
            new = _masked(self.cond, self.body, self.state)
            for buf, t in zip(self.state, new):
                buf.copy_(t)
            del new
            self.flag_buf = self.flags(self.state)
        self.hooks = hooks
        self.launches = {k: v - before[k] for k, v in
                         _launch_counts().items() if v != before[k]}
        self.pinned = [torch.empty(self.flag_buf.shape, dtype=torch.bool,
                                   pin_memory=True) for _ in range(2)]
        self.events = [torch.cuda.Event() for _ in range(2)]
        torch.cuda.synchronize()
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def pool(self):
        """The memory pool of the captured graph (CUDA)."""
        return self.graph.pool()

    def read_flags(self) -> List[bool]:
        """``flags`` of the current state, read on the host."""
        return [bool(f) for f in self.flags(self.state).tolist()]

    def _queue(self, i: int) -> None:
        self.graph.replay()
        self.pinned[i % 2].copy_(self.flag_buf, non_blocking=True)
        self.events[i % 2].record()

    def run(self, first: Optional[List[bool]] = None) \
            -> Tuple[int, List[bool]]:
        """Cycles until the first flag is False: (the cycles that took
        effect, the last flags read). ``first``: the flags of the current
        state when the caller read them already."""
        f = first if first is not None else self.read_flags()
        if not f[0]:
            return 0, f
        if not self.cuda:
            n = 0
            while f[0]:
                new = _masked(self.cond, self.body, self.state)
                for buf, t in zip(self.state, new):
                    buf.copy_(t)
                n += 1
                f = self.read_flags()
            self.effective += n
            return n, f
        self._queue(0)
        self._queue(1)
        n, i = 1, 0
        while True:
            self.events[i % 2].synchronize()
            f = [bool(x) for x in self.pinned[i % 2].tolist()]
            if not f[0]:
                break
            n += 1
            self._queue(i + 2)
            i += 1
        # replay i + 1 is queued and runs as a no-op
        self.replays += i + 2
        self.effective += n
        for hook in self.hooks:
            hook(n)
        return n, f

    def stats(self) -> Dict[str, object]:
        """Replays, cycles that took effect, the launches one capture
        recorded and the capture's ms (warm-up included)."""
        return {"replays": self.replays, "effective": self.effective,
                "launches": dict(self.launches),
                "capture_ms": self.capture_ms}


def while_loop(cond: Callable, body: Callable,
               state: Sequence[torch.Tensor], *, key=None,
               pool=None) -> Tuple[torch.Tensor, ...]:
    """``state <- body(state)`` while ``cond(state)`` (module docstring);
    returns the final state as new tensors. ``key`` caches the captured
    cycle (CUDA): a later call with the same key copies its state into
    the cycle's buffers and replays the same graph, so the key must name
    everything the cycle captured (closures, settings, shapes)."""
    state = tuple(state)
    cyc = _CACHE.get(key) if key is not None else None
    if cyc is None:
        cyc = Cycle(cond, body, tuple(t.clone() for t in state), pool=pool)
        if key is not None and cyc.cuda:
            _CACHE[key] = cyc
    else:
        for buf, t in zip(cyc.state, state):
            buf.copy_(t)
    cyc.run()
    return tuple(t.clone() for t in cyc.state)


def cached(key) -> Optional[object]:
    """The object cached under ``key``, or None."""
    return _CACHE.get(key)


def cache(key, value) -> None:
    """Cache ``value`` (a ``Cycle``, or an object whose ``cycles()`` gives
    its cycles) under ``key``."""
    _CACHE[key] = value


def cycles() -> List[Cycle]:
    """Every cached cycle."""
    out = []
    for v in _CACHE.values():
        out += [v] if isinstance(v, Cycle) else list(v.cycles())
    return out


def clear_cache() -> None:
    """Drop every cached cycle and its graph's memory."""
    _CACHE.clear()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
