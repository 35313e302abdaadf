"""Profiling and per-phase accounting.

Counterpart of ``pdb2reaction_tpu/runtime/profiling.py``:

- ``trace(log_dir)``: a context manager that records a ``torch.profiler``
  trace (host activity, and the card's when there is one) of whatever
  runs inside it and writes it as a Chrome trace,
  ``<log_dir>/trace.json``; every CLI command takes ``--profile DIR``;
- ``ForceCallMeter``: wall time, force calls and energy calls per named
  phase, read from a calculator's ``force_calls`` / ``energy_calls``,
  with a report table. The calculator may be attached while a phase
  runs (``meter.calc = ...``): a phase that began without one counts
  from zero.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
    print(f"[profile] torch.profiler trace written to {out / 'trace.json'}")


class ForceCallMeter:
    """Per-phase wall time, force calls and energy calls."""

    def __init__(self, calc=None):
        self.calc = calc
        self.phases: Dict[str, Dict[str, float]] = {}

    def _counts(self):
        c = self.calc
        return (0, 0) if c is None else (c.force_calls, c.energy_calls)

    @contextlib.contextmanager
    def phase(self, name: str):
        f0, e0 = self._counts()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            f1, e1 = self._counts()
            acc = self.phases.setdefault(
                name, {"calls": 0, "energy_calls": 0, "seconds": 0.0})
            acc["calls"] += f1 - f0
            acc["energy_calls"] += e1 - e0
            acc["seconds"] += dt

    def report(self) -> str:
        lines = [f"{'phase':<24}{'force calls':>12}{'energy calls':>13}"
                 f"{'seconds':>10}{'calls/s':>10}"]
        for name, acc in self.phases.items():
            rate = acc["calls"] / acc["seconds"] if acc["seconds"] else 0.0
            lines.append(f"{name:<24}{acc['calls']:>12}"
                         f"{acc['energy_calls']:>13}"
                         f"{acc['seconds']:>10.2f}{rate:>10.1f}")
        total_c = sum(a["calls"] for a in self.phases.values())
        total_e = sum(a["energy_calls"] for a in self.phases.values())
        total_s = sum(a["seconds"] for a in self.phases.values())
        lines.append(f"{'TOTAL':<24}{total_c:>12}{total_e:>13}"
                     f"{total_s:>10.2f}"
                     f"{(total_c / total_s if total_s else 0):>10.1f}")
        return "\n".join(lines)
