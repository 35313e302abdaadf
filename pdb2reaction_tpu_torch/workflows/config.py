"""Config helpers the ported workflows need: choice aliases
(light -> lbfgs, heavy -> rfo), elapsed-time formatting and the echo
block printed at the start of a run."""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Iterable, Mapping, Optional

_ALIASES = {
    "light": "lbfgs",
    "heavy": "rfo",
}


def normalize_choice(value: Optional[str],
                     choices: Optional[Iterable[str]] = None
                     ) -> Optional[str]:
    if value is None:
        return None
    v = str(value).strip().lower()
    v = _ALIASES.get(v, v)
    if choices is not None and v not in set(choices):
        raise ValueError(f"Invalid choice {value!r}; allowed: "
                         f"{sorted(set(choices))}")
    return v


def pretty_block(title: str, cfg: Mapping[str, Any]) -> str:
    """A titled ``key: value`` block echoing a run's settings."""
    def plain(v):
        if isinstance(v, Path):
            return str(v)
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        return v

    body = "".join(f"{k}: {plain(v)}\n" for k, v in cfg.items())
    bar = "-" * max(len(title), 8)
    return f"{bar}\n{title}\n{bar}\n{body}"


def format_elapsed(t_start: float, t_end: Optional[float] = None) -> str:
    dt = (t_end if t_end is not None else time.time()) - t_start
    h = int(dt // 3600)
    m = int((dt % 3600) // 60)
    s = dt % 60
    return f"{h:02d}:{m:02d}:{s:06.3f}"
