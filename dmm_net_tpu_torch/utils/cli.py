"""CLI helpers: dot-path config overrides (a copy of the JAX package's
utils/cli.py)."""

from __future__ import annotations

from typing import Dict, Iterable


def parse_overrides(pairs: Iterable[str] | None) -> Dict[str, object]:
    """Parse ["a.b=1", "c.d=x"] into {"a.b": 1, "c.d": "x"} with
    int/float/bool coercion."""
    out: Dict[str, object] = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        parsed: object = v
        if v in ("true", "True"):
            parsed = True
        elif v in ("false", "False"):
            parsed = False
        elif "," in v:
            # tuple values, e.g. model.image_size=64,64
            parsed = tuple(int(x) if x.strip().isdigit() else float(x)
                           for x in v.split(",") if x.strip())
        else:
            for cast in (int, float):
                try:
                    parsed = cast(v)
                    break
                except ValueError:
                    continue
        out[k] = parsed
    return out
