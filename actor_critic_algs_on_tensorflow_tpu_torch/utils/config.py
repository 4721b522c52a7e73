"""Dataclass configs with ``key=value`` overrides.

Counterpart of the JAX package's ``utils/config.py``, kept as its own
copy so the port imports nothing of the JAX package: the same coercion
rules, so a ``--set`` override written for the JAX CLI works verbatim
on the port's configs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple


def _field_types(cls) -> dict:
    return {f.name: f.type for f in dataclasses.fields(cls)}


def _coerce(raw: str, current: Any) -> Any:
    """Coerce a CLI string to the type of the current field value."""
    if isinstance(current, bool):
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot parse bool from {raw!r}")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        if raw.strip() == "":
            return ()
        parts = raw.split(",")
        if current:
            return tuple(type(current[0])(p) for p in parts)
        try:
            return tuple(int(p) for p in parts)
        except ValueError:
            return tuple(float(p) for p in parts)
    if isinstance(current, str):
        return raw if raw.lower() != "none" else None
    if current is None:
        # No runtime type to coerce from: infer int -> float -> bool ->
        # str from the raw text so Optional[int/float] fields work.
        if raw.lower() == "none":
            return None
        for parse in (int, float):
            try:
                return parse(raw)
            except ValueError:
                pass
        if raw.lower() in ("true", "false"):
            return raw.lower() == "true"
        return raw
    raise ValueError(f"unsupported config field type {type(current)}")


def apply_overrides(cfg, overrides: Tuple[str, ...]):
    """Apply ``key=value`` strings to a (possibly nested) dataclass.

    Nested fields use dots: ``env.num_envs=16``.
    """
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, raw = item.split("=", 1)
        cfg = _set_path(cfg, key.split("."), raw)
    return cfg


def _set_path(cfg, path, raw):
    name = path[0]
    if not hasattr(cfg, name):
        raise KeyError(
            f"{type(cfg).__name__} has no field {name!r}; "
            f"valid: {sorted(_field_types(type(cfg)))}"
        )
    current = getattr(cfg, name)
    if len(path) == 1:
        if dataclasses.is_dataclass(current):
            raise ValueError(
                f"{name!r} is a nested config; set a field inside it, "
                f"e.g. {name}.{dataclasses.fields(current)[0].name}=..."
            )
        return dataclasses.replace(cfg, **{name: _coerce(raw, current)})
    return dataclasses.replace(cfg, **{name: _set_path(current, path[1:], raw)})

