"""Layered configuration: defaults ← TOML file ← environment.

A trimmed copy of ``dynamo_tpu/utils/config.py`` (the reference's
figment-based config stack, lib/runtime/src/config.rs:26-103), holding the
two structs the runtime reads. Each resolves as

  1. dataclass field defaults,
  2. a TOML file — path from ``DYN_CONFIG_PATH`` (section per struct),
  3. environment variables ``{ENV_PREFIX}_{FIELD}`` (upper-cased field
     name), e.g. ``DYN_RUNTIME_HUB_URL=10.0.0.1:18500``.

Later layers win. Values from TOML/env are coerced to the annotated field
type (int/float/bool/str); booleans accept 1/0/true/false/yes/no.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
import typing
from typing import Any, Optional, Type, TypeVar

CONFIG_PATH_ENV = "DYN_CONFIG_PATH"

T = TypeVar("T")

_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off"}


def _coerce(value: Any, ty: Any) -> Any:
    origin = typing.get_origin(ty)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(ty) if a is not type(None)]
        if value is None:
            return None
        ty = args[0] if args else str
    if ty is bool:
        if isinstance(value, bool):
            return value
        s = str(value).strip().lower()
        if s in _TRUTHY:
            return True
        if s in _FALSY:
            return False
        raise ValueError(f"not a boolean: {value!r}")
    if ty in (int, float, str):
        return ty(value)
    return value


def _toml_section(section: str, path: Optional[str]) -> dict:
    path = path or os.environ.get(CONFIG_PATH_ENV)
    if not path or not os.path.exists(path):
        return {}
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    out = doc
    for part in section.split(".") if section else []:
        out = out.get(part, {})
        if not isinstance(out, dict):
            return {}
    return out


def load_config(
    cls: Type[T],
    *,
    section: str,
    env_prefix: str,
    toml_path: Optional[str] = None,
    overrides: Optional[dict] = None,
) -> T:
    """Resolve ``cls`` (a dataclass) through the defaults→TOML→env layers.

    ``overrides`` (explicit kwargs, e.g. CLI flags) are the final layer.
    Unknown keys in the TOML section are ignored; unknown env vars are not
    scanned (only annotated fields are looked up).
    """
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls!r} is not a dataclass")
    values: dict[str, Any] = {}
    file_layer = _toml_section(section, toml_path)
    hints = typing.get_type_hints(cls)
    for field in dataclasses.fields(cls):
        ty = hints.get(field.name, str)
        if field.name in file_layer:
            values[field.name] = _coerce(file_layer[field.name], ty)
        env_key = f"{env_prefix}_{field.name.upper()}"
        if env_key in os.environ:
            values[field.name] = _coerce(os.environ[env_key], ty)
    if overrides:
        for k, v in overrides.items():
            if v is not None:
                values[k] = v
    return cls(**values)


@dataclasses.dataclass
class RuntimeConfig:
    """Process runtime knobs (ref config.rs RuntimeConfig — its
    max_blocking_threads maps to the asyncio default-executor pool used for
    blocking work: tokenize, host staging IO; its num_worker_threads has no
    asyncio analog, the event loop is single-threaded by design)."""

    max_blocking_threads: int = 16
    hub_url: str = ""  # "" = in-process store/bus; "host:port" = TCP hub
    response_host: str = "127.0.0.1"

    @classmethod
    def from_settings(cls, **overrides) -> "RuntimeConfig":
        return load_config(
            cls, section="runtime", env_prefix="DYN_RUNTIME", overrides=overrides
        )


@dataclasses.dataclass
class WorkerConfig:
    """Worker main() knobs (ref worker.rs + config.rs DYN_WORKER_*)."""

    graceful_shutdown_timeout: float = 30.0

    @classmethod
    def from_settings(cls, **overrides) -> "WorkerConfig":
        return load_config(
            cls, section="worker", env_prefix="DYN_WORKER", overrides=overrides
        )
