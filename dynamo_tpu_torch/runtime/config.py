"""Environment-variable registry and typed readers.

A copy of the reading half of ``dynamo_tpu/runtime/config.py``: every
knob the port reads is declared here with a default, an owning component
and a description, and read through the typed ``env_*`` helpers. Reading
a name that was never registered raises :class:`UnregisteredEnvVar`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class EnvVar:
    """One registered environment knob."""

    name: str
    default: Optional[str]
    component: str
    description: str


ENV_REGISTRY: Dict[str, EnvVar] = {}


class UnregisteredEnvVar(KeyError):
    """An env read named a variable that was never registered."""


def register_env(name: str, default: Optional[str], component: str,
                 description: str) -> str:
    ENV_REGISTRY[name] = EnvVar(name, default, component, description)
    return name


register_env("DYN_TORCH_KERNEL_BUILD_DIR", None, "ops",
             "Directory the CUDA kernels are compiled into on first use. "
             "Unset = dynamo_tpu_torch/ops/_build inside the checkout.")
register_env("DYN_TORCH_NVCC", None, "ops",
             "Path of the nvcc that builds the CUDA kernels. Unset = nvcc "
             "on PATH, else /usr/local/cuda/bin/nvcc.")
register_env("DYN_JIT_FENCE", None, "engine",
             "Reaction to a CUDA-graph capture after warmup: unset = count "
             "only (stats post_warmup_compiles_total), 'warn' = also log, "
             "'raise' = raise PostWarmupCompileError.")
register_env("DYN_ASYNC_DETOK", "1", "llm",
             "Run Backend detokenization on a shared two-thread executor "
             "instead of the event-loop thread. Chunks of one request stay "
             "ordered (at most one decode in flight a request); 0 decodes "
             "inline.")
register_env("HF_HUB_OFFLINE", "1", "external",
             "Set by dynamo_tpu_torch.llm.tokenizer unless already present: "
             "never hit the HuggingFace hub at serve time.")
register_env("TRANSFORMERS_OFFLINE", "1", "external",
             "Set alongside HF_HUB_OFFLINE for the transformers library.")


def _lookup(name: str) -> EnvVar:
    var = ENV_REGISTRY.get(name)
    if var is None:
        raise UnregisteredEnvVar(
            f"env var {name!r} is not registered; declare it in "
            f"dynamo_tpu_torch/runtime/config.py (register_env)")
    return var


def env_str(name: str, default: Optional[str] = None, *,
            required: bool = False) -> Optional[str]:
    """The registered variable's value, else the explicit ``default``,
    else the registry default. ``required=True`` raises when unset."""
    var = _lookup(name)
    val = os.environ.get(name)
    if val is None:
        val = default if default is not None else var.default
    if val is None and required:
        raise KeyError(f"required env var {name} is not set")
    return val


def env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    val = env_str(name, None if default is None else str(default))
    return None if val is None else int(val)


def env_bool(name: str, default: bool = False) -> bool:
    """Truthy string values: 1/true/yes/on (case-insensitive)."""
    val = env_str(name)
    if val is None or val == "":
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def env_flag(name: str) -> bool:
    """DYN_DISABLE_* style switches: ANY non-empty value (even '0')
    enables the flag."""
    _lookup(name)
    return bool(os.environ.get(name))


def env_set_default(name: str, value: str) -> None:
    """Registered setdefault (import-time offline pins and the like)."""
    _lookup(name)
    os.environ.setdefault(name, value)
