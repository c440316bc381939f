"""Environment-variable registry and typed readers.

A copy of the reading half of ``dynamo_tpu/runtime/config.py`` and of
its ``RuntimeConfig``: every knob the port reads is declared here with a
default, an owning component and a description, and read through the
typed ``env_*`` helpers. Reading a name that was never registered raises
:class:`UnregisteredEnvVar`.
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
register_env("DYN_CACHE_WINDOW", "256", "engine",
             "Admissions in the windowed prefix-hit-rate window: "
             "stats()['gpu_prefix_cache_hit_rate'] is the hit tokens over "
             "the prompt tokens of the last N admissions; the lifetime "
             "ratio and the token totals ride beside it.")
register_env("DYN_PROFILE_DIR", None, "run",
             "The launcher's default --profile-dir: write a torch.profiler "
             "Chrome trace of the session into this directory.")
register_env("DYN_MESH_SHAPE", None, "parallel",
             "The launcher's default --mesh-shape (a replica's mesh as "
             "axis=N pairs). Replica sets are not ported: any value is "
             "refused.")
register_env("DYN_DP_REPLICAS", "1", "parallel",
             "The launcher's default --dp-replicas. Replica sets are not "
             "ported: any value but 1 is refused.")
register_env("DYN_DCP_ADDRESS", None, "runtime",
             "host:port of the DCP control plane. Unset: the launcher "
             "embeds an in-process server; CLIs fall back to "
             "127.0.0.1:6650.")
register_env("DYN_LEASE_TTL", "10.0", "runtime",
             "Primary-lease TTL in seconds (worker liveness).")
register_env("DYN_IO_TIMEOUT", "30.0", "runtime",
             "Bound (seconds) on single network IO steps: connects, "
             "handshakes, socket-buffer drains.")
register_env("DYN_REQUEST_TIMEOUT", "60.0", "runtime",
             "Default request-plane timeout in seconds (the worker's ack).")
register_env("DYN_STATS_TIMEOUT", "2.0", "runtime",
             "Per-instance stats-plane scrape probe timeout in seconds.")
register_env("DYN_TCP_ADVERTISE_HOST", None, "runtime",
             "Address the response-stream listener advertises to workers "
             "calling home. Unset = the bind host, or 127.0.0.1 when it "
             "binds every interface; set a routable address for workers "
             "on other hosts.")
register_env("DYN_BREAKER_THRESHOLD", "3", "runtime",
             "Circuit breakers: consecutive failures that flip an "
             "endpoint's breaker closed->open.")
register_env("DYN_BREAKER_PROBE_EVERY", "5", "runtime",
             "Circuit breakers: an OPEN breaker offers a single half-open "
             "probe every Nth denied call.")
register_env("DYN_BREAKER_RESET_S", "0", "runtime",
             "Circuit breakers: also offer the half-open probe once this "
             "many seconds have passed since opening (0 = count only).")
register_env("DYN_RETRY_MAX_ATTEMPTS", "3", "runtime",
             "RetryPolicy: total attempts (first try included) for route "
             "resolution and stats scrapes. Retries never run past the "
             "request deadline.")
register_env("DYN_RETRY_BASE_MS", "50", "runtime",
             "RetryPolicy: decorrelated-jitter backoff base in ms.")
register_env("DYN_RETRY_CAP_MS", "2000", "runtime",
             "RetryPolicy: backoff ceiling in ms.")
register_env("DYN_WIRE_VALIDATE", "0", "runtime",
             "Debug mode: validate every wire frame against the "
             "runtime/wire.py registry at encode/decode time (1/true).")
register_env("DYN_KV_TRANSFER_CHUNK_PAGES", "4", "llm/disagg",
             "KV pages per streamed transfer chunk frame; 0 = legacy "
             "single bulk frame.")
register_env("DYN_KV_TRANSFER_INT8", "0", "llm/disagg",
             "int8-compress shipped KV pages (~half the bytes; lossy). "
             "1/true enables.")
register_env("DYN_PREFILL_TIMEOUT", "120.0", "llm/disagg",
             "Decode-side cap (seconds) on one remote-prefill wait "
             "(enqueue to KV commit); the request deadline caps it "
             "further. On expiry the request falls back to local "
             "prefill.")
register_env("DYN_REDISPATCH_MAX", "2", "llm/disagg",
             "Max remote-prefill dispatches per request (first + hedged "
             "re-enqueues after a fast transfer-plane failure, e.g. a "
             "prefill worker dying mid-transfer). 1 disables hedging.")
register_env("DYN_MOE_BLOCK", "256", "models",
             "Row height of the blocks of the sorted MoE dispatch "
             "(models/llama.py moe_experts_blocked); also the padding "
             "quantum of each expert's group in its cost model.")
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


def env_float(name: str, default: Optional[float] = None
              ) -> Optional[float]:
    val = env_str(name, None if default is None else str(default))
    return None if val is None or val == "" else float(val)


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


@dataclass
class RuntimeConfig:
    """The distributed runtime's settings, from the environment (the
    reference also reads a ``DYN_CONFIG_PATH`` overlay file; the port
    reads the environment only)."""

    dcp_address: Optional[str] = None       # DYN_DCP_ADDRESS; None = embedded
    lease_ttl: float = 10.0                 # DYN_LEASE_TTL

    @classmethod
    def from_settings(cls) -> "RuntimeConfig":
        return cls(dcp_address=env_str("DYN_DCP_ADDRESS"),
                   lease_ttl=env_float("DYN_LEASE_TTL"))
