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
register_env("DYN_EVICT_POLICY", "cost", "engine",
             "KV eviction policy of both cache tiers "
             "(EngineConfig.evict_policy=None reads this): 'cost' runs "
             "GreedyDual over the hot-prefix hit table, so a hot shared "
             "prefix outlives one-shot churn; 'lru' evicts the "
             "least-recently-freed page.")
register_env("DYN_RESTORE_OVERLAP", "1", "engine",
             "Pipeline host-tier restores: a drained batch's host-to-device "
             "copy and dequantize are enqueued on one drain and its page "
             "inject lands on the next, overlapping the step between; 0 "
             "injects in the same drain. EngineConfig.restore_overlap=None "
             "reads this.")
register_env("DYN_HOST_TIER_FP16", "0", "engine",
             "Keep the host KV tier at the pool's dtype instead of the int8 "
             "default (engine/kv_compress.py): int8 halves the copied bytes "
             "but restored pages round-trip lossily; 1 restores them "
             "bitwise. An explicit EngineConfig.host_tier_int8 wins.")
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


# the frontend's operator planes (tracing, logging, SLO, profiling, the
# flight recorder, admission, drain and deadlines) and the engine's
# step timeline and cache view
register_env("DYN_BLACKBOX_COOLDOWN_S", "60", "runtime",
             "dynablack incident flight recorder: debounce (seconds) "
             "between persisted captures — a trigger storm (breaker "
             "flapping, repeated stalls) produces one bundle per "
             "cooldown window, not one per event. Manual captures "
             "inside the window answer 409 with Retry-After.")
register_env("DYN_BLACKBOX_DIR", None, "runtime",
             "dynablack: directory incident bundles are persisted into "
             "(one incident-<id>.json per capture). Unset = bundles are "
             "kept in the bounded in-memory incident table only "
             "(GET /debug/incidents).")
register_env("DYN_BLACKBOX_TRIGGERS", "all", "runtime",
             "dynablack: comma-separated trigger allowlist out of "
             "slo_burn_rate,breaker_open,post_warmup_compile,"
             "watchdog_stall,failover_resume,deadline_storm,manual — "
             "'all' (default) arms every trigger; 'manual' keeps only "
             "POST /debug/incidents/capture.")
register_env("DYN_BLACKBOX_WINDOW_S", "30", "runtime",
             "dynablack: how many seconds of shadow-ring telemetry an "
             "incident bundle folds in (trace spans, step-timeline "
             "events and shadow-ring entries older than the window are "
             "dropped at capture time). 0 disables the flight recorder "
             "entirely — no shadow rings, no triggers, no captures "
             "(the hot-path A/B control arm).")
register_env("DYN_DRAIN_TIMEOUT_MS", "10000", "runtime",
             "dynarevive graceful drain: bound (ms) on finishing "
             "in-flight sequences after a worker receives SIGTERM or "
             "POST /drain — discovery record deleted first (no new "
             "admissions), KV events flushed, then the lease releases. "
             "On expiry leftover requests are killed.")
register_env("DYN_LOG", "INFO", "runtime",
             "Root log level (DEBUG/INFO/WARNING/...).")
register_env("DYN_LOGGING_JSONL", "0", "runtime",
             "Emit JSONL structured logs instead of text (1/true).")
register_env("DYN_PROF_ATTR_RING", "2048", "runtime",
             "dynaprof: per-request cost-attribution ring capacity "
             "(finished-request attribution dicts kept per process for "
             "/v1/traces/{request_id} and the usage extension block).")
register_env("DYN_PROF_LOOP_INTERVAL_MS", "100", "runtime",
             "dynaprof: event-loop lag-monitor sampling interval in ms "
             "(the sleep whose wakeup drift is measured).")
register_env("DYN_PROF_STACKS", "256", "runtime",
             "dynaprof: max distinct folded stacks the stall watchdog "
             "keeps (new shapes past the cap are counted as dropped).")
register_env("DYN_PROF_STALL_MS", "250", "runtime",
             "dynaprof: loop-callback overrun (ms) past which the stall "
             "watchdog captures the event-loop thread's Python stack "
             "into the flamegraph ring; 0 disables the watchdog thread.")
register_env("DYN_REQUEST_DEADLINE_MS", "0", "runtime",
             "Default end-to-end request deadline in milliseconds, "
             "applied at the HTTP frontend when the request carries "
             "neither a `timeout` body field nor an X-Request-Deadline-Ms "
             "header. 0 = no implicit deadline.")
register_env("DYN_SHED_KV_FREE_BLOCKS", "0", "runtime",
             "dynarevive admission control: shed (early 503) when the "
             "worst worker's free KV blocks drop to/below this floor. "
             "0 disables the signal.")
register_env("DYN_SHED_LOOP_LAG_MS", "0", "runtime",
             "dynarevive admission control: shed when the worst "
             "worker's event-loop lag p99 exceeds this many ms. "
             "0 disables the signal.")
register_env("DYN_SHED_QUEUE_DEPTH", "0", "runtime",
             "dynarevive admission control: shed when the summed "
             "admission-queue depth exceeds this many waiting requests "
             "PER live worker. 0 disables the signal (the default "
             "frontend sheds on nothing until configured).")
register_env("DYN_SHED_RETRY_CAP_S", "8", "runtime",
             "dynarevive admission control: ceiling (seconds) on the "
             "load-derived, jittered Retry-After answered with shed / "
             "no-capacity 503s.")
register_env("DYN_SLO_BURN_THRESHOLD", "2.0", "runtime",
             "dynaslo: error-budget burn rate BOTH the fast and slow "
             "windows must exceed before an objective's multi-window "
             "alert fires (1.0 = spending exactly the budget).")
register_env("DYN_SLO_FAST_FRACTION", "0.1", "runtime",
             "dynaslo: the fast alert window as a fraction of each "
             "objective's window (SRE multi-window burn-rate pattern: "
             "the fast window catches the spike, the slow window proves "
             "it is sustained).")
register_env("DYN_SLO_FILE", None, "runtime",
             "dynaslo: path to a file of SLO objectives, one per line "
             "('#' comments), same grammar as DYN_SLO_OBJECTIVES. "
             "Ignored when DYN_SLO_OBJECTIVES is set.")
register_env("DYN_SLO_OBJECTIVES", None, "runtime",
             "dynaslo: ';'-separated SLO objectives, grammar "
             "[name=]metric<=threshold_s@target/window_s over metrics "
             "ttft|itl|queue_wait|e2e — e.g. 'ttft<=0.5@0.95/300;"
             "itl<=0.05@0.99/300'. Unset = no objectives (latency "
             "histograms still recorded and rendered).")
register_env("DYN_CHAOS", None, "runtime",
             "Chaos-injection scenario for the real transports and the "
             "worker, e.g. 'seed=42;sever:kv.send@after=1;"
             "delay:tcp.send@ms=50,p=0.2' (grammar in runtime/guard.py). "
             "Unset = no chaos.")
register_env("DYN_PROTO_VALIDATE", "0", "runtime",
             "Debug mode: validate every proto.step(...) lifecycle "
             "anchor against the runtime/proto.py protocol registry at "
             "transition time (1/true). Default off: an anchor is then "
             "a no-op.")
register_env("DYN_REVIVE_JOURNAL_TOKENS", "4096", "runtime",
             "Mid-stream failover: per-request bound on journaled "
             "emitted tokens (the resume prompt is prompt + journal, so "
             "past this bound the request is marked non-resumable "
             "rather than resumed with a truncated prompt).")
register_env("DYN_REVIVE_MAX", "2", "runtime",
             "Mid-stream failover: max re-dispatches per request after "
             "an upstream worker dies before its finish chunk (0 "
             "disables failover: the stream errors).")
register_env("DYN_REVIVE_RING", "2048", "runtime",
             "Mid-stream failover: max concurrent journal entries kept "
             "per process (one per in-flight request; eviction only "
             "costs the evicted request its resumability).")
register_env("DYN_STEP_TIMELINE", "512", "runtime",
             "Engine step-timeline ring capacity (events kept per engine "
             "for /v1/traces); 0 disables the timeline.")
register_env("DYN_TRACE_JSONL", None, "runtime",
             "Path to append one JSON line per finished trace span "
             "(dyntrace export; unset = in-memory ring only).")
register_env("DYN_TRACE_RING", "4096", "runtime",
             "dyntrace in-memory ring capacity (finished spans kept per "
             "process for /v1/traces).")
register_env("DYN_TRACE_SAMPLE", "1.0", "runtime",
             "dyntrace sampling rate in [0,1], decided per root span "
             "(children follow their parent). 0 disables all tracing "
             "instrumentation (no spans, no envelope fields).")
register_env("DYN_CACHE_TOPK", "20", "engine",
             "dynacache: hot prefix chains reported per engine in "
             "GET /debug/cache (top-K cached block hashes by reuse "
             "count; internal tracking stays bounded regardless).")
register_env("DYN_ROUTER_AUTOTUNE", "1", "llm",
             "Self-tune KvScheduler.load_balance_weight from the router's "
             "predicted-vs-realized overlap calibration error: "
             "over-prediction (a stale or optimistic index) shifts weight "
             "toward load, under-prediction toward overlap. Bounded to "
             "[0.1, 0.9] and exported as the "
             "dyn_kv_router_load_balance_weight gauge; 0 pins the "
             "configured weight.")
register_env("DYN_ROUTER_AUTOTUNE_GAIN", "0.05", "llm",
             "Per-window step size of the load_balance_weight autotuner "
             "(fraction of the bounded range moved per calibration "
             "window at full bias); 0 observes without adjusting.")


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
