"""KV-router wire protocols, a copy of ``dynamo_tpu/llm/kv_router/protocols.py``.

``ForwardPassMetrics`` (a worker's load snapshot, read from its stats
reply), ``KvCacheEventWire`` (Stored/Removed block updates on the bus)
and the hit-rate event of each routing decision. ``from_dict`` takes any
engine's ``stats()`` dict: the JAX engine's and ``TorchEngine``'s, whose
keys differ (``TorchEngine`` adds ``memory``, lacks some counters);
unknown keys are ignored and missing ones keep their defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

KV_EVENT_SUBJECT = "kv_events"       # published under <ns>.<component>.
KV_HIT_RATE_SUBJECT = "kv-hit-rate"  # router observability events


@dataclass
class ForwardPassMetrics:
    """Per-worker load snapshot: the reference's fields, names and
    defaults (replica identity, role, latency histograms, drain flag,
    slots and blocks, prefix-cache counters, KV tiers, speculative
    decoding, the capture fence, the transfer plane, profiler output)."""

    worker_label: str = ""
    mesh_shape: str = ""
    mesh_devices: int = 1
    # prefill|decode|unified: the scheduler never routes token requests
    # to a prefill-role worker
    role: str = "unified"
    latency_hist: dict = field(default_factory=dict)
    # 1 while the worker drains: the scheduler offers it nothing new
    draining: int = 0
    request_active_slots: int = 0
    request_total_slots: int = 0
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    num_requests_waiting: int = 0
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hit_rate: float = 0.0
    gpu_prefix_cache_hit_rate_lifetime: float = 0.0
    prefix_hit_tokens_total: int = 0
    prompt_tokens_total: int = 0
    cache_device_hit_blocks_total: int = 0
    cache_host_restored_blocks_total: int = 0
    cache_fresh_blocks_total: int = 0
    cache_evict_offloaded_total: int = 0
    cache_evict_dropped_total: int = 0
    cache_evict_age_seconds_total: float = 0.0
    cache_host_evictions_total: int = 0
    cache_restore_queue_depth: int = 0
    cache_restores_drained_total: int = 0
    cache_restore_wait_seconds_total: float = 0.0
    cache_restore_batches_total: int = 0
    cache_restore_batch_pages_total: int = 0
    spec_decode_acceptance_rate: float = 0.0
    spec_decode_mean_accepted_len: float = 0.0
    # captures after warmup (the JAX engine counts compiles)
    post_warmup_compiles_total: int = 0
    kv_transfer_bytes_total: int = 0
    kv_transfer_chunks_total: int = 0
    kv_transfer_inject_seconds_total: float = 0.0
    kv_transfer_streams_failed_total: int = 0
    remote_prefill_wait_seconds_total: float = 0.0
    queue_wait_seconds_total: float = 0.0
    kv_free_blocks: int = 0
    kv_cached_blocks: int = 0
    host_free_blocks: int = 0
    host_cache_usage_perc: float = 0.0
    host_offload_pages_total: int = 0
    host_restore_pages_total: int = 0
    long_prefills_total: int = 0
    loop_lag_p50_seconds: float = 0.0
    loop_lag_p99_seconds: float = 0.0
    device_time_fraction: float = 0.0
    profiled_steps_total: int = 0
    batch_dispatches_total: int = 0
    bucket_cost: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, d: dict) -> "ForwardPassMetrics":
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class KvCacheEventWire:
    """Stored/Removed event as published on the bus (reference
    protocols.rs KvCacheEvent + the worker id tag added on receive)."""

    worker_id: int
    kind: str                        # "stored" | "removed"
    block_hashes: List[int]
    parent_hash: Optional[int] = None

    def to_dict(self) -> dict:
        return {"worker_id": self.worker_id, "kind": self.kind,
                "block_hashes": self.block_hashes,
                "parent_hash": self.parent_hash}

    @classmethod
    def from_dict(cls, d: dict) -> "KvCacheEventWire":
        return cls(worker_id=d["worker_id"], kind=d["kind"],
                   block_hashes=list(d["block_hashes"]),
                   parent_hash=d.get("parent_hash"))


@dataclass
class KVHitRateEvent:
    """Per-decision observability event (reference scheduler.rs:27-32)."""

    worker_id: int
    isl_blocks: int
    overlap_blocks: int

    def to_dict(self) -> dict:
        return dict(self.__dict__)
