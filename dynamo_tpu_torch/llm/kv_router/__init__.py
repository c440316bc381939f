"""KV-cache-aware routing: events, index, scheduler, router."""

from .indexer import KvIndexer, OverlapScores, RadixTree
from .protocols import (ForwardPassMetrics, KVHitRateEvent, KvCacheEventWire,
                        KV_EVENT_SUBJECT, KV_HIT_RATE_SUBJECT)
from .publisher import KvEventPublisher
from .router import KvRouter
from .scheduler import KvScheduler, WorkerState
