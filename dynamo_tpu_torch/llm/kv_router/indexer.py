"""Global KV-cache radix index, a copy of the Python backend of
``dynamo_tpu/llm/kv_router/indexer.py``.

A prefix tree over chained block hashes recording which workers hold
which cached blocks. ``find_matches`` walks a request's block-hash chain
and returns per-worker overlap scores; ``apply_event`` ingests worker
Stored/Removed events. The asyncio event loop gives the tree its single
writer.

Block hashes are the engine's chained xxh3 hashes
(``engine/kv_manager.py chain_hashes``, the reference's construction and
seed), so an index fed by port workers and one fed by JAX workers hold
the same hashes for the same tokens. The reference's C++ index
(``native_indexer.py``) is not part of the port.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from ...engine.kv_manager import chain_hashes
from .protocols import KvCacheEventWire


@dataclass
class OverlapScores:
    """worker id -> number of matched prefix blocks."""

    scores: Dict[int, int] = field(default_factory=dict)

    def best(self) -> int:
        return max(self.scores.values(), default=0)


class _Node:
    __slots__ = ("block_hash", "parent", "children", "workers")

    def __init__(self, block_hash: int, parent: Optional["_Node"]):
        self.block_hash = block_hash
        self.parent = parent
        self.children: Dict[int, _Node] = {}
        self.workers: Set[int] = set()


class RadixTree:
    """Prefix tree keyed by block hash; each node records the workers that
    hold that block. A per-worker hash->node lookup makes Removed events
    and worker eviction O(1) per block."""

    def __init__(self) -> None:
        self.root = _Node(0, None)
        self.lookup: Dict[int, Dict[int, _Node]] = defaultdict(dict)

    def find_matches(self, block_hashes: Sequence[int]) -> OverlapScores:
        """Walk the chain from the root; count per-worker contiguous
        matches."""
        scores: Dict[int, int] = {}
        node = self.root
        for h in block_hashes:
            nxt = node.children.get(h)
            if nxt is None:
                break
            for w in nxt.workers:
                scores[w] = scores.get(w, 0) + 1
            node = nxt
        return OverlapScores(scores)

    def apply_event(self, ev: KvCacheEventWire) -> None:
        if ev.kind == "stored":
            self._apply_stored(ev)
        elif ev.kind == "removed":
            self._apply_removed(ev)

    def _apply_stored(self, ev: KvCacheEventWire) -> None:
        wl = self.lookup[ev.worker_id]
        # anchor at the parent node if known, else the root
        if ev.parent_hash is not None and ev.parent_hash in wl:
            node = wl[ev.parent_hash]
        else:
            node = self.root
        for h in ev.block_hashes:
            existing = wl.get(h)
            if existing is not None:
                node = existing
                continue
            child = node.children.get(h)
            if child is None:
                child = _Node(h, node)
                node.children[h] = child
            child.workers.add(ev.worker_id)
            wl[h] = child
            node = child

    def _apply_removed(self, ev: KvCacheEventWire) -> None:
        wl = self.lookup[ev.worker_id]
        for h in ev.block_hashes:
            node = wl.pop(h, None)
            if node is None:
                continue
            node.workers.discard(ev.worker_id)
            self._maybe_prune(node)

    def remove_worker(self, worker_id: int) -> None:
        """Drop every block of a dead worker (lease expiry: stale index
        entries must go)."""
        wl = self.lookup.pop(worker_id, {})
        for node in wl.values():
            node.workers.discard(worker_id)
            self._maybe_prune(node)

    def _maybe_prune(self, node: "_Node") -> None:
        while (node is not self.root and not node.workers
               and not node.children and node.parent is not None):
            parent = node.parent
            parent.children.pop(node.block_hash, None)
            node.parent = None
            node = parent

    def block_count(self) -> int:
        n = 0
        stack = [self.root]
        while stack:
            cur = stack.pop()
            n += len(cur.children)
            stack.extend(cur.children.values())
        return n


class KvIndexer:
    """Tokens-in, scores-out facade over the :class:`RadixTree`."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        # the workers with indexed blocks (the router's dead-worker prune)
        self._workers: set = set()
        self.tree = RadixTree()

    def find_matches_for_request(self, token_ids: Sequence[int]
                                 ) -> OverlapScores:
        hashes = chain_hashes(token_ids, self.block_size)
        return self.tree.find_matches(hashes)

    def apply_event(self, ev: KvCacheEventWire) -> None:
        self._workers.add(ev.worker_id)
        self.tree.apply_event(ev)

    def remove_worker(self, worker_id: int) -> None:
        self._workers.discard(worker_id)
        self.tree.remove_worker(worker_id)

    def workers(self) -> List[int]:
        """Workers that have contributed indexed blocks (sorted)."""
        return sorted(self._workers)
