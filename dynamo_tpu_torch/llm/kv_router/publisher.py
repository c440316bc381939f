"""Worker-side KV event publishing, a copy of ``KvEventPublisher`` from
``dynamo_tpu/llm/kv_router/publisher.py``.

The engine is in-process, so the publisher drains the engine's
``PageManager.drain_events()`` (``engine/kv_manager.py``) every
``interval`` seconds onto the bus subject
``<namespace>.<component>.kv_events``. The reference's
``NativeEventBridge`` (events of external native engines through a C
shim) is not part of the port.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ...runtime.dcp_client import DcpClient, pack
from ...runtime.tasks import cancel_join, spawn_tracked
from .protocols import KV_EVENT_SUBJECT, KvCacheEventWire

log = logging.getLogger("dynamo_tpu_torch.kv_router.publisher")


class KvEventPublisher:
    """Periodically drains engine KV events onto the bus subject
    ``<namespace>.<component>.kv_events``. ``engine`` is anything with a
    ``pm`` that has ``drain_events()`` (``TorchEngine``)."""

    def __init__(self, dcp: DcpClient, namespace: str, component: str,
                 worker_id: int, engine, interval: float = 0.25):
        self.dcp = dcp
        self.subject = f"{namespace}.{component}.{KV_EVENT_SUBJECT}"
        self.worker_id = worker_id
        self.engine = engine
        self.interval = interval
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None:
            self._task = spawn_tracked(self._loop(), name="kv-event-pub")

    async def stop(self) -> None:
        # claim the task before the await: a concurrent stop() must not
        # double-cancel
        task, self._task = self._task, None
        await cancel_join(task)
        await self.flush()

    async def flush(self) -> None:
        events = self.engine.pm.drain_events()
        if not events:
            return
        payload = pack([
            KvCacheEventWire(worker_id=self.worker_id, kind=e.kind,
                             block_hashes=e.block_hashes,
                             parent_hash=e.parent_hash).to_dict()
            for e in events])
        try:
            await self.dcp.publish(self.subject, payload)
        except Exception:
            log.exception("kv event publish failed")

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            await self.flush()
