"""Frontend model discovery, a copy of ``dynamo_tpu/llm/http/discovery.py``.

``ModelWatcher`` watches the ``models/`` prefix of the KV store: on Put it
builds a client to the worker's endpoint and registers a chat and/or
completions engine for the model with the ``ModelManager``; on Delete it
removes it. Workers (and models registered by hand) appear on the
frontend with no restart, and leave it when their lease ends.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional

from ...runtime.dcp_client import unpack
from ...runtime.runtime import DistributedRuntime
from ...runtime.tasks import cancel_join, spawn_tracked
from ..engines import RemoteOpenAIEngine
from ..entry import MODEL_PREFIX, ModelEntry
from .service import ModelManager

log = logging.getLogger("dynamo_tpu_torch.http.discovery")


class ModelWatcher:
    def __init__(self, drt: DistributedRuntime, manager: ModelManager):
        self.drt = drt
        self.manager = manager
        self._clients: Dict[str, object] = {}
        self._task: Optional[asyncio.Task] = None
        self._watch = None

    async def start(self) -> None:
        items, watch = await self.drt.dcp.kv_watch_prefix(MODEL_PREFIX)
        self._watch = watch
        for item in items:
            await self._register(ModelEntry.from_dict(unpack(item.value)))
        self._task = spawn_tracked(self._loop(), name="model-watcher")

    async def stop(self) -> None:
        if self._watch:
            await self._watch.stop()
        await cancel_join(self._task)
        clients, self._clients = self._clients, {}
        for client in clients.values():
            await client.close()

    async def _loop(self) -> None:
        async for ev in self._watch:
            try:
                if ev.event == "put":
                    await self._register(ModelEntry.from_dict(unpack(ev.value)))
                elif ev.event == "delete":
                    self._unregister(ev.key)
            except Exception:
                log.exception("model watcher event failed for %s", ev.key)

    async def _register(self, entry: ModelEntry) -> None:
        addr = entry.address
        client = await self.drt.namespace(addr.namespace) \
            .component(addr.component).endpoint(addr.endpoint).client()
        engine = RemoteOpenAIEngine(client)
        if entry.model_type in ("chat", "both"):
            self.manager.add_chat_model(entry.name, engine)
        if entry.model_type in ("completions", "both"):
            self.manager.add_completions_model(entry.name, engine)
        old = self._clients.pop(entry.kv_key(), None)
        if old is not None:  # re-registration (worker restart/card refresh)
            spawn_tracked(old.close(), name="stale-client-close")
        self._clients[entry.kv_key()] = client
        log.info("discovered model %r -> %s", entry.name, entry.endpoint)

    def _unregister(self, kv_key: str) -> None:
        # key: models/<type>/<name> — remove only that type's route
        parts = kv_key[len(MODEL_PREFIX):].split("/", 1)
        if len(parts) != 2:
            return
        mtype, name = parts
        self.manager.remove_model(name, model_type=mtype)
        client = self._clients.pop(kv_key, None)
        if client is not None:
            spawn_tracked(client.close(), name="withdrawn-client-close")
        log.info("model %r withdrawn (type=%s)", name, mtype)
