"""The shared prefill work queue (``dynamo_tpu/llm/disagg/queue.py``):
decode workers push, any prefill worker pulls, workers join and leave
freely; the DCP server's FIFO work queue ``{namespace}.prefill_queue``
holds the jobs."""

from __future__ import annotations

import json
from typing import Optional

from ...runtime.dcp_client import DcpClient
from .protocols import RemotePrefillRequest


class PrefillQueue:
    def __init__(self, dcp: DcpClient, namespace: str = "dynamo",
                 name: str = "prefill_queue"):
        self.dcp = dcp
        self.queue = f"{namespace}.{name}"

    async def put(self, req: RemotePrefillRequest) -> None:
        await self.dcp.queue_put(self.queue,
                                 json.dumps(req.to_dict()).encode())

    async def pull(self, timeout: float = 0.0
                   ) -> Optional[RemotePrefillRequest]:
        raw = await self.dcp.queue_pull(self.queue, timeout=timeout)
        if raw is None:
            return None
        return RemotePrefillRequest.from_dict(json.loads(raw))

    async def depth(self) -> int:
        return await self.dcp.queue_len(self.queue)
