"""Conditional disaggregation and its live reconfiguration
(``dynamo_tpu/llm/disagg/router.py``).

Remote prefill iff ``prefill_length - prefix_hit_length >
max_local_prefill_length``, with the threshold (and the queue cap and
the on/off switch) reconfigured live through a watch on the DCP key
``{namespace}/disagg_router/models/{model}``; :func:`publish_config` is
the operator's write.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

from ...runtime.dcp_client import DcpClient

log = logging.getLogger("dynamo_tpu_torch.llm.disagg")


def config_key(namespace: str, model: str) -> str:
    return f"{namespace}/disagg_router/models/{model}"


class DisaggRouter:
    def __init__(self, max_local_prefill_length: int = 512,
                 max_prefill_queue_size: Optional[int] = None,
                 enabled: bool = True):
        self.max_local_prefill_length = max_local_prefill_length
        self.max_prefill_queue_size = max_prefill_queue_size
        self.enabled = enabled
        self._watch_task: Optional[asyncio.Task] = None

    def prefill_remote(self, prefill_length: int, prefix_hit_length: int,
                       queue_depth: int = 0) -> bool:
        """True -> enqueue a remote prefill; False -> prefill locally."""
        if not self.enabled:
            return False
        if (self.max_prefill_queue_size is not None
                and queue_depth >= self.max_prefill_queue_size):
            return False  # queue saturated: keep it local (backpressure)
        return (prefill_length - prefix_hit_length
                > self.max_local_prefill_length)

    # ------------------------------------------------------- live reconfig

    async def start_watch(self, dcp: DcpClient, namespace: str,
                          model: str) -> None:
        """Apply and follow the updates published at config_key()."""
        key = config_key(namespace, model)
        items, watch = await dcp.kv_watch_prefix(key)
        for item in items:
            self._apply(item.value)

        async def _loop():
            async for ev in watch:
                if ev.event == "put" and ev.value is not None:
                    self._apply(ev.value)

        self._watch_task = asyncio.ensure_future(_loop())

    def _apply(self, raw: bytes) -> None:
        try:
            cfg = json.loads(raw)
        except (ValueError, TypeError):
            log.warning("ignoring malformed disagg config: %r", raw[:100])
            return
        if "max_local_prefill_length" in cfg:
            self.max_local_prefill_length = int(cfg["max_local_prefill_length"])
        if "max_prefill_queue_size" in cfg:
            v = cfg["max_prefill_queue_size"]
            self.max_prefill_queue_size = None if v is None else int(v)
        if "enabled" in cfg:
            self.enabled = bool(cfg["enabled"])
        log.info("disagg router reconfigured: threshold=%d queue_max=%s "
                 "enabled=%s", self.max_local_prefill_length,
                 self.max_prefill_queue_size, self.enabled)

    def stop(self) -> None:
        if self._watch_task:
            self._watch_task.cancel()
            self._watch_task = None


async def publish_config(dcp: DcpClient, namespace: str, model: str,
                         **cfg) -> None:
    """Operator-side helper: update the live disagg config."""
    await dcp.kv_put(config_key(namespace, model), json.dumps(cfg).encode())
