"""The remote-prefill job (``dynamo_tpu/llm/disagg/protocols.py``),
carried over the DCP work queue as the ``prefill.remote_request``
frame."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ...runtime import wire


@dataclass
class RemotePrefillRequest:
    """One queued remote-prefill job.

    ``page_ids`` are DECODE-side pool pages, reserved before enqueueing,
    so the prefill side writes straight into them. ``skip_pages`` leading
    pages are already valid on the decode side (prefix-cache hits) and
    are not transferred.
    """

    request_id: str
    token_ids: List[int]
    sampling: dict = field(default_factory=dict)
    eos_token_ids: List[int] = field(default_factory=list)
    page_ids: List[int] = field(default_factory=list)
    skip_pages: int = 0
    engine_id: int = 0          # decode engine instance (transfer lookup key)
    # the decode-side request's trace context: the prefill worker's spans
    # join that trace (None roots a worker-local trace)
    trace_ctx: Optional[dict] = None
    # remaining request budget (ms) at enqueue time: the prefill worker
    # drops jobs whose budget is spent and caps its ack waits by what is
    # left. Absent on the wire = no deadline
    deadline_ms: Optional[int] = None

    def to_dict(self) -> dict:
        d = {
            "request_id": self.request_id,
            "token_ids": list(self.token_ids),
            "sampling": self.sampling,
            "eos_token_ids": list(self.eos_token_ids),
            "page_ids": list(self.page_ids),
            "skip_pages": self.skip_pages,
            "engine_id": self.engine_id,
        }
        if self.trace_ctx is not None:
            d["trace_ctx"] = self.trace_ctx
        if self.deadline_ms is not None:
            d["deadline_ms"] = int(self.deadline_ms)
        return wire.checked(wire.PREFILL_REMOTE_REQUEST, d)

    @classmethod
    def from_dict(cls, d: dict) -> "RemotePrefillRequest":
        d = wire.decoded(wire.PREFILL_REMOTE_REQUEST, d)
        return cls(request_id=d["request_id"],
                   token_ids=list(d["token_ids"]),
                   sampling=d.get("sampling", {}),
                   eos_token_ids=list(d.get("eos_token_ids", [])),
                   page_ids=list(d.get("page_ids", [])),
                   skip_pages=int(d.get("skip_pages", 0)),
                   engine_id=int(d.get("engine_id", 0)),
                   trace_ctx=d.get("trace_ctx"),
                   deadline_ms=d.get("deadline_ms"))
