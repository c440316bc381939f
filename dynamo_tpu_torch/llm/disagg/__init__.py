"""Prefill/decode disaggregation, a port of ``dynamo_tpu/llm/disagg``.

Long prompts are prefilled on dedicated prefill workers; their KV pages
move into the decode engine's pool and decoding continues there:

- the shared prefill queue       -> DCP work queue (queue.py)
- the conditional-disagg router  -> DisaggRouter (router.py)
- the KV block transfer          -> host-staged TCP page transfer with
  DCP-registered endpoints (transfer.py)
- the remote-prefill staging     -> TorchEngine.reserve_remote /
  submit_prefilled / prefill_only (engine/torch_engine.py)

Frames and keys are the reference's, so a JAX prefill worker feeds a
port decode engine and the reverse. The reference's tracing spans are
not part of the port (a ``trace`` or ``trace_ctx`` field a peer sends is
accepted and ignored).
"""

from .decode import DisaggDecodeEngine
from .prefill_worker import PrefillWorker
from .protocols import RemotePrefillRequest
from .queue import PrefillQueue
from .router import DisaggRouter
from .transfer import KvTransferClient, KvTransferServer, TransferStats

__all__ = [
    "DisaggDecodeEngine", "DisaggRouter", "KvTransferClient",
    "KvTransferServer", "PrefillQueue", "PrefillWorker",
    "RemotePrefillRequest", "TransferStats",
]
