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
port decode engine and the reverse. The decode side records the
``route.disagg``, ``prefill.remote`` and ``decode`` spans and puts its
trace context on the remote prefill job (``trace_ctx``); the prefill
worker's ``prefill.forward`` and ``kv_transfer.send`` spans and the
receiver's ``kv_transfer.inject`` span join that trace. The ``kv.connect``,
``kv.send`` and ``kv.recv`` chaos points (``runtime/guard.py``) sever or
drop the transfer plane's frames.
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
