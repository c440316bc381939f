"""Worker-side model serving, a copy of ``dynamo_tpu/llm/worker.py``.

``serve_openai_model`` is the ``in=dyn://`` worker mode: it builds
``OpenAIPreprocessor -> Backend -> engine`` behind an endpoint and
registers a ``ModelEntry`` (and the model card) in the KV store under
the worker's lease, so the frontend's model watcher picks it up — and
drops it when the lease ends. ``serve_token_model`` is the worker of the
KV-routed graph: ``PreprocessedRequest`` dicts in, ``EngineOutput`` dicts
out, the engine's ``stats()`` on the stats plane and a
:class:`KvEventPublisher` on the event plane.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..runtime.engine import Annotated, Context
from ..runtime.runtime import DistributedRuntime
from .engines import LocalChatChain, LocalCompletionChain
from .entry import ModelEntry, register_model
from .model_card import ModelDeploymentCard
from .preprocessor import OpenAIPreprocessor
from .protocols.common import PreprocessedRequest
from .protocols.openai import ChatCompletionRequest, CompletionRequest

log = logging.getLogger("dynamo_tpu_torch.llm.worker")


def _component_slug(mdc: ModelDeploymentCard) -> str:
    return mdc.name.replace("/", "-").replace(".", "-").lower()


async def serve_openai_model(
    drt: DistributedRuntime,
    mdc: ModelDeploymentCard,
    core_engine,
    *,
    namespace: str = "dynamo",
    component: Optional[str] = None,
    endpoint: str = "generate",
    stats_handler=None,
    model_type: Optional[str] = None,
):
    """Serve ``mdc``'s model with ``core_engine`` (token-level) and
    register it for discovery. Returns the ServeHandle."""
    component = component or _component_slug(mdc)
    preprocessor = OpenAIPreprocessor(mdc)
    chat_chain = LocalChatChain(mdc, core_engine, preprocessor)
    completion_chain = LocalCompletionChain(mdc, core_engine, preprocessor)

    async def handler(request: dict, context: Context):
        # chat requests carry "messages"; completion requests carry "prompt"
        if "messages" in request:
            req = ChatCompletionRequest(**request)
            async for chunk in chat_chain(req, context):
                yield _to_payload(chunk)
        else:
            req = CompletionRequest(**request)
            async for chunk in completion_chain(req, context):
                yield _to_payload(chunk)

    comp = drt.namespace(namespace).component(component)
    await comp.create_service()
    ep = comp.endpoint(endpoint)
    handle = await ep.serve(handler, stats_handler=stats_handler)

    await mdc.publish(drt.dcp)
    mtype = model_type or mdc.model_type
    entry = ModelEntry(name=mdc.name, endpoint=ep.path, model_type=mtype)
    await register_model(drt.dcp, entry, lease=drt.primary_lease)
    log.info("model %r serving at %s (type=%s)", mdc.name, ep.path, mtype)
    return handle


async def serve_token_model(
    drt: DistributedRuntime,
    mdc: ModelDeploymentCard,
    engine,
    *,
    namespace: str = "dynamo",
    component: Optional[str] = None,
    endpoint: str = "generate_tokens",
    publish_kv_events: bool = True,
):
    """Serve the token-level engine endpoint with the engine's ``stats()``
    on the stats plane and KV event publishing. Returns (ServeHandle,
    KvEventPublisher | None)."""
    from .kv_router.publisher import KvEventPublisher

    component = component or _component_slug(mdc)

    async def handler(request: dict, context: Context):
        pre = PreprocessedRequest.from_dict(request)
        async for out in engine.generate(pre, context):
            yield out.to_dict()

    comp = drt.namespace(namespace).component(component)
    await comp.create_service()
    ep = comp.endpoint(endpoint)
    handle = await ep.serve(handler,
                            stats_handler=getattr(engine, "stats", None))
    # the card is shared by all workers of the model: publish WITHOUT a
    # lease so one worker's death cannot delete it from under the others
    await mdc.publish(drt.dcp)

    publisher = None
    if publish_kv_events and hasattr(engine, "pm"):
        publisher = KvEventPublisher(
            drt.dcp, namespace, component, drt.instance_id, engine)
        publisher.start()
    log.info("token-level model %r serving at %s", mdc.name, ep.path)
    return handle, publisher


def _to_payload(chunk):
    """Chunks cross the wire as plain dicts (Annotated pass through)."""
    if isinstance(chunk, Annotated):
        return chunk
    if hasattr(chunk, "model_dump"):
        return chunk.model_dump(exclude_none=True)
    return chunk
