"""Model registration entries, a copy of ``dynamo_tpu/llm/entry.py``.

A ``ModelEntry {name, endpoint, model_type}`` written to the KV store
under ``models/<type>/<name>``; the frontend's model watcher reacts to
Put/Delete by (un)registering engines. ``register_model`` and
``remove_model`` are the reference's ``llmctl`` verbs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..runtime.component import EndpointAddress
from ..runtime.dcp_client import DcpClient, pack, unpack

MODEL_PREFIX = "models/"


@dataclass
class ModelEntry:
    name: str
    endpoint: str           # dyn://namespace.component.endpoint
    model_type: str = "chat"  # "chat" | "completions" | "both"

    def kv_key(self) -> str:
        return f"{MODEL_PREFIX}{self.model_type}/{self.name}"

    def to_dict(self) -> dict:
        return {"name": self.name, "endpoint": self.endpoint,
                "model_type": self.model_type}

    @classmethod
    def from_dict(cls, d: dict) -> "ModelEntry":
        return cls(name=d["name"], endpoint=d["endpoint"],
                   model_type=d.get("model_type", "chat"))

    @property
    def address(self) -> EndpointAddress:
        return EndpointAddress.parse(self.endpoint)


async def register_model(dcp: DcpClient, entry: ModelEntry,
                         lease: int = 0) -> None:
    await dcp.kv_put(entry.kv_key(), pack(entry.to_dict()), lease=lease)


async def remove_model(dcp: DcpClient, name: str,
                       model_type: str = "chat") -> bool:
    return await dcp.kv_delete(f"{MODEL_PREFIX}{model_type}/{name}")


async def list_models(dcp: DcpClient) -> List[ModelEntry]:
    items = await dcp.kv_get_prefix(MODEL_PREFIX)
    return [ModelEntry.from_dict(unpack(i.value)) for i in items]
