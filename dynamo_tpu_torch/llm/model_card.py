"""Model Deployment Card (MDC), a copy of ``dynamo_tpu/llm/model_card.py``.

The card bundles what the preprocessor needs to serve a model (display
name, tokenizer artifact, context length, KV block size) plus a content
checksum (``mdcsum``), and is published to the control-plane KV store
under ``mdc/<name>`` so frontends and routers read the worker's card.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

import xxhash

from ..runtime.dcp_client import DcpClient, pack, unpack
from .tokenizer import Tokenizer, load_tokenizer

MDC_PREFIX = "mdc/"


@dataclass
class ModelDeploymentCard:
    name: str
    model_path: Optional[str] = None      # local dir with config/weights
    tokenizer_kind: str = "byte"          # "byte" | "hf"
    tokenizer_path: Optional[str] = None
    context_length: int = 8192
    kv_block_size: int = 64               # tokens per KV block/page
    model_type: str = "chat"              # "chat" | "completions" | "both"
    extra: dict = field(default_factory=dict)

    def mdcsum(self) -> str:
        blob = json.dumps(self.to_dict(), sort_keys=True).encode()
        return f"{xxhash.xxh3_64_intdigest(blob):016x}"

    def to_dict(self) -> dict:
        return {
            "name": self.name, "model_path": self.model_path,
            "tokenizer_kind": self.tokenizer_kind,
            "tokenizer_path": self.tokenizer_path,
            "context_length": self.context_length,
            "kv_block_size": self.kv_block_size,
            "model_type": self.model_type, "extra": self.extra,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ModelDeploymentCard":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})

    @classmethod
    def from_local_path(cls, path: str, name: Optional[str] = None,
                        **overrides) -> "ModelDeploymentCard":
        """Build a card from a local HF-style model directory."""
        name = name or os.path.basename(path.rstrip("/"))
        card = cls(name=name, model_path=path)
        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            card.context_length = int(
                cfg.get("max_position_embeddings", card.context_length))
        if os.path.exists(os.path.join(path, "tokenizer.json")) or \
                os.path.exists(os.path.join(path, "tokenizer_config.json")):
            card.tokenizer_kind = "hf"
            card.tokenizer_path = path
        for k, v in overrides.items():
            setattr(card, k, v)
        return card

    def load_tokenizer(self) -> Tokenizer:
        return load_tokenizer(self.tokenizer_kind, self.tokenizer_path)

    # ---------------------------------------------------------- KV publish

    def kv_key(self) -> str:
        return f"{MDC_PREFIX}{self.name}"

    async def publish(self, dcp: DcpClient, lease: int = 0) -> None:
        await dcp.kv_put(self.kv_key(), pack(self.to_dict()), lease=lease)

    @classmethod
    async def load(cls, dcp: DcpClient,
                   name: str) -> Optional["ModelDeploymentCard"]:
        raw = await dcp.kv_get(f"{MDC_PREFIX}{name}")
        return cls.from_dict(unpack(raw)) if raw else None
