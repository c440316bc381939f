"""Model acquisition by id: the launcher's ``--model-id``.

A copy of ``resolve_model`` of ``dynamo_tpu/models/hub.py``: a local
directory passes through untouched; anything else resolves through the
HuggingFace cache first (``local_files_only``, so a pre-populated cache
serves with no network) and only then the hub. ``huggingface_hub`` is
imported on that branch alone, so a host without it still resolves local
directories.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("dynamo_tpu_torch.hub")

# weights + configs + tokenizer assets; skips .bin duplicates when
# safetensors exist (the loader reads safetensors only)
_PATTERNS = ["*.safetensors", "*.safetensors.index.json", "*.json",
             "*.model", "tokenizer*", "*.tiktoken"]


def resolve_model(model_id: str, revision: str | None = None) -> str:
    """Resolve a model id or path to a local checkpoint directory.

    Local directories are returned as-is. Hub ids resolve via
    huggingface_hub's snapshot cache: cache-only first, then a download.
    """
    if os.path.isdir(model_id):
        return model_id
    from huggingface_hub import snapshot_download

    try:
        path = snapshot_download(model_id, revision=revision,
                                 allow_patterns=_PATTERNS,
                                 local_files_only=True)
        log.info("resolved %s from local HF cache: %s", model_id, path)
        return path
    except Exception:  # noqa: BLE001 — cache miss falls through to network
        pass
    try:
        path = snapshot_download(model_id, revision=revision,
                                 allow_patterns=_PATTERNS)
        log.info("downloaded %s: %s", model_id, path)
        return path
    except Exception as exc:  # noqa: BLE001
        raise RuntimeError(
            f"cannot resolve model {model_id!r}: not a local directory, "
            f"not in the HF cache, and download failed ({exc}). Pass "
            f"--model-path, or pre-populate the HuggingFace cache on "
            f"hosts with no network.") from exc
