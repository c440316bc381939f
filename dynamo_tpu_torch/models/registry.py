"""Model-family registry: ModelConfig → model module (the JAX package's
``models/registry.py``).

The engine, the bridge, the loader's callers and the int8 helpers reach
``init_params`` / ``init_kv_cache`` / ``make_step_fns`` / ``param_table``
through this table: MLA configurations (``cfg.is_mla``, DeepSeek-V2/V3)
take ``models/mla.py``, every other one ``models/llama.py``, which keeps
refusing MLA itself."""

from __future__ import annotations

from .config import ModelConfig


def get_model_module(cfg: ModelConfig):
    if cfg.is_mla:
        from . import mla

        return mla
    from . import llama

    return llama
