"""Params bridge: numpy arrays (e.g. the JAX package's params, taken with
``np.asarray``) → the port's tensors, with identical keys and layout
(int8 weights: the port's ``QuantInt8``)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..parallel.mesh import MeshSpec, shard_param
from ..runtime.device import resolve_device
from .config import ModelConfig
from .llama import Params
from .quant import QuantInt8


def params_from_numpy(params: Dict[str, np.ndarray], cfg: ModelConfig,
                      device="cuda", *, rank: int = 0,
                      size: int = 1) -> Params:
    """Stacked-layer params as tensors on ``device`` in the config's
    dtype. Arrays in a numpy type torch lacks (ml_dtypes bfloat16) go
    through float32, which holds every bfloat16 value exactly. An int8
    weight (the JAX package's ``QuantInt8``, or anything with ``q [...,
    in, out]`` int8 and ``s [..., 1, out]`` float32 arrays) becomes the
    port's :class:`~.quant.QuantInt8` with the same int8 values and
    scales, ``q`` in the port's ``[..., out, in]`` layout; neither
    passes through the config's dtype. With ``size`` > 1, the Megatron
    shard of tensor-parallel rank ``rank`` of ``size`` (``parallel/mesh.py
    shard_param``), cut on the host: only the shard reaches the device."""
    device = resolve_device(device)
    mesh = MeshSpec(model=size).view(rank)
    out: Params = {}
    for k, a in params.items():
        if hasattr(a, "q") and hasattr(a, "s"):
            qa = QuantInt8(np.array(np.swapaxes(np.asarray(a.q, np.int8),
                                                -1, -2), order="C"),
                           np.array(a.s, np.float32, order="C"))
            qa = shard_param(k, qa, cfg, mesh)
            out[k] = QuantInt8(torch.from_numpy(qa.q).to(device),
                               torch.from_numpy(qa.s).to(device))
            continue
        a = np.asarray(a)
        if a.dtype.kind not in "fiub":
            a = a.astype(np.float32)
        elif a.dtype.kind == "f" and a.dtype.itemsize == 2 \
                and a.dtype != np.float16:
            a = a.astype(np.float32)
        a = shard_param(k, a, cfg, mesh)
        out[k] = torch.from_numpy(np.array(a, order="C")).to(
            device=device, dtype=cfg.torch_dtype)
    return out
