"""Weight loading from local HF-style checkpoints (safetensors), dense
and Mixtral-style MoE models.

The dense and MoE branches of ``dynamo_tpu/models/loader.py``, with its
keys and
layouts: HuggingFace ``nn.Linear`` stores ``[out, in]`` weights and the
model computes ``x @ W``, so every projection is transposed once at load
time; per-layer weights are stacked on a leading layer axis; ``lm_head``
is absent when ``tie_word_embeddings`` is set; Qwen2's q/k/v biases,
Qwen3's ``q_norm``/``k_norm`` and Gemma-2's sandwich norms
(``pre_feedforward_layernorm`` → ``ln_mlp``, ``post_attention_layernorm``
→ ``ln_attn_post``, ``post_feedforward_layernorm`` → ``ln_mlp_post``).
MoE checkpoints stack each layer's experts on a second axis (``w_gate``
``[L, E, D, I]``) and its router as ``w_router`` ``[L, D, E]``: Mixtral's
``block_sparse_moe.experts.{e}.w1/w3/w2`` and ``block_sparse_moe.gate``,
Qwen3-MoE's ``mlp.experts.{e}.gate_proj/up_proj/down_proj`` and
``mlp.gate``. MLA checkpoints raise ``NotImplementedError``;
``quant="int8"`` gives the projections as ``models/quant.py QuantInt8``
(``load_params``).

The files are read by :class:`SafetensorsFile`, this module's own reader
(the format: an 8-byte little-endian header length, a JSON header, then
raw little-endian tensor bytes), which maps each file with ``mmap`` and
views an entry with ``torch.frombuffer`` in the header's dtype, BF16
included (numpy has no bfloat16). Each parameter is allocated once on
the target device in the load dtype and filled one layer at a time: the
entry's bytes go to the device as they lie in the file (cut first to a
tensor-parallel rank's shard, ``parallel/mesh.py shard_param``), and the
transpose and the cast run there. The host holds at most one layer's
matrix, and drops the mapped pages of each entry once it is copied.
"""

from __future__ import annotations

import json
import mmap
import os
from typing import Dict, Optional

import torch

from ..parallel.mesh import MeshSpec, param_pspecs, shard
from ..runtime.device import resolve_device
from .config import ModelConfig
from .llama import Params
from .quant import QUANT_KEYS, QuantInt8, quantize_rows

_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
           "F32": torch.float32}


class SafetensorsFile:
    """One ``.safetensors`` file, mapped: :meth:`get` views an entry as a
    CPU tensor over the mapping (no copy), :meth:`release` drops the
    entry's pages from this process once it has been copied."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(n))
            # a private (copy-on-write) mapping: writable for
            # torch.frombuffer, and nothing is ever written back
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self.entries = header
        self._base = 8 + n

    def keys(self):
        return self.entries.keys()

    def get(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        dtype = _DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: {name} has dtype {e['dtype']}; "
                             f"the loader reads {sorted(_DTYPES)}")
        start, end = e["data_offsets"]
        shape = e["shape"]
        count = end - start
        numel = 1
        for d in shape:
            numel *= d
        if numel * dtype.itemsize != count:
            raise ValueError(f"{self.path}: {name} holds {count} bytes, "
                             f"not {shape} of {e['dtype']}")
        if numel == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self._map, dtype=dtype, count=numel,
                                offset=self._base + start).view(shape)

    def release(self, name: str) -> None:
        """Drop the mapped pages of ``name`` (they stay in the page cache,
        out of this process's resident set)."""
        start, end = self.entries[name]["data_offsets"]
        page = mmap.PAGESIZE
        a = (self._base + start) // page * page
        b = min(-(-(self._base + end) // page) * page, len(self._map))
        if b > a and hasattr(self._map, "madvise"):
            self._map.madvise(mmap.MADV_DONTNEED, a, b - a)


def _index(path: str) -> Dict[str, str]:
    """tensor name → shard file, from the safetensors index (or the
    single file)."""
    idx_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx_path):
        with open(idx_path) as f:
            return json.load(f)["weight_map"]
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        return {k: "model.safetensors"
                for k in SafetensorsFile(single).keys()}
    raise FileNotFoundError(f"no safetensors checkpoint under {path}")


def load_params(path: str, cfg: Optional[ModelConfig] = None, device="cuda",
                *, dtype: Optional[torch.dtype] = None, rank: int = 0,
                size: int = 1, quant: Optional[str] = None) -> Params:
    """Load and restack a local HF checkpoint (single file, or shards
    with ``model.safetensors.index.json``) into the model's params, on
    ``device`` in ``dtype`` (default the config's). With ``size`` > 1,
    the Megatron shard of tensor-parallel rank ``rank`` of ``size``:
    only the shard is read into the process and sent to the device.
    ``quant="int8"``: the projection weights (``models/quant.py
    QUANT_KEYS``) as ``QuantInt8``, quantized on the device from the
    file's values (in float32) one layer at a time, so the bfloat16 tree
    never exists whole on the card; a row-parallel shard (``wo``,
    ``w_down``) takes the scales of the whole rows, which the rank reads
    for that. The result is bitwise the JAX loader's ``quant="int8"``
    cut to the rank."""
    cfg = cfg or ModelConfig.from_local_path(path)
    if cfg.is_mla:
        raise NotImplementedError(
            "MLA checkpoints are not loaded by the port yet "
            "(_load_mla_attention of dynamo_tpu/models/loader.py)")
    if quant not in (None, "int8"):
        raise ValueError(f"unknown quant mode {quant!r} (expected 'int8')")
    device = resolve_device(device)
    dtype = dtype or cfg.torch_dtype
    mesh = MeshSpec(model=size).view(rank)
    specs = param_pspecs(cfg)
    qkeys = QUANT_KEYS if quant == "int8" else frozenset()
    wmap = _index(path)
    files: Dict[str, SafetensorsFile] = {}

    def entry(name: str):
        if name not in wmap:
            raise KeyError(f"{path}: the checkpoint has no tensor {name}")
        fname = wmap[name]
        if fname not in files:
            files[fname] = SafetensorsFile(os.path.join(path, fname))
        return files[fname], name

    def put(dst: torch.Tensor, name: str, spec, linear: bool) -> None:
        """Copy entry ``name`` (transposed when ``linear``) into ``dst``,
        cut to the rank's shard of ``spec`` first: the cut on the file's
        layout, the transpose and the cast on the device."""
        f, key = entry(name)
        src = f.get(key)
        block = shard(src, tuple(reversed(spec)) if linear else spec, mesh)
        moved = block.to(device)
        dst.copy_(moved.T if linear else moved)
        f.release(key)

    def put_int8(dst: QuantInt8, name: str, spec) -> None:
        """Quantize entry ``name`` (``[out, in]``, the kernel's layout of
        ``q``) into ``dst``, the rank's shard: the rows of the rank's
        ``out`` go to the device whole along ``in``, so the scales are
        those of the whole rows (JAX quantizes the whole weight and then
        shards it), and are cut to the rank's ``in`` there."""
        f, key = entry(name)
        src = f.get(key)
        out_spec, in_spec = spec[-1], spec[-2]
        rows = shard(src, (out_spec, None), mesh).to(device)
        qw = quantize_rows(rows)
        dst.q.copy_(shard(qw.q, (None, in_spec), mesh))
        dst.s.copy_(qw.s)
        f.release(key)

    def alloc(key: str, shape) -> torch.Tensor:
        """The rank's shard of param ``key``, uninitialised (int8 weights:
        a QuantInt8 of ``q`` and ``s``)."""
        spec = specs.get(key, (None,) * len(shape))
        part = shard(torch.empty(shape, device="meta"), spec, mesh)
        if key in qkeys:
            *lead, inp, out = part.shape
            return QuantInt8(
                torch.empty((*lead, out, inp), dtype=torch.int8,
                            device=device),
                torch.empty((*lead, 1, out), dtype=torch.float32,
                            device=device))
        return torch.empty(part.shape, dtype=dtype, device=device)

    def fill(dst, name: str, spec, linear: bool) -> None:
        if isinstance(dst, QuantInt8):
            put_int8(dst, name, spec)
        else:
            put(dst, name, spec, linear)

    def single(key: str, name: str, linear: bool = False) -> None:
        f, k = entry(name)
        e = f.entries[k]["shape"]
        shape = tuple(reversed(e)) if linear else tuple(e)
        p[key] = alloc(key, shape)
        fill(p[key], name, specs.get(key, (None,) * len(shape)), linear)

    def stack(key: str, fmt: str, linear: bool = True,
              experts: int = 0) -> None:
        """Param ``key`` from entries ``fmt.format(layer)``, stacked on a
        leading layer axis; with ``experts`` = E, from entries
        ``fmt.format(layer, expert)`` stacked on [layer, expert]."""
        lead = (cfg.num_layers,) + ((experts,) if experts else ())
        f, k = entry(fmt.format(*(0,) * len(lead)))
        e = f.entries[k]["shape"]
        shape = lead + (tuple(reversed(e)) if linear else tuple(e))
        p[key] = alloc(key, shape)
        spec = specs.get(key, (None,) * len(shape))[len(lead):]
        for i in range(cfg.num_layers):
            for j in range(experts or 1):
                ids = (i, j) if experts else (i,)
                dst = p[key][i][j] if experts else p[key][i]
                fill(dst, fmt.format(*ids), spec, linear)

    p: Params = {}
    single("embed", "model.embed_tokens.weight")
    single("ln_final", "model.norm.weight")
    if not cfg.tie_word_embeddings:
        single("lm_head", "lm_head.weight", linear=True)
    layer = "model.layers.{}."
    stack("ln_attn", layer + "input_layernorm.weight", linear=False)
    if cfg.sandwich_norms:
        # Gemma-2: post_attention_layernorm normalizes the ATTENTION
        # OUTPUT (before its residual add); the pre-MLP norm is
        # pre_feedforward_layernorm
        stack("ln_mlp", layer + "pre_feedforward_layernorm.weight",
              linear=False)
        stack("ln_attn_post", layer + "post_attention_layernorm.weight",
              linear=False)
        stack("ln_mlp_post", layer + "post_feedforward_layernorm.weight",
              linear=False)
    else:
        stack("ln_mlp", layer + "post_attention_layernorm.weight",
              linear=False)
    for key, proj in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                      ("wo", "o_proj")):
        stack(key, layer + f"self_attn.{proj}.weight")
    if cfg.attn_bias:  # Qwen2-style qkv bias
        for key, proj in (("bq", "q_proj"), ("bk", "k_proj"),
                          ("bv", "v_proj")):
            stack(key, layer + f"self_attn.{proj}.bias", linear=False)
    if cfg.qk_norm:  # Qwen3 per-head q/k norms
        stack("q_norm", layer + "self_attn.q_norm.weight", linear=False)
        stack("k_norm", layer + "self_attn.k_norm.weight", linear=False)
    if cfg.num_experts > 0:
        # HF names the MoE block per family: Mixtral's block_sparse_moe
        # with w1/w3/w2, Qwen3-MoE's mlp with gate/up/down_proj
        if cfg.model_type == "qwen3":
            moe, projs = "mlp", ("gate_proj", "up_proj", "down_proj")
        else:
            moe, projs = "block_sparse_moe", ("w1", "w3", "w2")
        stack("w_router", layer + f"{moe}.gate.weight")
        for key, proj in zip(("w_gate", "w_up", "w_down"), projs):
            stack(key, layer + moe + ".experts.{}." + proj + ".weight",
                  experts=cfg.num_experts)
    else:
        for key, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                          ("w_down", "down_proj")):
            stack(key, layer + f"mlp.{proj}.weight")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return p
