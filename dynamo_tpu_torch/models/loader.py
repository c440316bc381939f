"""Weight loading from local HF-style checkpoints (safetensors): dense,
Mixtral-style MoE and DeepSeek MLA models.

``dynamo_tpu/models/loader.py``, with its keys and layouts: HuggingFace
``nn.Linear`` stores ``[out, in]`` weights and the model computes
``x @ W``, so every projection is transposed once at load time; per-layer weights are stacked on a leading layer axis; ``lm_head``
is absent when ``tie_word_embeddings`` is set; Qwen2's q/k/v biases,
Qwen3's ``q_norm``/``k_norm`` and Gemma-2's sandwich norms
(``pre_feedforward_layernorm`` → ``ln_mlp``, ``post_attention_layernorm``
→ ``ln_attn_post``, ``post_feedforward_layernorm`` → ``ln_mlp_post``).
MoE checkpoints stack each layer's experts on a second axis (``w_gate``
``[L, E, D, I]``) and its router as ``w_router`` ``[L, D, E]``: Mixtral's
``block_sparse_moe.experts.{e}.w1/w3/w2`` and ``block_sparse_moe.gate``,
Qwen3-MoE's ``mlp.experts.{e}.gate_proj/up_proj/down_proj`` and
``mlp.gate``. DeepSeek-V2/V3 checkpoints (MLA) load into
``models/mla.py``'s layout (:func:`_load_mla_attention`,
:func:`_load_deepseek_moe`): ``kv_b_proj`` splits into ``w_uk`` and
``w_uv``, interleaved rope columns are permuted to the split-half
convention (:func:`_rope_perm`), and the MoE layers load as their
segments (dense-first ``w_*_d``, routed ``w_*_e``, shared ``w_*_s``, the
router and V3's selection bias). Those splits and permutations are
selections of a weight's output rows, made on the file's rows before the
cut and the copy. ``quant="int8"`` gives the projections as
``models/quant.py QuantInt8`` (``load_params``).

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

import numpy as np
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

    def read(name: str, pick):
        """Entry ``name`` as a CPU tensor; with ``pick``, those of its
        rows (``[out, in]``: output channels), in that order (a copy)."""
        f, key = entry(name)
        src = f.get(key)
        return (src if pick is None else src[pick]), f, key

    def put(dst: torch.Tensor, name: str, spec, linear: bool,
            pick=None) -> None:
        """Copy entry ``name`` (transposed when ``linear``) into ``dst``,
        cut to the rank's shard of ``spec`` first: the cut on the file's
        layout, the transpose and the cast on the device."""
        src, f, key = read(name, pick)
        block = shard(src, tuple(reversed(spec)) if linear else spec, mesh)
        moved = block.to(device)
        dst.copy_(moved.T if linear else moved)
        f.release(key)

    def put_int8(dst: QuantInt8, name: str, spec, pick=None) -> None:
        """Quantize entry ``name`` (``[out, in]``, the kernel's layout of
        ``q``) into ``dst``, the rank's shard: the rows of the rank's
        ``out`` go to the device whole along ``in``, so the scales are
        those of the whole rows (JAX quantizes the whole weight and then
        shards it), and are cut to the rank's ``in`` there. A selection
        of output rows quantizes as the JAX package's selected weight
        does: each row has its own scale."""
        src, f, key = read(name, pick)
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

    def fill(dst, name: str, spec, linear: bool, pick=None) -> None:
        if isinstance(dst, QuantInt8):
            put_int8(dst, name, spec, pick)
        else:
            put(dst, name, spec, linear, pick)

    def single(key: str, name: str, linear: bool = False) -> None:
        f, k = entry(name)
        e = f.entries[k]["shape"]
        shape = tuple(reversed(e)) if linear else tuple(e)
        p[key] = alloc(key, shape)
        fill(p[key], name, specs.get(key, (None,) * len(shape)), linear)

    def stack(key: str, fmt: str, linear: bool = True,
              experts: int = 0, layers: Optional[range] = None,
              pick: Optional[torch.Tensor] = None) -> None:
        """Param ``key`` from entries ``fmt.format(layer)``, stacked on a
        leading layer axis; with ``experts`` = E, from entries
        ``fmt.format(layer, expert)`` stacked on [layer, expert].
        ``layers``: the checkpoint layers stacked (default all; a
        DeepSeek-MoE segment's range); ``pick``: the output rows of each
        linear entry taken, in order (a split or a permutation)."""
        layers = range(cfg.num_layers) if layers is None else layers
        lead = (len(layers),) + ((experts,) if experts else ())
        first = (layers[0],) + ((0,) if experts else ())
        f, k = entry(fmt.format(*first))
        e = list(f.entries[k]["shape"])
        if pick is not None:
            e[0] = len(pick)
        shape = lead + (tuple(reversed(e)) if linear else tuple(e))
        p[key] = alloc(key, shape)
        spec = specs.get(key, (None,) * len(shape))[len(lead):]
        for n, i in enumerate(layers):
            for j in range(experts or 1):
                ids = (i, j) if experts else (i,)
                dst = p[key][n][j] if experts else p[key][n]
                fill(dst, fmt.format(*ids), spec, linear, pick)

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
    if cfg.is_mla:
        _load_mla_attention(cfg, stack)
    else:
        for key, proj in (("wq", "q_proj"), ("wk", "k_proj"),
                          ("wv", "v_proj"), ("wo", "o_proj")):
            stack(key, layer + f"self_attn.{proj}.weight")
    if cfg.attn_bias:  # Qwen2-style qkv bias
        for key, proj in (("bq", "q_proj"), ("bk", "k_proj"),
                          ("bv", "v_proj")):
            stack(key, layer + f"self_attn.{proj}.bias", linear=False)
    if cfg.qk_norm:  # Qwen3 per-head q/k norms
        stack("q_norm", layer + "self_attn.q_norm.weight", linear=False)
        stack("k_norm", layer + "self_attn.k_norm.weight", linear=False)
    if cfg.num_experts > 0 and cfg.is_mla:
        _load_deepseek_moe(cfg, stack)
    elif cfg.num_experts > 0:
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


def _rope_perm(dr: int) -> torch.Tensor:
    """Interleaved → split-half rope column permutation: DeepSeek
    checkpoints store rope dims as (pair0_re, pair0_im, pair1_re, ...);
    ``models/llama.py apply_rope`` takes all real parts first. The same
    permutation of the q and k rope columns leaves every q.k score
    unchanged (HF's ``apply_rotary_pos_emb_interleave`` is this
    permutation followed by split-half rope)."""
    return torch.from_numpy(np.concatenate([np.arange(0, dr, 2),
                                            np.arange(1, dr, 2)]))


def _load_mla_attention(cfg: ModelConfig, stack) -> None:
    """DeepSeek-V2/V3 MLA attention weights → models/mla.py's layout:
    ``kv_a_proj_with_mqa`` → ``w_dkv`` [D, r + dr]; ``kv_a_layernorm`` →
    ``kv_norm``; ``kv_b_proj`` ([H*(dn+dv), r] in HF) splits into
    ``w_uk`` [r, H*dn] and ``w_uv`` [r, H*dv] (each a selection of its
    rows); the q path full-rank (``q_proj`` → ``w_q``) or LoRA
    (``q_a_proj``, ``q_a_layernorm``, ``q_b_proj`` → ``w_dq``, ``q_norm``,
    ``w_uq``). With ``rope_interleave``, the rope columns of ``w_dkv`` and
    of each head's block of the q projection are permuted
    (:func:`_rope_perm`)."""
    H, r, dr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    attn = "model.layers.{}.self_attn."
    dkv_pick = q_pick = None
    if cfg.rope_interleave:
        perm = _rope_perm(dr)
        dkv_pick = torch.cat([torch.arange(r), r + perm])
        head = torch.cat([torch.arange(dn), dn + perm])
        q_pick = (torch.arange(H)[:, None] * (dn + dr) + head).reshape(-1)
    stack("w_dkv", attn + "kv_a_proj_with_mqa.weight", pick=dkv_pick)
    stack("kv_norm", attn + "kv_a_layernorm.weight", linear=False)
    first = torch.arange(H)[:, None] * (dn + dv)
    stack("w_uk", attn + "kv_b_proj.weight",
          pick=(first + torch.arange(dn)).reshape(-1))
    stack("w_uv", attn + "kv_b_proj.weight",
          pick=(first + dn + torch.arange(dv)).reshape(-1))
    stack("w_o", attn + "o_proj.weight")
    if cfg.q_lora_rank > 0:
        stack("w_dq", attn + "q_a_proj.weight")
        stack("q_norm", attn + "q_a_layernorm.weight", linear=False)
        stack("w_uq", attn + "q_b_proj.weight", pick=q_pick)
    else:
        stack("w_q", attn + "q_proj.weight", pick=q_pick)


def _load_deepseek_moe(cfg: ModelConfig, stack) -> None:
    """DeepSeek-V2/V3 MoE weights → models/mla.py's segmented layout:
    the dense first-k layers (``mlp.{gate,up,down}_proj`` → ``w_*_d``),
    then the routed experts (``mlp.experts.N.*`` → ``w_*_e`` [Lm, E, D,
    Im]; router ``mlp.gate`` → ``w_router``; V3's
    ``e_score_correction_bias`` → ``router_bias``) and the always-on
    shared experts (``mlp.shared_experts.*`` → ``w_*_s``)."""
    kd = cfg.first_k_dense_replace
    mlp = "model.layers.{}.mlp."
    projs = (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj"))
    dense, moe = range(kd), range(kd, cfg.num_layers)
    if kd > 0:
        for key, proj in projs:
            stack(f"w_{key}_d", mlp + proj + ".weight", layers=dense)
    stack("w_router", mlp + "gate.weight", layers=moe)
    if cfg.moe_router == "deepseek_v3":
        stack("router_bias", mlp + "gate.e_score_correction_bias",
              linear=False, layers=moe)
    for key, proj in projs:
        stack(f"w_{key}_e", mlp + "experts.{}." + proj + ".weight",
              experts=cfg.num_experts, layers=moe)
    if cfg.n_shared_experts > 0:
        for key, proj in projs:
            stack(f"w_{key}_s", mlp + "shared_experts." + proj + ".weight",
                  layers=moe)
