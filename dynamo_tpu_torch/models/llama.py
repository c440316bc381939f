"""Llama-family model (dense and Mixtral-style MoE) in PyTorch with a
paged KV cache.

The PyTorch counterpart of ``dynamo_tpu/models/llama.py``,
with the same layouts so the two compare like with like:

- params are a dict of tensors with the JAX package's keys; projections
  are ``x @ W`` with ``W`` of shape ``[in, out]``, stacked on a leading
  layer axis (``wq`` is ``[L, D, H*hd]``);
- the KV cache is the stacked page pool ``[L, num_pages, KV, page_size,
  head_dim]``; sequences own pages through page tables.

Where the JAX package donates the pool buffers so XLA can update pages in
place, this module updates the pool tensors IN PLACE (``forward``, the
step functions and the fused decode window all mutate ``kv_k``/``kv_v``
and return the same tensors). Layers run as a Python loop over the
stacked axis (``lax.scan`` in JAX).

Attention goes through the CUDA kernels in ``ops/paged_attention.py``
(decode and the fused window through the decode kernel, prefill through
the prefill kernel) when ``use_kernels`` is set; on CPU tensors those
wrappers compute their plain versions. ``use_kernels=False`` takes the
gather paths (``_paged_attention``, ``_pool_window_attention``), the
plain reference the kernel path is held against.

Tensor parallelism (the JAX package's mesh branches): with a ``mesh``
(the rank's ``parallel/mesh.py`` ``MeshView``) each rank holds its
Megatron shard of the params and of the pool (``shard_params``,
``shard_kv_cache``) and runs its own heads: the sharded attention
wrappers on its q and kv heads, an all-reduce over the model axis after
``wo``, after ``w_down`` and after the vocab-sharded embedding lookup,
and an all-gather of the vocab-sharded logits, so every rank samples the
same tokens from the same full logits. GSPMD inserts those collectives
in the JAX package.

Weight-only int8 (``models/quant.py``): a projection param may be a
``QuantInt8`` (its ``[layer]`` a ``QuantInt8`` too), and ``x @ w`` runs
the int8 GEMM; the code has no int8 branches. A tied head (``embed.T``)
stays in the model's dtype, as ``embed`` is not quantized.

MoE (``cfg.num_experts > 0``: Mixtral, Qwen3-MoE): the MLP of every layer
is :func:`_moe_mlp`, token-choice top-k routing over stacked experts
(``w_gate``/``w_up`` ``[L, E, D, I]``, ``w_down`` ``[L, E, I, D]``,
``w_router`` ``[L, D, E]``), in one of the JAX package's two strategies,
chosen from static shapes by :func:`_moe_use_blocked`: the sorted,
padded dispatch :func:`moe_experts_blocked` or the dense sum over every
expert. Both have static shapes and read nothing back to the host, so
every prefill bucket and decode window captures as a CUDA graph. MLA
configurations raise ``NotImplementedError`` here: they are
``models/mla.py``'s (``models/registry.py`` picks the module).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.paged_attention import (NEG_INF, effective_window,
                                   paged_attention_decode_layered,
                                   paged_attention_decode_sharded,
                                   paged_attention_decode_window,
                                   paged_attention_decode_window_sharded,
                                   paged_attention_prefill,
                                   paged_attention_prefill_sharded,
                                   prefill_reference)
from ..parallel.mesh import MeshView, local_heads
from ..runtime.config import env_int
from ..runtime.device import resolve_device
from .config import ModelConfig

# a projection may be a models/quant.py QuantInt8
Params = Dict[str, torch.Tensor]

# scatter sentinel for padded rows: out of range, so the scatter drops it
DROP_SLOT = 1 << 30


def check_supported(cfg: ModelConfig) -> None:
    if cfg.is_mla:
        raise NotImplementedError(
            "MLA models run in models/mla.py, not models/llama.py (take "
            "the module from models/registry.py get_model_module)")


# ---------------------------------------------------------------- KV cache


@dataclass
class KVCacheSpec:
    num_pages: int
    page_size: int

    def shape(self, cfg: ModelConfig) -> Tuple[int, ...]:
        # kv-head-major page layout [L, pages, KV, ps, hd]: one page of
        # one kv head is a contiguous [ps, hd] tile for the kernels
        return (cfg.num_layers, self.num_pages, cfg.num_kv_heads,
                self.page_size, cfg.head_dim_)


def init_kv_cache(cfg: ModelConfig, spec: KVCacheSpec, dtype=None,
                  device="cuda", mesh: Optional[MeshView] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed pools; with ``mesh``, the rank's shard (its kv heads)."""
    device = resolve_device(device)
    shape = list(spec.shape(cfg))
    shape[2] = local_heads(cfg, mesh)[1]
    dtype = dtype or cfg.torch_dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


# ------------------------------------------------------------------ params


def param_table(cfg: ModelConfig) -> list:
    """(name, kind, shape) of every param, in the order :func:`init_params`
    draws them; kind is "w" (normal / sqrt(fan_in)), "ones" or "zeros"."""
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    V = cfg.vocab_size
    table = [("embed", "w", (V, D)), ("wq", "w", (L, D, H * hd)),
             ("wk", "w", (L, D, KV * hd)), ("wv", "w", (L, D, KV * hd)),
             ("wo", "w", (L, H * hd, D)), ("w_gate", "w", (L, D, I)),
             ("w_up", "w", (L, D, I)), ("w_down", "w", (L, I, D)),
             ("ln_attn", "ones", (L, D)), ("ln_mlp", "ones", (L, D)),
             ("ln_final", "ones", (D,))]
    if cfg.attn_bias:  # Qwen2-style q/k/v projection bias
        table += [("bq", "zeros", (L, H * hd)), ("bk", "zeros", (L, KV * hd)),
                  ("bv", "zeros", (L, KV * hd))]
    if cfg.sandwich_norms:  # Gemma-2 post-attention/feedforward norms
        table += [("ln_attn_post", "ones", (L, D)),
                  ("ln_mlp_post", "ones", (L, D))]
    if cfg.qk_norm:  # Qwen3 per-head q/k norms
        table += [("q_norm", "ones", (L, hd)), ("k_norm", "ones", (L, hd))]
    if not cfg.tie_word_embeddings:
        table.append(("lm_head", "w", (D, V)))
    if cfg.num_experts > 0:
        # the JAX package's MoE shapes: a router, and the experts stacked
        # on an axis after the layer's in place of the dense MLP
        E = cfg.num_experts
        moe = {"w_gate": (L, E, D, I), "w_up": (L, E, D, I),
               "w_down": (L, E, I, D)}
        table = [(n, k, moe.get(n, shape)) for n, k, shape in table]
        table.append(("w_router", "w", (L, D, E)))
    return table


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=None,
                shard: Optional[Callable[[str, torch.Tensor],
                                         torch.Tensor]] = None) -> Params:
    """Random-init params (stacked layers on axis 0) on the generator's
    device, drawn from ``generator``: normal / sqrt(fan_in) for
    matrices, ones for norms, zeros for biases. ``shard(name, tensor)``,
    when given, transforms each param as soon as it is drawn (a
    tensor-parallel rank's block, ``parallel/mesh.py shard_param``, or
    the int8 weights of it): the draws are the same as without it, so
    the blocks are those of the unsharded params, and only one whole
    param is held at a time."""
    check_supported(cfg)
    dtype = dtype or cfg.torch_dtype
    device = generator.device

    def w(*shape):
        scale = 1.0 / math.sqrt(shape[-2]) if len(shape) > 1 else 0.02
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(dtype)

    make = {"w": w,
            "ones": lambda *shape: torch.ones(shape, dtype=dtype,
                                              device=device),
            "zeros": lambda *shape: torch.zeros(shape, dtype=dtype,
                                                device=device)}
    p: Params = {}
    for name, kind, shape in param_table(cfg):
        t = make[kind](*shape)
        p[name] = shard(name, t) if shard is not None else t
    return p


# -------------------------------------------------------------- primitives


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             unit_offset: bool = False) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    if unit_offset:
        # Gemma: w is a delta around 1, applied in float32 before the cast
        return (normed * (1.0 + w.float())).to(x.dtype)
    # Llama: cast first, then scale (matches HF LlamaRMSNorm)
    return normed.to(x.dtype) * w


def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 mesh: Optional[MeshView] = None) -> torch.Tensor:
    """Token embedding lookup; Gemma scales by sqrt(hidden). With a
    vocab-sharded table (``mesh``), each rank looks up the tokens in its
    block of the vocab, zeros the others, and the model axis sums."""
    table = params["embed"]
    if mesh is None or mesh.model == 1:
        h = table[tokens.long()]
    else:
        n = table.shape[0]
        local = tokens.long() - mesh.model_rank * n
        h = table[local.clamp(0, n - 1)].masked_fill(
            ((local < 0) | (local >= n))[..., None], 0)
        mesh.all_reduce(h)
    if cfg.embed_scale:
        # a device scalar (made by a fill, so a CUDA graph can capture
        # it), rounded to h's dtype as the JAX package rounds it
        h = h * torch.full((), math.sqrt(cfg.hidden_size), dtype=h.dtype,
                           device=h.device)
    return h


def project_logits(params: Params, cfg: ModelConfig, h: torch.Tensor,
                   mesh: Optional[MeshView] = None) -> torch.Tensor:
    """LM head (tied to the embedding when absent) + the optional
    final-logit softcap; float32 logits. With a vocab-sharded head
    (``mesh``), each rank's block of the vocab is gathered over the model
    axis, so every rank holds the whole row."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = h @ head
    if mesh is not None:
        logits = mesh.gather_last(logits)
    logits = logits.float()
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _act(cfg: ModelConfig):
    if cfg.hidden_act == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    return F.silu


def rope_freqs(cfg: ModelConfig, dim: Optional[int] = None,
               device="cpu") -> torch.Tensor:
    hd = dim or cfg.head_dim_
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))
    scaling = cfg.rope_scaling or {}
    if scaling.get("rope_type") == "llama3" or scaling.get("type") == "llama3":
        # Llama-3.1-style NTK-by-parts frequency rescaling: low frequencies
        # are divided by `factor`, high frequencies kept, mid smoothly mixed
        factor = scaling.get("factor", 8.0)
        low = scaling.get("low_freq_factor", 1.0)
        high = scaling.get("high_freq_factor", 4.0)
        orig = scaling.get("original_max_position_embeddings", 8192)
        wavelen = 2 * math.pi / inv
        smooth = torch.clamp((orig / wavelen - low) / (high - low), 0.0, 1.0)
        inv = torch.where(wavelen > orig / low, inv / factor,
                          torch.where(wavelen < orig / high, inv,
                                      (1 - smooth) * inv / factor
                                      + smooth * inv))
    return inv


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotation angles, [..., T, 1, hd/2] float32:
    computed once per forward and shared by every layer's q and k."""
    angles = positions[..., None].float() * inv_freq   # [..., T, hd/2]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: [..., T, heads, head_dim]; positions: [..., T]. Rotates split
    halves in float32."""
    return _rotate(x, *rope_cos_sin(positions, inv_freq))


DropPlan = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _drop_plan(idx: torch.Tensor, limit: int) -> DropPlan:
    """The fixed-shape form of a drop-mode scatter over the flat indices
    ``idx`` (torch has none, and selecting the kept entries needs a device
    sync with a data-dependent shape). Returns ``(dest, src, any_kept)``:
    entry j writes row ``src[j]`` to ``dest[j]``. A kept entry (inside
    ``[0, limit)``) writes itself; a dropped one (DROP_SLOT padding, a
    page id >= num_pages) repeats the first kept entry's write, the same
    bytes to the same place. With nothing kept, every entry goes to
    index 0 and the caller writes that place's own value back, so a
    dropped entry never changes a byte of the pool."""
    valid = (idx >= 0) & (idx < limit)
    first = torch.argmax(valid.to(torch.int32))
    src = torch.where(valid, torch.arange(idx.numel(), device=idx.device),
                      first)
    any_kept = valid.any()
    return torch.where(any_kept, idx[src], 0), src, any_kept


def _scatter_pages_paged(cache_layer: torch.Tensor, new: torch.Tensor,
                         page_slots: torch.Tensor,
                         plan: Optional[DropPlan] = None) -> torch.Tensor:
    """Page-granular prefill commit, in place: write WHOLE pages. Requires
    chunk starts page-aligned (the engine guarantees it). The tail page
    may carry junk K/V beyond the chunk — safe, because a position's K/V
    is always written before any query attends to it.

    cache_layer: [num_pages, KV, ps, hd]; new: [B, T, KV, hd] (T % ps
    == 0); page_slots: [B, T // ps] destination page ids (>= num_pages →
    dropped padding); ``plan`` precomputed by :func:`_drop_plan`
    (optional)."""
    N, KV, ps, hd = cache_layer.shape
    B, T = new.shape[:2]
    blocks = new.reshape(B, T // ps, ps, KV, hd).permute(0, 1, 3, 2, 4)
    blocks = blocks.reshape(B * (T // ps), KV, ps, hd)
    if plan is None:
        plan = _drop_plan(page_slots.reshape(-1).long(), N)
    dest, src, any_kept = plan
    cache_layer[dest] = torch.where(any_kept, blocks[src].to(
        cache_layer.dtype), cache_layer[0])
    return cache_layer


def _scatter_pages(cache_layer: torch.Tensor, new: torch.Tensor,
                   flat_slots: torch.Tensor,
                   plan: Optional[DropPlan] = None) -> torch.Tensor:
    """Write new K/V rows into the page pool, in place.

    cache_layer: [num_pages, KV, page_size, hd]; new: [B, T, KV, hd];
    flat_slots: [B, T] flattened (page*page_size + slot) indices; entries
    outside the pool (DROP_SLOT) are dropped (see :func:`_drop_plan`)."""
    N, KV, ps, hd = cache_layer.shape
    if plan is None:
        plan = _drop_plan(flat_slots.reshape(-1).long(), N * ps)
    dest, src, any_kept = plan
    rows = new.reshape(-1, KV, hd)[src].to(cache_layer.dtype)
    # advanced indices (pages, offs) separated by the KV slice put the
    # scatter axis first: target shape [n, KV, hd]
    cache_layer[dest // ps, :, dest % ps] = torch.where(
        any_kept, rows, cache_layer[0, :, 0])
    return cache_layer


def _softcap_mask(scores, visible, softcap: Optional[float]):
    """Gemma-2 attention-score postprocess: tanh softcap (BEFORE masking),
    then the visibility mask."""
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    return torch.where(visible, scores, torch.full_like(scores, NEG_INF))


def _attention(q: torch.Tensor, kv_k: torch.Tensor, kv_v: torch.Tensor,
               layer: int, page_table: torch.Tensor,
               q_positions: torch.Tensor, scale: float,
               use_kernels: bool = True, softcap: Optional[float] = None,
               window: Optional[int] = None,
               is_sliding: bool = False, mesh: Optional[MeshView] = None,
               kv_heads: int = 0) -> torch.Tensor:
    """Dispatch: decode (T == 1) → the decode kernel on layer ``layer`` of
    the stacked pool; T > 1 → the prefill kernel on ``pool[layer]`` (a
    view); with ``mesh``, their sharded wrappers on the rank's heads
    (``kv_heads``: the model's, over all ranks). ``use_kernels=False``
    takes the gather path."""
    B, T = q.shape[:2]
    if not use_kernels:
        return _paged_attention(q, kv_k[layer], kv_v[layer], page_table,
                                q_positions, scale, softcap=softcap,
                                window=window, is_sliding=is_sliding)
    eff = None
    if window is not None:
        eff = effective_window(window, is_sliding, B, q.device)
    if T == 1:
        # padding rows: position -1 → length 0 → zeros
        lengths = (q_positions[:, 0] + 1).clamp(min=0).to(torch.int32)
        lower = None
        if eff is not None:
            # first visible position, clamped so a live row keeps at
            # least its own position in view
            lower = torch.minimum(
                (lengths - eff).clamp(min=0),
                (lengths - 1).clamp(min=0)).to(torch.int32)
        if mesh is not None:
            return paged_attention_decode_sharded(
                q[:, 0].contiguous(), kv_k, kv_v, layer, page_table,
                lengths, mesh=mesh, kv_heads=kv_heads, scale=scale,
                return_stats=False, softcap=softcap, lower=lower)[:, None]
        return paged_attention_decode_layered(
            q[:, 0].contiguous(), kv_k, kv_v, layer, page_table, lengths,
            scale=scale, softcap=softcap, lower=lower)[:, None]
    if mesh is not None:
        return paged_attention_prefill_sharded(
            q.contiguous(), kv_k[layer], kv_v[layer], page_table,
            q_positions, mesh=mesh, kv_heads=kv_heads, scale=scale,
            softcap=softcap, eff_win=eff)
    return paged_attention_prefill(q.contiguous(), kv_k[layer], kv_v[layer],
                                   page_table, q_positions, scale=scale,
                                   softcap=softcap, eff_win=eff)


def _paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, page_table: torch.Tensor,
                     q_positions: torch.Tensor, scale: float,
                     softcap: Optional[float] = None,
                     window: Optional[int] = None,
                     is_sliding: bool = False) -> torch.Tensor:
    """Gather-based paged GQA attention, the prefill kernel's plain
    version: the row's pages become a dense ``[B, P*ps, KV, hd]`` view,
    then masked attention over logical positions ``j <= q_position`` (and
    within the sliding window on sliding layers). Padding queries give
    zeros.

    q: [B, T, H, hd]; k_pages/v_pages: [num_pages, KV, ps, hd];
    page_table: [B, P]; q_positions: [B, T] (absolute, -1 padding)."""
    eff = None
    if window is not None:
        eff = effective_window(window, is_sliding, q.shape[0], q.device)
    return prefill_reference(q, k_pages, v_pages, page_table, q_positions,
                             scale, softcap=softcap, eff_win=eff)


# ------------------------------------------------------------ forward pass


def _mlp(h, w_gate, w_up, w_down, act=F.silu) -> torch.Tensor:
    return (act(h @ w_gate) * (h @ w_up)) @ w_down


def _layer_keys(cfg: ModelConfig) -> list:
    """Per-layer param names indexed on the stacked-layer axis."""
    keys = ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
            "ln_attn", "ln_mlp"]
    if cfg.num_experts > 0:
        keys.append("w_router")
    if cfg.attn_bias:
        keys += ["bq", "bk", "bv"]
    if cfg.sandwich_norms:
        keys += ["ln_attn_post", "ln_mlp_post"]
    if cfg.qk_norm:
        keys += ["q_norm", "k_norm"]
    return keys


def _residual_add(h, out, lp, post_key: str, cfg: ModelConfig):
    """Residual add, with the Gemma-2 sandwich norm on the branch output
    when the config uses them."""
    if cfg.sandwich_norms:
        out = rms_norm(out, lp[post_key], cfg.rms_norm_eps,
                       cfg.norm_unit_offset)
    return h + out


def _qk_headnorm(q, k, lp, cfg: ModelConfig):
    """Qwen3 per-head RMSNorm on q/k before RoPE. No-op unless
    cfg.qk_norm."""
    if not cfg.qk_norm:
        return q, k
    return (rms_norm(q, lp["q_norm"], cfg.rms_norm_eps),
            rms_norm(k, lp["k_norm"], cfg.rms_norm_eps))


def _sliding_flag(cfg: ModelConfig, l_idx: int) -> bool:
    """Gemma-2 applies the window on even-indexed layers only."""
    return cfg.sliding_window is not None and l_idx % 2 == 0


def _qkv(cfg: ModelConfig, lp, x, B: int, T: int, rope,
         heads: Tuple[int, int]):
    """Projections, optional bias / qk-norm, RoPE with ``rope`` = (cos,
    sin) from :func:`rope_cos_sin`: (q, k, v) as [B, T, H|KV, hd], with
    ``heads`` = (H, KV) the heads this rank holds."""
    (H, KV), hd = heads, cfg.head_dim_
    xq, xk, xv = x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]
    if cfg.attn_bias:
        xq, xk, xv = xq + lp["bq"], xk + lp["bk"], xv + lp["bv"]
    q, k = _qk_headnorm(xq.reshape(B, T, H, hd), xk.reshape(B, T, KV, hd),
                        lp, cfg)
    return _rotate(q, *rope), _rotate(k, *rope), xv.reshape(B, T, KV, hd)


def _reduce(t: torch.Tensor, mesh: Optional[MeshView]) -> torch.Tensor:
    """A row-parallel projection's partial sums summed over the model
    axis (in place; no-op without a mesh)."""
    return mesh.all_reduce(t) if mesh is not None else t


def _mlp_block(cfg: ModelConfig, lp, h, act, mesh=None):
    x = rms_norm(h, lp["ln_mlp"], cfg.rms_norm_eps, cfg.norm_unit_offset)
    if cfg.num_experts > 0:
        out = _moe_mlp(x, lp["w_router"], lp["w_gate"], lp["w_up"],
                       lp["w_down"], cfg.num_experts_per_tok, mesh=mesh)
    else:
        out = _reduce(_mlp(x, lp["w_gate"], lp["w_up"], lp["w_down"], act),
                      mesh)
    return _residual_add(h, out, lp, "ln_mlp_post", cfg)


# ------------------------------------------------------------------- MoE


def _top_k(logits: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis in descending
    order, a tie going to the lower index. ``torch.topk`` promises no
    order among equal values, so this is a stable sort's first k."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dyn_expert(w, e: torch.Tensor):
    """One expert's weight from the stacked ``[E, ...]`` tensor (or
    ``QuantInt8``) by a device index ``e`` ([1] int64): a copy of that
    expert alone, made on the device with no host read. An int8 expert
    stays int8, so its products run on the int8 GEMM."""
    return w.index_select(0, e)[0]


def moe_experts_blocked(x: torch.Tensor, weights: torch.Tensor,
                        idx: torch.Tensor, w_gate, w_up, w_down,
                        block: int = 256, act=F.silu) -> torch.Tensor:
    """Sparse top-k expert dispatch with static shapes and no token
    drops (the JAX package's ``moe_experts_blocked``).

    x: [N, D] flattened tokens; weights/idx: [N, k] routing output.
    The N*k (token, expert) pairs are sorted by expert (stably), each
    expert's group is padded to a multiple of ``block`` rows, and the
    ``nb = ceil(N*k / block) + E`` blocks of ``block`` rows run one
    after another, each on ONE expert's weights, taken by a device index
    (:func:`_dyn_expert`). Slack blocks past the last group hold zeros
    and run on the last expert; their rows are never read back. The
    products run in x's dtype. Each pair's output row is gathered back
    to ``[N, k, D]`` through the inverse of the sort, weighted and summed
    over k in order in float32: no atomics, so a replay gives the same
    bits. Returns [N, D] float32."""
    N, D = x.shape
    k = idx.shape[-1]
    E = w_gate.shape[0]
    NK = N * k
    nb = (NK + block - 1) // block + E  # static worst-case block count
    dev = x.device

    pair_e = idx.reshape(-1).long()                   # [NK]
    pair_t = torch.arange(NK, device=dev) // k
    order = torch.argsort(pair_e, stable=True)
    se, st = pair_e[order], pair_t[order]

    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, pair_e, torch.ones_like(pair_e))
    start = torch.cumsum(counts, 0) - counts          # exclusive, [E]
    padded = (counts + block - 1) // block * block
    pend = torch.cumsum(padded, 0)                    # padded group ends
    pstart = pend - padded
    pos = torch.arange(NK, device=dev) - start[se]
    dest = pstart[se] + pos                           # [NK], < nb*block

    buf = x.new_zeros((nb * block, D))
    buf[dest] = x[st]
    # block j covers rows [j*block, (j+1)*block) of exactly one padded
    # group; slack blocks past the last group stay zero (clamped expert)
    bstart = torch.arange(nb, device=dev) * block
    block_e = torch.clamp((bstart[:, None] >= pend[None, :]).sum(1),
                          max=E - 1)
    yb = torch.empty_like(buf)
    for j in range(nb):
        rows = slice(j * block, (j + 1) * block)
        be = block_e[j:j + 1]
        yb[rows] = _mlp(buf[rows], _dyn_expert(w_gate, be),
                        _dyn_expert(w_up, be), _dyn_expert(w_down, be), act)
    # pair j's row of yb, in the pairs' own (token-major) order
    row = torch.empty_like(dest)
    row[order] = dest
    contrib = yb[row].float().reshape(N, k, D) \
        * weights.float().reshape(N, k, 1)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out


# row height of the sorted dispatch's blocks, also the padding quantum of
# each expert's group (so it enters the cost model below)
_MOE_BLOCK = env_int("DYN_MOE_BLOCK")


def _moe_use_blocked(mesh, n_tokens: int, n_experts: int, top_k: int,
                     block: int) -> bool:
    """The JAX package's cost model, from static shapes only (so the
    choice is fixed per captured graph): the blocked dispatch pays at
    worst ``N*k + E*block`` row-MLPs (every pair once, plus up to one
    padded block an expert), the dense sum ``N*E``; blocked only where it
    is at least 2x cheaper, and only without a tensor-parallel mesh
    (there every rank runs the dense sum on its shard of each expert)."""
    return (n_experts > 1
            and n_tokens * top_k + n_experts * block
            <= (n_tokens * n_experts) // 2
            and (mesh is None or mesh.size == 1))


def moe_route(x: torch.Tensor, w_router, top_k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice routing of ``x`` [N, D]: float32 router logits (the
    product in x's dtype), their top k (ties to the lower expert), and a
    float32 softmax over those k: (weights [N, k] float32, idx [N, k])."""
    weights, idx = _top_k((x @ w_router).float(), top_k)
    return torch.softmax(weights, dim=-1), idx


def moe_experts_dense(x: torch.Tensor, weights: torch.Tensor,
                      idx: torch.Tensor, w_gate, w_up, w_down,
                      act=F.silu) -> torch.Tensor:
    """The dense strategy (the JAX package's einsum over all experts):
    ``sum_e gate_e * mlp_e(x)`` with ``gate [N, E]`` the routing weights
    scattered over the experts (zero where an expert was not picked). A
    static loop over the experts; each expert's products in x's dtype
    (float32 accumulation in the GEMMs), the gates, the weighting and the
    sum in float32, so no stack is upcast whole. Returns [N, D] float32."""
    N, D = x.shape
    E = w_gate.shape[0]
    gate = torch.zeros((N, E), dtype=torch.float32,
                       device=x.device).scatter_(1, idx, weights)
    out = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    for e in range(E):
        y = _mlp(x, w_gate[e], w_up[e], w_down[e], act)
        out = out + gate[:, e:e + 1] * y.float()
    return out


def _moe_mlp(h: torch.Tensor, w_router, w_gate, w_up, w_down, top_k: int,
             mesh: Optional[MeshView] = None) -> torch.Tensor:
    """Mixtral-style MoE MLP (the JAX package's ``_moe_mlp``):
    :func:`moe_route`, then :func:`moe_experts_blocked` or
    :func:`moe_experts_dense`, as :func:`_moe_use_blocked` decides from
    the static shapes. With ``mesh``, each rank holds a shard of every
    expert's inner width: its partial sums go through the model axis's
    all-reduce in float32. Returns h's dtype.

    h: [B, T, D]; w_router [D, E]; w_gate/w_up [E, D, I]; w_down
    [E, I, D] (a projection may be a ``QuantInt8``)."""
    B, T, D = h.shape
    E = w_gate.shape[0]
    x = h.reshape(B * T, D)
    weights, idx = moe_route(x, w_router, top_k)
    if _moe_use_blocked(mesh, B * T, E, top_k, _MOE_BLOCK):
        out = moe_experts_blocked(x, weights, idx, w_gate, w_up, w_down,
                                  block=_MOE_BLOCK)
    else:
        out = _reduce(moe_experts_dense(x, weights, idx, w_gate, w_up,
                                        w_down), mesh)
    return out.reshape(B, T, D).to(h.dtype)


@torch.no_grad()
def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, kv_k: torch.Tensor, kv_v: torch.Tensor,
            page_table: torch.Tensor, flat_slots: torch.Tensor,
            use_kernels: bool = True,
            page_slots: Optional[torch.Tensor] = None,
            mesh: Optional[MeshView] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared prefill/decode forward (a tensor-parallel rank's, with
    ``mesh``: its params and pool shards, its heads).

    tokens: [B, T] (T=1 for decode); positions: [B, T] absolute positions
    (-1 for padding rows); page_table: [B, P] int32; flat_slots: [B, T]
    cache write slots (page*page_size + offset, DROP_SLOT for padding);
    page_slots: optional [B, T // ps] page-granular write path for
    aligned prefill chunks (see _scatter_pages_paged).

    Writes the new K/V into ``kv_k``/``kv_v`` in place and returns
    (hidden [B, T, D], kv_k, kv_v).
    """
    check_supported(cfg)
    B, T = tokens.shape
    inv_freq = rope_freqs(cfg, device=tokens.device)
    scale = cfg.attn_scale
    heads = local_heads(cfg, mesh)
    H, hd = heads[0], cfg.head_dim_
    _, N, _, ps, _ = kv_k.shape
    h = embed_tokens(params, cfg, tokens, mesh)
    act = _act(cfg)
    rope = rope_cos_sin(positions.clamp(min=0), inv_freq)
    # the padding plans are shared by every layer: computed once
    if page_slots is not None:
        plan = _drop_plan(page_slots.reshape(-1).long(), N)
    else:
        plan = _drop_plan(flat_slots.reshape(-1).long(), N * ps)
    keys = _layer_keys(cfg)
    for l in range(cfg.num_layers):
        lp = {k: params[k][l] for k in keys}
        x = rms_norm(h, lp["ln_attn"], cfg.rms_norm_eps, cfg.norm_unit_offset)
        q, k, v = _qkv(cfg, lp, x, B, T, rope, heads)
        if page_slots is not None:
            _scatter_pages_paged(kv_k[l], k, page_slots, plan)
            _scatter_pages_paged(kv_v[l], v, page_slots, plan)
        else:
            _scatter_pages(kv_k[l], k, flat_slots, plan)
            _scatter_pages(kv_v[l], v, flat_slots, plan)
        attn = _attention(q, kv_k, kv_v, l, page_table, positions, scale,
                          use_kernels=use_kernels,
                          softcap=cfg.attn_logit_softcap,
                          window=cfg.sliding_window,
                          is_sliding=_sliding_flag(cfg, l), mesh=mesh,
                          kv_heads=cfg.num_kv_heads)
        h = _residual_add(h, _reduce(attn.reshape(B, T, H * hd) @ lp["wo"],
                                     mesh), lp, "ln_attn_post", cfg)
        h = _mlp_block(cfg, lp, h, act, mesh)
    h = rms_norm(h, params["ln_final"], cfg.rms_norm_eps, cfg.norm_unit_offset)
    return h, kv_k, kv_v


def logits_at(params: Params, cfg: ModelConfig, hidden: torch.Tensor,
              gather_idx: torch.Tensor,
              mesh: Optional[MeshView] = None) -> torch.Tensor:
    """LM head at selected positions. hidden: [B, T, D];
    gather_idx: [B] position per row → logits [B, V] (float32)."""
    B = hidden.shape[0]
    rows = torch.arange(B, device=hidden.device)
    return project_logits(params, cfg, hidden[rows, gather_idx.long()],
                          mesh)


# ------------------------------------------------------------ entry points


def make_step_fns(cfg: ModelConfig, use_kernels: bool = True,
                  mesh: Optional[MeshView] = None):
    """Build the (prefill_step, decode_step) pair for one config (a
    tensor-parallel rank's, with ``mesh``). Both write the pools in place
    (the JAX package donates them instead)."""

    def prefill_step(params: Params, tokens, positions, kv_k, kv_v,
                     page_table, flat_slots, last_idx, page_slots=None):
        """Process prompt chunks [B, T]; returns (logits [B, V], kv_k,
        kv_v)."""
        h, kv_k, kv_v = forward(params, cfg, tokens, positions, kv_k, kv_v,
                                page_table, flat_slots,
                                use_kernels=use_kernels,
                                page_slots=page_slots, mesh=mesh)
        return logits_at(params, cfg, h, last_idx, mesh), kv_k, kv_v

    def decode_step(params: Params, tokens, positions, kv_k, kv_v,
                    page_table, flat_slots):
        """One decode step: tokens [B], positions [B] →
        (logits [B, V], kv_k, kv_v)."""
        h, kv_k, kv_v = forward(params, cfg, tokens[:, None],
                                positions[:, None], kv_k, kv_v, page_table,
                                flat_slots[:, None], use_kernels=use_kernels,
                                mesh=mesh)
        return project_logits(params, cfg, h[:, 0], mesh), kv_k, kv_v

    return prefill_step, decode_step


def make_verify_fn(cfg: ModelConfig, use_kernels: bool = True,
                   mesh: Optional[MeshView] = None):
    """The verify forward of self-speculative decoding
    (``dynamo_tpu/models/llama.py`` make_verify_fn): ONE [B, K+1]
    multi-token step against the paged pool that returns the logits at
    EVERY position (the accept mask needs the greedy target after each
    draft token). The K+1 inputs' K/V scatter row by row through
    ``flat_slots`` before attention (a verify row starts anywhere in a
    page, so never the page-granular commit), and the prefill kernel's
    causal mask lets draft j see drafts 0..j-1 and the cached sequence.
    Rejected drafts leave K/V past the row's accepted extent, which is
    rewritten when its position's real token is the decode input,
    before any query sees it."""

    def verify_step(params: Params, tokens, positions, kv_k, kv_v,
                    page_table, flat_slots):
        """tokens/positions/flat_slots: [B, K+1] (-1 / DROP_SLOT padding)
        → (logits [B, K+1, V] float32, kv_k, kv_v)."""
        h, kv_k, kv_v = forward(params, cfg, tokens, positions, kv_k, kv_v,
                                page_table, flat_slots,
                                use_kernels=use_kernels, mesh=mesh)
        return project_logits(params, cfg, h, mesh), kv_k, kv_v

    return verify_step


# ------------------------------------------------- fused decode window


def carry_active(done: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rows still generating: not stopped, not padding (pos < 0)."""
    return torch.logical_and(torch.logical_not(done), pos >= 0)


def carry_step_update(nxt, tok, pos, done, steps, remaining, eos_table):
    """On-device sequence-carry update for one fused decode step: freeze
    rows that sample a stop token or exhaust their budget."""
    active = carry_active(done, pos)
    hit_stop = torch.any(nxt[:, None] == eos_table, dim=1)
    remaining = torch.where(active, remaining - 1, remaining)
    tok = torch.where(active, nxt, tok)
    pos = torch.where(active, pos + 1, pos)
    steps = torch.where(active, steps + 1, steps)
    done = torch.logical_or(done, torch.logical_and(
        active, torch.logical_or(hit_stop, remaining <= 0)))
    return tok, pos, done, steps, remaining


def make_decode_window_fn(cfg: ModelConfig, use_kernels: bool = True,
                          max_top_k: int = 64,
                          mesh: Optional[MeshView] = None):
    """Fused K-step decode with a READ-ONLY pool and an on-device
    sequence carry (``dynamo_tpu/models/llama.py`` make_decode_window_fn).
    The K new tokens' K/V accumulate in a per-layer window buffer that
    attention reads alongside the pool; ONE scatter at the end commits the
    window into the pool (in place). Stop conditions run on device: a row
    freezes as soon as it samples a stop token or exhausts its budget, and
    ``emitted`` counts the tokens each row really produced. With ``mesh``,
    a tensor-parallel rank's window: every rank samples the same tokens
    from the gathered logits, so the carries agree.

    ``penalties`` (the ``engine/sampling.py apply_penalties`` tuple,
    replicated on every rank) apply before each of the K draws, and each
    step's token folds into the state with the PRE-step done mask, so the
    carries still agree across ranks; ``logprobs_topn`` > 0 also returns
    each step's logprobs of the raw logits."""
    from ..engine.sampling import (logprob_aux, sample_tokens,
                                   update_penalty_state)

    heads = local_heads(cfg, mesh)
    (H, KV), hd = heads, cfg.head_dim_
    scale = cfg.attn_scale

    @torch.no_grad()
    def decode_window(params, tokens, positions, done, steps, remaining,
                      kv_k, kv_v, page_table, temperature, top_k, top_p,
                      seeds, eos_table, penalties=None, *, k_steps: int,
                      logprobs_topn: int = 0):
        """tokens/positions/done/steps/remaining: [B] carry (position -1 =
        padding row); temperature/top_k/top_p/seeds: [B] sampler params;
        eos_table: [B, E] stop ids (-1 pad); penalties: None or the
        sampler's penalty tuple. Returns (tokens [B, K], emitted [B],
        carry, kv_k, kv_v), with ``aux`` = (lp [B, K], top_vals
        [B, K, n], top_ids [B, K, n]) after ``emitted`` when
        ``logprobs_topn`` = n > 0."""
        check_supported(cfg)
        B = tokens.shape[0]
        L = cfg.num_layers
        _, N, _, ps, _ = kv_k.shape
        P = page_table.shape[1]
        dev = tokens.device
        inv_freq = rope_freqs(cfg, device=dev)
        act = _act(cfg)
        start = positions  # [B] position of the first window token
        wk = torch.zeros((L, B, k_steps, KV, hd), dtype=kv_k.dtype, device=dev)
        wv = torch.zeros_like(wk)
        keys = _layer_keys(cfg)
        tok, pos = tokens, positions
        toks = []
        lps, tvs, tis = [], [], []
        emitted = torch.zeros((B,), dtype=torch.int32, device=dev)
        for i in range(k_steps):
            h = embed_tokens(params, cfg, tok, mesh)[:, None]  # [B, 1, D]
            safe_pos = pos.clamp(min=0)[:, None]
            rope = rope_cos_sin(safe_pos, inv_freq)
            for l in range(L):
                lp = {k: params[k][l] for k in keys}
                x = rms_norm(h, lp["ln_attn"], cfg.rms_norm_eps,
                             cfg.norm_unit_offset)
                q, k, v = _qkv(cfg, lp, x, B, 1, rope, heads)
                wk[l, :, i] = k[:, 0].to(wk.dtype)
                wv[l, :, i] = v[:, 0].to(wv.dtype)
                win_args = dict(softcap=cfg.attn_logit_softcap,
                                window=cfg.sliding_window,
                                is_sliding=_sliding_flag(cfg, l),
                                q_pos=safe_pos[:, 0])
                if use_kernels:
                    attn = _pool_window_attention_kernel(
                        q, kv_k, kv_v, l, page_table, start, wk[l], wv[l],
                        i, scale, mesh=mesh, kv_heads=cfg.num_kv_heads,
                        **win_args)
                else:
                    attn = _pool_window_attention(
                        q, kv_k[l], kv_v[l], page_table, start, wk[l],
                        wv[l], i, scale, **win_args)
                h = _residual_add(
                    h, _reduce(attn.reshape(B, 1, H * hd) @ lp["wo"], mesh),
                    lp, "ln_attn_post", cfg)
                h = _mlp_block(cfg, lp, h, act, mesh)
            h = rms_norm(h, params["ln_final"], cfg.rms_norm_eps,
                         cfg.norm_unit_offset)
            logits = project_logits(params, cfg, h[:, 0], mesh)
            nxt = sample_tokens(logits, temperature, top_k, top_p, seeds,
                                steps, max_top_k=max_top_k,
                                penalties=penalties)
            if logprobs_topn:
                lp, tv, ti = logprob_aux(logits, nxt, logprobs_topn)
                lps.append(lp)
                tvs.append(tv)
                tis.append(ti)
            penalties = update_penalty_state(penalties, nxt, done)
            emitted = emitted + carry_active(done, pos).to(torch.int32)
            tok, pos, done, steps, remaining = carry_step_update(
                nxt, tok, pos, done, steps, remaining, eos_table)
            toks.append(tok)

        # commit the window into the pool: entry i holds the K/V of
        # position start+i, valid only if the row was still active at
        # step i (start+i < final pos)
        wpos = start[:, None] + torch.arange(k_steps, device=dev)[None, :]
        rows = torch.arange(B, device=dev)[:, None]
        page = page_table[rows, torch.clamp(torch.div(
            wpos, ps, rounding_mode="floor"), 0, P - 1)].long()
        valid = (start[:, None] >= 0) & (wpos < pos[:, None])
        flat = torch.where(valid, page * ps + wpos % ps,
                           torch.full_like(page, DROP_SLOT))
        plan = _drop_plan(flat.reshape(-1), N * ps)
        for l in range(L):
            _scatter_pages(kv_k[l], wk[l], flat, plan)
            _scatter_pages(kv_v[l], wv[l], flat, plan)
        out_toks = torch.stack(toks, dim=1)
        carry = (tok, pos, done, steps, remaining)
        if logprobs_topn:
            aux = (torch.stack(lps, dim=1), torch.stack(tvs, dim=1),
                   torch.stack(tis, dim=1))
            return out_toks, emitted, aux, carry, kv_k, kv_v
        return out_toks, emitted, carry, kv_k, kv_v

    return decode_window


def _pool_window_attention_kernel(q, k_pools, v_pools, layer: int,
                                  page_table, start, wk_l, wv_l, i: int,
                                  scale: float, softcap=None, window=None,
                                  is_sliding: bool = False, q_pos=None,
                                  mesh: Optional[MeshView] = None,
                                  kv_heads: int = 0):
    """Decode attention for one fused-window step, the kernel side
    (``_pool_window_attention_pallas`` in the JAX package): the frozen
    paged pool of layer ``layer`` (taken as an offset, no copy) and the
    in-flight window buffer in one softmax. The JAX package merges the
    decode kernel's (m, l) stats with the buffer in XLA; here the decode
    kernel's combine step folds the buffer in on the card. Positions
    < start live in the pool; positions start..start+i in the buffer.

    q: [B, 1, H, hd]; *_pools: [L, pages, KV, ps, hd]; wk_l/wv_l:
    [B, K, KV, hd]; start: [B]; i: step index; q_pos: [B] current query
    position (sliding window). With ``mesh``, the sharded wrapper on the
    rank's heads (``kv_heads``: the model's, over all ranks)."""
    eff = None
    if window is not None:
        eff = effective_window(window, is_sliding, q.shape[0], q.device)
    if mesh is not None:
        return paged_attention_decode_window_sharded(
            q[:, 0].contiguous(), k_pools, v_pools, layer, page_table, start,
            q_pos.contiguous(), wk_l, wv_l, i + 1, mesh=mesh,
            kv_heads=kv_heads, scale=scale, softcap=softcap,
            eff_win=eff)[:, None]
    out = paged_attention_decode_window(
        q[:, 0].contiguous(), k_pools, v_pools, layer, page_table, start,
        q_pos.contiguous(), wk_l, wv_l, i + 1, scale=scale, softcap=softcap,
        eff_win=eff)
    return out[:, None]


def _pool_window_attention(q, k_pool_l, v_pool_l, page_table, start,
                           wk_l, wv_l, i: int, scale: float, softcap=None,
                           window=None, is_sliding: bool = False,
                           q_pos=None):
    """Plain side: decode attention reading the (frozen) paged pool for
    positions < start plus the in-flight window for positions
    start..start+i, by gather and one softmax over the concatenation.

    q: [B, 1, H, hd]; *_pool_l: [pages, KV, ps, hd]; wk_l/wv_l:
    [B, K, KV, hd]; start: [B]; i: step index."""
    B, _, H, hd = q.shape
    _, KV, ps, _ = k_pool_l.shape
    K = wk_l.shape[1]
    P = page_table.shape[1]
    S = P * ps
    G = H // KV
    dev = q.device
    idx = page_table.long()
    kp = k_pool_l[idx].permute(0, 1, 3, 2, 4).reshape(B, S, KV, hd)
    vp = v_pool_l[idx].permute(0, 1, 3, 2, 4).reshape(B, S, KV, hd)
    qg = q.reshape(B, 1, KV, G, hd).float()
    sp = torch.einsum("btkgh,bskh->bkgts", qg, kp.float()) * scale
    sw = torch.einsum("btkgh,bwkh->bkgtw", qg, wk_l.float()) * scale
    ar_s = torch.arange(S, device=dev)
    ar_k = torch.arange(K, device=dev)
    mask_p = ar_s[None, :] < start[:, None]            # start<0 → all off
    mask_w = (ar_k[None, :] <= i) & (start[:, None] >= 0)
    if window is not None and is_sliding:
        # sliding layers see only kv positions > q_pos - window; pool
        # slot j holds logical position j, window slot w holds start + w
        mask_p = mask_p & (ar_s[None, :] > (q_pos - window)[:, None])
        mask_w = mask_w & ((start[:, None] + ar_k[None, :])
                           > (q_pos - window)[:, None])
    sp = _softcap_mask(sp, mask_p[:, None, None, None, :], softcap)
    sw = _softcap_mask(sw, mask_w[:, None, None, None, :], softcap)
    p = torch.softmax(torch.cat([sp, sw], dim=-1), dim=-1)
    pp, pw = p[..., :S], p[..., S:]
    out = (torch.einsum("bkgts,bskh->btkgh", pp, vp.float())
           + torch.einsum("bkgtw,bwkh->btkgh", pw, wv_l.float()))
    return out.reshape(B, 1, H, hd).to(q.dtype)
