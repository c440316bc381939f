"""DeepSeek-style MLA (multi-head latent attention) with a paged latent
KV cache, and DeepSeek's segmented MoE, in PyTorch.

The PyTorch counterpart of ``dynamo_tpu/models/mla.py``, with its names,
layouts and arithmetic order:

- the KV cache stores only the rank-r latent ``c_kv`` and the one shared
  rope key ``k_rope`` a token: pools ``[L, pages, 1, ps, r]`` and
  ``[L, pages, 1, ps, dr]``, whose KV-head axis of 1 keeps the engine's
  page machinery shape-agnostic (a token costs ``(r + dr) * 2`` bytes a
  layer in 16 bits);
- attention is the absorbed form: ``w_uk`` folds into the query
  (``q_lat = q_nope . w_uk``) and ``w_uv`` into the output, so it runs in
  latent space, as float32 einsums over the gathered pages
  (:func:`_mla_attention`). The JAX package has no Pallas kernel here, so
  neither attention kernel of ``ops/paged_attention.py`` runs on this
  path; ``use_kernels`` is taken for the llama module's interface and
  ignored;
- prefill and decode share :func:`forward`, which writes the new latents
  into the pools row by row, in place, in fixed shapes with no host read
  (:func:`_scatter_rows`: padded rows, ``DROP_SLOT``, write nothing), so
  every bucket captures as a CUDA graph. The module has no fused decode
  window: the engine builds the generic one (``engine/torch_engine.py
  _make_decode_multi``), K forwards with per-step pool writes;
- DeepSeek-MoE configurations (``num_experts > 0``) segment their layers:
  the first ``first_k_dense_replace`` run a dense MLP (``w_*_d``), the
  rest DeepSeek's routed experts (``w_*_e``, routed by
  :func:`_deepseek_gate`: the v2 softmax router or the v3 sigmoid router
  with its selection bias) beside the always-on shared experts
  (``w_*_s``), through the llama module's two expert dispatches
  (``moe_experts_blocked`` / ``moe_experts_dense``, chosen by
  ``_moe_use_blocked`` from static shapes).

Weight-only int8 (``models/quant.py``): ``w_uk`` and ``w_uv`` dequantize
to float32 before their reshape to ``[r, H, d]`` (``QuantInt8.reshape``,
as the JAX package's does); every other quantized key multiplies through
the int8 GEMM. The expert products run in the activations' dtype with
float32 sums (the JAX package upcasts each expert stack to float32; at
float32 the two are the same function).

Tensor parallelism (``parallel/mesh.py``): a rank holds its heads of the
up-projections (``w_q``/``w_uq``, ``w_uk``, ``w_uv``), its rows of
``w_o`` and its shards of the dense-first, shared and expert MLPs, whose
partial sums go through the model axis's float32 all-reduce; the latent
projections and the latent pools are replicated (every rank writes the
same latents). Under a mesh the experts take the dense sum.

Rope scaling: DeepSeek's YaRN (``rope_scaling`` type ``yarn``) and its
mscale are ignored, as the JAX package ignores them (``rope_freqs``
handles ``llama3`` scaling only; the softmax scale is
``1/sqrt(dn + dr)``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from ..parallel.mesh import MeshView
from ..runtime.device import resolve_device
from . import llama
from .config import ModelConfig
from .llama import (KVCacheSpec, Params, _drop_plan, _mlp, _reduce,
                    _rotate, _scatter_pages, _top_k, embed_tokens,
                    logits_at, moe_experts_blocked, moe_experts_dense,
                    project_logits, rms_norm, rope_cos_sin, rope_freqs)

# the JAX package's masked-score fill (finite: a row with no visible key
# gets a uniform softmax, and is dropped later)
MASK_FILL = -1e30


# ---------------------------------------------------------------- KV cache


def cache_shapes(cfg: ModelConfig, spec: KVCacheSpec):
    """(latent pool shape, rope pool shape): the KV-head axis fixed at 1
    so the engine's page gather/scatter stay shape-agnostic."""
    latent = (cfg.num_layers, spec.num_pages, 1, spec.page_size,
              cfg.kv_lora_rank)
    rope = (cfg.num_layers, spec.num_pages, 1, spec.page_size,
            cfg.qk_rope_head_dim)
    return latent, rope


def init_kv_cache(cfg: ModelConfig, spec: KVCacheSpec, dtype=None,
                  device="cuda", mesh: Optional[MeshView] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed latent and rope pools; under a mesh every rank holds them
    whole (replicated, as the JAX package shards them)."""
    device = resolve_device(device)
    dtype = dtype or cfg.torch_dtype
    lat, rope = cache_shapes(cfg, spec)
    return (torch.zeros(lat, dtype=dtype, device=device),
            torch.zeros(rope, dtype=dtype, device=device))


# ------------------------------------------------------------------ params


def param_table(cfg: ModelConfig) -> list:
    """(name, kind, shape) of every param at the JAX package's shapes
    (``mla.py init_params``), in the order :func:`init_params` draws
    them; kind is "w" (normal / sqrt(fan_in)), "ones" or "zeros"."""
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    H, V = cfg.num_heads, cfg.vocab_size
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    table = [("embed", "w", (V, D)), ("w_dkv", "w", (L, D, r + dr)),
             ("kv_norm", "ones", (L, r)), ("w_uk", "w", (L, r, H * dn)),
             ("w_uv", "w", (L, r, H * dv)), ("w_o", "w", (L, H * dv, D))]
    if cfg.num_experts == 0:
        table += [("w_gate", "w", (L, D, I)), ("w_up", "w", (L, D, I)),
                  ("w_down", "w", (L, I, D))]
    table += [("ln_attn", "ones", (L, D)), ("ln_mlp", "ones", (L, D)),
              ("ln_final", "ones", (D,))]
    if cfg.q_lora_rank > 0:
        rq = cfg.q_lora_rank
        table += [("w_dq", "w", (L, D, rq)), ("q_norm", "ones", (L, rq)),
                  ("w_uq", "w", (L, rq, H * (dn + dr)))]
    else:
        table.append(("w_q", "w", (L, D, H * (dn + dr))))
    if not cfg.tie_word_embeddings:
        table.append(("lm_head", "w", (D, V)))
    if cfg.num_experts > 0:
        E, kd = cfg.num_experts, cfg.first_k_dense_replace
        Lm, Im = L - kd, cfg.moe_intermediate_size or I
        if kd > 0:
            table += [("w_gate_d", "w", (kd, D, I)),
                      ("w_up_d", "w", (kd, D, I)),
                      ("w_down_d", "w", (kd, I, D))]
        table += [("w_router", "w", (Lm, D, E)),
                  ("w_gate_e", "w", (Lm, E, D, Im)),
                  ("w_up_e", "w", (Lm, E, D, Im)),
                  ("w_down_e", "w", (Lm, E, Im, D))]
        if cfg.moe_router == "deepseek_v3":
            table.append(("router_bias", "zeros", (Lm, E)))
        if cfg.n_shared_experts > 0:
            Is = Im * cfg.n_shared_experts
            table += [("w_gate_s", "w", (Lm, D, Is)),
                      ("w_up_s", "w", (Lm, D, Is)),
                      ("w_down_s", "w", (Lm, Is, D))]
    return table


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=None,
                shard: Optional[Callable[[str, torch.Tensor],
                                         torch.Tensor]] = None) -> Params:
    """Random-init params on the generator's device, drawn from
    ``generator`` as ``models/llama.py init_params`` draws them (one
    param at a time; ``shard(name, tensor)`` transforms each as soon as
    it is drawn)."""
    dtype = dtype or cfg.torch_dtype
    device = generator.device

    def make(kind, shape):
        if kind == "w":
            scale = 1.0 / math.sqrt(shape[-2]) if len(shape) > 1 else 0.02
            x = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device)
            return x.mul_(scale).to(dtype)
        fill = torch.ones if kind == "ones" else torch.zeros
        return fill(shape, dtype=dtype, device=device)

    p: Params = {}
    for name, kind, shape in param_table(cfg):
        t = make(kind, shape)
        p[name] = shard(name, t) if shard is not None else t
    return p


# ----------------------------------------------------------------- forward


def _mla_attn_keys(cfg: ModelConfig) -> list:
    """Attention-side per-layer param names (stacked over all layers)."""
    keys = ["w_dkv", "kv_norm", "w_uk", "w_uv", "w_o", "ln_attn",
            "ln_mlp"]
    keys += (["w_dq", "q_norm", "w_uq"] if cfg.q_lora_rank > 0
             else ["w_q"])
    return keys


def _mla_layer_keys(cfg: ModelConfig) -> list:
    """Per-layer param names of a dense MLA config (DeepSeek-MoE configs
    segment their params: :func:`_layer_params`)."""
    return _mla_attn_keys(cfg) + ["w_gate", "w_up", "w_down"]


def _moe_layer_params(cfg: ModelConfig, params: Params) -> dict:
    """The MoE segment's per-layer params (stacked over layers
    [first_k_dense_replace, L))."""
    lp = {"w_router": params["w_router"], "w_gate_e": params["w_gate_e"],
          "w_up_e": params["w_up_e"], "w_down_e": params["w_down_e"]}
    if cfg.moe_router == "deepseek_v3":
        lp["router_bias"] = params["router_bias"]
    if cfg.n_shared_experts > 0:
        lp.update({k: params[k] for k in ("w_gate_s", "w_up_s",
                                          "w_down_s")})
    return lp


def _layer_params(cfg: ModelConfig, params: Params, l: int
                  ) -> Tuple[dict, bool]:
    """Layer ``l``'s params and whether its MLP is DeepSeek's MoE: the
    attention keys, then the dense MLP (``w_gate``/``w_up``/``w_down``;
    from the ``_d`` stacks in a DeepSeek-MoE config's first layers) or
    the MoE segment's entry ``l - first_k_dense_replace``."""
    if cfg.num_experts == 0:
        return {k: params[k][l] for k in _mla_layer_keys(cfg)}, False
    lp = {k: params[k][l] for k in _mla_attn_keys(cfg)}
    kd = cfg.first_k_dense_replace
    if l < kd:
        lp.update({k: params[f"{k}_d"][l]
                   for k in ("w_gate", "w_up", "w_down")})
        return lp, False
    lp.update({k: v[l - kd]
               for k, v in _moe_layer_params(cfg, params).items()})
    return lp, True


def deepseek_scores(x32: torch.Tensor, w_router, bias,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, selection scores) [..., E] float32 of DeepSeek's router:
    the logits ``x32 @ w_router`` in float32 (the JAX package's order: the
    product in float32, whatever the params' dtype), then v2's softmax,
    or v3's sigmoid with the selection bias added for the choice."""
    logits = x32 @ w_router.float()
    if cfg.moe_router == "deepseek_v3":
        scores = torch.sigmoid(logits)
        return scores, scores + bias.float()
    scores = torch.softmax(logits, dim=-1)
    return scores, scores


def _gate_weights(scores: torch.Tensor, topi: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The applied weights of the experts ``topi``: their scores (v3: the
    sigmoid scores without the bias), renormalised under v3 with
    ``norm_topk_prob``, then scaled by ``routed_scaling_factor``."""
    w = torch.gather(scores, -1, topi)
    if cfg.moe_router == "deepseek_v3" and cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * cfg.routed_scaling_factor


def _deepseek_gate(x32: torch.Tensor, w_router, bias, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek's router → (weights [..., k] float32, expert indices
    [..., k]) (the JAX package's ``_deepseek_gate``).

    v2 (HF DeepseekV2MoEGate): softmax scores; optional group limiting by
    the max score of each group; top-k; weights scaled, not renormalised.
    v3 (HF DeepseekV3TopkRouter): sigmoid scores; selection by scores +
    ``router_bias`` with groups ranked by their top-2 sum; the applied
    weights are the selected experts' sigmoid scores, optionally
    renormalised, then scaled. Groups outside the top ``topk_group`` are
    set to 0.0 (not -inf), as in both references. Every top-k here
    (experts, groups, v3's top-2) breaks ties to the lower index, as
    ``lax.top_k`` does (``models/llama.py _top_k``)."""
    E = w_router.shape[-1]
    scores, choice = deepseek_scores(x32, w_router, bias, cfg)
    if cfg.n_group > 0 and cfg.topk_group > 0:
        G = cfg.n_group
        cg = choice.reshape(*choice.shape[:-1], G, E // G)
        if cfg.moe_router == "deepseek_v3":
            g_scores = _top_k(cg, 2)[0].sum(dim=-1)
        else:
            g_scores = cg.amax(dim=-1)
        _, g_idx = _top_k(g_scores, cfg.topk_group)
        g_mask = torch.zeros_like(g_scores).scatter_(-1, g_idx, 1.0)
        choice = torch.where(g_mask[..., None] > 0, cg,
                             torch.zeros_like(cg)).reshape(choice.shape)
    _, topi = _top_k(choice, cfg.num_experts_per_tok)
    return _gate_weights(scores, topi, cfg), topi


def _deepseek_moe_mlp(x: torch.Tensor, lp, cfg: ModelConfig,
                      mesh: Optional[MeshView] = None) -> torch.Tensor:
    """DeepSeek's MoE MLP (the JAX package's ``_deepseek_moe_mlp``): the
    routed experts, by the sorted blocked dispatch or the dense sum as
    ``_moe_use_blocked`` decides from the static shapes, plus the
    always-on shared experts. The router runs in float32; the expert
    products in x's dtype with float32 weighting and sums (at float32,
    the JAX package's arithmetic). With ``mesh``, a rank's partial sums
    (dense sum and shared experts) go through one float32 all-reduce.
    Returns x's dtype. x: [B, T, D]."""
    B, T, D = x.shape
    E = lp["w_gate_e"].shape[0]
    k = cfg.num_experts_per_tok
    xf = x.reshape(B * T, D)
    w, topi = _deepseek_gate(xf.float(), lp["w_router"],
                             lp.get("router_bias"), cfg)
    block = llama._MOE_BLOCK
    if llama._moe_use_blocked(mesh, B * T, E, k, block):
        out = moe_experts_blocked(xf, w, topi, lp["w_gate_e"],
                                  lp["w_up_e"], lp["w_down_e"], block=block)
    else:
        out = moe_experts_dense(xf, w, topi, lp["w_gate_e"], lp["w_up_e"],
                                lp["w_down_e"])
    if cfg.n_shared_experts > 0:
        out = out + _mlp(xf, lp["w_gate_s"], lp["w_up_s"],
                         lp["w_down_s"]).float()
    return _reduce(out, mesh).reshape(B, T, D).to(x.dtype)


def _scatter_rows(cache_layer: torch.Tensor, new: torch.Tensor,
                  flat_slots: torch.Tensor,
                  plan: Optional[llama.DropPlan] = None) -> torch.Tensor:
    """Write rows into one layer of a latent pool, in place.
    cache_layer: [pages, 1, ps, d]; new: [B, T, d]; flat_slots [B, T]
    (page*ps + offset; DROP_SLOT pads write nothing: the fixed-shape
    drop of ``models/llama.py _drop_plan``)."""
    return _scatter_pages(cache_layer, new[:, :, None, :], flat_slots, plan)


def _mla_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                   c_pages: torch.Tensor, r_pages: torch.Tensor,
                   page_table: torch.Tensor, q_positions: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Latent-space paged attention, in float32.

    q_lat: [B, T, H, r] (absorbed queries); q_rope: [B, T, H, dr];
    c_pages: [pages, 1, ps, r]; r_pages: [pages, 1, ps, dr]; page_table:
    [B, P]; q_positions: [B, T] (-1: padding, sees no key). Returns
    [B, T, H, r] float32, the latent-space context (to be up-projected
    by ``w_uv``). The two score einsums are summed, then scaled, and the
    mask is the JAX package's ``arange(S) <= q_position``."""
    B = q_lat.shape[0]
    r, dr = c_pages.shape[-1], r_pages.shape[-1]
    S = page_table.shape[1] * c_pages.shape[2]
    idx = page_table.long()
    c = c_pages[idx].reshape(B, S, r).float()
    kr = r_pages[idx].reshape(B, S, dr).float()
    scores = (torch.einsum("bthr,bsr->bhts", q_lat.float(), c)
              + torch.einsum("bthd,bsd->bhts", q_rope.float(), kr)) * scale
    mask = (torch.arange(S, device=q_lat.device)[None, None, :]
            <= q_positions[:, :, None])
    scores = scores.masked_fill(~mask[:, None], MASK_FILL)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bsr->bthr", probs, c)


def _local_heads(cfg: ModelConfig, mesh: Optional[MeshView]) -> int:
    """The query heads a rank holds (the up-projections' shard)."""
    tp = mesh.model if mesh is not None else 1
    if cfg.num_heads % tp:
        raise ValueError(f"{cfg.num_heads} heads do not split over "
                         f"model={tp}")
    return cfg.num_heads // tp


def _attn_inputs(cfg: ModelConfig, lp, x: torch.Tensor, rope, H: int):
    """The layer's queries and its new latents: (q_nope [B, T, H, dn],
    q_rope [B, T, H, dr] rotated, c_kv [B, T, r] normed, k_rope
    [B, T, dr] rotated: the one rope head every query head shares)."""
    B, T = x.shape[:2]
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    if cfg.q_lora_rank > 0:
        q_all = rms_norm(x @ lp["w_dq"], lp["q_norm"],
                         cfg.rms_norm_eps) @ lp["w_uq"]
    else:
        q_all = x @ lp["w_q"]
    q_all = q_all.reshape(B, T, H, dn + cfg.qk_rope_head_dim)
    q_nope, q_rope = q_all[..., :dn], _rotate(q_all[..., dn:], *rope)
    ckr = x @ lp["w_dkv"]  # [B, T, r + dr]
    c_kv = rms_norm(ckr[..., :r], lp["kv_norm"], cfg.rms_norm_eps)
    k_rope = _rotate(ckr[..., None, r:], *rope)[..., 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mlp_out(cfg: ModelConfig, lp, x: torch.Tensor, moe: bool,
             mesh: Optional[MeshView]) -> torch.Tensor:
    if moe:
        return _deepseek_moe_mlp(x, lp, cfg, mesh=mesh)
    return _reduce(_mlp(x, lp["w_gate"], lp["w_up"], lp["w_down"]), mesh)


def _scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _mla_block(cfg: ModelConfig, lp, x: torch.Tensor, rope,
               c_layer: torch.Tensor, r_layer: torch.Tensor,
               page_table: torch.Tensor, positions: torch.Tensor,
               flat_slots: torch.Tensor, plan: llama.DropPlan, H: int,
               mesh: Optional[MeshView] = None) -> torch.Tensor:
    """One layer's attention on its normed input ``x`` [B, T, D]: the new
    latents written into the layer's pools ``c_layer`` / ``r_layer`` (in
    place, by ``flat_slots`` and its drop ``plan``), then absorbed latent
    attention over the row's pages and ``w_o``, summed over the model
    axis under a mesh. Returns [B, T, D] in x's dtype."""
    B, T = x.shape[:2]
    r, dn, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _attn_inputs(cfg, lp, x, rope, H)
    _scatter_rows(c_layer, c_kv, flat_slots, plan)
    _scatter_rows(r_layer, k_rope, flat_slots, plan)
    # absorbed attention: q_lat = q_nope . w_uk (a head at a time)
    w_uk = lp["w_uk"].reshape(r, H, dn)
    q_lat = torch.einsum("bthd,rhd->bthr", q_nope.float(), w_uk.float())
    out_lat = _mla_attention(q_lat, q_rope, c_layer, r_layer, page_table,
                             positions, _scale(cfg))
    w_uv = lp["w_uv"].reshape(r, H, dv)
    out = torch.einsum("bthr,rhd->bthd", out_lat, w_uv.float())
    return _reduce(out.reshape(B, T, H * dv).to(x.dtype) @ lp["w_o"], mesh)


@torch.no_grad()
def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, kv_k: torch.Tensor, kv_v: torch.Tensor,
            page_table: torch.Tensor, flat_slots: torch.Tensor,
            use_kernels: bool = True,
            page_slots: Optional[torch.Tensor] = None,
            mesh: Optional[MeshView] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The contract of ``models/llama.py forward``, with (kv_k, kv_v) the
    (latent pool, rope pool). ``use_kernels`` is ignored (latent attention
    is plain torch throughout, as it is XLA in the JAX package), and so
    is ``page_slots``: the latent pools keep the row commit. Writes the
    new latents in place; returns (hidden [B, T, D], kv_k, kv_v)."""
    del use_kernels, page_slots
    H = _local_heads(cfg, mesh)
    N, ps = kv_k.shape[1], kv_k.shape[3]
    inv_freq = rope_freqs(cfg, dim=cfg.qk_rope_head_dim,
                          device=tokens.device)
    rope = rope_cos_sin(positions.clamp(min=0), inv_freq)
    # the padding plan is shared by every layer: computed once
    plan = _drop_plan(flat_slots.reshape(-1).long(), N * ps)
    h = embed_tokens(params, cfg, tokens, mesh)
    for l in range(cfg.num_layers):
        lp, moe = _layer_params(cfg, params, l)
        x = rms_norm(h, lp["ln_attn"], cfg.rms_norm_eps)
        h = h + _mla_block(cfg, lp, x, rope, kv_k[l], kv_v[l], page_table,
                           positions, flat_slots, plan, H, mesh)
        x = rms_norm(h, lp["ln_mlp"], cfg.rms_norm_eps)
        h = h + _mlp_out(cfg, lp, x, moe, mesh)
    h = rms_norm(h, params["ln_final"], cfg.rms_norm_eps)
    return h, kv_k, kv_v


def make_step_fns(cfg: ModelConfig, use_kernels: bool = True,
                  mesh: Optional[MeshView] = None):
    """The (prefill_step, decode_step) pair, the contract of
    ``models/llama.py make_step_fns``; both write the pools in place.
    ``use_kernels`` is taken for that interface and ignored."""

    def prefill_step(params: Params, tokens, positions, kv_k, kv_v,
                     page_table, flat_slots, last_idx, page_slots=None):
        h, kv_k, kv_v = forward(params, cfg, tokens, positions, kv_k, kv_v,
                                page_table, flat_slots, mesh=mesh)
        return logits_at(params, cfg, h, last_idx, mesh), kv_k, kv_v

    def decode_step(params: Params, tokens, positions, kv_k, kv_v,
                    page_table, flat_slots):
        h, kv_k, kv_v = forward(params, cfg, tokens[:, None],
                                positions[:, None], kv_k, kv_v, page_table,
                                flat_slots[:, None], mesh=mesh)
        return project_logits(params, cfg, h[:, 0], mesh), kv_k, kv_v

    return prefill_step, decode_step


# -------------------------------------------------- full-attention reference


@torch.no_grad()
def reference_forward(params: Params, cfg: ModelConfig,
                      tokens: torch.Tensor) -> torch.Tensor:
    """Non-paged, non-absorbed MLA forward (per-head K/V materialised
    from the latents): the independent oracle of the paged, absorbed
    path. tokens [B, T] → logits [B, T, V] float32."""
    B, T = tokens.shape
    H = cfg.num_heads
    r, dn, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
    scale = _scale(cfg)
    dev = tokens.device
    inv_freq = rope_freqs(cfg, dim=cfg.qk_rope_head_dim, device=dev)
    pos = torch.arange(T, device=dev)[None, :].expand(B, T)
    rope = rope_cos_sin(pos, inv_freq)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
    h = embed_tokens(params, cfg, tokens)
    for l in range(cfg.num_layers):
        lp, moe = _layer_params(cfg, params, l)
        x = rms_norm(h, lp["ln_attn"], cfg.rms_norm_eps)
        q_nope, q_rope, c_kv, k_rope = _attn_inputs(cfg, lp, x, rope, H)
        k_nope = torch.einsum("btr,rhd->bthd", c_kv.float(),
                              lp["w_uk"].reshape(r, H, dn).float())
        v = torch.einsum("btr,rhd->bthd", c_kv.float(),
                         lp["w_uv"].reshape(r, H, dv).float())
        scores = (torch.einsum("bthd,bshd->bhts", q_nope.float(), k_nope)
                  + torch.einsum("bthd,bsd->bhts", q_rope.float(),
                                 k_rope.float())) * scale
        scores = scores.masked_fill(~causal[None, None], MASK_FILL)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhts,bshd->bthd", probs, v)
        h = h + out.reshape(B, T, H * dv).to(h.dtype) @ lp["w_o"]
        x = rms_norm(h, lp["ln_mlp"], cfg.rms_norm_eps)
        h = h + _mlp_out(cfg, lp, x, moe, None)
    h = rms_norm(h, params["ln_final"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return (h @ head).float()
