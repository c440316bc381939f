"""Batched token sampling with per-request parameters, as one branchless
device program.

The PyTorch counterpart of ``dynamo_tpu/engine/sampling.py``
``sample_tokens``. Every row goes through the same fixed-shape ops, so a
fused decode window that samples can be captured in a CUDA graph and the
sampler never reads a device value on the host:

- greedy rows (temperature 0) take the FIRST index of the row's maximum
  (``torch.argmax``), which is what the JAX package's
  ``lax.top_k(...)[0]`` gives, so greedy decoding is token-identical,
  ties included (``torch.topk`` promises no order among ties);
- sampled rows apply temperature, take ``topk`` once with the static
  bound ``max_top_k``, mask per row by k, then top-p over the sorted
  candidates, and draw by Gumbel-max over the kept candidates. The noise
  is a counter-based hash of (seed, step, candidate rank), splitmix64 in
  int64 torch ops, evaluated on the device.

The JAX threefry stream has no torch equivalent: sampled tokens match the
JAX package in distribution, not bit for bit.

Penalties and logprobs as the JAX package applies them:
:func:`apply_penalties` (repetition over the whole context, then
frequency and presence over the generated tokens, then the additive
``logit_bias``, all on the raw logits before temperature),
:func:`update_penalty_state` (a window step's tokens folded into the
state) and :func:`logprob_aux` (log-probabilities of the RAW model
logits). :func:`fill_penalty_state` builds the (counts, presence) state
on the device from the rows' token ids, which is what the JAX engine's
``_penalty_state`` builds on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _i64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser on int64 bits (multiplication wraps)."""
    z = (z ^ _shr(z, 30)) * _i64(_MIX1)
    z = (z ^ _shr(z, 27)) * _i64(_MIX2)
    return z ^ _shr(z, 31)


def gumbel_noise(seeds: torch.Tensor, step: torch.Tensor,
                 n: int) -> torch.Tensor:
    """[B, n] float32 Gumbel(0, 1) noise, a pure function of (seed, step,
    candidate rank): splitmix64 stream ``mix((seed << 32) ^ step)``, whose
    (rank + 1)-th output gives the top 24 bits of a uniform in (0, 1)."""
    base = _mix64((seeds.to(torch.int64) << 32) ^ step.to(torch.int64))
    rank = torch.arange(1, n + 1, dtype=torch.int64, device=seeds.device)
    z = _mix64(base[:, None] + rank[None, :] * _i64(_GOLDEN))
    u = (_shr(z, 40).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


@dataclass
class SamplingBatch:
    """Per-row sampling parameters, padded to the decode batch size."""

    temperature: np.ndarray  # [B] float32; 0 → greedy
    top_k: np.ndarray        # [B] int32; 0 → disabled
    top_p: np.ndarray        # [B] float32; 1.0 → disabled
    seeds: np.ndarray        # [B] uint32 per-row RNG streams
    # OpenAI/HF penalties; neutral values disable each
    rep: np.ndarray          # [B] float32; 1.0 → disabled (HF semantics)
    freq: np.ndarray         # [B] float32; 0.0 → disabled
    pres: np.ndarray         # [B] float32; 0.0 → disabled

    @classmethod
    def build(cls, rows, pad_to: int) -> "SamplingBatch":
        """rows: SamplingOptions-like objects with .temperature, .top_k,
        .top_p, .seed (+ the penalty fields)."""
        temperature = np.zeros(pad_to, np.float32)
        top_k = np.zeros(pad_to, np.int32)
        top_p = np.ones(pad_to, np.float32)
        seeds = np.zeros(pad_to, np.uint32)
        rep = np.ones(pad_to, np.float32)
        freq = np.zeros(pad_to, np.float32)
        pres = np.zeros(pad_to, np.float32)
        for i, s in enumerate(rows):
            temperature[i] = s.temperature if s.temperature is not None else 0.0
            top_k[i] = s.top_k or 0
            top_p[i] = s.top_p if s.top_p is not None else 1.0
            seeds[i] = (s.seed if s.seed is not None
                        else np.random.randint(0, 2**31)) & 0xFFFFFFFF
            rep[i] = (s.repetition_penalty
                      if getattr(s, "repetition_penalty", None) else 1.0)
            freq[i] = getattr(s, "frequency_penalty", None) or 0.0
            pres[i] = getattr(s, "presence_penalty", None) or 0.0
        return cls(temperature, top_k, top_p, seeds, rep, freq, pres)

    @property
    def has_penalties(self) -> bool:
        return bool((self.rep != 1.0).any() or (self.freq != 0.0).any()
                    or (self.pres != 0.0).any())


def _on(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a tensor of ``dtype`` on ``device``: device tensors pass
    through (a cast at most); host arrays and scalars are uploaded."""
    if isinstance(x, np.ndarray) and x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.as_tensor(x, device=device).to(dtype)


def apply_penalties(logits: torch.Tensor, counts, presence, rep, freq, pres,
                    bias=None) -> torch.Tensor:
    """Sampling penalties on raw logits (before temperature), in vLLM's
    order and semantics, as the JAX package applies them:

    - repetition (HF ``RepetitionPenaltyLogitsProcessor``): tokens present
      ANYWHERE in the context (prompt + generated) get positive logits
      divided / negative logits multiplied by the penalty;
    - frequency/presence (OpenAI): subtract ``freq·count`` and
      ``pres·(count>0)`` where ``count`` is over GENERATED tokens only;
    - ``bias`` [B, V] (OpenAI ``logit_bias``): added last.

    counts: [B, V] generated-token counts; presence: [B, V] context
    presence; penalties are per-row [B]. A row with neutral rep, freq and
    pres gets exactly its logits plus its bias, whatever its state."""
    dev = logits.device
    rp = _on(rep, torch.float32, dev)[:, None]
    present = torch.as_tensor(presence, device=dev) > 0
    logits = torch.where(present & (rp != 1.0),
                         torch.where(logits > 0, logits / rp, logits * rp),
                         logits)
    cf = torch.as_tensor(counts, device=dev).to(torch.float32)
    logits = (logits - _on(freq, torch.float32, dev)[:, None] * cf
              - _on(pres, torch.float32, dev)[:, None] * (cf > 0))
    if bias is not None:
        logits = logits + _on(bias, torch.float32, dev)
    return logits


def update_penalty_state(penalties, sampled: torch.Tensor,
                         done: torch.Tensor):
    """Fold a window step's sampled tokens into the penalty state
    (out of place). ``done`` is the PRE-step mask: tokens sampled while a
    row was live are the ones the host will append. Returns the updated
    tuple, or None through the penalty-free path."""
    if penalties is None:
        return None
    counts, presence, rest = penalties[0], penalties[1], penalties[2:]
    rows = torch.arange(counts.shape[0], device=counts.device)
    idx = (rows, sampled.long())
    live = torch.logical_not(done).to(counts.dtype)
    counts = counts.index_put(idx, live, accumulate=True)
    presence = presence.index_put(idx, torch.maximum(
        presence[idx], live.to(presence.dtype)))
    return (counts, presence) + tuple(rest)


@torch.no_grad()
def fill_penalty_state(counts: torch.Tensor, presence: torch.Tensor,
                       ids: torch.Tensor, starts: torch.Tensor) -> None:
    """Rebuild, in place, the penalty state of the rows' host token lists
    (the JAX engine's ``_penalty_state``): ``counts`` [B, V] int32 of the
    GENERATED tokens and ``presence`` [B, V] int8 over the whole context,
    from ``ids`` [B, C] (each row's tokens, -1 padded) and ``starts`` [B]
    (the row's first generated position). Ids outside the vocabulary are
    skipped. Fixed-shape scatters: a padded entry adds 0 to the counts
    and re-marks the row's first token present (padding rows, all -1,
    write 0 to token 0)."""
    V = counts.shape[1]
    ids = ids.long()
    valid = (ids >= 0) & (ids < V)
    head = valid[:, :1]
    idx = torch.where(valid, ids,
                      torch.where(head, ids[:, :1], 0))
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    gen = valid & (pos >= starts.long()[:, None])
    counts.zero_()
    counts.scatter_add_(1, idx, gen.to(counts.dtype))
    presence.zero_()
    presence.scatter_(1, idx, (valid | head).to(presence.dtype))


@torch.no_grad()
def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p, seeds,
                  step, max_top_k: int = 64,
                  penalties=None) -> torch.Tensor:
    """Sample one token per row. logits: [B, V] float32; temperature /
    top_k / top_p / seeds: [B]; step: a scalar or per-row [B] decode-step
    counter (advances the row's stream); ``penalties``, when given, the
    tuple ``(counts, presence, rep, freq, pres[, bias])`` of
    :func:`apply_penalties`, applied first (greedy rows take the argmax
    of the penalised logits). On the device path pass device tensors:
    host arrays are uploaded, device values are never read back. Returns
    int32 [B] on the logits' device."""
    if penalties is not None:
        logits = apply_penalties(logits, *penalties)
    B, V = logits.shape
    dev = logits.device
    temperature = _on(temperature, torch.float32, dev)
    top_k = _on(top_k, torch.int32, dev)
    top_p = _on(top_p, torch.float32, dev)
    step = torch.broadcast_to(_on(step, torch.int64, dev), (B,))
    greedy = torch.argmax(logits, dim=-1)
    temp = torch.where(temperature > 0, temperature, 1.0)[:, None]
    k = min(max_top_k, V)
    vals, idx = torch.topk(logits / temp, k)  # descending
    ranks = torch.arange(k, device=dev)[None, :]
    eff_k = torch.where(top_k > 0, top_k.clamp(max=k), k)[:, None]
    vals = torch.where(ranks < eff_k, vals, float("-inf"))
    # top-p over the sorted candidates: always keep the first
    probs = torch.softmax(vals, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p[:, None]
    vals = torch.where(keep, vals, float("-inf"))
    noise = gumbel_noise(_on(seeds, torch.int64, dev), step, k)
    choice = torch.argmax(vals + noise, dim=-1, keepdim=True)
    sampled = torch.gather(idx, 1, choice)[:, 0]
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)


def logprob_aux(logits: torch.Tensor, chosen: torch.Tensor, topn: int):
    """(chosen_logprob [B], top_vals [B, topn], top_ids [B, topn] int32)
    over the RAW model logits: OpenAI logprobs describe the model's
    distribution, so penalties and temperature are not reflected (the
    JAX package's documented contract). ``torch.topk`` and ``lax.top_k``
    may order tied values differently."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tv, ti = torch.topk(logp, topn)
    return (logp.gather(1, chosen.long()[:, None])[:, 0], tv,
            ti.to(torch.int32))


@torch.no_grad()
def verify_greedy_draft(logits: torch.Tensor, draft: torch.Tensor,
                        draft_len: torch.Tensor):
    """Accept mask and bonus token of self-speculative decoding (greedy
    rows only), the JAX package's ``verify_greedy_draft`` as fixed-shape
    ops. logits: [B, K+1, V] from the verify forward (position j predicts
    the token after input j: input 0 is the row's pending decode token,
    inputs 1..K the draft); draft: [B, K]; draft_len: [B] valid drafts a
    row. The greedy target is :func:`sample_tokens`' greedy arm,
    ``torch.argmax`` (the first index of the maximum, as ``lax.top_k``
    gives), so speculation on or off gives the same tokens, ties
    included. Returns (out [B, K+1] int32: the accepted draft prefix, the
    bonus token, then -1; accepted [B] int32)."""
    B, K1, _ = logits.shape
    K = K1 - 1
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)      # [B, K+1]
    steps = torch.arange(K1, device=logits.device)[None, :]
    match = (draft.to(torch.int32) == greedy[:, :K]) & (
        steps[:, :K] < draft_len.long()[:, None])
    # the longest all-true prefix: cumprod zeroes everything past a miss
    accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    bonus = torch.gather(greedy, 1, accepted.long()[:, None])
    draft_ext = torch.cat([draft.to(torch.int32),
                           torch.zeros((B, 1), dtype=torch.int32,
                                       device=logits.device)], dim=1)
    acc = accepted[:, None]
    out = torch.where(steps < acc, draft_ext,
                      torch.where(steps == acc, bonus,
                                  torch.full_like(draft_ext, -1)))
    return out.to(torch.int32), accepted.to(torch.int32)
