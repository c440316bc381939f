"""Batched token sampling with per-request parameters.

The PyTorch counterpart of ``dynamo_tpu/engine/sampling.py``
``sample_tokens``. Greedy rows (temperature 0) take the FIRST index of
the row's maximum, which is what the JAX package's ``lax.top_k(...)[0]``
gives, so greedy decoding is token-identical, ties included. Sampled rows
apply temperature → top-k (static bound ``max_top_k``, per-row k) →
top-p over the sorted candidates → a categorical draw from a
``torch.Generator`` seeded per row from (seed, step). The JAX threefry
stream has no torch equivalent: sampled tokens match the JAX package in
distribution, not bit for bit. Penalties and logprobs are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


@dataclass
class SamplingBatch:
    """Per-row sampling parameters, padded to the decode batch size."""

    temperature: np.ndarray  # [B] float32; 0 → greedy
    top_k: np.ndarray        # [B] int32; 0 → disabled
    top_p: np.ndarray        # [B] float32; 1.0 → disabled
    seeds: np.ndarray        # [B] uint32 per-row RNG streams

    @classmethod
    def build(cls, rows, pad_to: int) -> "SamplingBatch":
        """rows: SamplingOptions-like objects with .temperature, .top_k,
        .top_p, .seed."""
        temperature = np.zeros(pad_to, np.float32)
        top_k = np.zeros(pad_to, np.int32)
        top_p = np.ones(pad_to, np.float32)
        seeds = np.zeros(pad_to, np.uint32)
        for i, s in enumerate(rows):
            temperature[i] = s.temperature if s.temperature is not None else 0.0
            top_k[i] = s.top_k or 0
            top_p[i] = s.top_p if s.top_p is not None else 1.0
            seeds[i] = (s.seed if s.seed is not None
                        else np.random.randint(0, 2**31)) & 0xFFFFFFFF
        return cls(temperature, top_k, top_p, seeds)


def _row_seed(seed: int, step: int) -> int:
    """splitmix64 of (seed, step): one independent stream per row and
    decode step."""
    z = ((int(seed) << 32) ^ int(step)) + 0x9E3779B97F4A7C15 & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@torch.no_grad()
def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p, seeds,
                  step, max_top_k: int = 64) -> torch.Tensor:
    """Sample one token per row. logits: [B, V] float32 on the device;
    temperature/top_k/top_p/seeds: [B] (host arrays or tensors); step: a
    scalar or per-row [B] decode-step counter. Returns int32 [B] on the
    logits' device."""
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temp = _host(temperature)
    rows = np.nonzero(temp > 0)[0]
    if rows.size == 0:
        return greedy
    tk, tp, sd = _host(top_k), _host(top_p), _host(seeds)
    st = np.broadcast_to(_host(step), (B,))
    out = greedy.clone()
    k = min(max_top_k, V)
    for i in rows.tolist():
        vals, idx = torch.topk(logits[i] / float(temp[i]), k)  # descending
        eff_k = min(int(tk[i]), k) if tk[i] > 0 else k
        vals[eff_k:] = float("-inf")
        probs = torch.softmax(vals, dim=-1)
        # top-p over the sorted candidates: always keep the first
        keep = (torch.cumsum(probs, dim=-1) - probs) < float(tp[i])
        probs = torch.softmax(torch.where(keep, vals, torch.full_like(
            vals, float("-inf"))), dim=-1)
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_row_seed(int(sd[i]), int(st[i])))
        choice = torch.multinomial(probs, 1, generator=gen)
        out[i] = idx[choice[0]].to(torch.int32)
    return out
