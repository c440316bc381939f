"""Self-speculative decoding: model-free prompt-lookup drafting.

The port's copy of ``dynamo_tpu/engine/spec_decode.py``. A sequence's own
history (prompt + generated tokens) is the draft model: the longest
suffix n-gram that also occurs earlier in the history predicts its
historical continuation, and ONE batched ``[B, K+1]`` verify forward
(``models/llama.py make_verify_fn``) checks the drafts, keeping the
longest prefix that matches the greedy targets plus one bonus token
(``engine/sampling.py verify_greedy_draft``). The lookup is a host-side
numpy scan, so the device sees one static verify graph per bucket.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def propose_ngram_draft(tokens: Sequence[int], max_draft: int,
                        ngram_max: int, ngram_min: int = 1) -> List[int]:
    """Propose up to ``max_draft`` tokens continuing ``tokens``.

    Matches the longest suffix n-gram (``ngram_max`` down to
    ``ngram_min`` tokens, the last of which is the pending decode input)
    against every earlier position in the history. Among the hits, the
    most recent one that can supply a full ``max_draft``-token
    continuation wins (short-period greedy loops would otherwise always
    truncate the draft to their period), else the hit with the longest
    continuation. Returns [] when nothing matches.
    """
    L = len(tokens)
    if max_draft <= 0 or L < ngram_min + 1:
        return []
    arr = np.asarray(tokens, dtype=np.int64)
    for n in range(min(ngram_max, L - 1), max(ngram_min, 1) - 1, -1):
        pat = arr[L - n:]
        # candidate starts 0..L-1-n: strictly earlier than the suffix
        # itself, but allowed to overlap it (self-periodic continuations)
        hay = np.lib.stride_tricks.sliding_window_view(arr[:L - 1], n)
        hits = np.nonzero((hay == pat).all(axis=1))[0]
        if hits.size == 0:
            continue
        avail = (L - hits) - n  # continuation tokens before history ends
        full = hits[avail >= max_draft]
        # hits ascend, so avail descends: argmax picks the longest
        # continuation when no hit can fill the whole draft
        start = int(full[-1]) if full.size else int(hits[np.argmax(avail)])
        follow = arr[start + n:start + n + max_draft]
        if follow.size:
            return [int(t) for t in follow]
    return []
