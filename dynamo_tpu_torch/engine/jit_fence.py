"""Runtime capture fence: detect a CUDA-graph capture after warmup.

The counterpart of ``dynamo_tpu/engine/jit_fence.py``. The JAX engine's
``warmup()`` compiles its whole bucket grid so no compile happens while
serving; a fence armed at the end of warmup counts every compile after
it. The port's counterpart of a compiled program is a captured CUDA
graph (``engine/cuda_graphs.py``): ``TorchEngine.warmup()`` captures the
whole decode grid and arms this fence, and from then on every capture of
a new bucket counts as a compile. No monitoring hook is involved: the
graph runner reports each capture itself.

``DYN_JIT_FENCE`` picks the reaction, as in the JAX module:

- unset/empty — count only: the count shows in ``stats()`` as
  ``post_warmup_compiles_total`` (the JAX key);
- ``warn`` — also log a warning naming the bucket;
- ``raise`` — raise :class:`PostWarmupCompileError` before the capture.

A capture after warmup is also a step-timeline event (``compile``) and a
``post_warmup_compile`` trigger of the flight recorder
(``runtime/blackbox.py``), and arming the fence refreshes the recorder's
baseline, as in the JAX module.
"""

from __future__ import annotations

import logging

from ..runtime.config import env_str

log = logging.getLogger("dynamo_tpu_torch.engine.fence")


class PostWarmupCompileError(RuntimeError):
    """A CUDA graph was captured after warmup with DYN_JIT_FENCE=raise."""


class CompileFence:
    """Per-engine post-warmup capture counter and warn/raise tripwire."""

    def __init__(self, name: str, timeline=None):
        self.name = name
        self.timeline = timeline
        self.armed = False
        self.post_warmup_compiles = 0

    def arm(self) -> None:
        """Called at the end of warmup(): from here on, every capture
        counts against the no-capture serving invariant."""
        self.armed = True
        # end of warmup = steady state begins: the flight recorder's
        # pre-incident baseline of cost tables and caches
        from ..runtime import blackbox
        rec = blackbox.get_recorder()
        if rec.enabled:
            rec.refresh_baseline()

    def on_compile(self, form: str) -> None:
        """Report a capture (``form`` names it, e.g. the bucket) about to
        happen. Counts it when armed, then warns or raises per mode."""
        if not self.armed:
            return
        self.post_warmup_compiles += 1
        if self.timeline is not None:
            self.timeline.add("compile", form=form,
                              post_warmup_total=self.post_warmup_compiles)
        # a capture after warmup is an incident by definition (the
        # no-capture invariant broke); already on the cold capture path
        from ..runtime import blackbox
        blackbox.notify_trigger("post_warmup_compile", {
            "fence": self.name,
            "post_warmup_total": self.post_warmup_compiles,
            "last_dispatch_form": form,
        })
        mode = (env_str("DYN_JIT_FENCE") or "").strip().lower()
        msg = (f"CUDA-graph capture after warmup on {self.name} "
               f"({self.post_warmup_compiles} total): {form} is outside "
               f"the warmed grid")
        if mode == "raise":
            raise PostWarmupCompileError(msg)
        if mode == "warn":
            log.warning(msg)
