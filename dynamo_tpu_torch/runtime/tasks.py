"""Tracked background tasks, a copy of ``dynamo_tpu/runtime/tasks.py``.

Every background task of the runtime goes through :func:`spawn_tracked`,
which pins a strong reference (the event loop keeps only weak ones, so a
fire-and-forget task can be collected mid-flight) and logs a crash the
moment it happens; every ``stop()`` path goes through :func:`cancel_join`,
which bounds how long a wedged task can stall shutdown.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Coroutine, Optional, Set

log = logging.getLogger("dynamo_tpu_torch.tasks")

_BACKGROUND: Set[asyncio.Task] = set()


def spawn_tracked(coro: Coroutine, *, name: Optional[str] = None,
                  logger: Optional[logging.Logger] = None) -> asyncio.Task:
    """``asyncio.create_task`` with crash logging and GC pinning."""
    task = asyncio.create_task(coro, name=name)
    _BACKGROUND.add(task)
    task.add_done_callback(lambda t: _on_task_done(t, logger or log))
    return task


def _on_task_done(task: asyncio.Task, logger: logging.Logger) -> None:
    _BACKGROUND.discard(task)
    if task.cancelled():
        return
    exc = task.exception()  # marks the exception retrieved
    if exc is not None:
        logger.error("background task %r crashed", task.get_name(),
                     exc_info=exc)


async def cancel_join(*tasks: Optional[asyncio.Task],
                      timeout: float = 5.0) -> None:
    """Cancel task(s) and wait for them to exit. ``None`` entries are
    skipped; a task that ignores cancellation for ``timeout`` seconds is
    abandoned with a warning."""
    live = [t for t in tasks if t is not None]
    for t in live:
        t.cancel()
    if not live:
        return
    _done, pending = await asyncio.wait(live, timeout=timeout)
    for t in pending:
        log.warning("task %r ignored cancellation for %.1fs; abandoning",
                    t.get_name(), timeout)


def backoff_interval(base: float, failures: int, cap: float = 30.0) -> float:
    """Bounded exponential backoff for scrape/poll loops: ``base`` while
    healthy, doubling per consecutive failure up to ``cap``."""
    if failures <= 0:
        return base
    return min(base * (2.0 ** min(failures, 16)), max(cap, base))
