"""Runtime pieces the port needs: the env registry and the engine context."""

from .engine import Annotated, AsyncEngine, Context

__all__ = ["Annotated", "AsyncEngine", "Context"]
