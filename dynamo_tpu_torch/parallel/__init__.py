"""Parallel layouts of the port (``parallel/mesh.py``)."""
