"""PyTorch and CUDA port of the dynamo-tpu serving engine.

The JAX package ``dynamo_tpu`` is the reference; this package keeps its
layouts (weights as ``x @ W`` stacked on a leading layer axis, the KV pool
as ``[L, pages, KV, page_size, head_dim]``) and imports nothing of it.
Entry points run on the GPU unless the caller asks for the CPU.
"""
