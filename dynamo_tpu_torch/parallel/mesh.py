"""Tensor-parallel mesh over ``torch.distributed``, and the Megatron
sharding of the params and the KV pool.

The counterpart of ``dynamo_tpu/parallel/mesh.py``. The JAX package runs
one SPMD program over a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives; here one process runs per rank and the model calls them
itself (``models/llama.py``: an all-reduce after ``wo``, after ``w_down``
and after the vocab-sharded embedding lookup, an all-gather of the
vocab-sharded logits).

The specs are the JAX package's, keyed as there: one mesh axis name (or
None) per dimension, as a ``PartitionSpec`` lists them. A rank's shard
is the contiguous block of each named dimension at the rank's coordinate
on that axis, which is how ``NamedSharding`` splits an array; a
dimension that does not divide raises. Contiguous blocks of the head
axis keep each GQA group on one rank while ``num_kv_heads`` divides.

Ranks are laid out with ``model`` innermost, as ``MeshSpec.build`` of the
JAX package lays out its devices: rank = data_rank * model + model_rank.
This slice serves ``model=N, data=1``: :meth:`MeshSpec.build` refuses a
data axis (not ported yet), while :meth:`MeshSpec.view` gives any rank's
coordinates without process groups, as the sharded attention wrappers
and the tests take them.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from ..models.quant import QuantInt8, quantize_int8, quantize_rows, scale_of

log = logging.getLogger("dynamo_tpu_torch.parallel")

Spec = Tuple[Optional[str], ...]

# rendezvous and the device group's collectives
INIT_TIMEOUT = datetime.timedelta(minutes=10)
# control messages: a follower waits in its receive for as long as the
# server idles (rank 0 exiting closes the socket, which ends the wait)
CONTROL_TIMEOUT = datetime.timedelta(days=365)


@dataclass(frozen=True)
class MeshView:
    """One rank's place in a ``data x model`` mesh: its coordinates, its
    device, the group of its ``model`` axis for the model's collectives
    (``group``: NCCL on the card, gloo on the CPU) and a gloo group of
    every rank for control messages (``cpu_group``). Both groups are None
    in a view made without processes (:meth:`MeshSpec.view`)."""

    data: int
    model: int
    rank: int
    device: torch.device
    group: Any = None
    cpu_group: Any = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> str:
        """The JAX engine's ``mesh_shape``: the axes above 1 as
        ``axis=N`` pairs, or ``"single"``."""
        axes = [f"{k}={v}" for k, v in (("data", self.data),
                                         ("model", self.model)) if v > 1]
        return ",".join(axes) or "single"

    def coordinate(self, axis: str) -> int:
        return {"data": self.data_rank, "model": self.model_rank}[axis]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model axis, in place (no-op at model=1)."""
        if self.model > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """The model axis's blocks of ``t`` [..., n] joined along the last
        dimension, in rank order: [..., model * n]."""
        if self.model == 1:
            return t
        t = t.contiguous()
        # the blocks one after the other along dim 0 (the form both NCCL
        # and gloo take), then each rank's block moved beside the others
        out = torch.empty((self.model * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=self.group)
        out = out.view(self.model, *t.shape)
        return torch.movedim(out, 0, -2).reshape(
            *t.shape[:-1], self.model * t.shape[-1])


@dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    model: int = 1

    def __post_init__(self) -> None:
        if self.data < 1 or self.model < 1:
            raise ValueError(f"mesh axes must be >= 1: {self}")

    @property
    def num_devices(self) -> int:
        return self.data * self.model

    def view(self, rank: int, device="cuda", group=None,
             cpu_group=None) -> MeshView:
        """Rank ``rank``'s view without process groups (its coordinates,
        for the sharding and the sharded wrappers)."""
        if not 0 <= rank < self.num_devices:
            raise ValueError(f"rank {rank} outside a mesh of "
                             f"{self.num_devices}")
        return MeshView(self.data, self.model, rank, torch.device(device),
                        group, cpu_group)

    def build(self, device_type: str = "cuda") -> MeshView:
        """This process's view, once :func:`initialize_multihost` has run:
        its device (``cuda:{LOCAL_RANK % device_count}``, or the CPU), the
        device group (NCCL on the card, gloo on the CPU) and the gloo
        control group. One eager all-reduce on the device group brings up
        its communicator here: ProcessGroupNCCL makes it at the first
        collective, which must not fall inside a CUDA-graph capture."""
        if self.data > 1:
            raise NotImplementedError(
                "the data axis inside one engine is not ported yet: the "
                "port serves model=N, data=1")
        if not dist.is_initialized():
            raise RuntimeError("MeshSpec.build: call initialize_multihost "
                               "first")
        size, rank = dist.get_world_size(), dist.get_rank()
        if size != self.num_devices:
            raise ValueError(f"mesh of {self.num_devices} ranks over a "
                             f"process group of {size}")
        if device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("MeshSpec.build: no CUDA GPU available")
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(device)
            backend = "nccl"
        elif device_type == "cpu":
            device, backend = torch.device("cpu"), "gloo"
        else:
            raise ValueError(f"unsupported device type {device_type!r}")
        group = dist.new_group(backend=backend, timeout=INIT_TIMEOUT)
        cpu_group = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
        probe = torch.ones(1, device=device)
        dist.all_reduce(probe, group=group)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if int(probe.item()) != size:
            raise RuntimeError(f"device group all-reduce gave "
                               f"{probe.item()}, expected {size}")
        log.info("rank %d/%d on %s: device group %s, control group gloo",
                 rank, size, device, backend)
        return self.view(rank, device, group, cpu_group)


def initialize_multihost(coordinator: str, num_processes: int,
                         process_id: int) -> None:
    """Join the process group (the JAX package's
    ``jax.distributed.initialize``). ``coordinator`` is ``host:port`` of
    process 0's rendezvous (TCP), or an init URL (``tcp://...``,
    ``file://...``); every process passes the same value. The default
    group is gloo; :meth:`MeshSpec.build` adds the device group."""
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group("gloo", init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=INIT_TIMEOUT)


def leave_process_groups(mesh: Optional[MeshView] = None) -> None:
    """Leave the process groups in order, once the rank's work is done:
    the mesh's device and control groups (:meth:`MeshSpec.build`), then
    the default group (:func:`initialize_multihost`). Each destroy joins
    the group's threads and closes its connections; a gloo rank that
    exits with them still open can abort at interpreter exit. The ranks
    first meet on the control group, so no rank closes a connection a
    peer is still reading. Does nothing outside a process group, nor on
    the card: there the engine's captured graphs still hold the NCCL
    device group's communicator, and destroying it under them blocks the
    rank, so it leaves at exit."""
    if not dist.is_initialized():
        return
    if mesh is not None and mesh.device.type == "cuda":
        return
    if mesh is not None and mesh.cpu_group is not None:
        dist.barrier(group=mesh.cpu_group)
    for group in (mesh.group, mesh.cpu_group) if mesh is not None else ():
        if group is not None:
            dist.destroy_process_group(group)
    dist.destroy_process_group()


# ------------------------------------------------------------ sharding


def param_pspecs(cfg: ModelConfig) -> Dict[str, Spec]:
    """Megatron-style specs of the params (the JAX package's
    ``param_pspecs``): column-parallel q/k/v, gate and up, row-parallel o
    and down, vocab-sharded embedding and head; norms replicated. MoE:
    the router replicated, each expert's gate and up column-parallel and
    its down row-parallel (the JAX package's specs with its ``expert``
    axis at 1: the port's mesh has no expert axis). MLA: heads live only
    in the up-projections (``w_q``/``w_uq``, ``w_uk``, ``w_uv``), which
    are column-parallel, and ``w_o`` is row-parallel; the latent path
    (``w_dkv``, ``kv_norm``, ``w_dq``, ``q_norm``) is replicated.
    DeepSeek-MoE: the dense-first and shared-expert MLPs Megatron-style,
    each routed expert's gate and up column-parallel and its down
    row-parallel (the ``expert`` axis at 1 again), the router and its
    bias replicated."""
    specs: Dict[str, Spec] = {
        "embed": ("model", None),
        "wq": (None, None, "model"),
        "wk": (None, None, "model"),
        "wv": (None, None, "model"),
        "wo": (None, "model", None),
        "w_gate": (None, None, "model"),
        "w_up": (None, None, "model"),
        "w_down": (None, "model", None),
        "ln_attn": (None, None),
        "ln_mlp": (None, None),
        "ln_attn_post": (None, None),
        "ln_mlp_post": (None, None),
        "q_norm": (None, None),
        "k_norm": (None, None),
        "ln_final": (None,),
        "lm_head": (None, "model"),
    }
    if cfg.is_mla:
        specs.update({
            "w_dkv": (None, None, None),
            "kv_norm": (None, None),
            "w_uk": (None, None, "model"),
            "w_uv": (None, None, "model"),
            "w_o": (None, "model", None),
            "w_q": (None, None, "model"),
            "w_dq": (None, None, None),
            "w_uq": (None, None, "model"),
            "w_gate_d": (None, None, "model"),
            "w_up_d": (None, None, "model"),
            "w_down_d": (None, "model", None),
            "w_gate_e": (None, None, None, "model"),
            "w_up_e": (None, None, None, "model"),
            "w_down_e": (None, None, "model", None),
            "w_gate_s": (None, None, "model"),
            "w_up_s": (None, None, "model"),
            "w_down_s": (None, "model", None),
            "router_bias": (None, None),
        })
    if cfg.attn_bias:
        specs.update({"bq": (None, "model"), "bk": (None, "model"),
                      "bv": (None, "model")})
    if cfg.num_experts > 0:
        specs.update({"w_router": (None, None, None),
                      "w_gate": (None, None, None, "model"),
                      "w_up": (None, None, None, "model"),
                      "w_down": (None, None, "model", None)})
    return specs


def kv_cache_pspec(cfg: ModelConfig) -> Spec:
    """The pool ``[L, pages, kv_heads, page_size, head_dim]``: kv heads
    over ``model``, replicated over ``data`` (any row may reference any
    page). MLA's latent pools (one shared "head") are replicated."""
    if cfg.is_mla:
        return (None,) * 5
    return (None, None, "model", None, None)


def shard(a, spec: Spec, mesh: MeshView):
    """The rank's block of ``a`` (a numpy array or a tensor) under
    ``spec``, contiguous; ``a`` itself when no dimension is split."""
    index = []
    for dim, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        n = getattr(mesh, axis)
        if a.shape[dim] % n:
            raise ValueError(f"dimension {dim} of shape {tuple(a.shape)} "
                             f"does not split over {axis}={n}")
        step = a.shape[dim] // n
        c = mesh.coordinate(axis)
        index.append(slice(c * step, (c + 1) * step))
    if all(s == slice(None) for s in index):
        return a
    block = a[tuple(index)]
    if isinstance(block, np.ndarray):
        return np.ascontiguousarray(block)
    return block.contiguous()


def shard_param(name: str, a, cfg: ModelConfig, mesh: MeshView):
    """The rank's block of param ``name`` (replicated when it has no
    spec, as in the JAX package). An int8 weight (``models/quant.py
    QuantInt8``) is cut as the JAX package's ``shard_params`` cuts it:
    ``q`` under the param's spec (its last two axes swapped, since ``q``
    is stored ``[..., out, in]``), ``s [..., 1, out]`` under the same spec
    with the contraction axis unsharded. So a column-parallel weight cuts
    its scales along ``out`` and a row-parallel one keeps them whole."""
    spec = param_pspecs(cfg).get(name, (None,) * len(a.shape))
    if isinstance(a, QuantInt8):
        return QuantInt8(shard(a.q, (*spec[:-2], spec[-1], spec[-2]), mesh),
                         shard(a.s, (*spec[:-2], None, spec[-1]), mesh),
                         a.plain)
    return shard(a, spec, mesh)


def quantize_shard(name: str, w: torch.Tensor, cfg: ModelConfig,
                   mesh: MeshView) -> QuantInt8:
    """Quantize the rank's shard ``w [..., in, out]`` of param ``name``
    to the scales of the whole param: where the spec splits the
    contraction axis (a row-parallel weight), the per-rank amax is
    all-reduced with MAX over the model axis first, so the scales, and
    with them every int8 value, are those of quantizing the whole weight
    and cutting it (a per-shard amax would not be). A stack is quantized
    one matrix (a layer's, or a layer's expert's) at a time."""
    spec = param_pspecs(cfg).get(name, (None,) * w.dim())
    if spec[-2] is None or mesh.model == 1:
        return quantize_int8(w)

    def rows(wt: torch.Tensor) -> QuantInt8:
        amax = wt.float().abs().amax(dim=-1, keepdim=True)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=mesh.group)
        return quantize_rows(wt, scale_of(amax))

    return quantize_int8(w, rows)


def shard_params(params: Dict[str, Any], cfg: ModelConfig,
                 mesh: MeshView) -> Dict[str, Any]:
    return {k: shard_param(k, v, cfg, mesh) for k, v in params.items()}


def shard_kv_cache(kv_k, kv_v, cfg: ModelConfig, mesh: MeshView):
    spec = kv_cache_pspec(cfg)
    return shard(kv_k, spec, mesh), shard(kv_v, spec, mesh)


def local_heads(cfg: ModelConfig, mesh: Optional[MeshView]
                ) -> Tuple[int, int]:
    """(q heads, kv heads) a rank holds; raises unless both divide over
    the model axis (a GQA group never straddles two ranks)."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    tp = mesh.model if mesh is not None else 1
    if H % tp or KV % tp:
        raise ValueError(f"{H} heads and {KV} kv heads do not split over "
                         f"model={tp} (kv heads must divide, so that each "
                         f"GQA group stays on one rank)")
    return H // tp, KV // tp
