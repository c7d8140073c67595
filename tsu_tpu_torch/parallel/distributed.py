"""The multi-process runtime: one process per rank on ``torch.distributed``.

Counterpart of the ``jax.distributed`` runtime that
``tsu_tpu/parallel/mesh.py:multihost_initialize`` starts. After
:func:`initialize` (``parallel.multihost_initialize``), a mesh spans
processes and hosts: every entry of a :class:`~tsu_tpu_torch.parallel.Mesh`
carries the rank that holds it, each rank builds and sweeps only its own
shards, and the sharded paths trade halos and small results through the
functions here.

**Backend rule** (recorded in ``mesh_info`` and the runner's topology):

- an explicit ``backend=`` wins;
- ``"nccl"`` when this rank runs on a card and every rank of its host has a
  card of its own (``LOCAL_WORLD_SIZE <= torch.cuda.device_count()``);
- ``"gloo"`` when ranks share a card (NCCL refuses two ranks on one GPU) or
  run on the CPU.

Under gloo a tensor on a card is staged through a pinned host buffer: gloo's
point-to-point calls take CPU tensors only. Under NCCL the tensors go from
card to card as they are.

Nothing falls back: a process group that fails to form raises, as does a
second :func:`initialize`, and a rank whose card is missing raises
``ConfigurationError`` unless it asked for ``device="cpu"``.
"""

from __future__ import annotations

import collections
import datetime
import os
import socket
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from tsu_tpu_torch.config import ConfigurationError


@dataclass(frozen=True)
class Runtime:
    """The process group as this rank sees it. ``hosts`` and ``devices``:
    each rank's host name and device (as a string), gathered once."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    hosts: tuple
    devices: tuple

    @property
    def n_hosts(self) -> int:
        return len(set(self.hosts))

    @property
    def placements(self) -> list:
        """(host, device) of each rank: two equal entries share a card."""
        return list(zip(self.hosts, self.devices))


_RUNTIME: Optional[Runtime] = None


def runtime() -> Optional[Runtime]:
    """The runtime, or None before :func:`initialize` (one process drives
    every shard)."""
    return _RUNTIME


def initialized() -> bool:
    return _RUNTIME is not None


def rank() -> int:
    return 0 if _RUNTIME is None else _RUNTIME.rank


def world_size() -> int:
    return 1 if _RUNTIME is None else _RUNTIME.world_size


def n_hosts() -> int:
    return 1 if _RUNTIME is None else _RUNTIME.n_hosts


def backend() -> Optional[str]:
    return None if _RUNTIME is None else _RUNTIME.backend


def backend_for(device: torch.device, local_world_size: int, device_count: int,
                backend: Optional[str] = None) -> str:
    """The backend rule of the module docstring."""
    if backend is not None:
        return backend
    if device.type == "cuda" and local_world_size <= device_count:
        return "nccl"
    return "gloo"


def _env_int(name: str, given, default=None) -> int:
    if given is not None:
        return int(given)
    if name in os.environ:
        return int(os.environ[name])
    if default is None:
        raise ConfigurationError(f"{name} is not set: launch under torchrun or pass it")
    return int(default)


def initialize(*, init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None, backend: Optional[str] = None,
               device=None, timeout_s: float = 600.0) -> Runtime:
    """Form the process group and return the runtime.

    From ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``)
    or from the arguments: ``init_method`` (``"file://..."``,
    ``"tcp://host:port"``; default ``"env://"``), ``rank``, ``world_size``.
    Without ``LOCAL_RANK`` a rank's local rank is its rank and its host holds
    every rank. ``device``: default ``cuda:LOCAL_RANK mod device_count``,
    which raises ``ConfigurationError`` without CUDA; ``"cpu"`` runs the
    plain versions. ``backend``: the rule of the module docstring unless
    given. Raises RuntimeError when called twice."""
    global _RUNTIME
    if _RUNTIME is not None or dist.is_initialized():
        raise RuntimeError("the multi-process runtime is already initialised in this process")
    rank = _env_int("RANK", rank)
    world_size = _env_int("WORLD_SIZE", world_size)
    local_rank = _env_int("LOCAL_RANK", None, rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", None, world_size)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigurationError(
                f"rank {rank}: device {device} requested but CUDA is not available; pass "
                "device='cpu' for the plain PyTorch path")
        if device.index is None:
            device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    chosen = backend_for(device, local_world,
                         torch.cuda.device_count() if device.type == "cuda" else 0, backend)
    dist.init_process_group(chosen, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    placed = [None] * world_size
    dist.all_gather_object(placed, (socket.gethostname(), str(device)))
    _RUNTIME = Runtime(rank=rank, world_size=world_size, device=device, backend=chosen,
                       hosts=tuple(h for h, _ in placed), devices=tuple(d for _, d in placed))
    return _RUNTIME


def _require() -> Runtime:
    if _RUNTIME is None:
        raise RuntimeError("the multi-process runtime is not initialised "
                           "(parallel.multihost_initialize)")
    return _RUNTIME


def _staged(rt: Runtime) -> bool:
    """Whether tensors go through host memory (gloo) or as they are (NCCL)."""
    return rt.backend != "nccl"


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy of ``t``, pinned when ``t`` is on a card."""
    if not t.is_cuda:
        return t.contiguous()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def exchange(sends, recvs) -> list:
    """Point-to-point messages, posted together in one
    ``dist.batch_isend_irecv`` and waited for.

    ``sends``: (tensor, peer, tag) triples (a strided view is made
    contiguous first); ``recvs``: (shape, dtype, device, peer, tag). Every
    message between a pair of ranks has its own tag, so a pair that trades
    several messages at once (the up and the down halo of a two-rank ring)
    neither deadlocks nor swaps them: gloo matches by tag, and the ops are
    posted in tag order on both sides, the order NCCL matches by. Returns
    the received tensors in the order of ``recvs``, each on its device.
    Counts the calls by their (messages, bytes) sent in ``exchange.sizes``."""
    rt = _require()
    staged = _staged(rt)
    ops, out = [], []
    sent = 0
    for t, peer, tag in sends:
        buf = _host_copy(t) if staged else t.contiguous()
        ops.append((tag, dist.P2POp(dist.isend, buf, peer, tag=tag)))
        sent += buf.numel() * buf.element_size()
    for shape, dtype, device, peer, tag in recvs:
        device = torch.device(device)
        pin = staged and device.type == "cuda"
        buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else device,
                          pin_memory=pin)
        ops.append((tag, dist.P2POp(dist.irecv, buf, peer, tag=tag)))
        out.append((buf, device))
    if ops:
        ops.sort(key=lambda op: op[0])
        for work in dist.batch_isend_irecv([op for _, op in ops]):
            work.wait()
        exchange.sizes[(len(sends), sent)] += 1
    return [buf.to(device, non_blocking=True) for buf, device in out]


exchange.sizes = collections.Counter()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor on ``t``'s device): on
    the host under gloo, on this rank's card under NCCL."""
    rt = _require()
    if _staged(rt) and t.is_cuda:
        buf = _host_copy(t)
    elif _staged(rt) or t.device == rt.device:
        buf = t.clone(memory_format=torch.contiguous_format)
    else:
        buf = t.to(rt.device).contiguous()
    dist.all_reduce(buf)
    return buf.to(t.device)


def assemble(pieces: dict, n: int, device) -> torch.Tensor:
    """The concatenation of n equal pieces along their first axis, on every
    rank: ``pieces`` maps a piece's index to the tensor this rank holds.
    An all-gather of pieces a rank may hold any number of: the zero-padded
    stack is summed over the ranks, which is exact (x + 0 == x)."""
    some = next(iter(pieces.values()))
    full = torch.zeros((n, *some.shape), dtype=some.dtype, device=some.device)
    for s, x in pieces.items():
        full[s] = x.to(some.device)
    return all_reduce_sum(full).reshape(n * some.shape[0], *some.shape[1:]).to(device)


def shutdown():
    """Destroy the process group at the end of a rank's run."""
    global _RUNTIME
    _require()
    dist.destroy_process_group()
    _RUNTIME = None


def barrier():
    _require()
    if _RUNTIME.backend == "nccl":
        dist.barrier(device_ids=[_RUNTIME.device.index])
    else:
        dist.barrier()
