"""Data parallelism over ``torch.distributed``: one process (rank) per card.

The counterpart of ``connect4_tpu.parallel.mesh``. The JAX package shards
the leading axis of games and batches over a 1-D device mesh and lets XLA
insert the collectives; here each rank is a process of its own, launched by
``torchrun --nproc_per_node W``, that plays its block of the games and
trains on its rows of each batch, and the collectives are written out:

- self-play: rank r plays block r of the slot pool on its own card with no
  collective inside a wave; the ranks' outputs are gathered once at the end
  (``gather_output``);
- training: the parameters are replicated (``replicate``), each rank takes
  its contiguous rows of a batch (``shard_batch``), and the BatchNorm
  statistics, the loss normalisers and the gradients are all-reduced
  (``models.net``, ``training.learner``).

``Mesh`` carries what every collective needs: the process group, this
rank, the world size, this rank's device and the backend. The backend is
named by the caller (``initialize_distributed``): NCCL when every rank has
a card of its own, gloo on the CPU and where several ranks share one card,
which NCCL refuses. Nothing retries a failed collective on another backend.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from connect4_tpu_torch.utils import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")
# the gating match runs on rank 0 while the other ranks wait at the next
# generation's first collective: long enough for a match at full depth
TIMEOUT = datetime.timedelta(hours=2)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: every rank of ``group`` holds a replica of the net
    and a block of the games and rows."""

    shape: Tuple[int, ...]
    group: object  # a torch.distributed ProcessGroup
    rank: int
    world_size: int
    device: torch.device  # this rank's device
    backend: str

    def rows(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` rows."""
        if n % self.world_size:
            raise ValueError(f"{n} rows do not divide over {self.world_size} ranks")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks, in place; returns it."""
        dist.all_reduce(tensor, group=self.group)
        return tensor

    def broadcast(self, tensor: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``tensor`` on every rank, in place; returns it."""
        dist.broadcast(tensor, src=0, group=self.group)
        return tensor

    def barrier(self) -> None:
        """Wait for every rank (a one-element all-reduce on this rank's
        device, which every backend supports on every device)."""
        self.all_reduce(torch.zeros(1, device=self.device))

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (a decision that a file on disk
        drives, which the ranks could otherwise read at different times)."""
        return bool(self.broadcast(torch.tensor([int(flag)], device=self.device)).item())

    def fork_generator(self, generator: torch.Generator) -> torch.Generator:
        """A generator of this rank's own, seeded from ``generator`` (which
        is in the same state on every rank): the ranks draw different noise
        and openings, and the same run draws the same ones again."""
        seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
        return torch.Generator(device=self.device).manual_seed(seed + self.rank)


class _AllReduce(torch.autograd.Function):
    """Sum over the ranks with a gradient: the gradient of a rank's input is
    the sum over the ranks of the gradients of the output."""

    @staticmethod
    def forward(ctx, tensor, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(tensor.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.clone()), None


def all_reduce_with_grad(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``tensor`` summed over the ranks, differentiably (a new tensor)."""
    return _AllReduce.apply(tensor, mesh)


def local_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``cuda`` without an index (or None) means
    ``cuda:<LOCAL_RANK>``, one card a rank as torchrun numbers them; a device
    with an index, or the CPU, as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return resolve_device(dev)


def initialize_distributed(
    backend: str,
    device: DeviceLike = None,
    init_method: str = "env://",
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> None:
    """Join the process group: by default from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); a test
    passes ``init_method`` (``file://...``), ``rank`` and ``world_size``.
    ``backend`` is ``"nccl"`` (one card a rank; ``device`` becomes the
    rank's current card) or ``"gloo"`` (CPU ranks, or several ranks on one
    card). A no-op when the group already exists."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: name one of {BACKENDS}")
    if dist.is_initialized():
        return
    dev = local_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
        torch.cuda.set_device(dev)
    given = {k: v for k, v in (("rank", rank), ("world_size", world_size)) if v is not None}
    dist.init_process_group(backend, init_method=init_method, timeout=TIMEOUT, **given)


def make_mesh(shape: Optional[Tuple[int, ...]] = None, device: DeviceLike = None) -> Mesh:
    """The mesh of every rank of the initialised process group. ``shape``
    (default ``(world_size,)``) must multiply to the world size: a mesh is
    never quietly smaller than what the caller asked for. Raises when no
    group has been initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"mesh shape {shape}: no torch.distributed process group is initialised; "
            "launch one process per card with `torchrun --nproc_per_node N` (the CLI "
            "calls initialize_distributed) or call initialize_distributed first"
        )
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} ranks, the group has {world}")
    dev = local_device(device)
    backend = str(dist.get_backend())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
    return Mesh(shape, dist.group.WORLD, dist.get_rank(), world, dev, backend)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, torch.optim.Optimizer):  # in parameter order, the same on every rank
        for group in obj.param_groups:
            for p in group["params"]:
                state = obj.state.get(p, {})
                yield from (state[k] for k in sorted(state) if isinstance(state[k], torch.Tensor))
    else:
        for item in obj:
            yield from _tensors(item)


@torch.no_grad()
def replicate(obj, mesh: Mesh):
    """Make every rank's copy of ``obj`` rank 0's, in place: a tensor, a
    module (parameters and buffers), an optimiser (its state tensors, such
    as momentum buffers), or a sequence of these such as a ``TrainState``.
    Returns ``obj``."""
    for t in _tensors(obj):
        mesh.broadcast(t.data)
    return obj


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous rows of ``x`` (raises unless they divide)."""
    return x[mesh.rows(x.shape[0])]


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (of equal shapes) stacked along the first axis in
    rank order, on every rank. Sent as bytes, so any dtype goes through
    any backend."""
    x = x.contiguous()
    flat = x.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(mesh.world_size)]
    dist.all_gather(parts, flat, group=mesh.group)
    return torch.cat(parts).view(x.dtype).reshape((mesh.world_size * x.shape[0],) + tuple(x.shape[1:]))


def gather_output(output, mesh: Mesh):
    """The whole game-indexed output from each rank's block of it (a
    ``SelfPlayOutput``, or any named tuple of tensors whose first axis is
    the games), in rank order, on every rank."""
    return type(output)(*(all_gather_rows(x, mesh) for x in output))
