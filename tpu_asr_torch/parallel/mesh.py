"""Process groups and the batch layout of data and tensor parallelism over
torch.distributed (port of tpu_asr/parallel/mesh.py).

The reference lays its devices out as a jax.sharding.Mesh with a "data"
and a "model" axis, and GSPMD partitions one program over it. The port
runs one process (rank) per mesh position: rank r sits at (r // n_model,
r % n_model), as np.asarray(devices).reshape(n_data, n_model) places
device r. A rank's `data` group holds the ranks of its model column (the
gradients are summed over it), its `model` group the ranks of its data
row (the tensor-parallel partial sums are summed over it; see
parallel/sharding.py).

Every rank assembles the same host batch from the seeded loader, as the
reference's multi-host path does, and `shard_batch` slices this rank's
rows from it on the host. So the reference's make_global_batch, which
turns such host batches into global jax.Arrays, has no counterpart.

Backend: NCCL when every rank has a card of its own, gloo when ranks
share a card or run on the CPU (NCCL refuses two ranks on one device).
Gloo reduces and gathers CUDA tensors itself (it copies them through
host buffers of its own), so the collectives take the tensors where
they lie, under either backend, and the model never leaves the card.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def choose_backend(world_size: int, device: torch.device) -> str:
    """nccl when every rank has a card of its own, else gloo."""
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device: str | None) -> torch.device:
    """Rank r's device: the CPU when asked for, else cuda:(r mod the
    number of cards); RuntimeError when there is no card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(device: str | None = None) -> torch.device | None:
    """Join the process group that COORDINATOR_ADDRESS (host:port),
    NUM_PROCESSES and PROCESS_ID describe, the reference's variables.
    A no-op returning None when COORDINATOR_ADDRESS is unset; else this
    rank's device (rank_device), made current, with the backend
    (choose_backend) printed on stderr. CPU ranks split the host's
    threads (torch.get_num_threads() // NUM_PROCESSES each, at least 1).
    A process already in a group gets its device and joins nothing
    more."""
    address = os.environ.get("COORDINATOR_ADDRESS")
    if not address:
        return None
    world = int(os.environ.get("NUM_PROCESSES", "1"))
    rank = int(os.environ.get("PROCESS_ID", "0"))
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if dev.type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    backend = choose_backend(world, dev)
    print(f"rank {rank}/{world}: {backend} on {dev}", file=sys.stderr)
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT)
    return dev


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, world: int, port: int, target: str,
                args) -> None:
    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{port}",
                      NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
    module, name = target.split(":")
    try:
        getattr(importlib.import_module(module), name)(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(target: str, world: int, *args) -> None:
    """Run the function `target` ("package.module:function", imported in
    each process: a CLI's __main__ module works too) with `args` in
    `world` new processes on this host, each one rank of a process group
    on localhost (COORDINATOR_ADDRESS and the others set for
    initialize_distributed). Returns when all have ended; raises if any
    rank failed (the others are then stopped)."""
    import torch.multiprocessing as mp
    mp.spawn(_rank_entry, args=(world, free_port(), target, args),
             nprocs=world, join=True)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: its process group, the
    number of ranks on it and this rank's index there. Its collectives
    run on an axis of one rank too (they are the identity there, and a
    1-rank NCCL group still takes the NCCL route)."""
    group: object
    size: int
    index: int

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the axis in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_coalesced_(self, tensors: list[torch.Tensor]) -> None:
        """Sum each tensor over the axis in place, in one collective per
        dtype."""
        if not tensors:
            return
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = self.all_reduce_(torch.cat([t.reshape(-1) for t in group]))
            at = 0
            for t in group:
                t.copy_(flat[at: at + t.numel()].view_as(t))
                at += t.numel()

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The axis's tensors (equal shapes) concatenated along `dim`, in
        index order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def all_gather_object(self, obj) -> list:
        """The axis's picklable objects, in index order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an n_data x n_model layout."""
    n_data: int
    n_model: int
    rank: int
    data: Axis
    model: Axis


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh | None:
    """The mesh over ranks 0 .. n_data * n_model - 1 of the process group
    (n_data None: all ranks // n_model), with rank r at (r // n_model,
    r % n_model). Every rank of the group must call it (it makes the
    groups); a rank outside the mesh gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(initialize_distributed or "
                           "torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_data * n_model > world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} ranks; the group has {world}")
    axes = {}
    data_groups, model_groups = mesh_groups(n_data, n_model)
    for name, groups in (("data", data_groups), ("model", model_groups)):
        for ranks in groups:
            group = dist.new_group(ranks)
            if rank in ranks:
                axes[name] = Axis(group, len(ranks), ranks.index(rank))
    if not axes:
        return None
    return Mesh(n_data, n_model, rank, axes["data"], axes["model"])


def mesh_groups(n_data: int, n_model: int
                ) -> tuple[list[list[int]], list[list[int]]]:
    """The ranks of each data group (one per model coordinate: a column
    of the rank grid) and of each model group (one per data coordinate:
    a row), rank r sitting at (r // n_model, r % n_model)."""
    grid = np.arange(n_data * n_model).reshape(n_data, n_model)
    return grid.T.tolist(), grid.tolist()


@dataclasses.dataclass(frozen=True)
class Layout:
    """How the leading (batch) axis lies over a mesh axis: `shards`
    contiguous blocks, this rank holding block `index`."""
    shards: int
    index: int

    def rows(self, n: int) -> slice:
        if n % self.shards:
            raise ValueError(f"a batch of {n} rows does not split into "
                             f"{self.shards} equal shards (bucket batch "
                             f"sizes must be multiples of the data axis: "
                             f"make_buckets(batch_multiple=...))")
        per = n // self.shards
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh: Mesh) -> Layout:
    """The leading (batch) axis split along 'data' (the reference's
    P("data"))."""
    return Layout(mesh.n_data, mesh.data.index)


def replicated(mesh: Mesh) -> Layout:
    """Every rank holds every row (the reference's P())."""
    return Layout(1, 0)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """A host batch -> this rank's contiguous block of B / n_data rows of
    every array (numpy or tensor) in it, at the batch's padded shape.
    Other entries (the loader's `ids`, which lists the real utterances
    only) are left out."""
    layout = batch_sharding(mesh)
    return {k: v[layout.rows(len(v))] for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}
