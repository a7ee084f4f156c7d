"""Process groups for the multi-device backends.

Counterpart of ``wembed_tpu/distributed/mesh.py``.  JAX runs one process
over P devices and shards work over a ``jax.sharding.Mesh``; the port runs
one process a rank (``torch.distributed``), each with its own device, and
the "mesh" is the default process group with that rank's device.

    python -m torch.distributed.run --standalone --nproc-per-node 1 -m wembed_tpu_torch.cli.embed \\
        -i graph.edg -o emb.csv --dim 2 --distributed replicated

The collectives: ``all_reduce`` (both backends), and for the halo backend
``all_to_all`` (``all_to_all_single``), ``all_gather``
(``all_gather_into_tensor``) and ``reduce_scatter``
(``reduce_scatter_tensor``; ``*_single`` where torch has those names).

NCCL refuses two ranks on one card; ``backend="gloo"`` lets several ranks
share one card.  Gloo takes CUDA tensors in all four collectives (checked
on an H100 under torch 2.11.0+cu128, ``PERF.md``) and copies them through
the host itself, so the mesh passes every tensor as it is, on either
backend.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..utils import rng as rng_mod


@dataclass(frozen=True)
class Mesh:
    """One rank of the default process group and its device."""

    rank: int
    size: int
    device: torch.device
    backend: str

    def all_reduce(self, tensor: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
        dist.all_reduce(tensor, op=op)

    def all_to_all(self, tensor: torch.Tensor) -> torch.Tensor:
        """(P, ...) blocks, block q to rank q; returns (P, ...) blocks, block
        q from rank q (the halo exchange)."""
        out = torch.empty_like(tensor)
        dist.all_to_all_single(out, tensor.contiguous())
        return out

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's (k, ...) rows, in rank order: (P k, ...)."""
        out = torch.empty((self.size * tensor.shape[0], *tensor.shape[1:]),
                          dtype=tensor.dtype, device=tensor.device)
        _all_gather(out, tensor.contiguous())
        return out

    def reduce_scatter(self, tensor: torch.Tensor) -> torch.Tensor:
        """(P k, ...) rows summed over the ranks; returns this rank's k rows
        of the sum."""
        out = torch.empty((tensor.shape[0] // self.size, *tensor.shape[1:]),
                          dtype=tensor.dtype, device=tensor.device)
        _reduce_scatter(out, tensor.contiguous())
        return out

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def share_host_stream(self) -> None:
        """Give every rank rank 0's host seed stream, so that what the ranks
        draw from it (initial coordinates, generator seeds, the hierarchy of
        a layered run) is the same even without a common ``setSeed``."""
        bits = rng_mod.host_rng().bit_generator
        bits.state = self.broadcast_object(bits.state)


# torch 2.13 names the one-tensor gather and reduce-scatter all_gather_single
# and reduce_scatter_single, and warns on the older names, which torch 2.11
# has alone
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join the default process group, or start it.  A no-op once a group
    exists.  Configuration, in priority order:

      1. explicit arguments (``coordinator_address`` as host:port);
      2. ``WEMBED_COORDINATOR`` / ``WEMBED_NUM_PROCESSES`` /
         ``WEMBED_PROCESS_ID``, the JAX package's names;
      3. ``torch.distributed.run``'s ``MASTER_ADDR`` / ``MASTER_PORT`` /
         ``RANK`` / ``WORLD_SIZE``;
      4. none of them: a group of this process alone.

    ``backend`` defaults to NCCL where CUDA is available, else gloo.
    Returns True when the group spans more than one process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    address = coordinator_address or env.get("WEMBED_COORDINATOR")
    if num_processes is None and env.get("WEMBED_NUM_PROCESSES"):
        num_processes = int(env["WEMBED_NUM_PROCESSES"])
    if process_id is None and env.get("WEMBED_PROCESS_ID"):
        process_id = int(env["WEMBED_PROCESS_ID"])
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if address is not None:
        dist.init_process_group(
            backend, init_method=f"tcp://{address}", world_size=num_processes, rank=process_id
        )
    elif "MASTER_ADDR" in env:
        dist.init_process_group(
            backend,
            world_size=num_processes if num_processes is not None else int(env["WORLD_SIZE"]),
            rank=process_id if process_id is not None else int(env["RANK"]),
        )
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size() > 1


def make_mesh(
    num_devices: int | None = None,
    backend: str | None = None,
    device: torch.device | str | None = None,
) -> Mesh:
    """This rank's ``Mesh``, starting the process group if there is none
    (``init_distributed``): one rank still makes a real one-rank group, so
    one rank runs the code that P ranks run.

    ``device`` defaults to ``cuda:LOCAL_RANK % device_count`` (the rank
    where torch.distributed.run sets no ``LOCAL_RANK``); a CPU mesh is
    asked for with ``device="cpu"``.  ``backend`` defaults to NCCL for
    CUDA and gloo for the CPU, and must be the group's when one exists.
    ``num_devices`` must equal the group's world size."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    init_distributed(backend=want)
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"the process group runs {have}, {backend} was asked for")
    if have == "nccl" and dev.type != "cuda":
        raise ValueError(f"the process group runs nccl, which reduces no {dev.type} tensors")
    rank, size = dist.get_rank(), dist.get_world_size()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"numDevices={num_devices}, but the process group has {size} ranks")
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(rank=rank, size=size, device=dev, backend=have)


def process_rank() -> int:
    """This process's rank in the default group, 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    """End the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
