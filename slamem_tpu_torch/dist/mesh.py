"""Process-group mesh and its collectives (port of
``slamem_tpu/dist/mesh.py``).

One process per rank and one device per process: rank r runs on
``cuda:(r % device_count)`` over NCCL, or on the CPU over gloo. The JAX
package lays one mesh over every chip its processes see; here a mesh is
``torch.distributed``'s world, one device per rank.

A ``Mesh`` with no process group is a world of one rank: its collectives
are identities. With a group the collectives go through it even at world
size 1, so a one-rank world still runs them on its device.

The JAX sharding helpers (``replicated``, ``row_sharded``,
``put_replicated``) have no counterpart: every process holds its own copy
of the index.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from slamem_tpu_torch.utils.device import resolve_device

# the launcher variables of the JAX package (either name of each), so one
# launcher drives both packages
_COORD = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
_NPROC = ("JAX_NUM_PROCESSES", "NUM_PROCESSES")
_PID = ("JAX_PROCESS_ID", "PROCESS_ID")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one run: world size, this process's rank, its device,
    and the process group (None: a world of one rank, no group)."""

    size: int
    rank: int
    device: torch.device
    group: object | None = None


def _env(names: tuple[str, str]) -> str | None:
    return next((os.environ[n] for n in names if os.environ.get(n)), None)


def initialize_multihost(device: str | torch.device = "cuda",
                         timeout_s: float = 600.0) -> bool:
    """Join the process group that the launcher variables describe.

    Reads the JAX package's variables: the coordinator ``host:port``
    (JAX_COORDINATOR_ADDRESS or COORDINATOR_ADDRESS), the process count
    (JAX_NUM_PROCESSES or NUM_PROCESSES) and this process's id
    (JAX_PROCESS_ID or PROCESS_ID). No coordinator: nothing to join. A
    CUDA ``device`` takes NCCL on ``cuda:(id % device_count)``, made the
    current device; the CPU takes gloo. A failed set-up raises; nothing
    falls back to another backend. The JAX package's cluster
    auto-detection (a coordinator without count or id) is not ported: that
    raises ValueError. The group is left at exit, after a barrier. Returns
    whether more than one process joined.
    """
    coord = _env(_COORD)
    if not coord:
        return False
    nproc, pid = _env(_NPROC), _env(_PID)
    if nproc is None or pid is None:
        missing = [" or ".join(names) for names, v in
                   ((_NPROC, nproc), (_PID, pid)) if v is None]
        raise ValueError(
            f"a coordinator address is set but {' and '.join(missing)} "
            "is not; cluster auto-detection is not supported")
    world, rank = int(nproc), int(pid)
    if not dist.is_initialized():
        dev = torch.device(device)
        kw = {}
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("a CUDA process group was asked for but "
                                   "torch.cuda.is_available() is False")
            local = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(local)
            # bound to its card, NCCL builds its communicator here, not
            # inside the first collective (which a stage span would time)
            backend, kw = "nccl", {"device_id": local}
        else:
            backend = "gloo"
        dist.init_process_group(
            backend, init_method=f"tcp://{coord}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s), **kw)
        atexit.register(_shutdown)
    return dist.get_world_size() > 1


def _shutdown() -> None:
    """Leave the group at exit, all ranks together (a process that exits
    with its group alive can abort in the group's teardown)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def world_size() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_output_process() -> bool:
    """True on the process that writes files and stdout: rank 0 (every
    process runs the same program; one must emit)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(n_devices: int | None = None,
              device: str | torch.device = "cuda") -> Mesh:
    """The mesh of ``n_devices`` ranks (default: the world) on this
    process's device. ``n_devices`` must be the world size, or 1: the
    one-rank view (no group: a collective over it returns its input)."""
    dev = resolve_device(device)
    world = world_size()
    n = world if n_devices is None else n_devices
    if n == 1 and not (dist.is_initialized() and world == 1):
        return Mesh(1, 0, dev)
    if n != world:
        raise ValueError(f"requested {n} devices, only {world} present")
    return Mesh(world, dist.get_rank(), dev, dist.group.WORLD)


def all_gather_ragged(mesh: Mesh, t: torch.Tensor
                      ) -> tuple[torch.Tensor, list[int]]:
    """Every rank's ``t`` (any length along dim 0, the same trailing shape
    and dtype), concatenated in rank order, and each rank's length.

    The lengths are gathered first (one host read); each rank pads to the
    largest with -1, the tensors are gathered, trimmed and concatenated.
    """
    if mesh.group is None:
        return t, [int(t.shape[0])]
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    counts = [torch.empty_like(n) for _ in range(mesh.size)]
    dist.all_gather(counts, n, group=mesh.group)
    counts = torch.cat(counts).tolist()
    top = max(counts)
    if top == 0:      # every rank knows it: no rank sends anything
        return t, counts
    buf = torch.full((top, *t.shape[1:]), -1, dtype=t.dtype, device=t.device)
    buf[:t.shape[0]] = t
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]), counts


def _all_reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    if mesh.group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=op, group=mesh.group)
    return out


def all_reduce_max(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Elementwise maximum of ``t`` over the ranks (the JAX ``pmax``)."""
    return _all_reduce(mesh, t, dist.ReduceOp.MAX)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum of ``t`` over the ranks (the JAX ``psum``)."""
    return _all_reduce(mesh, t, dist.ReduceOp.SUM)
