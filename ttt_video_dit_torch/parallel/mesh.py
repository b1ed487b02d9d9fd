"""The (replica, fsdp, tensor) device mesh and the process group under
torchrun (port of ttt_video_dit_tpu/parallel/mesh.py and of the JAX
entry's ``init_distributed``, train.py at the repo root).

- ``replica``: HSDP's replication axis (FSDP2's replicate dimension);
- ``fsdp``: the parameter and moment shards (FSDP2's shard dimension);
- ``tensor``: head tensor parallelism (parallel/sharding.py).

The batch is sharded over (replica, fsdp) jointly. Rank r sits at the
coordinates of r in ``np.arange(n).reshape(replica, fsdp, tensor)``, as JAX
lays its device array out (``init_device_mesh`` numbers ranks row-major the
same way), so ``tensor`` is the innermost axis and a rank's data rank is
``rank // tensor``: the reference's effective rank. The ranks of one tensor
group take the same batch shard and the same draws.

Under torchrun (``WORLD_SIZE`` set) each rank joins the process group: NCCL
on ``cuda:LOCAL_RANK``, or gloo when ``--job.platform cpu`` asks for the CPU.
Without it an entry runs in one process with no mesh, as before.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

REPLICA, FSDP, TENSOR = "replica", "fsdp", "tensor"
AXES = (REPLICA, FSDP, TENSOR)
FLAGS = ("--parallelism.dp_replicate", "--parallelism.dp_sharding", "--parallelism.tp_sharding")


def mesh_shape(dp_replicate: int, dp_sharding: int, tp_sharding: int, n: int) -> tuple[int, int, int]:
    """The (replica, fsdp, tensor) sizes for ``n`` ranks: ``dp_sharding = -1``
    takes what replica and tensor leave, and the product must be ``n``.
    Raises ValueError naming the flags otherwise (the JAX package asserts the
    same, mesh.py:51-58)."""
    sizes = (dp_replicate, dp_sharding, tp_sharding)
    for flag, size in zip(FLAGS, sizes):
        if size < 1 and not (flag == FLAGS[1] and size == -1):
            raise ValueError(f"{flag} {size}: a mesh size is at least 1 (--parallelism.dp_sharding may be -1)")
    named = ", ".join(f"{flag} {size}" for flag, size in zip(FLAGS, sizes) if size != 1) or ", ".join(
        f"{flag} {size}" for flag, size in zip(FLAGS, sizes))
    if dp_sharding == -1:
        if n % (dp_replicate * tp_sharding):
            raise ValueError(f"device count {n} not divisible by replica({dp_replicate}) * tensor({tp_sharding}) "
                             f"({named})")
        dp_sharding = n // (dp_replicate * tp_sharding)
    if dp_replicate * dp_sharding * tp_sharding != n:
        raise ValueError(f"mesh {dp_replicate}x{dp_sharding}x{tp_sharding} != {n} devices ({named}: the sizes must "
                         f"multiply to the world size)")
    return dp_replicate, dp_sharding, tp_sharding


def world_size() -> int:
    """The ranks of the process group, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def build_mesh(dp_replicate: int = 1, dp_sharding: int = -1, tp_sharding: int = 1,
               device_type: str = "cuda") -> DeviceMesh:
    """The global (replica, fsdp, tensor) mesh over the process group's ranks."""
    shape = mesh_shape(dp_replicate, dp_sharding, tp_sharding, world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def data_rank(mesh: DeviceMesh | None) -> int:
    """This rank's index among the data ranks (replica x fsdp): rank // tensor."""
    if mesh is None:
        return 0
    replica, fsdp, _ = mesh.get_coordinate()
    return replica * mesh.size(1) + fsdp


def data_size(mesh: DeviceMesh | None) -> int:
    """The data ranks: replica x fsdp."""
    return 1 if mesh is None else mesh.size(0) * mesh.size(1)


def tensor_rank(mesh: DeviceMesh | None) -> int:
    """This rank's index in its tensor group."""
    return 0 if mesh is None else mesh.get_local_rank(TENSOR)


def is_main_process() -> bool:
    """Rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def say(*args, **kwargs) -> None:
    """``print`` on the main process only."""
    if is_main_process():
        print(*args, **kwargs)


def world_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the process group's ranks (``t`` without one)."""
    if not dist.is_initialized():
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t / dist.get_world_size()


def barrier() -> None:
    """Wait for every rank of the process group (nothing without one)."""
    if dist.is_initialized():
        dist.barrier()


def init_distributed(device: torch.device) -> bool:
    """Under torchrun, join the process group: NCCL on ``device``
    (``cuda:LOCAL_RANK``, resolved by the entry), gloo on the CPU. Returns
    whether a group was joined (False without torchrun)."""
    if "WORLD_SIZE" not in os.environ:  # torchrun sets it
        return False
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    return True


def end_distributed() -> None:
    """Wait for every rank, then leave the process group."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
