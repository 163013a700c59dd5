"""Data parallelism over torch.distributed (the port's counterpart of
regtr_tpu/parallel/mesh.py).

The JAX package runs one program over a one-dimensional `data` mesh: every
process's loader yields its own share of the global batch, the step is one
program over the global batch, and the parameters are replicated.  Here each
rank is one process on one device, launched by `torch.distributed.run`
(which sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT), and
the same step is spelled out with collectives:

  * the losses divide each rank's numerator by the global batch's
    denominator (`all_reduce_sum` of the local ones, which depend on no
    parameter), so the sum of the ranks' losses is the loss of the global
    batch;
  * the gradients are summed over the ranks in one flat fp32 buffer
    (`all_reduce_sum_flat`), so every rank applies the gradient of the
    global batch's loss and the parameters stay bitwise replicated;
  * metrics and per-pair errors are reduced or gathered where the JAX
    package reads them off the global batch.

With one process every function here is the identity and no group is made.
NCCL reduces on the card; Gloo (the CPU, or several ranks sharing one card)
reduces host copies of CUDA tensors.  `shard_batch` has no counterpart: each
rank moves its own batch to its own device.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as tdist

# seconds a collective waits for the other ranks before it raises
DEFAULT_TIMEOUT_S = 1800.0


def world_size() -> int:
    """The number of ranks of the process group, 1 without one."""
    return tdist.get_world_size() if tdist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return tdist.get_rank() if tdist.is_initialized() else 0


def resolve_device(requested: Optional[str] = None) -> torch.device:
    """The device this rank runs on: `requested` when given, else the card
    of this rank's LOCAL_RANK (cuda:0 for a process started alone)."""
    if requested:
        return torch.device(requested)
    return torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")


def init_distributed(backend: Optional[str] = None, device=None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group that `torch.distributed.run` describes in the
    environment.  The backend defaults to NCCL for a CUDA `device` and Gloo
    otherwise; a collective that one rank never reaches raises after
    `timeout` seconds.  Nothing happens with one process, or when a group
    exists already.  Returns whether this call made the group (and so
    should `shutdown` it)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or tdist.is_initialized():
        return False
    device = torch.device(device) if device is not None else None
    if backend is None:
        backend = "nccl" if device is not None and device.type == "cuda" \
            else "gloo"
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    tdist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    return True


def shutdown():
    """Leave the process group, where there is one."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def barrier():
    """Wait for every rank (multihost_utils.sync_global_devices)."""
    if world_size() > 1:
        if tdist.get_backend() == "nccl":
            tdist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            tdist.barrier()


def _comm_device() -> torch.device:
    """Where the backend reduces: the current card for NCCL, else the
    host."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, as a new tensor on t's device with no
    gradient; `t` itself with one process."""
    if world_size() == 1:
        return t
    buf = t.detach().to(_comm_device(), copy=True)
    tdist.all_reduce(buf)
    return buf.to(t.device)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of `x` over the ranks' tensors (each
    rank's sum over the global count); x.mean() with one process."""
    if world_size() == 1:
        return x.mean()
    return x.sum() / all_reduce_sum(x.new_tensor(float(x.numel())))


def all_reduce_sum_flat(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each tensor over the ranks, in one collective over one flat fp32
    buffer in list order; the tensors themselves with one process."""
    if world_size() == 1 or not tensors:
        return tensors
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    flat = all_reduce_sum(flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def allgather(t: torch.Tensor) -> torch.Tensor:
    """(world, *t.shape): every rank's `t` (of one shape on every rank), in
    rank order, on t's device; t[None] with one process."""
    if world_size() == 1:
        return t[None]
    buf = t.detach().to(_comm_device()).contiguous()
    parts = [torch.empty_like(buf) for _ in range(world_size())]
    tdist.all_gather(parts, buf)
    return torch.stack(parts).to(t.device)


def allgather_ragged(arr) -> np.ndarray:
    """The concatenation over the ranks, in rank order, of an array whose
    leading dimension differs by rank (evaluation.py `_allgather_ragged` of
    the JAX package): padded to the largest, gathered, unpadded.  float64;
    the array itself with one process."""
    arr = np.asarray(arr, np.float64)
    if arr.ndim == 0:
        arr = arr[None]
    if world_size() == 1:
        return arr
    ns = allgather(torch.tensor([arr.shape[0]], dtype=torch.int64))
    ns = ns.reshape(-1).tolist()
    padded = np.full((max(ns),) + arr.shape[1:], np.nan)
    padded[:arr.shape[0]] = arr
    gathered = allgather(torch.from_numpy(padded)).numpy()
    return np.concatenate([gathered[r, :n] for r, n in enumerate(ns)],
                          axis=0)


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (picklable); `obj` with one process."""
    if world_size() == 1:
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src=0)
    return box[0]
