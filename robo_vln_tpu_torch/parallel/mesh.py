"""The data-parallel mesh (counterpart of robo_vln_tpu/parallel/mesh.py).

The JAX package trains one program over a ``jax.sharding.Mesh`` whose
"data" axis holds every visible device at the default ``TPU.MESH_SHAPE``
``[-1, 1]``; axis 0 of each batch entry is sharded over it and GSPMD
inserts the sums.  The port runs one process a rank of the data axis,
joined by a ``torch.distributed`` process group: NCCL on the card, gloo on
the CPU.  The same global batch gives the same losses, gradients and
weights as one process:

* ``DAGGER.BATCH_SIZE`` is per rank; the global batch is
  ``BATCH_SIZE × n_data`` (:func:`global_batch_size`), padded as the
  loader pads a tail batch.
* Every rank reads the same global batch, in the same order, and collates
  rows ``[r·b, (r+1)·b)`` of it (:meth:`DataMesh.rows`, the loaders'
  ``rows``) at the bucket of the global batch's longest episode: a rank
  that collated its own episodes would pick its own bucket.
* Every denominator of the losses (training/steps.py) is a count over the
  global batch: each rank's counts are summed across the ranks
  (:meth:`DataMesh.sum`) before any division, so each rank's loss is its
  share of the global loss, and the gradients summed across the ranks
  (:meth:`DataMesh.reduce_step`, one coalesced all-reduce, placed before
  the optimizer) are the gradient of the global loss.  The same
  all-reduce sums the losses, so the non-finite guard and the logged
  metrics read the global values on every rank.
* Rank 0 collects, featurizes, writes checkpoints and TensorBoard and
  logs; the other ranks wait for it (:meth:`DataMesh.on_main`) in a gloo
  group of their own whose timeout is :data:`MAIN_WORK_TIMEOUT`: a wait in
  the step's group would end at that group's timeout (NCCL's watchdog ends
  a collective after 10 minutes by default), and collection or
  featurizing a real buffer takes longer.  Every rank starts from rank 0's
  weights (:meth:`DataMesh.broadcast`).

``-1`` on the data axis means every visible CUDA device on the card, and
one process on the CPU.  With more than one rank, :func:`spawn` starts a
process a rank (run.py's ``run_exp``); rank ``r`` runs on ``cuda:r``.  One
rank needs no group: its mesh calls no collective, and the step is the
one-process step, bit for bit.  A group that is already up (of any size)
is the mesh's.

A "model" axis above 1 (tensor parallelism, ``param_shardings`` in JAX)
and other axis names are refused by ``get_config`` before any work
(config/default.check_mesh, ROADMAP §A item 7b).
"""

from __future__ import annotations

import datetime
import socket
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def visible_devices(device) -> int:
    """The devices the data axis can hold: every CUDA device on the card,
    one process on the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def data_axis_size(mesh_shape: Sequence[int], device) -> int:
    """The ranks of the data axis, -1 resolved as make_mesh resolves it."""
    n = int(mesh_shape[0])
    visible = visible_devices(device)
    if n == -1:
        return visible
    if torch.device(device).type == "cuda" and n > visible:
        raise RuntimeError(f"TPU.MESH_SHAPE puts {n} ranks on the data axis; "
                           f"{visible} CUDA devices are visible")
    return n


def global_batch_size(per_rank_batch: int, n_data: int) -> int:
    """Global batch = per-rank batch × data-axis size."""
    return per_rank_batch * n_data


def free_address() -> str:
    """A ``tcp://localhost:<port>`` address on a port that was free."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


# how long the other ranks wait for rank 0's work (on_main): longer than
# any collection or featurizing run
MAIN_WORK_TIMEOUT = datetime.timedelta(days=7)


def init_process_group(rank: int, size: int, address: str, device,
                       backend: Optional[str] = None,
                       timeout: Optional[datetime.timedelta] = None) -> None:
    """Join the group: NCCL for a CUDA device, gloo for the CPU, unless
    ``backend`` says otherwise (gloo takes CUDA tensors too, through the
    host, for two ranks on one card).  ``timeout`` bounds each of the
    step's collectives (torch's default when None)."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is not None:  # "cuda" is the current one
        torch.cuda.set_device(device)
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=address, rank=rank, world_size=size,
                            **kwargs)


class DataMesh:
    """This process's place on the data axis: ``size`` ranks, this one
    ``rank``, its tensors on ``device``.  Without a process group it is the
    one-rank mesh, whose collectives are not called (``distributed`` False):
    the steps then run the one-process code."""

    def __init__(self, device="cpu", size: Optional[int] = None, rank: Optional[int] = None):
        self.device = torch.device(device)
        self.distributed = dist.is_available() and dist.is_initialized()
        self.size = dist.get_world_size() if self.distributed else 1
        self.rank = dist.get_rank() if self.distributed else 0
        if (size is not None and size != self.size) or (rank is not None and rank != self.rank):
            raise RuntimeError(f"the process group holds rank {self.rank} of {self.size}; "
                               f"rank {rank} of {size} was asked for")
        self._wait_group = None

    @classmethod
    def for_config(cls, config, device) -> "DataMesh":
        """The mesh ``config``'s TPU.MESH_SHAPE asks for, from the process
        group that is up; more than one rank without a group raises (start
        them with :func:`spawn`, as run.py's run_exp does)."""
        n = data_axis_size(config.TPU.MESH_SHAPE, device)
        if n > 1 and not dist.is_initialized():
            raise RuntimeError(
                f"TPU.MESH_SHAPE {list(config.TPU.MESH_SHAPE)} puts {n} ranks on the data "
                "axis: train through python -m robo_vln_tpu_torch.run, which starts a "
                "process a rank")
        return cls(device, size=n)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, global_batch: int):
        """(lo, hi): this rank's rows [r·b, (r+1)·b) of a global batch."""
        if global_batch % self.size:
            raise ValueError(f"a global batch of {global_batch} does not split over "
                             f"{self.size} ranks")
        b = global_batch // self.size
        return self.rank * b, (self.rank + 1) * b

    def shard(self, window: Dict) -> Dict:
        """This rank's rows of every entry of a global window (views)."""
        if self.size == 1:
            return window
        lo, hi = self.rows(len(next(iter(window.values()))))
        return {k: v[lo:hi] for k, v in window.items()}

    def sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` summed over the ranks, in place."""
        if self.distributed:
            dist.all_reduce(tensor)
        return tensor

    def reduce_step(self, grads: Sequence[Optional[torch.Tensor]],
                    scalars: Sequence[torch.Tensor]):
        """(grads, scalars), each summed over the ranks in one all-reduce of
        a flat float32 buffer; None gradients (parameters the losses never
        reach, the same on every rank) stay None."""
        if not self.distributed:
            return list(grads), list(scalars)
        present = [g for g in grads if g is not None]
        flat = torch.cat([g.reshape(-1).float() for g in present]
                         + [s.detach().reshape(1).float() for s in scalars])
        dist.all_reduce(flat)
        out, offset = [], 0
        for g in grads:
            if g is None:
                out.append(None)
                continue
            out.append(flat[offset:offset + g.numel()].view(g.shape).to(g.dtype))
            offset += g.numel()
        return out, list(flat[offset:].unbind())

    def _waits(self):
        """The gloo group over the same ranks in which they wait for rank 0
        (made on first use, by every rank at the same call)."""
        if self._wait_group is None:
            self._wait_group = dist.new_group(backend="gloo", timeout=MAIN_WORK_TIMEOUT)
        return self._wait_group

    def barrier(self) -> None:
        """Every rank here before any goes on, waiting up to
        MAIN_WORK_TIMEOUT."""
        if self.distributed:
            dist.barrier(group=self._waits())

    def broadcast(self, *modules: torch.nn.Module) -> None:
        """Every parameter and buffer of ``modules`` set to rank 0's."""
        if not self.distributed:
            return
        with torch.no_grad():
            for module in modules:
                for t in module.state_dict(keep_vars=True).values():
                    dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, 0)

    def on_main(self, fn: Callable, *args, **kwargs):
        """``fn``'s result, computed on rank 0 while the others wait, then
        given to every rank (a picklable value)."""
        if not self.distributed:
            return fn(*args, **kwargs)
        box: List = [fn(*args, **kwargs) if self.is_main else None]
        dist.broadcast_object_list(box, 0, group=self._waits())
        return box[0]


def _rank_entry(rank: int, size: int, address: str, device_type: str, threads: int,
                group_timeout, fn: Callable, args) -> None:
    torch.set_num_threads(threads)
    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    init_process_group(rank, size, address, device, timeout=group_timeout)
    try:
        fn(rank, device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, size: int, device, *args, timeout_s: Optional[float] = None,
          group_timeout: Optional[datetime.timedelta] = None) -> None:
    """Run ``fn(rank, device, *args)`` in ``size`` spawned processes joined
    by a process group at a free localhost port (NCCL on ``cuda:rank``,
    gloo on the CPU; ``group_timeout`` as init_process_group's
    ``timeout``), each on ``threads / size`` intra-op threads.  A rank that
    raises ends the others and raises here; so does ``timeout_s`` passing
    with a rank still running."""
    import time

    import torch.multiprocessing as mp

    device_type = torch.device(device).type
    threads = max(1, torch.get_num_threads() // size)
    context = mp.start_processes(
        _rank_entry, args=(size, free_address(), device_type, threads, group_timeout, fn, args),
        nprocs=size, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while not context.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for proc in context.processes:
                proc.kill()
            raise TimeoutError(f"{size} ranks still running after {timeout_s} s")
