"""The mesh of the port's trainers (counterpart of
robo_vln_tpu/parallel/mesh.py): a ``data × model`` grid of ranks.

The JAX package trains one program over a ``jax.sharding.Mesh`` with the
axes ["data", "model"] of ``TPU.MESH_SHAPE`` (default ``[-1, 1]``: every
visible device on the data axis); axis 0 of each batch entry is sharded
over "data" and GSPMD inserts the sums.  The port runs one process a rank
of the grid ``[d, m]``, joined by a ``torch.distributed`` process group:
NCCL on the card, gloo on the CPU.  Rank ``r`` sits at data ``r // m``,
model ``r % m``, as a C-order reshape of ``[d, m]`` places it.  The same
global batch gives the same losses, gradients and weights as one process:

* ``DAGGER.BATCH_SIZE`` is per data rank; the global batch is
  ``BATCH_SIZE × d`` (:func:`global_batch_size`), padded as the loader
  pads a tail batch.
* Every rank reads the same global batch, in the same order, and collates
  rows ``[i·b, (i+1)·b)`` of it, ``i`` its data rank (:meth:`DataMesh.rows`,
  the loaders' ``rows``) at the bucket of the global batch's longest
  episode: a rank that collated its own episodes would pick its own
  bucket.  The ranks of one model group hold the same rows.
* Every denominator of the losses (training/steps.py) is a count over the
  global batch: each rank's counts are summed over its data group
  (:meth:`DataMesh.sum`) before any division, so each rank's loss is its
  share of the global loss, and the gradients summed over the data group
  (:meth:`DataMesh.reduce_step`, one coalesced all-reduce, placed before
  the optimizer) are the gradient of the global loss.  The same
  all-reduce sums the losses, so the non-finite guard and the logged
  metrics read the global values on every rank.
* The "model" axis is a layout, as in JAX: :func:`param_shardings` is the
  JAX package's Megatron-style rule (a 2-D kernel of at least
  ``min_size`` elements split over "model" on its output dim when that is
  the larger, else on its input dim; whole where the dim does not divide),
  and :func:`shard_params` keeps each rank's slice of those tensors,
  swapping their modules for the split forms of parallel/tensor.py, whose
  collectives over the model group (:attr:`DataMesh.model_group`) give
  every rank the whole output of each sharded module.  The optimizers are
  built on the slices, so the Adam moments are split too.
* Rank 0 collects, featurizes, writes checkpoints and TensorBoard and
  logs; the other ranks wait for it (:meth:`DataMesh.on_main`) in a gloo
  group of their own whose timeout is :data:`MAIN_WORK_TIMEOUT`: a wait in
  the step's group would end at that group's timeout (NCCL's watchdog ends
  a collective after 10 minutes by default), and collection or
  featurizing a real buffer takes longer.  Every rank starts from rank 0's
  weights (:meth:`DataMesh.broadcast`), before the split.

``-1`` on an axis means the visible devices over the other axis (the
group's ranks where a group is up): every CUDA device on the card, one
process on the CPU (``[-1, 2]`` is ``[1, 2]`` there).  With more than one
rank, :func:`spawn` starts a process a rank (run.py's ``run_exp``); rank
``r`` runs on ``cuda:r``.  One rank needs no group: its mesh calls no
collective, and the step is the one-process step, bit for bit.  A group
that is already up is the mesh's.  Axis names other than
["data", "model"] are refused by ``get_config`` before any work
(config/default.check_mesh).
"""

from __future__ import annotations

import datetime
import socket
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def visible_devices(device) -> int:
    """The devices the mesh can hold: every CUDA device on the card, one
    process on the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def mesh_axes(mesh_shape: Sequence[int], device, ranks: Optional[int] = None):
    """(d, m): the data and model axes of ``mesh_shape``, -1 resolved as
    make_mesh resolves it, over ``ranks`` devices (the visible ones when
    None).  On the CPU a -1 stays 1; on a CUDA device a grid larger than
    the visible cards, or a count that does not divide, raises, as JAX's
    reshape of the device list fails."""
    shape = [int(n) for n in mesh_shape]
    cuda = torch.device(device).type == "cuda"
    devices = ranks if ranks is not None else visible_devices(device)
    if -1 in shape:
        i = shape.index(-1)
        other = shape[1 - i]
        if ranks is None and not cuda:
            shape[i] = 1
        elif devices % other:
            raise RuntimeError(f"TPU.MESH_SHAPE {list(mesh_shape)}: {devices} devices do not "
                               f"divide over {other} on the other axis")
        else:
            shape[i] = devices // other
    d, m = shape
    if ranks is None and cuda and d * m > devices:
        raise RuntimeError(f"TPU.MESH_SHAPE {list(mesh_shape)} puts {d * m} ranks on the grid; "
                           f"{devices} CUDA devices are visible")
    if ranks is not None and d * m != ranks:
        raise RuntimeError(f"TPU.MESH_SHAPE {list(mesh_shape)} is a grid of {d * m} ranks; "
                           f"the process group holds {ranks}")
    return d, m


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


class AxisGroup:
    """The ranks of one axis that this rank shares: ``size`` of them, this
    one at ``rank``; ``group`` is their process group (None when there is
    nothing to exchange: no group is up, or the axis holds this rank
    alone).  A copy of a module keeps the same group."""

    def __init__(self, group=None, size: int = 1, rank: int = 0, ranks: Sequence[int] = (0,)):
        self.group, self.size, self.rank, self.ranks = group, size, rank, list(ranks)

    def __deepcopy__(self, memo):
        return self

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` summed over the axis, in place."""
        if self.group is not None:
            dist.all_reduce(tensor, group=self.group)
        return tensor

    def all_gather(self, tensor: torch.Tensor, dim: int) -> torch.Tensor:
        """The axis's tensors concatenated along ``dim``, in rank order."""
        if self.group is None:
            return tensor
        parts = [torch.empty_like(tensor) for _ in range(self.size)]
        dist.all_gather(parts, tensor.contiguous(), group=self.group)
        return torch.cat(parts, dim)

    def broadcast(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` set to the axis's first rank's, in place."""
        if self.group is not None:
            dist.broadcast(tensor, self.ranks[0], group=self.group)
        return tensor


class DataMesh:
    """This process's place on the grid: ``size`` ranks on the data axis,
    this one ``rank`` there, ``model_size`` on the model axis, this one
    ``model_rank`` there; ``world_rank`` of ``world_size`` in the process
    group; its tensors on ``device``.  Without a process group it is the
    one-rank mesh, whose collectives are not called (``distributed``
    False): the steps then run the one-process code.  ``data_group`` holds
    the ranks at this model rank (the gradients' sums), ``model_group``
    those at this data rank (the split modules' collectives)."""

    def __init__(self, device="cpu", size: Optional[int] = None, rank: Optional[int] = None,
                 model: int = 1):
        self.device = torch.device(device)
        self.distributed = dist.is_available() and dist.is_initialized()
        self.world_size = dist.get_world_size() if self.distributed else 1
        self.world_rank = dist.get_rank() if self.distributed else 0
        if self.world_size % model:
            raise RuntimeError(f"the process group's {self.world_size} ranks do not make a "
                               f"grid with {model} on the model axis")
        self.model_size = model
        self.size = self.world_size // model
        self.rank, self.model_rank = divmod(self.world_rank, model)
        if (size is not None and size != self.size) or (rank is not None and rank != self.rank):
            raise RuntimeError(f"the process group holds data rank {self.rank} of {self.size} "
                               f"(model axis {model}); data rank {rank} of {size} was asked for")
        self.data_group, self.model_group = self._axis_groups()
        self._wait_group = None

    def _axis_groups(self):
        """(data group, model group), every subgroup made by every rank in
        the same order, as new_group requires."""
        d, m = self.size, self.model_size
        if not self.distributed:
            return AxisGroup(), AxisGroup()
        if m == 1:  # the data axis is the whole group, as before there was a model axis
            return (AxisGroup(dist.group.WORLD, d, self.rank, range(d)),
                    AxisGroup(ranks=[self.world_rank]))
        groups = []
        for axis, members in (("data", [[i * m + j for i in range(d)] for j in range(m)]),
                              ("model", [[i * m + j for j in range(m)] for i in range(d)])):
            mine = None
            for ranks in members:
                group = dist.new_group(ranks) if len(ranks) > 1 else None
                if self.world_rank in ranks:
                    mine = AxisGroup(group, len(ranks), ranks.index(self.world_rank), ranks)
            groups.append(mine)
        return tuple(groups)

    @classmethod
    def for_config(cls, config, device) -> "DataMesh":
        """The mesh ``config``'s TPU.MESH_SHAPE asks for, over the process
        group that is up; a grid of more than one rank without a group
        raises (start its ranks with :func:`spawn`, as run.py's run_exp
        does)."""
        up = dist.is_available() and dist.is_initialized()
        d, m = mesh_axes(config.TPU.MESH_SHAPE, device, dist.get_world_size() if up else None)
        if d * m > 1 and not up:
            raise RuntimeError(
                f"TPU.MESH_SHAPE {list(config.TPU.MESH_SHAPE)} is a grid of {d * m} ranks: "
                "train through python -m robo_vln_tpu_torch.run, which starts a process a rank")
        return cls(device, size=d, model=m)

    @property
    def is_main(self) -> bool:
        return self.world_rank == 0

    def rows(self, global_batch: int):
        """(lo, hi): this rank's rows [i·b, (i+1)·b) of a global batch, i
        its data rank."""
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
        """``tensor`` summed over the data group, in place."""
        return self.data_group.all_reduce(tensor)

    def reduce_step(self, grads: Sequence[Optional[torch.Tensor]],
                    scalars: Sequence[torch.Tensor]):
        """(grads, scalars), each summed over the data group in one
        all-reduce of a flat float32 buffer; None gradients (parameters the
        losses never reach, the same on every rank) stay None.  A split
        parameter's gradient is its slice's, summed with the same slice of
        the other data ranks."""
        if not self.distributed:
            return list(grads), list(scalars)
        present = [g for g in grads if g is not None]
        flat = torch.cat([g.reshape(-1).float() for g in present]
                         + [s.detach().reshape(1).float() for s in scalars])
        self.data_group.all_reduce(flat)
        out, offset = [], 0
        for g in grads:
            if g is None:
                out.append(None)
                continue
            out.append(flat[offset:offset + g.numel()].view(g.shape).to(g.dtype))
            offset += g.numel()
        return out, list(flat[offset:].unbind())

    def _waits(self):
        """The gloo group over every rank in which they wait for rank 0
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
        """Every parameter and buffer of ``modules`` set to rank 0's (the
        whole modules, before :func:`shard_params`)."""
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


def _kernel_layout(module: torch.nn.Module, name: str, p: torch.Tensor):
    """(the flax kernel's shape, True where the port holds it transposed)
    of a parameter the JAX rule sees as a 2-D kernel, or None: a Linear's
    weight is the Dense kernel transposed, a 1x1 Conv1d's too (the JAX
    package's Dense), an RNN's ``weight_ih``/``weight_hh`` its ``w_ih``/
    ``w_hh`` transposed; an Embedding and any other 2-D parameter keep
    flax's orientation."""
    nn = torch.nn
    if isinstance(module, nn.Conv1d) and name == "weight" and p.dim() == 3 and p.shape[2] == 1:
        return (p.shape[1], p.shape[0]), True
    if p.dim() != 2:
        return None
    if (isinstance(module, nn.Linear) and name == "weight") or \
            name.startswith(("weight_ih_l", "weight_hh_l")):
        return (p.shape[1], p.shape[0]), True
    return tuple(p.shape), False


def param_shardings(module: torch.nn.Module, mesh, min_size: int = 1 << 16
                    ) -> Dict[str, Optional[int]]:
    """Tensor-parallel parameter layout over the "model" axis: for each of
    ``module``'s parameters (by its state_dict name), the dim of the
    port's tensor that is split over the axis, or None where it stays
    whole.  ``mesh``: a DataMesh or the model axis's size.

    JAX's rule on the flax kernel: a 2-D kernel of at least ``min_size``
    elements, on a model axis above 1, is split on its output dim (1)
    where that dim is at least its input dim (column-parallel), else on
    its input dim (row-parallel), and stays whole where that dim does not
    divide by the axis; every other parameter stays whole.  The dim is
    then named in the port's orientation (:func:`_kernel_layout`).  As in
    JAX, an embedding table is a kernel too: BERT's word table (30522,
    768) splits on its vocabulary, the position table on its features."""
    n_model = mesh if isinstance(mesh, int) else mesh.model_size
    owners = dict(module.named_modules())
    out: Dict[str, Optional[int]] = {}
    for qualified, p in module.named_parameters():
        owner, _, name = qualified.rpartition(".")
        layout = _kernel_layout(owners[owner], name, p)
        out[qualified] = None
        if layout is None or n_model <= 1 or p.numel() < min_size:
            continue
        (a, b), transposed = layout
        flax_dim = 1 if b >= a else 0
        if (a, b)[flax_dim] % n_model == 0:
            out[qualified] = 1 - flax_dim if transposed else flax_dim
    return out


def shard_params(module: torch.nn.Module, mesh: "DataMesh", min_size: int = 1 << 16
                 ) -> Dict[str, Optional[int]]:
    """Keep this rank's slice of each tensor :func:`param_shardings`
    splits, in place, their modules swapped for the split forms
    (parallel/tensor.shard_modules); returns the layout.  On a model axis
    of 1 nothing changes."""
    from .tensor import shard_modules

    plan = param_shardings(module, mesh, min_size)
    if mesh.model_size > 1:
        shard_modules(module, plan, mesh)
    return plan


def _rank_entry(rank: int, size: int, address: str, device: str, backend, threads: int,
                group_timeout, fn: Callable, args) -> None:
    torch.set_num_threads(threads)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank)
    init_process_group(rank, size, address, device, backend=backend, timeout=group_timeout)
    try:
        fn(rank, device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, size: int, device, *args, timeout_s: Optional[float] = None,
          group_timeout: Optional[datetime.timedelta] = None,
          backend: Optional[str] = None) -> None:
    """Run ``fn(rank, device, *args)`` in ``size`` spawned processes joined
    by a process group at a free localhost port: rank ``r`` on ``cuda:r``
    for ``device`` "cuda", every rank on a device that names its index
    ("cuda:0"), on the CPU for "cpu"; NCCL on a CUDA device and gloo on the
    CPU unless ``backend`` says otherwise (gloo puts several ranks on one
    card); ``group_timeout`` as init_process_group's ``timeout``; each on
    ``threads / size`` intra-op threads.  A rank that raises ends the
    others and raises here; so does ``timeout_s`` passing with a rank still
    running."""
    import time

    import torch.multiprocessing as mp

    threads = max(1, torch.get_num_threads() // size)
    context = mp.start_processes(
        _rank_entry, args=(size, free_address(), str(torch.device(device)), backend, threads,
                           group_timeout, fn, args),
        nprocs=size, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while not context.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for proc in context.processes:
                proc.kill()
            raise TimeoutError(f"{size} ranks still running after {timeout_s} s")
