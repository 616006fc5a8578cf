"""Data parallelism across processes: the process group and its
collectives.

Counterpart of `egotap_tpu/parallel/mesh.py` (`initialize_multihost`,
`choose_num_data`, `data_parallel_setup`, `replicate`,
`make_global_batch`). JAX runs one program over a ('data', 'model') mesh
and XLA inserts the gradient all-reduce; PyTorch's idiom is one process
per card, launched by ``torchrun``:

    torchrun --nproc_per_node=N -m egotap_tpu_torch.cli.train ...

`init` joins the process group (from the ``torchrun`` environment, or
from an explicit rank, world size and store) and `setup` returns the
`DataParallel` of the group joined, which the training loop passes to
the task (its step and `evaluate` use it) and to the loaders:
  * `broadcast_modules`: rank 0's parameters and buffers to every rank
    (JAX's ``replicate``);
  * `average_gradients`: one flat buffer, all-reduced and divided by the
    world size before the optimizer (the gradient of the global mean
    loss, as JAX's sharded step computes it);
  * `sum_over_ranks`: an autograd-aware sum, which train-mode BatchNorm
    uses for statistics over the global batch (`models/layers.py`);
  * `average`, `max_`, `gather_objects` and `barrier` for losses,
    calibrated scales, evaluation rows and checkpoint writes.

Backends: NCCL for CUDA ranks, gloo only where the caller asks for it
(two ranks sharing one card, which NCCL refuses) or the ranks run on the
CPU. gloo takes every collective the port uses on CUDA tensors as they
are (``python -m egotap_tpu_torch.parallel.dryrun --mode probe``), so
nothing is staged through the host here.

Differences by design: JAX shrinks its data axis to the largest divisor
of the batch (`choose_num_data`); ranks cannot be shrunk, so a batch the
world size does not divide raises, and a nonzero ``cfg.data_parallel``
must equal the world size.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

TIMEOUT = datetime.timedelta(minutes=10)


class DataParallel:
    """This process's place in the process group, and the collectives the
    port uses. ``device`` is the rank's device."""

    def __init__(self, rank: int, world: int, device: torch.device):
        self.rank, self.world, self.device = rank, world, device
        self.backend = dist.get_backend()

    @property
    def main(self) -> bool:
        """True on the rank that writes the run's files (rank 0)."""
        return self.rank == 0

    def all_reduce_(self, t: torch.Tensor,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t, op=op)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        dist.barrier()

    def sum_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks; differentiable (the gradient of
        each rank's copy is the sum of the ranks' gradients)."""
        return _SumOverRanks.apply(t, self)

    @torch.no_grad()
    def _flat(self, tensors: List[torch.Tensor], fn) -> None:
        """Apply the in-place collective ``fn`` to ``tensors`` through one
        flat buffer per dtype, and copy the result back."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            fn(flat)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

    def broadcast_modules(self, modules: Iterable[nn.Module]) -> None:
        """Every parameter and buffer of ``modules`` from rank 0."""
        tensors = [t for m in modules for t in m.state_dict().values()]
        self._flat(tensors, self.broadcast_)

    def average_gradients(self, grads: Dict[str, Optional[torch.Tensor]]
                          ) -> Dict[str, Optional[torch.Tensor]]:
        """The mean of each gradient over the ranks (one flat all-reduce);
        None stays None."""
        live = [g for g in grads.values() if g is not None]

        def mean_(flat):
            self.all_reduce_(flat).div_(self.world)
        self._flat(live, mean_)
        return grads

    def average(self, values: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """The mean over the ranks of each scalar of ``values``."""
        keys = list(values)
        stacked = torch.stack([values[k].float() for k in keys])
        self.all_reduce_(stacked).div_(self.world)
        return dict(zip(keys, stacked.unbind()))

    def max_(self, tensors: List[torch.Tensor]) -> None:
        """Replace each tensor by its elementwise max over the ranks."""
        self._flat(tensors, lambda flat: self.all_reduce_(
            flat, dist.ReduceOp.MAX))

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj``, in rank order (pickled, through the
        host)."""
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dp):
        ctx.dp = dp
        return dp.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.dp.all_reduce_(grad.clone()), None


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: ``device`` as given when it names an index;
    a bare ``"cuda"`` is the card of the local rank, and a local rank
    without a card raises (ranks never share a card unless the caller
    names it)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local_rank} needs card {local_rank}, but "
            f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", local_rank)


def _local_rank(rank: Optional[int]) -> int:
    return int(os.environ.get("LOCAL_RANK", rank or 0))


def init(device="cuda", rank: Optional[int] = None,
         world_size: Optional[int] = None, store=None,
         backend: Optional[str] = None) -> DataParallel:
    """Join the process group (`initialize_multihost`): from the
    ``torchrun`` environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT) when ``rank`` is None, else from ``rank``,
    ``world_size`` and ``store`` (a ``torch.distributed.Store``).
    ``backend`` defaults to NCCL for CUDA ranks and gloo on the CPU.
    Returns this rank's `DataParallel`; `shutdown` leaves the group."""
    dev = rank_device(device, _local_rank(rank))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, timeout=TIMEOUT)
    if rank is None:
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(store=store, rank=rank,
                                world_size=world_size, **kw)
    return DataParallel(dist.get_rank(), dist.get_world_size(), dev)


def shutdown() -> None:
    """Leave the process group joined by `init`."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_world(dp: Optional[DataParallel]):
    """(rank, world size) of ``dp``; (0, 1) for a single process."""
    return (dp.rank, dp.world) if dp is not None else (0, 1)


def setup(cfg, device) -> Optional[DataParallel]:
    """The data-parallel layout of a run (`data_parallel_setup`): the
    process group already joined in this process (``device`` as `init`
    resolves it), or the ``torchrun`` one when WORLD_SIZE is set; None
    for a single process. ``cfg.data_parallel`` 0 means the world size,
    and a nonzero value must equal it; the world size must divide
    ``cfg.batch_size``."""
    dp = None
    if dist.is_initialized():
        dp = DataParallel(dist.get_rank(), dist.get_world_size(),
                          rank_device(device, _local_rank(dist.get_rank())))
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dp = init(device)
    world = dp.world if dp is not None else 1
    if cfg.data_parallel not in (0, world):
        raise ValueError(
            f"data_parallel={cfg.data_parallel} but {world} process(es): "
            f"launch with torchrun --nproc_per_node={cfg.data_parallel}")
    if cfg.batch_size % world:
        raise ValueError(f"batch_size {cfg.batch_size} does not divide "
                         f"over {world} ranks")
    return dp
