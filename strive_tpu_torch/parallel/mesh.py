"""Scene-axis data parallelism over processes, with ``torch.distributed``.

Port of ``strive_tpu/parallel/mesh.py``. strive_tpu shards the scene
(batch) axis of one SPMD program over a 1-D ``scenes`` mesh. Here each
device is a process of its own, a rank, which holds the contiguous rows of
the batch that ``NamedSharding(P('scenes'))`` would place on its device
(``shard_rows``):

- training is data-parallel: each rank steps on its rows, and the losses'
  batch totals and the gradients are summed over the ranks, so a step is
  the one-process step on the whole batch (``train.Trainer``);
- scenario generation optimizes each rank's scenes on its own: the batch
  totals the losses divide by are summed over the ranks, and the
  per-scene results are gathered (``gather_rows``) so that rank 0 writes
  what the one-process run writes (``scripts/adv_scenario_gen.py``).

``launch`` starts one process a rank, each on a device of an explicit
list, in a process group of an explicit backend: NCCL on CUDA, gloo on the
CPU (``default_backend``). gloo also runs several ranks on one card, which
NCCL refuses. Nothing falls back: a rank that raises makes ``launch``
raise, and the other ranks are stopped.

Every collective here is an ``all_reduce`` sum, which NCCL and gloo take
on CPU and CUDA tensors alike. A gather is the sum of zero buffers into
which each rank wrote its own rows; each element has one non-zero term, so
the sum is exact.
"""

from __future__ import annotations

import io
import socket

import torch
import torch.distributed as dist

from ..losses.common import BatchReduce
from ..utils.logger import Logger

_rank_device = None  # the device ``launch`` gave this process


def default_backend(device):
    """'nccl' for a CUDA device, 'gloo' for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def world():
    """Number of ranks of this process's group; 1 outside a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device():
    """The device ``launch`` gave this rank."""
    if _rank_device is None:
        raise RuntimeError("rank_device() outside a rank started by launch")
    return _rank_device


def entry_devices(device, n=None):
    """An entry point's ranks: ``n`` copies of the CPU, or CUDA devices 0
    .. n-1 (``n`` None: every visible card, as strive_tpu's mesh takes
    every device). A named card (``cuda:1``) is one rank. Raises when the
    machine has fewer cards than asked for."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return ["cpu"] * (n or 1)
    if dev.type != "cuda":
        raise ValueError(f"no ranks on device {device!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if dev.index is not None:
        if (n or 1) != 1:
            raise ValueError(f"{n} ranks on the one card {device}")
        want = [dev.index]
    else:
        want = list(range(have if n is None else n))
    if not want or max(want) >= have:
        raise RuntimeError(f"{len(want) or 1} card(s) asked for, "
                           f"{have} visible")
    return [f"cuda:{i}" for i in want]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(index, fn, args, devices, backend, init_method, threads, queue):
    global _rank_device
    _rank_device = torch.device(devices[index])
    torch.set_num_threads(threads)
    if _rank_device.type == "cuda":
        torch.cuda.set_device(_rank_device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=len(devices), rank=index)
    Logger.silent = index != 0
    try:
        out = fn(*args)
        if index == 0:
            # as bytes: a tensor sent through the queue itself would be
            # shared memory that dies with this process
            buf = io.BytesIO()
            torch.save(out, buf)
            queue.put(buf.getvalue())
    finally:
        dist.destroy_process_group()


def launch(fn, args, devices, backend, init_method=None):
    """Run ``fn(*args)`` in one process a rank, rank r on ``devices[r]``,
    inside a process group of ``backend`` ('nccl' or 'gloo'); the ranks
    share this process's torch threads (each takes its number divided by
    the ranks', at least 1: more would have idle threads spin while
    another rank waits for a core) and only rank 0 logs.

    :param fn: a module-level function (the ranks are spawned)
    :param init_method: the group's rendezvous; a free
        ``tcp://localhost`` port when None
    :return: rank 0's return value
    :raises: whatever a rank raised (``torch.multiprocessing``'s
        ``ProcessRaisedException``), once every rank has stopped
    """
    devices = [str(torch.device(d)) for d in devices]
    kinds = {torch.device(d).type for d in devices}
    if backend == "nccl" and (kinds != {"cuda"}
                              or len(set(devices)) != len(devices)):
        raise ValueError(f"NCCL needs one card a rank, got {devices}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if init_method is None:
        init_method = f"tcp://localhost:{_free_port()}"
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    Logger.log(f"launching {len(devices)} ranks, backend {backend}, on "
               f"{', '.join(devices)}")
    procs = torch.multiprocessing.start_processes(
        _worker, args=(fn, args, devices, backend, init_method,
                       max(1, torch.get_num_threads() // len(devices)),
                       queue),
        nprocs=len(devices), join=False, start_method="spawn")
    out = None
    while not procs.join(timeout=0.5):
        if out is None and not queue.empty():
            out = queue.get()
    if out is None:
        out = queue.get()
    return torch.load(io.BytesIO(out), weights_only=False)


def shard_rows(n):
    """This rank's contiguous rows of an ``n``-row batch (``n`` a multiple
    of the number of ranks), as ``NamedSharding(P('scenes'))`` splits it."""
    if n % world():
        raise ValueError(f"a batch of {n} does not split over {world()} "
                         "ranks")
    k = n // world()
    return list(range(rank() * k, (rank() + 1) * k))


def all_sum(x):
    """The sum of ``x`` over the ranks (a new tensor; ``x`` itself outside a
    group). Bool tensors are summed as integers."""
    if not dist.is_initialized():
        return x
    y = x.detach().to(torch.int64 if x.dtype == torch.bool else x.dtype,
                      copy=True)
    dist.all_reduce(y)
    return y


def from_rank0(value, device):
    """Rank 0's integer ``value`` on every rank (``value`` itself outside a
    group)."""
    if not dist.is_initialized():
        return value
    t = torch.tensor([value if rank() == 0 else 0], dtype=torch.int64,
                     device=device)
    return int(all_sum(t)[0])


def sum_tensors(tensors):
    """Each tensor of a list summed over the ranks, through one flat
    buffer (the list itself outside a group)."""
    if not dist.is_initialized():
        return tensors
    flat = all_sum(torch.cat([t.reshape(-1) for t in tensors]))
    return [f.view_as(t) for f, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def gather_rows(x):
    """Every rank's rows of ``x`` (a tensor, or a tuple or dict of them,
    leading axis the rank's rows), in rank order, on every rank."""
    if isinstance(x, dict):
        return {k: gather_rows(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(gather_rows(v) for v in x)
    if not dist.is_initialized():
        return x
    k, r = x.shape[0], rank()
    kind = torch.uint8 if x.dtype == torch.bool else x.dtype
    full = torch.zeros((k * world(),) + tuple(x.shape[1:]), dtype=kind,
                       device=x.device)
    full[r * k:(r + 1) * k] = x.detach()
    dist.all_reduce(full)
    return full.to(torch.bool) if x.dtype == torch.bool else full


class ShardedBatch(BatchReduce):
    """The batch reductions of a rank that holds some rows of the batch.

    Sums a loss divides by (counts, weight totals) are summed over the
    ranks; rows that are not part of the batch (the padding of a batch to
    a multiple of the ranks) add nothing to any sum, numerator or
    denominator. Each rank's loss is then its share of the batch loss, and
    the sum over the ranks is the loss of the whole batch.

    :param real: (rows,) bool, the rank's rows that belong to the batch;
        every row when None
    """

    def __init__(self, real=None):
        self.real = real

    def _keep(self, x):
        if self.real is None:
            return x
        r = self.real.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(r, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))

    def total(self, x):
        return all_sum(torch.sum(self._keep(x.detach())))

    def mean(self, x):
        rows = (x.shape[0] if self.real is None
                else torch.sum(self.real.to(torch.int64)))
        n = all_sum(torch.as_tensor(rows, device=x.device)) * x[0].numel()
        return torch.sum(self._keep(x)) / n

    def weighted_mean(self, x, w):
        return torch.sum(self._keep(x * w)) / torch.clamp(self.total(w),
                                                          min=1.0)

    def masked_mean(self, x, mask, fallback=0.0):
        mask = self._keep(mask)
        cnt = self.total(mask)
        s = torch.sum(torch.where(mask, x, 0.0))
        # the ranks' losses are summed: each carries its share of fallback
        return torch.where(cnt > 0, s / torch.clamp(cnt, min=1),
                           fallback / world())

    def values(self, x):
        return all_sum(x)
