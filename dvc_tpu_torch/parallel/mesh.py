"""Data-parallel training over N ranks, one process a card (counterpart of
``dvc_tpu/parallel/mesh.py``; the reference trains TSP with PyTorch DDP
over NCCL, ``video_backbone/TSP/common/utils.py:237-259``).

The JAX package's ``make_mesh(n_data=N)`` runs the global-batch step in one
process: each device holds ``batch_size / N`` contiguous rows of the batch
(``P('data')``), every loss is normalised over the global batch, and XLA
sums the gradients.  Here each rank is a process with its rows
(:func:`rows`); the losses' denominators are summed over the ranks
(:func:`global_sum`), the ranks' gradients are summed in a few flat
buckets (:func:`sum_gradients`), so clipping and the optimizer see the
global gradient on every rank, and BatchNorm's statistics are summed with
gradients (:func:`all_reduce_sum`).  Sum, not average: each rank's loss is
its share of the global loss, so a DDP-style average would divide by N a
second time.

:func:`run` starts the ranks: under ``torchrun`` it joins the group that
the environment describes; without, it spawns them itself; at one rank it
makes no group, so no collective is issued and every helper here is the
identity.  The backend is NCCL on the card and gloo on the CPU.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

# Rank 0 validates alone while the other ranks wait at a barrier, and a
# full validation (the val set's greedy decode, then the metric stack on
# the host) takes tens of minutes: NCCL's default of ten minutes would end
# the waiting ranks.  A rank that really hangs is still ended, later.
GROUP_TIMEOUT = datetime.timedelta(hours=3)

# gradients are summed in flat buffers of at most this size: a few
# all-reduces a step for the FusionPDVC, one for small models
BUCKET_BYTES = 64 << 20


def active() -> bool:
    """Whether a process group exists (then the helpers here reduce)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    return rank() == 0


def rows(batch_size: int, r: int | None = None,
         n: int | None = None) -> slice:
    """Rank r's rows ``[r B/n, (r+1) B/n)`` of a global batch of B: the
    JAX mesh's ``P('data')`` placement."""
    r = rank() if r is None else r
    n = world() if n is None else n
    if batch_size % n:
        raise ValueError(f'a batch of {batch_size} does not split over {n} '
                         'ranks (the JAX data mesh refuses it as well)')
    per = batch_size // n
    return slice(r * per, (r + 1) * per)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks (a new tensor, no gradient); x itself
    without a group."""
    if not active():
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


class AllReduceSum(torch.autograd.Function):
    """A SUM all-reduce that carries gradients: the forward sums x over the
    ranks, the backward sums the ranks' gradients of the result, since
    every rank's loss depends on the sum (a plain ``dist.all_reduce`` in a
    forward cuts the gradient)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """:class:`AllReduceSum` of x; x itself without a group."""
    return AllReduceSum.apply(x) if active() else x


@torch.no_grad()
def sum_gradients(grads, bucket_bytes: int = BUCKET_BYTES):
    """Sum every rank's gradients in place, in flat buckets of at most
    ``bucket_bytes`` (one all-reduce each, in the order given, which every
    rank shares).  Nothing without a group."""
    if not active():
        return
    bucket, size = [], 0
    for g in list(grads) + [None]:
        if bucket and (g is None or size + g.numel() * g.element_size()
                       > bucket_bytes or g.dtype != bucket[0].dtype):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat)
            # one multi-tensor copy back, not a launch a gradient
            torch._foreach_copy_(bucket, [f.view_as(t) for t, f in zip(
                bucket, flat.split([t.numel() for t in bucket]))])
            bucket, size = [], 0
        if g is not None:
            bucket.append(g)
            size += g.numel() * g.element_size()


@torch.no_grad()
def broadcast_module(module: torch.nn.Module):
    """Rank 0's parameters and buffers on every rank (once, after the model
    is built, restored or warm-started).  Nothing without a group."""
    if not active():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, 0)


def from_main(fn, *args):
    """``fn(*args)`` run on rank 0 alone, its (picklable) result given to
    every rank: a run folder that rank 0 names and makes."""
    if not active():
        return fn(*args)
    box = [fn(*args) if is_main() else None]
    dist.broadcast_object_list(box, 0)
    return box[0]


def barrier():
    """Every rank waits here for the others (rank 0's validation)."""
    if active():
        dist.barrier()


def rank_device(device, local_rank: int, n: int) -> torch.device:
    """The device of a rank: the CPU, or card ``local_rank``.  Raises where
    fewer than n cards are visible: no two ranks share a card, and nothing
    falls back to the CPU."""
    device = torch.device(device)
    if device.type == 'cpu':
        return device
    visible = torch.cuda.device_count()
    if n > visible:
        raise RuntimeError(f'{n} data-parallel ranks need {n} cards, '
                           f'{visible} visible (one rank a card; pass '
                           '--device cpu to train on the CPU)')
    return torch.device('cuda', local_rank)


def init_group(device: torch.device, init_method: str, r: int, n: int):
    """The process group of rank r of n: NCCL on a card, gloo on the CPU,
    with :data:`GROUP_TIMEOUT`."""
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo',
                            init_method=init_method, rank=r, world_size=n,
                            timeout=GROUP_TIMEOUT)


def run(fn, n: int, batch_size: int, device, *args):
    """``fn(rank_device, *args)`` on each of n data-parallel ranks; returns
    rank 0's result (under ``torchrun`` or in a group the caller made,
    each rank's own).

    * A group exists (``torchrun`` after its init, or the caller's): it
      must have n ranks; rank r runs on card ``LOCAL_RANK`` (else r).
    * ``torchrun`` (``WORLD_SIZE`` in the environment): it must equal n;
      the group is made from the environment and ended after ``fn``.
    * n == 1: ``fn`` runs here, with no group.
    * Else n workers are spawned, rank r on card r, meeting at a file
      store in a temporary folder.

    Raises before any work where ``batch_size % n`` or where n exceeds the
    visible cards."""
    n = int(n)
    if n < 1:
        raise ValueError(f'{n} data-parallel ranks')
    rows(batch_size, 0, n)                      # the split's check
    if active():
        if world() != n:
            raise ValueError(f'the process group has {world()} ranks, the '
                             f'run asks for {n}')
        local = int(os.environ.get('LOCAL_RANK', rank()))
        return fn(rank_device(device, local, n), *args)
    if 'WORLD_SIZE' in os.environ:              # torchrun
        size = int(os.environ['WORLD_SIZE'])
        if size != n:
            raise ValueError(f'WORLD_SIZE {size} (torchrun) but {n} '
                             'data-parallel ranks asked for')
        r = int(os.environ['RANK'])
        dev = rank_device(device, int(os.environ.get('LOCAL_RANK', r)), n)
        init_group(dev, 'env://', r, n)
        try:
            return fn(dev, *args)
        finally:
            dist.destroy_process_group()
    if n == 1:
        return fn(device, *args)
    rank_device(device, 0, n)                   # enough cards?
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix='dvc_ranks_') as tmp:
        ctx = mp.start_processes(_worker, args=(fn, n, str(device), tmp,
                                                args),
                                 nprocs=n, join=False, start_method='spawn')
        while not ctx.join():
            pass
        with open(os.path.join(tmp, 'result.pkl'), 'rb') as f:
            return pickle.load(f)


def _worker(r, fn, n, device, tmp, args):
    """A spawned rank: its group (a file store in ``tmp``), ``fn``, and
    rank 0's result written to ``tmp/result.pkl``."""
    dev = rank_device(device, r, n)
    if dev.type == 'cpu':
        # n ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    init_group(dev, f'file://{os.path.join(tmp, "store")}', r, n)
    try:
        out = fn(dev, *args)
        if r == 0:
            with open(os.path.join(tmp, 'result.pkl'), 'wb') as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
