"""Data-parallel ranks for the port's tests: ``spawn`` runs a target on N
gloo ranks of a CPU process group, and the targets below drive the port's
``Trainer``, ``TSPTrainer`` and training drivers as ranks.

A spawned process imports the module of its target, so this module and its
targets import no JAX (the test modules do).  Each rank uses one thread,
meets the others at a file store under the test's ``tmp_path`` (no TCP
port, so parallel test workers never collide) and writes its result with
``torch.save``; ``spawn`` fails the test, rather than hang, when the ranks
do not finish in time.
"""
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_SECONDS = 180


def spawn(target, n, tmp, *args, timeout=JOIN_SECONDS):
    """``target(rank, *args)`` on n gloo ranks; the ranks' results, by
    rank.  Raises with the rank's traceback if one fails, and if they do
    not finish within ``timeout`` seconds."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(target, n, tmp, args), nprocs=n,
                             join=False, start_method='spawn')
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f'{n} ranks of {target.__name__} did not '
                                 f'finish within {timeout} s')
    return [torch.load(os.path.join(tmp, f'rank{r}.pt'), weights_only=False)
            for r in range(n)]


def _entry(rank, target, n, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', init_method=f'file://{os.path.join(tmp, "store")}',
        rank=rank, world_size=n)
    try:
        out = target(rank, *args)
        torch.save(out, os.path.join(tmp, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def rows_of(batch, rank, n):
    """Rank ``rank``'s rows of a global numpy batch (the mesh's P('data'))."""
    from dvc_tpu_torch.parallel import rows
    part = rows(len(next(iter(batch.values()))), rank, n)
    return {k: v[part] for k, v in batch.items()}


def assert_equal_states(a, b):
    """Two state_dicts equal bit for bit."""
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def state_of(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def pdvc_steps(rank, opt, state_dict, batches, lrs, plain=False):
    """A ``Trainer`` rank (FusionPDVC, or ``plain`` PDVC) from
    ``state_dict`` (rank 0's, broadcast) for one step a global batch on
    its rows: ({'losses': per step, 'state': final state_dict,
    'grads': the first step's summed gradients by name})."""
    from dvc_tpu_torch.models import make_pdvc_model
    from dvc_tpu_torch.parallel import broadcast_module
    from dvc_tpu_torch.train import Trainer
    model = make_pdvc_model(opt, 'cpu', seed=0) if plain else None
    trainer = Trainer(opt, device='cpu', model=model)
    if rank == 0:
        trainer.model.load_state_dict(state_dict, strict=True)
    broadcast_module(trainer.model)
    losses, grads = [], None
    for b, lr in zip(batches, lrs):
        out = trainer.train_step(rows_of(b, rank, dist.get_world_size()), lr)
        losses.append({k: float(v) for k, v in out.items()})
        if grads is None:
            grads = {n: p.grad.clone()
                     for n, p in trainer.model.named_parameters()}
    return {'losses': losses, 'state': state_of(trainer.model),
            'grads': grads}


def tsp_steps(rank, opt, state_dict, batches, iters):
    """A ``TSPTrainer`` rank from ``state_dict`` for one step a global
    batch on its rows: ({'metrics': per step, 'state', 'momentum'})."""
    from dvc_tpu_torch.train import TSPTrainer
    trainer = TSPTrainer(opt, 'cpu', gvf_dim=16)
    state = trainer.init_state(state_dict=state_dict)
    metrics = []
    for it, b in zip(iters, batches):
        part = rows_of(b, rank, dist.get_world_size())
        state, m = trainer.train_step(
            state, {k: torch.from_numpy(v) for k, v in part.items()}, it)
        metrics.append({k: float(v) for k, v in m.items()})
    return {'metrics': metrics, 'state': state_of(state['model']),
            'momentum': {k: v.clone() for k, v in
                         trainer.momentum_buffers(state).items()}}


def collective_cases(rank, cases):
    """On rank ``rank``: ``sync_metrics`` of each case's rank-``rank``
    dict; ``sum_gradients`` of rank-dependent tensors in 64-byte buckets
    (a float64 one among them); the gradient through ``all_reduce_sum``;
    ``from_main`` and ``broadcast_module``."""
    from dvc_tpu_torch import parallel
    grads = [torch.full(shape, float(rank + 1), dtype=dtype)
             for shape, dtype in (((3, 5), torch.float32), ((7,),
                                  torch.float32), ((2,), torch.float64),
                                  ((40,), torch.float32))]
    parallel.sum_gradients(grads, bucket_bytes=64)
    x = torch.ones(3, requires_grad=True)
    y = parallel.all_reduce_sum(x * (rank + 1))
    (y * torch.arange(3.0)).sum().backward()
    module = torch.nn.Linear(2, 2)
    torch.nn.init.constant_(module.weight, float(rank))
    parallel.broadcast_module(module)
    return {'sync': [parallel.sync_metrics(case[rank]) for case in cases],
            'grads': grads, 'y': y.detach(), 'x_grad': x.grad,
            'main': parallel.from_main(lambda: f'rank {parallel.rank()}'),
            'weight': module.weight.detach()}


def _capture(module):
    """``module.Trainer`` replaced by a subclass that keeps its instances."""
    made = []

    class Recorded(module.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    module.Trainer = Recorded
    return made


def pdvc_driver(rank, name, opt):
    """``new_train.main`` or ``run_train.main`` (``name``) as a rank of
    the caller's group: (run folder, losses, the rank's final weights)."""
    import importlib
    driver = importlib.import_module(f'dvc_tpu_torch.{name}')
    made = _capture(driver)
    folder, losses = driver.main(opt)
    return folder, losses, state_of(made[0].model)


def tsp_driver(rank, argv, inputs):
    """``train_tsp.main(argv)`` as a rank, with ``inputs`` {backbone: its
    resize and crop} in ``BACKBONE_INPUT``: the rank's final weights."""
    from dvc_tpu_torch import train_tsp
    train_tsp.BACKBONE_INPUT.update(inputs)
    return state_of(train_tsp.main(argv)['model'])
