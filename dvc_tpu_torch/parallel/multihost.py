"""Per-host input order and cross-rank metric sync (counterpart of
``dvc_tpu/parallel/multihost.py``; reference ``DistributedSampler`` and
``SmoothedValue.synchronize_between_processes``,
``video_backbone/TSP/common/utils.py:30-41,237-259``).

* :func:`host_shard_order`: DistributedSampler semantics, the JAX
  ``BatchLoader``'s ``process_index`` / ``process_count`` split (each host
  its strided slice of one epoch permutation).  The data-parallel drivers
  split each global batch by rows instead (``mesh.rows``, the mesh's
  ``P('data')``).
* :func:`sync_metrics`: host scalars averaged over the ranks, the identity
  in one process.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mesh


def host_shard_order(n: int, epoch: int, shuffle: bool, seed: int = 0,
                     process_index: int | None = None,
                     process_count: int | None = None) -> np.ndarray:
    """Host ``process_index``'s sample order for one epoch: the permutation
    of ``seed + 1000003 * epoch`` that every host draws alike, split
    ``order[i::world]`` after a wrap-around pad to ceil(n / world) samples
    a host, so every host takes as many steps.  The ranks of the group by
    default."""
    if process_index is None or process_count is None:
        process_index, process_count = mesh.rank(), mesh.world()
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + 1000003 * epoch).shuffle(order)
    if process_count == 1:
        return order
    per_host = -(-n // process_count)                    # ceil
    padded = np.concatenate([order, order[:per_host * process_count - n]])
    return padded[process_index::process_count]


def sync_metrics(metrics: dict, process_count: int | None = None) -> dict:
    """Host scalar metrics averaged over the ranks (one all-reduce, in
    sorted key order), as floats in the given order; a copy of them with
    ``process_count`` 1 or no group."""
    if process_count is None:
        process_count = mesh.world()
    if process_count == 1:
        return dict(metrics)
    keys = sorted(metrics)
    dev = (torch.device('cuda', torch.cuda.current_device())
           if torch.distributed.get_backend() == 'nccl' else 'cpu')
    local = torch.tensor([float(metrics[k]) for k in keys],
                         dtype=torch.float64, device=dev)
    mean = dict(zip(keys, (mesh.global_sum(local) / process_count).tolist()))
    return {k: mean[k] for k in metrics}
