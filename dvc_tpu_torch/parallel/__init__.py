"""Data-parallel training over N ranks, one process a card (counterpart of
``dvc_tpu/parallel``'s data mesh): the group, each rank's rows, the global
sums of the losses' counts, the gradients and BatchNorm's statistics
(``mesh``), the per-host order and the metric sync (``multihost``)."""

from .mesh import (active, all_reduce_sum, barrier, broadcast_module,
                   from_main, global_sum, is_main, rank, rows, run,
                   sum_gradients, world)
from .multihost import host_shard_order, sync_metrics

__all__ = ['active', 'all_reduce_sum', 'barrier', 'broadcast_module',
           'from_main', 'global_sum', 'host_shard_order', 'is_main', 'rank',
           'rows', 'run', 'sum_gradients', 'sync_metrics', 'world']
