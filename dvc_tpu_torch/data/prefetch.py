"""Background-thread batch prefetching (port of ``dvc_tpu/data/prefetch.py``;
reference ``train.py:71-75`` nthreads).

Wraps any (batch, meta) iterator: host-side collation runs in a worker
thread while the device computes, so input latency overlaps the step.
``DevicePrefetchLoader`` adds the device stage: it prepares the next batch
(``Trainer.prepare_batch``: pinned host tensors copied without blocking on
the trainer's copy stream) before the current one is yielded, so the upload
of batch n+1 overlaps step n.
"""

from __future__ import annotations

import collections
import queue
import threading


class PrefetchLoader:
    """Iterates ``loader`` in a worker thread, at most ``depth`` items
    ahead.  A consumer that stops early (``break``, an exception) stops and
    reaps the worker; an exception of the worker is raised again in the
    consumer."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()
        stop = threading.Event()
        err = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.loader:
                    if not put(item):
                        return      # the consumer went away
            except Exception as e:  # raised again in the consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # unblock and reap the worker even when the consumer abandons
            # the generator early; otherwise it parks in q.put holding a
            # batch
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join()
        if err:
            raise err[0]


class DevicePrefetchLoader:
    """Two-stage input pipeline: host collation in a worker thread
    (:class:`PrefetchLoader`, ``host_depth`` batches ahead) and a device
    lookahead of ``depth`` batches.

    ``prepare`` (``Trainer.prepare_batch`` or ``prepare_eval_batch``) runs
    on the consumer's thread for the next batch before the current one is
    yielded; on a CUDA device it only enqueues the upload, so the copy of
    batch n+1 overlaps step n.  Prepared batches carry ``_prepared``, so
    the trainer does not prepare them again.
    """

    def __init__(self, loader, prepare, depth: int = 1, host_depth: int = 2):
        self.loader = loader
        self.prepare = prepare
        self.depth = max(depth, 1)
        self.host_depth = host_depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        pending = collections.deque()
        host = iter(PrefetchLoader(self.loader, self.host_depth))
        try:
            for batch, meta in host:
                pending.append((self.prepare(batch), meta))
                if len(pending) > self.depth:
                    yield pending.popleft()
            while pending:
                yield pending.popleft()
        finally:
            host.close()                # reaps the worker on an early exit
