"""Host-side queues that connect the inference stages.

The part of ``remora_tpu/core/pipeline.py`` the device stage needs:
bounded, named queues with sentinel shutdown, and blocking put/get that
poll so KeyboardInterrupt stays deliverable. The stage runners
(``source_stage``, ``map_stage``, ...) come with the streaming driver.
"""

import multiprocessing as mp
import os
import queue as queue_mod
from functools import partial

# fork keeps callers that build pipelines at script top level working;
# REMORA_TPU_MP_CONTEXT=spawn|forkserver switches, as in remora_tpu
_MP = mp.get_context(os.environ.get("REMORA_TPU_MP_CONTEXT", "fork"))

_STOP = StopIteration
_POLL_S = 0.1

DEFAULT_QUEUE_SIZE = 10_000


class StageQueue:
    """Bounded, named queue; optionally process-shared with a size gauge
    (the stdlib mp.Queue has no usable qsize on all platforms)."""

    def __init__(self, maxsize=0, name="queue", cross_process=True):
        self.name = name
        self.maxsize = maxsize
        if cross_process:
            self.queue = _MP.Queue(maxsize=maxsize)
            self._gauge = _MP.Value("i", 0)
        else:
            self.queue = queue_mod.Queue(maxsize=maxsize)
            self._gauge = None

    def _bump(self, delta):
        if self._gauge is not None:
            with self._gauge.get_lock():
                self._gauge.value += delta

    def put(self, item, **kwargs):
        self.queue.put(item, **kwargs)
        self._bump(+1)

    def get(self, **kwargs):
        got = self.queue.get(**kwargs)
        self._bump(-1)
        return got

    def qsize(self):
        if self._gauge is not None:
            return self._gauge.value
        return self.queue.qsize()


# thread-only / process-shared aliases (reference NamedQueue analogs)
NamedQueue = partial(StageQueue, cross_process=False)
NamedMPQueue = StageQueue


def put_item(item, out_q):
    """Blocking put that polls so KeyboardInterrupt stays deliverable."""
    while True:
        try:
            out_q.put(item, timeout=_POLL_S)
        except queue_mod.Full:
            continue
        return


def get_item(in_q):
    """Blocking get that polls so KeyboardInterrupt stays deliverable."""
    while True:
        try:
            got = in_q.get(timeout=_POLL_S)
        except queue_mod.Empty:
            continue
        return got


def queue_iter(in_q, num_producers=1):
    """Iterate a queue until every producer has sent its stop sentinel."""
    live_producers = num_producers
    while live_producers > 0:
        item = get_item(in_q)
        if item is _STOP:
            live_producers -= 1
            continue
        yield item
