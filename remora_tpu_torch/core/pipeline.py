"""Host-side streaming pipeline fabric (copy of
``remora_tpu/core/pipeline.py``).

Stages connected by bounded, named queues with sentinel shutdown, each
stage either a background producer (``source_stage``) or a pool of
worker tasks mapping a function over the upstream queue (``map_stage``,
``batch_map_stage``). Threads or processes selectable per stage; per-item
exceptions are logged and swallowed so one bad read cannot stall the
pipeline. Blocking put/get poll so KeyboardInterrupt stays deliverable.

A process stage forks; its worker function must not touch CUDA, since
the parent may already hold a CUDA context (the inference driver keeps
every CUDA call in the parent's threads).
"""

import multiprocessing as mp
import os
import queue as queue_mod
import traceback
from functools import partial
from threading import Thread

from remora_tpu_torch import log

LOGGER = log.get_logger()

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
            # a driver drains every queue before it returns; one that
            # raised mid-run leaves items no process will read, and the
            # creating process must not block at exit flushing them into
            # a full pipe (a forked or spawned copy resets this and still
            # flushes what it put)
            self.queue.cancel_join_thread()
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


def _log_swallowed(tag, name, err, with_tb=True):
    detail = f"\n{traceback.format_exc()}" if with_tb else ""
    LOGGER.debug(f"{tag} in {name}: '{err}'{detail}")


def _run_guarded(tag, name, fn, with_tb=True, errors=None):
    """Run ``fn``, swallowing (but logging) everything except SIGINT; a
    swallowed exception is appended to ``errors`` when one is given."""
    try:
        fn()
    except KeyboardInterrupt:
        pass
    except Exception as e:
        _log_swallowed(tag, name, e, with_tb=with_tb)
        if errors is not None:
            errors.append(e)


def _pump(items, sink):
    """Forward every item into ``sink``; True on clean exhaustion."""
    for item in items:
        put_item(item, sink)
    return True


def _fill_queue(iterator, in_q, num_receivers):
    """Drain an in-process iterator into a stage's input queue."""
    _run_guarded(
        "PIPELINE_FILLER_ERROR", "filler", lambda: _pump(iterator, in_q)
    )
    for _ in range(num_receivers):
        put_item(_STOP, in_q)


def _worker_loop(name, func, prep_func, in_q, out_q, args, kwargs,
                 errors):
    LOGGER.debug(f"{name}: worker up")

    def run():
        nonlocal args, kwargs
        if prep_func is not None:
            # per-worker state constructed post-fork (file handles etc.)
            args, kwargs = prep_func(*args, **kwargs)
        for item in queue_iter(in_q):
            _run_guarded(
                "PIPELINE_ITEM_ERROR",
                name,
                lambda: put_item(func(item, *args, **kwargs), out_q),
                errors=errors,
            )

    _run_guarded("PIPELINE_WORKER_ERROR", name, run, with_tb=False,
                 errors=errors)
    LOGGER.debug(f"{name}: worker done")
    put_item(_STOP, out_q)


def _batch_iter(iterator, batch_size):
    """Group an iterator into lists of up to ``batch_size`` items."""
    buf = []
    for item in iterator:
        buf.append(item)
        if len(buf) >= batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def _batch_worker_loop(name, func, in_q, out_q, args, kwargs, errors):
    LOGGER.debug(f"{name}: batch worker up")

    def run():
        for batch in queue_iter(in_q):
            _run_guarded(
                "PIPELINE_ITEM_ERROR",
                name,
                lambda: _pump(func(batch, *args, **kwargs), out_q),
                errors=errors,
            )

    _run_guarded("PIPELINE_WORKER_ERROR", name, run, with_tb=False,
                 errors=errors)
    LOGGER.debug(f"{name}: batch worker done")
    put_item(_STOP, out_q)


def _producer_loop(name, func, out_q, args, kwargs):
    LOGGER.debug(f"{name}: producer up")
    _run_guarded(
        "PIPELINE_PRODUCER_ERROR",
        name,
        lambda: _pump(func(*args, **kwargs), out_q),
    )
    LOGGER.debug(f"{name}: producer done")
    put_item(_STOP, out_q)


def _launch(target, target_args, name, use_process):
    runner_cls = _MP.Process if use_process else Thread
    runner_cls(target=target, args=target_args, name=name, daemon=True).start()


class _Stage:
    """Common consumer side: iterate to drain the stage's output queue."""

    name = "stage"
    out_q = None
    _n_senders = 1

    def __iter__(self):
        try:
            yield from queue_iter(self.out_q, self._n_senders)
        except KeyboardInterrupt:
            LOGGER.debug(f"{self.name}: consumer interrupted")


class source_stage(_Stage):
    """Run a generator function in a background thread/process.

    Iterate this object to consume its output queue.
    """

    def __init__(self, func, args=(), kwargs=None, *, name="source",
                 q_maxsize=DEFAULT_QUEUE_SIZE, use_mp_queue=True,
                 use_process=False):
        self.name = name
        self.out_q = StageQueue(
            q_maxsize, name + ":out", cross_process=use_mp_queue
        )
        _launch(
            _producer_loop,
            (name, func, self.out_q, args, kwargs or {}),
            f"{name}_producer",
            use_process,
        )


class map_stage(_Stage):
    """Map ``func`` over an upstream iterable with N worker tasks.

    ``prep_func(*args, **kwargs) -> (args, kwargs)`` runs once inside each
    worker for state that must be constructed post-fork (e.g. BAM handles).

    An item whose ``func`` raises is logged and dropped; with thread
    workers its exception is also appended to ``errors``, so a driver can
    raise after draining (a process worker's exceptions are only logged).
    """

    def __init__(self, func, iterator, *, num_workers=1, prep_func=None,
                 args=(), kwargs=None, name="map",
                 q_maxsize=DEFAULT_QUEUE_SIZE, use_mp_queue=True,
                 use_process=False):
        self.name = name
        self._n_senders = self.num_workers = num_workers
        self.errors = []
        make_q = partial(StageQueue, q_maxsize, cross_process=use_mp_queue)
        self.out_q = make_q(name=name + ":out")
        in_q = make_q(name=name + ":in")
        # the filler is always a thread: it drains an in-process iterator
        # (often a generator or upstream stage) that cannot be pickled
        # into a spawned process
        filler = Thread(
            target=_fill_queue,
            args=(iterator, in_q, num_workers),
            name=f"{name}_filler",
            daemon=True,
        )
        filler.start()
        for idx in range(num_workers):
            _launch(
                _worker_loop,
                (name, func, prep_func, in_q, self.out_q, list(args),
                 kwargs or {}, None if use_process else self.errors),
                f"{name}_{idx}",
                use_process,
            )


class batch_map_stage(_Stage):
    """Map ``func`` over MICRO-BATCHES of upstream items.

    ``func`` receives a list of up to ``batch_size`` items and returns
    one output per item; the outputs are re-flattened into the stage's
    output queue, so consumers see the same per-item stream that
    ``map_stage`` would produce. Runs a single worker — built for
    stages that own an accelerator (e.g. the device banded-DP refine
    path) where batching amortizes kernel launches/transfers and a
    single process must hold the device.

    A batch whose ``func`` raises is logged and dropped, as a failed item
    of ``map_stage`` is, and its exception is appended to ``errors`` (an
    in-process worker's list; the port's drivers raise after draining
    when it is not empty, so a device failure never passes for a smaller
    output).
    """

    def __init__(self, func, iterator, batch_size, *, args=(), kwargs=None,
                 name="batch_map", q_maxsize=DEFAULT_QUEUE_SIZE,
                 use_mp_queue=True, use_process=False):
        self.name = name
        self._n_senders = 1
        self.errors = []
        make_q = partial(StageQueue, q_maxsize, cross_process=use_mp_queue)
        self.out_q = make_q(name=name + ":out")
        in_q = make_q(name=name + ":in")
        filler = Thread(
            target=_fill_queue,
            args=(_batch_iter(iterator, batch_size), in_q, 1),
            name=f"{name}_filler",
            daemon=True,
        )
        filler.start()
        _launch(
            _batch_worker_loop,
            (name, func, in_q, self.out_q, list(args), kwargs or {},
             self.errors),
            f"{name}_0",
            use_process,
        )
