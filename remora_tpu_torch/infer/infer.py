"""Streaming modified-base inference: POD5 + BAM -> modBAM.

Counterpart of ``remora_tpu/infer/infer.py``. Host stages (signal
decode, alignment join, chunk prep, batch assembly, unbatching, tag
formatting) stream through bounded queues; the device stage runs the
model's forward over fixed-size batches (the ragged last batch is padded
to the batch size and its outputs sliced back).

Data parallelism, as in the JAX package, by one of two routes that never
combine: handed a ``parallel.mesh.Mesh`` of more than one rank (one
process per GPU), each rank infers a disjoint stripe of the reads into a
BAM part that rank 0 merges (``_merge_multihost_parts``), on its own
device alone; without one, the device stage splits each batch's rows
over the local GPUs (``REMORA_TPU_INFER_DP``; one replica of each model
per GPU).

Entry points run on the GPU unless the caller names ``device="cpu"``;
with no GPU and no device named, ``ModelHandle.load`` raises.

Precision: the f32 path runs convs and matmuls in full f32 (TF32 off for
cuDNN and cuBLAS), as the JAX kernels pin ``Precision.HIGHEST``. The
bf16 path casts parameters and inputs to bf16 and returns f32 logits.

CUDA stays in the parent process: the driver's process stages (signal
extraction, alignment join, host read prep) fork and run NumPy only,
and every CUDA call (the device refiner's K4/K5, the forward's K1, the
host-to-device copies) runs in the parent's threads. Each batch's
host-to-device copy is queued inside the device stage, on the stream
that runs its forward (``run_model_batched``), so no copy queued on
another stream can race the forward.
"""

import array
import contextlib
import copy
import os
import sys
import time
from collections import defaultdict, deque
from threading import Event, Thread

import numpy as np
import torch

from remora_tpu_torch import RemoraError, constants, log
from remora_tpu_torch.core.pipeline import (
    NamedQueue,
    batch_map_stage,
    map_stage,
    put_item,
    queue_iter,
    source_stage,
)
from remora_tpu_torch.core.seq import Motif, revcomp
from remora_tpu_torch.core.tags import format_mm_ml_tags, softmax
from remora_tpu_torch.core.util import human_format, pad_rows, resolve_device
from remora_tpu_torch.io.bam import BamWriter, FastBamScanner
from remora_tpu_torch.io.pod5 import DatasetReader
from remora_tpu_torch.io.read import extract_alignments, iter_signal
from remora_tpu_torch.io.read_index import ReadIndexedBam, get_read_ids
from remora_tpu_torch.kernels import lstm as lstm_kernels
from remora_tpu_torch.kernels.encoded_kmers import compute_encoded_kmer_batch
from remora_tpu_torch.models import model_io

LOGGER = log.get_logger()

# per-stage cProfile hooks, read once at import as in the JAX package:
# each names the pstats file that the stage's thread dumps when it ends
# (PREP_DATA is read and unused there too)
_PROF_PREP_FN = os.getenv("REMORA_TPU_INFER_PREP_DATA_PROFILE_FILE")
_PROF_BATCH_FN = os.getenv("REMORA_TPU_INFER_BATCH_PROFILE_FILE")
_PROF_MODEL_FN = os.getenv("REMORA_TPU_INFER_RUN_MODEL_PROFILE_FILE")
_PROF_UNBATCH_FN = os.getenv("REMORA_TPU_INFER_UNBATCH_PROFILE_FILE")


def _maybe_profile(prof_path):
    """Decorator: dump cProfile stats for a pipeline stage when the env
    var for it is set."""

    def outer(func):
        if not prof_path:
            return func

        def wrapper(*args, **kwargs):
            import cProfile

            prof = cProfile.Profile()
            try:
                return prof.runcall(func, *args, **kwargs)
            finally:
                prof.dump_stats(prof_path)

        return wrapper

    return outer


def _check_stage_profiles():
    """Refuse, before any stage starts, two stage profiles at once where
    cProfile cannot run them: from Python 3.12 it profiles through
    ``sys.monitoring``, one profiler for the whole process, so a second
    ``cProfile.Profile`` started in another stage's thread raises
    ``ValueError('Another profiling tool is already active')`` (the JAX
    driver loses that stage mid-stream and raises after draining). One
    profile on 3.12 also records the other threads' calls while it runs."""
    names = [name for name, path in (
        ("REMORA_TPU_INFER_BATCH_PROFILE_FILE", _PROF_BATCH_FN),
        ("REMORA_TPU_INFER_RUN_MODEL_PROFILE_FILE", _PROF_MODEL_FN),
        ("REMORA_TPU_INFER_UNBATCH_PROFILE_FILE", _PROF_UNBATCH_FN),
    ) if path]
    if len(names) > 1 and sys.version_info >= (3, 12):
        raise RemoraError(
            f"{' and '.join(names)} are set: Python "
            f"{sys.version_info[0]}.{sys.version_info[1]}'s cProfile "
            "runs one profile a process, so profile one stage a run"
        )


def _model_read(remora_read, motifs):
    """Per-model working copy with its motif focus bases selected."""
    mdl_read = remora_read.copy()
    mdl_read.set_motif_focus_bases(motifs)
    return mdl_read


def _model_chunks(mdl_read, md):
    """Padded chunk-array dict for one canonical-base model, or None when
    the read yields no focus hits for its motifs (``mdl_read`` must come
    from ``_model_read``: the extraction skips the motif re-scan on the
    invariant that focus bases were selected from these same motifs)."""
    from remora_tpu_torch.data.chunk_batch import extract_chunks_batch

    # tight per-read row widths (the batch assembler pastes narrower
    # rows into model-wide batches); max_seq_len stays the drop bound.
    # motifs=None: focus bases were JUST selected from these same motifs
    # (set_motif_focus_bases -> findall), and findall hits are interior
    # by construction, so the re-scan mask is identically all-True here
    # (the ETL path keeps it: its focus bases can come from BED files)
    result = extract_chunks_batch(
        mdl_read,
        md["chunk_context"],
        md["kmer_context_bases"],
        md["chunk_len"] + 2,
        base_start_justify=md["base_start_justify"],
        offset=md["offset"],
        motifs=None,
        tight=True,
    )
    return None if result is None else result[0]


def _chunks_for_model(remora_read, md, motifs):
    mdl_read = _model_read(remora_read, motifs)
    mdl_read.refine_signal_mapping(md["sig_map_refiner"])
    return _model_chunks(mdl_read, md)


def prepare_reads(read_errs, models_metadata, ref_anchored):
    """Vectorized chunk extraction per read per canonical-base model.

    Produces padded dataset-format arrays directly (data.chunk_batch), no
    per-chunk Python loop — the reference's hottest inference host stage
    (``inference.py:62–137``).
    """
    motifs = {
        md["can_base"]: [Motif(*mot) for mot in md["motifs"]]
        for md in models_metadata
    }
    prepped = []
    for io_read, err in read_errs:
        if err is None:
            try:
                remora_read = io_read.into_remora_read(ref_anchored)
            except RemoraError as e:
                err = f"Read prep error: {e}"
            except Exception as e:  # noqa: BLE001 — keep the stream alive
                err = f"Unexpected error: {e}"
        io_read.prune(drop_move_tag=False)
        if err is not None:
            LOGGER.debug(f"{io_read.child_read_id} {err}")
            prepped.append((io_read, None, err))
            continue
        per_base_arrays = {}
        for md in models_metadata:
            cb = md["can_base"]
            chunks = _chunks_for_model(remora_read, md, motifs[cb])
            if chunks is None:
                why = f"No {cb} mod calls"
                LOGGER.debug(f"{io_read.child_read_id} {why}")
                prepped.append((io_read, None, why))
            else:
                per_base_arrays[cb] = chunks
        prepped.append((io_read, per_base_arrays, None))
    return prepped


def prepare_reads_batched(batch_read_errs, models_metadata, ref_anchored):
    """``prepare_reads`` over a read micro-batch, with all models' DP
    refinement batched across reads on the device
    (``SigMapRefiner.refine_reads_batch``, refine backend=device).

    Returns one ``prepare_reads``-shaped output list per upstream item
    (the batch_map_stage worker re-flattens them)."""
    motifs = {
        md["can_base"]: [Motif(*mot) for mot in md["motifs"]]
        for md in models_metadata
    }
    outputs = [[] for _ in batch_read_errs]
    # alignment entries in arrival order: [slot, io_read, per_base, errs]
    entries = []
    jobs = []  # (entry, md, mdl_read)
    for slot, read_errs in enumerate(batch_read_errs):
        for io_read, err in read_errs:
            if err is None:
                try:
                    remora_read = io_read.into_remora_read(ref_anchored)
                except RemoraError as e:
                    err = f"Read prep error: {e}"
                except Exception as e:  # noqa: BLE001 — keep stream alive
                    err = f"Unexpected error: {e}"
            io_read.prune(drop_move_tag=False)
            if err is not None:
                LOGGER.debug(f"{io_read.child_read_id} {err}")
                outputs[slot].append((io_read, None, err))
                continue
            entry = [slot, io_read, {}, []]
            entries.append(entry)
            for md in models_metadata:
                jobs.append(
                    (entry, md, _model_read(remora_read, motifs[md["can_base"]]))
                )
    # one batched refine per distinct refiner (models may share one)
    by_refiner = {}
    for job in jobs:
        smr = job[1]["sig_map_refiner"]
        by_refiner.setdefault(id(smr), (smr, []))[1].append(job)
    for smr, ref_jobs in by_refiner.values():
        if smr is None or not smr.is_loaded:
            refine_errs = [None] * len(ref_jobs)
        else:
            refine_errs = smr.refine_reads_batch(
                [mdl_read for _e, _md, mdl_read in ref_jobs]
            )
        for (entry, md, mdl_read), rerr in zip(ref_jobs, refine_errs):
            _slot, io_read, per_base, errs = entry
            cb = md["can_base"]
            if rerr is not None:
                why = f"Read prep error: {rerr}"
                LOGGER.debug(f"{io_read.child_read_id} {why}")
                errs.append(why)
                continue
            chunks = _model_chunks(mdl_read, md)
            if chunks is None:
                why = f"No {cb} mod calls"
                LOGGER.debug(f"{io_read.child_read_id} {why}")
                errs.append(why)
            else:
                per_base[cb] = chunks
    for slot, io_read, per_base, errs in entries:
        for why in errs:
            outputs[slot].append((io_read, None, why))
        outputs[slot].append((io_read, per_base, None))
    return outputs


def prep_nn_input(read_errs):
    """Materialize nn inputs per read: the compact arrays (labels dropped)
    that the device stage featurizes on the device."""
    if not read_errs:
        return [(None, None, "No valid mappings")]
    out = []
    for io_read, read_arrays, err in read_errs:
        if err is not None:
            out.append((io_read, None, err))
            continue
        per_base = {
            can_base: {k: v for k, v in arrays.items() if k != "labels"}
            for can_base, arrays in read_arrays.items()
        }
        out.append((io_read, per_base, None))
    return out


class _BatchAssembler:
    """Fixed-size batch accumulator for one canonical base.

    Rows from successive reads are packed back to back; a read whose
    chunks straddle an emission boundary appears in every batch it
    touches — start offset recorded in the first, ``None`` markers in
    the rest — which is what lets the unbatcher stitch outputs back
    together (reference analog ``inference.py:171–262``).
    """

    def __init__(self, md, batch_size):
        self.md = md
        self.batch_size = batch_size
        self._reset()

    def _reset(self):
        nrows, md = self.batch_size, self.md
        width = md["chunk_len"]
        # a width-wide signal window covers at most width + 2 bases
        seq_w = width + 2 + sum(md["kmer_context_bases"])
        self.inputs = (
            np.zeros((nrows, 1, width), np.float32),
            np.full((nrows, seq_w), -1, np.int8),
            np.zeros((nrows, width + 3), np.int16),
            np.zeros(nrows, np.int32),
        )
        self.focus = np.empty(nrows, int)
        self.fill = 0
        self.members = []

    def _paste(self, chunks, lo, hi):
        d0, d1 = self.fill, self.fill + (hi - lo)
        self.inputs[0][d0:d1] = chunks["signal"][lo:hi]
        seqs = chunks["sequence"][lo:hi]
        maps = chunks["sequence_to_signal_mapping"][lo:hi]
        self.inputs[1][d0:d1, : seqs.shape[1]] = seqs
        self.inputs[2][d0:d1, : maps.shape[1]] = maps
        self.inputs[3][d0:d1] = chunks["sequence_lengths"][lo:hi]
        self.focus[d0:d1] = chunks["read_focus_bases"][lo:hi]

    def note_error(self, io_read, err):
        self.members.append([io_read, None, None, err])

    def add(self, io_read, chunks):
        """Pack one read's rows, yielding each batch they fill."""
        total = chunks["read_focus_bases"].size
        placed = 0
        entry = True
        while self.fill + (total - placed) >= self.batch_size:
            take = self.batch_size - self.fill
            self._paste(chunks, placed, placed + take)
            self.members.append(
                [io_read, self.fill if entry else None, None, None]
            )
            placed += take
            entry = False
            full = (
                self.md["can_base"], self.inputs, self.focus, self.members
            )
            self._reset()
            yield full
        self._paste(chunks, placed, total)
        self.members.append(
            [
                io_read,
                self.fill if entry else None,
                self.fill + (total - placed),
                None,
            ]
        )
        self.fill += total - placed

    def drain(self):
        """The final ragged batch, or None when no rows are pending."""
        if self.fill == 0:
            return None
        live = self.fill
        return (
            self.md["can_base"],
            tuple(a[:live] for a in self.inputs),
            self.focus[:live],
            self.members,
        )


def batch_reads(prepped_nn_inputs, batches_q, batch_size, models_metadata):
    """Assemble fixed-size batches spanning read boundaries per can_base.

    Emits (can_base, input_arrays_tuple, read_pos, members) of host
    arrays; the input tuple is (signal, sequence i8, mapping i16, seq_lens
    i32) padded to model-wide widths for on-device featurization
    (``ModelHandle.eval_raw``). The device stage copies them
    to the device on its own stream (the JAX package's ``stage_h2d``
    option, which ships batches from this thread, is not ported).
    """
    packers = {
        md["can_base"]: _BatchAssembler(md, batch_size)
        for md in models_metadata
    }
    for read_nn_inputs in prepped_nn_inputs:
        for io_read, bases_chunks, err in read_nn_inputs:
            if err is not None:
                for packer in packers.values():
                    packer.note_error(io_read, err)
                continue
            for cb, r_chunks in bases_chunks.items():
                for full_batch in packers[cb].add(io_read, r_chunks):
                    put_item(full_batch, batches_q)
    for packer in packers.values():
        tail = packer.drain()
        if tail is not None:
            put_item(tail, batches_q)
    put_item(StopIteration, batches_q)


def _side_stream(device):
    """A side stream on ``device`` that starts after all work queued there
    so far (the model's own host->device copies included); None off
    CUDA."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def run_model_batched(batches_q, called_batches_q, eval_fns,
                      device_batch_size):
    """Device stage: forward per canonical base, padded last batch.

    ``eval_fns[cb]`` is one eval callable, or a list of (device, callable)
    replicas (``ModelHandle.shard_over``) that split each batch's rows in
    equal parts, one part per device, each on its device's side stream.
    Up to REMORA_TPU_INFER_INFLIGHT (default 2) batches stay in flight:
    each batch's forward and its device->host copy into pinned memory are
    queued on a side CUDA stream and fenced by an event, so the copy of
    batch N overlaps the host->device copy and compute of batch N+1; the
    host waits on a batch's events only when it emits that batch. With
    REMORA_TPU_INFER_STAGE_STATS set it logs its batches, K1's launches
    while it ran (``kernels.lstm.LAUNCHES``) and its per-batch host times.
    """
    inflight = max(1, int(os.getenv("REMORA_TPU_INFER_INFLIGHT", "2")))
    pending = deque()
    stats = {"batches": 0, "dispatch_s": 0.0, "fetch_s": 0.0,
             "wait_s": 0.0}
    k1_before = lstm_kernels.LAUNCHES
    replicas = {
        cb: [(None, fns)] if callable(fns) else list(fns)
        for cb, fns in eval_fns.items()
    }
    streams = {dev: _side_stream(dev)
               for reps in replicas.values() for dev, _fn in reps}

    def emit_oldest():
        cb, parts, live, b_read_pos, b_reads = pending.popleft()
        t0 = time.monotonic()
        for _host, done in parts:
            if done is not None:
                done.synchronize()
        hosts = [host for host, _done in parts]
        nn_out = (hosts[0] if len(hosts) == 1 else torch.cat(hosts)).numpy()
        stats["fetch_s"] += time.monotonic() - t0
        put_item((cb, nn_out[:live], b_read_pos, b_reads), called_batches_q)

    def launch(dev, fn, inputs):
        """One replica's forward and its copy into pinned host memory on
        its side stream: (host tensor, event or None)."""
        with torch.cuda.stream(streams[dev]):  # no-op for None
            out = fn(*inputs)
            if not out.is_cuda:
                return out, None
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return host, done

    for item in _timed_iter(queue_iter(batches_q), stats):
        cb, b_inputs, b_read_pos, b_reads = item
        live = b_read_pos.size
        if b_inputs[0].shape[0] != device_batch_size:
            # pad up to the fixed batch shape; outputs are sliced back
            b_inputs = tuple(
                pad_rows(arr, device_batch_size) for arr in b_inputs
            )
        t0 = time.monotonic()
        reps = replicas[cb]
        per = device_batch_size // len(reps)
        parts = [
            launch(dev, fn, tuple(a[j * per:(j + 1) * per]
                                  for a in b_inputs))
            for j, (dev, fn) in enumerate(reps)
        ]
        stats["dispatch_s"] += time.monotonic() - t0
        stats["batches"] += 1
        pending.append((cb, parts, live, b_read_pos, b_reads))
        if len(pending) > inflight:
            emit_oldest()
    while pending:
        emit_oldest()
    if os.getenv("REMORA_TPU_INFER_STAGE_STATS"):
        n = max(stats["batches"], 1)
        LOGGER.info(
            f"Device stage: {stats['batches']} batches, K1 launches "
            f"{lstm_kernels.LAUNCHES - k1_before}, per-batch "
            f"dispatch {stats['dispatch_s'] / n * 1e3:.1f}ms, "
            f"fetch {stats['fetch_s'] / n * 1e3:.1f}ms, "
            f"input-wait {stats['wait_s'] / n * 1e3:.1f}ms"
        )
    put_item(StopIteration, called_batches_q)


def _timed_iter(items, stats):
    """``items``, the time spent waiting for each added to
    ``stats["wait_s"]``."""
    while True:
        t0 = time.monotonic()
        item = next(items, None)
        stats["wait_s"] += time.monotonic() - t0
        if item is None:
            return
        yield item


class _ReadJoiner:
    """Stitches per-batch output rows back into whole reads, then joins
    each read's results across the canonical-base models."""

    def __init__(self, models_metadata):
        self.can_bases = [md["can_base"] for md in models_metadata]
        # per model: a read whose rows still span into the next batch
        self.open = dict.fromkeys(self.can_bases)
        # read_id -> [(can_base, (io_read, nn_out, positions, err))]
        self.parts = defaultdict(list)

    def feed(self, cb, nn_out, read_pos, members):
        """Absorb one batch; return reads now complete across models."""
        held = self.open[cb]
        closed = []
        for io_read, b_st, b_en, err in members:
            if err is not None:
                if held is not None:
                    closed.append(held)
                    held = None
                closed.append((io_read, None, None, err))
            elif b_st is None:
                # continuation rows of the read carried from last batch
                if held is None:
                    raise RemoraError("Unbatching encountered None read")
                held_read, prev_out, prev_pos, _ = held
                if held_read.read_id != io_read.read_id:
                    raise RemoraError(
                        "Unbatching encountered mismatching reads"
                    )
                held = (
                    held_read,
                    np.concatenate([prev_out, nn_out[:b_en]], axis=0),
                    np.concatenate([prev_pos, read_pos[:b_en]]),
                    None,
                )
            else:
                if held is not None:
                    closed.append(held)
                held = (
                    io_read, nn_out[b_st:b_en], read_pos[b_st:b_en], None
                )
        self.open[cb] = held
        for item in closed:
            self.parts[item[0].read_id].append((cb, item))
        ready = [
            rid
            for rid, got in self.parts.items()
            if len(got) == len(self.can_bases)
        ]
        return [self._join(self.parts.pop(rid)) for rid in ready]

    def flush(self):
        """End-of-stream: the still-open read joined across models."""
        if self.open[self.can_bases[0]] is None:
            return None
        return self._join([(cb, self.open[cb]) for cb in self.can_bases])

    @staticmethod
    def _join(parts):
        io_read = parts[-1][1][0]
        calls = [
            (cb, out, pos)
            for cb, (_rd, out, pos, err) in parts
            if err is None
        ]
        if calls:
            return io_read, calls, None
        reasons = sorted({err for _cb, (_rd, _o, _p, err) in parts})
        return io_read, calls, ",".join(reasons)


def unbatch(called_batches_q, called_reads_q, models_metadata):
    joiner = _ReadJoiner(models_metadata)
    for cb, nn_out, b_read_pos, b_reads in queue_iter(called_batches_q):
        for whole_read in joiner.feed(cb, nn_out, b_read_pos, b_reads):
            put_item(whole_read, called_reads_q)
    leftover = joiner.flush()
    if leftover is not None:
        put_item(leftover, called_reads_q)
    put_item(StopIteration, called_reads_q)


def post_process_reads(read_mapping, models_metadata, ref_anchored):
    """Softmax -> MM/ML tags; optional reference-anchored record rewrite."""
    io_read, mod_calls, err = read_mapping
    if err is not None:
        return io_read, err
    md_dict = {md["can_base"]: md for md in models_metadata}
    seq = io_read.ref_seq if ref_anchored else io_read.seq
    mm_tags = []
    ml_arr = array.array("B")
    for cb, nn_out, r_poss in mod_calls:
        # class-1.. probabilities in f64, as the reference formats them
        mod_probs = softmax(nn_out)[:, 1:].astype(np.float64)
        cb_mm, cb_ml = format_mm_ml_tags(
            seq=seq,
            poss=r_poss,
            probs=mod_probs,
            mod_bases=md_dict[cb]["mod_bases"],
            can_base=cb,
        )
        mm_tags.append(cb_mm)
        ml_arr.extend(cb_ml)

    rec = io_read.full_align
    rec.set_tag("MM", "Z", "".join(mm_tags))
    rec.set_tag("ML", "BC", np.frombuffer(ml_arr.tobytes(), dtype=np.uint8))
    if ref_anchored:
        flat_seq = io_read.ref_seq
        rec.cigartuples = [(0, len(flat_seq))]
        if io_read.ref_reg.strand != "+":
            flat_seq = revcomp(flat_seq)
        rec.query_sequence = flat_seq
        rec.query_qualities = None
    return io_read, None


def _check_handles(models):
    for mdl in models:
        if not isinstance(mdl, ModelHandle):
            raise RemoraError(
                f"models must be ModelHandles, not {type(mdl).__name__}")


def _resolve_models(models):
    """(metadata list, {can_base: eval fn or (device, eval fn) replicas})
    of the ModelHandles: each featurizes its batches on its device
    (``eval_raw``), or on each device it was spread over."""
    metadata = [m.metadata for m in models]
    eval_fns = {
        m.metadata["can_base"]: (
            m.eval_raw if m.replicas is None
            else [(r.device, r.eval_raw) for r in m.replicas])
        for m in models
    }
    return metadata, eval_fns


def local_devices(device):
    """The devices the device stage can split a batch over: every visible
    GPU for a model on a GPU, else ``device`` alone."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _infer_device_split(batch_size, device, world=1):
    """(devices, device_batch_size) the device stage splits each batch
    over, or (None, batch_size) when it stays on one device.

    A rank of a multi-process group (``world`` > 1) keeps its own device:
    the processes already split the work one per GPU, so the split is
    off there, and REMORA_TPU_INFER_DP asking for one raises.

    The eval forward is row-independent (BatchNorm takes its running
    statistics), so splitting the rows changes no row's logits. A batch
    size that does not divide over the devices pads the device batch up
    to the next multiple (the batches keep ``batch_size`` live rows).
    REMORA_TPU_INFER_DP overrides the device count: 0/1 keeps one device,
    N takes the first N local devices (unset: all local devices when
    there is more than one)."""
    n_req = os.getenv("REMORA_TPU_INFER_DP")
    if world > 1:
        if n_req is not None and int(n_req) > 1:
            raise RemoraError(
                f"REMORA_TPU_INFER_DP={n_req} splits batches over the local "
                f"devices, but this process is a rank of {world}, which "
                "runs on its own device: unset it, or run one process"
            )
        return None, batch_size
    devs = local_devices(device)
    if n_req is not None:
        n = int(n_req)
        if n <= 1:
            return None, batch_size
        if n > len(devs):
            raise RemoraError(
                f"REMORA_TPU_INFER_DP={n} but only {len(devs)} local "
                "devices are attached"
            )
        devs = devs[:n]
    elif len(devs) <= 1:
        return None, batch_size
    n_dev = len(devs)
    device_batch_size = -(-batch_size // n_dev) * n_dev
    if device_batch_size != batch_size:
        LOGGER.info(
            f"batch size {batch_size} does not divide over {n_dev} "
            f"local devices; padding device batches to "
            f"{device_batch_size} rows"
        )
    LOGGER.info(f"Inference device stage split over {n_dev} local devices")
    return devs, device_batch_size


class _InferProgress:
    """tqdm wrapper: per-read ticks + a live samples/s postfix."""

    def __init__(self, num_reads):
        from tqdm import tqdm

        self.t0 = time.monotonic()
        self.samples = 0
        self.last_rid = None
        self.bar = tqdm(
            desc="Inferring mods",
            total=num_reads,
            unit=" Reads",
            smoothing=0,
            dynamic_ncols=True,
            disable=bool(os.environ.get("LOG_SAFE", False)),
        )

    def skipped(self):
        self.bar.update()

    def called(self, io_read):
        if self.last_rid != io_read.read_id:
            self.bar.update()
        self.last_rid = io_read.read_id
        self.samples += io_read.sig_len or 0
        rate, mag = human_format(self.samples / self.elapsed())
        self.bar.set_postfix_str(
            f"{rate:>5.1f} {mag}samps/s", refresh=False
        )

    def elapsed(self):
        return max(time.monotonic() - self.t0, 1e-9)

    def close(self):
        self.bar.close()


def infer_from_pod5_and_bam(
    pod5_path,
    in_bam_path,
    models,
    out_bam_path,
    *,
    num_reads=None,
    queue_max=1_000,
    num_extract_alignment_workers=1,
    num_prep_read_workers=1,
    num_prep_nn_input_workers=1,
    num_post_process_workers=1,
    batch_size=constants.DEFAULT_BATCH_SIZE,
    skip_non_primary=True,
    ref_anchored=False,
    refine_backend=None,
    mesh=None,
):
    """Run the full streaming inference pipeline.

    Args:
        models: list of ModelHandle, on one device (each featurizes its
            batches there from the compact raw arrays).
        refine_backend: override the banded-DP execution backend of the
            models' metadata-embedded refiners (auto/native/numpy/
            device). ``device`` replaces the process-parallel read-prep
            stage with a single in-process worker that batches all
            reads' DP refinements into shared K4/K5 launches on the
            models' device.
        mesh: this rank's ``parallel.mesh.Mesh``. Of more than one rank,
            this rank infers the reads ``sorted(read_ids)[:num_reads]
            [rank::world]`` into ``out_bam_path.partNNNN`` on its models'
            device, and rank 0 merges the parts into ``out_bam_path`` in
            rank order; every rank returns the global record count.
            Without one, the device stage splits each batch over the
            local devices (``_infer_device_split``).
    """
    _check_handles(models)
    _check_stage_profiles()
    bam_idx = ReadIndexedBam(
        in_bam_path, skip_non_primary=skip_non_primary, req_tags={"mv"}
    )
    if not bam_idx.num_records:
        LOGGER.info("No records found in BAM file.")
        sys.exit()
    with DatasetReader(pod5_path) as pod5_dr:
        read_ids, num_reads = get_read_ids(bam_idx, pod5_dr, num_reads)

    # multi-process data parallelism: each rank streams a disjoint stripe
    # of the reads through its own pipeline into a BAM part, and rank 0
    # merges the parts after the others have closed theirs
    merged_out_path = None
    world = 1 if mesh is None else mesh.world
    if world > 1:
        rank = mesh.rank
        # sorted before striding: get_read_ids returns set-ordered ids;
        # the global num_reads cap applies before the stripe
        read_ids = sorted(read_ids)[:num_reads][rank::world]
        num_reads = len(read_ids)
        merged_out_path = out_bam_path
        out_bam_path = f"{out_bam_path}.part{rank:04d}"
        LOGGER.info(
            f"Process {rank}/{world} infers {num_reads} reads into "
            f"{out_bam_path}"
        )

    # within-process data parallelism: split the device stage's batches
    # over the local devices (before _resolve_models binds the evals)
    split_devs, device_batch_size = _infer_device_split(
        batch_size, models[0].device, world)
    if split_devs is not None:
        for mdl in models:
            mdl.shard_over(split_devs)

    models_metadata, eval_fns = _resolve_models(models)
    # a parameter's device: a GPU's carries its index, so the device
    # refiner below stays on this one card (an index-less "cuda" would
    # spread it over every visible GPU)
    device = models[0].device
    if refine_backend in (None, constants.REFINE_BACKEND_AUTO):
        # probe the device link once: 'auto' routes the banded DP to the
        # batched K4/K5 path on a co-located GPU, host otherwise.
        # IN-PROCESS probe: the models already hold a CUDA context here,
        # and the device DP would run in this process
        from remora_tpu_torch.refine.autoselect import (
            probe_device_roundtrip_inprocess,
            resolve_auto_backend,
        )

        refine_backend = resolve_auto_backend(
            [md.get("sig_map_refiner") for md in models_metadata],
            probe=lambda: probe_device_roundtrip_inprocess(device),
        )
    for md in models_metadata:
        if md.get("sig_map_refiner") is not None:
            md["sig_map_refiner"].backend = refine_backend
            # the device DP runs where the models run
            md["sig_map_refiner"].device = device
    device_refine = refine_backend == constants.REFINE_BACKEND_DEVICE

    signals = source_stage(
        iter_signal,
        args=(pod5_path,),
        kwargs=dict(
            read_ids=read_ids,
            num_reads=num_reads,
            pa_scaling=models_metadata[0]["pa_scaling"],
            rev_sig=models_metadata[0]["reverse_signal"],
        ),
        name="ExtractSignal",
        use_process=True,
        q_maxsize=queue_max,
    )
    reads = map_stage(
        extract_alignments,
        signals,
        name="AddAlignments",
        num_workers=num_extract_alignment_workers,
        args=(bam_idx, models_metadata[0]["reverse_signal"]),
        q_maxsize=queue_max,
        use_process=True,
    )
    if device_refine:
        # the device DP stage owns the (single) GPU: one in-process
        # worker over read micro-batches, DP refinement for the whole
        # batch in shared K4/K5 launches (never in a forked child)
        prepped_reads = batch_map_stage(
            prepare_reads_batched,
            reads,
            constants.REFINE_DEVICE_READ_BATCH,
            name="PrepReadData",
            args=(models_metadata, ref_anchored),
            q_maxsize=100,
        )
    else:
        prepped_reads = map_stage(
            prepare_reads,
            reads,
            name="PrepReadData",
            num_workers=num_prep_read_workers,
            args=(models_metadata, ref_anchored),
            q_maxsize=100,
            use_process=True,
        )
    prepped_nn_input = map_stage(
        prep_nn_input,
        prepped_reads,
        num_workers=num_prep_nn_input_workers,
        name="PrepNNInput",
        use_process=False,
        use_mp_queue=False,
        q_maxsize=10,
    )

    stage_errors = {}

    def serial_stage(target, prof_path, out_maxsize, out_name, *extra):
        out_q = NamedQueue(maxsize=out_maxsize, name=out_name)
        wrapped = _maybe_profile(prof_path)(target)

        def guarded(*a):
            # a crashed serial stage must still emit its end sentinel,
            # or every downstream stage (and the main loop) deadlocks;
            # the error is recorded so the driver raises after draining
            try:
                wrapped(*a)
            except BaseException as e:
                LOGGER.exception(
                    f"{target.__name__} stage failed; shutting pipeline "
                    "down"
                )
                stage_errors[target.__name__] = e
                put_item(StopIteration, out_q)
                raise

        th = Thread(
            target=guarded,
            args=extra + (out_q,),
            name=target.__name__,
            daemon=True,
        )
        th.start()
        return out_q, th

    def _batcher(src, sink):
        batch_reads(src, sink, batch_size, models_metadata)

    _batcher.__name__ = "batch_reads"
    batches_q, batch_reads_t = serial_stage(
        _batcher,
        _PROF_BATCH_FN,
        4,
        "Batches",
        queue_iter(prepped_nn_input.out_q, num_prep_nn_input_workers),
    )

    def _caller(src, sink):
        run_model_batched(src, sink, eval_fns, device_batch_size)

    _caller.__name__ = "call_batches"
    called_batches_q, call_batches_t = serial_stage(
        _caller, _PROF_MODEL_FN, 4, "CalledBatches", batches_q
    )

    def _joiner(src, sink):
        unbatch(src, sink, models_metadata)

    _joiner.__name__ = "unbatch"
    called_reads_q, unbatch_t = serial_stage(
        _joiner, _PROF_UNBATCH_FN, queue_max, "Unbatch", called_batches_q
    )

    final_reads = map_stage(
        post_process_reads,
        queue_iter(called_reads_q),
        name="PostProcess",
        num_workers=num_post_process_workers,
        args=(models_metadata, ref_anchored),
        q_maxsize=queue_max,
        use_process=False,
        use_mp_queue=False,
    )

    stage_qs = (
        signals.out_q,
        reads.out_q,
        prepped_reads.out_q,
        prepped_nn_input.out_q,
        batches_q,
        called_batches_q,
        called_reads_q,
        final_reads.out_q,
    )

    def queue_status():
        cells = (f"{q.name}: {q.qsize()}/{q.maxsize}" for q in stage_qs)
        return "QueuesStatus: " + "\t".join(cells)

    # REMORA_TPU_INFER_STAGE_STATS=1: sample queue depths on a timer and
    # log an occupancy summary at the end — a stage whose INPUT queue is
    # persistently full while its OUTPUT queue sits empty is the
    # bottleneck (reference analog: per-read queue-status debug lines,
    # inference.py:602–607, which are too verbose to eyeball at scale)
    stats_stop = None
    if os.getenv("REMORA_TPU_INFER_STAGE_STATS"):
        stats_stop = Event()
        samples = {q.name: [] for q in stage_qs}

        def _sampler():
            while not stats_stop.wait(0.2):
                for q in stage_qs:
                    samples[q.name].append(q.qsize())

        Thread(target=_sampler, name="StageStats", daemon=True).start()

        def _stats_summary():
            lines = []
            for q in stage_qs:
                vals = samples[q.name]
                if not vals:
                    continue
                full_frac = sum(
                    v >= max(q.maxsize, 1) for v in vals
                ) / len(vals)
                empty_frac = sum(v == 0 for v in vals) / len(vals)
                mean_depth = sum(vals) / len(vals)
                lines.append(
                    f"{q.name:<16} mean {mean_depth:8.1f}  "
                    f"empty {empty_frac:5.1%}  full {full_frac:5.1%}"
                )
            return "Stage queue occupancy:\n" + "\n".join(lines)
    else:
        _stats_summary = None

    skip_tally = defaultdict(int, bam_idx.skip_reasons)
    in_bam = FastBamScanner(in_bam_path)
    progress = _InferProgress(num_reads)
    n_written = 0
    with BamWriter(out_bam_path, in_bam.header) as out_bam:
        for io_read, err in final_reads:
            LOGGER.debug(queue_status())
            if io_read is None:
                skip_tally[err] += 1
                progress.skipped()
                continue
            progress.called(io_read)
            if err is not None:
                skip_tally[err] += 1
            out_bam.write(io_read.full_align)
            n_written += 1
    progress.close()
    if stats_stop is not None:
        stats_stop.set()
        LOGGER.info(_stats_summary())
    rate, mag = human_format(progress.samples / progress.elapsed())
    LOGGER.info(f"Wrote {n_written} records ({rate:.1f} {mag}samples/s)")
    if skip_tally:
        by_count = sorted(
            skip_tally.items(), key=lambda kv: kv[1], reverse=True
        )
        lines = (f"{num:>7} : {why:<80}" for why, num in by_count)
        LOGGER.info("Unsuccessful read reasons:\n" + "\n".join(lines))
    # bounded joins: a crashed downstream stage can leave its upstream
    # producer blocked on a full queue (daemon threads, so a timed-out
    # join is safe to abandon) — never hang the driver on it
    batch_reads_t.join(timeout=None if not stage_errors else 10)
    call_batches_t.join(timeout=None if not stage_errors else 10)
    # the unbatch stage has sent its last reads; its profile (if any) is
    # dumped when its thread ends
    unbatch_t.join(timeout=None if not stage_errors else 10)
    if device_refine and prepped_reads.errors:
        # the device refinement raised: its micro-batch of reads is gone
        stage_errors.setdefault("PrepReadData", prepped_reads.errors[0])
    if stage_errors:
        name, err = next(iter(stage_errors.items()))
        raise RemoraError(
            f"inference pipeline stage '{name}' failed after {n_written} "
            f"records were written: {err!r}"
        ) from err
    if merged_out_path is not None:
        n_written = _merge_multihost_parts(
            mesh, merged_out_path, n_written, progress.samples
        )
    return n_written


def _merge_multihost_parts(mesh, out_bam_path, n_written_local,
                           samples_local):
    """Gather every rank's written-record and sample counts over
    ``mesh``, and on rank 0 merge the ranks' BAM parts into
    ``out_bam_path`` in rank order and delete them; the other ranks wait
    at a barrier until the merged file exists. Returns the global record
    count on every rank.

    The gather doubles as the barrier that holds rank 0 until every part
    is closed. Parts that rank 0 cannot see (ranks on hosts without
    shared storage) are left in place with an error in the log."""
    counts = mesh.gather_counts([n_written_local, samples_local])
    n_written = int(counts[:, 0].sum())
    world = mesh.world
    if mesh.rank == 0:
        part_paths = [f"{out_bam_path}.part{r:04d}" for r in range(world)]
        missing = [p for p in part_paths if not os.path.exists(p)]
        if missing:
            LOGGER.error(
                f"Cannot merge per-rank BAM parts: {len(missing)} of "
                f"{len(part_paths)} parts are not visible on this host's "
                f"filesystem (first missing: {missing[0]}). Multi-process "
                "inference needs --out-bam on storage shared by all "
                f"ranks, or merge the {out_bam_path}.partNNNN files "
                "yourself."
            )
        else:
            scanner = FastBamScanner(part_paths[0])
            with BamWriter(out_bam_path, scanner.header) as out_bam:
                for part in part_paths:
                    for rec in FastBamScanner(part):
                        out_bam.write(rec)
            LOGGER.info(
                f"Merged {n_written} records from {world} rank parts into "
                f"{out_bam_path} ({int(counts[:, 1].sum()):,} samples "
                "called)"
            )
            for part in part_paths:
                os.remove(part)
    mesh.barrier()
    return n_written


@contextlib.contextmanager
def full_f32():
    """f32 convs and matmuls in full f32: TF32 off for cuDNN and cuBLAS.
    (These are process-wide flags; they are restored on exit.)"""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _put(arr, device):
    """Host array (or tensor) -> tensor on ``device``. Host memory bound
    for a GPU is staged through pinned memory so the copy is async on the
    current stream."""
    t = torch.as_tensor(arr)
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _cast_state(model, compute_dtype):
    """Cast every float32 parameter and buffer to ``compute_dtype``
    (in place; None leaves the model as it is)."""
    if compute_dtype is None:
        return model
    return model.to(compute_dtype)


def _model_device(model):
    return next(model.parameters()).device


def make_model_eval_fn(model, compute_dtype=None):
    """Logits fn ``(sigs, enc_kmers) -> (B, num_out)`` f32 tensor on the
    model's device, for host-featurized batches in (B, C, T) layout.

    ``compute_dtype`` (``torch.bfloat16``) runs the forward in reduced
    precision with f32 logits out; the default f32 path is the
    reference-parity one.
    """
    model = _cast_state(model, compute_dtype)
    device = _model_device(model)

    @torch.inference_mode()
    def _eval(sigs, enc_kmers):
        sigs, enc_kmers = _put(sigs, device), _put(enc_kmers, device)
        if compute_dtype is not None:
            sigs = sigs.to(compute_dtype)
            enc_kmers = enc_kmers.to(compute_dtype)
        with full_f32():
            return model(sigs, enc_kmers).float()

    return _eval


class ModelHandle:
    """Loaded model + eval paths for the inference device stage.

    ``eval_fn(sigs, enc_kmers)`` consumes host-featurized batches;
    ``eval_raw(sigs, seqs, maps, lens)`` featurizes on the device, so each
    batch ships the compact ragged arrays instead of the ~50x larger
    one-hot features. Both return f32 logits on the model's device.
    """

    def __init__(self, model, metadata, compute_dtype=None):
        self.model = _cast_state(model.eval(), compute_dtype)
        self.metadata = metadata
        self.compute_dtype = compute_dtype
        self.device = _model_device(self.model)
        self.replicas = None
        self._eval = None

    def shard_over(self, devices):
        """Data-parallel device stage: one replica of this handle on each
        of ``devices``; ``infer_from_pod5_and_bam``'s device stage splits
        each batch's rows over them (``_resolve_models``). The forward is
        row-independent, so the logits equal the one-device stage's."""
        self.replicas = [
            ModelHandle(copy.deepcopy(self.model).to(dev), self.metadata,
                        self.compute_dtype)
            for dev in devices
        ]

    @property
    def eval_fn(self):
        if self._eval is None:
            self._eval = make_model_eval_fn(self.model, self.compute_dtype)
        return self._eval

    @torch.inference_mode()
    def eval_raw(self, sigs, seqs, maps, lens):
        """sigs (B, 1, W) f32, seqs (B, S + ctx) int8, maps (B, S + 1),
        lens (B,) -> f32 logits (B, num_out)."""
        bb, ab = self.metadata["kmer_context_bases"]
        cd = self.compute_dtype
        sigs, seqs, maps, lens = (
            _put(a, self.device) for a in (sigs, seqs, maps, lens)
        )
        # (B, 4K, W): the convs' native layout on the GPU, so the towers
        # take their inputs without a relayout (the TPU path prefers
        # channels-last)
        enc = compute_encoded_kmer_batch(
            bb, ab, seqs, maps, lens, self.metadata["chunk_len"],
            out_dtype=cd,
        )
        if cd is not None:
            sigs = sigs.to(cd)
        with full_f32():
            return self.model(sigs, enc).float()

    @classmethod
    def load(cls, path, device=None, compute_dtype=None):
        device = resolve_device(device)
        model, meta = model_io.load_model(path)
        return cls(model.to(device), meta, compute_dtype=compute_dtype)
