"""Dataset preparation driver: POD5 + BAM -> chunk dataset.

Port of ``remora_tpu/prepare.py`` (reference analog
``src/remora/prepare_train_data.py``). Host pipeline stages (signal
decode, alignment join, chunk extraction) run as process-parallel stages
over bounded queues; the main process owns the memory-mapped output
store and flushes it periodically for crash tolerance.

With a refiner on the device backend, chunk extraction is one in-process
stage over read micro-batches (``extract_chunks_batched``) whose banded
DP runs as K4/K5 on the refiner's device: the GPU its ``device`` names,
or every visible GPU for ``device=None`` (``refine/refiner.py::
_refine_dp_devices``; the card's machine has one). Every CUDA call stays
in the parent process: the forked stages (signal decode, alignment
join, and chunk extraction with a host refiner) run NumPy and host code
only, and the refiner ships to them holding a ``torch.device``, never a
tensor.
"""

import os
import sys
from collections import Counter
from dataclasses import dataclass
from typing import Optional

import numpy as np

from remora_tpu_torch import RemoraError, constants, log
from remora_tpu_torch.core import coords
from remora_tpu_torch.core.pipeline import (
    batch_map_stage,
    map_stage,
    source_stage,
)
from remora_tpu_torch.data.chunk_batch import extract_chunks_batch
from remora_tpu_torch.data.dataset import CoreDataset
from remora_tpu_torch.data.metadata import DatasetMetadata
from remora_tpu_torch.data.read import RemoraRead
from remora_tpu_torch.io.pod5 import DatasetReader
from remora_tpu_torch.io.read import extract_alignments, iter_signal
from remora_tpu_torch.io.read_index import ReadIndexedBam, get_read_ids

LOGGER = log.get_logger()

READ_ID_DTYPE = "<U36"


@dataclass(frozen=True)
class ChunkExtractParams:
    """Everything the chunk-extraction worker stage needs, in one
    picklable bundle (ships once to each worker process)."""

    int_label: int
    motifs: list
    focus_ref_pos: Optional[dict]
    sig_map_refiner: object
    max_chunks_per_read: int
    chunk_context: tuple
    kmer_context_bases: tuple
    base_start_justify: bool
    offset: int
    basecall_anchor: bool
    max_seq_len: int


def _ref_anchored_training_read(io_read, int_label):
    """RemoraRead over the aligned reference sequence, labels filled in.

    Uses DAC->norm scaling (training convention; the inference path may
    instead use zero-centered pA scaling via ``Read.into_remora_read``).
    """
    ref_map = coords.compute_ref_to_signal(
        io_read.query_to_signal, io_read.cigar
    )
    io_read.ref_to_signal = ref_map
    n_ref_bases = len(io_read.ref_seq)
    assert ref_map.size == n_ref_bases + 1
    sig_lo = ref_map[0]
    label_row = np.full(n_ref_bases, int_label, dtype=int)
    return RemoraRead(
        dacs=io_read.dacs[sig_lo : ref_map[-1]],
        seq_to_sig_map=ref_map - sig_lo,
        shift=io_read.shift_dacs_to_norm,
        scale=io_read.scale_dacs_to_norm,
        str_seq=io_read.ref_seq,
        labels=label_row,
        read_id=io_read.read_id,
    )


def _training_read(io_read, params):
    """Build the labeled RemoraRead and select its focus bases."""
    if params.basecall_anchor:
        t_read = io_read.into_remora_read(use_reference_anchor=False)
        t_read.labels = np.full(
            len(io_read.seq), params.int_label, dtype=int
        )
        t_read.focus_bases = io_read.get_basecall_anchored_focus_bases(
            select_focus_reference_positions=params.focus_ref_pos,
            motifs=params.motifs,
        )
        return t_read
    t_read = _ref_anchored_training_read(io_read, params.int_label)
    if params.focus_ref_pos is not None:
        t_read.focus_bases = io_read.get_filtered_focus_positions(
            params.focus_ref_pos
        )
    else:
        t_read.set_motif_focus_bases(params.motifs)
    return t_read


def _alignment_training_read(io_read, err, params):
    """(t_read, err) for one alignment — everything before refinement."""
    if err is not None:
        return None, err
    if io_read.ref_seq is None:
        return None, "No reference sequence (missing MD tag)"
    return _training_read(io_read, params), None


def _alignment_chunks(t_read, io_read, align_idx, params):
    """Post-refinement tail: downsample, check, vectorized extraction.

    Returns ``((arrays, n_long), err)`` or None to silently drop the
    alignment (failed read check).
    """
    t_read.downsample_focus_bases(params.max_chunks_per_read)
    try:
        t_read.check()
    except RemoraError as e:
        LOGGER.debug(f"training-read build rejected: {e}")
        return None
    res = extract_chunks_batch(
        t_read,
        params.chunk_context,
        params.kmer_context_bases,
        params.max_seq_len,
        base_start_justify=params.base_start_justify,
        offset=params.offset,
        motifs=params.motifs,
        check_chunks=True,
    )
    if res is None:
        return (None, 0), None
    arrays, n_long = res
    n = arrays["sequence_lengths"].size
    arrays["read_ids"] = np.full(n, io_read.read_id, READ_ID_DTYPE)
    LOGGER.debug(f"alignment {align_idx} of {io_read.read_id}: {n} chunks")
    return (arrays, n_long), None


def extract_chunks(read_errs, params):
    """Dataset-format chunk arrays for every alignment of one read.

    Returns a list of ``((arrays, n_long), err)`` per alignment, where
    ``arrays`` is the vectorized whole-read extraction
    (`data.chunk_batch.extract_chunks_batch`) and ``n_long`` counts
    chunks dropped for exceeding ``max_seq_len`` (the driver's
    "Sequence too long" tally). Behaviorally identical to the per-chunk
    ``iter_chunks`` loop (parity-tested) without per-chunk Python.
    """
    per_alignment = []
    for align_idx, (io_read, err) in enumerate(read_errs):
        t_read, err = _alignment_training_read(io_read, err, params)
        if err is not None:
            per_alignment.append((None, err))
            continue
        t_read.refine_signal_mapping(params.sig_map_refiner)
        out = _alignment_chunks(t_read, io_read, align_idx, params)
        if out is not None:
            per_alignment.append(out)
    return per_alignment


def _drop_read(failed, slot, io_read, err):
    """Drop every alignment of the read in ``slot``, as the pipeline's
    per-item guard drops a read whose ``extract_chunks`` raises."""
    LOGGER.debug(
        f"PIPELINE_ITEM_ERROR in ExtractChunks ({io_read.read_id}): "
        f"'{err}'"
    )
    failed.add(slot)


def extract_chunks_batched(batch_read_errs, params):
    """``extract_chunks`` over a micro-batch of reads, with every
    alignment's banded-DP refinement sharing single device launches
    (``SigMapRefiner.refine_reads_batch``, refine backend=device).

    Returns one ``extract_chunks``-shaped output list per read (the
    batch_map_stage worker re-flattens them). Per-read refine failures
    drop that alignment, matching the per-item pipeline guard on the
    single-read path. A read whose host-side work raises (say, an
    alignment without a move table) is dropped alone, as the per-item
    guard drops it on the single-read path; the JAX package's batched
    path loses the whole micro-batch there. An exception out of the
    device refinement itself propagates (the driver raises).
    """
    outputs = [[] for _ in batch_read_errs]
    failed = set()
    built = []  # (read_slot, align_idx, io_read, t_read)
    for slot, read_errs in enumerate(batch_read_errs):
        read_built = []
        for align_idx, (io_read, err) in enumerate(read_errs):
            try:
                t_read, err = _alignment_training_read(io_read, err, params)
            except Exception as e:  # noqa: BLE001 — per-read guard
                _drop_read(failed, slot, io_read, e)
                break
            if err is not None:
                outputs[slot].append((None, err))
                continue
            read_built.append((slot, align_idx, io_read, t_read))
        if slot not in failed:
            built.extend(read_built)
    refine_errs = params.sig_map_refiner.refine_reads_batch(
        [t_read for *_fields, t_read in built]
    )
    for (slot, align_idx, io_read, t_read), rerr in zip(built, refine_errs):
        if slot in failed:
            continue
        if rerr is not None:
            LOGGER.debug(
                f"PIPELINE_ITEM_ERROR in ExtractChunks (batched refine, "
                f"{io_read.read_id}): '{rerr}'"
            )
            continue
        try:
            out = _alignment_chunks(t_read, io_read, align_idx, params)
        except Exception as e:  # noqa: BLE001 — per-read guard
            _drop_read(failed, slot, io_read, e)
            continue
        if out is not None:
            outputs[slot].append(out)
    return [out for slot, out in enumerate(outputs) if slot not in failed]


def _new_output_dataset(out_path, num_reads, params, *, mod_base,
                        mod_base_control, rev_sig, pa_scaling):
    if mod_base_control:
        mod_codes, mod_names = [], []
    else:
        mod_codes, mod_names = [mod_base[0]], [mod_base[1]]
    meta = DatasetMetadata(
        allocate_size=num_reads * params.max_chunks_per_read,
        mod_bases=mod_codes,
        mod_long_names=mod_names,
        max_seq_len=params.max_seq_len,
        motif_sequences=[m.raw_motif for m in params.motifs],
        motif_offsets=[m.focus_pos for m in params.motifs],
        extra_arrays={
            "read_ids": (READ_ID_DTYPE, "UUID of the source read"),
            "read_focus_bases": (
                "int64",
                "Focus base index within the training sequence",
            ),
        },
        kmer_context_bases=params.kmer_context_bases,
        chunk_context=params.chunk_context,
        reverse_signal=rev_sig,
        pa_scaling=pa_scaling,
        sig_map_refiner=params.sig_map_refiner,
        base_start_justify=params.base_start_justify,
        offset=params.offset,
    )
    return CoreDataset(data_path=str(out_path), mode="w", metadata=meta)


def _log_skip_tally(skips):
    if not skips:
        return
    lines = [
        f"{count:>7,} : {reason:<80}"
        for reason, count in skips.most_common()
    ]
    LOGGER.info("Unsuccessful read/chunk reasons:\n" + "\n".join(lines))


def _build_stages(pod5_path, bam_idx, read_ids, num_reads, params, *,
                  rev_sig, pa_scaling, n_align_workers, n_chunk_workers):
    """Wire the three host pipeline stages and return the chunk stream."""
    signals = source_stage(
        iter_signal,
        args=(pod5_path,),
        kwargs=dict(
            read_ids=read_ids,
            num_reads=num_reads,
            pa_scaling=pa_scaling,
            rev_sig=rev_sig,
        ),
        use_process=True,
        q_maxsize=1000,
        name="ExtractSignal",
    )
    reads = map_stage(
        extract_alignments,
        signals,
        args=(bam_idx, rev_sig),
        num_workers=n_align_workers,
        use_process=True,
        q_maxsize=1000,
        name="AddAlignments",
    )
    smr = params.sig_map_refiner
    if smr is not None and smr.backend == constants.REFINE_BACKEND_DEVICE:
        # the device DP stage must own the (single) accelerator, so it
        # runs one in-process worker over read micro-batches — batching
        # across reads is what amortizes kernel launches/transfers
        return batch_map_stage(
            extract_chunks_batched,
            reads,
            constants.REFINE_DEVICE_READ_BATCH,
            args=(params,),
            q_maxsize=1000,
            name="ExtractChunks",
        )
    return map_stage(
        extract_chunks,
        reads,
        args=(params,),
        num_workers=n_chunk_workers,
        use_process=True,
        q_maxsize=1000,
        name="ExtractChunks",
    )


def _checkpoint(dataset):
    dataset.flush()
    dataset.write_metadata()


def extract_chunk_dataset(
    bam_path,
    pod5_path,
    out_path,
    mod_base,
    mod_base_control,
    motifs,
    focus_ref_pos,
    chunk_context,
    min_samps_per_base,
    max_chunks_per_read,
    pa_scaling,
    sig_map_refiner,
    kmer_context_bases,
    base_start_justify,
    offset,
    num_reads,
    *,
    num_extract_alignment_workers=1,
    num_extract_chunks_workers=1,
    skip_shuffle=False,
    save_every=100_000,
    rev_sig=False,
    basecall_anchor=False,
    skip_non_primary=True,
):
    bam_idx = ReadIndexedBam(bam_path, skip_non_primary)
    if bam_idx.num_records == 0:
        LOGGER.info("No records found in BAM file.")
        sys.exit()
    with DatasetReader(pod5_path) as pod5_dr:
        read_ids, num_reads = get_read_ids(
            bam_idx, pod5_dr, num_reads, return_num_bam_reads=True
        )
    if num_reads == 0:
        return

    anchor_kind = "basecall" if basecall_anchor else "reference"
    LOGGER.info(f"Making {anchor_kind}-anchored training data")
    if (
        sig_map_refiner is not None
        and sig_map_refiner.backend == constants.REFINE_BACKEND_AUTO
    ):
        # probe the device link once: 'auto' routes the banded DP to the
        # batched K4/K5 path on a co-located GPU, host otherwise
        from remora_tpu_torch.refine.autoselect import resolve_auto_backend

        sig_map_refiner.backend = resolve_auto_backend(sig_map_refiner)
    params = ChunkExtractParams(
        int_label=0 if mod_base_control else 1,
        motifs=motifs,
        focus_ref_pos=focus_ref_pos,
        sig_map_refiner=sig_map_refiner,
        max_chunks_per_read=max_chunks_per_read,
        chunk_context=chunk_context,
        kmer_context_bases=kmer_context_bases,
        base_start_justify=base_start_justify,
        offset=offset,
        basecall_anchor=basecall_anchor,
        max_seq_len=sum(chunk_context) // min_samps_per_base,
    )
    dataset = _new_output_dataset(
        out_path,
        num_reads,
        params,
        mod_base=mod_base,
        mod_base_control=mod_base_control,
        rev_sig=rev_sig,
        pa_scaling=pa_scaling,
    )

    LOGGER.info("Processing reads")
    chunks = _build_stages(
        pod5_path,
        bam_idx,
        read_ids,
        num_reads,
        params,
        rev_sig=rev_sig,
        pa_scaling=pa_scaling,
        n_align_workers=num_extract_alignment_workers,
        n_chunk_workers=num_extract_chunks_workers,
    )

    from tqdm import tqdm

    skips = Counter()
    pbar = tqdm(
        desc="Extracting chunks",
        total=len(read_ids),
        unit=" Reads",
        smoothing=0,
        disable=bool(os.environ.get("LOG_SAFE")),
    )
    last_save = 0
    for read_chunks in chunks:
        pbar.update()
        if not read_chunks:
            skips["No chunks extracted"] += 1
            continue
        for align_res, err in read_chunks:
            if align_res is None:
                skips[err] += 1
                continue
            arrays, n_long = align_res
            if n_long:
                skips["Sequence too long"] += n_long
            if arrays is None:
                continue
            try:
                dataset.write_batch(arrays)
            except RemoraError as e:
                skips[str(e)] += 1
                continue
            # crash tolerance: persist arrays + metadata periodically
            if dataset.size - last_save >= save_every:
                _checkpoint(dataset)
                last_save = dataset.size

    pbar.close()
    _log_skip_tally(skips)
    stage_errors = getattr(chunks, "errors", None)
    if stage_errors:
        # the device refinement raised (a kernel that failed to build or
        # launch): its batch is gone, so the dataset would be short
        raise RemoraError(
            f"ExtractChunks device stage failed after {dataset.size:,} "
            f"chunks were written: {stage_errors[0]!r}"
        ) from stage_errors[0]
    dataset.write_metadata()
    LOGGER.info(
        f"Extracted {dataset.size:,} chunks from {num_reads:,} reads."
    )
    LOGGER.info(f"Label distribution: {dataset.label_summary}")
    if not skip_shuffle:
        LOGGER.info("Shuffling dataset")
        dataset.shuffle()
    dataset.flush()
    return dataset
