"""Duplex modified-base calling.

Port of ``remora_tpu/infer/duplex_infer.py`` (reference analog
``src/remora/inference.py:656–1014``): per-strand simplex calls
re-anchored onto the duplex basecall via the host pairwise aligner,
emitted as strand-aware (+/-) MM/ML tags on the duplex BAM records.

Each strand is called through ``ModelHandle.eval_fn`` (host-featurized
batches, padded to power-of-two buckets by ``RemoraRead.run_model``), so
the model's forward, K1 included, runs on the handle's device: the GPU
unless the handle was loaded with ``device="cpu"``.

CUDA stays in the parent process, as in ``infer/infer.py``: the pair
builder and the duplex-read builder are forked process stages that run
host code only, and the calls (the forward and, with a refiner on the
device backend, K4/K5 one read at a time) run in the parent's InferMods
threads.
"""

import sys
from collections import Counter
from copy import copy
from itertools import chain, islice

import numpy as np

from remora_tpu_torch import RemoraError, constants, log
from remora_tpu_torch.core.pipeline import map_stage
from remora_tpu_torch.core.seq import Motif, revcomp
from remora_tpu_torch.core.tags import format_mm_ml_tags, softmax
from remora_tpu_torch.io.bam import BamWriter, FastBamScanner
from remora_tpu_torch.io.duplex import DuplexPairsBuilder, DuplexRead
from remora_tpu_torch.io.read_index import ReadIndexedBam
from remora_tpu_torch.infer.infer import ModelHandle

LOGGER = log.get_logger()


def call_read_mods(
    read,
    eval_fn,
    model_metadata,
    *,
    focus_offset=None,
    batch_size=constants.DEFAULT_BATCH_SIZE,
    return_mod_probs=False,
    return_mm_ml_tags=False,
):
    """Call modified bases on a RemoraRead (public API entry).

    Args:
        read: data.read.RemoraRead
        eval_fn: callable (sigs, enc_kmers) -> logits
        model_metadata: loaded model metadata dict
        focus_offset: call only this base (default: model motif hits)

    Returns (nn_out, labels, positions) by default; with
    ``return_mod_probs`` the first element is per-mod probabilities; with
    ``return_mm_ml_tags`` the formatted (MM, ML) pair instead.
    """
    if focus_offset is None:
        site_motifs = [Motif(*m) for m in model_metadata["motifs"]]
        read.set_motif_focus_bases(site_motifs)
    else:
        read.focus_bases = np.array([focus_offset])
    read.prepare_batches(model_metadata, batch_size)
    if not read.batches:
        empty = np.array([])
        return empty, empty, empty
    nn_out, labels, pos = read.run_model(eval_fn)
    if not (return_mod_probs or return_mm_ml_tags):
        return nn_out, labels, pos
    mod_probs = softmax(nn_out)[:, 1:].astype("float64")
    if not return_mm_ml_tags:
        return mod_probs, labels, pos
    return format_mm_ml_tags(
        seq=read.str_seq,
        probs=mod_probs,
        poss=pos,
        can_base=model_metadata["can_base"],
        mod_bases=model_metadata["mod_bases"],
    )


class DuplexReadModCaller:
    """Calls each simplex strand, then maps both onto duplex coordinates."""

    def __init__(self, eval_fn, model_metadata):
        self.eval_fn = eval_fn
        self.model_metadata = model_metadata

    def _strand_mod_probs(self, simplex_read, ref_start):
        """Mod probabilities + duplex-reference positions for one strand."""
        remora_read = simplex_read.into_remora_read(False)
        mod_probs, _, positions = call_read_mods(
            read=remora_read,
            eval_fn=self.eval_fn,
            model_metadata=self.model_metadata,
            return_mod_probs=True,
        )
        return mod_probs, positions + ref_start

    def call_duplex_read_mod_probs(self, duplex_read: DuplexRead):
        t_probs, t_pos = self._strand_mod_probs(
            duplex_read.template_read, duplex_read.template_ref_start
        )
        c_probs, c_pos = self._strand_mod_probs(
            duplex_read.complement_read, duplex_read.complement_ref_start
        )
        seq = duplex_read.duplex_basecalled_sequence
        if duplex_read.is_reverse_mapped:
            # mapping flips the duplex: the template calls land on the
            # second (complement) strand of the oriented sequence
            seq = revcomp(seq)
            (t_probs, t_pos), (c_probs, c_pos) = (
                (c_probs, c_pos),
                (t_probs, t_pos),
            )
        return {
            "template_probs": t_probs,
            "template_positions": t_pos,
            "complement_probs": c_probs,
            "complement_positions": len(seq) - c_pos - 1,
            "read_sequence": seq,
        }

    def call_duplex_read_mods(self, duplex_read: DuplexRead):
        dp = self.call_duplex_read_mod_probs(duplex_read)
        shared = dict(mod_bases=self.model_metadata["mod_bases"])
        fwd_mm, fwd_ml = format_mm_ml_tags(
            strand="+",
            seq=dp["read_sequence"],
            probs=dp["template_probs"],
            poss=dp["template_positions"],
            can_base=self.model_metadata["can_base"],
            **shared,
        )
        rev_mm, rev_ml = format_mm_ml_tags(
            strand="-",
            seq=dp["read_sequence"],
            probs=dp["complement_probs"],
            poss=dp["complement_positions"],
            can_base=revcomp(self.model_metadata["can_base"]),
            **shared,
        )
        return fwd_mm + rev_mm, fwd_ml + rev_ml


class DelimIdConverter:
    """Picklable read-id converter (duplex ids are 'tid;cid')."""

    def __init__(self, delim):
        self.delim = delim

    def __call__(self, read_id):
        return read_id.split(self.delim)[0]


def check_simplex_alignments(*, simplex_index, duplex_index, id_pairs):
    """Filter pairs to those fully resolvable in both BAMs."""
    if not id_pairs:
        raise ValueError("no pairs found in file")
    simplex_ids = set(simplex_index.read_ids)
    duplex_ids = set(duplex_index.read_ids)
    if not simplex_ids.intersection(chain(*id_pairs)):
        raise ValueError("zero simplex alignments found")
    usable = [
        (tmpl, comp)
        for tmpl, comp in id_pairs
        if tmpl in simplex_ids
        and comp in simplex_ids
        and tmpl in duplex_ids
    ]
    LOGGER.debug(
        f"{len(usable)}/{len(id_pairs)} pairs resolvable in both BAMs"
    )
    return usable, len(usable)


def prep_duplex_read_builder(simplex_index, pod5_path):
    # one pairs-builder per worker process (holds open file handles)
    return [DuplexPairsBuilder(simplex_index, pod5_path)], {}


def iter_duplexed_io_reads(read_id_pair, pairs_builder):
    return pairs_builder.make_read_pair(read_id_pair)


def make_duplex_reads(pair_result, duplex_index):
    simplex_pair, err = pair_result
    if err is not None or simplex_pair is None:
        return simplex_pair, err
    template, complement = simplex_pair
    no_rec = "duplex BAM record not found for read_id"
    if template.read_id not in duplex_index:
        return simplex_pair, no_rec
    bam_record = next(duplex_index.get_alignments(template.read_id), None)
    if bam_record is None:
        return simplex_pair, no_rec
    return (
        DuplexRead.from_reads_and_alignment(
            duplex_alignment=bam_record,
            template_read=template,
            complement_read=complement,
        ),
        None,
    )


def add_mod_mappings_to_alignment(duplex_result, caller):
    duplex_read, err = duplex_result
    if err is not None:
        return None, err
    mm, ml = caller.call_duplex_read_mods(duplex_read)
    record = copy(duplex_read.duplex_alignment)
    record.drop_tags({"MM", "ML"})
    record.set_tag("MM", "Z", mm)
    record.set_tag("ML", "BC", np.frombuffer(ml.tobytes(), dtype=np.uint8))
    return record, None


def _open_indexed_bam(path, what, **kwargs):
    LOGGER.info(f"Indexing {what} BAM")
    index = ReadIndexedBam(path, **kwargs)
    if index.num_records == 0:
        LOGGER.info(f"No records found in {what} BAM file.")
        sys.exit()
    return index


def _resolve_refiner(model_metadata, refine_backend, device):
    """Set the model's refiner (if any) to ``refine_backend`` on the
    handle's device; ``None`` or ``auto`` resolves as the simplex driver
    does, by an in-process probe of ``device``."""
    smr = model_metadata.get("sig_map_refiner")
    if refine_backend in (None, constants.REFINE_BACKEND_AUTO):
        from remora_tpu_torch.refine.autoselect import (
            probe_device_roundtrip_inprocess,
            resolve_auto_backend,
        )

        refine_backend = resolve_auto_backend(
            smr, probe=lambda: probe_device_roundtrip_inprocess(device))
    if smr is not None:
        smr.backend = refine_backend
        # the device DP runs where the model runs
        smr.device = device


def infer_duplex(
    *,
    simplex_pod5_path,
    simplex_bam_path,
    duplex_bam_path,
    pairs_path,
    models,
    out_bam,
    num_reads=None,
    num_extract_alignment_threads=1,
    num_duplex_prep_workers=1,
    num_infer_threads=1,
    duplex_deliminator=";",
    skip_non_primary=True,
    refine_backend=None,
):
    """Stream duplex reads through per-strand calling into a modBAM.

    Args:
        models: list of ModelHandle; duplex supports one model, and calls
            it on the handle's device.
        refine_backend: override the banded-DP backend of the model's
            metadata-embedded refiner (auto/native/numpy/device); None
            resolves ``auto`` by probing the handle's device, as
            ``infer_from_pod5_and_bam`` does. ``device`` runs K4/K5 on
            the handle's device, one strand read a call.

    Raises RemoraError after draining when a pair's call raised (the
    JAX driver drops such a pair silently).
    """
    for mdl in models:
        if not isinstance(mdl, ModelHandle):
            raise RemoraError(
                f"models must be ModelHandles, not {type(mdl).__name__}")
    first = models[0]
    eval_fn, model_metadata = first.eval_fn, first.metadata
    # the handle's device, resolved here in the main thread before any
    # stage starts (a GPU's carries its index, so a device refiner stays
    # on this one card)
    _resolve_refiner(model_metadata, refine_backend, first.device)
    duplex_bam_index = _open_indexed_bam(
        duplex_bam_path,
        "Duplex",
        skip_non_primary=skip_non_primary,
        req_tags=set(),
        read_id_converter=DelimIdConverter(duplex_deliminator),
    )
    simplex_bam_index = _open_indexed_bam(
        simplex_bam_path, "Simplex", skip_non_primary=True, req_tags={"mv"}
    )
    with open(pairs_path) as fh:
        listed = [tuple(ln.split()) for ln in fh if ln.strip()]
    valid_pairs, num_valid = check_simplex_alignments(
        duplex_index=duplex_bam_index,
        simplex_index=simplex_bam_index,
        id_pairs=listed,
    )
    num_reads = num_valid if num_reads is None else min(num_valid, num_reads)

    io_read_pairs = map_stage(
        iter_duplexed_io_reads,
        islice(valid_pairs, num_reads),
        name="BuildDuplexedIoReads",
        use_process=True,
        num_workers=num_extract_alignment_threads,
        q_maxsize=100,
        prep_func=prep_duplex_read_builder,
        args=(simplex_bam_index, simplex_pod5_path),
    )
    duplex_reads = map_stage(
        make_duplex_reads,
        io_read_pairs,
        name="MakeDuplexReads",
        use_process=True,
        num_workers=num_duplex_prep_workers,
        q_maxsize=100,
        args=(duplex_bam_index,),
    )
    caller = DuplexReadModCaller(eval_fn, model_metadata)
    records = map_stage(
        add_mod_mappings_to_alignment,
        duplex_reads,
        name="InferMods",
        use_process=False,
        use_mp_queue=False,
        num_workers=num_infer_threads,
        q_maxsize=100,
        args=(caller,),
    )

    skips = Counter()
    in_bam = FastBamScanner(duplex_bam_path)
    n_written = 0
    with BamWriter(out_bam, in_bam.header) as out:
        for record, err in records:
            if err is not None:
                skips[err] += 1
            else:
                out.write(record)
                n_written += 1
    if skips:
        lines = [
            f"{count:>7} : {reason:<80}"
            for reason, count in skips.most_common()
        ]
        LOGGER.info("Unsuccessful read reasons:\n" + "\n".join(lines))
    if records.errors:
        # a call raised (a kernel that failed to build or launch, the
        # card out of memory): its pair is gone, so the BAM would be short
        raise RemoraError(
            f"InferMods failed on {len(records.errors)} pair(s) after "
            f"{n_written} duplex records were written: "
            f"{records.errors[0]!r}"
        ) from records.errors[0]
    LOGGER.info(f"Wrote {n_written} duplex records")
    return n_written
