"""Training/inference read container and chunk extraction (copy of
``remora_tpu/data/read.py``). ``prepare_batches`` and ``run_model`` are
the per-read inference path that duplex calling takes
(``infer/duplex_infer.py``); ``run_model`` brings each batch's logits to
the host once, wherever the model runs.

Reference analogs: ``RemoraRead`` (``src/remora/data_chunks.py:126–540``)
and ``Chunk`` (``:543–641``). Semantics (edge padding, searchsorted
boundary selection, center-of-focus-base chunk anchoring) are preserved
exactly so that golden chunk counts and tensors match.
"""

from dataclasses import dataclass
from functools import cached_property
from typing import Optional

import numpy as np

from remora_tpu_torch import RemoraError, log
from remora_tpu_torch.core import seq as sequtil

LOGGER = log.get_logger()


def _paste_clipped(dest, src, src_lo, src_hi):
    """Copy ``src[src_lo:src_hi]`` into ``dest``, clipping out-of-range
    source indices and leaving the corresponding dest edges untouched.

    Returns (left_pad, right_pad): the number of dest positions skipped
    on each side.
    """
    left_pad = max(-src_lo, 0)
    right_pad = max(src_hi - src.size, 0)
    dest[left_pad : dest.size - right_pad] = src[
        src_lo + left_pad : src_hi - right_pad
    ]
    return left_pad, right_pad


@dataclass
class Chunk:
    """One fixed-width training/inference unit.

    Attributes:
        signal: normalized signal, length = sum(chunk_context)
        seq_w_context: int8 sequence including k-mer context bases (-1 pad)
        seq_to_sig_map: int32, len = central seq len + 1, chunk-relative
        kmer_context_bases: (before, after)
        chunk_sig_focus_idx: focus position within chunk signal
        chunk_focus_base: focus base within central chunk sequence
        read_focus_base: focus position within the full read
    """

    signal: np.ndarray
    seq_w_context: np.ndarray
    seq_to_sig_map: np.ndarray
    kmer_context_bases: "tuple"
    chunk_sig_focus_idx: "int"
    chunk_focus_base: "int"
    read_focus_base: "int"
    label: Optional["int"] = None
    read_id: Optional["str"] = None

    def mask_focus_base(self):
        focus_idx = self.chunk_focus_base + self.kmer_context_bases[0]
        self.seq_w_context[focus_idx] = -1

    @property
    def kmer_len(self):
        kb, ka = self.kmer_context_bases
        return kb + ka + 1

    @property
    def seq_len(self):
        kb, ka = self.kmer_context_bases
        return self.seq_w_context.size - kb - ka

    @property
    def seq(self):
        lo = self.kmer_context_bases[0]
        hi = lo + self.seq_len
        return self.seq_w_context[lo:hi]

    @property
    def base_sig_lens(self):
        return np.diff(self.seq_to_sig_map)

    def check(self):
        if not self.signal.size:
            raise RemoraError("chunk has no signal")
        if np.isnan(self.signal).any():
            raise RemoraError("chunk signal contains NaN")
        smap = self.seq_to_sig_map
        if smap.size != self.seq_len + 1:
            raise RemoraError("chunk mapping length != seq length + 1")
        if (self.base_sig_lens < 0).any():
            LOGGER.debug(
                f"FAILED_CHUNK: non-monotonic map in {self.read_id} "
                f"{smap}"
            )
        if smap[0] < 0:
            raise RemoraError("chunk mapping enters negative signal")
        if smap[-1] > self.signal.size:
            raise RemoraError("chunk mapping runs past the signal")


@dataclass
class RemoraRead:
    """Signal + sequence + mapping for one read.

    Args:
        dacs: unnormalized DAC signal (already reversed for
            reverse-signal chemistries)
        shift/scale: normalization via norm = (dac - shift) / scale
        seq_to_sig_map: signal index per base (+ terminator)
        int_seq / str_seq: encoded / string sequence (one required)
        labels: per-base training label
        focus_bases: positions to extract chunks at
    """

    dacs: np.ndarray
    shift: "float"
    scale: "float"
    seq_to_sig_map: np.ndarray
    int_seq: Optional[np.ndarray] = None
    str_seq: Optional["str"] = None
    labels: Optional[np.ndarray] = None
    read_id: Optional["str"] = None
    focus_bases: Optional[np.ndarray] = None
    batches: Optional[list] = None

    _LAZY = ("sig", "sig_cumsum", "dwells", "base_levels")

    def __post_init__(self):
        if self.int_seq is not None:
            self.str_seq = sequtil.int_to_seq(self.int_seq)
        elif self.str_seq is not None:
            self.int_seq = sequtil.seq_to_int(self.str_seq)
        else:
            raise RemoraError("Must provide sequence to initialize RemoraRead")

    def _reset_cache(self):
        for name in self._LAZY:
            self.__dict__.pop(name, None)

    @classmethod
    def test_read(cls, nbases=20, *, signal_per_base=10):
        """Uniform spoof read (reference test double, data_chunks.py:179)."""
        n_sig = nbases * signal_per_base
        return cls(
            dacs=np.zeros(n_sig),
            shift=0.0,
            scale=1.0,
            seq_to_sig_map=np.arange(0, n_sig + 1, signal_per_base),
            int_seq=np.arange(nbases) % 4,
            labels=np.zeros(nbases, dtype=np.int64),
            read_id="test_read",
        )

    # --- lazily derived signal views (cleared by _reset_cache) ---
    @cached_property
    def sig(self):
        norm = (self.dacs - self.shift) / self.scale
        return norm.astype(np.float32)

    @cached_property
    def sig_cumsum(self):
        cs = np.zeros(self.sig.size + 1)
        np.cumsum(self.sig, out=cs[1:])
        return cs

    @cached_property
    def dwells(self):
        return np.diff(self.seq_to_sig_map)

    @cached_property
    def base_levels(self):
        sums_per_base = np.diff(self.sig_cumsum[self.seq_to_sig_map])
        with np.errstate(invalid="ignore"):
            return sums_per_base / self.dwells

    def check(self):
        smap, nbases = self.seq_to_sig_map, self.int_seq.size
        if smap.size != nbases + 1:
            raise RemoraError(
                f"Invalid read: mapping size ({smap.size}) "
                f"must be sequence size ({nbases}) + 1"
            )
        if smap[0] != 0:
            raise RemoraError("Invalid read: mapping start")
        if smap[-1] != self.sig.size:
            raise RemoraError("Invalid read: mapping end")
        if nbases and not (-1 <= self.int_seq.min()
                           and self.int_seq.max() <= 3):
            raise RemoraError("Invalid read: Invalid base")

    def copy(self):
        def dup(arr):
            return None if arr is None else arr.copy()

        fields = dict(
            seq_to_sig_map=self.seq_to_sig_map,
            dacs=self.dacs.copy(),
            int_seq=dup(self.int_seq),
            str_seq=self.str_seq,
            labels=dup(self.labels),
            focus_bases=dup(self.focus_bases),
            read_id=self.read_id,
        )
        return RemoraRead(shift=self.shift, scale=self.scale, **fields)

    def refine_signal_mapping(self, sig_map_refiner, check_read=False):
        """Apply rough rescale and/or banded-DP mapping refinement."""
        # refiners may be absent (no levels) -> no-op
        if sig_map_refiner is None or not sig_map_refiner.is_loaded:
            return
        if sig_map_refiner.do_rough_rescale:
            self.shift, self.scale = sig_map_refiner.rough_rescale(
                dacs=self.dacs,
                int_seq=self.int_seq,
                seq_to_sig_map=self.seq_to_sig_map,
                shift=self.shift,
                scale=self.scale,
            )
            self._reset_cache()
        if sig_map_refiner.scale_iters >= 0:
            before = f"shift={self.shift} scale={self.scale}"
            try:
                refined = sig_map_refiner.refine_sig_map(
                    dacs=self.dacs,
                    int_seq=self.int_seq,
                    seq_to_sig_map=self.seq_to_sig_map,
                    shift=self.shift,
                    scale=self.scale,
                )
                self.seq_to_sig_map, self.shift, self.scale = refined
            except IndexError as e:
                LOGGER.debug(f"DP refinement IndexError "
                             f"({self.read_id}): {e}")
            self._reset_cache()
            LOGGER.debug(
                f"DP-refined scaling: {before} -> "
                f"shift={self.shift} scale={self.scale}"
            )
        if check_read:
            self.check()

    def set_motif_focus_bases(self, motifs):
        hits = sequtil.find_focus_bases(self.int_seq, motifs)
        self.focus_bases = hits

    def downsample_focus_bases(self, max_sites):
        sites = self.focus_bases
        if sites is None or sites.size <= max_sites:
            return
        LOGGER.debug(
            f"{self.read_id}: keeping {max_sites} of "
            f"{sites.size} focus bases"
        )
        self.focus_bases = np.random.choice(sites, max_sites, False)

    def _chunk_signal(self, sig_lo, sig_hi, signal_padding):
        """Chunk signal window with zero (or mirrored) edge padding."""
        if sig_lo >= 0 and sig_hi <= self.sig.size:
            return self.sig[sig_lo:sig_hi].copy(), 0
        window = np.zeros(sig_hi - sig_lo, dtype=np.float32)
        left_pad, right_pad = _paste_clipped(window, self.sig, sig_lo, sig_hi)
        if signal_padding:
            # mirror the read edges instead of zero fill
            if left_pad:
                window[:left_pad] = self.sig[left_pad:0:-1]
            if right_pad:
                n = self.sig.size
                window[window.size - right_pad :] = self.sig[
                    n : n - right_pad - 1 : -1
                ]
        return window, left_pad

    def _chunk_sequence(self, seq_lo, seq_hi, kmer_context_bases):
        """Sequence window incl. k-mer context, -1 padded at read edges."""
        kb, ka = kmer_context_bases
        if seq_lo >= kb and seq_hi + ka <= self.int_seq.size:
            # in-range: return a view (mask_focus_base mutates through it,
            # matching reference behavior)
            return self.int_seq[seq_lo - kb : seq_hi + ka]
        window = np.full(seq_hi - seq_lo + kb + ka, -1, dtype=np.int8)
        _paste_clipped(window, self.int_seq, seq_lo - kb, seq_hi + ka)
        return window

    def extract_chunk(
        self,
        focus_sig_idx,
        chunk_context,
        kmer_context_bases,
        *,
        signal_padding=False,
        check_chunk=False,
        read_focus_base=-1,
        label=-1,
    ):
        """Extract one fixed-width chunk centered at a signal position."""
        chunk_len = sum(chunk_context)
        sig_lo = focus_sig_idx - chunk_context[0]
        sig_hi = focus_sig_idx + chunk_context[1]
        chunk_sig, left_pad = self._chunk_signal(sig_lo, sig_hi, signal_padding)
        clipped_lo = max(sig_lo, 0)
        clipped_hi = min(sig_hi, self.sig.size)

        # bases whose signal spans intersect the window
        seq_lo = np.searchsorted(self.seq_to_sig_map, clipped_lo, "right") - 1
        seq_hi = np.searchsorted(self.seq_to_sig_map, clipped_hi, "left")

        chunk_map = self.seq_to_sig_map[seq_lo : seq_hi + 1] - (
            clipped_lo - left_pad
        )
        chunk_map[0] = 0
        chunk_map[-1] = chunk_len
        chunk_map = chunk_map.astype(np.int32)

        seq_ctx = self._chunk_sequence(seq_lo, seq_hi, kmer_context_bases)
        chunk = Chunk(
            signal=chunk_sig,
            seq_w_context=seq_ctx,
            seq_to_sig_map=chunk_map,
            kmer_context_bases=kmer_context_bases,
            chunk_sig_focus_idx=focus_sig_idx - clipped_lo,
            chunk_focus_base=read_focus_base - seq_lo,
            read_focus_base=read_focus_base,
            label=label,
            read_id=self.read_id,
        )
        if check_chunk:
            chunk.check()
        return chunk

    def _anchor_signal_index(self, focus_base, base_start_justify):
        """Signal coordinate a chunk is anchored on for a focus base."""
        span_lo = self.seq_to_sig_map[focus_base]
        if base_start_justify:
            return span_lo
        return (span_lo + self.seq_to_sig_map[focus_base + 1]) // 2

    def _chunk_at(self, focus_base, chunk_context, kmer_context_bases,
                  base_start_justify, check_chunks, label):
        """One chunk at a focus base, or None if extraction fails."""
        anchor = self._anchor_signal_index(focus_base, base_start_justify)
        try:
            return self.extract_chunk(
                anchor,
                chunk_context,
                kmer_context_bases,
                check_chunk=check_chunks,
                read_focus_base=focus_base,
                label=label,
            )
        except RemoraError as e:
            LOGGER.debug(f"chunk failed validation: {e}")
        except Exception as e:
            LOGGER.debug(f"chunk extraction raised: {e}")
        return None

    def iter_chunks(
        self,
        chunk_context,
        kmer_context_bases,
        *,
        offset=0,
        base_start_justify=False,
        motifs=None,
        check_chunks=False,
    ):
        last_mapped = self.seq_to_sig_map.size - 2
        for focus_base in self.focus_bases:
            if motifs is not None:
                hit = any(
                    m.match(self.int_seq, focus_base) for m in motifs
                )
                if not hit:
                    LOGGER.debug("FAILED_MOTIF_CHECK")
                    continue
            if self.labels is None:
                label = -1
            else:
                label = self.labels[focus_base]
            # shift by requested offset, clamped to mapped bases
            focus_base = int(np.clip(focus_base + offset, 0, last_mapped))
            chunk = self._chunk_at(
                focus_base, chunk_context, kmer_context_bases,
                base_start_justify, check_chunks, label,
            )
            if chunk is not None:
                yield chunk

    def prepare_batches(self, model_metadata, batch_size):
        """Prepare device-ready batches of this read's chunks.

        Reference analog ``data_chunks.py:468–514`` — builds an in-memory
        dataset so chunk tensor assembly is identical to training prep.
        """
        from remora_tpu_torch.data.dataset import CoreDataset
        from remora_tpu_torch.data.metadata import DatasetMetadata

        md = model_metadata
        self.batches = []
        self.refine_signal_mapping(md["sig_map_refiner"])
        chunk_list = list(
            self.iter_chunks(
                md["chunk_context"],
                md["kmer_context_bases"],
                base_start_justify=md["base_start_justify"],
                offset=md["offset"],
            )
        )
        if not chunk_list:
            return
        motif_seqs, motif_offsets = zip(*md["motifs"])
        widest = max(c.seq_len for c in chunk_list)
        staging_meta = DatasetMetadata(
            allocate_size=len(chunk_list),
            mod_bases=md["mod_bases"],
            mod_long_names=md["mod_long_names"],
            max_seq_len=widest,
            kmer_context_bases=md["kmer_context_bases"],
            chunk_context=md["chunk_context"],
            motif_sequences=list(motif_seqs),
            motif_offsets=list(motif_offsets),
            extra_arrays={"read_focus_bases": ("int64", "")},
        )
        staging = CoreDataset(
            mode="w",
            metadata=staging_meta,
            batch_size=batch_size,
            super_batch_size=len(chunk_list),
            infinite_iter=False,
        )
        for chunk in chunk_list:
            staging.write_chunk(chunk)
        cols = ("signal", "enc_kmers", "labels", "read_focus_bases")
        self.batches = [
            tuple(batch[c] for c in cols) for batch in staging
        ]

    def run_model(self, eval_fn):
        """Call modified bases over prepared batches.

        Args:
            eval_fn: callable (sigs, enc_kmers) -> logits, a tensor on the
                model's device (``ModelHandle.eval_fn``), brought to the
                host once a batch. Ragged batches are padded to
                power-of-two bucket shapes, as in the JAX package, so a
                batch's shape is one of a bounded set.

        Returns:
            (outputs (ncalls, nlab), labels, read positions)
        """
        per_batch = []
        for sigs, enc_kmers, labels, positions in self.batches:
            n = sigs.shape[0]
            bucket = 1 << max(0, (n - 1)).bit_length()
            if bucket != n:
                pad_s = np.zeros((bucket,) + sigs.shape[1:], sigs.dtype)
                pad_k = np.zeros(
                    (bucket,) + enc_kmers.shape[1:], enc_kmers.dtype
                )
                pad_s[:n] = sigs
                pad_k[:n] = enc_kmers
                out = eval_fn(pad_s, pad_k).cpu().numpy()[:n]
            else:
                out = eval_fn(sigs, enc_kmers).cpu().numpy()
            per_batch.append((out, labels, positions))
        outs, labs, poss = zip(*per_batch)
        return (
            np.concatenate(outs, axis=0),
            np.concatenate(labs),
            np.concatenate(poss),
        )
