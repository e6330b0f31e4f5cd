"""Chunk datasets: single memory-mapped store + weighted composition.

Copy of ``remora_tpu/data/dataset.py`` (reference ``CoreRemoraDataset``
and ``RemoraDataset``). The on-disk layout is the JAX package's, bit-
compatible with reference dataset v3: five headerless arrays
(``signal.npy`` f32 (N,1,W), ``sequence.npy`` i8, ``sequence_to_signal_
mapping.npy`` i16, ``sequence_lengths.npy`` i16, ``labels.npy`` i64 —
written via np.memmap, so despite the extension there is no npy header),
plus ``extra_*.npy`` and ``metadata.jsn`` (+ ``kmer_table.npy``). The
sampled-block content hash matches the reference digest so dataset
configs interoperate.

Batches are plain dicts of NumPy arrays; the training loop moves them to
the device and the encoded-kmer featurization runs there (the host
featurizer here serves validation batches). Every ``np.random`` call sits
where the JAX package has it, so the same seed gives the same batches.

Change from the JAX copy: the chunk-context trim is the vectorised NumPy
path only (the JAX package may take a C++ kernel with the same result).
"""

import hashlib
import itertools
import json
import os
from dataclasses import dataclass
from glob import glob
from typing import Optional

import numpy as np

from remora_tpu_torch import RemoraError, log
from remora_tpu_torch.constants import (
    DEFAULT_BATCH_SIZE,
    DEFAULT_SUPER_BATCH_SIZE,
)
from remora_tpu_torch.core import seq as sequtil
from remora_tpu_torch.core.util import resolve_path
from remora_tpu_torch.data import encoded_kmers
from remora_tpu_torch.data.metadata import DatasetMetadata

LOGGER = log.get_logger()

CORE_DTYPES = dict(
    signal=np.float32,
    sequence=np.int8,
    sequence_to_signal_mapping=np.int16,
    sequence_lengths=np.int16,
    labels=np.int64,
)
CORE_ARRAYS = tuple(CORE_DTYPES)


def _ragged_values(rows, lens, extra=0):
    """Flatten the first ``lens[i] + extra`` entries of every row."""
    col = np.arange(rows.shape[1])
    return rows[col[None, :] < lens[:, None] + extra]


def check_super_batch(super_batch, chunk_width):
    """Sanity-check a loaded super batch (reference ``check_super_batch``)."""
    seq_lens = super_batch["sequence_lengths"]
    if not seq_lens.all():
        raise RemoraError("Sequence lengths must all be positive.")
    maps = super_batch["sequence_to_signal_mapping"]
    flat_map = _ragged_values(maps, seq_lens, extra=1)
    if flat_map.max() > chunk_width:
        raise RemoraError("Signal mapping extends beyond the chunk width")
    if flat_map.min() < 0:
        raise RemoraError("Signal mapping contains negative values")
    row_idx = np.arange(seq_lens.size)
    if (maps[row_idx, seq_lens] != chunk_width).any():
        raise RemoraError("Chunk does not end at chunk_width")
    # monotonic within each row: negative steps allowed only at the
    # boundaries between consecutive flattened rows
    steps = np.diff(flat_map)
    row_break = np.cumsum(seq_lens + 1)[:-1] - 1
    interior = np.ones(steps.size, dtype=bool)
    interior[row_break] = False
    if steps[interior].min() < 0:
        raise RemoraError("Sequence to signal mappings are not monotonic")
    flat_seq = _ragged_values(super_batch["sequence"], seq_lens)
    if flat_seq.max() > 3 or flat_seq.min() < -1:
        raise RemoraError("Sequence values must be in [-1, 3]")


def trim_sb_chunk_context(stored_cc, cc, total_seq_context, *, seqs,
                          seq_mappings, seq_lens):
    """In-place ragged trim of seq + mapping rows for a smaller chunk
    context (reference Cython ``trim_sb_chunk_context_core``), fully
    vectorized (no per-row Python).

    Assumes ``seq_mappings`` has already been shifted by the start diff.
    """
    new_width = cc[0] + cc[1]
    n_rows, map_w = seq_mappings.shape
    col = np.arange(map_w)
    valid = col[None, :] <= seq_lens[:, None]
    guarded = np.where(valid, seq_mappings, np.int32(1 << 30))

    # first base whose (shifted) end maps beyond 0 becomes base 0
    ends_after_zero = (guarded[:, 1:] > 0) & valid[:, 1:]
    first_base = np.argmax(ends_after_zero, axis=1)
    # last base whose start precedes new_width becomes the final base
    starts_before_w = (guarded[:, :-1] < new_width) & valid[:, :-1]
    last_base = map_w - 2 - np.argmax(starts_before_w[:, ::-1], axis=1)
    new_lens = (last_base - first_base + 1).astype(seq_lens.dtype)

    # left-shift every row by its first_base via a per-row gather
    map_src = np.minimum(first_base[:, None] + col[None, :], map_w - 1)
    shifted = np.take_along_axis(seq_mappings, map_src, axis=1)
    np.clip(shifted, 0, new_width, out=shifted)
    shifted[:, 0] = 0
    np.put_along_axis(
        shifted, new_lens[:, None].astype(np.int64), new_width, axis=1
    )
    seq_mappings[:] = shifted

    seq_col = np.arange(seqs.shape[1])
    seq_src = np.minimum(
        first_base[:, None] + seq_col[None, :], seqs.shape[1] - 1
    )
    seqs[:] = np.take_along_axis(seqs, seq_src, axis=1)
    seq_lens[:] = new_lens
    return seqs, seq_mappings, seq_lens


def _sampled_file_digest(path, block_size=2**18, n_blocks=8):
    """sha256 of a file, hashing n_blocks evenly spaced blocks for large
    files (reference-compatible digest)."""
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        total = fh.seek(0, os.SEEK_END)
        if total < block_size * n_blocks:
            fh.seek(0)
            for piece in iter(lambda: fh.read(block_size), b""):
                digest.update(piece)
        else:
            starts = np.floor(
                np.linspace(0, total - block_size, n_blocks)
            ).astype(int)
            for pos in starts:
                fh.seek(pos)
                digest.update(fh.read(block_size))
    return digest.hexdigest()


def _format_label_summary(labels, counts):
    return "; ".join(
        f"{lab}:{n:,}" for lab, n in zip(labels, counts)
    )


@dataclass
class CoreDataset:
    """One on-disk (or in-memory) chunk store with super-batch streaming."""

    data_path: Optional["str"] = None
    mode: "str" = "r"
    metadata: Optional[DatasetMetadata] = None
    override_metadata: Optional[dict] = None
    batch_size: "int" = DEFAULT_BATCH_SIZE
    super_batch_size: "int" = DEFAULT_SUPER_BATCH_SIZE
    super_batch_sample_frac: Optional["float"] = None
    super_batch_offset: "int" = 0
    infinite_iter: "bool" = True
    do_check_super_batches: "bool" = False
    # multihost data parallelism: this process streams super batches
    # shard_index, shard_index + num_shards, ... (disjoint across hosts
    # while the stream stays within one wrap of the dataset)
    shard_index: "int" = 0
    num_shards: "int" = 1

    # ------------- paths / hashing -------------
    @staticmethod
    def dataset_paths(data_path):
        base = resolve_path(data_path)
        names = ["metadata.jsn"] + [f"{n}.npy" for n in CORE_ARRAYS]
        found = [os.path.join(base, name) for name in names]
        found.extend(sorted(glob(os.path.join(base, "extra_*.npy"))))
        kmer_table = os.path.join(base, "kmer_table.npy")
        if os.path.isfile(kmer_table):
            found.append(kmer_table)
        return found

    @staticmethod
    def check_dataset_dir(data_path):
        return all(
            os.path.isfile(p) for p in CoreDataset.dataset_paths(data_path)
        )

    @staticmethod
    def hash(data_path):
        """Sampled sha256 over dataset files (reference-compatible)."""
        combined = "".join(
            _sampled_file_digest(part)
            for part in CoreDataset.dataset_paths(data_path)
        )
        return hashlib.sha256(combined.encode("utf-8")).hexdigest()

    def _sidecar(self, filename):
        root = self.data_path
        if root is None:
            raise RemoraError("in-memory dataset has no backing files")
        return os.path.join(root, filename)

    @property
    def metadata_path(self):
        return self._sidecar("metadata.jsn")

    @property
    def kmer_table_path(self):
        return self._sidecar("kmer_table.npy")

    @property
    def size(self):
        md = self.metadata
        return md.size

    @property
    def array_names(self):
        extras = self.metadata.extra_array_names
        return list(CORE_ARRAYS) + extras

    @property
    def arrays_info(self):
        md = self.metadata
        info = [
            (name, dtype, getattr(md, name + "_shape"))
            for name, dtype in CORE_DTYPES.items()
        ]
        info.extend(md.extra_array_dtypes_and_shapes)
        return info

    @property
    def summary(self):
        md = self.metadata
        fields = (
            ("data_path", self.data_path),
            ("size", f"{self.size:,}"),
            ("dataset_start", f"{md.dataset_start:,}"),
            ("dataset_end", f"{md.dataset_end:,}"),
            ("label distribution", self.label_summary),
            ("modified_base_labels", md.modified_base_labels),
            ("mod_bases", md.mod_bases),
            ("mod_long_names", md.mod_long_names),
            ("kmer_context_bases", md.kmer_context_bases),
            ("chunk_context", md.chunk_context),
            ("motifs", md.motifs),
            ("reverse_signal", md.reverse_signal),
            ("chunk_extract_base_start", md.base_start_justify),
            ("chunk_extract_offset", md.offset),
            ("sig_map_refiner", md.sig_map_refiner),
        )
        return "".join(f"{name:>25} : {val}\n" for name, val in fields)

    def get_label_counts(self):
        window = slice(self.metadata.dataset_start, self.metadata.dataset_end)
        ds_labels = self.labels[window]
        if self.label_conv is not None:
            ds_labels = self.label_conv[ds_labels]
        return np.bincount(ds_labels)

    @property
    def label_summary(self):
        return _format_label_summary(
            self.metadata.labels, self.get_label_counts()
        )

    # ------------- metadata load / override -------------
    def _shrink_context(self, loaded, key, stored_key, requested):
        """Shrink-only context override (chunk or k-mer context)."""
        requested = tuple(requested)
        stored = loaded[key] = tuple(loaded[key])
        if requested[0] > stored[0] or requested[1] > stored[1]:
            raise RemoraError(
                f"{key} can only shrink (stored:{stored} ; "
                f"requested:{requested})"
            )
        loaded[stored_key] = stored
        return requested

    def _expand_labels(self, loaded, new_mod_bases):
        """Label conversion for adding mod classes (shared classes keep
        their identity; stored classes must all survive)."""
        stored_mods = list(map(str, loaded["mod_bases"]))
        if any(mb not in new_mod_bases for mb in stored_mods):
            raise AssertionError("Cannot remove modified base")
        if stored_mods == list(new_mod_bases)[: len(stored_mods)]:
            return
        conv = np.zeros(len(stored_mods) + 1, dtype=np.int64)
        for cls, mod in enumerate(stored_mods, start=1):
            conv[cls] = list(new_mod_bases).index(mod) + 1
        self.label_conv = conv
        LOGGER.debug(
            f"Setting label conversion: {self.label_conv} {self.data_path}"
        )

    def load_metadata(self):
        loaded = DatasetMetadata.load(self.metadata_path, self.kmer_table_path)
        overriding = self.override_metadata is not None
        if not overriding:
            self.metadata = DatasetMetadata(**loaded)
            return
        overrides = self.override_metadata
        rejected = []
        for key, val in overrides.items():
            if key == "dataset_start":
                if val < 0:
                    raise RemoraError("Dataset start must be positive")
            elif key == "dataset_end":
                if val > loaded["dataset_end"]:
                    raise RemoraError("Cannot set dataset end past loaded end")
            elif key == "mod_bases":
                assert "mod_long_names" in overrides
                assert len(overrides["mod_long_names"]) == len(val)
                self._expand_labels(loaded, val)
            elif key == "mod_long_names":
                assert "mod_bases" in overrides
            elif key == "extra_arrays":
                stored_extras = loaded["extra_arrays"] or {}
                missing = set(val) - set(stored_extras)
                if missing:
                    raise RemoraError(
                        f"Cannot load missing arrays: {', '.join(missing)}"
                    )
                val = {name: stored_extras[name] for name in val}
            elif key == "chunk_context":
                val = self._shrink_context(
                    loaded, key, "_stored_chunk_context", val
                )
            elif key == "kmer_context_bases":
                val = self._shrink_context(
                    loaded, key, "_stored_kmer_context_bases", val
                )
            else:
                rejected.append(key)
                continue
            if loaded.get(key) != val:
                LOGGER.debug(
                    f"Overriding {key} from '{loaded.get(key)}' to '{val}'"
                )
                loaded[key] = val
        if loaded["dataset_start"] >= loaded["dataset_end"]:
            raise RemoraError("Loaded dataset is empty")
        if rejected:
            raise RemoraError(
                f"Cannot change metadata values: {', '.join(rejected)}"
            )
        self.metadata = DatasetMetadata(**loaded)

    def update_metadata(self, other):
        inherited = {
            key: getattr(other.metadata, key)
            for key in (
                "mod_bases",
                "mod_long_names",
                "extra_arrays",
                "kmer_context_bases",
                "chunk_context",
            )
        }
        inherited["dataset_start"] = self.metadata.dataset_start
        inherited["dataset_end"] = self.metadata.dataset_end
        self.override_metadata = inherited
        self.load_metadata()

    # ------------- array management -------------
    def get_array_path(self, array_name):
        if array_name in (self.metadata.extra_arrays or {}):
            return self._sidecar(f"extra_{array_name}.npy")
        if array_name not in CORE_ARRAYS:
            raise RemoraError(f"unknown array: {array_name}")
        return self._sidecar(f"{array_name}.npy")

    def _require_write_mode(self):
        if self.mode == "w":
            return
        raise RemoraError("dataset opened read-only")

    def allocate_arrays(self):
        self._require_write_mode()
        in_memory = self.data_path is None
        if not in_memory:
            os.makedirs(self.data_path, exist_ok=True)
        for name, np_dtype, shape in self.arrays_info:
            if in_memory:
                arr = np.empty(shape, dtype=np_dtype)
            else:
                arr = np.memmap(
                    self.get_array_path(name),
                    mode="w+",
                    dtype=np_dtype,
                    shape=shape,
                )
            setattr(self, name, arr)

    def refresh_memmaps(self):
        if self.data_path is None:
            return
        file_mode = {"r": "r"}.get(self.mode, "r+")
        for name, np_dtype, shape in self.arrays_info:
            self.__dict__.pop(name, None)
            mapped = np.memmap(
                self.get_array_path(name),
                mode=file_mode,
                dtype=np_dtype,
                shape=shape,
            )
            setattr(self, name, mapped)

    def write_metadata(self):
        self.metadata.write(
            self.metadata_path, kmer_table_path=self.kmer_table_path
        )

    def close_memmaps(self):
        if self.data_path is None:
            return
        for name in CORE_ARRAYS:
            setattr(self, name, None)

    def __post_init__(self):
        self._iter = self.label_conv = None
        assert self.mode in "rw", "mode must be 'r' or 'w'"
        writing = self.mode == "w"
        if self.data_path is None:
            assert writing, "In-memory dataset must have mode='w'"
            assert isinstance(self.metadata, DatasetMetadata)
            self.allocate_arrays()
        else:
            self.data_path = resolve_path(self.data_path)
            if writing:
                assert isinstance(self.metadata, DatasetMetadata)
                self.allocate_arrays()
                self.write_metadata()
            else:
                self.load_metadata()
        self.refresh_memmaps()

    # ------------- writing -------------
    def write_batch(self, arrays):
        self._require_write_mode()
        sizes = {arr.shape[0] for arr in arrays.values()}
        if len(sizes) != 1:
            raise RemoraError("ragged batch: arrays differ in row count")
        (n_new,) = sizes
        md = self.metadata
        if n_new > md.allocate_size - md.dataset_end:
            self.write_metadata()
            raise RemoraError("batch overruns the allocated store")
        expected = set(self.array_names)
        missing = expected - set(arrays)
        if missing:
            raise RemoraError(
                f"Batch write must include all arrays. Missing: "
                f"{', '.join(missing)}"
            )
        surplus = set(arrays) - expected
        if surplus:
            raise RemoraError(
                f"Batch write must only include specified arrays. Found: "
                f"{', '.join(surplus)}"
            )
        row = md.dataset_end
        for name, incoming in arrays.items():
            getattr(self, name)[row : row + n_new] = incoming
        md.dataset_end = row + n_new

    @staticmethod
    def _padded_row(width, values, dtype):
        row = np.empty((1, width), dtype=dtype)
        row[0, : values.size] = values
        return row

    def write_chunk(self, chunk):
        """Write one Chunk as a single-row batch (right-padded arrays)."""
        md = self.metadata
        dt = CORE_DTYPES
        one = {"signal": chunk.signal[None].astype(dt["signal"])}
        one["sequence"] = self._padded_row(
            md.sequence_width, chunk.seq_w_context, dt["sequence"]
        )
        one["sequence_to_signal_mapping"] = self._padded_row(
            md.sequence_to_signal_mapping_width,
            chunk.seq_to_sig_map,
            dt["sequence_to_signal_mapping"],
        )
        one["sequence_lengths"] = np.array(
            [chunk.seq_len], dt["sequence_lengths"]
        )
        one["labels"] = np.array([chunk.label], dt["labels"])
        extras = self.metadata.extra_arrays or {}
        chunk_extras = {
            "read_ids": chunk.read_id,
            "read_focus_bases": chunk.read_focus_base,
        }
        for name, value in chunk_extras.items():
            if name in extras:
                one[name] = np.array([value], dtype=extras[name][0])
        self.write_batch(one)

    def shuffle(self, *, batch_size=100_000, show_prog=False):
        """On-disk permutation applied blockwise to bound memory."""
        self._require_write_mode()
        order = np.random.permutation(self.size)
        lo, hi = self.metadata.dataset_start, self.metadata.dataset_end
        for array_name in self.array_names:
            LOGGER.debug(f"Shuffling {array_name} array")
            live = getattr(self, array_name)[lo:hi]
            snapshot = live.copy()
            for blk_st in range(0, self.size, batch_size):
                blk_en = min(blk_st + batch_size, self.size)
                live[blk_st:blk_en] = snapshot[order[blk_st:blk_en]]
                if self.data_path is not None:
                    getattr(self, array_name).flush()

    def flush(self):
        if self.data_path is None:
            return
        for name in self.array_names:
            getattr(self, name).flush()
        # reopen so readers observe the flushed rows
        self.refresh_memmaps()

    # ------------- reading -------------
    def adjust_batch_params(self):
        """Resolve (chunks per super batch, per-SB random sample count)."""
        self.super_batch_size = min(self.super_batch_size, self.size)
        frac = self.super_batch_sample_frac
        if frac is None:
            return self.super_batch_size, None
        n_batches = np.ceil(self.super_batch_size * frac / self.batch_size)
        sb_select = int(n_batches) * self.batch_size
        if sb_select > self.super_batch_size:
            sb_select -= self.batch_size
        if sb_select == 0:
            self.batch_size = int(self.super_batch_size * frac)
            sb_select = self.batch_size
        if frac == 1.0:
            self.super_batch_size = sb_select
        return sb_select, sb_select

    def _trim_kmer_context_sb(self, super_batch):
        if self.metadata.kmer_context_bases_adjusted is False:
            return super_batch
        stored_kb = self.metadata.stored_kmer_context_bases[0]
        shift = stored_kb - self.metadata.kmer_context_bases[0]
        if shift > 0:
            seq = super_batch["sequence"]
            if not seq.flags.writeable:
                seq = super_batch["sequence"] = seq.copy()
            seq[:, :-shift] = seq[:, shift:]
        return super_batch

    def _trim_chunk_context_sb(self, super_batch):
        if self.metadata.chunk_context_adjusted is False:
            return super_batch
        stored_cc = self.metadata.stored_chunk_context
        cc = self.metadata.chunk_context
        lead_cut = stored_cc[0] - cc[0]
        super_batch["signal"] = np.ascontiguousarray(
            super_batch["signal"][:, :, lead_cut : stored_cc[0] + cc[1]]
        )
        for name in ("sequence_to_signal_mapping", "sequence",
                     "sequence_lengths"):
            if not super_batch[name].flags.writeable:
                super_batch[name] = super_batch[name].copy()
        smap = super_batch["sequence_to_signal_mapping"]
        smap -= lead_cut
        trim_sb_chunk_context(
            stored_cc,
            cc,
            sum(self.metadata.kmer_context_bases),
            seqs=super_batch["sequence"],
            seq_mappings=smap,
            seq_lens=super_batch["sequence_lengths"],
        )
        return super_batch

    def load_super_batch(self, offset=0, *, size=None,
                         select_num_chunks=None):
        """Copy a contiguous (wrapping if infinite) slab of chunk rows."""
        if self.infinite_iter:
            offset %= self.size
        elif offset >= self.size:
            return None
        origin = self.metadata.dataset_start
        if size is None:
            if self.infinite_iter:
                raise RemoraError(
                    "an infinite-iteration stream needs an explicit "
                    "super-batch size"
                )
            size = self.metadata.dataset_end - origin - offset
        if size > self.size:
            raise RemoraError("super batch exceeds the dataset")

        super_batch = {}
        lo = origin + offset
        if lo + size <= self.metadata.dataset_end:
            # in-range slab: copy so context trims never touch the memmap
            for name in self.array_names:
                super_batch[name] = getattr(self, name)[lo : lo + size].copy()
        elif self.infinite_iter:
            # wraparound handled by one index-arithmetic gather (a copy)
            rows = origin + (offset + np.arange(size)) % self.size
            for name in self.array_names:
                super_batch[name] = getattr(self, name)[rows]
        else:
            # tail of a finite dataset: a view is fine (read-only mode)
            for name in self.array_names:
                super_batch[name] = getattr(self, name)[
                    lo : self.metadata.dataset_end
                ]

        if select_num_chunks is not None:
            n_rows = super_batch["labels"].size
            keep = np.random.choice(
                n_rows, min(select_num_chunks, n_rows), replace=False
            )
            super_batch = {
                name: arr[keep] for name, arr in super_batch.items()
            }
        if self.label_conv is not None:
            remapped = self.label_conv[super_batch["labels"]]
            super_batch["labels"] = remapped
        super_batch = self._trim_kmer_context_sb(super_batch)
        return self._trim_chunk_context_sb(super_batch)

    def iter_super_batches(self, select_num_chunks=None):
        for sb_num in itertools.count():
            self.refresh_memmaps()
            stripe = self.shard_index + sb_num * self.num_shards
            sb_at = self.super_batch_offset + stripe * self.super_batch_size
            super_batch = self.load_super_batch(
                sb_at,
                size=self.super_batch_size,
                select_num_chunks=select_num_chunks,
            )
            if super_batch is None:
                return
            if self.do_check_super_batches:
                check_super_batch(
                    super_batch, chunk_width=self.metadata.chunk_width
                )
            yield super_batch

    def extract_batch(self, super_batch, start):
        """One training batch with host-side encoded-kmer features."""
        stop = min(start + self.batch_size, super_batch["sequence"].shape[0])
        window = slice(start, stop)
        kb, ka = self.metadata.kmer_context_bases
        batch = {
            "enc_kmers": encoded_kmers.compute_encoded_kmer_batch(
                kb,
                ka,
                super_batch["sequence"][window],
                super_batch["sequence_to_signal_mapping"][window],
                super_batch["sequence_lengths"][window],
            )
        }
        for name in ["signal", "labels"] + self.metadata.extra_array_names:
            batch[name] = super_batch[name][window]
        return batch

    def _iter_batches_inner(self, raw):
        chunks_per_sb, sb_select = self.adjust_batch_params()
        for super_batch in self.iter_super_batches(sb_select):
            for start in range(0, chunks_per_sb, self.batch_size):
                if not raw:
                    yield self.extract_batch(super_batch, start)
                    continue
                stop = min(
                    start + self.batch_size,
                    super_batch["sequence"].shape[0],
                )
                yield {
                    name: super_batch[name][start:stop]
                    for name in self.array_names
                }

    def iter_batches(self, max_batches=None, raw=False):
        """Yield batches; ``raw=True`` skips host enc-kmer computation and
        yields the ragged arrays for on-device featurization."""
        stream = self._iter_batches_inner(raw)
        if max_batches is None:
            return stream
        return itertools.islice(stream, max_batches)

    def __iter__(self):
        fresh = self._iter is None or not self.infinite_iter
        if fresh:
            self._iter = iter(self.iter_batches())
        return self._iter

    def __next__(self):
        live = self._iter
        return next(live)


# ----------------------------------------------------------------------
# dataset configs + composition
# ----------------------------------------------------------------------


def parse_dataset_config(config_path, used_configs=None):
    """Flatten a (possibly nested) dataset config into paths/weights/hashes.

    Configs are JSON lists of [path, weight] or [path, weight, hash];
    a path may point at another config (cycles detected). Weights are
    normalized to proportions.
    """
    config_path = resolve_path(config_path)
    used_configs = (
        {config_path: config_path} if used_configs is None else used_configs
    )
    with open(config_path) as fh:
        entries = json.load(fh)
    paths = []
    weights = []
    hashes = []
    for entry in entries:
        ds_path, weight = entry[:2]
        ds_hash = entry[2] if len(entry) > 2 else None
        assert weight > 0, "dataset config weight must be positive"
        ds_path = _existing_path(ds_path)
        if os.path.isdir(ds_path):
            computed = CoreDataset.hash(ds_path)
            if ds_hash is not None and ds_hash != computed:
                raise RemoraError(
                    "Dataset hash does not match value from config for "
                    f"dataset at {ds_path}"
                )
            paths.append(ds_path)
            hashes.append(computed if ds_hash is None else ds_hash)
            weights.append(weight)
        else:
            # nested config file
            if ds_path in used_configs:
                raise RemoraError(
                    f"Circular or repeated dataset config reference. "
                    f"{ds_path} found in {config_path}"
                )
            used_configs[ds_path] = config_path
            sub_paths, sub_props, sub_hashes = parse_dataset_config(
                ds_path, used_configs=used_configs
            )
            paths += sub_paths
            hashes += sub_hashes
            weights.extend(np.asarray(sub_props) * weight)
    if len(set(paths)) != len(paths):
        LOGGER.warning("Core datasets loaded multiple times")
    mix = np.array(weights, dtype=float)
    return paths, mix / mix.sum(), hashes


def _existing_path(ds_path):
    ds_path = resolve_path(ds_path)
    if not os.path.exists(ds_path):
        raise RemoraError(f"no dataset at {ds_path}")
    return ds_path


def load_dataset(ds_path):
    """Parse either a core dataset dir or a dataset config file."""
    ds_path = _existing_path(ds_path)
    if os.path.isdir(ds_path):
        return [ds_path], np.array([1.0]), None
    return parse_dataset_config(ds_path)


def compute_best_split(total_size, props):
    """Integer split of total_size approximately proportional to props."""
    if len(props) > total_size:
        raise RemoraError(
            f"cannot split {total_size} items {len(props)} ways "
            "(need at least one each)"
        )
    sizes = np.floor(np.asarray(props) * total_size).astype(int)
    np.maximum(sizes, 1, out=sizes)
    while sizes.sum() > total_size:
        sizes[sizes.argmax()] -= 1
    while sizes.sum() < total_size:
        shortfall = np.asarray(props) - sizes / sizes.sum()
        sizes[shortfall.argmax()] += 1
    return sizes


class ComposedDataset:
    """Weighted mixture of CoreDatasets yielding combined fixed-size batches.

    Reference analog ``RemoraDataset``; yields dicts of NumPy arrays
    (enc_kmers computed host-side, or raw ragged arrays for on-device
    featurization via ``iter_batches(raw=True)``).
    """

    # metadata that every member dataset must share exactly
    UNIFORM_METADATA = (
        "sig_map_refiner",
        "pa_scaling",
        "reverse_signal",
        "modified_base_labels",
        "base_start_justify",
        "offset",
    )

    def __init__(
        self,
        datasets,
        proportions,
        hashes=None,
        *,
        seed=None,
        batch_size=DEFAULT_BATCH_SIZE,
        super_batch_size=DEFAULT_SUPER_BATCH_SIZE,
        super_batch_sample_frac=None,
    ):
        if len(datasets) != len(proportions):
            raise RemoraError("need exactly one proportion per dataset")
        if not all(0 <= p <= 1 for p in proportions):
            raise RemoraError("proportions must lie in [0, 1]")
        self.datasets = datasets
        self.props = proportions
        self._hashes = hashes
        self.seed = seed
        self.super_batch_size = super_batch_size
        self.super_batch_sample_frac = super_batch_sample_frac
        self.set_batch_size(batch_size)
        self.infinite_iter = all(ds.infinite_iter for ds in datasets)
        self.set_global_metadata()
        for member in datasets:
            member.update_metadata(self)
        self.super_batch_offsets = [0] * len(datasets)
        self._ds_iters = self._iter = self._all_batches = None

    # ---- properties ----
    @property
    def size(self):
        return sum(member.size for member in self.datasets)

    @property
    def num_datasets(self):
        members = self.datasets
        return len(members)

    @property
    def paths(self):
        return [member.data_path for member in self.datasets]

    @property
    def hashes(self):
        known = self._hashes
        if known is None or None in known:
            LOGGER.debug("Computing dataset hashes")
            known = self._hashes = [
                member.hash(member.data_path) for member in self.datasets
            ]
        return known

    @property
    def summary(self):
        md = self.metadata
        fields = (
            ("size", f"{self.size:,}"),
            ("modified_base_labels", md.modified_base_labels),
            ("mod_bases", md.mod_bases),
            ("mod_long_names", md.mod_long_names),
            ("kmer_context_bases", md.kmer_context_bases),
            ("chunk_context", md.chunk_context),
            ("motifs", md.motifs),
            ("reverse_signal", md.reverse_signal),
            ("chunk_extract_base_start", md.base_start_justify),
            ("chunk_extract_offset", md.offset),
            ("pa_scaling", md.pa_scaling),
            ("sig_map_refiner", md.sig_map_refiner),
        )
        return "".join(f"{name:>25} : {val}\n" for name, val in fields)

    @property
    def init_kwargs(self):
        return dict(
            proportions=self.props,
            hashes=self._hashes,
            batch_size=self.batch_size,
            super_batch_size=self.super_batch_size,
            super_batch_sample_frac=self.super_batch_sample_frac,
            seed=self.seed,
        )

    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)
        self.batch_sizes = compute_best_split(batch_size, self.props)

    # ---- global metadata merge ----
    def _replace_motifs(self, motifs):
        merged = sequtil.merge_motifs(motifs)
        seqs, offs = zip(*[m.to_tuple() for m in merged])
        self.metadata.motif_sequences = list(seqs)
        self.metadata.motif_offsets = list(offs)
        self.metadata.check_motifs()

    def _fold_in_labels(self, member_md):
        """Union of mod classes, preserving long-name consistency."""
        known = dict(
            zip(self.metadata.mod_bases, self.metadata.mod_long_names)
        )
        md = self.metadata
        for mb, mln in zip(member_md.mod_bases, member_md.mod_long_names):
            if mb not in known:
                md.mod_bases.append(mb)
                md.mod_long_names.append(mln)
            else:
                assert known[mb] == mln, "Mismatched modified bases."

    def _fold_in_contexts(self, member_md):
        """Element-wise minimum of both context windows."""
        for attr in ("kmer_context_bases", "chunk_context"):
            ours = getattr(self.metadata, attr)
            theirs = getattr(member_md, attr)
            if ours != theirs:
                setattr(
                    self.metadata,
                    attr,
                    (min(ours[0], theirs[0]), min(ours[1], theirs[1])),
                )

    _PER_STORE_MD = (
        "allocate_size", "max_seq_len", "dataset_start", "dataset_end",
    )

    def set_global_metadata(self):
        merged = self.datasets[0].metadata.copy()
        self.metadata = merged
        # these describe one on-disk store, not the mixture
        for md_name in self._PER_STORE_MD:
            setattr(self.metadata, md_name, None)
        self._replace_motifs(self.metadata.motifs)
        for ds in self.datasets[1:]:
            member_md = ds.metadata
            for attr in self.UNIFORM_METADATA:
                if getattr(member_md, attr) != getattr(self.metadata, attr):
                    raise RemoraError(
                        f"All datasets must have same {attr} "
                        f"{getattr(member_md, attr)} != "
                        f"{getattr(self.metadata, attr)}"
                    )
            ours = set(self.metadata.extra_array_names)
            theirs = set(member_md.extra_array_names)
            if ours != theirs:
                raise RemoraError(
                    f"extra arrays differ between members: "
                    f"{sorted(theirs)} vs {sorted(ours)}"
                )
            self._fold_in_labels(member_md)
            self._fold_in_contexts(member_md)
            if set(member_md.motifs) != set(self.metadata.motifs):
                self._replace_motifs(self.metadata.motifs + member_md.motifs)
        # canonical order: modified bases sorted alphabetically
        by_base = sorted(
            zip(self.metadata.mod_bases, self.metadata.mod_long_names)
        )
        self.metadata.mod_bases = [mb for mb, _ in by_base]
        self.metadata.mod_long_names = [mln for _, mln in by_base]

    _UPDATE_GUARD_KEYS = (
        "modified_base_labels",
        "offset",
        "reverse_signal",
        "pa_scaling",
        "sig_map_refiner",
    )
    _UPDATE_INHERIT_KEYS = (
        "mod_bases",
        "mod_long_names",
        "extra_arrays",
        "kmer_context_bases",
        "chunk_context",
    )

    def update_metadata(self, other):
        theirs = other.metadata
        for md_key in self._UPDATE_GUARD_KEYS:
            if getattr(theirs, md_key) != getattr(self.metadata, md_key):
                raise RemoraError(
                    f"metadata field {md_key!r} differs; cannot update"
                )
        for member in self.datasets:
            member.update_metadata(other)
        for md_key in self._UPDATE_INHERIT_KEYS:
            setattr(self.metadata, md_key, getattr(theirs, md_key))

    # ---- construction ----
    @classmethod
    def from_config(cls, config_path, *, override_metadata=None,
                    ds_kwargs=None, **kwargs):
        paths, props, hashes = parse_dataset_config(config_path)
        override_metadata = override_metadata or {}
        ds_kwargs = ds_kwargs or {}
        members = [
            CoreDataset(
                ds_path, override_metadata=override_metadata.copy(), **ds_kwargs
            )
            for ds_path in paths
        ]
        return cls(members, props, hashes, **kwargs)

    def _reopen_slices(self, sizes, override_metadata, *, tail):
        """Reopen each member restricted to its first ``sizes[i]`` chunks
        (``tail=False``) or everything after them (``tail=True``)."""
        out = []
        for ds, n in zip(self.datasets, sizes):
            if n >= ds.size:
                raise RemoraError("Not enough chunks")
            cut = ds.metadata.dataset_start + n
            md = dict(override_metadata)
            if tail:
                md["dataset_start"] = cut
                out.append(CoreDataset(ds.data_path, override_metadata=md))
            else:
                md["dataset_start"] = ds.metadata.dataset_start
                md["dataset_end"] = cut
                out.append(
                    CoreDataset(
                        ds.data_path,
                        infinite_iter=False,
                        override_metadata=md,
                    )
                )
        return out

    def train_test_split(self, num_test_chunks, override_metadata=None):
        override_metadata = override_metadata or {}
        test_sizes = compute_best_split(num_test_chunks, self.props)
        trn = self._reopen_slices(test_sizes, override_metadata, tail=True)
        tst = self._reopen_slices(test_sizes, override_metadata, tail=False)
        return (
            ComposedDataset(trn, **self.init_kwargs),
            ComposedDataset(tst, **self.init_kwargs),
        )

    def head(self, num_chunks, override_metadata=None):
        sizes = compute_best_split(num_chunks, self.props)
        override_metadata = override_metadata or {}
        heads = self._reopen_slices(sizes, override_metadata, tail=False)
        return ComposedDataset(heads, **self.init_kwargs)

    # ---- iteration ----
    def _set_sub_ds_iters(self, raw=False):
        members = self.datasets
        for member, bs, sb_off in zip(
            members, self.batch_sizes, self.super_batch_offsets
        ):
            member.batch_size = int(bs)
            member.super_batch_offset = sb_off
            member.super_batch_size = self.super_batch_size
            member.super_batch_sample_frac = self.super_batch_sample_frac
        self._ds_iters = [m.iter_batches(raw=raw) for m in members]

    def iter_batches(self, *, raw=False,
                     return_arrays=("enc_kmers", "signal", "labels")):
        if self._ds_iters is None:
            self._set_sub_ds_iters(raw=raw)
        names = (
            list(self.datasets[0].array_names)
            if raw
            else list(return_arrays)
        )

        def concat(arrays):
            if raw and arrays[0].ndim == 2:
                # ragged widths can differ between sub-datasets (different
                # stored max_seq_len); right-pad to the widest
                width = max(a.shape[1] for a in arrays)
                if any(a.shape[1] != width for a in arrays):
                    arrays = [
                        np.pad(a, ((0, 0), (0, width - a.shape[1])))
                        for a in arrays
                    ]
            return np.concatenate(arrays)

        while True:
            try:
                member_batches = [next(it) for it in self._ds_iters]
            except StopIteration:
                break
            yield {
                name: concat([mb[name] for mb in member_batches])
                for name in names
            }

    def load_all_batches(self):
        if self.infinite_iter is True:
            raise RemoraError(
                "caching every batch needs a finite iteration order"
            )
        self._set_sub_ds_iters()
        cached = [*self.iter_batches()]
        for member in self.datasets:
            member.close_memmaps()
        self._all_batches = cached

    def __iter__(self):
        cached = self._all_batches
        if cached is not None:
            self._iter = iter(cached)
            return self._iter
        stale = self._iter is None or not self.infinite_iter
        if stale:
            self._set_sub_ds_iters()
            self._iter = iter(self.iter_batches())
        return self._iter

    def __next__(self):
        live = self._iter
        return next(live)

    # ---- stats / config ----
    def get_label_counts(self):
        totals = np.zeros(int(self.metadata.num_labels), int)
        for member in self.datasets:
            counts = member.get_label_counts()
            totals[: counts.size] += counts
        return totals

    @property
    def label_summary(self):
        return _format_label_summary(
            self.metadata.labels, self.get_label_counts()
        )

    def get_config(self):
        rows = zip(self.paths, self.props, self.hashes)
        out = []
        for path, weight, digest in rows:
            out.append(
                (path, weight) if digest is None else (path, weight, digest)
            )
        return out

    def epoch_summary(self, batches_per_epoch):
        """Per-dataset draw rates and per-label batch/total counts
        (reference ``RemoraDataset.epoch_summary`` format)."""
        labels = self.metadata.labels
        rows = []
        for ds, ds_bs in zip(self.datasets, self.batch_sizes):
            per_epoch = batches_per_epoch * ds_bs
            pairs = zip(ds.metadata.labels, ds.get_label_counts())
            counts = dict(pairs)
            total = sum(counts.values())
            batch_col = "\t".join(
                f"{int(np.ceil(counts.get(lab, 0) / total * ds_bs)):,}"
                for lab in labels
            )
            count_col = "\t".join(f"{counts.get(lab, 0):,}" for lab in labels)
            rows.append(
                f"{per_epoch / ds.size:10.4%}\t{batch_col}\t{per_epoch:,}\t"
                f"{ds.size:,}\t{count_col}\t{ds.data_path}"
            )
        batch_hdr = "\t".join(f"batch_{lab}" for lab in labels)
        ds_hdr = "\t".join(f"dataset_{lab}" for lab in labels)
        header = (
            f"percent_of_dataset_per_epoch\t{batch_hdr}\t"
            f"dataset_chunks_per_epoch\tdataset_size\t{ds_hdr}\tpath\n"
        )
        return header + "\n".join(rows)
