"""Dataset metadata: schema + chunk-extraction hyperparameters.

Copy of ``remora_tpu/data/metadata.py``. The on-disk representation
(``metadata.jsn`` + ``kmer_table.npy`` sidecar) is the JAX package's, so
datasets interoperate in both directions; dataclass field names double
as the JSON key contract.

The JAX package holds the refinement settings as a ``SigMapRefiner``;
this package does not refine (yet), so it carries them as a plain
``refine_settings`` dict of the ``refine_*`` keys, which round-trip
unchanged through ``write`` and ``load``.
"""

import dataclasses
import json
import os
from copy import deepcopy
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from remora_tpu_torch import RemoraError, constants
from remora_tpu_torch.constants import (
    DEFAULT_CHUNK_CONTEXT,
    DEFAULT_KMER_CONTEXT_BASES,
    DEFAULT_ROUGH_RESCALE_METHOD,
)
from remora_tpu_torch.core.seq import Motif

DATASET_VERSION = constants.DATASET_VERSION

# numpy scalar/array -> plain JSON value
_JSON_COERCIONS = (
    (np.integer, int),
    (np.floating, float),
    (np.bool_, bool),
    (np.ndarray, lambda a: a.tolist()),
)


def jsonify_numpy(obj):
    """``json.dump`` default hook handling numpy scalars and arrays."""
    for np_type, coerce in _JSON_COERCIONS:
        if isinstance(obj, np_type):
            return coerce(obj)
    raise TypeError(f"Object of type {type(obj)} is not JSON serializable")


def same_refine_settings(a, b):
    """Equality on the settings that affect refinement (the tiers of the
    JAX package's ``SigMapRefiner.__eq__``): when neither side rescales
    nor refines, the rest is inert; otherwise every key must agree."""
    a, b = a or {}, b or {}

    def mode(s):
        return (bool(s.get("refine_do_rough_rescale", False)),
                int(s.get("refine_scale_iters", -1)))

    if mode(a) != mode(b):
        return False
    if not mode(a)[0] and mode(a)[1] < 0:
        return True
    if a.keys() != b.keys():
        return False
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


@dataclasses.dataclass
class DatasetMetadata:
    """Travels with data and model so inference extracts chunks exactly
    as data preparation did. Derived views resolve through ``_DERIVED``
    via ``__getattr__``."""

    # store geometry
    allocate_size: "int"
    max_seq_len: "int"
    # label classes
    mod_bases: Sequence[str]
    mod_long_names: Sequence[str]
    # extraction sites
    motif_sequences: Sequence[str]
    motif_offsets: Sequence[int]

    # live row window + format version
    dataset_start: "int" = 0
    dataset_end: "int" = 0
    version: "int" = DATASET_VERSION
    # extraction hyperparameters (travel with the data)
    modified_base_labels: "bool" = True
    extra_arrays: Optional[Dict[str, tuple]] = None
    chunk_context: Tuple[int, int] = DEFAULT_CHUNK_CONTEXT
    base_start_justify: "bool" = False
    offset: "int" = 0
    kmer_context_bases: Tuple[int, int] = DEFAULT_KMER_CONTEXT_BASES
    reverse_signal: "bool" = False
    pa_scaling: Optional[Tuple[float, float]] = None
    refine_settings: Optional[dict] = None
    rough_rescale_method: "str" = DEFAULT_ROUGH_RESCALE_METHOD

    _stored_kmer_context_bases: Optional[Tuple[int, int]] = None
    _stored_chunk_context: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        self.mod_bases = [str(code) for code in self.mod_bases]
        if len(self.mod_bases) != len(self.mod_long_names):
            raise AssertionError(
                f"mod_bases ({self.mod_bases}) and mod_long_names "
                f"({self.mod_long_names}) must pair up"
            )
        for attr in ("mod_long_names", "motif_sequences", "motif_offsets"):
            setattr(self, attr, list(getattr(self, attr)))
        for attr in ("chunk_context", "kmer_context_bases"):
            setattr(self, attr, tuple(getattr(self, attr)))
        for attr in ("_stored_chunk_context", "_stored_kmer_context_bases",
                     "pa_scaling"):
            val = getattr(self, attr)
            if val is not None:
                setattr(self, attr, tuple(val))
        self.check_motifs()

    def __getattr__(self, name):
        rule = _DERIVED.get(name)
        if rule is None:
            raise AttributeError(
                f"{type(self).__name__!r} object has no attribute {name!r}"
            )
        return rule(self)

    def check_motifs(self):
        motifs = [Motif(*mot) for mot in self.motifs]
        ambig = [m for m in motifs if m.focus_base not in "ACGT"]
        if ambig:
            raise RemoraError(
                f"Dataset motifs need unambiguous focus bases; got {ambig}"
            )
        if len({m.focus_base for m in motifs}) > 1:
            raise RemoraError(
                "Dataset motifs must share a single focus base; got "
                f"{set(m.focus_base for m in motifs)}"
            )

    @property
    def extra_array_dtypes_and_shapes(self):
        shape = self.extras_shape
        return [
            (name, dtype, shape)
            for name, (dtype, _desc) in (self.extra_arrays or {}).items()
        ]

    # --- (de)serialization ---
    def copy(self):
        return deepcopy(self)

    def asdict(self):
        flat = dataclasses.asdict(self)
        flat.update(flat.pop("refine_settings") or {})
        return flat

    def write(self, metadata_path, kmer_table_path=None):
        """Write metadata.jsn (levels go to the .npy sidecar)."""
        record = self.asdict()
        levels = record.pop("refine_kmer_levels", None)
        if levels is not None and kmer_table_path is not None:
            np.save(kmer_table_path, levels, allow_pickle=False)
        with open(metadata_path, "w") as fh:
            json.dump(record, fh, default=jsonify_numpy)

    @classmethod
    def load(cls, metadata_path, kmer_table_path=None):
        """Load metadata.jsn (+ optional kmer table sidecar) to a dict."""
        with open(metadata_path) as fh:
            record = json.load(fh)
        found_version = record.get("version")
        if found_version != DATASET_VERSION:
            raise RemoraError(
                f"unsupported dataset version {found_version} "
                f"(this build reads v{DATASET_VERSION})"
            )
        if kmer_table_path is not None and os.path.exists(kmer_table_path):
            record["refine_kmer_levels"] = np.load(kmer_table_path)
        if record.get("refine_sd_arr") is not None:
            record["refine_sd_arr"] = np.asarray(
                record["refine_sd_arr"], np.float32
            )
        refine = {
            k: record.pop(k) for k in list(record) if k.startswith("refine_")
        }
        record["refine_settings"] = refine or None
        return record


def _alloc_rows(meta, *trailing):
    """Allocated array shape: one leading row per chunk."""
    return (meta.allocate_size,) + trailing


_DERIVED = {
    # context windows (requested vs stored-on-disk)
    "stored_chunk_context":
        lambda m: m._stored_chunk_context or m.chunk_context,
    "stored_kmer_context_bases":
        lambda m: m._stored_kmer_context_bases or m.kmer_context_bases,
    "chunk_context_adjusted":
        lambda m: m.chunk_context != m.stored_chunk_context,
    "kmer_context_bases_adjusted":
        lambda m: m.kmer_context_bases != m.stored_kmer_context_bases,
    "chunk_width": lambda m: sum(m.chunk_context),
    "stored_chunk_width": lambda m: sum(m.stored_chunk_context),
    "kmer_len": lambda m: 1 + sum(m.kmer_context_bases),
    # labels / motifs
    "labels": lambda m: ["control"] + list(m.mod_long_names),
    "num_labels": lambda m: 1 + len(m.mod_long_names),
    "motifs": lambda m: list(zip(m.motif_sequences, m.motif_offsets)),
    "num_motifs": lambda m: len(m.motif_sequences),
    "size": lambda m: m.dataset_end - m.dataset_start,
    # per-chunk widths of the ragged arrays
    "sequence_width":
        lambda m: m.max_seq_len + sum(m.stored_kmer_context_bases),
    "sequence_to_signal_mapping_width": lambda m: m.max_seq_len + 1,
    # full allocated array shapes, one per core on-disk array
    "sequence_lengths_shape": _alloc_rows,
    "labels_shape": _alloc_rows,
    "extras_shape": _alloc_rows,
    "signal_shape": lambda m: _alloc_rows(m, 1, m.stored_chunk_width),
    "sequence_shape": lambda m: _alloc_rows(m, m.sequence_width),
    "sequence_to_signal_mapping_shape":
        lambda m: _alloc_rows(m, m.sequence_to_signal_mapping_width),
    "extra_array_names": lambda m: list(m.extra_arrays or ()),
}
