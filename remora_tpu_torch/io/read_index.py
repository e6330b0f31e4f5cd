"""Read-id indexed BAM access (reference analog ``src/remora/io.py:183–391``).

A full scan records the stream offset of every kept record keyed by its
*parent* read id (the ``pi`` tag for split reads, else the query name),
so signal extracted from POD5 by parent id can be joined back to all of
its alignments. Skip reasons are tallied for the final report.

Built on FastBamScanner (whole-file decompress + in-memory offsets) —
the index pass decompresses each BGZF block exactly once and offsets are
plain byte positions into the decompressed stream.

Copy of ``remora_tpu/io/read_index.py``, importing this package's modules.
"""

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from remora_tpu_torch import RemoraError, log
from remora_tpu_torch.io.bam import FastBamScanner

LOGGER = log.get_logger()

_INDEX_CACHE_VERSION = 1


def _index_cache_path(bam_path):
    """Cache file under the user cache dir (never beside the BAM — data
    directories are often shared/read-only and must not be written to).
    REMORA_TPU_BAM_INDEX_CACHE_DIR overrides the location."""
    import hashlib

    cache_dir = os.getenv(
        "REMORA_TPU_BAM_INDEX_CACHE_DIR",
        os.path.join(
            os.path.expanduser("~"), ".cache", "remora_tpu_torch", "bam_index"
        ),
    )
    key = hashlib.sha256(
        os.path.abspath(bam_path).encode()
    ).hexdigest()[:24]
    stem = os.path.basename(bam_path)
    return os.path.join(cache_dir, f"{stem}.{key}.rtidx.npz")


def _cache_meta(bam_path, req_key):
    st = os.stat(bam_path)
    return {
        "version": _INDEX_CACHE_VERSION,
        "size": st.st_size,
        "mtime_ns": st.st_mtime_ns,
        "req_tags": req_key,
    }


def _load_index_cache(bam_path, req_key):
    """Cached pre-filter scan columns, or None on any miss/mismatch.

    The cache stores the raw per-record scan output (offsets, flags,
    names, parent ids, required-tag presence) BEFORE the runtime-only
    filters (_admit), so one cache file serves every filter
    configuration with the same required-tag set. Keyed by the BAM's
    (size, mtime) — a rewritten file invalidates it. Kill switch:
    REMORA_TPU_BAM_INDEX_CACHE=0.
    """
    if os.getenv("REMORA_TPU_BAM_INDEX_CACHE", "1") == "0":
        return None
    path = _index_cache_path(bam_path)
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta != _cache_meta(bam_path, req_key):
                return None
            offsets = z["offsets"]
            flags = z["flags"]
            names = z["names"].tolist()
            pis_raw = z["pis"].tolist()
            pi_none = z["pi_none"]
            has_req = z["has_req"]
    except Exception:  # noqa: BLE001 — a corrupt/truncated cache file
        # (BadZipFile, zlib.error, ...) must degrade to a rescan, never
        # permanently break indexing of that BAM
        return None
    pis = [
        None if none else pi for pi, none in zip(pis_raw, pi_none)
    ]
    return offsets, flags, names, pis, has_req


def _save_index_cache(bam_path, req_key, res):
    """Best-effort atomic cache write (unwritable cache dirs are
    silently skipped)."""
    if os.getenv("REMORA_TPU_BAM_INDEX_CACHE", "1") == "0":
        return
    offsets, flags, names, pis, has_req = res
    path = _index_cache_path(bam_path)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path),
            prefix=os.path.basename(path) + ".",
        )
        with os.fdopen(fd, "wb") as fh:
            np.savez(
                fh,
                meta=json.dumps(_cache_meta(bam_path, req_key)),
                offsets=np.asarray(offsets, np.int64),
                flags=np.asarray(flags, np.uint16),
                names=np.asarray(names, dtype=str),
                pis=np.asarray(
                    ["" if p is None else p for p in pis], dtype=str
                ),
                pi_none=np.asarray([p is None for p in pis], bool),
                has_req=np.asarray(has_req, bool),
            )
        os.replace(tmp, path)
        LOGGER.debug(f"BAM index cache written: {path}")
    except OSError as e:
        LOGGER.debug(f"BAM index cache not written ({e})")
        try:
            os.unlink(tmp)
        except (OSError, UnboundLocalError):
            pass


def read_is_primary(read):
    return not (read.is_supplementary or read.is_secondary)


def strands_match(strand, bam_read):
    if strand == "+":
        return bam_read.is_forward
    if strand == "-":
        return bam_read.is_reverse
    # None or any non-strand marker matches both
    return True


def get_parent_id(bam_read):
    try:
        return bam_read.get_tag("pi")
    except KeyError:
        return bam_read.query_name


@dataclass
class ReadIndexedBam:
    """Random access to BAM records by (parent) read id.

    The underlying scanner is constructed lazily per process (pickling an
    instance across an mp boundary transfers only the path and index).
    """

    bam_path: str
    skip_non_primary: bool = True
    req_tags: set = None
    read_id_converter: Callable = None
    parent_read_id_subset: set = None
    child_read_id_subset: set = None

    def __post_init__(self):
        self.num_reads = None
        self.num_records = 0
        self.skip_reasons = {}
        self._scanner = None
        self._bam_idx = None
        self.header = None
        self.compute_read_index()

    # pickle support: drop the open scanner
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_scanner"] = None
        return state

    def open(self):
        if self._scanner is None:
            self._scanner = FastBamScanner(self.bam_path)
            self.header = self._scanner.header
        return self

    def close(self):
        self._scanner = None


    def _admit(self, child_id, parent_id, has_req_tags, primary, tally):
        """Shared record filter for both index scans.

        Returns the index key for an accepted record or None after
        tallying the skip reason."""
        subset = self.child_read_id_subset
        if subset is not None and child_id not in subset:
            tally("Child read ID filtered")
            return None
        subset = self.parent_read_id_subset
        if subset is not None and parent_id not in subset:
            tally("Parent read ID filtered")
            return None
        if self.read_id_converter is not None:
            parent_id = self.read_id_converter(parent_id)
        if not has_req_tags:
            tally("Missing BAM tags")
            return None
        if self.skip_non_primary and not primary:
            tally("Non-primary alignment")
            return None
        return parent_id

    def _finish_index(self, bam_idx, skip_reasons, suffix=""):
        self._bam_idx = bam_idx
        self.num_records = sum(len(ptrs) for ptrs in bam_idx.values())
        self.skip_reasons = skip_reasons
        self.num_reads = len(bam_idx)
        LOGGER.debug(
            f"Indexed {self.num_records} records / {self.num_reads} reads "
            f"from {self.bam_path}{suffix}"
        )

    def compute_read_index(self):
        if self._compute_read_index_native():
            return
        self.open()
        bam_idx = {}
        skip_reasons = {}

        def tally(reason):
            skip_reasons[reason] = skip_reasons.get(reason, 0) + 1

        for read_ptr, read in self._scanner.iter_with_offsets():
            if self.req_tags is None:
                has_req = True
            else:
                present = {t for t, _tc, _v in read.tags}
                has_req = self.req_tags <= present
            key = self._admit(
                read.query_name,
                get_parent_id(read),
                has_req,
                read_is_primary(read),
                tally,
            )
            if key is not None:
                bam_idx.setdefault(key, []).append(read_ptr)
        self._finish_index(bam_idx, skip_reasons)

    def fetch(self, ctg, start, end, strand=None):
        """Region query (reference ``ReadIndexedBam.fetch`` analog)."""
        self.open()
        if not hasattr(self, "_region_index") or self._region_index is None:
            by_ref = {}
            for rec in self._scanner:
                if rec.is_unmapped:
                    continue
                by_ref.setdefault(rec.reference_name, []).append(rec)
            for recs in by_ref.values():
                recs.sort(key=lambda r: r.reference_start)
            self._region_index = by_ref
        for rec in self._region_index.get(ctg, []):
            if rec.reference_start >= end:
                break
            if rec.reference_end > start and strands_match(strand, rec):
                yield rec

    def _compute_read_index_native(self):
        """Index via the C++ whole-file scan (io.native.bam_scan_index);
        returns False to fall back to the Python record decode.

        The pre-filter scan columns persist under the user cache dir
        (see ``_index_cache_path`` — never beside the BAM) so repeated
        pipeline runs over the same file skip the whole-file scan — it
        was ~3s of spinup per streaming-infer invocation on the
        400-read bench set."""
        req_key = ",".join(sorted(self.req_tags or ()))
        suffix = " (cached index)"
        res = _load_index_cache(self.bam_path, req_key)
        if res is None:
            from remora_tpu_torch.io.native import bam_scan_index

            suffix = " (native scan)"
            try:
                res = bam_scan_index(
                    self.bam_path, tuple(sorted(self.req_tags or ()))
                )
            except Exception as e:
                LOGGER.debug(f"native index scan failed: {e}")
                return False
            if res is None:
                return False
            _save_index_cache(self.bam_path, req_key, res)
        offsets, flags, names, pis, has_req = res
        bam_idx = {}
        skip_reasons = {}

        def tally(reason):
            skip_reasons[reason] = skip_reasons.get(reason, 0) + 1

        for off, flag, name, pi, hr in zip(
            offsets, flags, names, pis, has_req
        ):
            key = self._admit(
                name,
                name if pi is None else pi,
                bool(hr) or not self.req_tags,
                not flag & 0x900,
                tally,
            )
            if key is not None:
                bam_idx.setdefault(key, []).append(int(off))
        self._finish_index(bam_idx, skip_reasons, suffix=suffix)
        return True

    def get_alignments(self, read_id):
        if self._bam_idx is None:
            raise RemoraError("Bam index not yet computed")
        self.open()
        try:
            read_ptrs = self._bam_idx[read_id]
        except KeyError:
            raise RemoraError(f"Could not find {read_id} in {self.bam_path}")
        for ptr in read_ptrs:
            yield self._scanner.record_at(ptr)

    def get_first_alignment(self, read_id):
        return next(self.get_alignments(read_id))

    def __contains__(self, read_id):
        return read_id in self._bam_idx

    def __getitem__(self, read_id):
        return self._bam_idx[read_id]

    @property
    def read_ids(self):
        return list(self._bam_idx.keys())

    def __iter__(self):
        self.open()
        return iter(self._scanner)


def get_read_ids(bam_idx, pod5_dr, num_reads, return_num_bam_reads=False):
    """Read ids present in both the BAM index and the POD5 file."""
    LOGGER.info("Extracting read IDs from POD5")
    shared = set(pod5_dr.read_ids) & set(bam_idx.read_ids)
    shared = list(shared)
    n_shared_records = sum(len(bam_idx[rid]) for rid in shared)
    if bam_idx.num_records:
        pct = n_shared_records / bam_idx.num_records
        LOGGER.info(
            f"Found {bam_idx.num_records:,} valid BAM records. Found signal "
            f"in POD5 for {pct:.2%} of BAM records."
        )
    available = n_shared_records if return_num_bam_reads else len(shared)
    num_reads = available if num_reads is None else min(num_reads, available)
    return shared, num_reads
