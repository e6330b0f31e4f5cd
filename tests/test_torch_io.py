"""The port's host readers and writers against the JAX package's on the
CPU: POD5 reads, BAM records and headers, the read-id BAM index (native
and Python scans), the signal/alignment join into ``io.Read`` and
``RemoraRead``, the BAM writer both ways, and the sequence, coordinate
and metric helpers. Everything is held identical, with no tolerance.

``write_test_set`` is the synthetic set the streaming-infer tests share:
``benchmarks/synth_set.py::write_synth_set`` reads plus a second POD5
file of reads whose records cover what the synthetic set does not (a
reverse-strand record with soft clips, an insertion, a deletion and a
mismatch; a split-read child with ``pi``/``sp``; a record without
``sm``/``sd``; a secondary alignment; a record without a move table)."""

import dataclasses
import shutil
import time
import uuid

import numpy as np
import pytest

from benchmarks.synth_set import synth_read, write_synth_set
from remora_tpu.core import coords as jax_coords
from remora_tpu.core import metrics as jax_metrics
from remora_tpu.core import seq as jax_seq
from remora_tpu.io import bam as jax_bam
from remora_tpu.io import bgzf as jax_bgzf
from remora_tpu.io import pod5 as jax_pod5
from remora_tpu.io import read as jax_read
from remora_tpu.io import read_index as jax_index
from remora_tpu.io import refregion as jax_refregion
from remora_tpu.io.pod5_write import Pod5Writer
from remora_tpu_torch.core import coords, metrics
from remora_tpu_torch.core import seq as seq_mod
from remora_tpu_torch.io import bam, bgzf, native, pod5, read, read_index
from remora_tpu_torch.io import refregion

N_READS, N_BASES = 8, 600


def load_jax_native(wait_s=300):
    """Load the JAX package's host library in this process. Its loader
    compiles in place, and the test processes each build it when they
    find none; one that opens the file while another process is still
    writing it caches the failure for good (and takes the NumPy paths,
    or a forked stage loads the half-written file). Retry until the
    finished file loads."""
    from remora_tpu.io import native as jax_native

    deadline = time.monotonic() + wait_s
    while jax_native.get_lib() is None:
        if time.monotonic() > deadline:
            raise RuntimeError("the JAX package's host library does not "
                               "load")
        time.sleep(1.0)
        jax_native._BUILD_FAILED = False


@pytest.fixture(scope="module", autouse=True)
def jax_native_loaded():
    """Every module that compares with the JAX package's host library, or
    runs its drivers (whose forked stages inherit the loaded library),
    imports this fixture."""
    load_jax_native()


def _record(header, rid, seq, s2s, *, flag=0, ref_start=0, cigar=None,
            md=None, extra_tags=(), sm_sd=True, with_moves=True):
    """A BamRecord of the JAX package for a read whose basecalls ``seq``
    (read orientation) map to signal through ``s2s``; the stored query is
    reverse-complemented for a reverse-strand ``flag``."""
    stored = jax_seq.revcomp(seq) if flag & 16 else seq
    mv = np.zeros(int(s2s[-1] - s2s[0]), dtype=np.uint8)
    mv[s2s[:-1] - s2s[0]] = 1
    tags = [("MD", "Z", md if md is not None else str(len(seq)))]
    if sm_sd:
        tags += [("sm", "f", 0.0), ("sd", "f", 1.0)]
    tags += list(extra_tags)
    if with_moves:
        tags.append(("mv", "Bc", np.concatenate([[1], mv]).astype(np.int8)))
    return jax_bam.BamRecord(
        query_name=rid,
        flag=flag,
        reference_id=0,
        reference_start=ref_start,
        mapq=60,
        cigartuples=cigar or [(0, len(seq))],
        query_sequence=stored,
        query_qualities=np.full(len(seq), 30, np.uint8),
        tags=tags,
        header=header,
    )


def write_test_set(out_dir, n_reads=N_READS, n_bases=N_BASES, seed=17):
    """The synthetic set: returns (POD5 directory, BAM path)."""
    synth_dir = out_dir / "synth"
    pod5_dir = out_dir / "pod5"
    synth_dir.mkdir()
    pod5_dir.mkdir()
    synth_pod5, synth_bam = write_synth_set(
        str(synth_dir), n_reads=n_reads, n_bases=n_bases, seed=seed
    )
    shutil.copy(synth_pod5, pod5_dir / "reads.pod5")
    scanner = jax_bam.FastBamScanner(synth_bam)
    header = scanner.header
    records = list(scanner)
    rng = np.random.default_rng(seed + 1)
    ref_base = (n_bases + 1000) * n_reads
    with Pod5Writer(str(pod5_dir / "extra.pod5")) as p5w:
        # reverse strand: soft clips, an insertion, a deletion, a mismatch
        rid = str(uuid.uuid4())
        int_seq, s2s, dacs = synth_read(rng, n_bases)
        p5w.add_read(rid, dacs, 90.0, 20.0)
        seq = jax_seq.int_to_seq(int_seq)
        rest = n_bases - 20 - 200 - 3 - 150 - 15
        cigar = [(4, 20), (0, 200), (1, 3), (0, 150), (2, 4), (0, rest),
                 (4, 15)]
        stored = jax_seq.revcomp(seq)
        mism = "A" if stored[20 + 100] != "A" else "C"
        md = f"100{mism}249^ACGT{rest}"
        records.append(_record(header, rid, seq, s2s, flag=16,
                               ref_start=ref_base, cigar=cigar, md=md))
        # a secondary alignment of the same read
        records.append(_record(header, rid, seq, s2s, flag=16 | 256,
                               ref_start=ref_base + 5000, cigar=cigar,
                               md=md))
        # split-read child: its signal starts 300 samples into the parent's
        parent = str(uuid.uuid4())
        int_seq, s2s, dacs = synth_read(rng, n_bases)
        lead = rng.integers(60, 120, 300).astype(np.int16)
        p5w.add_read(parent, np.concatenate([lead, dacs]), 90.0, 20.0)
        records.append(_record(
            header, str(uuid.uuid4()), jax_seq.int_to_seq(int_seq), s2s,
            ref_start=ref_base + 10_000,
            extra_tags=[("pi", "Z", parent), ("sp", "i", 300)],
        ))
        # no sm/sd: the norm scaling comes from the signal's median/MAD
        rid = str(uuid.uuid4())
        int_seq, s2s, dacs = synth_read(rng, n_bases)
        p5w.add_read(rid, dacs, 90.0, 20.0)
        records.append(_record(header, rid, jax_seq.int_to_seq(int_seq),
                               s2s, ref_start=ref_base + 15_000,
                               sm_sd=False))
        # no move table: skipped by the index
        rid = str(uuid.uuid4())
        int_seq, s2s, dacs = synth_read(rng, 200)
        p5w.add_read(rid, dacs, 90.0, 20.0)
        records.append(_record(header, rid, jax_seq.int_to_seq(int_seq),
                               s2s, ref_start=ref_base + 20_000,
                               with_moves=False))
    bam_path = out_dir / "reads.bam"
    with jax_bam.BamWriter(str(bam_path), header) as bw:
        for rec in records:
            bw.write(rec)
    return str(pod5_dir), str(bam_path)


@pytest.fixture(scope="module")
def test_set(tmp_path_factory):
    return write_test_set(tmp_path_factory.mktemp("torch_io"))


@pytest.fixture(autouse=True)
def _no_index_cache(monkeypatch):
    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE", "0")


def _plain(value):
    """A comparable form of a record field or tag value."""
    if isinstance(value, np.ndarray):
        return (value.dtype.str, value.tolist())
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


def _record_fields(rec):
    return {
        f.name: _plain(getattr(rec, f.name))
        for f in dataclasses.fields(rec)
        if f.name != "header"
    }


def _header_fields(header):
    return (header.text, list(header.references), list(header.lengths))


def test_pod5_reads_match(test_set):
    pod5_dir, _bam = test_set
    with jax_pod5.DatasetReader(pod5_dir) as jdr, \
            pod5.DatasetReader(pod5_dir) as tdr:
        assert tdr.read_ids == jdr.read_ids
        assert len(tdr.read_ids) == N_READS + 4
        want = list(jdr.reads())
        got = list(tdr.reads())
        sel = tdr.read_ids[::3]
        assert ([r.read_id for r in tdr.reads(selection=sel)]
                == [r.read_id for r in jdr.reads(selection=sel)])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.read_id == w.read_id
        assert g.signal.dtype == w.signal.dtype
        assert np.array_equal(g.signal, w.signal)
        assert dataclasses.asdict(g.calibration) == dataclasses.asdict(
            w.calibration)
        assert (g.sample_rate, g.num_samples) == (w.sample_rate,
                                                  w.num_samples)


def test_vbz_codec_matches():
    rng = np.random.default_rng(5)
    sig = rng.integers(-3000, 3000, 4097).astype(np.int16)
    blob = jax_pod5.vbz_encode(sig)
    assert pod5.vbz_encode(sig) == blob
    assert np.array_equal(pod5.vbz_decode(blob, sig.size), sig)
    assert np.array_equal(pod5.vbz_decode(blob, sig.size),
                          jax_pod5.vbz_decode(blob, sig.size))


def test_bam_records_match(test_set):
    _pod5, bam_path = test_set
    want = list(jax_bam.FastBamScanner(bam_path).iter_with_offsets())
    scanner = bam.FastBamScanner(bam_path)
    got = list(scanner.iter_with_offsets())
    assert _header_fields(scanner.header) == _header_fields(
        jax_bam.FastBamScanner(bam_path).header)
    assert len(got) == len(want) == N_READS + 5
    for (g_off, g), (w_off, w) in zip(got, want):
        assert g_off == w_off
        assert _record_fields(g) == _record_fields(w)
        assert _record_fields(scanner.record_at(g_off)) == _record_fields(w)
        assert g.tag_dict().keys() == w.tag_dict().keys()
        assert (g.is_reverse, g.is_secondary, g.reference_end) == (
            w.is_reverse, w.is_secondary, w.reference_end)
        assert g.get_reference_sequence() == w.get_reference_sequence()
        assert g.to_sam_line() == w.to_sam_line()
    # the streaming reader (virtual offsets) agrees too
    streamed = [_record_fields(r) for r in bam.BamReader(bam_path)]
    assert streamed == [_record_fields(w) for _o, w in want]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_bam_writer_round_trip(test_set, tmp_path, direction):
    _pod5, bam_path = test_set
    src_mod, dst_mod = (bam, jax_bam) if direction == "port_to_jax" else (
        jax_bam, bam)
    scanner = src_mod.FastBamScanner(bam_path)
    recs = list(scanner)
    recs[0].set_tag("MM", "Z", "C+m?,0,1;")
    recs[0].set_tag("ML", "BC", np.array([3, 250], np.uint8))
    out = tmp_path / "out.bam"
    with src_mod.BamWriter(str(out), scanner.header) as bw:
        for rec in recs:
            bw.write(rec)
    back = dst_mod.FastBamScanner(str(out))
    assert _header_fields(back.header) == _header_fields(scanner.header)
    assert [_record_fields(r) for r in back] == [
        _record_fields(r) for r in recs]
    # both writers write the same bytes for the same records
    twin = tmp_path / "twin.bam"
    with dst_mod.BamWriter(str(twin), scanner.header) as bw:
        for rec in recs:
            bw.write(rec)
    assert twin.read_bytes() == out.read_bytes()


def test_bgzf_matches(tmp_path):
    rng = np.random.default_rng(2)
    payload = rng.integers(0, 255, 200_000, dtype=np.uint8).tobytes()
    paths = []
    for mod in (bgzf, jax_bgzf):
        path = tmp_path / f"{mod.__name__}.gz"
        with mod.BgzfWriter(str(path)) as w:
            w.write(payload[:70_000])
            w.write(payload[70_000:])
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert bgzf.decompress_all(str(paths[1])) == payload
    rdr, jrdr = bgzf.BgzfReader(str(paths[0])), jax_bgzf.BgzfReader(
        str(paths[0]))
    assert rdr.read(100_000) == jrdr.read(100_000)
    assert rdr.tell() == jrdr.tell()


def _index_fields(idx):
    return (
        {rid: list(idx[rid]) for rid in idx.read_ids},
        dict(idx.skip_reasons),
        idx.num_records,
        idx.num_reads,
    )


@pytest.mark.parametrize("skip_non_primary", [True, False])
def test_read_index_native_and_python_scan(test_set, monkeypatch,
                                           skip_non_primary):
    """The port's index comes from its own native scan (where g++ is
    present) and equals its Python scan and the JAX package's index."""
    _pod5, bam_path = test_set
    kwargs = dict(skip_non_primary=skip_non_primary, req_tags={"mv"})
    want = _index_fields(jax_index.ReadIndexedBam(bam_path, **kwargs))
    scans = []
    real = native.bam_scan_index

    def counted(*args, **kw):
        res = real(*args, **kw)
        scans.append(res is not None)
        return res

    monkeypatch.setattr(native, "bam_scan_index", counted)
    got = read_index.ReadIndexedBam(bam_path, **kwargs)
    if shutil.which("g++"):
        assert scans == [True]
    assert _index_fields(got) == want
    monkeypatch.setattr(read_index.ReadIndexedBam,
                        "_compute_read_index_native", lambda self: False)
    assert _index_fields(read_index.ReadIndexedBam(bam_path, **kwargs)) == (
        want)
    assert want[1] == ({"Missing BAM tags": 1, "Non-primary alignment": 1}
                       if skip_non_primary else {"Missing BAM tags": 1})


def test_native_scan_columns_match(test_set):
    if not shutil.which("g++"):
        pytest.skip("no g++ to build the native library")
    _pod5, bam_path = test_set
    from remora_tpu.io import native as jax_native

    got = native.bam_scan_index(bam_path, ("mv",))
    want = jax_native.bam_scan_index(bam_path, ("mv",))
    assert got is not None and want is not None
    assert [_plain(np.asarray(c)) if isinstance(c, np.ndarray) else c
            for c in got] == [
        _plain(np.asarray(c)) if isinstance(c, np.ndarray) else c
        for c in want]


def test_read_index_cache(test_set, tmp_path, monkeypatch):
    """The index cache lives under REMORA_TPU_BAM_INDEX_CACHE_DIR, never
    beside the BAM, serves a second index, and is off when
    REMORA_TPU_BAM_INDEX_CACHE=0."""
    _pod5, bam_path = test_set
    cache_dir = tmp_path / "cache"
    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE", "1")
    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE_DIR", str(cache_dir))
    beside = set(p.name for p in tmp_path.parent.iterdir())
    first = read_index.ReadIndexedBam(bam_path, req_tags={"mv"})
    if not shutil.which("g++"):
        pytest.skip("no g++: the cache holds native scans only")
    cached = list(cache_dir.iterdir())
    assert len(cached) == 1 and cached[0].name.endswith(".rtidx.npz")
    assert set(p.name for p in tmp_path.parent.iterdir()) == beside
    monkeypatch.setattr(native, "bam_scan_index", None)  # must not scan
    second = read_index.ReadIndexedBam(bam_path, req_tags={"mv"})
    assert _index_fields(second) == _index_fields(first)
    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE", "0")
    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE_DIR",
                       str(tmp_path / "off"))
    monkeypatch.undo()
    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE", "0")
    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE_DIR",
                       str(tmp_path / "off"))
    read_index.ReadIndexedBam(bam_path, req_tags={"mv"})
    assert not (tmp_path / "off").exists()


def test_get_read_ids(test_set):
    pod5_dir, bam_path = test_set
    jidx = jax_index.ReadIndexedBam(bam_path, req_tags={"mv"})
    tidx = read_index.ReadIndexedBam(bam_path, req_tags={"mv"})
    for num_reads in (None, 3):
        with jax_pod5.DatasetReader(pod5_dir) as jdr, \
                pod5.DatasetReader(pod5_dir) as tdr:
            want_ids, want_n = jax_index.get_read_ids(jidx, jdr, num_reads)
            got_ids, got_n = read_index.get_read_ids(tidx, tdr, num_reads)
        assert sorted(got_ids) == sorted(want_ids)
        assert got_n == want_n
    assert want_n == 3 and len(want_ids) == N_READS + 3


_READ_FIELDS = (
    "read_id", "dacs", "seq", "stride", "mv_table", "query_to_signal",
    "shift_dacs_to_pa", "scale_dacs_to_pa", "shift_pa_to_norm",
    "scale_pa_to_norm", "shift_dacs_to_norm", "scale_dacs_to_norm",
    "shift_pa_to_zc_pa", "scale_pa_to_zc_pa", "ref_seq", "cigar",
    "ref_to_signal", "child_read_id", "sig_len", "seq_len",
    "ref_seq_len",
)


def _read_fields(io_read):
    out = {name: _plain(getattr(io_read, name)) for name in _READ_FIELDS}
    reg = io_read.ref_reg
    out["ref_reg"] = None if reg is None else dataclasses.astuple(reg)
    out["norm_signal"] = _plain(io_read.norm_signal)
    out["full_align"] = _record_fields(io_read.full_align)
    return out


def _joined_reads(mod, idx_mod, pod5_dir, bam_path, rev_sig=False,
                  pa_scaling=None):
    idx = idx_mod.ReadIndexedBam(bam_path, req_tags={"mv"})
    out = {}
    for read_err in mod.iter_signal(pod5_dir, rev_sig=rev_sig,
                                    pa_scaling=pa_scaling):
        for io_read, err in mod.extract_alignments(read_err, idx, rev_sig,
                                                   pa_scaling):
            out.setdefault(read_err[0].read_id, []).append((io_read, err))
    return out


@pytest.mark.parametrize("pa_scaling", [None, (95.0, 18.0)])
def test_extract_alignments_match(test_set, pa_scaling):
    pod5_dir, bam_path = test_set
    want = _joined_reads(jax_read, jax_index, pod5_dir, bam_path,
                         pa_scaling=pa_scaling)
    got = _joined_reads(read, read_index, pod5_dir, bam_path,
                        pa_scaling=pa_scaling)
    assert got.keys() == want.keys()
    assert len(want) == N_READS + 4
    for rid in want:
        assert len(got[rid]) == len(want[rid])
        for (g, g_err), (w, w_err) in zip(got[rid], want[rid]):
            assert g_err == w_err
            if w_err is None:
                assert _read_fields(g) == _read_fields(w)
    reverse = [w for rs in want.values() for w, _e in rs
               if w.full_align is not None and w.full_align.is_reverse]
    assert len(reverse) == 1 and reverse[0].ref_reg.strand == "-"


@pytest.mark.parametrize("ref_anchored", [False, True])
def test_into_remora_read_match(test_set, ref_anchored):
    pod5_dir, bam_path = test_set
    want = _joined_reads(jax_read, jax_index, pod5_dir, bam_path)
    got = _joined_reads(read, read_index, pod5_dir, bam_path)
    n = 0
    for rid in want:
        for (g, g_err), (w, _e) in zip(got[rid], want[rid]):
            if g_err is not None:
                continue
            wr = w.into_remora_read(ref_anchored)
            gr = g.into_remora_read(ref_anchored)
            for name in ("read_id", "dacs", "shift", "scale",
                         "seq_to_sig_map", "int_seq", "str_seq"):
                assert _plain(getattr(gr, name)) == _plain(
                    getattr(wr, name)), name
            n += 1
    assert n == N_READS + 3


_SEQ_CASES = {
    "comp": ("ACGTNacgtRYKMBVDH",),
    "revcomp": ("ACGTNacgtRYKMBVDH",),
    "u_to_t": ("ACGUuN",),
    "t_to_u": ("ACGTtN",),
    "comp_int": (np.array([0, 1, 2, 3, 3, 0]),),
    "revcomp_int": (np.array([0, 1, 2, 3, 3, 0]),),
    "get_can_converter": ("ACaGTm", "ACAGTC"),
    "get_mod_bases": ("ACaGTm", "ACAGTC"),
}


@pytest.mark.parametrize("name", sorted(_SEQ_CASES))
def test_seq_helpers_match(name):
    args = _SEQ_CASES[name]
    got = getattr(seq_mod, name)(*args)
    want = getattr(jax_seq, name)(*args)
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("control", [False, True])
def test_validate_mod_bases_match(control):
    args = (["m", "h"], "ACmhGT", "ACCCGT")
    got = seq_mod.validate_mod_bases(
        args[0], [seq_mod.Motif("CG", 0)], *args[1:], control=control)
    want = jax_seq.validate_mod_bases(
        args[0], [jax_seq.Motif("CG", 0)], *args[1:], control=control)
    assert _plain(got) == _plain(want)
    with pytest.raises(Exception, match="canonical equivalent"):
        seq_mod.validate_mod_bases(["a"], [seq_mod.Motif("CG", 0)],
                                   "ACaGT", "ACAGT")


def _random_cigar(rng):
    ops = []
    for _ in range(12):
        ops.append((int(rng.choice([0, 0, 0, 1, 2, 7, 8])),
                    int(rng.integers(1, 30))))
    return [(4, 5)] + ops + [(0, 10), (4, 3)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coords_match(seed):
    rng = np.random.default_rng(seed)
    cigar = _random_cigar(rng)
    text = jax_coords.cigartuples_to_string(cigar)
    assert coords.cigartuples_to_string(cigar) == text
    assert coords.cigartuples_from_string(text) == (
        jax_coords.cigartuples_from_string(text))
    knots = coords.make_sequence_coordinate_mapping(cigar)
    assert _plain(knots) == _plain(
        jax_coords.make_sequence_coordinate_mapping(cigar))
    q_len = sum(n for op, n in cigar if op in (0, 1, 4, 7, 8))
    stride = 5
    moves = np.zeros(q_len * 3, np.uint8)
    moves[np.sort(rng.choice(np.arange(1, moves.size), q_len - 1,
                             replace=False))] = 1
    moves[0] = 1
    sig_len = moves.size * stride + 3
    for rev in (False, True):
        q2s = coords.parse_move_table(stride, moves, sig_len, seq_len=q_len,
                                      reverse_signal=rev)
        assert _plain(q2s) == _plain(jax_coords.parse_move_table(
            stride, moves, sig_len, seq_len=q_len, reverse_signal=rev))
    assert _plain(coords.compute_ref_to_signal(q2s, cigar)) == _plain(
        jax_coords.compute_ref_to_signal(q2s, cigar))
    assert _plain(coords.map_ref_to_signal(
        query_to_signal=q2s, ref_to_query_knots=knots)) == _plain(
        jax_coords.map_ref_to_signal(query_to_signal=q2s,
                                     ref_to_query_knots=knots))


@pytest.mark.parametrize("metric", sorted(jax_metrics.METRIC_FUNCS))
def test_metrics_match(metric):
    rng = np.random.default_rng(4)
    sig = rng.normal(0, 1, 2000).astype(np.float32)
    s2s = np.concatenate([[0], np.cumsum(rng.integers(0, 12, 200))])
    for kwargs in ({}, {"start_trim": 2, "end_trim": 0}):
        got = metrics.METRIC_FUNCS[metric](sig, s2s, **kwargs)
        want = jax_metrics.METRIC_FUNCS[metric](sig, s2s, **kwargs)
        assert got.keys() == want.keys()
        for key in want:
            assert np.array_equal(got[key], want[key], equal_nan=True), key


def test_refregion_match(tmp_path):
    for text, req_strand in (("chr1:101-200", False), ("ctg2:5-5000:-", True),
                             ("chrX:1-10:+", True)):
        got = refregion.RefRegion.parse_ref_region_str(text, req_strand)
        want = jax_refregion.RefRegion.parse_ref_region_str(text, req_strand)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert dataclasses.astuple(got.adjust(3, -2, ref_orient=False)) == (
            dataclasses.astuple(want.adjust(3, -2, ref_orient=False)))
    bed = tmp_path / "r.bed"
    bed.write_text("chr1\t10\t20\tn\t0\t+\nchr1\t30\t35\tn\t0\t-\n"
                   "chr2\t5\t9\n")
    got = refregion.parse_bed(str(bed))
    want = jax_refregion.parse_bed(str(bed))
    assert {k: sorted(v) for k, v in got.items()} == {
        k: sorted(v) for k, v in want.items()}
    assert [dataclasses.astuple(r) for r in refregion.parse_bed_lines(
        str(bed))] == [dataclasses.astuple(r)
                       for r in jax_refregion.parse_bed_lines(str(bed))]
