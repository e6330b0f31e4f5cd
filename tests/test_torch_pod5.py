"""The port's POD5 codec and files against the JAX package on the CPU.

The port decodes and encodes VBZ signal (svb16, then one zstd frame)
through ``pyarrow``'s zstd codec alone, at the content size that the
frame's header declares (``io.pod5.zstd_content_size``); it never
imports ``zstandard``. Here its frames and files are held to the JAX
package's, which use ``zstandard``: each package reads the other's
frames and files to identical reads, and with ``zstandard`` blocked the
port writes and reads a file and its streaming driver gives the JAX
driver's f32 tags on it."""

import struct
import sys
import uuid

import numpy as np
import pytest
import zstandard

from remora_tpu.io import pod5 as jax_pod5
from remora_tpu.io.pod5_write import Pod5Writer as JaxPod5Writer
from remora_tpu_torch import RemoraError
from remora_tpu_torch.io import pod5 as port_pod5
from remora_tpu_torch.io.pod5_write import SIGNAL_CHUNK
from remora_tpu_torch.io.pod5_write import Pod5Writer as PortPod5Writer

from tests.test_torch_infer_pipeline import (assert_identical_outputs,
                                             run_jax, run_port, write_model)
from tests.test_torch_io import jax_native_loaded  # noqa: F401 (autouse)
from tests.test_torch_io import write_test_set

WRITERS = {"jax": JaxPod5Writer, "port": PortPod5Writer}
READERS = {"jax": jax_pod5.DatasetReader, "port": port_pod5.DatasetReader}
MAGIC = b"\x28\xb5\x2f\xfd"


def zstd_header(size, fcs_len, single, dict_len=0, dict_id=0x01020304):
    """A zstd frame header declaring ``size`` in a content-size field of
    ``fcs_len`` bytes (0: none), single segment or with a window byte, and
    a dictionary ID of ``dict_len`` bytes."""
    if fcs_len == 1:
        assert single
    fcs_flag = {0: 0, 1: 0, 2: 1, 4: 2, 8: 3}[fcs_len]
    did_flag = {0: 0, 1: 1, 2: 2, 4: 3}[dict_len]
    out = MAGIC + bytes([fcs_flag << 6 | single << 5 | did_flag])
    if not single:
        out += bytes([0x58])  # window 2^21
    out += (dict_id & (1 << 8 * dict_len) - 1).to_bytes(dict_len, "little")
    stored = size - 256 if fcs_len == 2 else size
    return out + stored.to_bytes(fcs_len, "little")


HEADER_CASES = [
    (size, fcs_len, single, dict_len)
    for fcs_len, sizes in ((1, (0, 7, 255)), (2, (256, 1000, 65791)),
                           (4, (65792, 5_000_000, 2**32 - 1)),
                           (8, (2**32, 2**40 + 5)))
    for size in sizes
    for single in ((1,) if fcs_len == 1 else (0, 1))
    for dict_len in (0, 1, 2, 4)
]


@pytest.mark.parametrize("size,fcs_len,single,dict_len", HEADER_CASES)
def test_zstd_content_size_every_field_width(size, fcs_len, single,
                                             dict_len):
    """The size parsed from a header at every field width, single segment
    or windowed, with and without a dictionary ID, is the size written and
    the one ``zstandard``'s own header parser reads."""
    header = zstd_header(size, fcs_len, single, dict_len)
    params = zstandard.get_frame_parameters(header)
    assert params.content_size == size
    assert params.dict_id == 0x01020304 & (1 << 8 * dict_len) - 1
    assert params.has_checksum is False
    assert port_pod5.zstd_content_size(header) == size
    assert port_pod5.zstd_content_size(header + b"\x00" * 9) == size


@pytest.mark.parametrize("n", [0, 1, 100, 255, 256, 70_000, 300_000])
def test_zstd_content_size_of_real_frames(n):
    """Frames written by ``zstandard`` (levels 1 and 3) and by the port's
    ``pyarrow`` encoder declare their input's size, which the port parses
    and decodes at."""
    import pyarrow as pa

    raw = np.random.default_rng(n).integers(0, 40, n, np.uint8).tobytes()
    frames = [zstandard.ZstdCompressor(level=lv).compress(raw)
              for lv in (1, 3)]
    frames.append(pa.Codec("zstd", compression_level=1).compress(
        raw, asbytes=True))
    for frame in frames:
        assert port_pod5.zstd_content_size(frame) == n
        assert pa.Codec("zstd").decompress(
            frame, decompressed_size=n, asbytes=True) == raw


def test_frame_without_content_size_raises():
    """No fallback: a frame that declares no size, or is not a zstd
    frame, or whose size cannot hold the row's samples raises
    ``RemoraError`` naming the read."""
    signal = np.arange(50, dtype=np.int16)  # 7 key bytes, 50 payload
    payload = port_pod5.svb16_encode(signal)
    no_size = zstandard.ZstdCompressor(
        level=1, write_content_size=False).compress(payload)
    assert zstandard.get_frame_parameters(no_size).content_size == (
        zstandard.CONTENTSIZE_UNKNOWN)
    with pytest.raises(RemoraError, match="declares no content size"):
        port_pod5.zstd_content_size(no_size)
    with pytest.raises(RemoraError, match="read r-1: .*no content size"):
        port_pod5.vbz_decode(no_size, signal.size, "r-1")
    frame = port_pod5.vbz_encode(signal)
    with pytest.raises(RemoraError, match="read r-2 is not a zstd frame"):
        port_pod5.vbz_decode(b"\x00" + frame[1:], signal.size, "r-2")
    with pytest.raises(RemoraError, match="read r-3: .*cannot hold 51"):
        port_pod5.vbz_decode(frame, signal.size + 1, "r-3")
    # a declared size within the bounds, but not the payload's
    with pytest.raises(RemoraError, match="read r-4"):
        port_pod5.vbz_decode(frame, signal.size - 1, "r-4")
    with pytest.raises(RemoraError, match="truncated zstd header"):
        port_pod5.zstd_content_size(zstd_header(70_000, 4, 0)[:-1])
    assert np.array_equal(port_pod5.vbz_decode(frame, signal.size), signal)


def _signal(rng, n, two_byte=True):
    """int16 DACs whose deltas need two svb16 bytes (|delta| > 127) when
    ``two_byte``, else one."""
    hi = 2000 if two_byte else 60
    return np.cumsum(rng.integers(-hi, hi + 1, n)).astype(np.int16)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, SIGNAL_CHUNK])
@pytest.mark.parametrize("two_byte", [False, True])
def test_vbz_frames_cross_decode(n, two_byte):
    """The port decodes the JAX package's frames and the JAX package the
    port's, each to the DACs encoded, bit for bit."""
    signal = _signal(np.random.default_rng(n + two_byte), n, two_byte)
    for encode, decode in ((jax_pod5.vbz_encode, port_pod5.vbz_decode),
                           (port_pod5.vbz_encode, jax_pod5.vbz_decode),
                           (port_pod5.vbz_encode, port_pod5.vbz_decode)):
        got = decode(encode(signal), n)
        assert got.dtype == np.int16 and np.array_equal(got, signal)
    assert np.array_equal(
        port_pod5.vbz_decode(jax_pod5.vbz_encode(signal), n),
        jax_pod5.vbz_decode(jax_pod5.vbz_encode(signal), n))


def synth_reads(seed=3):
    """(read id, int16 DACs, offset, scale) of reads that cover an empty
    signal, one of 250,000 samples (three signal-table rows), one-byte and
    two-byte deltas."""
    rng = np.random.default_rng(seed)
    lengths = [0, 1, 4000, 250_000, SIGNAL_CHUNK, 777]
    return [
        (str(uuid.UUID(bytes=rng.bytes(16), version=4)),
         _signal(rng, n, two_byte=i % 2 == 1),
         float(rng.uniform(-300, 300)), float(rng.uniform(0.5, 40)))
        for i, n in enumerate(lengths)
    ]


def write_pod5(writer, path, reads, sample_rate=5000):
    with WRITERS[writer](str(path), sample_rate=sample_rate) as p5w:
        for rid, signal, offset, scale in reads:
            p5w.add_read(rid, signal, offset, scale)
    return str(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_cross_read(tmp_path, writer):
    """A file written by either package's ``Pod5Writer`` reads in both
    packages' ``DatasetReader`` to identical reads: ids, int16 signal bit
    for bit, calibration (the float32 values the file stores), sample
    rate and sample count; the long read spans three signal rows."""
    reads = synth_reads()
    path = write_pod5(writer, tmp_path / f"{writer}.pod5", reads)
    got = {}
    for reader, cls in READERS.items():
        with cls(path) as rdr:
            assert rdr.read_ids == [r[0] for r in reads]
            got[reader] = list(rdr.reads())
            long_row = rdr._readers[0]._rid_to_row[reads[3][0]]
            assert len(rdr._readers[0]._sig_rows[long_row]) == 3
            mid = rdr.get_read(reads[2][0])
            assert np.array_equal(mid.signal, reads[2][1])
    for (rid, signal, offset, scale), g, j in zip(reads, got["port"],
                                                   got["jax"]):
        for rec in (g, j):
            assert rec.read_id == rid
            assert rec.signal.dtype == np.int16
            assert np.array_equal(rec.signal, signal)
            assert rec.num_samples == signal.size
            assert rec.sample_rate == 5000
            assert rec.calibration.offset == -float(np.float32(-offset))
            assert rec.calibration.scale == 1.0 / float(
                np.float32(1.0 / scale))
        assert (g.calibration.offset, g.calibration.scale) == (
            j.calibration.offset, j.calibration.scale)


def test_port_writer_matches_jax_writer(tmp_path):
    """Both writers lay out the same tables: the port's file and the JAX
    package's, written from the same reads, list the same embedded files
    in the same order and decode to the same reads; the footer names the
    writing package."""
    reads = synth_reads(seed=4)
    files = {w: write_pod5(w, tmp_path / f"{w}.pod5", reads)
             for w in WRITERS}
    layout = {}
    for w, path in files.items():
        buf = open(path, "rb").read()
        layout[w] = [ctype for _o, _l, ctype in port_pod5.parse_footer(buf)]
        software = b"remora_tpu_torch" if w == "port" else b"remora_tpu\x00"
        assert software in buf
    assert layout["port"] == layout["jax"] == [1, 4, 0]
    with port_pod5.DatasetReader(files["port"]) as a, \
            port_pod5.DatasetReader(files["jax"]) as b:
        for x, y in zip(a.reads(), b.reads(), strict=True):
            assert x.read_id == y.read_id
            assert np.array_equal(x.signal, y.signal)
            assert x.calibration == y.calibration


def test_port_round_trip_and_driver_without_zstandard(tmp_path,
                                                      monkeypatch):
    """With ``zstandard`` blocked, the port writes a file of the shared
    synthetic set's reads, reads it back bit for bit, and its streaming
    driver writes on that file the f32 tags that the JAX driver writes on
    it once ``zstandard`` is back."""
    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE", "0")
    sub = tmp_path / "set"
    sub.mkdir()
    pod5_dir, bam = write_test_set(sub)
    with jax_pod5.DatasetReader(pod5_dir) as rdr:
        src = list(rdr.reads())
        sample_rate = rdr._readers[0].sample_rate
    model = write_model(tmp_path, "size16.npz")
    path = str(tmp_path / "port_written.pod5")
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "zstandard", None)
        with pytest.raises(ImportError):
            import zstandard as _blocked  # noqa: F401
        with PortPod5Writer(path, sample_rate=sample_rate) as p5w:
            for rec in src:
                p5w.add_read(rec.read_id, rec.signal,
                             rec.calibration.offset, rec.calibration.scale)
        with port_pod5.DatasetReader(path) as rdr:
            back = list(rdr.reads())
        assert [r.read_id for r in back] == [r.read_id for r in src]
        for got, want in zip(back, src):
            assert np.array_equal(got.signal, want.signal)
            assert (got.calibration.offset, got.calibration.scale) == (
                want.calibration.offset, want.calibration.scale)
        n_port, tally_port = run_port(path, bam, model,
                                      tmp_path / "port.bam")
        assert sys.modules["zstandard"] is None
    n_jax, tally_jax = run_jax(path, bam, model, tmp_path / "jax.bam")
    assert n_port == n_jax > 0 and tally_port == tally_jax
    want, n_calls = assert_identical_outputs(tmp_path / "port.bam",
                                             tmp_path / "jax.bam")
    assert len(want) == n_jax and n_calls > 0


def test_footer_fields_parse():
    """``_build_footer``'s flatbuffer gives back the embedded files it was
    given, in order, through ``parse_footer``."""
    from remora_tpu_torch.io.pod5_write import _build_footer

    contents = [(24, 1000, 1), (1024, 2000, 4), (3024, 512, 0)]
    footer = _build_footer(str(uuid.uuid4()), "remora_tpu_torch", "0.2.8",
                           contents)
    sig = port_pod5.POD5_SIGNATURE
    buf = (sig + b"\x00" * 16 + footer + struct.pack("<q", len(footer))
           + b"\x00" * 16 + sig)
    assert port_pod5.parse_footer(buf) == contents
