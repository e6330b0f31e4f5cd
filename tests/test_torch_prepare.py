"""The port's ``dataset prepare`` driver (``extract_chunk_dataset``, POD5
+ BAM in, chunk dataset out) against the JAX package's on the CPU.

Both drivers run on one synthetic set written with the JAX package's
writers: forward reads of ``benchmarks/synth_set.py``, a reverse-strand
read with soft clips and indels, its secondary alignment, a record
without an MD tag, a record without a move table and a read whose signal
has no alignment. Every read is under 256 bases and 4096 samples, so the
JAX package's interpret-mode DP compiles once per band bucket.

The datasets must be identical, every array and the metadata files: with
one worker and ``skip_shuffle`` in order, after the shuffle under one
``np.random.seed``, and with 3 chunk workers once sorted by (read id,
focus base). The skip tallies match, and each package loads the other's
dataset. The refiner runs off, native and on the device backend (the
port's plain K4/K5 against the JAX package's Pallas kernels in interpret
mode). Every driver run is time-bounded, since the stages fork.
"""

import shutil
import uuid

import numpy as np
import pytest

from benchmarks.synth_set import synth_read, write_synth_set
from chip_smoke import skip_tally
from remora_tpu import prepare as jax_prepare
from remora_tpu.core import seq as jax_seq
from remora_tpu.data import dataset as jax_dataset
from remora_tpu.io import bam as jax_bam
from remora_tpu.io.pod5_write import Pod5Writer
from remora_tpu_torch import prepare as port_prepare
from remora_tpu_torch.core import seq as port_seq
from remora_tpu_torch.data import dataset as port_dataset
from remora_tpu_torch.kernels import banded_dp as port_dp
from remora_tpu_torch.refine import refiner as port_refiner

from tests.test_torch_infer_pipeline import captured, time_limit
from tests.test_torch_infer_pipeline import write_rna_set
from tests.test_torch_io import _record
from tests.test_torch_io import jax_native_loaded  # noqa: F401 (autouse)
from tests.test_torch_prepare_stage import _refiners

N_READS, N_BASES = 10, 200
CHUNK_CONTEXT, KMER_CONTEXT, MIN_SAMPS_PER_BASE = (50, 50), (2, 2), 6

PACKAGES = {
    "jax": (jax_prepare, jax_seq, jax_dataset, "RemoraTPU"),
    "port": (port_prepare, port_seq, port_dataset, "RemoraTPUTorch"),
}


def write_prepare_set(out_dir, n_reads=N_READS, n_bases=N_BASES, seed=23):
    """Returns (POD5 directory, BAM path)."""
    synth_dir, pod5_dir = out_dir / "synth", out_dir / "pod5"
    synth_dir.mkdir()
    pod5_dir.mkdir()
    synth_pod5, synth_bam = write_synth_set(
        str(synth_dir), n_reads=n_reads, n_bases=n_bases, seed=seed)
    shutil.copy(synth_pod5, pod5_dir / "reads.pod5")
    scanner = jax_bam.FastBamScanner(synth_bam)
    header, records = scanner.header, list(scanner)
    rng = np.random.default_rng(seed + 1)
    ref_base = (n_bases + 1000) * n_reads
    with Pod5Writer(str(pod5_dir / "extra.pod5")) as p5w:
        # reverse strand: soft clips, an insertion, a deletion, a mismatch
        rid = str(uuid.uuid4())
        int_seq, s2s, dacs = synth_read(rng, n_bases)
        p5w.add_read(rid, dacs, 90.0, 20.0)
        seq = jax_seq.int_to_seq(int_seq)
        rest = n_bases - 10 - 80 - 2 - 60 - 8
        cigar = [(4, 10), (0, 80), (1, 2), (0, 60), (2, 3), (0, rest),
                 (4, 8)]
        stored = jax_seq.revcomp(seq)
        mism = "A" if stored[10 + 40] != "A" else "C"
        md = f"40{mism}99^ACG{rest}"
        records.append(_record(header, rid, seq, s2s, flag=16,
                               ref_start=ref_base, cigar=cigar, md=md))
        # its secondary alignment (skipped: non-primary)
        records.append(_record(header, rid, seq, s2s, flag=16 | 256,
                               ref_start=ref_base + 2000, cigar=cigar,
                               md=md))
        # no MD tag: no reference sequence
        rid = str(uuid.uuid4())
        int_seq, s2s, dacs = synth_read(rng, n_bases)
        p5w.add_read(rid, dacs, 90.0, 20.0)
        rec = _record(header, rid, jax_seq.int_to_seq(int_seq), s2s,
                      ref_start=ref_base + 4000)
        rec.tags = [t for t in rec.tags if t[0] != "MD"]
        records.append(rec)
        # no move table: skipped by the index
        rid = str(uuid.uuid4())
        int_seq, s2s, dacs = synth_read(rng, n_bases)
        p5w.add_read(rid, dacs, 90.0, 20.0)
        records.append(_record(header, rid, jax_seq.int_to_seq(int_seq),
                               s2s, ref_start=ref_base + 6000,
                               with_moves=False))
        # signal without an alignment
        int_seq, s2s, dacs = synth_read(rng, n_bases)
        p5w.add_read(str(uuid.uuid4()), dacs, 90.0, 20.0)
    bam_path = out_dir / "reads.bam"
    with jax_bam.BamWriter(str(bam_path), header) as bw:
        for rec in records:
            bw.write(rec)
    return str(pod5_dir), str(bam_path)


def run_prepare(package, pod5, bam, out, *, refiner=None, seed=None,
                mod_base_control=False, focus_ref_pos=None, **kwargs):
    """One ``extract_chunk_dataset`` run of ``package``, with the global
    NumPy RNG seeded first; returns (chunks, skip tally)."""
    prepare, seq_mod, _dataset, logger = PACKAGES[package]
    args = dict(
        mod_base=("m", "5mC"),
        mod_base_control=mod_base_control,
        motifs=[seq_mod.Motif("CG", 0)],
        focus_ref_pos=focus_ref_pos,
        chunk_context=CHUNK_CONTEXT,
        min_samps_per_base=MIN_SAMPS_PER_BASE,
        max_chunks_per_read=kwargs.pop("max_chunks_per_read", 100),
        pa_scaling=None,
        sig_map_refiner=refiner,
        kmer_context_bases=KMER_CONTEXT,
        base_start_justify=False,
        offset=0,
        num_reads=None,
    )
    kwargs.setdefault("skip_shuffle", True)
    if seed is not None:
        np.random.seed(seed)
    with time_limit(), captured(logger) as msgs:
        dataset = prepare.extract_chunk_dataset(bam, pod5, str(out),
                                                **args, **kwargs)
    return dataset.size, skip_tally(msgs)


def load(package, path):
    return PACKAGES[package][2].CoreDataset(str(path), infinite_iter=False)


def dataset_arrays(ds, sort=False):
    arrays = {name: np.asarray(getattr(ds, name)[: ds.size])
              for name in ds.array_names}
    if sort:
        order = np.lexsort((arrays["read_focus_bases"], arrays["read_ids"]))
        arrays = {name: arr[order] for name, arr in arrays.items()}
    return arrays


def metadata_files(path):
    """{name: bytes} of a dataset directory's files other than its
    arrays."""
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())
            if p.suffix != ".npy"}


def assert_same_datasets(got_path, want_path, sort=False):
    """Identical arrays (each package loading both datasets) and metadata
    files."""
    want = dataset_arrays(load("jax", want_path), sort)
    assert want["labels"].size > 0
    for package in PACKAGES:
        got = dataset_arrays(load(package, got_path), sort)
        assert got.keys() == want.keys()
        for name, arr in want.items():
            assert got[name].dtype == arr.dtype, name
            assert np.array_equal(got[name], arr), (package, name)
    assert dataset_arrays(load("port", want_path), sort).keys() == want.keys()
    if not sort:
        assert metadata_files(got_path) == metadata_files(want_path)
    return want


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_prepare")


@pytest.fixture(scope="module")
def data_set(workdir):
    sub = workdir / "set"
    sub.mkdir()
    return write_prepare_set(sub)


@pytest.fixture(scope="module")
def reference_outs(data_set, workdir):
    """The no-refiner, one-worker, in-order dataset of each package."""
    pod5, bam = data_set
    outs = {package: workdir / f"ordered_{package}" for package in PACKAGES}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REMORA_TPU_BAM_INDEX_CACHE", "0")
        mp.setenv("LOG_SAFE", "1")
        for package, out in outs.items():
            run_prepare(package, pod5, bam, out)
    return outs


@pytest.fixture(autouse=True)
def _no_index_cache(monkeypatch):
    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE", "0")
    monkeypatch.setenv("LOG_SAFE", "1")


def _focus_ref_pos():
    """Every fifth reference position of the forward contig."""
    span = (N_BASES + 1000) * (N_READS + 4)
    return {("ctg1", "+"): set(range(0, span, 5))}


CASES = {
    "reference": {},
    "control": dict(mod_base_control=True),
    "basecall": dict(basecall_anchor=True),
    "focus_ref_pos": dict(focus_ref_pos=_focus_ref_pos()),
    "basecall_focus_ref_pos": dict(basecall_anchor=True,
                                   focus_ref_pos=_focus_ref_pos()),
    "downsample": dict(max_chunks_per_read=2, seed=5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prepare_matches_jax(data_set, workdir, case):
    """No refiner, one worker, ``skip_shuffle``: identical datasets in
    order, equal skip tallies."""
    pod5, bam = data_set
    outs, results = {}, {}
    for package in PACKAGES:
        outs[package] = workdir / f"{case}_{package}"
        results[package] = run_prepare(package, pod5, bam, outs[package],
                                       **CASES[case])
    assert results["port"] == results["jax"]
    n_chunks, tally = results["jax"]
    assert n_chunks > 0
    want = assert_same_datasets(outs["port"], outs["jax"])
    assert np.all(want["labels"] == int(case != "control"))
    if case == "reference":
        assert tally["No reference sequence (missing MD tag)"] == 1
        assert tally["Sequence too long"] > 0
    if case == "downsample":
        per_read = np.unique(want["read_ids"], return_counts=True)[1]
        assert per_read.max() == 2


def test_reverse_signal_matches_jax(workdir):
    """``rev_sig`` on reads whose signal is stored 3'->5'."""
    sub = workdir / "rna"
    sub.mkdir()
    pod5, bam = write_rna_set(sub, n_reads=4)
    outs, results = {}, {}
    for package in PACKAGES:
        outs[package] = sub / package
        results[package] = run_prepare(package, pod5, bam, outs[package],
                                       rev_sig=True)
    assert results["port"] == results["jax"]
    assert results["jax"][0] > 0
    assert_same_datasets(outs["port"], outs["jax"])


def _refine_runs(data_set, workdir, tag, backends):
    """``run_prepare`` of each (package, backend) with a fresh refiner
    (rough rescale, one dwell-penalty DP round); returns ({key: out
    path}, {key: (chunks, tally)}, {key: refiner})."""
    pod5, bam = data_set
    outs, results, refiners = {}, {}, {}
    for package, backend in backends:
        key = f"{package}_{backend}"
        pair = dict(zip(PACKAGES, _refiners(0, "dwell_penalty",
                                            backend=backend)))
        refiners[key] = pair[package]
        outs[key] = workdir / f"{tag}_{key}"
        results[key] = run_prepare(package, pod5, bam, outs[key],
                                   refiner=refiners[key])
    return outs, results, refiners


def test_native_refiner_matches_jax(data_set, workdir):
    """A refiner on the native backend: identical datasets and tallies,
    each dataset carrying the refiner."""
    outs, results, refiners = _refine_runs(
        data_set, workdir, "refine", [("jax", "native"), ("port", "native")])
    assert results["port_native"] == results["jax_native"]
    assert_same_datasets(outs["port_native"], outs["jax_native"])
    assert load("port", outs["jax_native"]).metadata.sig_map_refiner == \
        refiners["port_native"]
    assert load("jax", outs["port_native"]).metadata.sig_map_refiner == \
        refiners["jax_native"]


def test_device_refiner_matches_jax(data_set, workdir, monkeypatch):
    """The device backend (the port's plain K4/K5 on the CPU, the JAX
    package's Pallas kernels in interpret mode), both drivers at a
    micro-batch of one read: identical datasets and tallies. The device
    stage ran in this process, on the plain versions."""
    from remora_tpu import constants as jax_constants
    from remora_tpu_torch import constants as port_constants

    monkeypatch.setattr(jax_constants, "REFINE_DEVICE_READ_BATCH", 1)
    monkeypatch.setattr(port_constants, "REFINE_DEVICE_READ_BATCH", 1)
    port_refiner.PLANNED_LAUNCHES = port_refiner.HOST_ROUTED_READS = 0
    outs, results, _ = _refine_runs(
        data_set, workdir, "batch1", [("jax", "device"), ("port", "device")])
    assert results["port_device"] == results["jax_device"]
    assert_same_datasets(outs["port_device"], outs["jax_device"])
    assert port_refiner.PLANNED_LAUNCHES > 0
    assert port_refiner.HOST_ROUTED_READS == 0
    assert (port_dp.LAUNCHES_FWD, port_dp.LAUNCHES_TB) == (0, 0)


def test_device_stage_drops_one_read_not_its_batch(data_set, workdir):
    """The set's alignment without a move table raises in the host-side
    read build. The port's device stage drops that read alone, as both
    packages' per-read stage does, so at the full micro-batch it writes
    the JAX package's native-backend dataset; the JAX package's device
    stage loses the whole micro-batch (here every read) instead."""
    outs, results, _ = _refine_runs(
        data_set, workdir, "batch64",
        [("jax", "native"), ("jax", "device"), ("port", "device")])
    assert results["port_device"] == results["jax_native"]
    assert_same_datasets(outs["port_device"], outs["jax_native"])
    assert results["jax_device"] == (0, {})


def test_device_refiner_matches_native_in_port(data_set, workdir):
    """Within the port, the device and native backends write the same
    dataset (one DP round: host-exact normalization)."""
    pod5, bam = data_set
    outs, results = {}, {}
    for backend in ("device", "native"):
        _, refiner = _refiners(0, "Viterbi", backend=backend)
        outs[backend] = workdir / f"port_{backend}"
        results[backend] = run_prepare("port", pod5, bam, outs[backend],
                                       refiner=refiner)
    assert results["device"] == results["native"]
    want = dataset_arrays(load("port", outs["native"]))
    got = dataset_arrays(load("port", outs["device"]))
    for name, arr in want.items():
        assert np.array_equal(got[name], arr), name


def test_shuffled_datasets_match_jax(data_set, workdir, reference_outs):
    """The shuffle draws from the global NumPy RNG: under one seed both
    packages write the same permutation."""
    pod5, bam = data_set
    outs = {}
    for package in PACKAGES:
        outs[package] = workdir / f"shuffled_{package}"
        run_prepare(package, pod5, bam, outs[package], seed=17,
                    skip_shuffle=False)
    shuffled = assert_same_datasets(outs["port"], outs["jax"])
    ordered = dataset_arrays(load("jax", reference_outs["jax"]))
    assert not np.array_equal(shuffled["read_focus_bases"],
                              ordered["read_focus_bases"])
    resorted = dataset_arrays(load("port", outs["port"]), sort=True)
    for name, arr in dataset_arrays(load("jax", reference_outs["jax"]),
                                    sort=True).items():
        assert np.array_equal(resorted[name], arr), name


def test_three_workers_match_jax(data_set, workdir, reference_outs):
    """Three chunk workers (and two alignment workers) give the
    single-worker dataset, once sorted by (read id, focus base)."""
    pod5, bam = data_set
    outs, results = {}, {}
    for package in PACKAGES:
        outs[package] = workdir / f"workers_{package}"
        results[package] = run_prepare(
            package, pod5, bam, outs[package],
            num_extract_alignment_workers=2,
            num_extract_chunks_workers=3)
    assert results["port"] == results["jax"]
    want = assert_same_datasets(outs["port"], outs["jax"], sort=True)
    single = dataset_arrays(load("port", reference_outs["port"]),
                            sort=True)
    for name, arr in single.items():
        assert np.array_equal(want[name], arr), name


def test_empty_inputs(workdir, data_set):
    """An empty BAM exits, as the JAX driver does; no matching reads
    return None."""
    pod5, _bam = data_set
    sub = workdir / "empty"
    sub.mkdir()
    header = jax_bam.FastBamScanner(_bam).header
    empty_bam = sub / "empty.bam"
    with jax_bam.BamWriter(str(empty_bam), header):
        pass
    for package in PACKAGES:
        with pytest.raises(SystemExit):
            run_prepare(package, pod5, str(empty_bam), sub / package)
    other = sub / "other"
    other.mkdir()
    other_pod5 = other / "other.pod5"
    with Pod5Writer(str(other_pod5)) as p5w:
        _s, _m, dacs = synth_read(np.random.default_rng(1), 50)
        p5w.add_read(str(uuid.uuid4()), dacs, 90.0, 20.0)
    for package in PACKAGES:
        prepare = PACKAGES[package][0]
        with time_limit():
            got = prepare.extract_chunk_dataset(
                _bam, str(other_pod5), str(sub / f"none_{package}"),
                ("m", "5mC"), False, [PACKAGES[package][1].Motif("CG", 0)],
                None, CHUNK_CONTEXT, MIN_SAMPS_PER_BASE, 10, None, None,
                KMER_CONTEXT, False, 0, None)
        assert got is None


def test_device_refine_failure_raises(data_set, workdir, monkeypatch):
    """A kernel that fails in the device stage (the DP wrapper raises)
    makes the driver raise after draining, instead of writing a dataset
    short of the micro-batch's reads."""
    from remora_tpu_torch import RemoraError

    def boom(*args, **kwargs):
        raise RuntimeError("simulated kernel launch failure")

    monkeypatch.setattr(port_dp, "banded_dp_batch", boom)
    _, refiner = _refiners(0, "dwell_penalty", backend="device")
    with pytest.raises(RemoraError, match="simulated kernel launch"):
        run_prepare("port", *data_set, workdir / "failing", refiner=refiner)
