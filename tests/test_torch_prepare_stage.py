"""The refiner and the prepare stage it feeds, remora_tpu_torch against
the JAX package on the CPU.

``refine_reads_batch`` with the device backend (the port's plain K4/K5 on
the CPU, the JAX package's Pallas kernels in interpret mode) must give
identical maps, shift, scale and errors; so must the single-read entry
points, the routing to the host DP, the serialized settings and the
auto-backend resolution. The port's one deliberate difference, that only
``DeviceDPRouteError`` reroutes a batch to the host while any other error
propagates, is pinned here. Then the refined reads go through
``extract_chunks_batch`` into each package's ``CoreDataset``: the arrays
are identical, and each package reads the other's dataset to an equal
``SigMapRefiner``.

Every read here is under 256 bases and 4096 samples, so the JAX package's
interpret-mode kernels compile once per algorithm and band bucket.
"""

import numpy as np
import pytest
import torch

from remora_tpu.core.seq import Motif as JaxMotif
from remora_tpu.data import chunk_batch as jax_chunk_batch
from remora_tpu.data import dataset as jax_dataset
from remora_tpu.data import metadata as jax_metadata
from remora_tpu.data.read import RemoraRead as JaxRead
from remora_tpu.refine import autoselect as jax_autoselect
from remora_tpu.refine import refiner as jax_refiner
from remora_tpu_torch import RemoraError
from remora_tpu_torch.core.seq import Motif as PortMotif
from remora_tpu_torch.data import chunk_batch as port_chunk_batch
from remora_tpu_torch.data import dataset as port_dataset
from remora_tpu_torch.data import metadata as port_metadata
from remora_tpu_torch.data.read import RemoraRead as PortRead
from remora_tpu_torch.kernels import banded_dp as K
from remora_tpu_torch.refine import autoselect as port_autoselect
from remora_tpu_torch.refine import refiner as port_refiner
from tests.test_torch_io import jax_native_loaded  # noqa: F401 (autouse)
from tests.test_torch_refine import ALGOS, _dp_read, _kmer_table


def _refiners(scale_iters, algo, backend="device", **kwargs):
    table = _kmer_table(3)
    j = jax_refiner.SigMapRefiner.load_from_dict(
        table, do_rough_rescale=True, scale_iters=scale_iters, algo=algo,
        **kwargs)
    j.backend = backend
    p = port_refiner.SigMapRefiner.load_from_dict(
        table, do_rough_rescale=True, scale_iters=scale_iters, algo=algo,
        backend=backend, device="cpu", **kwargs)
    return j, p


def _read_arrays(rng, smr, n):
    int_seq = rng.integers(0, 4, n)
    levels = smr.extract_levels(int_seq)
    dwells = rng.integers(3, 11, n)
    s2s = np.concatenate([[0], np.cumsum(dwells)])
    sig = np.repeat(levels, dwells) + rng.normal(0, 0.12, s2s[-1])
    return dict(dacs=sig * 15 + 50, shift=45.0 + rng.normal(0, 2),
                scale=18.0 + rng.normal(0, 1), seq_to_sig_map=s2s,
                int_seq=int_seq, read_id=f"read{n}")


def _read_pairs(seed, smr, lengths):
    rng = np.random.default_rng(seed)
    arrays = [_read_arrays(rng, smr, n) for n in lengths]
    return ([JaxRead(**{k: np.copy(v) for k, v in a.items()})
             for a in arrays],
            [PortRead(**{k: np.copy(v) for k, v in a.items()})
             for a in arrays])


def _same_reads(jax_reads, port_reads):
    for j, p in zip(jax_reads, port_reads):
        assert np.array_equal(j.seq_to_sig_map, p.seq_to_sig_map)
        assert j.seq_to_sig_map.dtype == p.seq_to_sig_map.dtype
        assert j.shift == p.shift and j.scale == p.scale


def _same_errs(jax_errs, port_errs):
    assert len(jax_errs) == len(port_errs)
    for j, p in zip(jax_errs, port_errs):
        assert (j is None) == (p is None)
        if j is not None:
            assert type(j).__name__ == type(p).__name__ and str(j) == str(p)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("scale_iters", [0, 2])
def test_refine_reads_batch_matches_jax(scale_iters, algo):
    """The device backend of both packages (the port's plain K4/K5 on the
    CPU, the Pallas kernels in interpret mode), rough rescale on: maps,
    shift, scale and errors identical, with the numpy RNG seeded alike."""
    j_smr, p_smr = _refiners(scale_iters, algo)
    j_reads, p_reads = _read_pairs(11, j_smr, (120, 200, 80, 150, 12))
    np.random.seed(3)
    j_errs = j_smr.refine_reads_batch(j_reads)
    np.random.seed(3)
    p_errs = p_smr.refine_reads_batch(p_reads)
    _same_errs(j_errs, p_errs)
    _same_reads(j_reads, p_reads)


@pytest.mark.parametrize("algo", ALGOS)
def test_single_read_device_backend_matches_jax(algo):
    """``RemoraRead.refine_signal_mapping`` and ``refine_signal_mapping(
    backend="device")`` for one read; the native backend gives the same."""
    j_smr, p_smr = _refiners(1, algo)
    j_reads, p_reads = _read_pairs(4, j_smr, (90,))
    j_reads[0].refine_signal_mapping(j_smr)
    p_reads[0].refine_signal_mapping(p_smr)
    _same_reads(j_reads, p_reads)
    _, p_native = _refiners(1, algo, backend="native")
    _, native_reads = _read_pairs(4, j_smr, (90,))
    native_reads[0].refine_signal_mapping(p_native)
    _same_reads(native_reads, p_reads)

    rng = np.random.default_rng(2)
    signal, levels, _ = _dp_read(rng, 50)
    s2s = np.linspace(0, signal.size, 51).astype(np.int64)
    got = port_refiner.refine_signal_mapping(
        signal, s2s, levels, refine_algo=algo, backend="device",
        device="cpu")
    want = jax_refiner.refine_signal_mapping(
        signal, s2s, levels, refine_algo=algo, backend="device")
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[3], want[3])


def test_host_routing_matches_jax(monkeypatch):
    """With the band cap set small in both packages the same reads go to
    the host DP, with the same results."""
    j_smr, p_smr = _refiners(0, "dwell_penalty")
    j_reads, p_reads = _read_pairs(6, j_smr, (60, 90, 70))
    monkeypatch.setattr(jax_refiner, "REFINE_DEVICE_MAX_BAND", 64)
    monkeypatch.setattr(port_refiner, "REFINE_DEVICE_MAX_BAND", 64)
    routed = port_refiner.HOST_ROUTED_READS
    j_errs = j_smr.refine_reads_batch(j_reads)
    p_errs = p_smr.refine_reads_batch(p_reads)
    assert port_refiner.HOST_ROUTED_READS - routed == len(p_reads)
    _same_errs(j_errs, p_errs)
    _same_reads(j_reads, p_reads)


def test_bad_tb_budget_raises(monkeypatch):
    _, p_smr = _refiners(0, "Viterbi")
    _, p_reads = _read_pairs(8, p_smr, (50,))
    monkeypatch.setenv("REMORA_TPU_DP_TB_BUDGET_MB", "lots")
    with pytest.raises(RemoraError, match="not an integer"):
        p_smr.refine_reads_batch(p_reads)
    monkeypatch.setenv("REMORA_TPU_DP_TB_BUDGET_MB", "4096")
    monkeypatch.setenv("REMORA_TPU_REFINE_DP", "all")
    with pytest.raises(RemoraError, match="not an integer"):
        p_smr.refine_reads_batch(p_reads)
    monkeypatch.setenv("REMORA_TPU_REFINE_DP", "9")
    with pytest.raises(RemoraError, match="devices"):
        p_smr.refine_reads_batch(p_reads)


@pytest.mark.parametrize("where", ["dp_wrapper", "device_loop"])
def test_kernel_error_propagates(monkeypatch, where):
    """The port's no-fallback rule, the counterpart of the JAX package's
    ``test_device_refine_falls_back_to_host``: a RuntimeError raised by
    the DP wrapper (a kernel that fails to build or launch) or anywhere in
    the device loop propagates out of ``refine_reads_batch`` instead of
    rerouting the batch to the host."""
    _, p_smr = _refiners(1, "dwell_penalty")
    _, p_reads = _read_pairs(9, p_smr, (120, 300))

    def boom(*args, **kwargs):
        raise RuntimeError("simulated kernel launch failure")

    if where == "dp_wrapper":
        monkeypatch.setattr(K, "banded_dp_batch", boom)
    else:
        monkeypatch.setattr(port_refiner.SigMapRefiner,
                            "_device_refine_loop", boom)
    routed = port_refiner.HOST_ROUTED_READS
    with pytest.raises(RuntimeError, match="simulated kernel launch"):
        p_smr.refine_reads_batch(p_reads)
    assert port_refiner.HOST_ROUTED_READS == routed


def test_route_error_reroutes_to_host(monkeypatch):
    """A DeviceDPRouteError reroutes the batch to the host DP, restarted
    from the post-rough-rescale shift and scale: the results of the
    ``auto`` backend read by read."""
    _, p_smr = _refiners(2, "dwell_penalty")
    _, p_host = _refiners(2, "dwell_penalty", backend="auto")
    _, p_reads = _read_pairs(9, p_smr, (120, 300))
    _, host_reads = _read_pairs(9, p_smr, (120, 300))

    def route(*args, **kwargs):
        raise port_refiner.DeviceDPRouteError("band grew too wide")

    calls = []
    real = K.banded_dp_batch

    def second_round_routes(*args, **kwargs):
        calls.append(1)
        if len(calls) > 1:
            route()
        return real(*args, **kwargs)

    monkeypatch.setattr(K, "banded_dp_batch", second_round_routes)
    routed = port_refiner.HOST_ROUTED_READS
    np.random.seed(5)
    assert p_smr.refine_reads_batch(p_reads) == [None, None]
    assert port_refiner.HOST_ROUTED_READS - routed == 2
    np.random.seed(5)
    for rd in host_reads:
        rd.refine_signal_mapping(p_host)
    _same_reads(host_reads, p_reads)


def test_device_backend_needs_a_device():
    table = _kmer_table(3)
    if torch.cuda.is_available():
        smr = port_refiner.SigMapRefiner.load_from_dict(
            table, scale_iters=0, backend="device")
        assert smr.device.type == "cuda"
    else:
        with pytest.raises(RemoraError, match="no CUDA device"):
            port_refiner.SigMapRefiner.load_from_dict(
                table, scale_iters=0, backend="device")
    smr = port_refiner.SigMapRefiner.load_from_dict(
        table, scale_iters=0, backend="device", device="cpu")
    assert smr.device == torch.device("cpu")


def test_refiner_metadata_round_trips_with_jax():
    j_smr, p_smr = _refiners(2, "Viterbi", half_bandwidth=7,
                             sd_params=(5, 4, 1.0))
    j_dict, p_dict = j_smr.asdict(), p_smr.asdict()
    assert j_dict.keys() == p_dict.keys()
    for key in j_dict:
        assert np.array_equal(np.asarray(j_dict[key]),
                              np.asarray(p_dict[key])), key
    assert port_refiner.SigMapRefiner.load_from_metadata(j_dict) == p_smr
    assert jax_refiner.SigMapRefiner.load_from_metadata(p_dict) == j_smr
    other = port_refiner.SigMapRefiner.load_from_metadata(
        {**j_dict, "refine_half_bandwidth": 6})
    assert other != p_smr
    assert port_refiner.SigMapRefiner() == port_refiner.SigMapRefiner(
        algo="Viterbi", backend="numpy")
    assert p_smr.get_sub_kmer_table(2) == j_smr.get_sub_kmer_table(2)


@pytest.mark.parametrize("probe_s,forced,threshold", [
    (0.01, None, None), (0.2, None, None), (None, None, None),
    (0.2, None, "0.5"), (0.01, "native", None),
])
def test_resolve_auto_backend_matches_jax(monkeypatch, probe_s, forced,
                                          threshold):
    for name, value in (("REMORA_TPU_REFINE_AUTO", forced),
                        ("REMORA_TPU_REFINE_PROBE_THRESHOLD", threshold)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    j_smr, p_smr = _refiners(0, "Viterbi", backend="auto")
    for refiners in ((j_smr, p_smr), ([None], [None])):
        want = jax_autoselect.resolve_auto_backend(
            refiners[0], probe=lambda: probe_s)
        got = port_autoselect.resolve_auto_backend(
            refiners[1], probe=lambda: probe_s)
        assert got == want


# ---------------- the stage: refine, extract, write ----------------

STAGE_PKGS = {
    "jax": (JaxRead, JaxMotif, jax_chunk_batch, jax_dataset, jax_metadata),
    "port": (PortRead, PortMotif, port_chunk_batch, port_dataset,
             port_metadata),
}
CHUNK_CONTEXT, KMER_CONTEXT, MAX_SEQ_LEN = (50, 50), (2, 2), 40


def _stage_reads(package, smr, seed=21, lengths=(150, 90, 200, 60)):
    """Reads with labels and CG focus bases (the same arrays in both
    packages)."""
    read_cls, motif_cls, *_ = STAGE_PKGS[package]
    rng = np.random.default_rng(seed)
    reads = []
    for n in lengths:
        arrays = _read_arrays(rng, smr, n)
        arrays["labels"] = rng.integers(0, 2, n)
        rd = read_cls(**arrays)
        rd.set_motif_focus_bases([motif_cls("CG", 0)])
        reads.append(rd)
    return reads


def write_refined_dataset(package, smr, reads, path, max_chunks=100_000):
    """prepare's device stage in ``package``: ``refine_reads_batch``, then
    per read the focus-base downsample, the read check and
    ``extract_chunks_batch``, written with that package's ``CoreDataset``.
    Returns the number of chunks."""
    _read_cls, motif_cls, chunk_batch, dataset, metadata = \
        STAGE_PKGS[package]
    motifs = [motif_cls("CG", 0)]
    errs = smr.refine_reads_batch(reads)
    batches = []
    for rd, err in zip(reads, errs):
        if err is not None:
            continue
        rd.downsample_focus_bases(max_chunks)
        rd.check()
        res = chunk_batch.extract_chunks_batch(
            rd, CHUNK_CONTEXT, KMER_CONTEXT, MAX_SEQ_LEN, motifs=motifs,
            check_chunks=True)
        if res is None:
            continue
        arrays, _n_long = res
        n = arrays["sequence_lengths"].size
        arrays["read_ids"] = np.full(n, rd.read_id, "<U36")
        batches.append(arrays)
    n_chunks = sum(b["labels"].size for b in batches)
    md = metadata.DatasetMetadata(
        allocate_size=n_chunks, max_seq_len=MAX_SEQ_LEN,
        mod_bases=["m"], mod_long_names=["5mC"],
        motif_sequences=["CG"], motif_offsets=[0],
        extra_arrays={
            "read_ids": ("<U36", "UUID of the source read"),
            "read_focus_bases": ("int64", "Focus base index"),
        },
        kmer_context_bases=KMER_CONTEXT, chunk_context=CHUNK_CONTEXT,
        sig_map_refiner=smr,
    )
    ds = dataset.CoreDataset(str(path), mode="w", metadata=md)
    for arrays in batches:
        ds.write_batch(arrays)
    ds.flush()
    ds.write_metadata()
    return n_chunks


@pytest.mark.parametrize("algo", ALGOS)
def test_stage_datasets_match_jax(tmp_path, algo):
    """Refined reads through ``extract_chunks_batch`` into each package's
    ``CoreDataset``: identical arrays; each package loads the other's
    dataset with an equal ``SigMapRefiner``."""
    j_smr, p_smr = _refiners(0, algo)
    paths = {}
    for package, smr in (("jax", j_smr), ("port", p_smr)):
        paths[package] = tmp_path / package
        np.random.seed(13)
        n = write_refined_dataset(package, smr, _stage_reads(package, smr),
                                  paths[package], max_chunks=4)
        assert n > 0
    j_ds = jax_dataset.CoreDataset(str(paths["port"]), infinite_iter=False)
    p_ds = port_dataset.CoreDataset(str(paths["jax"]), infinite_iter=False)
    assert j_ds.metadata.sig_map_refiner == j_smr
    assert p_ds.metadata.sig_map_refiner == p_smr
    j_own = jax_dataset.CoreDataset(str(paths["jax"]), infinite_iter=False)
    assert j_ds.size == j_own.size == p_ds.size
    for name in j_own.array_names:
        want = getattr(j_own, name)[: j_own.size]
        assert np.array_equal(getattr(j_ds, name)[: j_ds.size], want), name
        assert np.array_equal(getattr(p_ds, name)[: p_ds.size], want), name


def test_stage_device_matches_native(tmp_path):
    """In the port, the device backend and the native backend write the
    same dataset (one DP round: host-exact normalization)."""
    _, p_dev = _refiners(0, "dwell_penalty")
    _, p_nat = _refiners(0, "dwell_penalty", backend="native")
    got = {}
    for tag, smr in (("device", p_dev), ("native", p_nat)):
        reads = _stage_reads("port", smr)
        if tag == "device":
            n = write_refined_dataset("port", smr, reads, tmp_path / tag)
        else:
            for rd in reads:
                rd.refine_signal_mapping(smr)
            no_refine = port_refiner.SigMapRefiner()
            n = write_refined_dataset("port", no_refine, reads,
                                      tmp_path / tag)
        got[tag] = (n, port_dataset.CoreDataset(str(tmp_path / tag),
                                                infinite_iter=False))
    (n_dev, dev), (n_nat, nat) = got["device"], got["native"]
    assert n_dev == n_nat > 0
    for name in dev.array_names:
        assert np.array_equal(getattr(dev, name)[:n_dev],
                              getattr(nat, name)[:n_nat]), name
