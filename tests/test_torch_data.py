"""The port's dataset modules against the JAX package on the CPU: datasets
written by either package read in the other, identical batch streams from
the same seed, and metadata that round-trips unchanged."""

import json

import numpy as np
import pytest

from remora_tpu.data import dataset as jax_dataset
from remora_tpu.data import metadata as jax_metadata
from remora_tpu.refine.refiner import SigMapRefiner
from remora_tpu_torch import RemoraError
from remora_tpu_torch.core import seq as port_seq
from remora_tpu_torch.data import dataset as port_dataset
from remora_tpu_torch.data import metadata as port_metadata
from remora_tpu_torch.refine.refiner import SigMapRefiner as PortRefiner

PACKAGES = {
    "jax": (jax_dataset, jax_metadata),
    "port": (port_dataset, port_metadata),
}


def synth_arrays(rng, n, chunk_context, kmer_context_bases):
    """Raw chunk arrays as a dataset stores them (the recipe of
    ``chip_smoke.synth_inputs``): seqs with the k-mer context, sorted int16
    maps from 0 to the chunk width, ragged seq lens, labels in {0, 1} that
    shift the signal around the chunk's centre."""
    width = sum(chunk_context)
    kmer_len = sum(kmer_context_bases) + 1
    max_seq = width // 5
    labels = rng.integers(0, 2, n).astype(np.int64)
    sigs = rng.normal(size=(n, 1, width)).astype(np.float32)
    sigs[:, 0, width // 2 - 5: width // 2 + 5] += labels[:, None]
    lens = rng.integers(max_seq // 2, max_seq + 1, n).astype(np.int16)
    seqs = rng.integers(0, 4, (n, max_seq + kmer_len - 1)).astype(np.int8)
    maps = np.zeros((n, max_seq + 1), np.int16)
    for b in range(n):
        maps[b, 1:lens[b]] = np.sort(rng.integers(0, width + 1, lens[b] - 1))
        maps[b, lens[b]:] = width
    return {
        "signal": sigs,
        "sequence": seqs,
        "sequence_to_signal_mapping": maps,
        "sequence_lengths": lens,
        "labels": labels,
    }


def write_synth_dataset(package, path, n, seed, chunk_context=(25, 25),
                        kmer_context_bases=(4, 4), **md_kwargs):
    """Write ``n`` seeded synthetic chunks with ``package``'s CoreDataset
    (motif CG 0, mod base m); returns the path."""
    ds_mod, md_mod = PACKAGES[package]
    arrays = synth_arrays(np.random.default_rng(seed), n, chunk_context,
                          kmer_context_bases)
    md = md_mod.DatasetMetadata(
        allocate_size=n,
        max_seq_len=arrays["sequence_to_signal_mapping"].shape[1] - 1,
        mod_bases=["m"],
        mod_long_names=["5mC"],
        motif_sequences=["CG"],
        motif_offsets=[0],
        chunk_context=chunk_context,
        kmer_context_bases=kmer_context_bases,
        extra_arrays={},
        **md_kwargs,
    )
    ds = ds_mod.CoreDataset(str(path), mode="w", metadata=md)
    ds.write_batch(arrays)
    ds.flush()
    ds.write_metadata()
    return str(path)


def write_config(path, members):
    with open(path, "w") as fh:
        json.dump([[str(p), w] for p, w in members], fh)
    return str(path)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_dataset_cross_read(tmp_path, writer, reader):
    path = write_synth_dataset(writer, tmp_path / "ds", 40, seed=1)
    want = synth_arrays(np.random.default_rng(1), 40, (25, 25), (4, 4))
    ds = PACKAGES[reader][0].CoreDataset(path, infinite_iter=False)
    assert ds.size == 40
    for name, arr in want.items():
        assert np.array_equal(np.asarray(getattr(ds, name)), arr), name
    assert jax_dataset.CoreDataset.hash(path) == \
        port_dataset.CoreDataset.hash(path)


def _stream(package, config, seed, raw, n_batches, sample_frac=None):
    """(train batches, test batches, head batches) from ``package``'s
    ComposedDataset over ``config``, with ``train_model``'s calls in
    its order."""
    ds_mod = PACKAGES[package][0]
    np.random.seed(seed)
    override = {"extra_arrays": {}}
    paths, props, hashes = ds_mod.load_dataset(config)
    ds = ds_mod.ComposedDataset(
        [ds_mod.CoreDataset(p, override_metadata=dict(override))
         for p in paths],
        props, hashes, batch_size=16, super_batch_size=30,
        super_batch_sample_frac=sample_frac,
    )
    trn, tst = ds.train_test_split(12, override_metadata=override)
    head = trn.head(12, override_metadata=override)
    it = trn.iter_batches(raw=raw)
    train = [next(it) for _ in range(n_batches)]
    return train, list(tst.iter_batches()), list(head.iter_batches()), trn


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("sample_frac", [None, 0.5])
def test_same_seed_same_batches(tmp_path, raw, sample_frac):
    a = write_synth_dataset("jax", tmp_path / "a", 50, seed=2)
    b = write_synth_dataset("port", tmp_path / "b", 70, seed=3)
    config = write_config(tmp_path / "cfg.jsn", [(a, 1), (b, 3)])
    streams = [_stream(pkg, config, 7, raw, 9, sample_frac)
               for pkg in ("jax", "port")]
    for part in range(3):
        got, want = streams[1][part], streams[0][part]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for name in w:
                assert g[name].dtype == w[name].dtype, name
                assert np.array_equal(g[name], w[name]), name
    assert streams[1][3].epoch_summary(4) == streams[0][3].epoch_summary(4)


def test_metadata_round_trips(tmp_path):
    """A JAX-written dataset whose refiner carries a levels table and
    non-default settings: the port reads its metadata.jsn (refine_* keys
    as its own ``SigMapRefiner``), writes it back unchanged, and the JAX
    package reads the port's copy to an equal refiner."""
    levels = np.linspace(-1, 1, 4 ** 3).astype(np.float32)
    refiner = SigMapRefiner(
        _levels_array=levels, center_idx=1, do_rough_rescale=True,
        scale_iters=0, algo="Viterbi", half_bandwidth=7, sd_params=(5, 4, 1.0),
    )
    path = write_synth_dataset("jax", tmp_path / "ds", 10, seed=4,
                               sig_map_refiner=refiner)
    ds = port_dataset.CoreDataset(path, infinite_iter=False)
    port_refiner = ds.metadata.sig_map_refiner
    assert port_refiner.algo == "Viterbi"
    assert port_refiner.half_bandwidth == 7
    assert np.array_equal(port_refiner.levels_array, levels)
    assert port_refiner == PortRefiner(
        _levels_array=levels, center_idx=1, do_rough_rescale=True,
        scale_iters=0, algo="Viterbi", half_bandwidth=7, sd_params=(5, 4, 1.0),
    )
    out = tmp_path / "copy"
    out.mkdir()
    ds.metadata.write(out / "metadata.jsn", out / "kmer_table.npy")
    with open(f"{path}/metadata.jsn") as fh:
        want = json.load(fh)
    with open(out / "metadata.jsn") as fh:
        got = json.load(fh)
    assert got == want
    assert {k for k in want if k.startswith("refine_")} >= {
        "refine_sd_arr", "refine_algo", "refine_half_bandwidth"}
    assert np.array_equal(np.load(out / "kmer_table.npy"), levels)
    record = jax_metadata.DatasetMetadata.load(out / "metadata.jsn",
                                               out / "kmer_table.npy")
    assert record["sig_map_refiner"] == refiner


def test_merge_motifs_matches_jax():
    from remora_tpu.core import seq as jax_seq

    cases = [[("CG", 0), ("CA", 0)], [("CG", 0), ("GC", 1)],
             [("NCGN", 1), ("CG", 0)], [("CG", 0), ("CCG", 1), ("TCG", 1)]]
    for motifs in cases:
        got = sorted(m.to_tuple() for m in port_seq.merge_motifs(motifs))
        want = sorted(m.to_tuple() for m in jax_seq.merge_motifs(motifs))
        assert got == want, motifs
    assert np.array_equal(port_seq.seq_to_int("ACGTN"),
                          jax_seq.seq_to_int("ACGTN"))
    assert port_seq.int_to_seq([0, 1, 2, 3, -1]) == "ACGTN"


def test_composed_rejects_mismatched_members(tmp_path):
    a = write_synth_dataset("port", tmp_path / "a", 20, seed=5)
    b = write_synth_dataset("port", tmp_path / "b", 20, seed=6,
                            reverse_signal=True)
    config = write_config(tmp_path / "cfg.jsn", [(a, 1), (b, 1)])
    with pytest.raises(RemoraError, match="reverse_signal"):
        port_dataset.ComposedDataset.from_config(config)
