"""The port's duplex inference (``infer_duplex``: simplex POD5 + BAM, a
duplex BAM and a pairs file in, duplex modBAM out) and its parts against
the JAX package's on the CPU.

The pairwise aligner (the host C++ kernel and its NumPy twin) is held
identical on fuzzed pairs (``tests/test_aligner_fuzz.py``'s mutation
generator) and on ``tests/test_duplex_fixtures.py``'s cases; so are the
simplex-to-duplex mapping, ``Read.with_duplex_alignment``, the strand
batches of ``RemoraRead.prepare_batches`` (bit for bit) and their f32
logits through ``run_model`` (within 1e-5).

Both drivers then run on a synthetic duplex set written here with the
JAX package's writers (``chip_smoke.py::write_duplex_set``: 8 pairs of
240 bases, every fourth duplex record mapped reverse, one pair without a
duplex record and one without its complement's signal) with the
size-16 checkpoint of ``tests/test_torch_infer_pipeline.py``: the same
records, f32 MM/ML identical by duplex read id, bf16 ML within 1, equal
skip tallies; within the port the device refiner (K4/K5's plain versions
on the CPU) writes the native refiner's tags, and a call that raises
makes the port's driver raise. Every driver run is time-bounded, since
the stages fork.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (DUPLEX_NO_DUPLEX, DUPLEX_NO_SIGNAL,
                        synth_level_table, write_duplex_set)
from remora_tpu.infer import duplex_infer as jax_duplex_infer
from remora_tpu.infer import infer as jax_infer
from remora_tpu.io import bam as jax_bam
from remora_tpu.io import duplex as jax_duplex
from remora_tpu.io import native as jax_native
from remora_tpu.io import read_index as jax_index
from remora_tpu.io.pod5_write import Pod5Writer
from remora_tpu_torch import RemoraError
from remora_tpu_torch.infer import duplex_infer
from remora_tpu_torch.infer import infer
from remora_tpu_torch.io import duplex
from remora_tpu_torch.io import native
from remora_tpu_torch.io import read_index
from remora_tpu_torch.kernels import banded_dp as port_dp
from remora_tpu_torch.refine import refiner as port_refiner

from tests.test_aligner_fuzz import _mutate, _rand_seq
from tests.test_duplex_fixtures import CASES
from tests.test_torch_infer_pipeline import (KMER_LEN, captured, ml_of,
                                             skip_tally, time_limit,
                                             write_model)
from tests.test_torch_io import _plain, _read_fields, _record_fields
from tests.test_torch_io import jax_native_loaded  # noqa: F401 (autouse)

N_PAIRS, N_BASES = 8, 240


def _fuzz_pairs(seed=1234, n=75):
    """``test_native_matches_numpy_and_gotoh_fuzz``'s (query, ref) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for trial in range(n):
        ref = _rand_seq(rng, int(rng.integers(20, 220)))
        query = _mutate(rng, ref)
        if trial % 3 == 0:
            query = _rand_seq(rng, int(rng.integers(0, 15))) + query
        if trial % 3 == 1:
            query = query + _rand_seq(rng, int(rng.integers(0, 15)))
        if query:
            out.append((query, ref))
    return out


FIXTURE_PAIRS = [(case[1], case[2]) for case in CASES]


@pytest.mark.parametrize("which", ["fuzz", "fixtures"])
def test_aligners_match_jax(which):
    """The port's host kernel and NumPy twin each give the JAX package's
    counterpart's alignment, both ways round (the two may break score
    ties apart from each other, in both packages)."""
    pairs = _fuzz_pairs() if which == "fuzz" else FIXTURE_PAIRS
    assert native.get_lib() is not None
    for i, (query, ref) in enumerate(pairs):
        for q, r in ((query, ref), (ref, query)):
            assert native.sg_align_native(q, r) == \
                jax_native.sg_align_native(q, r), (q, r)
            # the twins loop in Python: every other fuzz pair
            if which == "fixtures" or i % 2 == 0:
                assert native.sg_align_numpy(q, r) == \
                    jax_native.sg_align_numpy(q, r), (q, r)


def test_aligner_twin_without_the_library(monkeypatch):
    """Without the host library, ``sg_align_native`` runs the NumPy twin."""
    monkeypatch.setattr(native, "get_lib", lambda: None)
    for query, ref in FIXTURE_PAIRS:
        assert native.sg_align_native(query, ref) == \
            jax_native.sg_align_native(query, ref)


def _mapping_fields(m):
    return (_plain(m.duplex_to_simplex_mapping), m.trimmed_duplex_seq,
            m.duplex_offset)


def test_map_simplex_to_duplex_matches_jax():
    """``tests/test_aligner_fuzz.py::test_simplex_duplex_mapping_fuzz``'s
    mutated reads with ragged ends, and the fixture cases."""
    rng = np.random.default_rng(99)
    pairs = list(FIXTURE_PAIRS)
    for _ in range(25):
        dup = _rand_seq(rng, int(rng.integers(200, 800)))
        simplex = (_rand_seq(rng, int(rng.integers(0, 30)))
                   + _mutate(rng, dup)
                   + _rand_seq(rng, int(rng.integers(0, 30))))
        pairs.append((simplex, dup))
    for simplex, dup in pairs:
        want = jax_duplex.map_simplex_to_duplex(simplex_seq=simplex,
                                                duplex_seq=dup)
        got = duplex.map_simplex_to_duplex(simplex_seq=simplex,
                                           duplex_seq=dup)
        assert _mapping_fields(got) == _mapping_fields(want)
        aln = duplex.pairwise_align(query=simplex, ref=dup)
        assert dataclasses.astuple(aln) == dataclasses.astuple(
            jax_duplex.pairwise_align(query=simplex, ref=dup))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_duplex")


@pytest.fixture(scope="module")
def duplex_set(workdir):
    """(POD5 path, simplex BAM, duplex BAM, pairs file), written with the
    JAX package's writers."""
    sub = workdir / "set"
    sub.mkdir()
    pod5 = sub / "simplex.pod5"
    table, center = synth_level_table(KMER_LEN)
    from remora_tpu_torch.refine.levels import extract_levels

    with Pod5Writer(str(pod5)) as p5w:
        paths = write_duplex_set(
            str(sub), N_PAIRS, N_BASES, jax_bam,
            lambda rid, dacs: p5w.add_read(rid, dacs, 90.0, 20.0),
            levels_of=lambda s: extract_levels(s, table, KMER_LEN, center))
    return (str(pod5), *paths)


@pytest.fixture(scope="module")
def model_path(workdir):
    return write_model(workdir, "size16.npz")


@pytest.fixture(scope="module")
def refine_model_path(workdir):
    from remora_tpu.refine.refiner import SigMapRefiner

    table, center = synth_level_table(KMER_LEN)
    refiner = SigMapRefiner(
        _levels_array=table, center_idx=center, do_rough_rescale=True,
        scale_iters=0)
    return write_model(workdir, "refine16.npz", refiner=refiner)


@pytest.fixture(autouse=True)
def _no_index_cache(monkeypatch):
    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE", "0")


def _read_pairs(read_mod_pkg, duplex_mod, index_mod, duplex_set):
    """(template Read, complement Read, duplex record) of every pair with
    signal and a duplex record, by one package."""
    pod5, simplex_bam, duplex_bam, pairs_path = duplex_set
    simplex_idx = index_mod.ReadIndexedBam(simplex_bam, req_tags={"mv"})
    duplex_idx = index_mod.ReadIndexedBam(
        duplex_bam, req_tags=set(),
        read_id_converter=read_mod_pkg.DelimIdConverter(";"))
    builder = duplex_mod.DuplexPairsBuilder(simplex_idx, pod5)
    out = []
    with open(pairs_path) as fh:
        for line in fh:
            pair, err = builder.make_read_pair(tuple(line.split()))
            if err is None and pair[0].read_id in duplex_idx:
                rec = next(duplex_idx.get_alignments(pair[0].read_id))
                out.append((*pair, rec))
    return out


def test_duplex_reads_match_jax(duplex_set):
    """``DuplexPairsBuilder``, ``Read.with_duplex_alignment`` (through
    ``DuplexRead.from_reads_and_alignment``) and each strand's
    ``into_remora_read`` match the JAX package's."""
    want = _read_pairs(jax_duplex_infer, jax_duplex, jax_index, duplex_set)
    got = _read_pairs(duplex_infer, duplex, read_index, duplex_set)
    assert len(got) == len(want) == N_PAIRS - 2
    n_reverse = 0
    for (gt, gc, grec), (wt, wc, wrec) in zip(got, want):
        assert _read_fields(gt) == _read_fields(wt)
        assert _read_fields(gc) == _read_fields(wc)
        assert _record_fields(grec) == _record_fields(wrec)
        g = duplex.DuplexRead.from_reads_and_alignment(
            template_read=gt, complement_read=gc, duplex_alignment=grec)
        w = jax_duplex.DuplexRead.from_reads_and_alignment(
            template_read=wt, complement_read=wc, duplex_alignment=wrec)
        assert g.is_reverse_mapped == w.is_reverse_mapped
        n_reverse += w.is_reverse_mapped
        assert (g.template_ref_start, g.complement_ref_start) == \
            (w.template_ref_start, w.complement_ref_start)
        assert g.duplex_basecalled_sequence == w.duplex_basecalled_sequence
        for gs, ws in ((g.template_read, w.template_read),
                       (g.complement_read, w.complement_read)):
            assert _plain(gs.query_to_signal) == _plain(ws.query_to_signal)
            assert (gs.seq, gs.ref_seq, gs.ref_to_signal) == \
                (ws.seq, ws.ref_seq, ws.ref_to_signal)
            gr, wr = gs.into_remora_read(False), ws.into_remora_read(False)
            for name in ("dacs", "shift", "scale", "seq_to_sig_map",
                         "int_seq"):
                assert _plain(getattr(gr, name)) == \
                    _plain(getattr(wr, name)), name
    assert n_reverse > 0


@pytest.mark.parametrize("batch_size", [2048, 5])
def test_prepare_batches_and_run_model_match_jax(duplex_set, model_path,
                                                 batch_size):
    """Each strand's batches bit-equal the JAX package's; the f32 logits
    of ``run_model`` (power-of-two buckets) within 1e-5, with the calls'
    labels and positions equal."""
    from remora_tpu.core.seq import Motif as JaxMotif
    from remora_tpu_torch.core.seq import Motif

    jax_handle = jax_infer.ModelHandle.load(model_path)
    port_handle = infer.ModelHandle.load(model_path, device="cpu")
    want = _read_pairs(jax_duplex_infer, jax_duplex, jax_index, duplex_set)
    got = _read_pairs(duplex_infer, duplex, read_index, duplex_set)
    n_batches = 0
    for (gt, gc, _g), (wt, wc, _w) in list(zip(got, want))[:3]:
        for gs, ws in ((gt, wt), (gc, wc)):
            gr, wr = gs.into_remora_read(False), ws.into_remora_read(False)
            gr.set_motif_focus_bases([Motif("CG", 0)])
            wr.set_motif_focus_bases([JaxMotif("CG", 0)])
            gr.prepare_batches(port_handle.metadata, batch_size)
            wr.prepare_batches(jax_handle.metadata, batch_size)
            assert len(gr.batches) == len(wr.batches) > 0
            for gb, wb in zip(gr.batches, wr.batches):
                assert [_plain(a) for a in gb] == [_plain(a) for a in wb]
            n_batches += len(gr.batches)
            g_out, g_lab, g_pos = gr.run_model(port_handle.eval_fn)
            w_out, w_lab, w_pos = wr.run_model(jax_handle.eval_fn)
            assert g_out.dtype == np.float32 and g_out.shape == w_out.shape
            assert np.abs(g_out - w_out).max() <= 1e-5
            assert _plain(g_lab) == _plain(w_lab)
            assert _plain(g_pos) == _plain(w_pos)
    assert n_batches > (6 if batch_size == 5 else 0)


def run_jax(duplex_set, path, out, compute_dtype=None, **kwargs):
    pod5, simplex_bam, duplex_bam, pairs = duplex_set
    handle = jax_infer.ModelHandle.load(path, compute_dtype=compute_dtype)
    with time_limit(), captured("RemoraTPU") as msgs:
        n = jax_duplex_infer.infer_duplex(
            simplex_pod5_path=pod5, simplex_bam_path=simplex_bam,
            duplex_bam_path=duplex_bam, pairs_path=pairs, models=[handle],
            out_bam=str(out), **kwargs)
    return n, skip_tally(msgs)


def run_port(duplex_set, path, out, compute_dtype=None, **kwargs):
    pod5, simplex_bam, duplex_bam, pairs = duplex_set
    handle = infer.ModelHandle.load(path, device="cpu",
                                    compute_dtype=compute_dtype)
    with time_limit(), captured("RemoraTPUTorch") as msgs:
        n = duplex_infer.infer_duplex(
            simplex_pod5_path=pod5, simplex_bam_path=simplex_bam,
            duplex_bam_path=duplex_bam, pairs_path=pairs, models=[handle],
            out_bam=str(out), **kwargs)
    return n, skip_tally(msgs)


def records_by_id(path):
    out = {}
    for rec in jax_bam.FastBamScanner(str(path)):
        assert rec.query_name not in out
        out[rec.query_name] = rec
    return out


def assert_same_records(got_path, want_path, ml_tol=0):
    got, want = records_by_id(got_path), records_by_id(want_path)
    assert got.keys() == want.keys()
    n_calls = 0
    for rid, w in want.items():
        g = got[rid]
        assert g.tag_dict()["MM"] == w.tag_dict()["MM"], rid
        delta = np.abs(ml_of(g).astype(int) - ml_of(w))
        assert delta.max(initial=0) <= ml_tol, rid
        fields = {k: v for k, v in _record_fields(g).items() if k != "tags"}
        assert fields == {k: v for k, v in _record_fields(w).items()
                          if k != "tags"}, rid
        n_calls += ml_of(w).size
    return want, n_calls


MISSING_SIGNAL = {"duplex pair read id(s) missing from pod5": 1}


def test_f32_tags_identical(duplex_set, model_path, workdir):
    n_jax, tally_jax = run_jax(duplex_set, model_path, workdir / "jax.bam")
    n_port, tally_port = run_port(duplex_set, model_path,
                                  workdir / "port.bam")
    # the pair without a duplex record is filtered before the stages
    # (``check_simplex_alignments``); the pair without its complement's
    # signal is the one skip
    assert n_port == n_jax == N_PAIRS - 2
    assert tally_port == tally_jax == MISSING_SIGNAL
    want, n_calls = assert_same_records(workdir / "port.bam",
                                        workdir / "jax.bam")
    assert n_calls > 8 * N_PAIRS
    assert sum(r.is_reverse for r in want.values()) > 0
    for rec in want.values():
        mm = rec.tag_dict()["MM"]
        assert "C+m" in mm and "G-m" in mm
    missing = {line.split()[0] for i, line in
               enumerate(open(duplex_set[3]))
               if i in (DUPLEX_NO_DUPLEX, DUPLEX_NO_SIGNAL)}
    assert not {rid.split(";")[0] for rid in want} & missing


def test_bf16_ml_within_one(duplex_set, model_path, workdir):
    import jax.numpy as jnp

    run_jax(duplex_set, model_path, workdir / "jax_bf16.bam",
            compute_dtype=jnp.bfloat16)
    n, tally = run_port(duplex_set, model_path, workdir / "port_bf16.bam",
                        compute_dtype=torch.bfloat16)
    assert n == N_PAIRS - 2 and tally == MISSING_SIGNAL
    assert_same_records(workdir / "port_bf16.bam", workdir / "jax_bf16.bam",
                        ml_tol=1)


def test_device_refiner_matches_native(duplex_set, refine_model_path,
                                       workdir):
    """A checkpoint with a refiner: the port's device DP (one strand read
    a call, the plain K4/K5 on the CPU) writes the native DP's tags, which
    are the JAX driver's (its refiner loads as ``auto``: the host DP)."""
    path = refine_model_path
    run_jax(duplex_set, path, workdir / "jax_refine.bam")
    run_port(duplex_set, path, workdir / "native_refine.bam",
             refine_backend="native")
    port_dp.LAUNCHES_FWD = port_dp.LAUNCHES_TB = 0
    port_refiner.PLANNED_LAUNCHES = port_refiner.HOST_ROUTED_READS = 0
    n, tally = run_port(duplex_set, path, workdir / "device_refine.bam",
                        refine_backend="device")
    assert n == N_PAIRS - 2 and tally == MISSING_SIGNAL
    # two strands a pair, one DP round each, in this process
    assert port_refiner.PLANNED_LAUNCHES == 2 * n
    assert port_refiner.HOST_ROUTED_READS == 0
    assert (port_dp.LAUNCHES_FWD, port_dp.LAUNCHES_TB) == (0, 0)
    assert_same_records(workdir / "device_refine.bam",
                        workdir / "native_refine.bam")
    assert_same_records(workdir / "native_refine.bam",
                        workdir / "jax_refine.bam")


@pytest.mark.parametrize("where", ["forward", "device_refiner"])
def test_call_failure_raises(duplex_set, model_path, refine_model_path,
                             workdir, monkeypatch, where):
    """A call that raises in the InferMods threads (the forward's kernel
    or the device refiner's K4/K5 failing to launch) makes the driver
    raise RemoraError after draining, instead of writing a BAM short of
    the pair."""

    def boom(*args, **kwargs):
        raise RuntimeError("simulated kernel launch failure")

    if where == "forward":
        monkeypatch.setattr(infer.ModelHandle, "eval_fn",
                            property(lambda self: boom))
        path, kwargs = model_path, {}
    else:
        monkeypatch.setattr(port_dp, "banded_dp_batch", boom)
        path, kwargs = refine_model_path, {"refine_backend": "device"}
    with pytest.raises(RemoraError, match="InferMods failed on 6 pair"):
        run_port(duplex_set, path, workdir / f"broken_{where}.bam",
                 **kwargs)


def test_driver_takes_model_handles_only(duplex_set, model_path, workdir):
    """Bare (eval_fn, metadata) pairs are refused before any stage
    starts, as in the simplex driver."""
    pod5, simplex_bam, duplex_bam, pairs = duplex_set
    handle = infer.ModelHandle.load(model_path, device="cpu")
    with time_limit(), pytest.raises(RemoraError, match="ModelHandle"):
        duplex_infer.infer_duplex(
            simplex_pod5_path=pod5, simplex_bam_path=simplex_bam,
            duplex_bam_path=duplex_bam, pairs_path=pairs,
            models=[(handle.eval_fn, handle.metadata)],
            out_bam=str(workdir / "pairs.bam"))
    assert not (workdir / "pairs.bam").exists()
