"""The port's streaming inference (``infer_from_pod5_and_bam``, POD5 +
BAM in, modBAM out) against the JAX package's on the CPU.

A ConvLSTM_w_ref checkpoint of size 16 (9-mer, chunk context (50, 50))
written by the JAX package runs through both drivers at batch 64 on
``tests/test_torch_io.py::write_test_set``'s reads, whose calls do not
fill the last batch. The outputs are compared by read id and alignment:
the f32 MM strings and ML bytes are identical (also reference-anchored,
on a reverse-signal set, and with a refiner on the port's device DP
against the JAX package's native DP), bf16 ML bytes are within 1 of the
JAX package's bf16 bytes (and the bf16 logits within a bound set from
bf16's epsilon), and the record counts and skip tallies are equal. The host stages (read prep, batch assembly, unbatching) are held
to the JAX package's one by one. Every driver run is time-bounded."""

import contextlib
import faulthandler
import logging
import signal
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from chip_smoke import calibrate, skip_tally, synth_level_table
from remora_tpu.infer import infer as jax_infer
from remora_tpu.io.bam import BamHeader, BamRecord, BamWriter, FastBamScanner
from remora_tpu.io.pod5_write import Pod5Writer
from remora_tpu_torch import RemoraError
from remora_tpu_torch.core.pipeline import NamedQueue, put_item, queue_iter
from remora_tpu_torch.infer import infer
from remora_tpu_torch.io import read as port_read
from remora_tpu_torch.io import read_index as port_index
from remora_tpu_torch.kernels import banded_dp as port_dp
from remora_tpu_torch.kernels.encoded_kmers import compute_encoded_kmer_batch
from remora_tpu_torch.refine import refiner as port_refiner

from tests.test_synthetic_rna import _synth_read as rna_read
from tests.test_torch_io import _plain, _record_fields, write_test_set
from tests.test_torch_io import jax_native_loaded  # noqa: F401 (autouse)
from tests.test_torch_models import _numpy_trees

SIZE, KMER_LEN, CTX, BATCH = 16, 9, (50, 50), 64
FC_SCALE = 64
RUN_LIMIT_S = 240  # each driver run; a hang fails the test, not the suite


@contextlib.contextmanager
def time_limit(seconds=RUN_LIMIT_S):
    """Fail a pipeline run that takes longer than ``seconds`` (SIGALRM in
    the main thread; forked stage children do not inherit the alarm)."""

    def on_alarm(_signum, _frame):
        # where every thread of this process stood, for the report
        faulthandler.dump_traceback(all_threads=True)
        raise TimeoutError(f"pipeline run exceeded {seconds} s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


class _Captured(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@contextlib.contextmanager
def captured(logger_name):
    handler = _Captured()
    logger = logging.getLogger(logger_name)
    logger.addHandler(handler)
    try:
        yield handler.messages
    finally:
        logger.removeHandler(handler)


def write_model(out_dir, name, reverse_signal=False, refiner=None,
                spread=1.5):
    """A size-16 ConvLSTM_w_ref written by the JAX package's
    ``save_model`` (``benchmarks/synth_set.py::write_synth_model``'s
    metadata). The weights are numpy-seeded, the recurrent layers drawn
    4x wider and the BatchNorm statistics calibrated
    (``tests/test_torch_infer.py``'s recipe); the head centres the logit
    difference on seeded chunks with a standard deviation of ``spread``,
    so the calls spread over the ML bytes."""
    from remora_tpu.data.metadata import DatasetMetadata
    from remora_tpu.models import model_io as jax_io
    from remora_tpu_torch.models import conv_lstm_model, model_io

    params, bn_state = _numpy_trees(conv_lstm_model, SIZE, KMER_LEN, 2, 11)
    for layer in ("lstm1", "lstm2", "fc"):
        params[layer] = {k: 4 * v for k, v in params[layer].items()}
    model = conv_lstm_model.init(size=SIZE, kmer_len=KMER_LEN)
    model.load_state_dict(model_io.params_from_numpy(params, bn_state))
    calibrate(model, bench._synth_inputs(256, 400, KMER_LEN)[:4])
    params, bn_state = model_io.module_to_trees(model)
    # the head: the logit difference centred, with a standard deviation
    # of ``spread``, on seeded chunks of the model's width
    sigs, seqs, maps, lens = (torch.from_numpy(a) for a in
                              bench._synth_inputs(512, sum(CTX),
                                                  KMER_LEN)[:4])
    with torch.no_grad():
        enc = compute_encoded_kmer_batch(4, 4, seqs, maps, lens, sum(CTX))
        diff = np.diff(model(sigs, enc).numpy(), axis=1)[:, 0]
    w, b = params["fc"]["w"], params["fc"]["b"]
    gain = spread / diff.std()
    params["fc"]["w"] = (w * gain).astype(np.float32)
    params["fc"]["b"] = np.array(
        [0.0, -gain * (diff.mean() - (b[1] - b[0]))], np.float32)
    md = DatasetMetadata(
        allocate_size=1,
        max_seq_len=sum(CTX) // 5,
        mod_bases=["m"],
        mod_long_names=["5mC"],
        motif_sequences=["CG"],
        motif_offsets=[0],
        chunk_context=CTX,
        kmer_context_bases=(4, 4),
        reverse_signal=reverse_signal,
        sig_map_refiner=refiner,
    )
    meta, arrays = jax_io.make_model_metadata(
        md, "ConvLSTM_w_ref",
        {"size": SIZE, "kmer_len": KMER_LEN, "num_out": 2},
    )
    path = out_dir / name
    jax_io.save_model(str(path), params, bn_state, meta, arrays)
    return str(path)


def write_rna_set(out_dir, n_reads=7, seed=11):
    """Reverse-signal reads (``tests/test_synthetic_rna.py``'s recipe):
    signal stored 3'->5', move tables in the stored orientation."""
    rng = np.random.default_rng(seed)
    pod5_path, bam_path = out_dir / "rna.pod5", out_dir / "rna.bam"
    header = BamHeader(
        text="@HD\tVN:1.6\tSO:unknown\n@SQ\tSN:ctg1\tLN:100000\n",
        references=["ctg1"], lengths=[100_000],
    )
    from remora_tpu.core.seq import int_to_seq

    with Pod5Writer(str(pod5_path)) as p5w, \
            BamWriter(str(bam_path), header) as bw:
        for ri in range(n_reads):
            rid = str(uuid.uuid4())
            int_seq, s2s, dacs_53 = rna_read(rng, n_bases=600)
            sig_len = int(s2s[-1])
            p5w.add_read(rid, dacs_53[::-1], 90.0, 20.0)
            mv = np.zeros(sig_len, dtype=np.uint8)
            mv[(sig_len - s2s[1:])[::-1]] = 1
            seq = int_to_seq(int_seq)
            bw.write(BamRecord(
                query_name=rid, flag=0, reference_id=0,
                reference_start=1000 * ri, mapq=60,
                cigartuples=[(0, len(seq))], query_sequence=seq,
                query_qualities=np.full(len(seq), 30, np.uint8),
                tags=[("MD", "Z", str(len(seq))), ("sm", "f", 0.0),
                      ("sd", "f", 1.0),
                      ("mv", "Bc", np.concatenate([[1], mv]).astype(
                          np.int8))],
                header=header,
            ))
    return str(pod5_path), str(bam_path)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_infer_pipeline")


@pytest.fixture(scope="module")
def data_set(workdir):
    sub = workdir / "set"
    sub.mkdir()
    return write_test_set(sub)


@pytest.fixture(scope="module")
def model_path(workdir):
    return write_model(workdir, "size16.npz")


@pytest.fixture(autouse=True)
def _no_index_cache(monkeypatch):
    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE", "0")


def run_jax(pod5, bam, path, out, compute_dtype=None, **kwargs):
    handle = jax_infer.ModelHandle.load(path, compute_dtype=compute_dtype)
    with time_limit(), captured("RemoraTPU") as msgs:
        n = jax_infer.infer_from_pod5_and_bam(
            pod5, bam, [handle], str(out), batch_size=BATCH, **kwargs)
    return n, skip_tally(msgs)


def run_port(pod5, bam, path, out, compute_dtype=None, **kwargs):
    handle = infer.ModelHandle.load(path, device="cpu",
                                    compute_dtype=compute_dtype)
    with time_limit(), captured("RemoraTPUTorch") as msgs:
        n = infer.infer_from_pod5_and_bam(
            pod5, bam, [handle], str(out), batch_size=BATCH, **kwargs)
    return n, skip_tally(msgs)


def records_by_alignment(path):
    """{(read id, flag, ref start): record fields} of a BAM (order-free:
    the drivers write reads in set order)."""
    out = {}
    for rec in FastBamScanner(str(path)):
        key = (rec.query_name, rec.flag, rec.reference_start)
        assert key not in out
        out[key] = rec
    return out


def ml_of(rec):
    return np.asarray(rec.tag_dict()["ML"], np.uint8)


def assert_identical_outputs(got_path, want_path):
    got, want = records_by_alignment(got_path), records_by_alignment(
        want_path)
    assert got.keys() == want.keys()
    n_calls = 0
    for key, w in want.items():
        g = got[key]
        assert g.tag_dict()["MM"] == w.tag_dict()["MM"], key
        assert np.array_equal(ml_of(g), ml_of(w)), key
        assert _record_fields(g) == _record_fields(w), key
        n_calls += ml_of(w).size
    return want, n_calls


@pytest.mark.parametrize("ref_anchored", [False, True])
def test_f32_tags_identical(data_set, model_path, workdir, ref_anchored):
    pod5, bam = data_set
    tag = f"ref{int(ref_anchored)}"
    n_jax, tally_jax = run_jax(pod5, bam, model_path,
                               workdir / f"jax_{tag}.bam",
                               ref_anchored=ref_anchored)
    n_port, tally_port = run_port(pod5, bam, model_path,
                                  workdir / f"port_{tag}.bam",
                                  ref_anchored=ref_anchored)
    assert n_port == n_jax > 0
    assert tally_port == tally_jax
    assert tally_jax.get("Missing BAM tags") == 1
    want, n_calls = assert_identical_outputs(workdir / f"port_{tag}.bam",
                                             workdir / f"jax_{tag}.bam")
    assert len(want) == n_jax
    # the calls do not fill the last batch, and the bytes spread
    assert n_calls % BATCH != 0 and n_calls > 3 * BATCH
    all_ml = np.concatenate([ml_of(r) for r in want.values()])
    assert len(np.unique(all_ml)) > 20
    reverse = [r for r in want.values() if r.is_reverse]
    assert len(reverse) == 1
    if ref_anchored:
        assert all(r.cigartuples == [(0, len(r.query_sequence))]
                   for r in want.values())


def test_reverse_signal_tags_identical(workdir):
    sub = workdir / "rna"
    sub.mkdir()
    pod5, bam = write_rna_set(sub)
    path = write_model(sub, "rna16.npz", reverse_signal=True)
    n_jax, tally_jax = run_jax(pod5, bam, path, sub / "jax.bam")
    n_port, tally_port = run_port(pod5, bam, path, sub / "port.bam")
    assert n_port == n_jax == 7
    assert tally_port == tally_jax
    _want, n_calls = assert_identical_outputs(sub / "port.bam",
                                              sub / "jax.bam")
    assert n_calls > BATCH


def test_bf16_ml_within_one(data_set, model_path, workdir):
    """The bf16 contract: ML bytes within 1 of the JAX package's bf16
    output, MM identical, at the head whose logit difference spreads by
    1.5. There bf16 moves the JAX package's bytes by more than 4 from its
    own f32 bytes (checked), so a bf16 forward that drifts would show."""
    pod5, bam = data_set
    outs = {}
    for tag, run, dtype in (("jax_f32", run_jax, None),
                            ("jax_bf16", run_jax, jnp.bfloat16),
                            ("port_bf16", run_port, torch.bfloat16)):
        run(pod5, bam, model_path, workdir / f"{tag}.bam",
            compute_dtype=dtype)
        outs[tag] = records_by_alignment(workdir / f"{tag}.bam")

    def worst(a, b):
        assert outs[a].keys() == outs[b].keys()
        out = 0
        for key, rec in outs[b].items():
            assert outs[a][key].tag_dict()["MM"] == rec.tag_dict()["MM"]
            delta = ml_of(outs[a][key]).astype(int) - ml_of(rec)
            out = max(out, int(np.abs(delta).max(initial=0)))
        return out

    assert worst("port_bf16", "jax_bf16") <= 1
    assert worst("jax_bf16", "jax_f32") > 4


@pytest.mark.parametrize("entry", ["eval_fn", "eval_raw"])
def test_bf16_logits_match_jax(model_path, entry):
    """The bf16 forward's f32 logits against the JAX package's bf16 logits
    on seeded chunks, through the host-featurized (``eval_fn``) and the
    device-featurized (``eval_raw``) entry: within a quarter of bf16's
    epsilon times the logits' magnitude, while bf16 moves the JAX
    package's logits from its f32 logits by more than four times that."""
    width = sum(CTX)
    sigs, seqs, maps, lens = bench._synth_inputs(256, width, KMER_LEN)[:4]
    if entry == "eval_raw":
        args = (sigs, seqs, maps, lens)
    else:
        enc = compute_encoded_kmer_batch(
            4, 4, *(torch.from_numpy(a) for a in (seqs, maps, lens)), width)
        args = (sigs, enc.numpy())
    jax_bf16 = jax_infer.ModelHandle.load(model_path,
                                          compute_dtype=jnp.bfloat16)
    jax_f32 = jax_infer.ModelHandle.load(model_path)
    port_bf16 = infer.ModelHandle.load(model_path, device="cpu",
                                       compute_dtype=torch.bfloat16)
    want = np.asarray(getattr(jax_bf16, entry)(*args))
    got = getattr(port_bf16, entry)(*args).numpy()
    f32 = np.asarray(getattr(jax_f32, entry)(*args))
    tol = torch.finfo(torch.bfloat16).eps * np.abs(want).max() / 4
    assert np.abs(got - want).max() <= tol
    assert np.abs(want - f32).max() > 4 * tol


@pytest.fixture(scope="module")
def refine_model_path(workdir):
    """The size-16 model with a SigMapRefiner in its metadata (phase 8b's
    9-mer level table, rough rescale, no scale iterations)."""
    from remora_tpu.refine.refiner import SigMapRefiner

    table, center = synth_level_table(KMER_LEN)
    refiner = SigMapRefiner(
        _levels_array=table, center_idx=center, do_rough_rescale=True,
        scale_iters=0)
    return write_model(workdir, "refine16.npz", refiner=refiner)


def test_device_refiner_matches_native(data_set, workdir, refine_model_path):
    """A checkpoint that carries a SigMapRefiner: the port with
    refine_backend="device" (K4/K5's plain versions on the CPU) writes the
    JAX package's tags with "native"."""
    path = refine_model_path
    pod5, bam = data_set
    n_jax, tally_jax = run_jax(pod5, bam, path, workdir / "jax_refine.bam",
                               refine_backend="native")
    port_dp.LAUNCHES_FWD = port_dp.LAUNCHES_TB = 0
    port_refiner.PLANNED_LAUNCHES = port_refiner.HOST_ROUTED_READS = 0
    n_port, tally_port = run_port(pod5, bam, path,
                                  workdir / "port_refine.bam",
                                  refine_backend="device")
    assert n_port == n_jax > 0
    assert tally_port == tally_jax
    assert_identical_outputs(workdir / "port_refine.bam",
                             workdir / "jax_refine.bam")
    # the device DP ran (in the driver's process: the counts are this
    # process's), on the plain versions: a CPU tensor launches nothing
    assert port_refiner.PLANNED_LAUNCHES > 0
    assert port_refiner.HOST_ROUTED_READS == 0
    assert (port_dp.LAUNCHES_FWD, port_dp.LAUNCHES_TB) == (0, 0)


def test_auto_refine_backend_on_cpu_stays_on_host(data_set, workdir,
                                                  refine_model_path):
    """refine_backend=None resolves "auto" with the in-process probe of the
    models' device: a CPU handle has no GPU link, so the DP stays on the
    host (no device plan) and the tags equal the JAX driver's."""
    pod5, bam = data_set
    n_jax, _ = run_jax(pod5, bam, refine_model_path,
                       workdir / "jax_auto.bam", refine_backend="native")
    port_refiner.PLANNED_LAUNCHES = 0
    n_port, _ = run_port(pod5, bam, refine_model_path,
                         workdir / "port_auto.bam")
    assert n_port == n_jax > 0
    assert port_refiner.PLANNED_LAUNCHES == 0
    assert_identical_outputs(workdir / "port_auto.bam",
                             workdir / "jax_auto.bam")


def test_device_stage_failure_raises(data_set, model_path, workdir):
    """A device stage that raises makes the driver raise RemoraError after
    draining, and never hang."""
    pod5, bam = data_set
    handle = infer.ModelHandle.load(model_path, device="cpu")

    def broken(*_arrays):
        raise RuntimeError("device lost")

    handle.eval_raw = broken
    with time_limit(), pytest.raises(RemoraError, match="call_batches"):
        infer.infer_from_pod5_and_bam(pod5, bam, [handle],
                                      str(workdir / "broken.bam"),
                                      batch_size=BATCH)


def test_device_refine_failure_raises(data_set, workdir, refine_model_path,
                                     monkeypatch):
    """A kernel that fails in the device refine stage (the DP wrapper
    raises) makes the driver raise RemoraError after draining, instead of
    writing a BAM short of the micro-batch's reads."""
    pod5, bam = data_set

    def boom(*args, **kwargs):
        raise RuntimeError("simulated kernel launch failure")

    monkeypatch.setattr(port_dp, "banded_dp_batch", boom)
    handle = infer.ModelHandle.load(refine_model_path, device="cpu")
    with time_limit(), pytest.raises(RemoraError, match="PrepReadData"):
        infer.infer_from_pod5_and_bam(
            pod5, bam, [handle], str(workdir / "refine_broken.bam"),
            batch_size=BATCH, refine_backend="device")


def test_driver_takes_model_handles_only(data_set, model_path, workdir):
    """The JAX driver's legacy (eval_fn, metadata) pairs, which featurize
    on the host, are refused before any stage starts."""
    pod5, bam = data_set
    handle = infer.ModelHandle.load(model_path, device="cpu")
    with time_limit(), pytest.raises(RemoraError, match="ModelHandle"):
        infer.infer_from_pod5_and_bam(
            pod5, bam, [(handle.eval_fn, handle.metadata)],
            str(workdir / "pairs.bam"), batch_size=BATCH)
    assert not (workdir / "pairs.bam").exists()


# ---- the host stages one by one ----


def _prepped(mod_read, mod_index, infer_mod, pod5, bam, md, ref_anchored):
    idx = mod_index.ReadIndexedBam(bam, req_tags={"mv"})
    out = []
    for read_err in sorted(mod_read.iter_signal(pod5),
                           key=lambda re_: re_[0].read_id):
        joined = mod_read.extract_alignments(read_err, idx)
        out.extend(infer_mod.prepare_reads(joined, [md], ref_anchored))
    return out


@pytest.mark.parametrize("ref_anchored", [False, True])
def test_prepare_reads_matches_jax(data_set, model_path, ref_anchored):
    from remora_tpu.io import read as jax_read
    from remora_tpu.io import read_index as jax_index

    pod5, bam = data_set
    jmd = jax_infer.ModelHandle.load(model_path).metadata
    tmd = infer.ModelHandle.load(model_path, device="cpu").metadata
    want = _prepped(jax_read, jax_index, jax_infer, pod5, bam, jmd,
                    ref_anchored)
    got = _prepped(port_read, port_index, infer, pod5, bam, tmd,
                   ref_anchored)
    assert len(got) == len(want)
    for (g_read, g_arrs, g_err), (w_read, w_arrs, w_err) in zip(got, want):
        assert (g_read.read_id, g_err) == (w_read.read_id, w_err)
        if w_arrs is None:
            assert g_arrs is None
            continue
        assert g_arrs.keys() == w_arrs.keys() == {"C"}
        for name, arr in w_arrs["C"].items():
            assert _plain(g_arrs["C"][name]) == _plain(arr), name


def _batches(infer_mod, prepped, md):
    """The batches of the compact raw arrays (the JAX package's
    ``raw=True``, the port's only form)."""
    q = NamedQueue()
    if infer_mod is jax_infer:
        nn_in = [jax_infer.prep_nn_input(prepped, raw=True)]
        jax_infer.batch_reads(nn_in, q, BATCH, [md], raw=True)
    else:
        nn_in = [infer_mod.prep_nn_input(prepped)]
        infer_mod.batch_reads(nn_in, q, BATCH, [md])
    return list(queue_iter(q))


def test_batch_and_unbatch_match_jax(data_set, model_path):
    """Batches (inputs, positions, members) equal the JAX package's, and
    unbatching seeded logits rejoins each read as the JAX package does."""
    from remora_tpu.io import read as jax_read
    from remora_tpu.io import read_index as jax_index

    pod5, bam = data_set
    jmd = jax_infer.ModelHandle.load(model_path).metadata
    tmd = infer.ModelHandle.load(model_path, device="cpu").metadata
    want = _batches(jax_infer, _prepped(jax_read, jax_index, jax_infer,
                                        pod5, bam, jmd, False), jmd)
    got = _batches(infer, _prepped(port_read, port_index, infer, pod5, bam,
                                   tmd, False), tmd)
    assert len(got) == len(want) > 2
    assert want[-1][2].size % BATCH != 0
    rng = np.random.default_rng(0)
    called = []
    for (gcb, g_in, g_pos, g_mem), (wcb, w_in, w_pos, w_mem) in zip(got,
                                                                    want):
        assert gcb == wcb == "C"
        assert [_plain(a) for a in g_in] == [_plain(a) for a in w_in]
        assert _plain(g_pos) == _plain(w_pos)
        assert ([(m[0].read_id, *m[1:]) for m in g_mem]
                == [(m[0].read_id, *m[1:]) for m in w_mem])
        logits = rng.normal(0, 2, (g_pos.size, 2)).astype(np.float32)
        called.append((gcb, logits, g_pos, g_mem, w_mem))

    def joined(infer_mod, which):
        in_q, out_q = NamedQueue(), NamedQueue()
        for cb, logits, pos, g_mem, w_mem in called:
            put_item((cb, logits, pos, g_mem if which == "port" else w_mem),
                     in_q)
        put_item(StopIteration, in_q)
        infer_mod.unbatch(in_q, out_q, [tmd if which == "port" else jmd])
        return [(rd.read_id, [(cb, _plain(o), _plain(p)) for cb, o, p in
                              calls], err)
                for rd, calls, err in queue_iter(out_q)]

    assert joined(infer, "port") == joined(jax_infer, "jax")


ABANDONED_PIPELINE = """
import time
import numpy as np
from remora_tpu_torch.core.pipeline import map_stage

def stuck(item):
    time.sleep(60)

# 20 MB of items for a forked worker that never takes a second one: the
# parent's queue buffer outgrows the pipe
items = (np.zeros(100_000, np.uint8) for _ in range(200))
stage = map_stage(stuck, items, use_process=True, q_maxsize=100)
time.sleep(2)
"""


def test_abandoned_pipeline_does_not_block_exit():
    """A process that leaves a pipeline undrained (a driver run that
    raised or timed out mid-run) exits: its stage queues do not wait at
    exit to flush items into a pipe no process reads."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run([sys.executable, "-c", ABANDONED_PIPELINE],
                          cwd=repo, capture_output=True, text=True,
                          timeout=45)
    assert done.returncode == 0, done.stderr
