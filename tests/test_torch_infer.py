"""The port's inference device stage against the JAX package's on the CPU:
ModelHandle.eval_raw / eval_fn and run_model_batched at full width
(size 64, 9-mer, chunk 400) and batch 16."""

import numpy as np
import pytest
import torch

import bench
from remora_tpu.core.tags import softmax as jax_softmax
from remora_tpu.data.encoded_kmers import compute_encoded_kmer_batch
from remora_tpu.infer.infer import ModelHandle as JaxHandle
from remora_tpu.models import model_io as jax_io
from remora_tpu_torch.core.pipeline import NamedQueue, put_item
from remora_tpu_torch.core.tags import softmax
from remora_tpu_torch.infer.infer import ModelHandle, run_model_batched
from remora_tpu_torch.models import conv_lstm_model, model_io

from chip_smoke import calibrate
from tests.test_torch_models import _meta, _numpy_trees

B, WIDTH, KMER_LEN, SIZE = 16, 400, 9, 64


def _ml_bytes(logits, softmax_fn=softmax):
    probs = softmax_fn(logits)[:, 1:].astype(np.float64)
    return np.minimum(np.floor(probs * 256), 255).astype(np.uint8)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, batches):
    """A size-64 ConvLSTM written by the JAX package's save_model. The
    recurrent layers and the head are drawn 4x wider than at init and the
    BatchNorm statistics are calibrated, so the ML bytes spread."""
    params, bn_state = _numpy_trees(conv_lstm_model, SIZE, KMER_LEN, 2, 11)
    for name in ("lstm1", "lstm2", "fc"):
        params[name] = {k: 4 * v for k, v in params[name].items()}
    model = conv_lstm_model.init(size=SIZE, kmer_len=KMER_LEN)
    model.load_state_dict(model_io.params_from_numpy(params, bn_state))
    calibrate(model, batches[0])
    params, bn_state = model_io.module_to_trees(model)
    meta = _meta("ConvLSTM_w_ref", (WIDTH // 2, WIDTH // 2))
    meta["model_params"] = {"size": SIZE, "kmer_len": KMER_LEN, "num_out": 2}
    path = tmp_path_factory.mktemp("torch_infer") / "convlstm64.npz"
    jax_io.save_model(path, params, bn_state, meta)
    return path


@pytest.fixture(scope="module")
def batches():
    """Three batches of raw chunks (bench.py's recipe), the last short."""
    sigs, seqs, maps, lens, _ = bench._synth_inputs(2 * B + 9, WIDTH,
                                                    KMER_LEN)
    arrs = (sigs, seqs, maps, lens)
    return [tuple(a[i:i + B] for a in arrs) for i in range(0, 2 * B + 9, B)]


@pytest.fixture(scope="module")
def jax_logits(checkpoint, batches):
    handle = JaxHandle.load(str(checkpoint))
    return [np.asarray(handle.eval_raw(*b)) for b in batches[:2]]


def test_eval_raw_matches_jax(checkpoint, batches, jax_logits):
    handle = ModelHandle.load(checkpoint, device="cpu")
    for arrs, want in zip(batches, jax_logits):
        got = handle.eval_raw(*arrs)
        assert got.dtype == torch.float32 and got.shape == (B, 2)
        got = got.numpy()
        assert np.allclose(got, want, atol=1e-5, rtol=0)
        ml = _ml_bytes(got)
        assert np.array_equal(ml, _ml_bytes(want, jax_softmax))
        assert len(np.unique(ml)) > 3  # the weights spread the calls


def test_eval_fn_matches_eval_raw(checkpoint, batches):
    handle = ModelHandle.load(checkpoint, device="cpu")
    sigs, seqs, maps, lens = batches[0]
    enc = compute_encoded_kmer_batch(4, 4, seqs, maps, lens)
    got = handle.eval_fn(sigs, enc).numpy()
    want = handle.eval_raw(sigs, seqs, maps, lens).numpy()
    assert np.allclose(got, want, atol=1e-6, rtol=0)


def test_run_model_batched_short_last_batch(checkpoint, batches,
                                            jax_logits, monkeypatch):
    monkeypatch.setenv("REMORA_TPU_INFER_INFLIGHT", "1")
    handle = ModelHandle.load(checkpoint, device="cpu")
    batches_q, called_q = NamedQueue(), NamedQueue()
    for i, arrs in enumerate(batches):
        n = arrs[0].shape[0]
        put_item(("C", arrs, np.arange(n), [(f"r{i}", 0, n, None)]),
                 batches_q)
    put_item(StopIteration, batches_q)
    run_model_batched(batches_q, called_q, {"C": handle.eval_raw}, B)
    outs = []
    while (item := called_q.get(timeout=10)) is not StopIteration:
        outs.append(item)
    assert [o[1].shape for o in outs] == [(B, 2), (B, 2), (9, 2)]
    assert [o[3][0][0] for o in outs] == ["r0", "r1", "r2"]
    for (_cb, logits, _pos, _members), arrs in zip(outs, batches):
        want = handle.eval_raw(*arrs).numpy()
        assert np.allclose(logits, want, atol=1e-6, rtol=0)
    for (_cb, logits, _pos, _members), want in zip(outs, jax_logits):
        assert np.array_equal(_ml_bytes(logits),
                              _ml_bytes(want, jax_softmax))


def test_bf16_handle(checkpoint, batches):
    f32 = ModelHandle.load(checkpoint, device="cpu")
    bf16 = ModelHandle.load(checkpoint, device="cpu",
                            compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf16.model.parameters())
    assert all(b.dtype == torch.bfloat16 for b in bf16.model.buffers())
    got = bf16.eval_raw(*batches[0])
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = f32.eval_raw(*batches[0])
    # the bf16 contract of the JAX package: ML bytes move by at most 1/256
    drift = np.abs(_ml_bytes(got.numpy()).astype(int)
                   - _ml_bytes(want.numpy()).astype(int))
    assert drift.max() <= 1
