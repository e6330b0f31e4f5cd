"""Inference device stage: loaded model -> logits for batches of chunks.

Counterpart of the device-stage part of ``remora_tpu/infer/infer.py``
(``ModelHandle``, ``make_model_eval_fn``, ``_cast_state`` and
``run_model_batched``). The streaming POD5 + BAM driver around it comes
in a later slice.

Entry points run on the GPU unless the caller names ``device="cpu"``;
with no GPU and no device named, ``ModelHandle.load`` raises.

Precision: the f32 path runs convs and matmuls in full f32 (TF32 off for
cuDNN and cuBLAS), as the JAX kernels pin ``Precision.HIGHEST``. The
bf16 path casts parameters and inputs to bf16 and returns f32 logits.
"""

import contextlib
import os
import time
from collections import deque

import torch

from remora_tpu_torch import log
from remora_tpu_torch.core.pipeline import put_item, queue_iter
from remora_tpu_torch.core.util import pad_rows, resolve_device
from remora_tpu_torch.kernels.encoded_kmers import compute_encoded_kmer_batch
from remora_tpu_torch.models import model_io

LOGGER = log.get_logger()


@contextlib.contextmanager
def full_f32():
    """f32 convs and matmuls in full f32: TF32 off for cuDNN and cuBLAS.
    (These are process-wide flags; they are restored on exit.)"""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _put(arr, device):
    """Host array (or tensor) -> tensor on ``device``. Host memory bound
    for a GPU is staged through pinned memory so the copy is async on the
    current stream."""
    t = torch.as_tensor(arr)
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _cast_state(model, compute_dtype):
    """Cast every float32 parameter and buffer to ``compute_dtype``
    (in place; None leaves the model as it is)."""
    if compute_dtype is None:
        return model
    return model.to(compute_dtype)


def _model_device(model):
    return next(model.parameters()).device


def make_model_eval_fn(model, compute_dtype=None):
    """Logits fn ``(sigs, enc_kmers) -> (B, num_out)`` f32 tensor on the
    model's device, for host-featurized batches in (B, C, T) layout.

    ``compute_dtype`` (``torch.bfloat16``) runs the forward in reduced
    precision with f32 logits out; the default f32 path is the
    reference-parity one.
    """
    model = _cast_state(model, compute_dtype)
    device = _model_device(model)

    @torch.inference_mode()
    def _eval(sigs, enc_kmers):
        sigs, enc_kmers = _put(sigs, device), _put(enc_kmers, device)
        if compute_dtype is not None:
            sigs = sigs.to(compute_dtype)
            enc_kmers = enc_kmers.to(compute_dtype)
        with full_f32():
            return model(sigs, enc_kmers).float()

    return _eval


class ModelHandle:
    """Loaded model + eval paths for the inference device stage.

    ``eval_fn(sigs, enc_kmers)`` consumes host-featurized batches;
    ``eval_raw(sigs, seqs, maps, lens)`` featurizes on the device, so each
    batch ships the compact ragged arrays instead of the ~50x larger
    one-hot features. Both return f32 logits on the model's device.
    """

    def __init__(self, model, metadata, compute_dtype=None):
        self.model = _cast_state(model.eval(), compute_dtype)
        self.metadata = metadata
        self.compute_dtype = compute_dtype
        self.device = _model_device(self.model)
        self._eval = None

    @property
    def eval_fn(self):
        if self._eval is None:
            self._eval = make_model_eval_fn(self.model, self.compute_dtype)
        return self._eval

    @torch.inference_mode()
    def eval_raw(self, sigs, seqs, maps, lens):
        """sigs (B, 1, W) f32, seqs (B, S + ctx) int8, maps (B, S + 1),
        lens (B,) -> f32 logits (B, num_out)."""
        bb, ab = self.metadata["kmer_context_bases"]
        cd = self.compute_dtype
        sigs, seqs, maps, lens = (
            _put(a, self.device) for a in (sigs, seqs, maps, lens)
        )
        # (B, 4K, W): the convs' native layout on the GPU, so the towers
        # take their inputs without a relayout (the TPU path prefers
        # channels-last)
        enc = compute_encoded_kmer_batch(
            bb, ab, seqs, maps, lens, self.metadata["chunk_len"],
            out_dtype=cd,
        )
        if cd is not None:
            sigs = sigs.to(cd)
        with full_f32():
            return self.model(sigs, enc).float()

    @classmethod
    def load(cls, path, device=None, compute_dtype=None):
        device = resolve_device(device)
        model, meta = model_io.load_model(path)
        return cls(model.to(device), meta, compute_dtype=compute_dtype)


def run_model_batched(batches_q, called_batches_q, eval_fns,
                      device_batch_size):
    """Device stage: forward per canonical base, padded last batch.

    Up to REMORA_TPU_INFER_INFLIGHT (default 2) batches stay in flight:
    each batch's forward and its device->host copy into pinned memory are
    queued on a side CUDA stream and fenced by an event, so the copy of
    batch N overlaps the host->device copy and compute of batch N+1; the
    host waits on a batch's event only when it emits that batch.
    """
    inflight = max(1, int(os.getenv("REMORA_TPU_INFER_INFLIGHT", "2")))
    pending = deque()
    stats = {"batches": 0, "dispatch_s": 0.0, "fetch_s": 0.0,
             "wait_s": 0.0}
    stream = None
    if torch.cuda.is_available():
        # the side stream starts after all work queued so far (the
        # model's own host->device copies included)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())

    def emit_oldest():
        cb, host, done, live, b_read_pos, b_reads = pending.popleft()
        t0 = time.monotonic()
        if done is not None:
            done.synchronize()
        nn_out = host.numpy()[:live]
        stats["fetch_s"] += time.monotonic() - t0
        put_item((cb, nn_out, b_read_pos, b_reads), called_batches_q)

    batch_iter = queue_iter(batches_q)
    with torch.cuda.stream(stream):  # no-op for None
        while True:
            t0 = time.monotonic()
            item = next(batch_iter, None)
            stats["wait_s"] += time.monotonic() - t0
            if item is None:
                break
            cb, b_inputs, b_read_pos, b_reads = item
            live = b_read_pos.size
            if b_inputs[0].shape[0] != device_batch_size:
                # pad up to the fixed batch shape; outputs are sliced back
                b_inputs = tuple(
                    pad_rows(arr, device_batch_size) for arr in b_inputs
                )
            t0 = time.monotonic()
            out = eval_fns[cb](*b_inputs)
            done = None
            if out.is_cuda:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host = out
            stats["dispatch_s"] += time.monotonic() - t0
            stats["batches"] += 1
            pending.append((cb, host, done, live, b_read_pos, b_reads))
            if len(pending) > inflight:
                emit_oldest()
        while pending:
            emit_oldest()
    if os.getenv("REMORA_TPU_INFER_STAGE_STATS"):
        n = max(stats["batches"], 1)
        LOGGER.info(
            f"Device stage: {stats['batches']} batches, per-batch "
            f"dispatch {stats['dispatch_s'] / n * 1e3:.1f}ms, "
            f"fetch {stats['fetch_s'] / n * 1e3:.1f}ms, "
            f"input-wait {stats['wait_s'] / n * 1e3:.1f}ms"
        )
    put_item(StopIteration, called_batches_q)
