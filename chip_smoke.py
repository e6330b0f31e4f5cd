#!/usr/bin/env python3
"""Smoke run of remora_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (each one that fails exits non-zero, and no result line is
printed):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build every CUDA source of the package with ``nvcc``;
3. each hand kernel against its plain PyTorch version on the card at the
   main path's shapes, with kernel / plain / ``torch.nn`` times and the
   kernel's bound;
4. the main path at full width: a seeded ConvLSTM_w_ref (size 64, 9-mer,
   chunk context (200, 200)) saved and loaded through ``ModelHandle.load``,
   fed 8 batches of 2048 synthetic raw chunks (the last one short)
   through ``run_model_batched``, f32 and bf16 legs. Each leg runs with
   the launch counts set to 0 and must launch every kernel of the path;
   logits are held to the same handle with the plain LSTM and to a CPU
   run, one pass is profiled by kernel (busy and idle share), and MM/ML
   tags are formatted for a few synthetic reads;
5. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line again, and as
   the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package ``remora_tpu``.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): FP32 outside the tensor cores, bf16
# tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# main-path shapes: batch 2048, chunk 400, 9-mer, size 64
BATCH, WIDTH, KMER_LEN, SIZE = 2048, 400, 9, 64
N_BATCHES, LAST_BATCH = 8, 1111
N_TIMED, CALLS_PER_SAMPLE = 25, 5
N_STAGE_PASSES = 11  # the host's clock is noisy: a median of many passes


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0].strip()


def synth_inputs(rng, batch, width=WIDTH, kmer_len=KMER_LEN):
    """Synthetic raw chunks: the recipe of ``bench.py::_synth_inputs``
    (signal, int8 seqs with the k-mer context, sorted int16 maps ending at
    the chunk width, ragged seq_lens), drawn from ``rng``."""
    max_seq = width // 5
    sigs = rng.normal(size=(batch, 1, width)).astype(np.float32)
    seq_lens = rng.integers(max_seq // 2, max_seq + 1, batch).astype(
        np.int16
    )
    seqs = rng.integers(0, 4, (batch, max_seq + kmer_len - 1)).astype(
        np.int8
    )
    maps = np.zeros((batch, max_seq + 1), np.int16)
    for b in range(batch):
        sl = seq_lens[b]
        maps[b, 1:sl] = np.sort(rng.integers(0, width + 1, sl - 1))
        maps[b, sl] = width
    return sigs, seqs, maps, seq_lens


def time_ms(fn, n=N_TIMED, calls=CALLS_PER_SAMPLE):
    """Median device time of one ``fn`` call over ``n`` samples after two
    warm-ups. Each sample runs ``calls`` calls back to back between two
    CUDA events, so the queue stays ahead of the card and the host's
    launch gaps drop out of a call that outlasts its own launch."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# ---------------- phase 3: kernels against their plain versions ----------


def lstm_case(dtype, T=124, B=BATCH, C=SIZE, H=SIZE, seed=0):
    """Seeded (params, x) for the last-only LSTM on the card."""
    import torch

    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    params = {
        name: torch.from_numpy(
            rng.uniform(-bound, bound, shape).astype(np.float32)
        ).cuda().to(dtype)
        for name, shape in (("w_ih", (4 * H, C)), ("w_hh", (4 * H, H)),
                            ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))
    }
    x = torch.from_numpy(rng.normal(size=(T, B, C)).astype(np.float32))
    return params, x.cuda().to(dtype)


def check_lstm_last(dtype, tol):
    import torch

    from remora_tpu_torch.infer.infer import full_f32
    from remora_tpu_torch.kernels import lstm as K

    params, x = lstm_case(dtype)
    T, B, C = x.shape
    H = params["w_hh"].shape[1]
    with full_f32():
        got = K.lstm_last(params, x)
        want = K.lstm_last_reference(params, x)
        torch.cuda.synchronize()
        check(got.shape == (B, H) and got.dtype == dtype,
              f"lstm_last {dtype}: got {tuple(got.shape)} {got.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        log(f"lstm_last {dtype}: max |dh| = {err:.3e} (tolerance {tol})")
        check(np.isfinite(err) and err <= tol,
              f"lstm_last {dtype}: kernel disagrees with the plain version "
              f"(max |dh| {err:.3e} > {tol})")

        lib_lstm = torch.nn.LSTM(C, H).cuda().to(dtype)
        with torch.no_grad():
            lib_lstm.weight_ih_l0.copy_(params["w_ih"])
            lib_lstm.weight_hh_l0.copy_(params["w_hh"])
            lib_lstm.bias_ih_l0.copy_(params["b_ih"])
            lib_lstm.bias_hh_l0.copy_(params["b_hh"])
        # one weight buffer, else cuDNN compacts the weights every call (a
        # no-op for bf16, which PyTorch's cuDNN dtype list lacks)
        lib_lstm.flatten_parameters()
        with torch.inference_mode():
            ms = time_ms(lambda: K.lstm_last(params, x))
            plain_ms = time_ms(lambda: K.lstm_last_reference(params, x))
            # the yardstick only: cuDNN's LSTM, all T hidden states
            library_ms = time_ms(lambda: lib_lstm(x))
    flops = 2.0 * T * B * (C + H) * 4 * H
    io_bytes = (x.numel() + (C + H + 1) * 4 * H + B * H) * x.element_size()
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    ops_ms = flops / peak * 1e3
    bytes_ms = io_bytes / PEAK_BYTES_PER_S * 1e3
    name = "lstm_last_" + ("f32" if dtype == torch.float32 else "bf16")
    log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.nn.LSTM {library_ms} ms, bound {max(ops_ms, bytes_ms):.4f}"
        f" ms ({flops / 1e9:.2f} GFLOP, {io_bytes / 1e6:.2f} MB)")
    return {
        "name": name,
        "route": "cuda",
        "source": "remora_tpu_torch/csrc/lstm_last.cu",
        "replaces": "remora_tpu/kernels/pallas_lstm.py:181",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }


# ---------------- phase 4: the main path ----------------


def calibrate(model, arrs):
    """Set each BatchNorm's running statistics to those of its conv's
    output on ``arrs`` (CPU forward), as training would leave them, so the
    random model's activations keep their scale through the towers."""
    import torch

    from remora_tpu_torch.kernels.encoded_kmers import (
        compute_encoded_kmer_batch,
    )
    from remora_tpu_torch.models import layers as L

    children = list(model.children())
    hooks = []
    for conv, bn in zip(children, children[1:]):
        if isinstance(conv, L.Conv1d) and isinstance(bn, L.BatchNorm):
            def hook(_mod, _inp, y, bn=bn):
                bn.mean.copy_(y.mean((0, 1)))
                bn.var.copy_(y.var((0, 1)))

            hooks.append(conv.register_forward_hook(hook))
    sigs, seqs, maps, lens = (torch.from_numpy(a) for a in arrs)
    with torch.no_grad():
        enc = compute_encoded_kmer_batch(
            KMER_LEN // 2, KMER_LEN - 1 - KMER_LEN // 2, seqs, maps, lens,
            WIDTH,
        )
        model(sigs, enc)
    for h in hooks:
        h.remove()


def seeded_checkpoint(path, seed=1):
    """Save a ConvLSTM_w_ref with numpy-seeded weights (fan-in uniform
    bounds, BatchNorm statistics calibrated on seeded synthetic chunks)
    via ``save_model``."""
    from remora_tpu_torch.models import conv_lstm_model, model_io

    rng = np.random.default_rng(seed)
    model = conv_lstm_model.init(size=SIZE, kmer_len=KMER_LEN, num_out=2)
    params, bn_state = model_io.module_to_trees(model)
    for name, leaves in params.items():
        if "gamma" in leaves:
            leaves["gamma"] = rng.uniform(0.5, 1.5, leaves["gamma"].shape)
            leaves["beta"] = rng.uniform(-0.1, 0.1, leaves["beta"].shape)
            continue
        # every leaf of a layer takes its first weight's fan-in bound; the
        # recurrent layers and the head 4x wider, so the calls spread
        w = next(a for a in leaves.values() if a.ndim > 1)
        bound = 1.0 / np.sqrt(np.prod(w.shape[1:]))
        if name in ("lstm1", "lstm2", "fc"):
            bound *= 4
        for leaf, arr in leaves.items():
            leaves[leaf] = rng.uniform(-bound, bound, arr.shape)
    model.load_state_dict(model_io.params_from_numpy(params, bn_state))
    calibrate(model, synth_inputs(rng, 256))
    meta = {
        "model_name": conv_lstm_model.NAME,
        "model_params": {"size": SIZE, "kmer_len": KMER_LEN, "num_out": 2},
        "chunk_context": [WIDTH // 2, WIDTH // 2],
        "kmer_context_bases": [KMER_LEN // 2, KMER_LEN - 1 - KMER_LEN // 2],
        "motifs": [["CG", 0]],
        "num_motifs": 1,
        "mod_bases": ["m"],
        "mod_long_names": ["5mC"],
        "reverse_signal": False,
        "base_start_justify": False,
        "offset": 0,
        "pa_scaling": None,
    }
    model_io.save_model(path, model, meta)


def make_batches(seed=2):
    rng = np.random.default_rng(seed)
    batches = []
    for i in range(N_BATCHES):
        n = LAST_BATCH if i == N_BATCHES - 1 else BATCH
        batches.append(synth_inputs(rng, n))
    return batches


def run_stage(handle, batches):
    """Drive ``run_model_batched`` over the batches; returns (logits per
    batch as numpy, wall seconds). One canonical base "C"; each batch's
    rows are one read's calls."""
    from remora_tpu_torch.core.pipeline import NamedQueue, put_item
    from remora_tpu_torch.infer.infer import run_model_batched

    batches_q, called_q = NamedQueue(), NamedQueue()
    for i, arrs in enumerate(batches):
        n = arrs[0].shape[0]
        put_item(("C", arrs, np.arange(n), [(f"read{i}", 0, n, None)]),
                 batches_q)
    put_item(StopIteration, batches_q)
    t0 = time.perf_counter()
    run_model_batched(batches_q, called_q, {"C": handle.eval_raw}, BATCH)
    wall = time.perf_counter() - t0
    outs = []
    while True:
        item = called_q.get()
        if item is StopIteration:
            break
        outs.append(item[1])
    return outs, wall


@contextlib.contextmanager
def plain_lstm():
    """Route the model's last-only LSTM through the plain version."""
    from remora_tpu_torch.kernels import lstm as K

    kernel = K.lstm_last
    K.lstm_last = K.lstm_last_reference
    try:
        yield
    finally:
        K.lstm_last = kernel


def ml_bytes(logits):
    from remora_tpu_torch.core.tags import softmax

    probs = softmax(logits)[:, 1:].astype(np.float64)
    return np.minimum(np.floor(probs * 256), 255).astype(np.int64)


def profile_stage(handle, batches, wall):
    """Device time by kernel over one ``run_model_batched`` pass
    (torch.profiler), and the kernels' busy share of ``wall``, the
    unprofiled median pass (the profiled pass's own wall, which the
    profiler's host overhead inflates, is printed beside it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, profiled_wall = run_stage(handle, batches)
    # kernels only: a CPU op's device time repeats its kernels' time
    rows = sorted(
        ((evt.self_device_time_total, evt.key, evt.count)
         for evt in prof.key_averages()
         if evt.device_type == DeviceType.CUDA
         and evt.self_device_time_total > 0),
        reverse=True,
    )
    if not rows:
        log("  profile: the profiler recorded no device time "
            "(device breakdown not measured)")
        return
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"  profile of one pass ({len(batches)} batches): kernels busy "
        f"{busy_s * 1e3:.4f} ms; unprofiled median wall {wall * 1e3:.4f} ms "
        f"({busy_s / wall:.1%} busy, {1 - busy_s / wall:.1%} idle); "
        f"profiled wall {profiled_wall * 1e3:.4f} ms")
    for dev_us, key, count in rows[:12]:
        log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")


def run_leg(path, batches, compute_dtype, tag):
    import torch

    from remora_tpu_torch.infer.infer import ModelHandle
    from remora_tpu_torch.kernels import lstm as K

    # no device named: the entry point's default is the GPU
    handle = ModelHandle.load(path, compute_dtype=compute_dtype)
    check(handle.device.type == "cuda", f"{tag}: handle on {handle.device}")
    run_stage(handle, batches)  # warm-up: cuDNN plans, pinned buffers
    torch.cuda.synchronize()
    K.LAUNCHES = 0
    outs, wall = run_stage(handle, batches)
    launches = K.LAUNCHES
    # more timed passes after the counted one, for a steadier rate
    walls = [wall] + [run_stage(handle, batches)[1]
                      for _ in range(N_STAGE_PASSES - 1)]
    wall = statistics.median(walls)
    n_chunks = sum(a[0].shape[0] for a in batches)
    log(f"{tag}: {n_chunks} chunks through run_model_batched, walls "
        f"{[round(w, 5) for w in walls]} s, median {wall:.5f} s = "
        f"{n_chunks / wall:.1f} chunks/s ({len(batches)} batches, "
        f"lstm_last launches {launches})")
    check(launches == len(batches),
          f"{tag}: lstm_last launched {launches} times for "
          f"{len(batches)} batches")
    check(len(outs) == len(batches), f"{tag}: {len(outs)} batches out")
    for arrs, out in zip(batches, outs):
        check(out.shape == (arrs[0].shape[0], 2) and out.dtype == np.float32,
              f"{tag}: logits {out.shape} {out.dtype}")
        check(np.isfinite(out).all(), f"{tag}: non-finite logits")

    with plain_lstm():
        plain = [handle.eval_raw(*arrs).cpu().numpy()[: arrs[0].shape[0]]
                 for arrs in batches]
    if compute_dtype is None:
        err = max(np.abs(o - p).max() for o, p in zip(outs, plain))
        log(f"{tag}: max |logit - plain-LSTM logit| = {err:.3e} "
            "(tolerance 1e-4)")
        check(err <= 1e-4, f"{tag}: logits disagree with the plain LSTM")
    else:
        diff = max(np.abs(ml_bytes(o) - ml_bytes(p)).max()
                   for o, p in zip(outs, plain))
        moved = sum(int((ml_bytes(o) != ml_bytes(p)).sum())
                    for o, p in zip(outs, plain))
        log(f"{tag}: ML bytes vs plain LSTM: {moved} moved, max |delta| "
            f"{diff} (tolerance 1)")
        check(diff <= 1, f"{tag}: ML bytes moved by more than 1")
    profile_stage(handle, batches, wall)
    return outs, launches, n_chunks / wall


def check_cpu_agreement(path, batches, gpu_logits, n=64):
    """The first ``n`` chunks through a CPU handle (plain path)."""
    from remora_tpu_torch.infer.infer import ModelHandle

    cpu = ModelHandle.load(path, device="cpu")
    arrs = tuple(a[:n] for a in batches[0])
    want = cpu.eval_raw(*arrs).numpy()
    err = np.abs(gpu_logits[0][:n] - want).max()
    log(f"f32 card vs CPU ({n} chunks): max |dlogit| = {err:.3e} "
        "(tolerance 1e-4)")
    check(err <= 1e-4, "f32 logits on the card disagree with the CPU")


def format_tags(logits, n_reads=3, seed=3):
    """MM/ML tags for synthetic reads: each read's CpG sites take the next
    rows of the f32 logits."""
    from remora_tpu_torch.core.tags import (
        format_mm_ml_tags,
        mods_tags_to_str,
        softmax,
    )

    rng = np.random.default_rng(seed)
    row = 0
    for r in range(n_reads):
        seq = "".join(rng.choice(list("ACGT"), 300))
        poss = [i for i in range(len(seq) - 1) if seq[i:i + 2] == "CG"]
        poss = poss[: len(logits) - row]
        probs = softmax(logits[row:row + len(poss)])[:, 1:].astype(
            np.float64
        )
        row += len(poss)
        mm, ml = format_mm_ml_tags(seq, poss, probs, ["m"], "C")
        check(len(ml) == len(poss), "ML tag length != number of calls")
        mm_str, ml_str = mods_tags_to_str([mm], ml)
        log(f"read{r}: {len(poss)} calls  {mm_str[:60]}...  {ml_str[:60]}...")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "remora_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(remora_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    # per-batch host dispatch / fetch / input-wait of every stage pass
    os.environ["REMORA_TPU_INFER_STAGE_STATS"] = "1"
    from remora_tpu_torch.kernels import _build

    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.device_count()} "
        "visible card(s)")
    t0 = time.monotonic()
    _build.build_all()
    log(f"built {_build.sources()} in {time.monotonic() - t0:.1f} s")
    for name, (secs, out) in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    kernels = {
        torch.float32: check_lstm_last(torch.float32, 1e-5),
        torch.bfloat16: check_lstm_last(torch.bfloat16, 2e-2),
    }

    batches = make_batches()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "convlstm_size64.npz")
        seeded_checkpoint(path)
        logits, launches, f32_rate = run_leg(path, batches, None, "f32")
        kernels[torch.float32]["launches"] = launches
        _, launches, bf16_rate = run_leg(path, batches, torch.bfloat16,
                                         "bf16")
        kernels[torch.bfloat16]["launches"] = launches
        check_cpu_agreement(path, batches, logits)
    format_tags(np.concatenate(logits))
    log(json.dumps({"slice": {
        "f32_chunks_per_s": f32_rate, "bf16_chunks_per_s": bf16_rate,
        "batches": N_BATCHES, "batch": BATCH, "last_batch": LAST_BATCH,
        "width": WIDTH, "kmer_len": KMER_LEN, "size": SIZE,
    }}))
    log(json.dumps({"kernels": list(kernels.values())}))
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        sys.exit(1)
