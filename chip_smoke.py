#!/usr/bin/env python3
"""Smoke run of remora_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (each one that fails exits non-zero, and no result line is
printed):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build every CUDA source of the package with ``nvcc``;
3. each hand kernel against its plain PyTorch version on the card at the
   main paths' shapes, with kernel / plain / ``torch.nn`` times and the
   kernel's bound (K1-K3 also their serial chain's floor): K1 (last-only
   LSTM), and (3b) K2 and K3 (the training LSTM forward and backward) at
   T=124, B=2048, C=H=64, K3 in bf16 also part by part (gates,
   recurrence, products: each held to its plain twin and timed); K1 and
   K2 run one kernel a dtype (f32 ``lstm_fwd_f32.cu`` on the FP32 pipes,
   bf16 ``lstm_fwd_mma.cu`` on the tensor cores), K3 in f32 one launch
   (``lstm_bwd_f32.cu``); no ptxas spill allowed in them or in K3 bf16's,
   and K1-K3 repeated bit for bit in both dtypes; (3c) K6 (the
   conv+BN+swish backward) at the four stride-1 block shapes of the
   training path, f32 and bf16 (db against the plain math in f64), with
   ``ConvBNSwish.backward``'s cuDNN path as the library yardstick; (3d)
   the wide LSTM legs (``lstm_wide.cu`` for K1/K2, ``lstm_wide_bwd.cu``
   for K3, the shapes the main-shape kernels refuse) at T=124, B=2048
   and C=H=96 (the shape 6e gives them; these records take 6e's launches
   into the kernels line) and C=H=128 (a line of its own), K1, K2 and K3
   in both dtypes against their plain versions, with times, bounds,
   chains, ``torch.nn.LSTM`` times, registers and spills, the wide K3 by
   part, and lines of the wide K1/K2 beside cuDNN's forward and of the
   wide K3 beside cuDNN's backward at both widths; (3e) the general LSTM
   leg (C or H past 128: K1/K2 on ``lstm_general_cluster.cu``'s cluster
   path where ``kernels.lstm.general_fwd_plan`` takes the shape, else on
   ``lstm_general.cu``'s streaming path; K3 on ``lstm_general.cu``) at
   T=124, B=2048 and C=H=160 (the shape 6g gives it; these records take
   6g's launches into the kernels line) and C=H=256 (a line of its own;
   f32 K1/K2 there, which the plan refuses, run the streaming path, and
   their records take 6g's size-256 leg's launches), K1, K2 (with and
   without cs) and K3 in both dtypes against their plain versions, each
   repeated bit for bit, with times beside the parent design's
   (``PARENT_GENERAL_MS``), bounds, chains, ``torch.nn.LSTM`` times, the
   path, cluster size and rows, registers and spills, the card's cluster
   capacity, and K3 by part;
4. the inference path at full width: a seeded ConvLSTM_w_ref (size 64,
   9-mer, chunk context (200, 200)) saved and loaded through
   ``ModelHandle.load``, fed 8 batches of 2048 synthetic raw chunks (the
   last one short) through ``run_model_batched``, f32 and bf16 legs. Each
   leg runs with the launch counts set to 0 and must launch every kernel
   of the path; logits are held to the same handle with the plain LSTM
   and to a CPU run, one pass is profiled by kernel (busy and idle share),
   and MM/ML tags are formatted for a few synthetic reads;
5. streaming inference, the main path: 256 synthetic reads of 4000
   bases (a BAM written by the port's ``BamWriter`` and indexed by its
   native scan; a POD5 file written by the port's ``Pod5Writer`` and
   read back bit for bit: VBZ through pyarrow's zstd codec, no
   zstandard; ExtractSignal's decode alone timed over it, reads/s and
   compressed MB/s) through
   ``infer_from_pod5_and_bam`` with phase 4's checkpoint at batch 2048,
   f32 and bf16, launch counts set to 0 before each run: K1 launches
   once per batch of 2048 calls (these counts are K1's in the kernels
   line), every read is written; reads/s, chunks/s and the stage
   occupancy summary; one f32 run profiled (device busy and idle share);
   a 16-read subset against the same driver with the handle on the CPU
   (MM identical, ML within 1); one more f32 run in a process of its own
   with ``REMORA_TPU_INFER_RUN_MODEL_PROFILE_FILE`` set (tags equal to
   the f32 run's; the ``call_batches`` thread's cProfile, top ten
   functions by cumulative and by own time); a checkpoint carrying phase 8b's level
   table through the device refiner (K4/K5 launch as planned, none
   routed to the host) and the native one, tags identical;
   (5b) duplex inference: 64 synthetic pairs of 4000 bases
   (``write_duplex_set``: the complement is the template's reverse
   complement with 4 edits, mapped reverse; duplex records ``tid;cid``,
   every fourth mapped reverse; one pair without a duplex record, one
   without its complement's signal) through ``infer_duplex`` with phase
   4's checkpoint and 4 prep workers, f32 then bf16, launch counts set to
   0 first: K1 launches once per ``eval_fn`` call (these counts join phase
   5's in the kernels line), every resolvable pair is written, the skip
   tally names the pair without signal (the one without a duplex record
   is filtered before the stages, as in the JAX driver), bf16 MM equals
   f32's and bf16 ML is within 1 of it; pairs/s and strand calls/s; a
   pair's time by the driver's stage functions run one after another
   (reads, alignment, forward, staging); on the first 8 pairs, the handle
   on the CPU against the f32 card leg (MM identical, ML within 1) and
   phase 5's refining checkpoint through the device DP (K4/K5 once per
   strand read, as planned, none routed to the host) and the native one,
   tags identical; K1 against its plain version at every bucket size 1,
   2, 4, ..., 2048, both dtypes, at phase 3's tolerances;
6. the training path at full width: a synthetic two-member dataset
   (26,624 chunks, written with the package's own ``CoreDataset``) and
   ``train_model`` on ConvLSTM_w_ref (size 64, batch 2048, 12 steps per
   epoch, 3 epochs), f32 and bf16 legs, each with the launch counts set to
   0: K2 and K3 must launch once per optimizer step, every batch loss be
   finite, the logs and checkpoints be written, K3's three bf16 parts
   launch once per bf16 step and never in f32; train chunks/s from the
   epoch timer, and one step profiled by kernel (K3's kernels and launches
   listed apart); the trim leg: the first member's super batch at chunk
   context (100, 100) through the native row trim and its NumPy path
   (identical arrays, both timed, the host library loaded), then 2 f32
   ``train_model`` steps on the dataset at (100, 100), K2/K3 once a step.
   (6b) one f32 train step
   with the kernels against the same step with the plain LSTM versions;
   then the trained checkpoint loads through ``ModelHandle.load`` and calls
   one batch. (6c) ``train_model`` with ``REMORA_TPU_CONVBN=pallas``, f32
   one step a call and bf16 in windows of ``steps_per_launch=4``, 2 epochs
   of 12 steps each, counts set to 0 first: K6 launches once per stride-1
   block and step (4 a step), K2/K3 once a step, finite losses, logs and
   checkpoints written, one pallas-mode step profiled by kernel; (6d) one
   f32 pallas-mode step against the same step in fused mode; (6e) the
   wide LSTM legs on the model path: ``train_model`` at size 96 for 2
   steps and its checkpoint through ``ModelHandle.load`` for one batch,
   f32 and bf16, the wide K2/K3 once a step and K1 once a batch, logits
   held to the plain LSTM, one train step and one served batch profiled
   by kernel, and one f32 size-96 train step held to the same step with
   the plain LSTM versions (as 6b); (6g) the same at size 160 on the
   general leg (K2/K3 once a step, K1 once a batch; K1/K2 on the cluster
   path, none streamed), held to the same handle and step with
   ``REMORA_TPU_LSTM=scan``, and K6's product paths at size 160's block
   shapes (merge_conv1 320 -> 160); then size 256 in f32, which the plan
   refuses: one train step and one served batch, K1/K2 on the streaming
   path once each, logits held to the scan; (6f) data-parallel training, the
   launch and all-reduce counts set to 0 first: (a) ``train_model`` over
   a one-rank NCCL group on cuda:0, 4 steps of 2048 (SGD), K2/K3 once a
   step, one all-reduce a step, losses within 1e-5 of the same run
   without a mesh; (b) two ranks sharing cuda:0 over gloo (processes of
   this script, ``--dp-rank``), 1024 rows each, 4 steps of
   ``make_dp_train_step`` without and with ``sync_bn``: the ranks'
   parameters identical, the stated all-reduces, K2/K3 once a step on
   each rank, the sync_bn parameters within 1e-4 relative of one process
   on the whole batches; whether gloo takes CUDA tensors, the step walls
   and the collectives' share; (5c, run after 6f) two ranks over gloo on
   cuda:0 infer 128 of phase 5's 256 reads each (f32, batch 2048), K1
   once a batch on each rank, the merged BAM holding every read with
   phase 5's f32 tags, reads/s; these K1-K3 launches join the kernels
   line;
8. the banded refinement DP: K4 (forward) and K5 (traceback) against
   their plain versions on the card (8 reads of 400 bases, W = 128), K5
   also on rows no DP wrote (W = 8, 128 and 4096; steps of any int16
   value; seq_lens 1 and N), and against the native host DP on one
   micro-batch (64 synthetic reads of 4000 bases), Viterbi and
   dwell_penalty, with their times and bounds (K4's and K5's the larger
   of bytes and serial chain), and K4's time beside the parent design's
   (its block path, forced at W = 128 by
   ``chip_dp_variants.build_block_path``, tb rows equal) timed in turns,
   parent, change, change, parent;
   (8b) the refinement stage at full size: 256 such reads with labels and
   CG focus bases through ``SigMapRefiner.refine_reads_batch`` (device,
   micro-batches of 64, launch counts set to 0 first: K4/K5 launch as the
   refiner planned, no read goes to the host), ``extract_chunks_batch`` and
   ``CoreDataset``, identical to the same stage with the native backend; a
   scale_iters=2 leg held to the same call on the CPU; the K4/K5 busy
   share of one micro-batch (CUDA events), and one micro-batch by kernel
   under torch.profiler in a child process (``--profile-refine``);
   (8c) the prepare driver, ``extract_chunk_dataset``, over phase 5's 256
   reads with phase 8b's refiner (CG sites, chunk context (200, 200),
   ``max_chunks_per_read`` 15), after one micro-batch of warm-up: the
   device backend first (launch counts set to 0: K4/K5 launch as planned,
   no read goes to the host; their busy share by CUDA events), then the
   native backend with one chunk worker, identical arrays and metadata;
   on the first 32 reads, where no read draws its sites, the device and
   native datasets shuffled under one seed are identical, and 4 chunk
   workers give one worker's dataset once sorted by (read id, focus
   base); reads/s, chunks/s and the skip tally of each run (these K4/K5
   launches and phase 5b's join phase 8b's in the kernels line);
7. the command line (run after phase 8c, on the checkpoint, reads and
   datasets of phases 4, 5, 5b, 6 and 8b): ``remora_tpu_torch.cli.main.
   run(argv)`` in-process at full width, no ``--device`` (the card), the
   launch counts set to 0 before each subcommand, the POD5 files read
   through the shipped reader: (a) ``model train`` on phase 6's dataset, one
   epoch of 4 steps of 2048, f32 then ``--bf16`` (K2/K3 once a step, K3's
   bf16 parts only in bf16, finite losses, checkpoint and logs written);
   (b) ``model export`` of phase 4's checkpoint as a Dorado directory and
   as TorchScript (its weights the checkpoint's); (c) ``infer
   from_pod5_and_bam`` on phase 5's 256 reads at ``--batch-size 2048``
   with the npz in f32 (tags equal to phase 5's driver run), the exported
   ``.pt`` in f32 (tags equal to the npz's) and the npz under ``--bf16``
   (MM equal, ML within 1), K1 once a batch, every read written; the
   same f32 run as a user starts it, ``python -m remora_tpu_torch infer
   from_pod5_and_bam`` in a process of its own (tags equal to phase 5's,
   K1 once a batch by the child's device-stage log line); and
   phase 5's refining checkpoint with ``--refine-backend device`` (K4/K5
   as planned, no read to the host, tags equal to phase 5's); (d)
   ``infer duplex_from_pod5_and_bam`` on phase 5b's first 8 pairs (K1
   once a strand call, tags equal to phase 5b's f32 run); (e) ``dataset
   prepare --refine-backend device`` with phase 8b's level table (as a
   file) on the first 32 reads, every CG site (K4/K5 as planned, no read
   to the host), identical to ``--refine-backend native``; (f)
   ``validate from_remora_dataset`` on (e)'s dataset (K1 once a batch)
   and ``validate from_modbams`` on (c)'s BAM against a BED of its CG
   sites. Each subcommand's wall and reads/s or chunks/s are logged; a
   subcommand that raises fails the run. These launches join the kernels
   line (K1, K2/K3, K4/K5);
9. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line again, and as
   the last line ``{"ok": true, "device": {...}}``; a run in which any
   phase imported zstandard fails.

Phases 5, 5b, 5c, 7 and 8c read real POD5 files through the port's
``io.pod5.DatasetReader`` in every stage, the forked ExtractSignal and
duplex pair stages included.

``python3 chip_smoke.py --lstm-kernels`` runs phases 1-3b, 3d and 3e
only (the build, K1-K3 against their plain versions with their times,
registers and spills, at the main shape, the wide and the general ones), for quick
turns on the LSTM kernels; its ``kernels`` line has no launch counts.

``python3 chip_smoke.py --data-parallel`` runs phases 6f and 5c alone,
after K1 and K2/K3 in f32 against their plain versions and the files the
phases read (phase 4's checkpoint, phase 5's f32 driver run, phase 6's
dataset).

``python3 chip_smoke.py --step-walls`` runs only the step profiles of
phases 6 and 6c (fused and pallas mode, f32 and bf16; 20 unprofiled walls
each) from a seeded checkpoint, against the package of the checkout it
sits in: copied into a checkout of another commit, it compares two trees
in one call on one card.

Imports nothing of JAX or of the JAX package ``remora_tpu``.
"""

import contextlib
import json
import logging
import math
import os
import re
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
# training: 12 optimizer steps of 2048 chunks per epoch, 3 epochs, and a
# 2048-chunk test split, over two dataset members
TRAIN_STEPS, TRAIN_EPOCHS = 12, 3
TRAIN_LSTM_T = 124  # the LSTM's length at chunk 400
# the wide LSTM legs (lstm_wide.cu, lstm_wide_bwd.cu): the model path at size WIDE_SIZE for
# WIDE_STEPS train steps, its kernels held to their plain versions at that
# shape and at C = H = WIDE, the widest they take
WIDE, WIDE_SIZE, WIDE_STEPS = 128, 96, 2
# the general LSTM leg (lstm_general.cu, C or H past 128): the model path at
# size GENERAL_SIZE for GENERAL_STEPS train steps, its kernels held to their
# plain versions at that shape and at C = H = GENERAL
GENERAL, GENERAL_SIZE, GENERAL_STEPS = 256, 160, 2
# samples of CALLS_PER_SAMPLE calls for the general leg's times: its calls
# take 9-35 ms, so fewer samples keep phase 3e's wall down
GENERAL_TIMED = 5
PALLAS_EPOCHS = 2  # the REMORA_TPU_CONVBN=pallas legs: 2 epochs of 12 steps


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


def lstm_bound(flops, io_bytes, dtype):
    """(bound ms, "operations" or "bytes"): the larger of the operations
    over the dtype's peak and the bytes over the memory rate."""
    import torch

    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    ops_ms = flops / peak * 1e3
    bytes_ms = io_bytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms \
        else "bytes"


# The LSTM kernels' serial chain (K1-K3): the instructions a step must
# run one after another, each at least DEP_LATENCY_CYCLES apart (the FP32
# pipe's dependent latency, the latency FOLD_STEP_CYCLES counts for
# K4; MUFU, shared-memory, barrier and tensor-core instructions take longer,
# so the count is a floor), read off each kernel's source. A sigmoid or tanh
# is at least ACT_CHAIN of them (ex2 -> add -> rcp -> mul).
DEP_LATENCY_CYCLES = 4
ACT_CHAIN = 4
# k a lane of lstm_fwd_f32.cu sums into one accumulator (its kKs)
FWD_F32_KS = 16


def lstm_chain_instrs(kind, C, H):
    """Dependent instructions of one step of an LSTM kernel's chain."""
    G = 4 * H
    if kind == "fwd":
        # K1/K2 f32 (lstm_fwd_f32.cu; x_t . W_x + b runs on the x role's
        # warps, off the chain): BAR -> LDS h_{t-1} -> FWD_F32_KS dependent
        # FFMA (a k group's slice, whatever H) -> 3 x (SHFL, FADD) (the four
        # k groups' ring) -> FADD the x sums -> the gates' activations -> c =
        # f c + i g (FMUL, FFMA) -> tanh(c) -> h = o tanh(c) -> STS h
        return 1 + 1 + FWD_F32_KS + 3 * 2 + 1 + ACT_CHAIN + 2 + ACT_CHAIN \
            + 1 + 1
    if kind == "wide_fwd":
        # K1/K2 wide f32 (lstm_wide.cu::wide_fwd_f32_kernel; x_t . W_x is
        # off the chain): cluster BAR (wait) -> LDS h_{t-1} -> H FFMA into
        # one accumulator a gate -> FADD bias -> the gates' activations -> c
        # = f c + i g (FMUL, FFMA) -> tanh(c) -> h = o tanh(c) ->
        # st.shared::cluster h -> cluster BAR (arrive)
        return 1 + 1 + H + 1 + ACT_CHAIN + 2 + ACT_CHAIN + 1 + 1 + 1
    if kind == "wide_fwd_mma":
        # K1/K2 wide bf16 (lstm_wide.cu::wide_fwd_bf16_kernel): cluster BAR
        # (wait) -> LDSM h_{t-1} -> ceil(H / 16) dependent HMMA -> FADD bias
        # -> the gates' activations -> c = f c + i g (FMUL, FFMA) -> tanh(c)
        # -> h = o tanh(c) -> pack to bf16 -> st.shared::cluster h -> cluster
        # BAR (arrive)
        return 1 + 1 + -(-H // 16) + 1 + ACT_CHAIN + 2 + ACT_CHAIN + 1 + 1 \
            + 1 + 1
    if kind in ("wide_bwd", "wide_bwd_mma"):
        # K3 wide (lstm_wide_bwd.cu::wide_rec_cluster_kernel; the gate
        # recompute and the products are other launches), a CTA of the
        # cluster: cluster BAR (wait) -> LDS the partner's dh sum -> FADD
        # the own sum -> FADD dhs -> dc (FMUL, FFMA) -> dgates (3 FMUL) ->
        # STS dgates -> BAR -> LDS -> the product's dependent chain (f32:
        # the k split's FFMA into one accumulator, 4hh / nsplit deep; bf16:
        # 4hh / 16 HMMA) -> BAR -> STS the split partial -> BAR -> LDS ->
        # nsplit FADD (the splits in order) -> st.shared::cluster
        half = -(-H // 2)
        hh = -(-half // 8) * 8
        if kind == "wide_bwd_mma":
            depth, nsplit = 4 * hh // 16, 1
        else:
            span = 32 * (1 if H <= 32 else 2 if H <= 64 else 3 if H <= 96
                         else 2)
            nsplit = 8 // -(-H // span)
            depth = 4 * hh // nsplit
        return 1 + 1 + 1 + 1 + 2 + 3 + 1 + 1 + 1 + depth + 1 + 1 + 1 + 1 \
            + nsplit + 1
    if kind == "general_fwd":
        # K1/K2 general f32, the cluster path (lstm_general_cluster.cu::
        # cluster_fwd_f32_kernel; x_t . W_x + b is off the chain, in the
        # window of barrier B): cluster BAR (wait B) -> LDS h_{t-1} -> H
        # FFMA into one accumulator a gate -> the gates' activations -> c =
        # f c + i g (FMUL, FFMA) -> tanh(c) -> h = o tanh(c) -> cluster BAR
        # (wait A) -> st.shared::cluster h -> cluster BAR (arrive B)
        return 1 + 1 + H + ACT_CHAIN + 2 + ACT_CHAIN + 1 + 1 + 1 + 1
    if kind == "general_fwd_mma":
        # K1/K2 general bf16, the cluster path (cluster_fwd_bf16_kernel):
        # cluster BAR (wait B) -> LDSM h_{t-1} -> ceil(H / 16) dependent
        # HMMA -> the gates' activations -> c = f c + i g (FMUL, FFMA) ->
        # tanh(c) -> h = o tanh(c) -> pack to bf16 -> cluster BAR (wait A)
        # -> st.shared::cluster h -> cluster BAR (arrive B)
        return 1 + 1 + -(-H // 16) + ACT_CHAIN + 2 + ACT_CHAIN + 1 + 1 + 1 \
            + 1 + 1
    if kind == "general_stream_fwd":
        # K1/K2 general, the streaming path (lstm_general.cu::
        # general_fwd_kernel, either dtype: x_t . W_x and h_{t-1} . W_h
        # share one accumulator a gate and row, so both are on the chain):
        # BAR -> LDS -> C + H dependent FFMA -> the gates' activations -> c
        # = f c + i g (FMUL, FFMA) -> tanh(c) -> h = o tanh(c) -> STS h ->
        # BAR -> LDG x_{t+1} -> STS -> BAR
        return 1 + 1 + C + H + ACT_CHAIN + 2 + ACT_CHAIN + 1 + 1 + 1 + 2 + 1
    if kind == "general_bwd":
        # K3 general (lstm_general.cu::general_rec_kernel; the gate
        # recompute and the products are other launches): BAR -> LDS the dh
        # carry -> FADD dhs -> dc (FMUL, FFMA) -> dgates (3 FMUL) -> STS ->
        # BAR -> LDS -> 4H dependent FFMA (dh = dgates . W_h^T) -> STS
        return 1 + 1 + 1 + 2 + 3 + 1 + 1 + 1 + G + 1
    if kind == "fwd_mma":
        # K1/K2 bf16 (lstm_fwd_mma.cu; x_t . W_x is off the chain): BAR ->
        # LDSM h_{t-1} -> ceil(H / 16) dependent HMMA -> FADD bias -> the
        # gates' activations -> c = f c + i g (FMUL, FFMA) -> tanh(c) -> h =
        # o tanh(c) -> pack to bf16 -> STS h
        return 1 + 1 + -(-H // 16) + 1 + ACT_CHAIN + 2 + ACT_CHAIN + 1 + 1 \
            + 1
    if kind == "bwd":
        # K3 f32 (lstm_bwd_f32.cu; the gate recompute and its activations
        # need no carry and run a step ahead, dx and dW are off the chain):
        # BAR -> LDS the two dh halves -> FADD them, FADD dhs -> dc (FMUL,
        # FMUL, FADD) -> dgates (3 FMUL) -> STS dgates -> BAR -> LDS -> 2H
        # FFMA into one accumulator (a half of dh = dgates . W_h^T) -> STS
        return 1 + 1 + 2 + 3 + 3 + 1 + 1 + 1 + G // 2 + 1
    # K3 bf16 (lstm_bwd_mma.cu::lstm_bwd_recurrence_kernel; the other parts
    # have no serial dependence): BAR -> LDS a warp partial -> ceil(H / 8)
    # FADD (the partials in warp order) -> FADD dh -> dc (FMUL, FMUL, FADD)
    # -> dgates (3 FMUL) -> pack to bf16 -> 2 HMMA -> STS the partial
    return 1 + 1 + -(-H // 8) + 1 + 3 + 3 + 1 + 2 + 1


def lstm_chain_bound_ms(kind, T, C, H):
    """T steps of the chain at the card's maximum SM clock."""
    cycles = T * lstm_chain_instrs(kind, C, H) * DEP_LATENCY_CYCLES
    return cycles / max_sm_clock_hz() * 1e3


def with_chain(record, chain_ms):
    """The record with ``chain_bound_ms`` and the largest of the three
    bounds as ``floor_ms`` / ``floor_by``; ``bound_ms`` / ``bound_by`` stay
    the function's bytes-or-operations bound (the chain is the design's)."""
    record["chain_bound_ms"] = chain_ms
    if chain_ms > record["bound_ms"]:
        record["floor_ms"], record["floor_by"] = chain_ms, "chain"
    else:
        record["floor_ms"] = record["bound_ms"]
        record["floor_by"] = record["bound_by"]
    return record


def lstm_kernel_of(leg, dtype, C, H):
    """(record name, source, chain kind) of the kernel that runs ``leg``
    ("last", "fwd", "bwd") in ``dtype`` at C, H (``kernels.lstm.route``)."""
    import torch

    from remora_tpu_torch.kernels import lstm as K

    bf16 = dtype == torch.bfloat16
    sfx = "bf16" if bf16 else "f32"
    kind = K.route(leg, dtype, C, H)
    if kind == "general" and leg != "bwd":
        if general_path(dtype, C, H) == "cluster":
            return (f"lstm_{leg}_general_cluster_{sfx}",
                    "remora_tpu_torch/csrc/lstm_general_cluster.cu",
                    "general_fwd_mma" if bf16 else "general_fwd")
        return (f"lstm_{leg}_general_stream_{sfx}",
                "remora_tpu_torch/csrc/lstm_general.cu",
                "general_stream_fwd")
    if kind == "general":
        return (f"lstm_{leg}_general_{sfx}",
                "remora_tpu_torch/csrc/lstm_general.cu", "general_bwd")
    if kind == "wide":
        if leg == "bwd":
            return (f"lstm_bwd_wide_{sfx}",
                    "remora_tpu_torch/csrc/lstm_wide_bwd.cu",
                    "wide_bwd_mma" if bf16 else "wide_bwd")
        return (f"lstm_{leg}_wide_{sfx}",
                "remora_tpu_torch/csrc/lstm_wide.cu",
                "wide_fwd_mma" if bf16 else "wide_fwd")
    src = {("last", False): "lstm_fwd_f32.cu",
           ("fwd", False): "lstm_fwd_f32.cu",
           ("bwd", False): "lstm_bwd_f32.cu",
           ("bwd", True): "lstm_bwd_mma.cu"}.get((leg, bf16),
                                                  "lstm_fwd_mma.cu")
    chain = {"bwd": "bwd_mma" if bf16 else "bwd"}.get(
        leg, "fwd_mma" if bf16 else "fwd")
    return f"lstm_{leg}_{sfx}", "remora_tpu_torch/csrc/" + src, chain


def general_path(dtype, C, H):
    """The general K1/K2's path on this card ("cluster" or "stream"),
    as ``kernels.lstm`` picks it."""
    from remora_tpu_torch.kernels import lstm as K

    return K.general_fwd_path(dtype, C, H, K.cluster_capacity(0))


def path_fields(leg, dtype, C, H):
    """A general K1/K2 record's path, cluster size and rows a cluster
    (``general_fwd_plan`` on this card); {} for any other kernel."""
    from remora_tpu_torch.kernels import lstm as K

    if leg == "bwd" or K.route(leg, dtype, C, H) != "general":
        return {}
    plan = K.general_fwd_plan(C, H, dtype, K.cluster_capacity(0))
    if plan is None:
        return {"path": "stream", "cluster_ctas": None, "cluster_rows": None}
    return {"path": "cluster", "cluster_ctas": plan[0],
            "cluster_rows": plan[1]}


def check_lstm_last(dtype, tol, C=SIZE, H=SIZE, n=N_TIMED):
    import torch

    from remora_tpu_torch.infer.infer import full_f32
    from remora_tpu_torch.kernels import lstm as K

    params, x = lstm_case(dtype, C=C, H=H)
    T, B, C = x.shape
    H = params["w_hh"].shape[1]
    with full_f32():
        got = K.lstm_last(params, x)
        want = K.lstm_last_reference(params, x)
        torch.cuda.synchronize()
        check(got.shape == (B, H) and got.dtype == dtype,
              f"lstm_last {dtype}: got {tuple(got.shape)} {got.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        log(f"lstm_last {dtype} C={C} H={H}: max |dh| = {err:.3e} "
            f"(tolerance {tol})")
        check(np.isfinite(err) and err <= tol,
              f"lstm_last {dtype}: kernel disagrees with the plain version "
              f"(max |dh| {err:.3e} > {tol})")
        check(torch.equal(K.lstm_last(params, x), got),
              f"lstm_last {dtype}: a second call gave other bits")
        log(f"lstm_last {dtype}: a second call repeats h_(T-1) bit for bit")

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
            ms = time_ms(lambda: K.lstm_last(params, x), n=n)
            plain_ms = time_ms(lambda: K.lstm_last_reference(params, x), n=n)
            # the yardstick only: cuDNN's LSTM, all T hidden states
            library_ms = time_ms(lambda: lib_lstm(x), n=n)
    flops = 2.0 * T * B * (C + H) * 4 * H
    io_bytes = (x.numel() + (C + H + 1) * 4 * H + B * H) * x.element_size()
    bound_ms, bound_by = lstm_bound(flops, io_bytes, dtype)
    name, source, chain = lstm_kernel_of("last", dtype, C, H)
    chain_ms = lstm_chain_bound_ms(chain, T, C, H)
    log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.nn.LSTM {library_ms} ms, bound {bound_ms:.4f}"
        f" ms ({flops / 1e9:.2f} GFLOP, {io_bytes / 1e6:.2f} MB), chain "
        f"{chain_ms:.4f} ms")
    return with_chain({
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": "remora_tpu/kernels/pallas_lstm.py:181",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        **path_fields("last", dtype, C, H),
    }, chain_ms)


def check_lstm_bwd_parts(x, w_aug, hs, cs, dhs):
    """K3's bf16 parts each against its plain twin on the same inputs (Z
    <= 1e-4 and dgates <= 2e-2 of their largest entries; dx <= 2e-2, dW <=
    1e-4 of its largest entry from the same dgates) and their times: ms
    by part."""
    from remora_tpu_torch.kernels import lstm as K

    z = K.lstm_bwd_gates(x, w_aug, hs)
    dg = K.lstm_bwd_recurrence(z, cs, dhs, w_aug)
    dx, dw = K.lstm_bwd_products(x, hs, w_aug, dg)
    errs = {
        "gates": rel_err(z, K.lstm_bwd_gates_reference(x, w_aug, hs)),
        "recurrence": rel_err(
            dg, K.lstm_bwd_recurrence_reference(z, cs, dhs, w_aug)),
    }
    dx_ref, dw_ref = K.lstm_bwd_products_reference(x, hs, w_aug, dg)
    errs["products dx"] = (dx.float() - dx_ref.float()).abs().max().item()
    errs["products dW"] = rel_err(dw, dw_ref)
    tols = {"gates": 1e-4, "recurrence": 2e-2, "products dx": 2e-2,
            "products dW": 1e-4}
    log("lstm_bwd_bf16 parts against their plain twins: " + ", ".join(
        f"{k} {v:.3e} (tolerance {tols[k]})" for k, v in errs.items()))
    for k, v in errs.items():
        check(np.isfinite(v) and v <= tols[k],
              f"lstm_bwd_bf16 part {k} disagrees with its plain twin "
              f"({v:.3e} > {tols[k]})")
    ms = {
        "gates": time_ms(lambda: K.lstm_bwd_gates(x, w_aug, hs)),
        "recurrence": time_ms(
            lambda: K.lstm_bwd_recurrence(z, cs, dhs, w_aug)),
        "products": time_ms(lambda: K.lstm_bwd_products(x, hs, w_aug, dg)),
    }
    log("lstm_bwd_bf16 parts: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms.items()))
    return ms


def split_bwd_parts_ms(x, w_aug, hs, cs, dhs, calls=5,
                      rec="wide_rec_cluster_kernel"):
    """Device ms of each of the split K3's kernels (gate recompute,
    recurrence, dx, dW, the ordered dW sum) a call, from torch.profiler
    over ``calls`` calls: ``lstm_wide_bwd.cu``'s, or with ``rec`` =
    "general_rec_kernel" ``lstm_general.cu``'s (the products are
    ``lstm_prod.cuh``'s in both)."""
    import torch

    from remora_tpu_torch.kernels import lstm as K

    K.lstm_bwd(x, w_aug, hs, cs, dhs)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            K.lstm_bwd(x, w_aug, hs, cs, dhs)
        torch.cuda.synchronize()
    ms = dict.fromkeys(("gates", "recurrence", "dx", "dW", "dW sum"), 0.0)
    for us, name, _count in kernel_rows(prof):
        if rec in name:
            part = "recurrence"
        elif re.search(K3_DW_SUM, name):
            part = "dW sum"
        else:
            # the products' Op template argument (kGates, kDx, kDw), as
            # the profiler demangles it or as mangled
            op = re.search(r"Op\)(\d)|OpE(\d)E", name)
            if "wide_prod" not in name or op is None:
                continue
            part = ("gates", "dx", "dW")[int(op.group(1) or op.group(2))]
        ms[part] += us / 1e3 / calls
    log(f"lstm_bwd {'general' if rec.startswith('general') else 'wide'} "
        "parts (torch.profiler): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms.items()))
    return ms


def wide_bwd_part_bounds(T, B, C, H, dtype):
    """Bound ms of each part of the split K3 as ``lstm_wide_bwd.cu`` and
    ``lstm_general.cu`` split it (Z and dgates through device memory): the larger of its operations
    over the dtype's peak and the bytes it must move (each input read
    once, each output written once: the gates read [x ; h] and write Z in
    f32; the recurrence reads Z, c and dh and writes dgates; dx reads
    dgates and writes dx; dW reads [x ; h] and dgates)."""
    import torch

    tb, G, K = T * B, 4 * H, C + H
    isz = 4 if dtype == torch.float32 else 2
    parts = {
        "gates": (2.0 * tb * K * G, tb * K * isz + tb * G * 4),
        "recurrence": (2.0 * tb * G * H,
                       tb * G * 4 + 2 * tb * H * isz + tb * G * isz),
        "dx": (2.0 * tb * G * C, tb * G * isz + tb * C * isz),
        "dW": (2.0 * tb * K * G, tb * K * isz + tb * G * isz),
    }
    return {name: lstm_bound(flops, io, dtype)[0]
            for name, (flops, io) in parts.items()}


def rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def check_lstm_train(dtype, tol, C=SIZE, H=SIZE, n=N_TIMED):
    """K2 (with cs) and K3 against their plain versions at the training
    path's shape (or another C, H); returns their two kernel records.
    Kernel and library times are medians of ``n`` samples."""
    import torch

    from remora_tpu_torch.infer.infer import full_f32
    from remora_tpu_torch.kernels import lstm as K

    params, x = lstm_case(dtype, T=TRAIN_LSTM_T, C=C, H=H, seed=3)
    T, B, C = x.shape
    H = params["w_hh"].shape[1]
    w_aug = K.make_w_aug(params, dtype)
    dhs = torch.from_numpy(np.random.default_rng(4).normal(
        size=(T, B, H)).astype(np.float32)).cuda().to(dtype)
    sfx = "f32" if dtype == torch.float32 else "bf16"
    if (C, H) != (SIZE, SIZE):
        sfx += f" C={C} H={H}"
    with full_f32():
        hs, cs = K.lstm_fwd(x, w_aug)
        hs_ref, cs_ref = K.lstm_fwd_reference(x, w_aug)
        dx, dw = K.lstm_bwd(x, w_aug, hs, cs, dhs)
        dx_ref, dw_ref = K.lstm_bwd_reference(x, w_aug, hs, cs, dhs)
        torch.cuda.synchronize()
        errs = {name: (a.float() - b.float()).abs().max().item()
                for name, a, b in (("hs", hs, hs_ref), ("cs", cs, cs_ref),
                                   ("dx", dx, dx_ref))}
        dw_rel = rel_err(dw, dw_ref)
        dw_tol = 1e-4 if dtype == torch.float32 else tol
        log(f"lstm_fwd/bwd {sfx}: max |d| hs {errs['hs']:.3e} cs "
            f"{errs['cs']:.3e} dx {errs['dx']:.3e} (tolerance {tol}); dW "
            f"{dw_rel:.3e} of its max-abs (tolerance {dw_tol})")
        for name, err in errs.items():
            check(np.isfinite(err) and err <= tol,
                  f"lstm_fwd/bwd {sfx}: {name} disagrees with the plain "
                  f"version ({err:.3e} > {tol})")
        check(np.isfinite(dw_rel) and dw_rel <= dw_tol,
              f"lstm_bwd {sfx}: dW disagrees with the plain version "
              f"({dw_rel:.3e} > {dw_tol})")
        again = K.lstm_fwd(x, w_aug)
        check(torch.equal(again[0], hs) and torch.equal(again[1], cs),
              f"lstm_fwd {sfx}: a second call gave other bits")
        check(torch.equal(K.lstm_fwd(x, w_aug, want_cs=False)[0], hs),
              f"lstm_fwd {sfx}: hs without cs differs from hs with cs")
        again = K.lstm_bwd(x, w_aug, hs, cs, dhs)
        check(torch.equal(again[0], dx) and torch.equal(again[1], dw),
              f"lstm_bwd {sfx}: a second call gave other bits")
        log(f"lstm_fwd/bwd {sfx}: a second call repeats hs, cs, dx and dW "
            "bit for bit; hs without cs is the same")
        bwd_chain = lstm_kernel_of("bwd", dtype, C, H)[2]
        parts_ms = (check_lstm_bwd_parts(x, w_aug, hs, cs, dhs)
                    if bwd_chain == "bwd_mma" else
                    split_bwd_parts_ms(x, w_aug, hs, cs, dhs)
                    if bwd_chain.startswith("wide_bwd") else
                    split_bwd_parts_ms(x, w_aug, hs, cs, dhs,
                                      rec="general_rec_kernel")
                    if bwd_chain == "general_bwd" else None)

        fwd_ms = time_ms(lambda: K.lstm_fwd(x, w_aug), n=n)
        general = K.route("fwd", dtype, C, H) == "general"
        nocs_ms = (time_ms(lambda: K.lstm_fwd(x, w_aug, want_cs=False), n=n)
                   if general else None)
        fwd_plain_ms = time_ms(lambda: K.lstm_fwd_reference(x, w_aug), n=5,
                               calls=1)
        bwd_ms = time_ms(lambda: K.lstm_bwd(x, w_aug, hs, cs, dhs), n=n)
        bwd_plain_ms = time_ms(
            lambda: K.lstm_bwd_reference(x, w_aug, hs, cs, dhs), n=5,
            calls=1)
        # yardsticks only, never called by the port: cuDNN's LSTM forward
        # (all T hidden states) and its backward (data and weights)
        lib_lstm = torch.nn.LSTM(C, H).cuda().to(dtype)
        with torch.no_grad():
            lib_lstm.weight_ih_l0.copy_(params["w_ih"])
            lib_lstm.weight_hh_l0.copy_(params["w_hh"])
            lib_lstm.bias_ih_l0.copy_(params["b_ih"])
            lib_lstm.bias_hh_l0.copy_(params["b_hh"])
        lib_lstm.flatten_parameters()
        with torch.no_grad():
            fwd_lib_ms = time_ms(lambda: lib_lstm(x), n=n)
        xg = x.clone().requires_grad_()
        out = lib_lstm(xg)[0]
        inputs = (xg, *lib_lstm.parameters())
        bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
            out, inputs, grad_outputs=dhs, retain_graph=True), n=n)
    n_x, n_h = T * B * C, T * B * H
    isz = x.element_size()
    w_bytes = (C + H + 1) * 4 * H * isz
    fwd_flops = 2.0 * T * B * (C + H) * 4 * H
    fwd_bytes = (n_x + 2 * n_h) * isz + w_bytes
    bwd_flops = 3 * fwd_flops
    # the function's inputs and outputs only: x, hs, cs, dhs, W read, dx
    # and dW written (each kernel's scratch is the design's)
    bwd_bytes = (2 * n_x + 3 * n_h) * isz + w_bytes \
        + (C + H + 1) * 4 * H * 4
    records = []
    for leg, ms, plain_ms, lib_ms, flops, io_bytes, err, replaces in (
        ("fwd", fwd_ms, fwd_plain_ms, fwd_lib_ms, fwd_flops, fwd_bytes,
         max(errs["hs"], errs["cs"]),
         "remora_tpu/kernels/pallas_lstm.py:137"),
        ("bwd", bwd_ms, bwd_plain_ms, bwd_lib_ms, bwd_flops, bwd_bytes,
         errs["dx"], "remora_tpu/kernels/pallas_lstm.py:251"),
    ):
        name, src, chain = lstm_kernel_of(leg, dtype, C, H)
        bound_ms, bound_by = lstm_bound(flops, io_bytes, dtype)
        chain_ms = lstm_chain_bound_ms(chain, T, C, H)
        log(f"{name} C={C} H={H}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, torch.nn.LSTM {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}; {flops / 1e9:.2f} GFLOP, {io_bytes / 1e6:.2f} "
            f"MB), chain {chain_ms:.4f} ms")
        records.append(with_chain({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": None,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib_ms,
            **path_fields(leg, dtype, C, H),
        }, chain_ms))
    if nocs_ms is not None:
        records[0]["nocs_ms"] = nocs_ms
    if parts_ms is not None:
        records[1]["parts_ms"] = parts_ms
    return records


# ---------------- phase 3c: K6, the conv+BN+swish backward ---------------

# the stride-1 blocks of ConvLSTM_w_ref (size 64, 9-mer, chunk 400): (name,
# I, O, K, Ti), the shapes K6 takes on the training path
CONVBN_BLOCKS = (("sig_conv1", 1, 4, 5, WIDTH),
                 ("sig_conv2", 4, 16, 5, WIDTH - 4),
                 ("seq_conv1", 4 * KMER_LEN, 16, 5, WIDTH),
                 ("merge_conv1", 2 * SIZE, SIZE, 5, TRAIN_LSTM_T + 4))


def convbn_case(dtype, I, O, K, Ti, seed):
    """Seeded K6 inputs on the card in the layouts the training path gives
    them: x a channels-last view of (B, I, Ti) storage, dout one of (B, O,
    To) storage (merge_conv1's of (To, B, O): the LSTM's input layout);
    r the batch statistic of conv(x, w) and mu its batch mean shifted by a
    tenth of its standard deviation, so that db, which is 0 up to rounding
    at the exact mean, is a sum a wrong kernel cannot match by chance."""
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    To = Ti - K + 1
    cuda = torch.device("cuda")

    def arr(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32)).to(cuda)

    x = arr(BATCH, I, Ti).to(dtype).transpose(1, 2)
    if I == 2 * SIZE:
        dout = arr(To, BATCH, O).to(dtype).transpose(0, 1)
    else:
        dout = arr(BATCH, O, To).to(dtype).transpose(1, 2)
    w = arr(O, I, K, scale=1.0 / np.sqrt(I * K)).to(dtype)
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, O).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(-0.1, 0.1, O).astype(np.float32))
    gamma, beta = gamma.to(cuda, dtype), beta.to(cuda, dtype)
    y = F.conv1d(x.transpose(1, 2).float(), w.float())
    var = y.var((0, 2), correction=0)
    mu = y.mean((0, 2)) + 0.1 * var.sqrt()
    r = torch.rsqrt(var + 1e-5)
    return x, dout, w, gamma, beta, mu.to(dtype), r.to(dtype)


def library_convbn_bwd(x, dout, w, gamma, beta, mu, r):
    """``ConvBNSwish.backward``'s work: the cuDNN conv recompute, the
    folded BN+swish chain, ``conv1d_weight`` and ``conv1d_input`` (the
    yardstick; the port's pallas mode never calls it)."""
    from remora_tpu_torch.models import layers as L

    y = L._conv_nobias(w, x, 1)
    dy, dgamma, dbeta = L._folded_dy(dout, gamma, beta, (y - mu) * r, r)
    dw, dx = L._conv_grads(x, w, dy, 1)
    return dx, dw, dy.sum((0, 1)), dgamma, dbeta


def convbn_db_f64(x, dout, w, gamma, beta, mu, r):
    """db of the plain version's math in f64 on the same (rounded) inputs:
    K6's yardstick for db, whose f32 sum in the plain version is itself
    1.9e-5 to 7.1e-5 of db's largest entry off at the block shapes."""
    import torch

    To = dout.shape[1]
    x64 = x.double()
    w64 = w.to(x.dtype).double()
    gamma, beta, mu, r = (v.double() for v in (gamma, beta, mu, r))
    xhat = (sum(x64[:, k:k + To] @ w64[:, :, k].T
                for k in range(w.shape[2])) - mu) * r
    z = gamma * xhat + beta
    s = torch.sigmoid(z)
    dz = dout.double() * (s + z * s * (1.0 - s))
    n = dz.shape[0] * To
    dy = gamma * r * (dz - dz.sum((0, 1)) / n
                      - xhat * ((dz * xhat).sum((0, 1)) / n))
    return dy.sum((0, 1))


def ptxas_kernels(log_text):
    """(kernel, registers, spill store bytes, spill load bytes) of each
    entry function in an ``nvcc -Xptxas=-v`` log."""
    out, name, spills = [], None, {}
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name is not None:
            spills[name] = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), *spills.get(name, (0, 0))))
    return out


def check_compile(lib, label, names):
    """Log the registers and spills of every kernel of ``lib`` (from the
    nvcc log of its library; each named by the first of ``names`` in its
    mangled name) and fail if one spills."""
    from remora_tpu_torch.kernels import _build

    kernels = ptxas_kernels(_build.compile_log(lib))
    check(kernels, f"{label}: no ptxas -v lines in the build log")
    for name, regs, st, ld in kernels:
        short = re.search("(" + "|".join(names) + r")(I\w*?E+v)?", name)
        log(f"  {label} {short.group(0) if short else name}: {regs} "
            f"registers, spill stores {st} B, spill loads {ld} B")
        check(st == 0 and ld == 0, f"{label} kernel {name} spills ({st} B "
              f"stores, {ld} B loads)")


def check_convbn_compile():
    """K6's kernels: registers logged, no spill."""
    check_compile("convbn_bwd", "K6", (
        "conv_mma_kernel", "conv_tiles_kernel", "conv_rows_kernel",
        "dw_mma_kernel", "dw_tiles_kernel", "dw_kernel", "dy_tm_kernel",
        "dy_kernel", "time_major_kernel", "ordered_sum_runs", "ordered_sum"))


def check_lstm_bwd_compile():
    """K3's kernels, f32 and bf16: registers logged, no spill."""
    check_compile("lstm_bwd_f32", "K3 f32", (
        "lstm_bwd_f32_kernel", "ordered_sum"))
    check_compile("lstm_bwd_mma", "K3 bf16", (
        "lstm_bwd_gates_kernel", "lstm_bwd_recurrence_kernel",
        "lstm_bwd_dx_kernel", "ordered_sum",
        "lstm_bwd_dw_kernel"))


def check_lstm_fwd_compile():
    """K1/K2's kernels, f32 and bf16, each instantiation (f32: the main
    shape's and the generic one, last-only and with hs, with and without
    cs): registers logged, no spill."""
    check_compile("lstm_fwd_f32", "K1/K2 f32", ("lstm_fwd_f32_kernel",))
    check_compile("lstm_fwd_mma", "K1/K2 bf16", ("lstm_fwd_mma_kernel",))


def check_lstm_wide_compile():
    """The wide LSTM legs' kernels (lstm_wide.cu, lstm_wide_bwd.cu), each
    instantiation: registers logged, no spill."""
    check_compile("lstm_wide", "wide K1/K2", (
        "wide_fwd_f32_kernel", "wide_fwd_bf16_kernel"))
    check_compile("lstm_wide_bwd", "wide K3", (
        "wide_rec_cluster_kernel", "wide_prod_f32_kernel",
        "wide_prod_bf16_kernel", "ordered_sum"))


def check_lstm_wide():
    """Phase 3d: K1, K2 on ``lstm_wide.cu`` and K3 on ``lstm_wide_bwd.cu``
    against their plain versions, each dtype, at T = 124, B = BATCH and C = H = WIDE_SIZE (the
    shape phase 6e's model path gives them) and at C = H = WIDE. The
    WIDE records are logged as a line of their own; returns the WIDE_SIZE
    records (K1, K2, K3) by dtype, which take 6e's launches into the
    kernels line."""
    import torch

    check_lstm_wide_compile()
    records = {
        width: {dtype: [check_lstm_last(dtype, tol, C=width, H=width),
                        *check_lstm_train(dtype, tol, C=width, H=width)]
                for dtype, tol in ((torch.float32, 1e-5),
                                   (torch.bfloat16, 2e-2))}
        for width in (WIDE_SIZE, WIDE)}
    log(json.dumps({f"wide_lstm_at_{WIDE}": [
        rec for recs in records[WIDE].values() for rec in recs]}))
    # the wide K1/K2 beside cuDNN's forward (torch.nn.LSTM, all T hidden
    # states) at both widths, with their bounds and chains
    log(json.dumps({"wide_fwd_vs_cudnn": {
        f"C=H={width}": {
            rec["name"]: {"ms": rec["ms"], "cudnn_fwd_ms": rec["library_ms"],
                          "bound_ms": rec["bound_ms"],
                          "bound_by": rec["bound_by"],
                          "chain_bound_ms": rec["chain_bound_ms"]}
            for dtype, recs in records[width].items() for rec in recs
            if not rec["name"].startswith("lstm_bwd")}
        for width in (WIDE_SIZE, WIDE)}}))
    # the wide K3 beside cuDNN's backward (torch.nn.LSTM, data and
    # weights) at both widths, from the records above
    log(json.dumps({"wide_k3_vs_cudnn_bwd": {
        f"C=H={width}": {
            rec["name"]: {"ms": rec["ms"], "cudnn_bwd_ms": rec["library_ms"],
                          "parts_ms": rec.get("parts_ms"),
                          "parts_bound_ms": wide_bwd_part_bounds(
                              TRAIN_LSTM_T, BATCH, width, width, dtype)}
            for dtype, recs in records[width].items() for rec in recs
            if rec["name"].startswith("lstm_bwd")}
        for width in (WIDE_SIZE, WIDE)}}))
    return records[WIDE_SIZE]


def check_lstm_general_compile():
    """The general LSTM leg's kernels (lstm_general.cu: its forward and
    recurrence, and lstm_prod.cuh's products and the ordered dW sum it
    launches), each instantiation: registers logged, no spill."""
    check_compile("lstm_general", "general K1-K3", (
        "general_fwd_kernel", "general_rec_kernel", "wide_prod_f32_kernel",
        "wide_prod_bf16_kernel", "ordered_sum"))
    check_compile("lstm_general_cluster", "general K1/K2 cluster", (
        "cluster_fwd_f32_kernel", "cluster_fwd_bf16_x2_kernel",
        "cluster_fwd_bf16_kernel"))


# the general K1/K2 before the cluster path (PR 21's general_fwd_kernel
# for every shape; PERF.md section 6, H100 80GB HBM3 at 700 W), ms: the
# parent-design figure each 3e record is logged beside
PARENT_GENERAL_MS = {
    ("last", "f32", 160): 9.2923, ("last", "bf16", 160): 9.3452,
    ("fwd", "f32", 160): 8.9869, ("fwd", "bf16", 160): 9.3324,
    ("last", "f32", 256): 14.7656, ("last", "bf16", 256): 14.7777,
    ("fwd", "f32", 256): 14.1321, ("fwd", "bf16", 256): 14.6810,
}


def check_lstm_general():
    """Phase 3e: K1, K2 (with and without cs) and K3 on the general leg
    against their plain versions, each dtype, at T = 124, B = BATCH and C =
    H = GENERAL_SIZE (the shape phase 6g's model path gives them) and at C
    = H = GENERAL; K1/K2 on the cluster path (``lstm_general_cluster.cu``)
    where ``general_fwd_plan`` takes the shape (bf16 at both, f32 at
    GENERAL_SIZE) and on the streaming path (``lstm_general.cu``) where it
    refuses it (f32 at GENERAL); each repeated bit for bit, timed beside
    its bound, its chain, its plain version, ``torch.nn.LSTM`` and the
    parent design (PARENT_GENERAL_MS). The GENERAL records are logged as a
    line of their own; returns the GENERAL_SIZE records (K1, K2, K3) by
    dtype, which take 6g's launches into the kernels line, and the
    streaming path's K1, K2 records (f32 at GENERAL), which take 6g's
    size-GENERAL leg's."""
    import torch

    from remora_tpu_torch.kernels import lstm as K

    check_lstm_general_compile()
    caps = K.cluster_capacity(0)
    log(f"clusters the card holds, one CTA an SM: {caps} (the plan's "
        f"table: {K.H100_CLUSTERS})")
    t0 = time.monotonic()
    records = {
        width: {dtype: [check_lstm_last(dtype, tol, C=width, H=width,
                                        n=GENERAL_TIMED),
                        *check_lstm_train(dtype, tol, C=width, H=width,
                                          n=GENERAL_TIMED)]
                for dtype, tol in ((torch.float32, 1e-5),
                                   (torch.bfloat16, 2e-2))}
        for width in (GENERAL_SIZE, GENERAL)}
    log(json.dumps({f"general_lstm_at_{GENERAL}": [
        rec for recs in records[GENERAL].values() for rec in recs]}))
    log(json.dumps({"general_vs_cudnn": {
        f"C=H={width}": {
            rec["name"]: {"ms": rec["ms"], "cudnn_ms": rec["library_ms"],
                          "parent_ms": PARENT_GENERAL_MS.get((
                              rec["name"].split("_")[1],
                              rec["name"].rsplit("_", 1)[1], width)),
                          "nocs_ms": rec.get("nocs_ms"),
                          "plain_ms": rec["plain_ms"],
                          "bound_ms": rec["bound_ms"],
                          "bound_by": rec["bound_by"],
                          "chain_bound_ms": rec["chain_bound_ms"],
                          "path": rec.get("path"),
                          "cluster_ctas": rec.get("cluster_ctas"),
                          "cluster_rows": rec.get("cluster_rows"),
                          "parts_ms": rec.get("parts_ms")}
            for recs in records[width].values() for rec in recs}
        for width in (GENERAL_SIZE, GENERAL)}}))
    stream = [rec for rec in records[GENERAL][torch.float32]
              if rec.get("path") == "stream"]
    check(len(stream) == 2, f"phase 3e: the streaming path ran "
          f"{[rec['name'] for rec in stream]} at f32 C=H={GENERAL}, not "
          "K1 and K2")
    for width in (GENERAL_SIZE, GENERAL):
        for rec in records[width][torch.bfloat16][:2]:
            check(rec.get("path") == "cluster",
                  f"phase 3e: {rec['name']} at C=H={width} is not on the "
                  "cluster path")
    log(f"phase 3e wall {time.monotonic() - t0:.1f} s")
    return records[GENERAL_SIZE], stream


def profile_serve(handle, arrs, tag, n_walls=5):
    """Device time by kernel over one ``ModelHandle.eval_raw`` batch
    (torch.profiler), against the median unprofiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(n_walls):
        t0 = time.perf_counter()
        handle.eval_raw(*arrs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        handle.eval_raw(*arrs)
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    if not rows:
        log(f"  {tag} profile: the profiler recorded no device time "
            "(device breakdown not measured)")
        return
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"  {tag} profile of one served batch: kernels busy "
        f"{busy_s * 1e3:.4f} ms; unprofiled median wall {wall * 1e3:.4f} ms "
        f"({busy_s / wall:.1%} busy)")
    for dev_us, key, count in rows[:8]:
        log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")


@contextlib.contextmanager
def lstm_mode(mode):
    """REMORA_TPU_LSTM set to ``mode`` (None: as it was)."""
    old = os.environ.get("REMORA_TPU_LSTM")
    if mode is not None:
        os.environ["REMORA_TPU_LSTM"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REMORA_TPU_LSTM", None)
        else:
            os.environ["REMORA_TPU_LSTM"] = old


def general_stream_leg(root, config, records):
    """Phase 6g's size-GENERAL leg: ConvLSTM_w_ref at size GENERAL in f32,
    the shape ``general_fwd_plan`` refuses, so its K1/K2 run the streaming
    ``general_fwd_kernel`` on the model path: ``train_model`` for one step
    (K2 there once), then its checkpoint through ``ModelHandle.load`` for
    one batch (K1 once), logits finite and held to the same handle with
    REMORA_TPU_LSTM=scan; no cluster launch. Sets the streaming records'
    launches."""
    from remora_tpu_torch.infer.infer import ModelHandle
    from remora_tpu_torch.kernels import lstm as K
    from remora_tpu_torch.train import optim
    from remora_tpu_torch.train.train import train_model

    tag = f"general_stream_size{GENERAL}_f32"
    out = os.path.join(root, tag)
    counts, paths = K.LAUNCHES_GENERAL, K.LAUNCHES_GENERAL_FWD
    for d in (counts, paths):
        d.update(dict.fromkeys(d, 0))
    t0 = time.monotonic()
    train_model(
        seed=1, out_path=out, remora_dataset_path=config,
        chunk_context=None, kmer_context_bases=None, batch_size=BATCH,
        model_name="ConvLSTM_w_ref", size=GENERAL,
        train_opts=optim.TrainOpts(epochs=1, lr_scheduler_str="constant",
                                   learning_rate=2e-3),
        chunks_per_epoch=BATCH, num_test_chunks=BATCH)
    train_launches, train_paths = dict(counts), dict(paths)
    log(f"{tag}: train_model 1 step in {time.monotonic() - t0:.1f} s; "
        f"general launches {train_launches}, by path {train_paths}")
    check(train_launches["fwd"] == train_launches["bwd"] == 1
          and train_paths["cluster"] == 0 and train_paths["stream"] >= 1,
          f"{tag}: launches {train_launches}, by path {train_paths}")
    handle = ModelHandle.load(os.path.join(out, "model_final.checkpoint"))
    arrs = synth_inputs(np.random.default_rng(8), BATCH)
    for d in (counts, paths):
        d.update(dict.fromkeys(d, 0))
    logits = handle.eval_raw(*arrs).cpu().numpy()
    last = counts["last"]
    check(last == 1 and paths == {"cluster": 0, "stream": 1},
          f"{tag}: one batch launched K1 {last} times, by path {paths}")
    with lstm_mode("scan"):
        plain = handle.eval_raw(*arrs).cpu().numpy()
    err = float(np.abs(logits - plain).max())
    log(f"{tag}: ModelHandle batch of {BATCH} on the streaming K1: max "
        f"|logit - REMORA_TPU_LSTM=scan logit| {err:.3e} (tolerance 1e-4)")
    check(np.isfinite(logits).all() and err <= 1e-4,
          f"{tag}: logits disagree with the scan ({err:.3e})")
    k1, k2 = records
    k1["launches"] = last
    k2["launches"] = train_launches["fwd"]


def model_path_leg(root, config, records, kind, stream_records=None):
    """Phase 6e (``kind`` "wide"): ConvLSTM_w_ref at size WIDE_SIZE on the
    card, f32 and bf16: ``train_model`` for WIDE_STEPS steps (K2 on
    lstm_wide.cu and K3 on lstm_wide_bwd.cu once a step), then its
    checkpoint through ``ModelHandle.load`` for one batch (K1 on
    lstm_wide.cu once), logits finite and held to the same handle with the
    plain LSTM; one train step and one served batch profiled by kernel;
    the f32 checkpoint's train step held to the same step with the plain
    K2/K3 (``check_train_step_vs_plain``). Phase 6g (``kind`` "general"):
    the same at size GENERAL_SIZE for GENERAL_STEPS steps on the general
    leg (K1/K2 on the cluster path, ``lstm_general_cluster.cu``: no launch
    streams), held to the same handle and step with REMORA_TPU_LSTM=scan,
    then ``general_stream_leg`` (size GENERAL f32, the streaming path;
    ``stream_records``). Sets the records' launches from the train and
    serve runs."""
    import torch

    from remora_tpu_torch.infer.infer import ModelHandle
    from remora_tpu_torch.kernels import lstm as K
    from remora_tpu_torch.train import optim
    from remora_tpu_torch.train.train import train_model

    general = kind == "general"
    size, steps = ((GENERAL_SIZE, GENERAL_STEPS) if general
                   else (WIDE_SIZE, WIDE_STEPS))
    counts = K.LAUNCHES_GENERAL if general else K.LAUNCHES_WIDE
    reference = ((lambda: lstm_mode("scan"), "REMORA_TPU_LSTM=scan")
                 if general else (plain_lstm, "plain-LSTM"))
    arrs = synth_inputs(np.random.default_rng(8), BATCH)
    t_phase = time.monotonic()
    for dtype, bf16 in ((torch.float32, False), (torch.bfloat16, True)):
        tag = f"{kind}_size{size}_{'bf16' if bf16 else 'f32'}"
        out = os.path.join(root, tag)
        counts.update(dict.fromkeys(counts, 0))
        paths = K.LAUNCHES_GENERAL_FWD
        paths.update(dict.fromkeys(paths, 0))
        t0 = time.monotonic()
        train_model(
            seed=1, out_path=out, remora_dataset_path=config,
            chunk_context=None, kmer_context_bases=None, batch_size=BATCH,
            model_name="ConvLSTM_w_ref", size=size,
            train_opts=optim.TrainOpts(epochs=1,
                                       lr_scheduler_str="constant",
                                       learning_rate=2e-3),
            chunks_per_epoch=steps * BATCH, num_test_chunks=BATCH,
            bf16_compute=bf16,
        )
        train_launches = dict(counts)
        with open(os.path.join(out, "batch.log")) as fh:
            losses = [float(line.split()[1]) for line in fh.readlines()[1:]]
        log(f"{tag}: train_model {steps} steps in "
            f"{time.monotonic() - t0:.1f} s (with validation and "
            f"checkpoints); {kind} launches {train_launches}; losses "
            f"{losses}")
        check(train_launches["fwd"] == train_launches["bwd"] == steps,
              f"{tag}: the {kind} K2/K3 launched {train_launches} times for "
              f"{steps} steps")
        if general:  # the cluster path, none of it streamed
            log(f"{tag}: general K1/K2 launches by path {paths}")
            check(paths["stream"] == 0 and paths["cluster"] >= steps,
                  f"{tag}: general K1/K2 by path {paths}")
        check(len(losses) == steps and np.isfinite(losses).all(),
              f"{tag}: batch.log losses {losses}")
        profile_train_step(os.path.join(out, "model_final.checkpoint"), bf16,
                           f"{tag} step", n_walls=5)
        handle = ModelHandle.load(
            os.path.join(out, "model_final.checkpoint"),
            compute_dtype=dtype if bf16 else None)
        check(handle.device.type == "cuda", f"{tag}: handle on "
              f"{handle.device}")
        counts.update(dict.fromkeys(counts, 0))
        paths.update(dict.fromkeys(paths, 0))
        logits = handle.eval_raw(*arrs).cpu().numpy()
        last_launches = counts["last"]
        if general:
            check(paths == {"cluster": 1, "stream": 0},
                  f"{tag}: the served batch's K1 by path {paths}")
        with reference[0]():
            plain = handle.eval_raw(*arrs).cpu().numpy()
        check(counts["last"] == last_launches,
              f"{tag}: the {reference[1]} pass launched the {kind} K1")
        check(logits.shape == (BATCH, 2) and np.isfinite(logits).all(),
              f"{tag}: logits {logits.shape}, finite "
              f"{np.isfinite(logits).all()}")
        check(last_launches == 1,
              f"{tag}: the {kind} K1 launched {last_launches} times for one "
              "batch")
        profile_serve(handle, arrs, tag)
        if bf16:
            diff = int(np.abs(ml_bytes(logits) - ml_bytes(plain)).max())
            log(f"{tag}: ModelHandle batch of {BATCH}: ML bytes vs "
                f"{reference[1]} max |delta| {diff} (tolerance 1)")
            check(diff <= 1, f"{tag}: ML bytes moved by more than 1")
        else:
            err = float(np.abs(logits - plain).max())
            log(f"{tag}: ModelHandle batch of {BATCH}: max |logit - "
                f"{reference[1]} logit| {err:.3e} (tolerance 1e-4)")
            check(err <= 1e-4,
                  f"{tag}: logits disagree with the {reference[1]} pass")
        k1, k2, k3 = records[dtype]
        k1["launches"] = last_launches
        k2["launches"] = train_launches["fwd"]
        k3["launches"] = train_launches["bwd"]
        if not bf16:
            check_train_step_vs_plain(
                os.path.join(out, "model_final.checkpoint"), kind=kind)
    if general:
        check_convbn_products(size)
        general_stream_leg(root, config, stream_records)
    log(f"phase {'6g' if general else '6e'} wall "
        f"{time.monotonic() - t_phase:.1f} s")


def check_convbn_products(size):
    """K6's stride-1 blocks of ConvLSTM_w_ref at ``size`` (merge_conv1
    takes 2 size channels in): the library must take each in both dtypes
    (``convbn.products``), as REMORA_TPU_CONVBN=pallas would run them."""
    import torch

    from remora_tpu_torch.kernels import convbn

    blocks = [(name, 2 * size, size, k, ti) if name == "merge_conv1"
              else (name, i, o, k, ti)
              for name, i, o, k, ti in CONVBN_BLOCKS]
    for dtype in (torch.float32, torch.bfloat16):
        paths = {name: convbn.products(BATCH, ti, i, o, k, dtype)
                 for name, i, o, k, ti in blocks}
        log(f"K6 at size {size}, {dtype}: product paths {paths}")
        check(all(p is not None for p in paths.values()),
              f"K6 takes no path for a block of size {size} in {dtype}: "
              f"{paths}")


def check_convbn(dtype, tols):
    """K6 against its plain version at each stride-1 block shape of the
    training path, each output within ``tols[name]`` of the largest entry
    (db against ``convbn_db_f64``); kernel, plain and library times and
    the bound. Returns one record per block."""
    import torch

    from remora_tpu_torch.infer.infer import full_f32
    from remora_tpu_torch.kernels import convbn as CB

    sfx = "f32" if dtype == torch.float32 else "bf16"
    records = []
    for seed, (block, I, O, K, Ti) in enumerate(CONVBN_BLOCKS):
        args = convbn_case(dtype, I, O, K, Ti, seed=20 + seed)
        x = args[0]
        To = Ti - K + 1
        with full_f32():
            got = CB.conv_bn_swish_bwd(*args)
            want = CB.conv_bn_swish_bwd_reference(*args)
            again = CB.conv_bn_swish_bwd(*args)
            db64 = convbn_db_f64(*args)
            torch.cuda.synchronize()
            errs, rels = {}, {}
            for name, a, b in zip(("dx", "dw", "db", "dgamma", "dbeta"),
                                  got, want):
                check(a.shape == b.shape and a.dtype == b.dtype,
                      f"K6 {block} {sfx}: {name} {tuple(a.shape)} {a.dtype}"
                      f" vs {tuple(b.shape)} {b.dtype}")
                d = (a.float() - b.float()).abs().max().item()
                errs[name] = d
                rels[name] = d / max(b.float().abs().max().item(), 1e-30)
            db_rel64 = ((got[2].double() - db64).abs().max()
                        / db64.abs().max()).item()
            plain_rel64 = ((want[2].double() - db64).abs().max()
                           / db64.abs().max()).item()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            lib = library_convbn_bwd(*args)
            lib_rel = {name: ((a.float() - b.float()).abs().max()
                              / b.float().abs().max()).item()
                       for name, a, b in (("dx", lib[0], want[0]),
                                          ("dw", lib[1], want[1]))}
            log(f"conv_bn_swish_bwd {block} {sfx} (B={BATCH}, Ti={Ti}, I={I},"
                f" O={O}, K={K}): relative max |d| dx {rels['dx']:.3e} dw "
                f"{rels['dw']:.3e} dgamma {rels['dgamma']:.3e} dbeta "
                f"{rels['dbeta']:.3e}; db vs f64 {db_rel64:.3e} (plain "
                f"version's {plain_rel64:.3e}, K6 vs plain "
                f"{rels['db']:.3e}; max |db| {db64.abs().max().item():.4e})"
                f" (tolerances {tols}); repeat identical {same}; library vs "
                f"plain dx {lib_rel['dx']:.3e} dw {lib_rel['dw']:.3e}")
            for name in ("dx", "dw", "dgamma", "dbeta"):
                check(np.isfinite(rels[name]) and rels[name] <= tols[name],
                      f"K6 {block} {sfx}: {name} disagrees with the plain "
                      f"version ({rels[name]:.3e} > {tols[name]})")
            check(np.isfinite(db_rel64) and db_rel64 <= tols["db"],
                  f"K6 {block} {sfx}: db disagrees with the plain version's "
                  f"math in f64 ({db_rel64:.3e} > {tols['db']})")
            check(same, f"K6 {block} {sfx}: a repeated call differs")
            ms = time_ms(lambda: CB.conv_bn_swish_bwd(*args))
            plain_ms = time_ms(lambda: CB.conv_bn_swish_bwd_reference(*args),
                               n=10, calls=1)
            library_ms = time_ms(lambda: library_convbn_bwd(*args), n=10,
                                 calls=1)
        prod = 2.0 * BATCH * To * I * O * K
        flops = 3 * prod  # the conv once, dw, dx
        isz = x.element_size()
        io_bytes = ((BATCH * Ti * I * 2 + BATCH * To * O) * isz
                    + (O * I * K * 2 + 6 * O) * 4)
        bound_ms, bound_by = lstm_bound(flops, io_bytes, dtype)
        log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"(ConvBNSwish.backward) {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.3f} GFLOP, "
            f"{io_bytes / 1e6:.2f} MB)")
        products = CB.products(BATCH, Ti, I, O, K, dtype)
        log(f"  products: {products}")
        records.append({
            "name": f"conv_bn_swish_bwd_{block}_{sfx}",
            "route": "cuda",
            "source": "remora_tpu_torch/csrc/convbn_bwd.cu",
            "replaces": "remora_tpu/kernels/pallas_convbn.py:57",
            "launches": None,
            "max_abs_err": max(errs.values()),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": f"B={BATCH}, Ti={Ti}, I={I}, O={O}, K={K}",
            "dtype": sfx,
            "products": products,
            "max_rel_err": dict(rels, db=db_rel64),
            "key": (Ti, I, O, K),
        })
    return records


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


def seeded_checkpoint(path, seed=1, refine=None):
    """Save a ConvLSTM_w_ref with numpy-seeded weights (fan-in uniform
    bounds, BatchNorm statistics calibrated on seeded synthetic chunks)
    via ``save_model``; ``refine`` = (9-mer level table, centre) puts a
    SigMapRefiner (rough rescale, no scale iterations) in its metadata."""
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
        "modified_base_labels": True,
        "reverse_signal": False,
        "base_start_justify": False,
        "offset": 0,
        "pa_scaling": None,
    }
    arrays = None
    if refine is not None:
        table, center = refine
        meta.update(refine_kmer_center_idx=center,
                    refine_do_rough_rescale=True, refine_scale_iters=0)
        arrays = {"refine_kmer_levels": table}
    model_io.save_model(path, model, meta, arrays)


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


def kernel_rows(prof):
    """(device us, name, count) per kernel of a profile, largest first:
    kernels only, since a CPU op's device time repeats its kernels', and no
    user annotation (a range such as ``Optimizer.step#AdamW.step`` can come
    back as a device row that spans the kernels it encloses)."""
    from torch.autograd import DeviceType

    return sorted(
        ((evt.self_device_time_total, evt.key, evt.count)
         for evt in prof.key_averages()
         if evt.device_type == DeviceType.CUDA
         and not getattr(evt, "is_user_annotation", False)
         and evt.self_device_time_total > 0),
        reverse=True,
    )


def profile_stage(handle, batches, wall):
    """Device time by kernel over one ``run_model_batched`` pass
    (torch.profiler), and the kernels' busy share of ``wall``, the
    unprofiled median pass (the profiled pass's own wall, which the
    profiler's host overhead inflates, is printed beside it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, profiled_wall = run_stage(handle, batches)
    rows = kernel_rows(prof)
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


# ---------------- phase 5: streaming inference, POD5 + BAM -> modBAM -----

# the reads: 4000 bases each, signal following phase 8b's 9-mer table;
# the CPU leg runs the first STREAM_SUBSET of them
STREAM_READS, STREAM_BASES, STREAM_SUBSET = 256, 4000, 16


def write_stream_set(root, name, n_reads, table, center, seed=12):
    """``benchmarks/synth_set.py::write_synth_set``'s reads (forward
    strand, move table, sm/sd and MD tags), their signal following the
    9-mer table: the BAM written with the port's ``BamWriter`` and indexed
    by the port's native scan, the signal written to a POD5 file by the
    port's ``Pod5Writer`` (VBZ through pyarrow's zstd codec) and read back
    bit for bit by its ``DatasetReader``. Returns (POD5 path, BAM
    path)."""
    from remora_tpu_torch.core.seq import int_to_seq
    from remora_tpu_torch.io import native
    from remora_tpu_torch.io.bam import BamHeader, BamRecord, BamWriter
    from remora_tpu_torch.io.pod5 import DatasetReader
    from remora_tpu_torch.io.pod5_write import Pod5Writer
    from remora_tpu_torch.io.read_index import ReadIndexedBam
    from remora_tpu_torch.refine.levels import extract_levels

    rng = np.random.default_rng(seed)
    pod5_path = os.path.join(root, f"{name}.pod5")
    bam_path = os.path.join(root, f"{name}.bam")
    ref_len = (STREAM_BASES + 1000) * n_reads
    header = BamHeader(
        text=f"@HD\tVN:1.6\tSO:unknown\n@SQ\tSN:ctg1\tLN:{ref_len}\n",
        references=["ctg1"], lengths=[ref_len],
    )
    reads = {}
    with BamWriter(bam_path, header) as bw, \
            Pod5Writer(pod5_path, sample_rate=5000) as p5w:
        for ri in range(n_reads):
            rid = f"00000000-0000-4000-8000-{seed:04d}{ri:08d}"
            int_seq, s2s, dacs = synth_read(
                rng, STREAM_BASES,
                lambda s: extract_levels(s, table, 9, center))
            p5w.add_read(rid, dacs, 90.0, 20.0)
            reads[rid] = dacs
            mv = np.zeros(int(s2s[-1]), dtype=np.uint8)
            mv[s2s[:-1]] = 1
            seq = int_to_seq(int_seq)
            bw.write(BamRecord(
                query_name=rid, flag=0, reference_id=0,
                reference_start=(STREAM_BASES + 1000) * ri, mapq=60,
                cigartuples=[(0, len(seq))], query_sequence=seq,
                query_qualities=np.full(len(seq), 30, np.uint8),
                tags=[("MD", "Z", str(len(seq))), ("sm", "f", 0.0),
                      ("sd", "f", 1.0),
                      ("mv", "Bc", np.concatenate([[1], mv]).astype(
                          np.int8))],
                header=header,
            ))
    scan = native.bam_scan_index(bam_path, ("mv",))
    check(scan is not None, "the native BAM scan is unavailable")
    idx = ReadIndexedBam(bam_path, req_tags={"mv"})
    check(sorted(idx.read_ids) == sorted(reads)
          and list(scan[0]) == sorted(o for rid in reads for o in idx[rid]),
          "the BAM index disagrees with the native scan")
    with DatasetReader(pod5_path) as rdr:
        back = {rec.read_id: rec.signal for rec in rdr.reads()}
    check(back.keys() == reads.keys()
          and all(np.array_equal(back[rid], reads[rid]) for rid in reads),
          f"{pod5_path}: the signal read back differs from the DACs written")
    return pod5_path, bam_path


def extract_signal_rate(pod5_path, n_passes=3):
    """ExtractSignal's work alone, in this process: every read of a POD5
    file through ``io.read.iter_signal`` (the stage's generator: the
    container, VBZ decode through pyarrow, calibration), the median of
    ``n_passes`` passes (the file warm in the page cache). Returns (reads,
    compressed signal bytes, median wall seconds)."""
    import pyarrow.compute as pc

    from remora_tpu_torch.io.pod5 import DatasetReader
    from remora_tpu_torch.io.read import iter_signal

    with DatasetReader(pod5_path) as rdr:
        n_bytes = sum(pc.sum(pc.binary_length(
            r._signal_tbl["signal"])).as_py() for r in rdr._readers)
    walls = []
    for _ in range(n_passes):
        t0 = time.perf_counter()
        n_reads = sum(err is None for _read, err in iter_signal(pod5_path))
        walls.append(time.perf_counter() - t0)
    return n_reads, n_bytes, statistics.median(walls)


class _LogLines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def bam_tags(path, by_name=False):
    """{(read id, flag, start) or read id: (MM, ML)} of a BAM."""
    from remora_tpu_torch.io.bam import FastBamScanner

    tags = {}
    for rec in FastBamScanner(path):
        td = rec.tag_dict()
        key = (rec.query_name if by_name else
               (rec.query_name, rec.flag, rec.reference_start))
        tags[key] = (td.get("MM"), np.asarray(td.get("ML"), np.uint8))
    return tags


def stream_leg(pod5_path, bam_path, handle, out_path, tag, **kwargs):
    """One run of ``infer_from_pod5_and_bam`` with the launch counts set
    to 0 first; returns ({(read id, flag, start): (MM, ML)}, counts,
    wall seconds, the driver's log lines)."""
    import torch

    from remora_tpu_torch.infer.infer import infer_from_pod5_and_bam
    from remora_tpu_torch.kernels import banded_dp as DP
    from remora_tpu_torch.kernels import lstm as K
    from remora_tpu_torch.refine import refiner as RF

    handler = _LogLines()
    logger = logging.getLogger("RemoraTPUTorch")
    logger.addHandler(handler)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    K.LAUNCHES = DP.LAUNCHES_FWD = DP.LAUNCHES_TB = 0
    RF.PLANNED_LAUNCHES = RF.HOST_ROUTED_READS = 0
    t0 = time.perf_counter()
    try:
        n_written = infer_from_pod5_and_bam(
            pod5_path, bam_path, [handle], out_path, batch_size=BATCH,
            **kwargs)
    finally:
        logger.removeHandler(handler)
    wall = time.perf_counter() - t0
    counts = {"k1": K.LAUNCHES, "k4": DP.LAUNCHES_FWD, "k5": DP.LAUNCHES_TB,
              "planned": RF.PLANNED_LAUNCHES,
              "host_routed": RF.HOST_ROUTED_READS, "written": n_written}
    tags = bam_tags(out_path)
    check(len(tags) == n_written, f"{tag}: {len(tags)} records read back, "
          f"{n_written} written")
    return tags, counts, wall, handler.lines


def tag_diff(got, want):
    """(MM strings that differ, ML bytes that differ, max |ML delta|) over
    the records of ``want``."""
    mm = ml = worst = 0
    for key, (w_mm, w_ml) in want.items():
        g_mm, g_ml = got[key]
        mm += g_mm != w_mm
        if g_ml.size != w_ml.size:
            ml += max(g_ml.size, w_ml.size)
            continue
        delta = np.abs(g_ml.astype(int) - w_ml.astype(int))
        ml += int((delta > 0).sum())
        worst = max(worst, int(delta.max(initial=0)))
    return mm, ml, worst


def profile_stream(pod5_path, bam_path, path, root):
    """The device's busy and idle share over one f32 streaming run
    (torch.profiler; the forked stages never touch the card), and its
    kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from remora_tpu_torch.infer.infer import ModelHandle

    handle = ModelHandle.load(path)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _tags, counts, wall, _ = stream_leg(
            pod5_path, bam_path, handle,
            os.path.join(root, "stream_profiled.bam"), "stream profiled")
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    if not rows:
        log("  stream profile: the profiler recorded no device time "
            "(device busy share not measured)")
        return
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"  stream f32 profiled run: {counts['written']} reads in "
        f"{wall:.3f} s; kernels busy {busy_s * 1e3:.4f} ms ("
        f"{busy_s / wall:.1%} busy, {1 - busy_s / wall:.1%} idle)")
    for dev_us, key, count in rows[:8]:
        log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")


def top_functions(stats, key, n=10):
    """The ``n`` functions of a ``pstats.Stats`` with the largest ``key``
    ("cumulative" or "tottime"), as log lines."""
    rows = sorted(stats.stats.items(), key=lambda kv: kv[1][3 if key ==
                  "cumulative" else 2], reverse=True)[:n]
    return [f"    {ct:9.4f} s cum {tt:9.4f} s self {nc:>8d} calls  "
            f"{os.path.basename(path)}:{line}({func})"
            for (path, line, func), (_cc, nc, tt, ct, _callers) in rows]


def profile_stream_stages(root, pod5_path, bam_path, path, want_tags):
    """Phase 5's f32 run once more, in a process of its own started with
    REMORA_TPU_INFER_RUN_MODEL_PROFILE_FILE set (``--profile-stream``;
    the driver reads the variable at import): its tags must equal phase
    5's f32 tags, and the ``call_batches`` thread's cProfile is logged,
    the top ten functions by cumulative and by own time. From Python 3.12
    cProfile records every thread of the process while the stage runs,
    so the table holds the other stages' calls too."""
    import pstats

    prof = os.path.join(root, "call_batches.pstats")
    out = os.path.join(root, "stream_cprofile.bam")
    env = dict(os.environ, REMORA_TPU_INFER_RUN_MODEL_PROFILE_FILE=prof)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--profile-stream",
         pod5_path, bam_path, path, out],
        env=env, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, "the cProfiled stream run failed:\n"
          + proc.stderr[-3000:])
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    tags = bam_tags(out)
    mm, ml, worst = tag_diff(tags, want_tags)
    log(f"stream f32 cProfiled (call_batches): {result['written']} reads in "
        f"{result['wall_s']:.3f} s, K1 {result['k1']}; vs phase 5's f32 "
        f"run: MM strings that differ {mm}, ML bytes that differ {ml} "
        f"(process wall {time.monotonic() - t0:.1f} s with start-up)")
    check(tags.keys() == want_tags.keys() and mm == ml == 0,
          "stream cProfiled: tags differ from phase 5's f32 run")
    stats = pstats.Stats(prof)
    for key in ("cumulative", "tottime"):
        log(f"  call_batches cProfile, top ten by {key} ("
            f"{stats.total_calls} calls, {stats.total_tt:.3f} s profiled):")
        for line in top_functions(stats, key):
            log(line)
    return result


def profile_stream_child(argv):
    """``--profile-stream POD5 BAM CKPT OUT``: one f32 streaming run (the
    parent sets the profile variable); its wall and counts as a JSON
    line."""
    from remora_tpu_torch.infer.infer import ModelHandle

    pod5_path, bam_path, path, out = argv
    _tags, counts, wall, _ = stream_leg(
        pod5_path, bam_path, ModelHandle.load(path), out, "stream cProfiled")
    print(json.dumps({"wall_s": wall, "k1": counts["k1"],
                      "written": counts["written"]}), flush=True)
    return 0


def stream_infer(root, path, refine_path, smi, sets):
    """Phase 5: the port's ``infer_from_pod5_and_bam`` on the card, f32
    and bf16, then a CPU run of a 16-read subset and a refiner checkpoint
    through the device DP and the native DP. Returns (K1 launches by
    dtype, rates); the reads and the f32 run's tags go into ``sets``
    (phase 7's)."""
    import torch

    from remora_tpu_torch.infer.infer import ModelHandle

    # every index from the native scan, none cached under $HOME; no tqdm
    # bars in the log
    os.environ["REMORA_TPU_BAM_INDEX_CACHE"] = "0"
    os.environ["LOG_SAFE"] = "1"
    table, center = synth_level_table()
    pod5_path, bam_path = write_stream_set(root, "stream", STREAM_READS,
                                           table, center)
    sub_pod5, sub_bam = write_stream_set(root, "subset", STREAM_SUBSET,
                                         table, center)
    results, launches, rates = {}, {}, {}
    n_read, n_bytes, wall = extract_signal_rate(pod5_path)
    log(f"stream ExtractSignal alone: {n_read} reads, {n_bytes / 1e6:.3f} "
        f"MB of VBZ signal in {wall:.4f} s = {n_read / wall:.1f} reads/s, "
        f"{n_bytes / 1e6 / wall:.1f} MB/s compressed (median of 3 passes, "
        f"file warm) [{smi}]")
    check(n_read == STREAM_READS, f"ExtractSignal read {n_read} reads")
    rates.update(extract_signal_reads_per_s=n_read / wall,
                 extract_signal_mb_per_s=n_bytes / 1e6 / wall)
    for dtype, tag in ((None, "f32"), (torch.bfloat16, "bf16")):
        handle = ModelHandle.load(path, compute_dtype=dtype)
        check(handle.device.type == "cuda", f"stream {tag}: handle on "
              f"{handle.device}")
        tags, counts, wall, lines = stream_leg(
            pod5_path, bam_path, handle,
            os.path.join(root, f"stream_{tag}.bam"), f"stream {tag}")
        n_calls = sum(ml.size for _mm, ml in tags.values())
        n_batches = -(-n_calls // BATCH)
        log(f"stream {tag}: {counts['written']} of {STREAM_READS} reads "
            f"({STREAM_BASES} bases), {n_calls} calls in {wall:.3f} s = "
            f"{STREAM_READS / wall:.1f} reads/s, {n_calls / wall:.1f} "
            f"chunks/s; K1 launches {counts['k1']} for {n_batches} "
            f"batches of {BATCH} [{smi}]")
        for line in lines:
            if line.startswith(("Device stage:", "Stage queue occupancy")):
                for part in line.splitlines():
                    log(f"  {part}")
        check(counts["written"] == STREAM_READS,
              f"stream {tag}: {counts['written']} reads written of "
              f"{STREAM_READS}")
        check(all(mm and ml.size for mm, ml in tags.values()),
              f"stream {tag}: a record without calls")
        check(counts["k1"] == n_batches, f"stream {tag}: K1 launched "
              f"{counts['k1']} times for {n_batches} batches")
        check(n_calls % BATCH != 0, f"stream {tag}: the last batch is full")
        results[tag], launches[tag] = tags, counts["k1"]
        rates[f"stream_{tag}_reads_per_s"] = STREAM_READS / wall
        rates[f"stream_{tag}_chunks_per_s"] = n_calls / wall
    mm, ml, worst = tag_diff(results["bf16"], results["f32"])
    log(f"stream bf16 vs f32: MM strings that differ {mm}, ML bytes that "
        f"differ {ml}, max |delta| {worst}")
    check(mm == 0, "stream bf16: MM strings differ from f32")
    profile_stream(pod5_path, bam_path, path, root)
    profile_stream_stages(root, pod5_path, bam_path, path, results["f32"])

    # the same driver with the handle on the CPU, 16 reads
    cpu = ModelHandle.load(path, device="cpu")
    cpu_tags, counts, cpu_wall, _ = stream_leg(
        sub_pod5, sub_bam, cpu, os.path.join(root, "subset_cpu.bam"),
        "subset cpu")
    card_tags, _c, _w, _l = stream_leg(
        sub_pod5, sub_bam, ModelHandle.load(path),
        os.path.join(root, "subset_f32.bam"), "subset f32")
    check(counts["k1"] == 0, "the CPU leg launched K1")
    check(card_tags.keys() == cpu_tags.keys()
          and len(cpu_tags) == STREAM_SUBSET, "subset: records differ")
    mm, ml, worst = tag_diff(card_tags, cpu_tags)
    n_calls = sum(v.size for _m, v in cpu_tags.values())
    log(f"stream f32 card vs CPU, {STREAM_SUBSET} reads ({n_calls} calls, "
        f"CPU {cpu_wall:.3f} s): MM strings that differ {mm}, ML bytes "
        f"that differ {ml}, max |delta| {worst} (tolerance 1)")
    check(mm == 0, "subset: MM differs between the card and the CPU")
    check(worst <= 1, "subset: ML moved by more than 1 between the card "
          "and the CPU")

    # a refiner checkpoint: the device DP (K4/K5) against the native DP
    refine_tags = {}
    for backend in ("device", "native"):
        handle = ModelHandle.load(refine_path)
        tags, counts, wall, _ = stream_leg(
            pod5_path, bam_path, handle,
            os.path.join(root, f"refine_{backend}.bam"),
            f"refine {backend}", refine_backend=backend)
        log(f"stream refine {backend}: {counts['written']} reads in "
            f"{wall:.3f} s = {STREAM_READS / wall:.1f} reads/s; K1 "
            f"{counts['k1']}, K4/K5 launches ({counts['k4']}, "
            f"{counts['k5']}), planned {counts['planned']}, reads routed "
            f"to the host {counts['host_routed']}")
        check(counts["written"] == STREAM_READS,
              f"refine {backend}: {counts['written']} reads written")
        if backend == "device":
            check(counts["k4"] == counts["k5"] == counts["planned"] > 0,
                  f"refine device: K4/K5 launched ({counts['k4']}, "
                  f"{counts['k5']}), the refiner planned "
                  f"{counts['planned']}")
            check(counts["host_routed"] == 0, "refine device: reads were "
                  "routed to the host DP")
            from remora_tpu_torch.refine.refiner import _refine_dp_devices

            dp_devs = _refine_dp_devices(
                handle.metadata["sig_map_refiner"].dp_device)
            check(dp_devs == [handle.device], f"refine device: the DP "
                  f"spreads over {dp_devs}, not the models' "
                  f"{handle.device} alone")
        else:
            check(counts["k4"] == counts["k5"] == 0,
                  "refine native: K4/K5 launched")
        refine_tags[backend] = tags
        rates[f"stream_refine_{backend}_reads_per_s"] = STREAM_READS / wall
    mm, ml, worst = tag_diff(refine_tags["device"], refine_tags["native"])
    log(f"stream refine device vs native: MM strings that differ {mm}, ML "
        f"bytes that differ {ml}")
    check(refine_tags["device"].keys() == refine_tags["native"].keys()
          and mm == ml == 0, "refine: the device DP's tags differ from the "
          "native DP's")
    mm, ml, worst = tag_diff(refine_tags["device"], results["f32"])
    log(f"stream refine vs no refiner: ML bytes that differ {ml}")
    check(ml > 0, "refine: the refiner changed no call")
    rates.update(stream_reads=STREAM_READS, stream_bases=STREAM_BASES,
                 stream_batch=BATCH)
    sets.update(pod5=pod5_path, bam=bam_path, stream_f32_tags=results["f32"],
                refine_ckpt=refine_path,
                stream_refine_tags=refine_tags["device"])
    return launches, rates


# ---------------- phase 5b: duplex inference ----------------------------

# 64 pairs of 4000 bases; the CPU and refiner legs run the first
# DUPLEX_SMALL_PAIRS resolvable pairs of the same set. The full legs align
# in DUPLEX_PREP_WORKERS forked workers (the driver's
# num_duplex_prep_workers).
# Pair DUPLEX_NO_DUPLEX has no duplex record, pair DUPLEX_NO_SIGNAL no
# complement signal; every fourth duplex record is mapped reverse.
DUPLEX_PAIRS, DUPLEX_BASES, DUPLEX_SMALL_PAIRS = 64, 4000, 8
DUPLEX_PREP_WORKERS = 4
DUPLEX_NO_DUPLEX, DUPLEX_NO_SIGNAL = 1, 2


def edit_seq(rng, seq, n_edits):
    """``seq`` with ``n_edits`` interior substitutions, insertions and
    deletions in turn."""
    out = list(seq)
    sites = sorted(rng.choice(np.arange(10, len(seq) - 10), n_edits,
                              replace=False), reverse=True)
    for k, pos in enumerate(sites):
        base = "ACGT"[int(rng.integers(4))]
        if k % 3 == 0:
            out[pos] = base
        elif k % 3 == 1:
            out.insert(pos, base)
        else:
            del out[pos]
    return "".join(out)


def strand_record(bam, header, rid, seq, s2s, *, flag=0, ref_start=0,
                  with_moves=True):
    """A BAM record of ``bam`` (either package's BAM module) for basecalls
    ``seq`` in read orientation; stored reverse-complemented for a reverse
    ``flag``. With moves: the move table, sm/sd and MD tags of
    ``write_stream_set``'s records."""
    from remora_tpu_torch.core.seq import revcomp

    stored = revcomp(seq) if flag & 16 else seq
    tags = [("MD", "Z", str(len(seq)))]
    if with_moves:
        mv = np.zeros(int(s2s[-1]), dtype=np.uint8)
        mv[s2s[:-1]] = 1
        tags += [("sm", "f", 0.0), ("sd", "f", 1.0),
                 ("mv", "Bc", np.concatenate([[1], mv]).astype(np.int8))]
    return bam.BamRecord(
        query_name=rid, flag=flag, reference_id=0,
        reference_start=ref_start, mapq=60,
        cigartuples=[(0, len(seq))], query_sequence=stored,
        query_qualities=np.full(len(seq), 30, np.uint8),
        tags=tags, header=header,
    )


def write_duplex_set(root, n_pairs, n_bases, bam, add_signal,
                     levels_of=None, seed=21):
    """A synthetic duplex set: per pair a template (mapped forward) and a
    complement, the template's reverse complement with 4 edits (mapped
    reverse), in a simplex BAM with moves; a duplex BAM whose records,
    named ``tid;cid``, carry the template with 2 edits (every fourth
    mapped reverse); and a pairs file of every pair. ``bam`` is either
    package's BAM module; ``add_signal(read_id, dacs)`` stores a strand's
    signal. Returns (simplex BAM, duplex BAM, pairs file)."""
    from remora_tpu_torch.core.seq import int_to_seq, revcomp, seq_to_int

    rng = np.random.default_rng(seed)
    ref_len = (n_bases + 1000) * n_pairs
    header = bam.BamHeader(
        text=f"@HD\tVN:1.6\tSO:unknown\n@SQ\tSN:ctg1\tLN:{ref_len}\n",
        references=["ctg1"], lengths=[ref_len],
    )
    simplex, duplex, pairs = [], [], []
    for i in range(n_pairs):
        tid = f"00000000-0000-4000-8000-{seed:04d}{2 * i:08d}"
        cid = f"00000000-0000-4000-8000-{seed:04d}{2 * i + 1:08d}"
        t_int = rng.integers(0, 4, n_bases)
        t_s2s, t_dacs = strand_signal(rng, t_int, levels_of)
        t_seq = int_to_seq(t_int)
        c_seq = edit_seq(rng, revcomp(t_seq), 4)
        c_s2s, c_dacs = strand_signal(rng, seq_to_int(c_seq), levels_of)
        d_seq = edit_seq(rng, t_seq, 2)
        start = (n_bases + 1000) * i
        add_signal(tid, t_dacs)
        if i != DUPLEX_NO_SIGNAL:
            add_signal(cid, c_dacs)
        simplex.append(strand_record(bam, header, tid, t_seq, t_s2s,
                                     ref_start=start))
        simplex.append(strand_record(bam, header, cid, c_seq, c_s2s,
                                     flag=16, ref_start=start))
        if i != DUPLEX_NO_DUPLEX:
            duplex.append(strand_record(
                bam, header, f"{tid};{cid}", d_seq, None,
                flag=16 if i % 4 == 3 else 0, ref_start=start,
                with_moves=False))
        pairs.append(f"{tid} {cid}\n")
    paths = [os.path.join(root, name)
             for name in ("simplex.bam", "duplex.bam", "pairs.txt")]
    for path, records in zip(paths, (simplex, duplex)):
        with bam.BamWriter(path, header) as bw:
            for rec in records:
                bw.write(rec)
    with open(paths[2], "w") as fh:
        fh.writelines(pairs)
    return paths


def skip_tally(messages):
    """{reason: count} of a driver's skip tally, from the log messages of
    either package: the inference drivers' 'Unsuccessful read reasons'
    and the prepare driver's 'Unsuccessful read/chunk reasons'."""
    tally = {}
    for msg in messages:
        if msg.startswith(("Unsuccessful read reasons:",
                           "Unsuccessful read/chunk reasons:")):
            for line in msg.splitlines()[1:]:
                num, why = line.split(" : ", 1)
                tally[why.strip()] = int(num.replace(",", ""))
    return tally


def duplex_leg(key, paths, handle, out_path, tag, **kwargs):
    """One ``infer_duplex`` run with the launch counts set to 0 first and
    the handle's ``eval_fn`` calls counted; returns ({duplex read id:
    (MM, ML)}, counts, wall seconds, the driver's log lines)."""
    import torch

    from remora_tpu_torch.infer.duplex_infer import infer_duplex
    from remora_tpu_torch.kernels import banded_dp as DP
    from remora_tpu_torch.kernels import lstm as K
    from remora_tpu_torch.refine import refiner as RF

    inner, buckets = handle.eval_fn, []

    def counted(sigs, enc_kmers):
        buckets.append(sigs.shape[0])
        return inner(sigs, enc_kmers)

    handle._eval = counted
    handler = _LogLines()
    logger = logging.getLogger("RemoraTPUTorch")
    logger.addHandler(handler)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    K.LAUNCHES = DP.LAUNCHES_FWD = DP.LAUNCHES_TB = 0
    RF.PLANNED_LAUNCHES = RF.HOST_ROUTED_READS = 0
    simplex_bam, duplex_bam, pairs = paths
    t0 = time.perf_counter()
    try:
        n_written = infer_duplex(
            simplex_pod5_path=key, simplex_bam_path=simplex_bam,
            duplex_bam_path=duplex_bam, pairs_path=pairs,
            models=[handle], out_bam=out_path, **kwargs)
    finally:
        logger.removeHandler(handler)
        handle._eval = inner
    wall = time.perf_counter() - t0
    counts = {"k1": K.LAUNCHES, "k4": DP.LAUNCHES_FWD, "k5": DP.LAUNCHES_TB,
              "planned": RF.PLANNED_LAUNCHES,
              "host_routed": RF.HOST_ROUTED_READS, "written": n_written,
              "eval_calls": len(buckets), "buckets": sorted(set(buckets))}
    tags = bam_tags(out_path, by_name=True)
    check(len(tags) == n_written, f"{tag}: {len(tags)} records read back, "
          f"{n_written} written")
    return tags, counts, wall, handler.lines


def check_lstm_last_buckets():
    """K1 against its plain version at every power-of-two batch that
    ``RemoraRead.run_model`` pads a strand's calls to, 1 to 2048, both
    dtypes, at phase 3's tolerances (T = 124, C = H = 64)."""
    import torch

    from remora_tpu_torch.infer.infer import full_f32
    from remora_tpu_torch.kernels import lstm as K

    worst = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        errs = []
        for b in (1 << k for k in range(12)):
            params, x = lstm_case(dtype, B=b, seed=b)
            with full_f32():
                got = K.lstm_last(params, x)
                want = K.lstm_last_reference(params, x)
            torch.cuda.synchronize()
            check(got.shape == (b, SIZE) and got.dtype == dtype,
                  f"lstm_last {dtype} B={b}: got {tuple(got.shape)}")
            err = (got.float() - want.float()).abs().max().item()
            check(np.isfinite(err) and err <= tol,
                  f"lstm_last {dtype} B={b}: kernel disagrees with the "
                  f"plain version (max |dh| {err:.3e} > {tol})")
            errs.append(err)
        worst[dtype] = max(errs)
        log(f"lstm_last {dtype} at B = 1, 2, 4, ..., 2048: max |dh| by B "
            f"{[f'{e:.2e}' for e in errs]} (tolerance {tol})")
    return worst


def duplex_split(key, paths, handle, n_pairs=4):
    """Where a duplex pair's time goes: the driver's own stage functions
    run one after another in this process for the first ``n_pairs``
    resolvable pairs (host wall; the card synchronized after each
    forward): BuildDuplexedIoReads (the pair's reads from signal and
    BAM), MakeDuplexReads (the strands' alignment to the duplex
    basecall) and InferMods, split into its forwards (``eval_fn``) and
    the rest (chunk staging and tags). Returns the mean ms a pair of
    each."""
    import torch

    from remora_tpu_torch.infer import duplex_infer as D
    from remora_tpu_torch.io.read_index import ReadIndexedBam

    simplex_bam, duplex_bam, pairs = paths
    simplex_idx = ReadIndexedBam(simplex_bam, req_tags={"mv"})
    duplex_idx = ReadIndexedBam(duplex_bam, req_tags=set(),
                                read_id_converter=D.DelimIdConverter(";"))
    forward = [0.0]

    def timed_eval(sigs, enc_kmers):
        t0 = time.perf_counter()
        out = handle.eval_fn(sigs, enc_kmers)
        torch.cuda.synchronize()
        forward[0] += time.perf_counter() - t0
        return out

    caller = D.DuplexReadModCaller(timed_eval, handle.metadata)
    totals = dict.fromkeys(("reads", "align", "forward", "staging"), 0.0)
    done = 0
    with open(pairs) as fh:
        (builder,), _ = D.prep_duplex_read_builder(simplex_idx, key)
        for line in fh:
            if done == n_pairs:
                break
            t0 = time.perf_counter()
            pair = D.iter_duplexed_io_reads(tuple(line.split()), builder)
            t1 = time.perf_counter()
            duplex_read = D.make_duplex_reads(pair, duplex_idx)
            if duplex_read[1] is not None:
                continue
            t2 = time.perf_counter()
            forward[0] = 0.0
            _record, err = D.add_mod_mappings_to_alignment(duplex_read,
                                                           caller)
            check(err is None, f"duplex split: {err}")
            t3 = time.perf_counter()
            for name, secs in (("reads", t1 - t0), ("align", t2 - t1),
                               ("forward", forward[0]),
                               ("staging", t3 - t2 - forward[0])):
                totals[name] += secs
            done += 1
    split = {name: secs / done * 1e3 for name, secs in totals.items()}
    log(f"  duplex split, mean of {done} pairs through the driver's stage "
        f"functions one after another (host wall, ms a pair): "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
    return split


def duplex_infer(root, path, refine_path, smi, sets):
    """Phase 5b: ``infer_duplex`` on the card with phase 4's checkpoint,
    f32 then bf16; the first resolvable pairs through the same driver
    with the handle on the CPU, and with phase 5's refining checkpoint
    through the device DP and the native one; K1 against its plain
    version at every bucket size. Returns (K1 launches by dtype, K4/K5
    launches, rates); the set and the f32 run's tags go into ``sets``
    (phase 7's)."""
    import torch

    from remora_tpu_torch.infer.infer import ModelHandle
    from remora_tpu_torch.io import bam
    from remora_tpu_torch.io.pod5_write import Pod5Writer
    from remora_tpu_torch.refine.levels import extract_levels

    # every index from the native scan, none cached under $HOME; no tqdm
    # bars in the log
    os.environ["REMORA_TPU_BAM_INDEX_CACHE"] = "0"
    os.environ["LOG_SAFE"] = "1"
    log(f"duplex: {host_memory()}")
    table, center = synth_level_table()
    sub = os.path.join(root, "duplex")
    os.makedirs(sub)
    key = os.path.join(sub, "simplex.pod5")
    with Pod5Writer(key, sample_rate=5000) as p5w:
        paths = write_duplex_set(
            sub, DUPLEX_PAIRS, DUPLEX_BASES, bam,
            lambda rid, dacs: p5w.add_read(rid, dacs, 90.0, 20.0),
            levels_of=lambda s: extract_levels(s, table, 9, center))
    # the pair without a duplex record is filtered before the stages; the
    # one without its complement's signal is among the first resolvable
    want_written = DUPLEX_PAIRS - 2
    small_written = DUPLEX_SMALL_PAIRS - 1
    want_tally = {"duplex pair read id(s) missing from pod5": 1}
    results, launches, rates, handles = {}, {}, {}, {}
    for dtype, tag in ((None, "f32"), (torch.bfloat16, "bf16")):
        handle = handles[tag] = ModelHandle.load(path, compute_dtype=dtype)
        check(handle.device.type == "cuda", f"duplex {tag}: handle on "
              f"{handle.device}")
        tags, counts, wall, lines = duplex_leg(
            key, paths, handle, os.path.join(root, f"duplex_{tag}.bam"),
            f"duplex {tag}", num_duplex_prep_workers=DUPLEX_PREP_WORKERS)
        n_calls = sum(ml.size for _mm, ml in tags.values())
        log(f"duplex {tag}: {counts['written']} of {DUPLEX_PAIRS} pairs "
            f"({DUPLEX_BASES} bases a strand, {DUPLEX_PREP_WORKERS} prep "
            f"workers), {n_calls} calls in {wall:.3f} s = "
            f"{counts['written'] / wall:.2f} pairs/s, "
            f"{2 * counts['written'] / wall:.2f} strand calls/s, "
            f"{n_calls / wall:.1f} chunks/s; eval_fn calls "
            f"{counts['eval_calls']} (buckets {counts['buckets']}), K1 "
            f"launches {counts['k1']} [{smi}]")
        tally = skip_tally(lines)
        log(f"  duplex {tag} skip tally: {tally}")
        check(counts["written"] == want_written,
              f"duplex {tag}: {counts['written']} pairs written, not "
              f"{want_written}")
        check(tally == want_tally, f"duplex {tag}: skip tally {tally}")
        check(all(mm and "C+m" in mm and "G-m" in mm and ml.size
                  for mm, ml in tags.values()),
              f"duplex {tag}: a record without calls on both strands")
        check(counts["k1"] == counts["eval_calls"] == 2 * want_written,
              f"duplex {tag}: K1 launched {counts['k1']} times for "
              f"{counts['eval_calls']} eval_fn calls")
        results[tag], launches[tag] = tags, counts["k1"]
        rates[f"duplex_{tag}_pairs_per_s"] = counts["written"] / wall
        rates[f"duplex_{tag}_strand_calls_per_s"] = (
            2 * counts["written"] / wall)
        rates[f"duplex_{tag}_chunks_per_s"] = n_calls / wall
    # bf16 is held to f32 by the bf16 contract, an ML byte within 1; MM
    # (call positions and sequence only) shows the same records were
    # written
    check(results["f32"].keys() == results["bf16"].keys(),
          "duplex bf16: records differ from f32")
    mm, ml, worst = tag_diff(results["bf16"], results["f32"])
    log(f"duplex bf16 vs f32: MM strings that differ {mm}, ML bytes that "
        f"differ {ml}, max |delta| {worst} (tolerance 1)")
    check(mm == 0, "duplex bf16: MM strings differ from f32")
    check(worst <= 1, "duplex bf16: ML moved by more than 1 from f32")
    check(ml > 0, "duplex bf16: ML equals f32's byte for byte (the bf16 "
          "forward did not run)")
    # the f32 handle, warm from its leg
    rates.update({f"duplex_split_{k}_ms": v for k, v in duplex_split(
        key, paths, handles["f32"]).items()})

    # the first resolvable pairs through the same driver with the handle
    # on the CPU, against the f32 card leg's records
    cpu_tags, counts, cpu_wall, _ = duplex_leg(
        key, paths, ModelHandle.load(path, device="cpu"),
        os.path.join(root, "duplex_cpu.bam"), "duplex cpu",
        num_reads=DUPLEX_SMALL_PAIRS)
    check(counts["k1"] == 0, "the CPU duplex leg launched K1")
    check(len(cpu_tags) == small_written,
          f"duplex CPU leg: {len(cpu_tags)} records, not {small_written}")
    card_tags = {rid: results["f32"][rid] for rid in cpu_tags}
    mm, ml, worst = tag_diff(card_tags, cpu_tags)
    log(f"duplex f32 card vs CPU, {len(cpu_tags)} pairs (CPU "
        f"{cpu_wall:.3f} s): MM strings that differ {mm}, ML bytes that "
        f"differ {ml}, max |delta| {worst} (tolerance 1)")
    check(mm == 0, "duplex: MM differs between the card and the CPU")
    check(worst <= 1, "duplex: ML moved by more than 1 between the card "
          "and the CPU")

    # the refining checkpoint on the same pairs: the device DP (K4/K5,
    # one strand read a call) against the native DP
    refine_tags, dp_launches = {}, (0, 0)
    for backend in ("device", "native"):
        handle = ModelHandle.load(refine_path)
        tags, counts, wall, _ = duplex_leg(
            key, paths, handle,
            os.path.join(root, f"duplex_refine_{backend}.bam"),
            f"duplex refine {backend}", refine_backend=backend,
            num_reads=DUPLEX_SMALL_PAIRS)
        log(f"duplex refine {backend}: {counts['written']} pairs in "
            f"{wall:.3f} s = {counts['written'] / wall:.2f} pairs/s; K1 "
            f"{counts['k1']}, K4/K5 launches ({counts['k4']}, "
            f"{counts['k5']}), planned {counts['planned']}, reads routed "
            f"to the host {counts['host_routed']}")
        check(counts["written"] == small_written,
              f"duplex refine {backend}: {counts['written']} pairs written")
        if backend == "device":
            check(counts["k4"] == counts["k5"] == counts["planned"]
                  == 2 * small_written,
                  f"duplex refine device: K4/K5 launched ({counts['k4']}, "
                  f"{counts['k5']}), planned {counts['planned']}, for "
                  f"{2 * small_written} strands")
            check(counts["host_routed"] == 0, "duplex refine device: "
                  "reads were routed to the host DP")
            dp_launches = (counts["k4"], counts["k5"])
        else:
            check(counts["k4"] == counts["k5"] == 0,
                  "duplex refine native: K4/K5 launched")
        refine_tags[backend] = tags
        rates[f"duplex_refine_{backend}_pairs_per_s"] = (
            counts["written"] / wall)
    mm, ml, worst = tag_diff(refine_tags["device"], refine_tags["native"])
    log(f"duplex refine device vs native: MM strings that differ {mm}, ML "
        f"bytes that differ {ml}")
    check(refine_tags["device"].keys() == refine_tags["native"].keys()
          and mm == ml == 0, "duplex refine: the device DP's tags differ "
          "from the native DP's")
    _mm, ml, _w = tag_diff(refine_tags["device"], card_tags)
    check(ml > 0, "duplex refine: the refiner changed no call")

    k1_errs = check_lstm_last_buckets()
    log(f"duplex done: {host_memory()}")
    rates.update(duplex_pairs=DUPLEX_PAIRS, duplex_bases=DUPLEX_BASES,
                 duplex_prep_workers=DUPLEX_PREP_WORKERS,
                 duplex_k1_bucket_max_err_f32=k1_errs[torch.float32],
                 duplex_k1_bucket_max_err_bf16=k1_errs[torch.bfloat16])
    sets.update(duplex_pod5=key, duplex_paths=paths,
                duplex_f32_tags=results["f32"])
    return launches, dp_launches, rates


# ---------------- phase 6: the training path ----------------


def write_train_set(root, seed=4):
    """Two dataset members of synthetic raw chunks (``synth_inputs``)
    written with the package's ``CoreDataset``, and their config; labels
    in {0, 1} shift the signal at the chunk's centre, so training has
    something to learn."""
    from remora_tpu_torch.data.dataset import CoreDataset
    from remora_tpu_torch.data.metadata import DatasetMetadata

    rng = np.random.default_rng(seed)
    n = (TRAIN_STEPS + 1) * BATCH // 2
    members = []
    for m in range(2):
        sigs, seqs, maps, lens = synth_inputs(rng, n)
        labels = rng.integers(0, 2, n).astype(np.int64)
        sigs[:, 0, WIDTH // 2 - 20: WIDTH // 2 + 20] += labels[:, None]
        md = DatasetMetadata(
            allocate_size=n, max_seq_len=maps.shape[1] - 1,
            mod_bases=["m"], mod_long_names=["5mC"],
            motif_sequences=["CG"], motif_offsets=[0],
            chunk_context=(WIDTH // 2, WIDTH // 2),
            kmer_context_bases=(KMER_LEN // 2, KMER_LEN - 1 - KMER_LEN // 2),
            extra_arrays={},
        )
        path = os.path.join(root, f"member{m}")
        ds = CoreDataset(path, mode="w", metadata=md)
        ds.write_batch({
            "signal": sigs, "sequence": seqs,
            "sequence_to_signal_mapping": maps, "sequence_lengths": lens,
            "labels": labels,
        })
        ds.flush()
        ds.write_metadata()
        members.append([path, 1])
    config = os.path.join(root, "train_config.jsn")
    with open(config, "w") as fh:
        json.dump(members, fh)
    return config


class EpochRates(logging.Handler):
    """Collects the chunks/s that ``train_model`` logs per epoch."""

    def __init__(self):
        super().__init__()
        self.rates = []

    def emit(self, record):
        found = re.match(r"Epoch \d+: ([\d,]+) chunks/s", record.getMessage())
        if found:
            self.rates.append(float(found.group(1).replace(",", "")))


@contextlib.contextmanager
def convbn_mode(mode):
    """REMORA_TPU_CONVBN set to ``mode`` (None: left as it is)."""
    saved = os.environ.get("REMORA_TPU_CONVBN")
    if mode is not None:
        os.environ["REMORA_TPU_CONVBN"] = mode
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("REMORA_TPU_CONVBN", None)
        else:
            os.environ["REMORA_TPU_CONVBN"] = saved


def train_leg(root, config, bf16, tag, epochs=TRAIN_EPOCHS,
              steps_per_launch=1, convbn=None, epoch_steps=TRAIN_STEPS,
              chunk_context=None):
    """``train_model`` at full width with the launch counts set to 0; K2
    and K3 must launch once per optimizer step, and in pallas mode K6 once
    per stride-1 conv block and step. ``chunk_context`` (None: the
    dataset's) trims the dataset's chunks as they load. Returns (out dir,
    (K2, K3) launches, epoch rates, K6 launches by block shape)."""
    from remora_tpu_torch import log as port_log
    from remora_tpu_torch.kernels import convbn as CB
    from remora_tpu_torch.kernels import lstm as K
    from remora_tpu_torch.train import optim
    from remora_tpu_torch.train.train import train_model

    out = os.path.join(root, tag)
    rates = EpochRates()
    port_log.get_logger().addHandler(rates)
    t0 = time.monotonic()
    K.LAUNCHES_FWD = K.LAUNCHES_BWD = 0
    K.LAUNCHES_BWD_MMA.update(dict.fromkeys(K.LAUNCHES_BWD_MMA, 0))
    CB.LAUNCHES = 0
    CB.LAUNCHES_BY_SHAPE.clear()
    try:
        # no device named: the entry point's default is the GPU
        with convbn_mode(convbn):
            best = train_model(
                seed=1, out_path=out, remora_dataset_path=config,
                chunk_context=chunk_context, kmer_context_bases=None,
                batch_size=BATCH, model_name="ConvLSTM_w_ref", size=SIZE,
                train_opts=optim.TrainOpts(epochs=epochs,
                                           lr_scheduler_str="constant",
                                           learning_rate=2e-3),
                chunks_per_epoch=epoch_steps * BATCH, num_test_chunks=BATCH,
                bf16_compute=bf16, steps_per_launch=steps_per_launch,
            )
    finally:
        port_log.get_logger().removeHandler(rates)
    launches = (K.LAUNCHES_FWD, K.LAUNCHES_BWD)
    parts = dict(K.LAUNCHES_BWD_MMA)
    k6 = dict(CB.LAUNCHES_BY_SHAPE)
    steps = epoch_steps * epochs
    log(f"{tag}: train_model {steps} steps (REMORA_TPU_CONVBN="
        f"{convbn or 'auto'}, steps_per_launch {steps_per_launch}) in "
        f"{time.monotonic() - t0:.1f} s (with validation and checkpoints); "
        f"epoch rates {rates.rates} chunks/s; lstm_fwd/lstm_bwd launches "
        f"{launches}; K3 bf16 parts {parts}; conv_bn_swish_bwd launches "
        f"{CB.LAUNCHES} "
        f"{sorted(k6.items())}; best val acc {best:.4f}")
    check(launches == (steps, steps),
          f"{tag}: K2/K3 launched {launches} times for {steps} steps")
    check(parts == dict.fromkeys(parts, steps if bf16 else 0),
          f"{tag}: K3's bf16 parts launched {parts} times for {steps} "
          f"{'bf16' if bf16 else 'f32'} steps")
    blocks = CONVBN_BLOCKS if convbn == "pallas" else ()
    check(CB.LAUNCHES == len(blocks) * steps
          and k6 == {(Ti, I, O, K): steps for _, I, O, K, Ti in blocks},
          f"{tag}: K6 launched {CB.LAUNCHES} times {sorted(k6.items())} "
          f"for {steps} steps of {len(blocks)} stride-1 blocks")
    with open(os.path.join(out, "batch.log")) as fh:
        losses = [float(line.split()[1]) for line in fh.readlines()[1:]]
    check(len(losses) == steps and np.isfinite(losses).all(),
          f"{tag}: batch.log holds {len(losses)} losses, finite: "
          f"{np.isfinite(losses).all()}")
    log(f"{tag}: batch losses first {losses[0]:.4f}, last {losses[-1]:.4f}")
    with open(os.path.join(out, "validation.log")) as fh:
        rows = fh.readlines()[1:]
    check(len(rows) == 2 * (epochs + 1),
          f"{tag}: validation.log holds {len(rows)} rows")
    log(f"{tag}: last validation row: {rows[-2].strip()}")
    for name in ("model_final.checkpoint", "model_best.checkpoint",
                 "epoch_summary.txt"):
        check(os.path.isfile(os.path.join(out, name)),
              f"{tag}: {name} not written")
    check(len(rates.rates) == epochs, f"{tag}: epoch rates {rates.rates}")
    return out, launches, rates.rates, k6


# phase 6's trim leg: the dataset, stored at (200, 200), loaded at this
# chunk context; TRIM_STEPS train steps on it
TRIM_CONTEXT, TRIM_STEPS = (100, 100), 2


def trim_leg(root, config, smi, n_passes=5):
    """Phase 6's trim leg: the first member of phase 6's dataset (chunk
    context (200, 200)) as a super batch trimmed to TRIM_CONTEXT, the
    maps shifted by the leading cut as ``CoreDataset`` does, through the
    port's native row trim (``csrc/host/trim.cpp``) and its NumPy path:
    identical arrays, both timed (median of ``n_passes``); then
    TRIM_STEPS ``train_model`` steps (f32) on the dataset at
    TRIM_CONTEXT, K2/K3 once a step. Returns their (K2, K3) launches."""
    from remora_tpu_torch.data import dataset as D
    from remora_tpu_torch.io import native

    check(native.get_lib() is not None, "trim: the port's host library "
          "did not load, so the native trim cannot run")
    with open(config) as fh:
        member = json.load(fh)[0][0]
    sb = D.CoreDataset(member, infinite_iter=False).load_super_batch(0)
    lead_cut = WIDTH // 2 - TRIM_CONTEXT[0]
    rows = (sb["sequence_to_signal_mapping"] - np.int16(lead_cut),
            sb["sequence"], sb["sequence_lengths"])
    new_width, seq_ctx = sum(TRIM_CONTEXT), KMER_LEN - 1

    def run_native(maps, seqs, lens):
        check(native.trim_chunk_rows(maps, seqs, lens, new_width, seq_ctx),
              "trim: the native trim refused the super batch")

    def run_plain(maps, seqs, lens):
        D.trim_rows_numpy(seqs, maps, lens, new_width, seq_ctx)

    out, walls = {}, {}
    for name, fn in (("native", run_native), ("numpy", run_plain)):
        walls[name] = []
        for _ in range(n_passes):
            arrays = [a.copy() for a in rows]
            t0 = time.perf_counter()
            fn(*arrays)
            walls[name].append(time.perf_counter() - t0)
        out[name] = arrays
    same = all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(out["native"], out["numpy"]))
    shrunk = int((out["native"][2] < rows[2]).sum())
    ms = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    log(f"trim: {rows[0].shape[0]} chunks, chunk context (200, 200) -> "
        f"{TRIM_CONTEXT}: native {ms['native']:.3f} ms, NumPy "
        f"{ms['numpy']:.3f} ms (host, median of {n_passes}); arrays "
        f"identical {same}; rows shortened {shrunk} [{smi}]")
    check(same, "trim: the native trim's arrays differ from the NumPy "
          "path's")
    check(shrunk > 0, "trim: no row lost a base")
    _out, launches, _rates, _k6 = train_leg(
        root, config, False, "train_trim_f32", epochs=1,
        epoch_steps=TRIM_STEPS, chunk_context=TRIM_CONTEXT)
    return launches


def _train_batch(seed=5):
    rng = np.random.default_rng(seed)
    sigs, seqs, maps, lens = synth_inputs(rng, BATCH)
    return sigs, seqs, maps, lens, rng.integers(0, 2, BATCH).astype(np.int64)


def _loaded_model(ckpt):
    from remora_tpu_torch.models import model_io

    model, meta = model_io.load_model(ckpt)
    return model.cuda(), meta


# K3's kernels by name: lstm_bwd_f32.cu's f32 kernel and lstm_bwd_mma.cu's
# bf16 parts, and the ordered dW sum each launches (mma_sm90.cuh's
# ordered_sum<0>, demangled or mangled; K6's is ordered_sum<64>)
K3_DW_SUM = r"ordered_sum(<0>|ILi0E)"
K3_KERNELS = (r"lstm_bwd_\w*kernel|wide_rec_cluster_kernel|"
              r"general_rec_kernel|wide_prod_\w*|" + K3_DW_SUM)


def profile_train_step(ckpt, bf16, tag, n_walls=10, convbn=None):
    """Device time by kernel over one optimizer step of the raw train step
    (torch.profiler), against the median unprofiled step wall;
    ``convbn`` sets REMORA_TPU_CONVBN for the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from remora_tpu_torch.infer.infer import _put, full_f32
    from remora_tpu_torch.train import optim
    from remora_tpu_torch.train import train as T

    model, meta = _loaded_model(ckpt)
    opt = optim.TrainOpts().load_optimizer(
        [p for _, p in T.sorted_params(model)])
    step = T.make_train_step_raw(
        model, opt, meta["kmer_context_bases"], meta["chunk_len"],
        compute_dtype=torch.bfloat16 if bf16 else None)
    inputs = tuple(_put(a, torch.device("cuda")) for a in _train_batch())
    with full_f32(), convbn_mode(convbn):
        for _ in range(3):
            step(*inputs)
        torch.cuda.synchronize()
        walls = []
        for _ in range(n_walls):
            t0 = time.perf_counter()
            step(*inputs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(*inputs)
            torch.cuda.synchronize()
    rows = kernel_rows(prof)
    log(f"{tag}: unprofiled train step walls {[round(w, 5) for w in walls]}"
        f" s, median {wall * 1e3:.4f} ms = {BATCH / wall:.1f} chunks/s")
    if not rows:
        log(f"  {tag} profile: the profiler recorded no device time "
            "(device breakdown not measured)")
        return
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"  {tag} profile of one step: kernels busy {busy_s * 1e3:.4f} ms; "
        f"unprofiled median wall {wall * 1e3:.4f} ms ({busy_s / wall:.1%} "
        f"busy, {1 - busy_s / wall:.1%} idle)")
    for dev_us, key, count in rows[:15]:
        log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
    k3 = [r for r in rows if re.search(K3_KERNELS, r[1])]
    log(f"  {tag} K3 in the step: {sum(r[2] for r in k3)} launches, "
        f"{sum(r[0] for r in k3) / 1e3:.4f} ms")
    for dev_us, key, count in k3:
        log(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")


def step_walls():
    """Phase 6/6c's step profiles, the four legs, from a seeded
    checkpoint: each leg's unprofiled walls, kernel busy time and K3's
    kernels."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "convlstm_size64.npz")
        seeded_checkpoint(path)
        for bf16 in (False, True):
            for convbn in ("fused", "pallas"):
                profile_train_step(
                    path, bf16, f"{convbn} {'bf16' if bf16 else 'f32'} step",
                    n_walls=20, convbn=convbn)
    return 0


@contextlib.contextmanager
def plain_lstm_train():
    """Route the training LSTM (K2, K3) through the plain versions."""
    from remora_tpu_torch.kernels import lstm as K

    kernels = K.lstm_fwd, K.lstm_bwd
    K.lstm_fwd, K.lstm_bwd = K.lstm_fwd_reference, K.lstm_bwd_reference
    try:
        yield
    finally:
        K.lstm_fwd, K.lstm_bwd = kernels


def check_train_step_vs_plain(ckpt, kind=None):
    """One f32 train step (forward, loss, backward) with K2/K3 against the
    same step with their plain versions, from the same checkpoint and
    batch: loss <= 1e-5, LSTM and fc gradients <= 1e-4 relative. ``kind``
    "wide": the kernels' step must run on the wide kernels (lstm_wide.cu,
    lstm_wide_bwd.cu); "general": on lstm_general.cu, and the step it is
    held to runs with REMORA_TPU_LSTM=scan (the scan in layers.lstm)."""
    import torch

    from remora_tpu_torch.infer.infer import _put, full_f32
    from remora_tpu_torch.kernels import lstm as K
    from remora_tpu_torch.kernels.encoded_kmers import (
        compute_encoded_kmer_batch,
    )
    from remora_tpu_torch.train import train as T

    sigs, seqs, maps, lens, labels = (
        _put(a, torch.device("cuda")) for a in _train_batch(seed=6))
    results = []
    for plain in (False, True):
        model, meta = _loaded_model(ckpt)
        loss_fn = T.make_loss_fn(model, channels_last=True)
        launches = (K.LAUNCHES_FWD, K.LAUNCHES_BWD)
        split = K.LAUNCHES_GENERAL if kind == "general" else K.LAUNCHES_WIDE
        split_launches = dict(split)
        ref = (lstm_mode("scan") if kind == "general" else plain_lstm_train())
        with (ref if plain else contextlib.nullcontext()), full_f32():
            bb, ab = meta["kmer_context_bases"]
            enc = compute_encoded_kmer_batch(bb, ab, seqs, maps, lens,
                                             meta["chunk_len"],
                                             channels_last=True)
            loss, _ = loss_fn(sigs.transpose(1, 2), enc, labels)
            loss.backward()
            torch.cuda.synchronize()
        ran = (K.LAUNCHES_FWD - launches[0], K.LAUNCHES_BWD - launches[1])
        check(ran == ((0, 0) if plain else (1, 1)),
              f"train step (plain={plain}) launched K2/K3 {ran} times")
        ran_split = tuple(split[leg] - split_launches[leg]
                          for leg in ("fwd", "bwd"))
        check(ran_split == ((1, 1) if kind and not plain else (0, 0)),
              f"train step (plain={plain}) launched the {kind or 'wide'} "
              f"K2/K3 {ran_split} times")
        grads = {name: p.grad for name, p in T.sorted_params(model)
                 if name.split("/")[0] in ("lstm1", "lstm2", "fc")
                 and p.grad is not None}
        results.append((loss.item(), grads))
    (k_loss, k_grads), (p_loss, p_grads) = results
    dloss = abs(k_loss - p_loss)
    rel = {name: ((k_grads[name] - g).abs().max()
                  / g.abs().max().clamp(min=1e-30)).item()
           for name, g in p_grads.items()}
    ref_name = "the scan" if kind == "general" else "plain LSTM"
    log(f"train step{f' ({kind})' if kind else ''}, kernels vs {ref_name}: "
        f"loss {k_loss:.6f} vs "
        f"{p_loss:.6f} (|d| {dloss:.3e}, tolerance 1e-5); worst relative "
        f"gradient gap {max(rel.values()):.3e} ({max(rel, key=rel.get)}; "
        f"tolerance 1e-4)")
    check(dloss <= 1e-5, f"train step loss disagrees with {ref_name}")
    check(k_grads.keys() == p_grads.keys() and len(rel) >= 9,
          f"gradients of {sorted(rel)}")
    check(max(rel.values()) <= 1e-4,
          f"train step gradients disagree with {ref_name}")


def check_pallas_step_vs_fused(ckpt):
    """One f32 train step (forward, loss, backward) with
    REMORA_TPU_CONVBN=pallas (K6 in the four stride-1 blocks) against the
    same step in fused mode (cuDNN conv gradients), from the same
    checkpoint and batch: loss <= 1e-5, gradients <= 1e-4 relative, the
    conv biases (centred sums: rounding noise) <= 1e-5 absolute."""
    import torch

    from remora_tpu_torch.infer.infer import _put, full_f32
    from remora_tpu_torch.kernels import convbn as CB
    from remora_tpu_torch.kernels.encoded_kmers import (
        compute_encoded_kmer_batch,
    )
    from remora_tpu_torch.train import train as T

    sigs, seqs, maps, lens, labels = (
        _put(a, torch.device("cuda")) for a in _train_batch(seed=8))
    results = []
    for mode in ("pallas", "fused"):
        model, meta = _loaded_model(ckpt)
        loss_fn = T.make_loss_fn(model, channels_last=True)
        launches = CB.LAUNCHES
        with convbn_mode(mode), full_f32():
            bb, ab = meta["kmer_context_bases"]
            enc = compute_encoded_kmer_batch(bb, ab, seqs, maps, lens,
                                             meta["chunk_len"],
                                             channels_last=True)
            loss, _ = loss_fn(sigs.transpose(1, 2), enc, labels)
            loss.backward()
            torch.cuda.synchronize()
        ran = CB.LAUNCHES - launches
        want = len(CONVBN_BLOCKS) if mode == "pallas" else 0
        check(ran == want, f"train step ({mode}) launched K6 {ran} times")
        results.append((loss.item(), {name: p.grad for name, p in
                                      T.sorted_params(model)
                                      if p.grad is not None}))
    (k_loss, k_grads), (f_loss, f_grads) = results
    check(k_grads.keys() == f_grads.keys(), "gradients of other parameters")
    dloss = abs(k_loss - f_loss)
    rel, bias = {}, {}
    for name, g in f_grads.items():
        d = (k_grads[name] - g).abs().max().item()
        if "conv" in name and name.endswith("/b"):
            bias[name] = d
        else:
            rel[name] = d / max(g.abs().max().item(), 1e-30)
    worst = max(rel, key=rel.get)
    log(f"train step, pallas vs fused mode: loss {k_loss:.6f} vs "
        f"{f_loss:.6f} (|d| {dloss:.3e}, tolerance 1e-5); worst relative "
        f"gradient gap {rel[worst]:.3e} ({worst}; tolerance 1e-4) over "
        f"{len(rel)} parameters; conv-bias gradients |d| <= "
        f"{max(bias.values()):.3e} (tolerance 1e-5)")
    check(dloss <= 1e-5, "pallas-mode train step loss disagrees with fused")
    check(rel[worst] <= 1e-4,
          "pallas-mode train step gradients disagree with fused")
    check(max(bias.values()) <= 1e-5,
          "pallas-mode conv-bias gradients disagree with fused")


def infer_trained(ckpt):
    """The trained checkpoint through the inference slice's entry point."""
    from remora_tpu_torch.core.tags import softmax
    from remora_tpu_torch.infer.infer import ModelHandle

    handle = ModelHandle.load(ckpt)
    arrs = synth_inputs(np.random.default_rng(7), BATCH)
    out = handle.eval_raw(*arrs).cpu().numpy()
    check(out.shape == (BATCH, 2) and np.isfinite(out).all(),
          f"trained checkpoint: logits {out.shape}, finite "
          f"{np.isfinite(out).all()}")
    log(f"trained checkpoint via ModelHandle.load: {BATCH} chunks, mean "
        f"softmax p(mod) {float(softmax(out)[:, 1].mean()):.4f}")


# ---------------- phases 6f and 5c: data parallel -------------------------

# 6f: DP_STEPS optimizer steps a leg; (b) and 5c run DP_WORLD ranks that
# share cuda:0 over gloo (the card's machine has one GPU, and NCCL refuses
# two ranks on one device)
DP_STEPS, DP_WORLD, DP_LR = 4, 2, 0.05
DP_RANK_TIMEOUT_S = 300
# 6f(b)'s parameter error over the parameters' change in DP_STEPS steps:
# sync_bn's must stay below it, per-rank BatchNorm's above (read on an
# H100 80GB HBM3 at 700 W: sync_bn 1.4e-05, per-rank 0.0225)
DP_MOVED_TOL = 1e-3


def timed_all_reduce(mesh):
    """Time ``mesh``'s all-reduces (the card fenced before and after each,
    so the time is the collective's, its staging included); returns the
    one-element list of seconds."""
    import torch

    inner, spent = mesh.all_reduce, [0.0]

    def timed(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(t)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    mesh.all_reduce = timed
    return spent


def dp_batches(seed=7):
    """6f(b)'s DP_STEPS global batches of BATCH raw chunks (labels shift
    the signal at the centre, as ``write_train_set``'s)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(DP_STEPS):
        sigs, seqs, maps, lens = synth_inputs(rng, BATCH)
        labels = rng.integers(0, 2, BATCH).astype(np.int64)
        sigs[:, 0, WIDTH // 2 - 20: WIDTH // 2 + 20] += labels[:, None]
        out.append((sigs, seqs, maps, lens, labels))
    return out


def dp_steps(step, lo, hi):
    """6f(b)'s batches' rows [lo, hi) through ``step``: (losses, step
    walls in s)."""
    import torch

    from remora_tpu_torch.infer.infer import full_f32

    losses, walls = [], []
    with full_f32():
        for batch in dp_batches():
            arrs = [torch.from_numpy(a[lo:hi]).cuda() for a in batch]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _n_filt, _maxs = step(*arrs)
            losses.append(float(loss))
            walls.append(time.perf_counter() - t0)
    return losses, walls


def dp_model(ckpt):
    """(model on the card, SGD over its parameters, featurize args)."""
    import torch

    from remora_tpu_torch.train.train import sorted_params

    model, meta = _loaded_model(ckpt)
    opt = torch.optim.SGD([p for _, p in sorted_params(model)], lr=DP_LR)
    return model, opt, (tuple(meta["kmer_context_bases"]), WIDTH)


def model_params(model):
    from remora_tpu_torch.train.train import sorted_params

    return {name: p.detach().cpu().numpy() for name, p in
            sorted_params(model)}


def gloo_takes_cuda():
    """Whether this torch's gloo takes CUDA tensors in all_reduce and
    all_gather (every rank calls it)."""
    import torch
    import torch.distributed as dist

    found = {}
    t = torch.ones(4, device="cuda")
    for name, call in (
            ("all_reduce", lambda: dist.all_reduce(t)),
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(t) for _ in range(DP_WORLD)], t))):
        try:
            call()
            found[name] = True
        except RuntimeError as err:
            found[name] = f"refused: {str(err)[:120]}"
    return found


def dp_train_rank(rank, out_dir, ckpt):
    """A rank of 6f(b): DP_STEPS steps of ``make_dp_train_step`` on its
    BATCH / DP_WORLD rows of each batch, without and with sync_bn, the
    launch and all-reduce counts set to 0 first."""
    import torch

    from remora_tpu_torch.kernels import lstm as K
    from remora_tpu_torch.parallel import mesh as P

    mesh = P.make_mesh(torch.device("cuda", 0))
    result = {"gloo_cuda": gloo_takes_cuda()}
    per = BATCH // DP_WORLD
    for sync in (False, True):
        model, opt, featurize = dp_model(ckpt)
        step = P.make_dp_train_step(model, opt, mesh, sync_bn=sync,
                                    featurize_args=featurize)
        spent = timed_all_reduce(mesh)
        K.LAUNCHES_FWD = K.LAUNCHES_BWD = 0
        with P.count_calls() as reduces:
            losses, walls = dp_steps(step, rank * per, (rank + 1) * per)
        del mesh.all_reduce  # the timer
        tag = "sync" if sync else "local"
        result[tag] = {"losses": losses, "walls_s": walls,
                       "all_reduce_s": spent[0], "k2": K.LAUNCHES_FWD,
                       "k3": K.LAUNCHES_BWD, "all_reduces": reduces[0],
                       "want_all_reduces": DP_STEPS * (
                           P.sync_bn_collectives(model)[0] if sync else 1)}
        np.savez(os.path.join(out_dir, f"{tag}.rank{rank}.npz"),
                 **model_params(model))
    with open(os.path.join(out_dir, f"train.rank{rank}.json"), "w") as fh:
        json.dump(result, fh)


def dp_infer_rank(rank, out_dir, ckpt):
    """A rank of 5c: phase 5's 256 reads (written again from the same
    seed into this rank's own POD5 and BAM files) through
    ``infer_from_pod5_and_bam`` on cuda:0 in f32, K1's count set to 0
    first; rank 0 merges the parts into out_dir/merged.bam."""
    import torch

    from remora_tpu_torch.infer.infer import (ModelHandle,
                                              infer_from_pod5_and_bam)
    from remora_tpu_torch.kernels import lstm as K
    from remora_tpu_torch.parallel import mesh as P

    os.environ["REMORA_TPU_BAM_INDEX_CACHE"] = "0"
    os.environ["LOG_SAFE"] = "1"
    table, center = synth_level_table()
    own = os.path.join(out_dir, f"rank{rank}")
    os.makedirs(own)
    pod5_path, bam_path = write_stream_set(own, "stream", STREAM_READS,
                                           table, center)
    handle = ModelHandle.load(ckpt, device=torch.device("cuda", 0))
    K.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = infer_from_pod5_and_bam(
        pod5_path, bam_path, [handle], os.path.join(out_dir, "merged.bam"),
        batch_size=BATCH, mesh=P.make_mesh(torch.device("cuda", 0)))
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"infer.rank{rank}.json"), "w") as fh:
        json.dump({"n": n, "k1": K.LAUNCHES, "wall_s": wall}, fh)


def dp_rank_main(argv):
    """``chip_smoke.py --dp-rank KIND RANK PORT DIR CKPT``: one rank of
    6f(b) (KIND train) or 5c (KIND infer) over gloo on cuda:0."""
    from remora_tpu_torch.parallel import mesh as P

    kind, rank, port, out_dir, ckpt = argv
    rank = int(rank)
    P.init_multihost(f"127.0.0.1:{port}", DP_WORLD, rank, backend="gloo",
                     device="cuda:0", timeout_s=120)
    try:
        (dp_train_rank if kind == "train" else dp_infer_rank)(
            rank, out_dir, ckpt)
    finally:
        P.teardown()
    return 0


def spawn_dp_ranks(kind, out_dir, ckpt):
    """DP_WORLD ranks of ``dp_rank_main``; a rank that fails or a run past
    DP_RANK_TIMEOUT_S fails the phase. Returns (wall s, the ranks'
    JSON results)."""
    import gc

    import torch

    from remora_tpu_torch.parallel import mesh as P

    # the ranks share this card: hand back what this process's allocator
    # caches from the phases before
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"{kind} ranks: {free / 2**30:.1f} of {total / 2**30:.1f} GiB free on "
        "the card before they start")
    check(free >= 8 * 2**30, f"{kind} ranks: {free / 2**30:.1f} GiB free on "
          "the card, 8 wanted")
    port = P.free_port()
    t0 = time.monotonic()
    try:
        P.spawn_ranks(
            lambda r: [sys.executable, os.path.join(REPO, "chip_smoke.py"),
                       "--dp-rank", kind, str(r), str(port), out_dir, ckpt],
            DP_WORLD, DP_RANK_TIMEOUT_S, env=dict(os.environ), cwd=REPO)
    except Exception as err:  # noqa: BLE001 — the phase fails with it
        raise SmokeFailure(f"{kind} ranks: {err}") from err
    wall = time.monotonic() - t0
    results = []
    for r in range(DP_WORLD):
        with open(os.path.join(out_dir, f"{kind}.rank{r}.json")) as fh:
            results.append(json.load(fh))
    return wall, results


def params_rel_err(got, want):
    """The largest |got - want| of a leaf over that leaf's largest |want|."""
    return max(float(np.abs(got[k] - want[k]).max())
               / max(float(np.abs(want[k]).max()), 1e-30) for k in want)


def params_moved_err(got, want, init):
    """||got - want|| over ||want - init||, every leaf in one vector: the
    error over the change that the steps made."""
    def norm(f):
        return math.sqrt(sum(float(np.square(f(k), dtype=np.float64).sum())
                             for k in want))

    return (norm(lambda k: got[k] - want[k])
            / max(norm(lambda k: want[k] - init[k]), 1e-30))


def dp_nccl_leg(root, config, smi):
    """6f(a): ``train_model`` with a mesh of one NCCL rank on cuda:0,
    DP_STEPS steps of BATCH (SGD), the launch and all-reduce counts set to
    0 first: K2/K3 once a step, one all-reduce a step, the losses within
    1e-5 of the same run without a mesh. Returns (K2, K3) launches and
    rates."""
    import torch

    from remora_tpu_torch.kernels import lstm as K
    from remora_tpu_torch.parallel import mesh as P
    from remora_tpu_torch.train import optim
    from remora_tpu_torch.train.train import train_model

    losses, rates = {}, {}
    for tag in ("plain", "nccl"):
        out = os.path.join(root, f"dp_{tag}")
        mesh = None
        if tag == "nccl":
            P.init_multihost(device=torch.device("cuda", 0))
            mesh = P.make_mesh(torch.device("cuda", 0))
            check(mesh.backend == "nccl" and mesh.world == 1,
                  f"6f(a): a group of {mesh.world} over {mesh.backend}")
            spent = timed_all_reduce(mesh)
        K.LAUNCHES_FWD = K.LAUNCHES_BWD = 0
        t0 = time.monotonic()
        try:
            with P.count_calls() as reduces:
                train_model(
                    seed=1, out_path=out, remora_dataset_path=config,
                    chunk_context=None, kmer_context_bases=None,
                    batch_size=BATCH, model_name="ConvLSTM_w_ref",
                    size=SIZE,
                    train_opts=optim.TrainOpts(
                        epochs=1, optimizer_str="sgd", learning_rate=DP_LR,
                        lr_scheduler_str="constant"),
                    chunks_per_epoch=DP_STEPS * BATCH, num_test_chunks=BATCH,
                    mesh=mesh,
                )
        finally:
            if mesh is not None:
                P.teardown()
        wall = time.monotonic() - t0
        launches = (K.LAUNCHES_FWD, K.LAUNCHES_BWD)
        with open(os.path.join(out, "batch.log")) as fh:
            losses[tag] = np.array([float(line.split()[1])
                                    for line in fh.readlines()[1:]])
        log(f"6f(a) train_model {tag}: {DP_STEPS} steps in {wall:.1f} s "
            f"(with validation and checkpoints); K2/K3 launches {launches}; "
            f"all-reduces {reduces[0]}; losses {losses[tag].tolist()}")
        check(launches == (DP_STEPS, DP_STEPS),
              f"6f(a) {tag}: K2/K3 launched {launches} times for "
              f"{DP_STEPS} steps")
        if tag == "nccl":
            check(reduces[0] == DP_STEPS, f"6f(a): {reduces[0]} all-reduces "
                  f"in {DP_STEPS} steps")
            rates["dp_nccl1_all_reduce_ms_per_step"] = (
                spent[0] / DP_STEPS * 1e3)
            rates["dp_nccl1_train_s"] = wall
    diff = float(np.abs(losses["nccl"] - losses["plain"]).max())
    log(f"6f(a) NCCL group of one vs no mesh: max |loss delta| {diff:.3g} "
        f"(tolerance 1e-5); all-reduce "
        f"{rates['dp_nccl1_all_reduce_ms_per_step']:.3f} ms a step [{smi}]")
    check(losses["nccl"].size == DP_STEPS and diff <= 1e-5,
          f"6f(a): losses {losses}")
    return launches, rates


def dp_gloo_leg(root, ckpt, smi):
    """6f(b): two ranks sharing cuda:0 over gloo, BATCH / 2 rows each,
    DP_STEPS steps without and with sync_bn: the ranks' parameters
    identical, one all-reduce a step without sync_bn (sync_bn's stated
    count with it), K2/K3 once a step on each rank, and the sync_bn
    parameters within 1e-4 relative of one process stepping on the whole
    batches; over the steps' change, sync_bn's within DP_MOVED_TOL of that
    run and per-rank BatchNorm's (the control) beyond it. Returns (K2, K3)
    launches over both ranks and rates."""
    from remora_tpu_torch.train.train import make_train_step_raw

    out_dir = os.path.join(root, "dp_gloo")
    os.makedirs(out_dir)
    wall, results = spawn_dp_ranks("train", out_dir, ckpt)
    gloo_cuda = results[0]["gloo_cuda"]
    log(f"6f(b) {DP_WORLD} gloo ranks on cuda:0: {wall:.1f} s with start-up; "
        f"this torch's gloo takes CUDA tensors: {gloo_cuda}")
    check(gloo_cuda == {"all_reduce": True, "all_gather": True},
          "6f(b): gloo refuses CUDA tensors, which the mesh hands it")
    launches = [0, 0]
    rates = {}
    params = {}
    for tag in ("local", "sync"):
        params[tag] = [dict(np.load(os.path.join(out_dir,
                                                 f"{tag}.rank{r}.npz")))
                       for r in range(DP_WORLD)]
        for r, res in enumerate(results):
            got = res[tag]
            step_ms = statistics.median(got["walls_s"]) * 1e3
            share = got["all_reduce_s"] / sum(got["walls_s"])
            log(f"6f(b) {tag} rank {r}: losses {got['losses']}; step wall "
                f"median {step_ms:.2f} ms, all-reduces {got['all_reduces']} "
                f"({share:.1%} of the steps' wall); K2/K3 launches "
                f"({got['k2']}, {got['k3']}) [{smi}]")
            check((got["k2"], got["k3"]) == (DP_STEPS, DP_STEPS),
                  f"6f(b) {tag} rank {r}: K2/K3 launched "
                  f"({got['k2']}, {got['k3']}) times for {DP_STEPS} steps")
            check(got["all_reduces"] == got["want_all_reduces"],
                  f"6f(b) {tag} rank {r}: {got['all_reduces']} all-reduces, "
                  f"{got['want_all_reduces']} stated")
            launches[0] += got["k2"]
            launches[1] += got["k3"]
            if r == 0:
                rates[f"dp_gloo_{tag}_step_ms"] = step_ms
                rates[f"dp_gloo_{tag}_all_reduce_share"] = share
        a, b = params[tag]
        check(a.keys() == b.keys()
              and all(np.array_equal(a[k], b[k]) for k in a),
              f"6f(b) {tag}: the ranks' parameters differ")
    # one process on the whole batches, the same steps
    model, opt, featurize = dp_model(ckpt)
    init = model_params(model)
    step = make_train_step_raw(model, opt, *featurize)
    losses, _walls = dp_steps(step, 0, BATCH)
    want = model_params(model)
    err = params_rel_err(params["sync"][0], want)
    # the control: per-rank BatchNorm (the local leg) against the same
    # one-process run, each error over the parameters' change in the
    # DP_STEPS steps, so that the check tells the two apart
    moved = {tag: params_moved_err(params[tag][0], want, init)
             for tag in ("sync", "local")}
    log(f"6f(b) sync_bn vs one process on the {BATCH}-row batches: losses "
        f"{results[0]['sync']['losses']} / {losses}; parameters max "
        f"relative error {err:.3g} (tolerance 1e-4); over the parameters' "
        f"change in {DP_STEPS} steps: sync_bn {moved['sync']:.3g} "
        f"(tolerance {DP_MOVED_TOL:g}), per-rank BatchNorm "
        f"{moved['local']:.3g} (must exceed it)")
    check(err <= 1e-4, f"6f(b): sync_bn parameters {err:.3g} from one "
          "process")
    check(moved["sync"] <= DP_MOVED_TOL,
          f"6f(b): sync_bn parameters {moved['sync']:.3g} of their change "
          "from one process")
    check(moved["local"] > DP_MOVED_TOL,
          f"6f(b): per-rank BatchNorm only {moved['local']:.3g} of the "
          "change from one process: the check cannot tell it from sync_bn")
    check(np.abs(np.subtract(results[0]["sync"]["losses"], losses)).max()
          <= 1e-4, "6f(b): sync_bn losses differ from one process")
    rates["dp_gloo_phase_s"] = wall
    return tuple(launches), rates


def dp_infer_phase(root, ckpt, smi, sets):
    """5c: two ranks over gloo on cuda:0, 128 of phase 5's 256 reads each
    (f32, batch 2048): K1 once a batch on each rank, every rank reports
    every read, and the merged BAM holds every read with phase 5's f32
    tags. Returns (K1 launches over both ranks, rates)."""
    out_dir = os.path.join(root, "dp_infer")
    os.makedirs(out_dir)
    wall, results = spawn_dp_ranks("infer", out_dir, ckpt)
    merged = os.path.join(out_dir, "merged.bam")
    tags = bam_tags(merged)
    want = sets["stream_f32_tags"]
    check(tags.keys() == want.keys(), f"5c: {len(tags)} records merged, "
          f"{len(want)} in phase 5's run")
    mm, ml, worst = tag_diff(tags, want)
    check(mm == ml == 0, f"5c: tags differ from phase 5's f32 run: MM "
          f"{mm}, ML bytes {ml}")
    check(not [p for p in os.listdir(out_dir) if ".part" in p],
          "5c: rank parts left beside the merged BAM")
    ids = sorted({rid for rid, _flag, _start in tags})
    rates = {}
    for r, res in enumerate(results):
        stripe = set(ids[r::DP_WORLD])
        calls = sum(v.size for (rid, _f, _s), (_m, v) in tags.items()
                    if rid in stripe)
        n_batches = -(-calls // BATCH)
        log(f"5c rank {r}: {len(stripe)} reads, {calls} calls in "
            f"{res['wall_s']:.3f} s = {len(stripe) / res['wall_s']:.1f} "
            f"reads/s; K1 launches {res['k1']} for {n_batches} batches; "
            f"reports {res['n']} records [{smi}]")
        check(res["k1"] == n_batches, f"5c rank {r}: K1 launched "
              f"{res['k1']} times for {n_batches} batches")
        check(res["n"] == STREAM_READS, f"5c rank {r}: reports {res['n']} "
              f"records of {STREAM_READS}")
    slowest = max(res["wall_s"] for res in results)
    rates.update(dp_infer_reads_per_s=STREAM_READS / slowest,
                 dp_infer_phase_s=wall)
    log(f"5c: {STREAM_READS} reads over {DP_WORLD} ranks = "
        f"{STREAM_READS / slowest:.1f} reads/s (the slower rank's driver "
        f"wall); MM and ML identical to phase 5's f32 run; phase wall "
        f"{wall:.1f} s with start-up")
    return sum(res["k1"] for res in results), rates


def data_parallel(root, config, ckpt, smi, sets):
    """Phases 6f and 5c. Returns ({"k1", "k2", "k3"} launches, rates)."""
    t0 = time.monotonic()
    (a2, a3), rates = dp_nccl_leg(root, config, smi)
    (b2, b3), gloo_rates = dp_gloo_leg(root, ckpt, smi)
    rates.update(gloo_rates, dp_train_phase_s=time.monotonic() - t0)
    log(f"phase 6f wall {rates['dp_train_phase_s']:.1f} s")
    k1, infer_rates = dp_infer_phase(root, ckpt, smi, sets)
    rates.update(infer_rates)
    log(f"phase 5c wall {rates['dp_infer_phase_s']:.1f} s")
    return {"k1": k1, "k2": a2 + b2, "k3": a3 + b3}, rates


# ---------------- phase 8: the banded refinement DP (K4, K5) -------------

# benchmarks/synth_set.py::BASE_LVL: the normalized level of each base
BASE_LVL = {0: -1.2, 1: -0.4, 2: 0.4, 3: 1.2}
DP_READS, DP_BASES = 64, 4000  # one micro-batch (REFINE_DEVICE_READ_BATCH)
DP_SMALL_READS, DP_SMALL_BASES = 8, 400
DP_HBW = 5  # DEFAULT_REFINE_HBW
STAGE_READS = 256
STAGE_CHUNK_CONTEXT, STAGE_KMER_CONTEXT = (200, 200), (4, 4)
STAGE_MAX_SEQ_LEN = 400 // 5  # prepare's chunk width // min samples/base
STAGE_MAX_CHUNKS = 100_000  # above every read's site count: no RNG draw
# dependent latency of one stay-fold step on the card, in SM cycles: the
# staged path's (W <= 128, banded_dp.cu::fold_rows) chain cs -> FADD (stay =
# cs + base) -> FMNMX (cs = fminf(cand, stay)), 4 + 4 cycles of Hopper's
# FMA-pipe latency; the code's select runs beside it. (The block path, W >
# 128, selects the score: FADD -> FSETP -> FSEL, 12 cycles.)
FOLD_STEP_CYCLES = 8
# a stay-only row (dwell_penalty's past-band suffix): one dependent FADD
STAY_STEP_CYCLES = 4
# dependent latency of one K5 walk step at its floor, in SM cycles: one
# dependent shared-memory load (LDS_CYCLES: 23.00 cycles for u32 and s16
# words, the pointer chase of ``chip_dp_variants.py --traceback`` on an
# H100 80GB HBM3 at 700 W) and the one dependent add that turns the loaded
# step into the next index (4 cycles, the pipe latency above)
LDS_CYCLES = 23
TB_STEP_CYCLES = LDS_CYCLES + 4
# K5 held bit for bit to its plain version on rows no DP wrote: (W, reads,
# bases) at three shapes of its ring (banded_dp.cu::tb_ring: 8 stages of
# 256 rows, 3 of 128, 3 of 4), each walk long enough to wrap the ring
TB_ROW_CASES = ((8, 8, 2500), (128, 8, 700), (4096, 4, 40))


def synth_read(rng, n_bases, levels_of=None):
    """``benchmarks/synth_set.py::synth_read``: random bases, dwells of 4 to
    11 samples, level + N(0, 0.1) noise, int16 DACs at shift 90, scale 20.
    ``levels_of`` maps the bases to their levels (default ``BASE_LVL``)."""
    int_seq = rng.integers(0, 4, n_bases)
    return (int_seq, *strand_signal(rng, int_seq, levels_of))


def strand_signal(rng, int_seq, levels_of=None):
    """(s2s, int16 DACs) of ``synth_read``'s recipe for given bases."""
    if levels_of is None:
        levels = np.array([BASE_LVL[int(b)] for b in int_seq])
    else:
        levels = levels_of(int_seq)
    dwells = rng.integers(4, 12, int_seq.size)
    s2s = np.concatenate([[0], np.cumsum(dwells)])
    norm = np.repeat(levels, dwells) + rng.normal(0, 0.1, s2s[-1])
    dacs = np.clip(norm * 20 + 90, -500, 3000).astype(np.int16)
    return s2s, dacs


def dp_reads(seed, n_reads, n_bases):
    """(normalized signal f32, levels f32, refiner band) per synthetic read,
    the band built as the refiner builds it (half-width 5, min step 2)."""
    from remora_tpu_torch.refine.refiner import _banded_search_space

    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n_reads):
        int_seq, s2s, dacs = synth_read(rng, n_bases)
        levels = np.array([BASE_LVL[int(b)] for b in int_seq], np.float32)
        sig = ((dacs - 90.0) / 20.0).astype(np.float32)
        band = _banded_search_space(s2s, levels, sig.size, DP_HBW, 2)
        reads.append((sig, levels, band))
    return reads


def width_bucket(reads):
    """The refiner's pow-2 band-width bucket of a launch of ``reads``."""
    w = max(16, max(int((bd[1] - bd[0]).max()) for _s, _l, bd in reads))
    return 1 << (w - 1).bit_length()


def dp_tensors(reads, w_bucket, device):
    import torch

    from remora_tpu_torch.kernels import banded_dp as K

    packed = K.pad_reads_for_dp(reads, w_max=w_bucket)
    return [torch.from_numpy(packed[k]).to(device)
            for k in ("signal", "levels", "band_starts", "band_widths",
                      "seq_lens")]


def dp_chain_cycles(starts, widths, n_dwell, dwell):
    """K4's serial chain for the read that needs the longest, in SM cycles:
    every base's folded rows at ``FOLD_STEP_CYCLES``; in dwell_penalty
    mode also the second fold's past-band suffix, rows p0c .. w-1 with p0c
    = max(previous width - bsd + L, 1), at ``STAY_STEP_CYCLES`` (rows below
    p0c take their candidate whatever the carry, so they chain nothing).
    Returns (cycles, folded rows, suffix rows) of that read."""
    st = starts.cpu().numpy().astype(np.int64)
    wd = widths.cpu().numpy().astype(np.int64)
    folded = wd.sum(1)
    suffix = np.zeros_like(folded)
    if dwell:
        # the first base's carry is spoofed: bsd = 1, previous width w[0]
        prev_w = np.concatenate([wd[:, :1], wd[:, :-1]], 1)
        bsd = np.diff(st, axis=1, prepend=st[:, :1] - 1)
        p0c = np.maximum(prev_w - bsd + n_dwell, 1)
        suffix = np.maximum(wd - p0c, 0).sum(1)
    cycles = folded * FOLD_STEP_CYCLES + suffix * STAY_STEP_CYCLES
    r = int(cycles.argmax())
    return int(cycles[r]), int(folded[r]), int(suffix[r])


def tb_row_case(seed, R, N, W, kind, device):
    """K5 inputs that no DP wrote: ``codes`` entries -1 .. W + 3 (a DP's
    codes, and steps wider than the band), ``wild`` the whole int16 range
    (negative steps, paths far off the band); band starts rising 0 to 6
    samples a base from anywhere in -50 .. 50, widths 1 .. W; seq_lens 1,
    N and between."""
    import torch

    rng = np.random.default_rng(seed)
    if kind == "codes":
        tb = rng.integers(-1, W + 4, (R, N, W))
    else:
        tb = rng.integers(-2 ** 15, 2 ** 15, (R, N, W))
    starts = (rng.integers(-50, 50, (R, 1))
              + np.cumsum(rng.integers(0, 7, (R, N)), 1))
    widths = rng.integers(1, W + 1, (R, N))
    seq_lens = rng.integers(1, N + 1, R)
    seq_lens[:2] = 1, N
    return [torch.from_numpy(a.astype(dt)).to(device) for a, dt in (
        (tb, np.int16), (starts, np.int32), (widths, np.int32),
        (seq_lens, np.int32))]


def check_traceback_rows():
    """K5 against its plain version, bit for bit, on arbitrary rows at W =
    8, 128 and 4096 (``TB_ROW_CASES``)."""
    import torch

    from remora_tpu_torch.kernels import banded_dp as K

    cuda = torch.device("cuda")
    for W, R, N in TB_ROW_CASES:
        for kind in ("codes", "wild"):
            tb, st, wd, sl = tb_row_case(W + N, R, N, W, kind, cuda)
            path = K.dp_traceback(tb, st, wd, sl)
            want = K.dp_traceback_reference(tb, st, wd, sl)
            torch.cuda.synchronize()
            check(torch.equal(path, want),
                  f"K5 on arbitrary rows (W={W}, {kind}): "
                  f"{int((path != want).sum())} path entries differ from "
                  "the plain version")
    log(f"K5 on arbitrary rows (W, reads, bases: {TB_ROW_CASES}; DP codes "
        "and the whole int16 range; seq_lens 1 and N): paths equal to the "
        "plain version, bit for bit")


def max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()
    return float(out[0]) * 1e6


def check_banded_dp():
    """K4 and K5 against their plain versions on the card (8 reads of 400
    bases) and against the native host DP on one micro-batch (64 reads of
    4000 bases), both algorithms; their times and bounds. Returns the K4
    and K5 records of dwell_penalty, the default algorithm and so the main
    path's (Viterbi's numbers are logged)."""
    import torch

    from chip_dp_variants import build_block_path
    from remora_tpu_torch.io.native import banded_dp_path, get_lib
    from remora_tpu_torch.kernels import banded_dp as K
    from remora_tpu_torch.refine.refiner import DEFAULT_REFINE_SHORT_DWELL_PEN

    cuda = torch.device("cuda")
    check(get_lib() is not None, "the native host DP library failed to build")
    sdp_np = np.asarray(DEFAULT_REFINE_SHORT_DWELL_PEN, np.float32)
    sdp = torch.from_numpy(sdp_np).to(cuda)

    small = dp_reads(8, DP_SMALL_READS, DP_SMALL_BASES)
    w_small = width_bucket(small)
    log(f"banded DP, {DP_SMALL_READS} reads of {DP_SMALL_BASES} bases: "
        f"band-width bucket {w_small}")
    check(w_small == 128, f"small DP case buckets at W={w_small}, not 128")
    sig, lvl, st, wd, sl = dp_tensors(small, w_small, cuda)
    plain_ms, small_ms, plain_err = {}, {}, {}
    for algo in ("Viterbi", "dwell_penalty"):
        dwell = algo == "dwell_penalty"
        tb = K.dp_forward(sig, lvl, st, wd, sdp, dwell, w_small)
        tb_ref = K.dp_forward_reference(sig, lvl, st, wd, sdp, dwell, w_small)
        path = K.dp_traceback(tb, st, wd, sl)
        path_ref = K.dp_traceback_reference(tb_ref, st, wd, sl)
        torch.cuda.synchronize()
        check(torch.equal(tb, tb_ref),
              f"K4 {algo}: traceback rows differ from the plain version "
              f"({int((tb != tb_ref).sum())} of {tb.numel()})")
        check(torch.equal(path, path_ref),
              f"K5 {algo}: paths differ from the plain version")
        plain_err[algo] = (
            float((tb.int() - tb_ref.int()).abs().max()),
            float((path - path_ref).abs().max()),
        )
        small_ms[algo] = (
            time_ms(lambda: K.dp_forward(sig, lvl, st, wd, sdp, dwell,
                                         w_small)),
            time_ms(lambda: K.dp_traceback(tb, st, wd, sl)),
        )
        plain_ms[algo] = (
            time_ms(lambda: K.dp_forward_reference(sig, lvl, st, wd, sdp,
                                                   dwell, w_small),
                    n=3, calls=1),
            time_ms(lambda: K.dp_traceback_reference(tb, st, wd, sl), n=3,
                    calls=1),
        )
        log(f"  {algo}: K4/K5 equal to their plain versions (tb rows and "
            f"paths, bit for bit); kernel {small_ms[algo][0]:.4f} / "
            f"{small_ms[algo][1]:.4f} ms, plain {plain_ms[algo][0]:.1f} / "
            f"{plain_ms[algo][1]:.1f} ms")

    check_traceback_rows()

    batch = dp_reads(9, DP_READS, DP_BASES)
    w_main = width_bucket(batch)
    sig, lvl, st, wd, sl = dp_tensors(batch, w_main, cuda)
    R, N = lvl.shape
    # the parent design's kernel (the block path, forced at W = 128)
    block = build_block_path()
    for algo in ("Viterbi", "dwell_penalty"):
        dwell = algo == "dwell_penalty"
        path, tb, _ = K.banded_dp_batch(sig, lvl, st, wd, sl, sdp, algo=algo,
                                        w_max=w_main)
        got = path.cpu().numpy()
        t0 = time.perf_counter()
        native = [banded_dp_path(s, lv, bd, sdp_np, algo)
                  for s, lv, bd in batch]
        native_s = time.perf_counter() - t0
        diffs = sum(int((got[r, :lv.size + 1] != native[r]).sum())
                    for r, (_s, lv, _b) in enumerate(batch))
        check(diffs == 0,
              f"K4/K5 {algo}: {diffs} path entries differ from the native "
              "host DP")
        W = tb.shape[2]
        tb_block = torch.empty_like(tb)

        def parent():
            err = block.banded_dp_forward(
                sig.data_ptr(), lvl.data_ptr(), st.data_ptr(), wd.data_ptr(),
                sdp.data_ptr(), sdp.numel(), int(dwell), R, N, sig.shape[1],
                W, tb_block.data_ptr(), torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"K4 {algo} (block path): launch error {err}")

        parent()
        torch.cuda.synchronize()
        check(torch.equal(tb_block, tb),
              f"K4 {algo}: the block path's tb rows differ from the staged "
              "path's")
        # parent, change, change, parent on one card
        turns = [(name, time_ms(fn)) for name, fn in (
            ("parent", parent),
            ("change", lambda: K.dp_forward(sig, lvl, st, wd, sdp, dwell,
                                            W)),
            ("change", lambda: K.dp_forward(sig, lvl, st, wd, sdp, dwell,
                                            W)),
            ("parent", parent))]
        fwd_ms = statistics.mean(ms for name, ms in turns if name == "change")
        parent_ms = statistics.mean(ms for name, ms in turns
                                    if name == "parent")
        log(f"K4 {algo} at the micro-batch, parent design (block path) vs "
            f"this kernel (staged path), in turns: " + ", ".join(
                f"{name} {ms:.4f} ms" for name, ms in turns)
            + "; tb rows equal")
        tb_ms = time_ms(lambda: K.dp_traceback(tb, st, wd, sl))
        # K5's floor: the longest walk's dependent steps, or its bytes
        walked = sl.clamp(1, N).long() - 1
        tb_chain_ms = (int(walked.max()) * TB_STEP_CYCLES
                       / max_sm_clock_hz() * 1e3)
        # K4's floor: the serial fold chain of the read that needs longest
        cycles, rows, suffix = dp_chain_cycles(st, wd, sdp.numel(), dwell)
        chain_ms = cycles / max_sm_clock_hz() * 1e3
        fwd_bytes = (sig.numel() * 4 + 3 * R * N * 4 + sdp.numel() * 4
                     + tb.numel() * 2)
        fwd_bytes_ms = fwd_bytes / PEAK_BYTES_PER_S * 1e3
        # K5 needs one int16 of each base's row, the bands and the path;
        # it streams each walked base's whole row and start
        tb_bytes = R * N * 2 + 2 * R * N * 4 + R * 4 + path.numel() * 4
        tb_bytes_ms = tb_bytes / PEAK_BYTES_PER_S * 1e3
        streamed = (int(walked.sum()) * (W * 2 + 4) + 2 * R * 4
                    + path.numel() * 4)
        n_bases = sum(lv.size for _s, lv, _b in batch)
        log(f"banded DP {algo}, {R} reads of {DP_BASES} bases (bucket "
            f"W={W}): paths equal to the native host DP; K4 {fwd_ms:.4f} "
            f"ms, K5 {tb_ms:.4f} ms ({n_bases / ((fwd_ms + tb_ms) / 1e3):,.0f}"
            f" bases/s); native host DP {native_s * 1e3:.1f} ms on one core "
            f"({n_bases / native_s:,.0f} bases/s); K4 floor: serial chain "
            f"{rows} folded rows x {FOLD_STEP_CYCLES} cycles + {suffix} "
            f"suffix rows x {STAY_STEP_CYCLES} cycles = {chain_ms:.4f} ms, "
            f"bytes {fwd_bytes / 1e6:.2f} MB = "
            f"{fwd_bytes_ms:.4f} ms; K5 floor: serial chain "
            f"{int(walked.max())} walked bases x {TB_STEP_CYCLES} cycles = "
            f"{tb_chain_ms:.4f} ms, bytes {tb_bytes / 1e6:.3f} MB = "
            f"{tb_bytes_ms:.4f} ms; K5 streams {streamed / 1e6:.2f} MB = "
            f"{streamed / PEAK_BYTES_PER_S * 1e3:.4f} ms at "
            f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s")
        if not dwell:
            continue
        # ms and bound_ms at the micro-batch; plain_ms, ms_at_plain_shape
        # and max_abs_err (tb rows, paths) at the small shape
        shapes = {
            "shape": f"{R} reads x {DP_BASES} bases, W={W}, {algo}",
            "plain_shape": f"{DP_SMALL_READS} reads x {DP_SMALL_BASES} "
                           f"bases, W={w_small}, {algo}",
            "path_mismatches_vs_native": diffs,
        }
        records = [
            {"name": "banded_dp_forward", "route": "cuda",
             "source": "remora_tpu_torch/csrc/banded_dp.cu",
             "replaces": "remora_tpu/kernels/pallas_dp.py:240",
             "launches": None, "max_abs_err": plain_err[algo][0],
             "ms": fwd_ms, "parent_ms": parent_ms,
             "plain_ms": plain_ms[algo][0],
             "ms_at_plain_shape": small_ms[algo][0],
             "bound_ms": max(chain_ms, fwd_bytes_ms),
             "bound_by": "operations" if chain_ms >= fwd_bytes_ms
             else "bytes",
             "library_ms": None, **shapes},
            {"name": "banded_dp_traceback", "route": "cuda",
             "source": "remora_tpu_torch/csrc/banded_dp.cu",
             "replaces": "remora_tpu/kernels/pallas_dp.py:361",
             "launches": None, "max_abs_err": plain_err[algo][1],
             "ms": tb_ms, "plain_ms": plain_ms[algo][1],
             "ms_at_plain_shape": small_ms[algo][1],
             "bound_ms": max(tb_chain_ms, tb_bytes_ms),
             "bound_by": "operations" if tb_chain_ms >= tb_bytes_ms
             else "bytes",
             "library_ms": None, **shapes},
        ]
    return records


# ---------------- phase 8b: the refinement stage at full size ------------


def synth_level_table(kmer_len=9):
    """A 9-mer level table: ``BASE_LVL`` of the centre base plus a small
    deterministic term from its neighbours (weights falling with
    distance), indexed as the refiner indexes k-mers."""
    idx = np.arange(4 ** kmer_len)
    digits = np.stack([(idx // 4 ** (kmer_len - 1 - j)) % 4
                       for j in range(kmer_len)], 1)
    lvl = np.array([BASE_LVL[b] for b in range(4)])
    center = kmer_len // 2
    table = lvl[digits[:, center]].copy()
    for j in range(kmer_len):
        if j != center:
            table += 0.06 / abs(j - center) * lvl[digits[:, j]]
    return table.astype(np.float32), center


def stage_reads(seed, n_reads, table, center):
    """``RemoraRead``s of 4000 synthetic bases with per-base labels and CG
    focus bases; the signal follows the 9-mer table."""
    from remora_tpu_torch.core.seq import Motif
    from remora_tpu_torch.data.read import RemoraRead
    from remora_tpu_torch.refine.levels import extract_levels

    kmer_len = (table.size - 1).bit_length() // 2
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n_reads):
        int_seq, s2s, dacs = synth_read(
            rng, DP_BASES,
            lambda s: extract_levels(s, table, kmer_len, center))
        rd = RemoraRead(
            dacs=dacs, shift=88.0 + rng.normal(0, 1),
            scale=21.0 + rng.normal(0, 0.5), seq_to_sig_map=s2s,
            int_seq=int_seq, labels=rng.integers(0, 2, DP_BASES),
            read_id=f"synth-read-{i:05d}",
        )
        rd.set_motif_focus_bases([Motif("CG", 0)])
        reads.append(rd)
    return reads


def extract_stage_chunks(reads, errs):
    """prepare's per-read tail after refinement: the focus-base downsample,
    the read check and ``extract_chunks_batch``; returns the arrays of
    every read."""
    from remora_tpu_torch.core.seq import Motif
    from remora_tpu_torch.data.chunk_batch import extract_chunks_batch

    out = []
    for rd, err in zip(reads, errs):
        if err is not None:
            continue
        rd.downsample_focus_bases(STAGE_MAX_CHUNKS)
        rd.check()
        res = extract_chunks_batch(
            rd, STAGE_CHUNK_CONTEXT, STAGE_KMER_CONTEXT, STAGE_MAX_SEQ_LEN,
            motifs=[Motif("CG", 0)], check_chunks=True)
        if res is None:
            continue
        arrays, _n_long = res
        arrays["read_ids"] = np.full(arrays["labels"].size, rd.read_id,
                                     "<U36")
        out.append(arrays)
    return out


def write_stage_dataset(path, batches, refiner):
    from remora_tpu_torch.data.dataset import CoreDataset
    from remora_tpu_torch.data.metadata import DatasetMetadata

    n = sum(b["labels"].size for b in batches)
    md = DatasetMetadata(
        allocate_size=n, max_seq_len=STAGE_MAX_SEQ_LEN,
        mod_bases=["m"], mod_long_names=["5mC"],
        motif_sequences=["CG"], motif_offsets=[0],
        extra_arrays={
            "read_ids": ("<U36", "UUID of the source read"),
            "read_focus_bases": ("int64", "Focus base index"),
        },
        kmer_context_bases=STAGE_KMER_CONTEXT,
        chunk_context=STAGE_CHUNK_CONTEXT, sig_map_refiner=refiner,
    )
    ds = CoreDataset(path, mode="w", metadata=md)
    for arrays in batches:
        ds.write_batch(arrays)
    ds.flush()
    ds.write_metadata()
    return CoreDataset(path, infinite_iter=False)


@contextlib.contextmanager
def timed_dp_kernels(intervals):
    """Record a pair of CUDA events around every K4/K5 launch."""
    import torch

    from remora_tpu_torch.kernels import banded_dp as K

    kernels = K.dp_forward, K.dp_traceback

    def timed(fn):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            intervals.append((start, end))
            return out
        return run

    K.dp_forward, K.dp_traceback = (timed(fn) for fn in kernels)
    try:
        yield
    finally:
        K.dp_forward, K.dp_traceback = kernels


def micro_batch_busy_share(refiner, batch):
    """The K4/K5 busy and idle share of one micro-batch of
    ``refine_reads_batch``: CUDA events around each launch, against the
    host wall of the call."""
    import torch

    intervals = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_dp_kernels(intervals):
        refiner.refine_reads_batch(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy_s = sum(a.elapsed_time(b) for a, b in intervals) / 1e3
    log(f"  one micro-batch ({len(batch)} reads), CUDA events: K4/K5 busy "
        f"{busy_s * 1e3:.4f} ms of {wall * 1e3:.4f} ms wall "
        f"({busy_s / wall:.1%} busy, {1 - busy_s / wall:.1%} idle; "
        f"{len(intervals)} launches)")


def profile_micro_batch():
    """``chip_smoke.py --profile-refine``: one micro-batch of the refinement
    stage (the stage's first 64 reads, device backend) under
    torch.profiler, by kernel, against the median of 3 unprofiled walls. It
    runs in a process of its own: in the smoke run's process, after the
    earlier phases, the profiler recorded no device activity for this
    stage."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from remora_tpu_torch.constants import REFINE_DEVICE_READ_BATCH
    from remora_tpu_torch.refine import refiner as RF

    table, center = synth_level_table()
    refiner = RF.SigMapRefiner(
        _levels_array=table, center_idx=center, do_rough_rescale=True,
        scale_iters=0, backend="device")
    reads = stage_reads(10, REFINE_DEVICE_READ_BATCH, table, center)
    walls = []
    for _ in range(4):  # a warm-up, then 3 timed
        batch = [rd.copy() for rd in reads]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refiner.refine_reads_batch(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls[1:])
    batch = [rd.copy() for rd in reads]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        refiner.refine_reads_batch(batch)
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    if not rows:
        log("profile: the profiler recorded no device time (breakdown by "
            "kernel not measured)")
        return 0
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"profile of one micro-batch ({len(reads)} reads): device busy "
        f"{busy_s * 1e3:.4f} ms; unprofiled median wall {wall * 1e3:.4f} ms "
        f"({busy_s / wall:.1%} busy, {1 - busy_s / wall:.1%} idle)")
    for dev_us, key, count in rows[:6]:
        log(f"  {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
    return 0


def profile_micro_batch_apart():
    """Run ``profile_micro_batch`` in a child process and log its lines."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--profile-refine"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    for line in proc.stdout.splitlines():
        log(f"  {line}")
    check(proc.returncode == 0,
          f"the profiled micro-batch failed (rc {proc.returncode}):\n"
          f"{proc.stderr[-3000:]}")


def refine_stage(root):
    """256 reads through ``refine_reads_batch`` (device, micro-batches of
    64) and through the native backend, carried into two datasets that
    must be identical; K4/K5 launches as planned and no host reroute; a
    scale_iters=2 leg held to the same call on the CPU; first, one
    micro-batch's K4/K5 busy share and its kernel profile. Returns
    (launches, rates)."""
    import torch

    from remora_tpu_torch.constants import REFINE_DEVICE_READ_BATCH
    from remora_tpu_torch.kernels import banded_dp as K
    from remora_tpu_torch.refine import refiner as RF

    table, center = synth_level_table()
    device_refiner = RF.SigMapRefiner(
        _levels_array=table, center_idx=center, do_rough_rescale=True,
        scale_iters=0, backend="device")
    check(device_refiner.device.type == "cuda",
          f"device refiner on {device_refiner.device}")
    native_refiner = RF.SigMapRefiner(
        _levels_array=table, center_idx=center, do_rough_rescale=True,
        scale_iters=0, backend="native")
    reads = stage_reads(10, STAGE_READS, table, center)
    native_reads = [rd.copy() for rd in reads]
    n_bases = sum(rd.int_seq.size for rd in reads)
    micro = REFINE_DEVICE_READ_BATCH

    # warm-up on a copy: the kernels' first launch, the native library
    device_refiner.refine_reads_batch([rd.copy() for rd in reads[:micro]])
    torch.cuda.synchronize()
    micro_batch_busy_share(device_refiner,
                           [rd.copy() for rd in reads[:micro]])
    profile_micro_batch_apart()
    K.LAUNCHES_FWD = K.LAUNCHES_TB = 0
    RF.PLANNED_LAUNCHES = RF.HOST_ROUTED_READS = 0
    t0 = time.perf_counter()
    errs = []
    for i in range(0, len(reads), micro):
        errs.extend(device_refiner.refine_reads_batch(reads[i:i + micro]))
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    launches = (K.LAUNCHES_FWD, K.LAUNCHES_TB)
    planned, rerouted = RF.PLANNED_LAUNCHES, RF.HOST_ROUTED_READS
    log(f"refine stage, device: {len(reads)} reads ({n_bases} bases) in "
        f"{device_s:.3f} s = {len(reads) / device_s:,.1f} reads/s, "
        f"{n_bases / device_s:,.0f} bases/s; K4/K5 launches {launches}, "
        f"planned {planned}, reads routed to the host {rerouted}")
    check(launches == (planned, planned) and planned > 0,
          f"K4/K5 launched {launches} times, the refiner planned {planned}")
    check(rerouted == 0, f"{rerouted} reads were routed to the host DP")
    check(all(e is None for e in errs),
          f"{sum(e is not None for e in errs)} reads failed to refine")

    t0 = time.perf_counter()
    for rd in native_reads:
        rd.refine_signal_mapping(native_refiner)
    native_s = time.perf_counter() - t0
    log(f"refine stage, native: {len(reads)} reads in {native_s:.3f} s = "
        f"{len(reads) / native_s:,.1f} reads/s, {n_bases / native_s:,.0f} "
        "bases/s (one core)")

    dev_ds = write_stage_dataset(os.path.join(root, "device"),
                                 extract_stage_chunks(reads, errs),
                                 device_refiner)
    nat_ds = write_stage_dataset(os.path.join(root, "native"),
                                 extract_stage_chunks(native_reads,
                                                      [None] * len(reads)),
                                 native_refiner)
    log(f"refine stage datasets: device {dev_ds.size} chunks, native "
        f"{nat_ds.size} chunks")
    check(dev_ds.size == nat_ds.size > 0,
          f"device dataset holds {dev_ds.size} chunks, native {nat_ds.size}")
    for name in nat_ds.array_names:
        check(np.array_equal(getattr(dev_ds, name)[:dev_ds.size],
                             getattr(nat_ds, name)[:nat_ds.size]),
              f"refine stage: {name} differs between device and native")
    check(dev_ds.metadata.sig_map_refiner == device_refiner,
          "the dataset's refiner differs from the stage's")

    # scale_iters=2: the device normalizes in f32 on the card; held to the
    # same call on the CPU (the plain versions)
    legs = []
    for device in (None, "cpu"):
        refiner = RF.SigMapRefiner(
            _levels_array=table, center_idx=center, do_rough_rescale=True,
            scale_iters=2, backend="device", device=device)
        leg = [rd.copy() for rd in reads[:micro]]
        np.random.seed(11)
        t0 = time.perf_counter()
        leg_errs = refiner.refine_reads_batch(leg)
        legs.append((leg, leg_errs, time.perf_counter() - t0))
    (card, card_errs, card_s), (cpu, cpu_errs, cpu_s) = legs
    moved = sum(int((a.seq_to_sig_map != b.seq_to_sig_map).sum())
                for a, b in zip(card, cpu))
    scaled = sum(a.shift != b.shift or a.scale != b.scale
                 for a, b in zip(card, cpu))
    log(f"scale_iters=2, {micro} reads: card {card_s:.3f} s, CPU (plain "
        f"versions) {cpu_s:.3f} s; map entries that differ {moved}, reads "
        f"whose shift or scale differ {scaled}")
    check([e is None for e in card_errs] == [e is None for e in cpu_errs],
          "scale_iters=2: errors differ between the card and the CPU")
    check(moved == 0 and scaled == 0,
          "scale_iters=2: the card's refinement differs from the CPU's")

    rates = {
        "refine_device_reads_per_s": len(reads) / device_s,
        "refine_device_bases_per_s": n_bases / device_s,
        "refine_native_reads_per_s": len(reads) / native_s,
        "refine_native_bases_per_s": n_bases / native_s,
        "refine_reads": len(reads), "refine_bases_per_read": DP_BASES,
        "refine_chunks": int(dev_ds.size),
    }
    return launches, rates


# ---------------- phase 8c: the prepare driver at full size --------------

PREPARE_MAX_CHUNKS = 15  # max_chunks_per_read: every read draws its sites
# a read has at most one site a base, so no read draws; the driver
# allocates reads x this many rows (sparse files, but reads through a
# hole on tmpfs allocate pages)
PREPARE_ALL_SITES = STREAM_BASES
# the first reads of the set, for the worker-count and shuffle legs (host
# pipeline properties, held to the JAX package on the CPU by
# tests/test_torch_prepare.py); one micro-batch warms the device stage
PREPARE_SUBSET, PREPARE_WARM = 32, 64


def host_memory():
    """The host's memory: this process's resident set, what the machine
    has available, and what the temporary directory holds."""
    import shutil

    def fields(path, names):
        out = {}
        with open(path) as fh:
            for line in fh:
                key, _, rest = line.partition(":")
                if key in names:
                    out[key] = int(rest.split()[0]) / 2 ** 20
        return out

    rss = fields("/proc/self/status", ("VmRSS",)).get("VmRSS", 0)
    avail = fields("/proc/meminfo", ("MemAvailable",)).get("MemAvailable", 0)
    tmp = shutil.disk_usage(tempfile.gettempdir()).used / 2 ** 30
    return (f"RSS {rss:.1f} GiB, available {avail:.1f} GiB, temp dir "
            f"holds {tmp:.1f} GiB")


def prepare_leg(key, bam_path, out, refiner, tag, seed, max_chunks,
                workers=1, shuffle=False, intervals=None,
                n_reads=STREAM_READS):
    """One ``extract_chunk_dataset`` run over the first ``n_reads`` reads
    (CG sites of 5mC, chunk context (200, 200), 9-mer context, 5 samples
    a base) with the launch counts set to 0 and the NumPy RNG seeded
    first; returns (dataset, counts, wall seconds, skip tally)."""
    import torch

    from remora_tpu_torch.core.seq import Motif
    from remora_tpu_torch.kernels import banded_dp as DP
    from remora_tpu_torch.prepare import extract_chunk_dataset
    from remora_tpu_torch.refine import refiner as RF

    handler = _LogLines()
    logger = logging.getLogger("RemoraTPUTorch")
    logger.addHandler(handler)
    torch.cuda.synchronize()
    DP.LAUNCHES_FWD = DP.LAUNCHES_TB = 0
    RF.PLANNED_LAUNCHES = RF.HOST_ROUTED_READS = 0
    np.random.seed(seed)
    timed = (timed_dp_kernels(intervals) if intervals is not None
             else contextlib.nullcontext())
    t0 = time.perf_counter()
    try:
        with timed:
            dataset = extract_chunk_dataset(
                bam_path, key, out, ("m", "5mC"), False, [Motif("CG", 0)],
                None, STAGE_CHUNK_CONTEXT, 5, max_chunks, None, refiner,
                STAGE_KMER_CONTEXT, False, 0, n_reads,
                num_extract_chunks_workers=workers,
                skip_shuffle=not shuffle)
            torch.cuda.synchronize()
    finally:
        logger.removeHandler(handler)
    wall = time.perf_counter() - t0
    counts = {"k4": DP.LAUNCHES_FWD, "k5": DP.LAUNCHES_TB,
              "planned": RF.PLANNED_LAUNCHES,
              "host_routed": RF.HOST_ROUTED_READS}
    tally = skip_tally(handler.lines)
    log(f"  prepare {tag} skip tally: {tally}")
    log(f"prepare {tag}: {n_reads} reads of {STREAM_BASES} bases, "
        f"{dataset.size} chunks in {wall:.3f} s = "
        f"{n_reads / wall:.1f} reads/s, {dataset.size / wall:.1f} "
        f"chunks/s; K4/K5 launches ({counts['k4']}, {counts['k5']}), "
        f"planned {counts['planned']}, reads routed to the host "
        f"{counts['host_routed']}; {host_memory()}")
    return dataset, counts, wall, tally


def dataset_diff(got, want, sort=False):
    """Names of the arrays that differ between two datasets (each sorted
    by read id and focus base first when ``sort``), and whether their
    metadata files differ."""
    from remora_tpu_torch.data.dataset import CoreDataset

    def arrays(ds):
        ds = CoreDataset(ds.data_path, infinite_iter=False)
        out = {n: np.asarray(getattr(ds, n)[:ds.size])
               for n in ds.array_names}
        if sort:
            order = np.lexsort((out["read_focus_bases"], out["read_ids"]))
            out = {n: a[order] for n, a in out.items()}
        return out

    a, b = arrays(got), arrays(want)
    differ = [n for n in b if n not in a or a[n].dtype != b[n].dtype
              or not np.array_equal(a[n], b[n])]
    meta = [os.path.join(ds.data_path, "metadata.jsn") for ds in (got, want)]
    with open(meta[0], "rb") as fa, open(meta[1], "rb") as fb:
        same_meta = fa.read() == fb.read()
    return differ, same_meta


def prepare_stage(root, smi):
    """Phase 8c: ``extract_chunk_dataset`` over phase 5's 256 reads of 4000
    bases with phase 8b's 9-mer refiner (rough rescale, one DP round),
    after one micro-batch of warm-up. The device backend first (K4/K5 in
    micro-batches of 64, launched as the refiner planned, no read to the
    host; its busy share by CUDA events), then the native backend with
    one chunk worker: identical arrays and metadata, in order. At
    ``max_chunks_per_read`` 15 every read draws its sites from the NumPy
    RNG, and each forked worker starts from the parent's state, so the
    worker-count and shuffle comparisons run on the first
    ``PREPARE_SUBSET`` reads where no read draws (``PREPARE_ALL_SITES``):
    the device and native datasets shuffled under one seed are identical,
    and 4 native workers give the single worker's dataset once sorted by
    (read id, focus base). Returns (K4/K5 launches, rates)."""
    import torch

    from remora_tpu_torch.refine import refiner as RF

    os.environ["REMORA_TPU_BAM_INDEX_CACHE"] = "0"
    os.environ["LOG_SAFE"] = "1"
    log(f"prepare: {host_memory()}")
    table, center = synth_level_table()
    key, bam_path = write_stream_set(root, "prepare", STREAM_READS, table,
                                     center)

    def refiner(backend):
        return RF.SigMapRefiner(
            _levels_array=table, center_idx=center, do_rough_rescale=True,
            scale_iters=0, backend=backend)

    # no device named: the stage spreads over every visible GPU, here one
    devs = RF._refine_dp_devices(refiner("device").dp_device)
    check(devs == [torch.device("cuda", 0)],
          f"prepare: the device stage runs on {devs}, not the one card")
    prepare_leg(key, bam_path, os.path.join(root, "warm"),
                refiner("device"), "warm-up", 1, PREPARE_MAX_CHUNKS,
                n_reads=PREPARE_WARM)
    legs, launches, rates, intervals = {}, [0, 0], {}, []
    for tag, backend, max_chunks, workers, shuffle, seed, n_reads in (
            ("device", "device", PREPARE_MAX_CHUNKS, 1, False, 7,
             STREAM_READS),
            ("native", "native", PREPARE_MAX_CHUNKS, 1, False, 7,
             STREAM_READS),
            ("device all sites shuffled", "device", PREPARE_ALL_SITES, 1,
             True, 9, PREPARE_SUBSET),
            ("native all sites shuffled", "native", PREPARE_ALL_SITES, 1,
             True, 9, PREPARE_SUBSET),
            ("native all sites 4 workers", "native", PREPARE_ALL_SITES, 4,
             True, 9, PREPARE_SUBSET)):
        ds, counts, wall, tally = prepare_leg(
            key, bam_path, os.path.join(root, tag.replace(" ", "_")),
            refiner(backend), tag, seed, max_chunks, workers, shuffle,
            intervals if tag == "device" else None, n_reads)
        check(ds.size > 0, f"prepare {tag}: no chunks")
        if backend == "device":
            check(counts["k4"] == counts["k5"] == counts["planned"] > 0,
                  f"prepare {tag}: K4/K5 launched ({counts['k4']}, "
                  f"{counts['k5']}), the refiner planned "
                  f"{counts['planned']}")
            check(counts["host_routed"] == 0,
                  f"prepare {tag}: reads were routed to the host DP")
            launches[0] += counts["k4"]
            launches[1] += counts["k5"]
        else:
            check(counts["k4"] == counts["k5"] == 0,
                  f"prepare {tag}: K4/K5 launched")
        legs[tag] = (ds, tally)
        slug = tag.replace(" ", "_")
        rates[f"prepare_{slug}_reads_per_s"] = n_reads / wall
        rates[f"prepare_{slug}_chunks_per_s"] = ds.size / wall
        rates[f"prepare_{slug}_chunks"] = int(ds.size)
    dev_wall = STREAM_READS / rates["prepare_device_reads_per_s"]
    busy_s = sum(a.elapsed_time(b) for a, b in intervals) / 1e3
    log(f"prepare device: K4/K5 busy {busy_s * 1e3:.4f} ms of "
        f"{dev_wall * 1e3:.4f} ms wall ({busy_s / dev_wall:.1%} busy, "
        f"{1 - busy_s / dev_wall:.1%} idle; {len(intervals)} launches, "
        f"CUDA events) [{smi}]")
    rates["prepare_device_dp_busy_share"] = busy_s / dev_wall
    for got, want, sort in (
            ("device", "native", False),
            ("device all sites shuffled", "native all sites shuffled",
             False),
            ("native all sites 4 workers", "native all sites shuffled",
             True)):
        differ, same_meta = dataset_diff(legs[got][0], legs[want][0], sort)
        log(f"prepare {got} vs {want}{' (sorted)' if sort else ''}: "
            f"arrays that differ {differ}, metadata identical {same_meta}")
        check(not differ and same_meta and legs[got][1] == legs[want][1],
              f"prepare: {got} differs from {want}")
    rates.update(prepare_reads=STREAM_READS, prepare_bases=STREAM_BASES,
                 prepare_subset_reads=PREPARE_SUBSET,
                 prepare_max_chunks_per_read=PREPARE_MAX_CHUNKS)
    return tuple(launches), rates


# ---------------- phase 7: the command line ----------------------------

# (a) trains CLI_TRAIN_STEPS steps of phase 6's batch on its dataset; (d)
# takes the first DUPLEX_SMALL_PAIRS pairs of phase 5b's set; (e) the first
# PREPARE_SUBSET reads of phase 5's set, every CG site drawn
CLI_TRAIN_STEPS = 4
CLI_SUBPROCESS_S = 300  # the subprocess infer's limit


def cli_leg(argv, tag):
    """``remora_tpu_torch.cli.main.run(argv)`` in-process, with every
    launch count set to 0 first. Returns (counts, wall seconds, the log
    lines); a subcommand that raises fails the phase."""
    import torch

    from remora_tpu_torch.cli import main as cli_main
    from remora_tpu_torch.kernels import banded_dp as DP
    from remora_tpu_torch.kernels import lstm as K
    from remora_tpu_torch.refine import refiner as RF

    handler = _LogLines()
    logger = logging.getLogger("RemoraTPUTorch")
    logger.addHandler(handler)
    torch.cuda.synchronize()
    K.LAUNCHES = K.LAUNCHES_FWD = K.LAUNCHES_BWD = 0
    K.LAUNCHES_BWD_MMA.update(dict.fromkeys(K.LAUNCHES_BWD_MMA, 0))
    DP.LAUNCHES_FWD = DP.LAUNCHES_TB = 0
    RF.PLANNED_LAUNCHES = RF.HOST_ROUTED_READS = 0
    argv = [str(a) for a in argv]
    t0 = time.perf_counter()
    try:
        cli_main.run(argv)
        torch.cuda.synchronize()
    except Exception as err:
        raise SmokeFailure(f"cli {tag}: {' '.join(argv[:2])} raised "
                           f"{type(err).__name__}: {err}") from err
    finally:
        logger.removeHandler(handler)
    wall = time.perf_counter() - t0
    counts = {"k1": K.LAUNCHES, "k2": K.LAUNCHES_FWD, "k3": K.LAUNCHES_BWD,
              "k3_parts": dict(K.LAUNCHES_BWD_MMA), "k4": DP.LAUNCHES_FWD,
              "k5": DP.LAUNCHES_TB, "planned": RF.PLANNED_LAUNCHES,
              "host_routed": RF.HOST_ROUTED_READS}
    return counts, wall, handler.lines


def cli_subprocess_infer(root, path, pod5_path, bam_path, sets, rates, smi):
    """``python -m remora_tpu_torch infer from_pod5_and_bam`` as a user
    runs it, in a process of its own on the card (f32, batch 2048, the
    device stage's stats on): its tags must equal phase 5's in-process
    f32 run's, read by read, and its device stage's log line must count
    one K1 launch a batch. Returns those launches."""
    from remora_tpu_torch.parallel import mesh as P

    out = os.path.join(root, "cli_subprocess_f32.bam")
    argv = [sys.executable, "-m", "remora_tpu_torch", "infer",
            "from_pod5_and_bam", pod5_path, bam_path, "--model", path,
            "--out-bam", out, "--batch-size", str(BATCH)]
    env = dict(P.package_env(), REMORA_TPU_INFER_STAGE_STATS="1")
    t0 = time.perf_counter()
    try:
        (output,) = P.spawn_ranks(lambda _r: argv, 1, CLI_SUBPROCESS_S,
                                  env=env, cwd=root)
    except Exception as err:  # noqa: BLE001 — the phase fails with it
        raise SmokeFailure(f"cli subprocess infer: {err}") from err
    wall = time.perf_counter() - t0
    tags = bam_tags(out)
    n_calls = sum(ml.size for _mm, ml in tags.values())
    n_batches = -(-n_calls // BATCH)
    stage = re.findall(r"Device stage: (\d+) batches, K1 launches (\d+)",
                       output)
    k1 = int(stage[0][1]) if len(stage) == 1 else -1
    mm, ml, _w = tag_diff(tags, sets["stream_f32_tags"])
    log(f"cli subprocess python -m remora_tpu_torch infer "
        f"from_pod5_and_bam f32: {len(tags)} reads, {n_calls} calls in "
        f"{wall:.3f} s (the process's start, imports and model load in "
        f"it) = {len(tags) / wall:.1f} reads/s; device stage {stage}; vs "
        f"phase 5's f32 run: MM strings that differ {mm}, ML bytes that "
        f"differ {ml} [{smi}]")
    check(stage == [(str(n_batches), str(n_batches))],
          f"cli subprocess infer: the child's device stage logged "
          f"{stage} (batches, K1 launches) for {n_batches} batches")
    check(tags.keys() == sets["stream_f32_tags"].keys() and mm == ml == 0,
          "cli subprocess infer: tags differ from phase 5's f32 run")
    rates["cli_subprocess_infer_s"] = wall
    return k1


def write_level_file(path, table):
    """A k-mer level table as ``--refine-kmer-level-table`` reads it."""
    from remora_tpu_torch.refine.levels import all_kmers

    kmer_len = (table.size - 1).bit_length() // 2
    with open(path, "w") as fh:
        fh.writelines(f"{kmer}\t{level!r}\n" for kmer, level in
                      zip(all_kmers(kmer_len), table.tolist()))
    return path


def write_cg_bed(path, bam_path):
    """A ground-truth BED of every CG site of a forward-read BAM's
    records: 5mC on every other read, C on the rest."""
    from remora_tpu_torch.io.bam import FastBamScanner

    with open(path, "w") as fh:
        for i, rec in enumerate(FastBamScanner(bam_path)):
            mod = "m" if i % 2 == 0 else "C"
            seq = rec.query_sequence
            for pos in (m.start() for m in re.finditer("CG", seq)):
                start = rec.reference_start + pos
                fh.write(f"{rec.reference_name}\t{start}\t{start + 1}\t"
                         f"{mod}\t0\t+\n")
    return path


def cli_phase(root, sets, smi):
    """Phase 7: the port's command line in-process on the card at full
    width (ConvLSTM_w_ref size 64, 9-mer, chunk context (200, 200), batch
    2048), on the checkpoint, reads and datasets of phases 4, 5, 5b, 6 and
    8b (``sets``), the launch counts set to 0 before each subcommand:
    (a) ``model train`` f32 then ``--bf16`` (K2/K3 once a step); (b)
    ``model export`` dorado and torchscript; (c) ``infer
    from_pod5_and_bam`` with the npz in f32 (tags equal to phase 5's
    driver run), the exported ``.pt`` in f32 (tags equal to the npz's)
    and the npz under ``--bf16`` (MM equal, ML within 1), K1 once a
    batch, and phase 5's refining checkpoint through the device refiner
    (K4/K5 as planned, tags equal to phase 5's); (d) ``infer
    duplex_from_pod5_and_bam`` on the first pairs (K1 once a strand call,
    tags equal to phase 5b's f32 run); (e) ``dataset
    prepare --refine-backend device`` with phase 8b's level table on the
    first reads (K4/K5 as planned, no read to the host) against
    ``--refine-backend native``; (f) ``validate from_remora_dataset`` on
    (e)'s dataset (K1 once a batch) and ``validate from_modbams`` on
    (c)'s BAM against a BED of its CG sites. Returns (launches, rates)."""
    from remora_tpu_torch.data.dataset import CoreDataset
    from remora_tpu_torch.models import model_io

    path, pod5_path, bam_path = (sets[k] for k in ("ckpt", "pod5", "bam"))
    rates, launches = {}, {"k1_f32": 0, "k1_bf16": 0, "k2_f32": 0,
                           "k3_f32": 0, "k2_bf16": 0, "k3_bf16": 0,
                           "k4": 0, "k5": 0}

    # (a) model train, one epoch of CLI_TRAIN_STEPS steps a leg
    for dtype, flags in (("f32", []), ("bf16", ["--bf16"])):
        out = os.path.join(root, f"cli_train_{dtype}")
        counts, wall, _ = cli_leg(
            ["model", "train", sets["train_config"], "--output-path", out,
             "--size", SIZE, "--batch-size", BATCH, "--epochs", 1,
             "--chunks-per-epoch", CLI_TRAIN_STEPS * BATCH,
             "--num-test-chunks", BATCH, "--scheduler", "constant",
             "--lr", 2e-3, "--seed", 1, *flags], f"train {dtype}")
        with open(os.path.join(out, "batch.log")) as fh:
            losses = [float(line.split()[1]) for line in fh.readlines()[1:]]
        log(f"cli model train {dtype}: {CLI_TRAIN_STEPS} steps of {BATCH} "
            f"in {wall:.3f} s (with validation and checkpoints) = "
            f"{CLI_TRAIN_STEPS * BATCH / wall:.1f} chunks/s; K2/K3 "
            f"launches ({counts['k2']}, {counts['k3']}), K3 bf16 parts "
            f"{counts['k3_parts']}; losses {losses} [{smi}]")
        check((counts["k2"], counts["k3"]) == (CLI_TRAIN_STEPS,) * 2,
              f"cli train {dtype}: K2/K3 launched ({counts['k2']}, "
              f"{counts['k3']}) times for {CLI_TRAIN_STEPS} steps")
        want_parts = CLI_TRAIN_STEPS if dtype == "bf16" else 0
        check(counts["k3_parts"] == dict.fromkeys(counts["k3_parts"],
                                                  want_parts),
              f"cli train {dtype}: K3 bf16 parts {counts['k3_parts']}")
        check(len(losses) == CLI_TRAIN_STEPS and np.isfinite(losses).all(),
              f"cli train {dtype}: batch.log losses {losses}")
        for name in ("model_final.checkpoint", "validation.log",
                     "epoch_summary.txt"):
            check(os.path.isfile(os.path.join(out, name)),
                  f"cli train {dtype}: {name} not written")
        launches[f"k2_{dtype}"] += counts["k2"]
        launches[f"k3_{dtype}"] += counts["k3"]
        rates[f"cli_train_{dtype}_s"] = wall

    # (b) model export, both formats
    dorado = os.path.join(root, "cli_dorado")
    pt_path = os.path.join(root, "cli_model.pt")
    for fmt, dest in (("dorado", dorado), ("torchscript", pt_path)):
        _c, wall, _ = cli_leg(["model", "export", path, dest, "--format",
                               fmt], f"export {fmt}")
        rates[f"cli_export_{fmt}_s"] = wall
        log(f"cli model export {fmt}: {wall:.3f} s")
    names = sorted(os.listdir(dorado))
    check(len(names) == 23 and "config.toml" in names,
          f"cli export dorado: {len(names)} files {names}")
    model, meta = model_io.load_torchscript_model(pt_path)
    ref, _meta = model_io.load_model(path)
    check(all(np.array_equal(v.numpy(), ref.state_dict()[k].numpy())
              for k, v in model.state_dict().items()),
          "cli export torchscript: the .pt's weights differ from the npz's")

    # (c) infer from_pod5_and_bam: npz f32, .pt f32, npz bf16
    results = {}
    for tag, model_file, flags in (("f32", path, []),
                                   ("pt_f32", pt_path, []),
                                   ("bf16", path, ["--bf16"])):
        out = os.path.join(root, f"cli_infer_{tag}.bam")
        counts, wall, _ = cli_leg(
            ["infer", "from_pod5_and_bam", pod5_path, bam_path, "--model",
             model_file, "--out-bam", out, "--batch-size", BATCH, *flags],
            f"infer {tag}")
        tags = results[tag] = bam_tags(out)
        n_calls = sum(ml.size for _mm, ml in tags.values())
        n_batches = -(-n_calls // BATCH)
        log(f"cli infer from_pod5_and_bam {tag}: {len(tags)} of "
            f"{STREAM_READS} reads, {n_calls} calls in {wall:.3f} s = "
            f"{STREAM_READS / wall:.1f} reads/s, {n_calls / wall:.1f} "
            f"chunks/s; K1 launches {counts['k1']} for {n_batches} batches "
            f"of {BATCH} [{smi}]")
        check(len(tags) == STREAM_READS, f"cli infer {tag}: {len(tags)} "
              f"reads written of {STREAM_READS}")
        check(counts["k1"] == n_batches, f"cli infer {tag}: K1 launched "
              f"{counts['k1']} times for {n_batches} batches")
        launches["k1_bf16" if tag == "bf16" else "k1_f32"] += counts["k1"]
        rates[f"cli_infer_{tag}_reads_per_s"] = STREAM_READS / wall
        rates[f"cli_infer_{tag}_chunks_per_s"] = n_calls / wall
    for got, want, what in (("f32", "phase5_f32", "phase 5's driver run"),
                            ("pt_f32", "f32", "the npz's")):
        want_tags = sets["stream_f32_tags"] if want == "phase5_f32" else (
            results[want])
        mm, ml, worst = tag_diff(results[got], want_tags)
        log(f"cli infer {got} vs {what}: MM strings that differ {mm}, ML "
            f"bytes that differ {ml}")
        check(results[got].keys() == want_tags.keys() and mm == ml == 0,
              f"cli infer {got}: tags differ from {what}")
    mm, ml, worst = tag_diff(results["bf16"], results["f32"])
    log(f"cli infer bf16 vs f32: MM strings that differ {mm}, ML bytes "
        f"that differ {ml}, max |delta| {worst} (tolerance 1)")
    check(mm == 0 and worst <= 1, "cli infer bf16: MM differs or ML moved "
          "by more than 1 from f32")
    check(ml > 0, "cli infer bf16: ML equals f32's byte for byte (the "
          "bf16 forward did not run)")
    launches["k1_f32"] += cli_subprocess_infer(root, path, pod5_path,
                                               bam_path, sets, rates, smi)
    # phase 5's refining checkpoint through the device refiner (K4/K5)
    out = os.path.join(root, "cli_infer_refine.bam")
    counts, wall, _ = cli_leg(
        ["infer", "from_pod5_and_bam", pod5_path, bam_path, "--model",
         sets["refine_ckpt"], "--out-bam", out, "--batch-size", BATCH,
         "--refine-backend", "device"], "infer refine")
    tags = bam_tags(out)
    mm, ml, _w = tag_diff(tags, sets["stream_refine_tags"])
    log(f"cli infer from_pod5_and_bam refine device: {len(tags)} reads in "
        f"{wall:.3f} s = {STREAM_READS / wall:.1f} reads/s; K1 "
        f"{counts['k1']}, K4/K5 launches ({counts['k4']}, {counts['k5']}), "
        f"planned {counts['planned']}, reads routed to the host "
        f"{counts['host_routed']}; vs phase 5's device-refiner run: MM "
        f"strings that differ {mm}, ML bytes that differ {ml}")
    check(counts["k4"] == counts["k5"] == counts["planned"] > 0,
          f"cli infer refine: K4/K5 launched ({counts['k4']}, "
          f"{counts['k5']}), the refiner planned {counts['planned']}")
    check(counts["host_routed"] == 0,
          "cli infer refine: reads were routed to the host DP")
    check(tags.keys() == sets["stream_refine_tags"].keys() and mm == ml == 0,
          "cli infer refine: tags differ from phase 5's device-refiner run")
    launches["k1_f32"] += counts["k1"]
    launches["k4"] += counts["k4"]
    launches["k5"] += counts["k5"]
    rates["cli_infer_refine_reads_per_s"] = STREAM_READS / wall

    # (d) infer duplex_from_pod5_and_bam on the first pairs
    out = os.path.join(root, "cli_duplex.bam")
    counts, wall, _ = cli_leg(
        ["infer", "duplex_from_pod5_and_bam", sets["duplex_pod5"],
         *sets["duplex_paths"], "--model", path, "--out-bam", out,
         "--num-reads", DUPLEX_SMALL_PAIRS], "duplex")
    tags = bam_tags(out, by_name=True)
    log(f"cli infer duplex_from_pod5_and_bam: {len(tags)} pairs of "
        f"{DUPLEX_SMALL_PAIRS} in {wall:.3f} s = {len(tags) / wall:.2f} "
        f"pairs/s; K1 launches {counts['k1']} [{smi}]")
    check(len(tags) == DUPLEX_SMALL_PAIRS - 1,
          f"cli duplex: {len(tags)} pairs written")
    check(counts["k1"] == 2 * len(tags), f"cli duplex: K1 launched "
          f"{counts['k1']} times for {2 * len(tags)} strand calls")
    want_tags = {rid: sets["duplex_f32_tags"][rid] for rid in tags}
    mm, ml, _w = tag_diff(tags, want_tags)
    check(mm == ml == 0, "cli duplex: tags differ from phase 5b's f32 run")
    launches["k1_f32"] += counts["k1"]
    rates["cli_duplex_pairs_per_s"] = len(tags) / wall

    # (e) dataset prepare, the device refiner against the native one
    table, _center = synth_level_table()
    levels = write_level_file(os.path.join(root, "levels_9mer.txt"), table)
    datasets = {}
    for backend in ("device", "native"):
        out = os.path.join(root, f"cli_prepare_{backend}")
        np.random.seed(9)
        counts, wall, lines = cli_leg(
            ["dataset", "prepare", pod5_path, bam_path, "--output-path", out,
             "--mod-base", "m", "5mC", "--motif", "CG", "0",
             "--chunk-context", *STAGE_CHUNK_CONTEXT,
             "--kmer-context-bases", *STAGE_KMER_CONTEXT,
             "--min-samples-per-base", 5, "--max-chunks-per-read",
             PREPARE_ALL_SITES, "--num-reads", PREPARE_SUBSET,
             "--refine-kmer-level-table", levels, "--refine-rough-rescale",
             "--refine-scale-iters", 0, "--refine-backend", backend],
            f"prepare {backend}")
        ds = datasets[backend] = CoreDataset(out, infinite_iter=False)
        log(f"cli dataset prepare {backend}: {PREPARE_SUBSET} reads, "
            f"{ds.size} chunks in {wall:.3f} s (the level table's load "
            f"included) = {PREPARE_SUBSET / wall:.1f} reads/s; K4/K5 "
            f"launches ({counts['k4']}, {counts['k5']}), planned "
            f"{counts['planned']}, reads routed to the host "
            f"{counts['host_routed']}; skip tally {skip_tally(lines)}")
        check(ds.size > 0, f"cli prepare {backend}: no chunks")
        if backend == "device":
            check(counts["k4"] == counts["k5"] == counts["planned"] > 0,
                  f"cli prepare device: K4/K5 launched ({counts['k4']}, "
                  f"{counts['k5']}), the refiner planned "
                  f"{counts['planned']}")
            check(counts["host_routed"] == 0,
                  "cli prepare device: reads were routed to the host DP")
            launches["k4"] += counts["k4"]
            launches["k5"] += counts["k5"]
        else:
            check(counts["k4"] == counts["k5"] == 0,
                  "cli prepare native: K4/K5 launched")
        rates[f"cli_prepare_{backend}_reads_per_s"] = PREPARE_SUBSET / wall
    differ, same_meta = dataset_diff(datasets["device"], datasets["native"])
    log(f"cli prepare device vs native: arrays that differ {differ}, "
        f"metadata identical {same_meta}")
    check(not differ and same_meta,
          "cli prepare: the device refiner's dataset differs from native's")

    # (f) validate from_remora_dataset on (e)'s dataset, from_modbams on
    # (c)'s BAM
    n_chunks = datasets["device"].size
    table_out = os.path.join(root, "cli_validate.txt")
    counts, wall, _ = cli_leg(
        ["validate", "from_remora_dataset", datasets["device"].data_path,
         "--model", path, "--batch-size", BATCH, "--out-file", table_out],
        "validate from_remora_dataset")
    n_batches = -(-n_chunks // BATCH)
    with open(table_out) as fh:
        rows = fh.read().splitlines()
    log(f"cli validate from_remora_dataset: {n_chunks} chunks in "
        f"{wall:.3f} s = {n_chunks / wall:.1f} chunks/s; K1 launches "
        f"{counts['k1']} for {n_batches} batches; {rows[-1]}")
    check(counts["k1"] == n_batches, f"cli validate: K1 launched "
          f"{counts['k1']} times for {n_batches} batches")
    check(len(rows) == 2, f"cli validate: {len(rows)} table rows")
    launches["k1_f32"] += counts["k1"]
    rates["cli_validate_dataset_chunks_per_s"] = n_chunks / wall
    bed = write_cg_bed(os.path.join(root, "cg_sites.bed"), bam_path)
    modbam_out = os.path.join(root, "cli_validate_modbams.txt")
    _c, wall, _ = cli_leg(
        ["validate", "from_modbams", "--bam-and-bed",
         os.path.join(root, "cli_infer_f32.bam"), bed, "--seed", 1,
         "--out-file", modbam_out], "validate from_modbams")
    with open(modbam_out) as fh:
        row = fh.read().splitlines()[-1]
    n_sites = int(row.split("\t")[6])
    log(f"cli validate from_modbams: {n_sites} sites in {wall:.3f} s; "
        f"{row}")
    check(n_sites > STREAM_READS, f"cli validate from_modbams: {n_sites} "
          "sites")
    rates["cli_validate_modbams_s"] = wall
    return launches, rates


def main():
    with contextlib.ExitStack() as stack:
        return run_phases(stack)


def run_phases(stack):
    """Every phase in turn; ``stack`` holds the temporary directory that
    outlives them all."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "remora_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(remora_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    if sys.argv[1:] == ["--profile-refine"]:
        return profile_micro_batch()
    if sys.argv[1:] == ["--step-walls"]:
        log(f"card: {nvidia_smi_line()}; package {REPO}")
        return step_walls()
    if sys.argv[1:2] == ["--dp-rank"]:
        return dp_rank_main(sys.argv[2:])
    if sys.argv[1:2] == ["--profile-stream"]:
        return profile_stream_child(sys.argv[2:])
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

    if sys.argv[1:] == ["--data-parallel"]:
        return data_parallel_only(stack, smi)
    check_lstm_fwd_compile()
    kernels = {
        torch.float32: check_lstm_last(torch.float32, 1e-5),
        torch.bfloat16: check_lstm_last(torch.bfloat16, 2e-2),
    }
    check_lstm_bwd_compile()
    train_kernels = {
        torch.float32: check_lstm_train(torch.float32, 1e-5),
        torch.bfloat16: check_lstm_train(torch.bfloat16, 2e-2),
    }
    wide_kernels = check_lstm_wide()
    general_kernels, stream_kernels = check_lstm_general()
    if sys.argv[1:] == ["--lstm-kernels"]:
        # phases 1-3b, 3d and 3e only: no main path ran, so no launch counts
        records = list(kernels.values())
        for recs in (*train_kernels.values(), *wide_kernels.values(),
                     *general_kernels.values(), stream_kernels):
            records.extend(recs)
        return finish(records)
    # relative to each output's largest entry: f32 rounding everywhere but
    # bf16's dx (dy and dx each rounded once to bf16) and dw (f32 sums of
    # the same bf16 operands, but a dy within f32 noise of a bf16 rounding
    # boundary rounds the other way: 1.1e-5 to 4.2e-5 on an H100)
    f32_tols = dict.fromkeys(("dx", "dw", "db", "dgamma", "dbeta"), 1e-5)
    check_convbn_compile()
    convbn_kernels = {
        torch.float32: check_convbn(torch.float32, f32_tols),
        torch.bfloat16: check_convbn(torch.bfloat16,
                                     dict(f32_tols, dx=2e-2, dw=2e-4)),
    }

    batches = make_batches()
    # phase 7 runs last, on the checkpoint, reads and datasets of the
    # phases before it: every phase's files stay until then
    root = stack.enter_context(tempfile.TemporaryDirectory())
    sets = {}
    tmp = os.path.join(root, "infer")
    os.makedirs(tmp)
    path = sets["ckpt"] = os.path.join(tmp, "convlstm_size64.npz")
    seeded_checkpoint(path)
    logits, launches, f32_rate = run_leg(path, batches, None, "f32")
    log(f"phase 4 f32: lstm_last launches {launches}")
    _, launches, bf16_rate = run_leg(path, batches, torch.bfloat16, "bf16")
    log(f"phase 4 bf16: lstm_last launches {launches}")
    check_cpu_agreement(path, batches, logits)
    format_tags(np.concatenate(logits))
    # phase 5: the streaming driver, the main path; its launch counts
    # are K1's in the kernels line
    refine_path = os.path.join(tmp, "convlstm_size64_refine.npz")
    seeded_checkpoint(refine_path, refine=synth_level_table())
    stream_launches, stream_rates = stream_infer(tmp, path, refine_path,
                                                 smi, sets)
    # phase 5b: duplex inference; K1's launches there join phase 5's
    t_phase = time.monotonic()
    duplex_launches, duplex_dp, duplex_rates = duplex_infer(
        tmp, path, refine_path, smi, sets)
    duplex_rates["duplex_phase_s"] = time.monotonic() - t_phase
    log(f"phase 5b wall {duplex_rates['duplex_phase_s']:.1f} s")
    kernels[torch.float32]["launches"] = (stream_launches["f32"]
                                          + duplex_launches["f32"])
    kernels[torch.bfloat16]["launches"] = (stream_launches["bf16"]
                                           + duplex_launches["bf16"])

    train_rates = {}
    tmp = os.path.join(root, "train")
    os.makedirs(tmp)
    config = sets["train_config"] = write_train_set(tmp)
    for dtype, bf16, tag in ((torch.float32, False, "train_f32"),
                             (torch.bfloat16, True, "train_bf16")):
        out, launches, rates, _ = train_leg(tmp, config, bf16, tag)
        for rec, n in zip(train_kernels[dtype], launches):
            rec["launches"] = n
        train_rates[tag] = rates
        profile_train_step(os.path.join(out, "model_final.checkpoint"),
                           bf16, tag)
    # the trim leg: the dataset at a smaller chunk context, its K2/K3
    # launches in the kernels line
    for rec, n in zip(train_kernels[torch.float32],
                      trim_leg(tmp, config, smi)):
        rec["launches"] += n
    final = os.path.join(tmp, "train_f32", "model_final.checkpoint")
    check_train_step_vs_plain(final)
    infer_trained(final)
    # 6c: the pallas-mode training path (K6 in every stride-1 block),
    # f32 one step a call and bf16 in windows of 4
    for dtype, bf16, spl, tag in (
            (torch.float32, False, 1, "train_pallas_f32"),
            (torch.bfloat16, True, 4, "train_pallas_bf16")):
        out, _, rates, k6 = train_leg(tmp, config, bf16, tag,
                                      epochs=PALLAS_EPOCHS,
                                      steps_per_launch=spl,
                                      convbn="pallas")
        for rec in convbn_kernels[dtype]:
            rec["launches"] = k6[rec.pop("key")]
        train_rates[tag] = rates
        profile_train_step(os.path.join(out, "model_final.checkpoint"),
                           bf16, tag, convbn="pallas")
    # 6d: a pallas-mode step against the fused-mode step
    check_pallas_step_vs_fused(final)
    # 6e: the wide LSTM legs on the model path at size WIDE_SIZE
    model_path_leg(tmp, config, wide_kernels, "wide")
    # 6g: the general LSTM leg on the model path at size GENERAL_SIZE
    model_path_leg(tmp, config, general_kernels, "general", stream_kernels)
    # 6f and 5c: data parallel on phase 6's dataset and phase 5's reads
    # and checkpoint; their K1-K3 launches join the kernels line
    dp_launches, dp_rates = data_parallel(tmp, config, sets["ckpt"], smi,
                                          sets)
    kernels[torch.float32]["launches"] += dp_launches["k1"]
    for rec, key in zip(train_kernels[torch.float32], ("k2", "k3")):
        rec["launches"] += dp_launches[key]

    log(f"phase 8: {host_memory()}")
    dp_kernels = check_banded_dp()
    tmp = os.path.join(root, "refine")
    os.makedirs(tmp)
    launches, refine_rates = refine_stage(tmp)
    # phase 8c: the prepare driver; K4/K5's launches there and in
    # phase 5b's device-refiner leg join phase 8b's
    t_phase = time.monotonic()
    prepare_launches, prepare_rates = prepare_stage(tmp, smi)
    prepare_rates["prepare_phase_s"] = time.monotonic() - t_phase
    log(f"phase 8c wall {prepare_rates['prepare_phase_s']:.1f} s")
    for rec, *ns in zip(dp_kernels, launches, duplex_dp, prepare_launches):
        rec["launches"] = sum(ns)

    # phase 7: the command line; its launches join the kernels line
    tmp = os.path.join(root, "cli")
    os.makedirs(tmp)
    log(f"phase 7: {host_memory()}")
    t_phase = time.monotonic()
    cli_launches, cli_rates = cli_phase(tmp, sets, smi)
    cli_rates["cli_phase_s"] = time.monotonic() - t_phase
    log(f"phase 7 wall {cli_rates['cli_phase_s']:.1f} s; launches "
        f"{cli_launches}")
    kernels[torch.float32]["launches"] += cli_launches["k1_f32"]
    kernels[torch.bfloat16]["launches"] += cli_launches["k1_bf16"]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for rec, key in zip(train_kernels[dtype], ("k2", "k3")):
            rec["launches"] += cli_launches[f"{key}_{tag}"]
    for rec, key in zip(dp_kernels, ("k4", "k5")):
        rec["launches"] += cli_launches[key]
    log(json.dumps({"slice": {
        "f32_chunks_per_s": f32_rate, "bf16_chunks_per_s": bf16_rate,
        "batches": N_BATCHES, "batch": BATCH, "last_batch": LAST_BATCH,
        "width": WIDTH, "kmer_len": KMER_LEN, "size": SIZE,
        "train_epoch_chunks_per_s": train_rates,
        "train_steps_per_epoch": TRAIN_STEPS, "train_epochs": TRAIN_EPOCHS,
        "train_pallas_epochs": PALLAS_EPOCHS,
        **stream_rates,
        **duplex_rates,
        **refine_rates,
        **prepare_rates,
        **cli_rates,
        **dp_rates,
    }}))
    records = list(kernels.values())
    for recs in (*train_kernels.values(), *wide_kernels.values(),
                 *general_kernels.values(), stream_kernels,
                 *convbn_kernels.values(),
                 dp_kernels):
        records.extend(recs)
    return finish(records)


def data_parallel_only(stack, smi):
    """``--data-parallel``: phases 6f and 5c alone, after K1 and K2/K3 in
    f32 against their plain versions (the kernels line's records) and
    the files the phases read: phase 4's checkpoint, phase 5's f32 driver
    run and phase 6's dataset."""
    import torch

    from remora_tpu_torch.infer.infer import ModelHandle

    check_lstm_fwd_compile()
    k1 = check_lstm_last(torch.float32, 1e-5)
    check_lstm_bwd_compile()
    k23 = check_lstm_train(torch.float32, 1e-5)
    root = stack.enter_context(tempfile.TemporaryDirectory())
    os.environ["REMORA_TPU_BAM_INDEX_CACHE"] = "0"
    os.environ["LOG_SAFE"] = "1"
    ckpt = os.path.join(root, "convlstm_size64.npz")
    seeded_checkpoint(ckpt)
    table, center = synth_level_table()
    pod5_path, bam_path = write_stream_set(root, "stream", STREAM_READS,
                                           table, center)
    tags, _counts, _wall, _lines = stream_leg(
        pod5_path, bam_path, ModelHandle.load(ckpt),
        os.path.join(root, "stream_f32.bam"), "stream f32")
    config = write_train_set(root)
    launches, rates = data_parallel(root, config, ckpt, smi,
                                    {"stream_f32_tags": tags})
    k1["launches"] = launches["k1"]
    for rec, key in zip(k23, ("k2", "k3")):
        rec["launches"] = launches[key]
    log(json.dumps({"slice": rates}))
    return finish([k1, *k23])


def finish(records):
    """The kernels line, the card's line and the result line, once no
    phase has imported zstandard (the port's POD5 codec is pyarrow's)."""
    import torch

    check("zstandard" not in sys.modules,
          "zstandard was imported: the port must read and write POD5 "
          "without it")

    log(json.dumps({"kernels": records}))
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
