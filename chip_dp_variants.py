#!/usr/bin/env python3
"""Where the per-base time of K4, the banded DP forward, goes, on one
NVIDIA GPU.

    python3 chip_dp_variants.py

Builds ``remora_tpu_torch/csrc/banded_dp.cu`` as it is (at W <= 128 the
staged path, ``dp_forward_staged_kernel``) and in variants (textual edits
of the source, made in a temporary directory). The block path
(``dp_forward_kernel``, the only design before the staged path and the
one W > 128 still runs) is forced at W = 128 and split: as it is, then
without the signal loads, the move candidates, the dwell candidates, the
traceback-row store, everything but the folds and the barriers ("the fold
alone") and everything but the barriers ("barriers only"). The staged
path is split without its folds and without its dwell candidates. Times
each,
both algorithms, at ``chip_smoke.py`` phase 8's micro-batch (64
synthetic reads of 4000 bases, band-width bucket W = 128) with CUDA
events, and prints each time per base of a read. The
variants compute wrong numbers on purpose: they are timings, never
results. Prints the card's name, power limit and SM clocks and each
variant's registers and spills. An edit that no longer matches the source
stops the script: update it with the kernel.

    python3 chip_dp_variants.py --traceback [--compare-parent DIR]
    python3 chip_dp_variants.py --block-256

splits K5, the traceback walk (``dp_traceback_staged_kernel``), at the
same micro-batch (the rows K4 writes for it, dwell_penalty): a pointer
chase through shared memory first measures the card's dependent ``LDS``
latency (the step of K5's floor, ``chip_smoke.TB_STEP_CYCLES``); then K5
as it is, without the walk (the staging, barriers and path stores only),
without the staging wait (the walk on whatever the ring holds; each chunk
is still awaited after its walk, so every copy lands before the block
ends), with the clamp as a mask (W = 128 is a power of 2) and as two
``IMNMX``, each in ms and cycles a walked base at the card's max SM
clock; the registers and spills of each, and the walk loop's SASS, which
must hold no global load. ``--compare-parent DIR`` also builds the
``banded_dp.cu`` of another checkout (DIR, e.g. ``git archive`` of the
parent commit unpacked into the gitignored ``parent_checkout/``) and
times its K5 against this one in one call, parent / this / this / parent,
paths equal.

``--block-256`` times K4's block path, which bands wider than 128 run,
at the same micro-batch padded to W = 256 beside its bound, its paths
held to the native host DP.

Imports nothing of JAX or of the JAX package ``remora_tpu``; the build and
timing helpers are ``chip_lstm_fwd_variants.py``'s, the reads
``chip_smoke.py``'s.
"""

import ctypes
import os
import re
import subprocess
import sys

from chip_lstm_fwd_variants import (build_variants, ptxas_lines, smi_line,
                                    time_ms)

SOURCE = "banded_dp.cu"

EDITS = {
    "block": [("  if (W <= kStagedMaxBand && W % 8 == 0) {", "  if (false) {")],
    "staged_no_folds": [
        ("          if (tid == 0) fold_rows(base, cand, ctb, next, ctb, w);",
         ""),
        ("          if (tid == 0) fold_rows(base, cand, ctb, unpen, unpen_tb, "
         "w);", ""),
        ("          if (tid == 0 && p0c < w) stay_suffix(base, cand, ctb, "
         "next, p0c, w);", "")],
    "staged_no_dwell": [
        ("            for (int d = 0; d < L; ++d) {",
         "            for (int d = 0; d < 0; ++d) {"),
        ("            if (p < p0 && p >= L) {", "            if (false) {")],
    "no_signal": [(
        "const float s = (col >= 0 && col < S) ? sig[col] : 0.0f;",
        "const float s = (float)(col & 7) * 0.25f;")],
    "no_move": [(
        "      float mv = (src >= 0 && src < prev_valid) ? "
        "__fadd_rn(prev[src], b)\n"
        "                                                 : kBig;",
        "      float mv = src < 0 ? kBig : b;")],
    "no_dwell": [
        ("        for (int d = 0; d < L; ++d) {",
         "        for (int d = 0; d < 0; ++d) {"),
        ("        if (in_main && p >= L) {", "        if (false) {")],
    "no_store": [(
        "      row[p] = p < w ? static_cast<int16_t>(ctb[p]) : int16_t(0);",
        "      if (ctb[p] == 12345) row[p] = 0;")],
    "no_folds": [
        ("      if (tid == 0) stay_fold(base, cand, ctb, prev, ctb, w);", ""),
        ("      if (tid == 0) stay_fold(base, cand, ctb, unpen, unpen_tb, "
         "w);", ""),
        ("      if (tid == 0 && p0c < w) stay_suffix(base, cand, ctb, prev, "
         "p0c, w);", "")],
}
_ALL_BUT_FOLDS = (EDITS["no_signal"] + EDITS["no_move"] + EDITS["no_dwell"]
                  + EDITS["no_store"])
_BLOCK = EDITS["block"]
VARIANTS = {
    "staged path (as is)": [],
    "staged, no folds": EDITS["staged_no_folds"],
    "staged, no dwell candidates": EDITS["staged_no_dwell"],
    "block path": _BLOCK,
    "block, no signal loads": _BLOCK + EDITS["no_signal"],
    "block, no move candidates": _BLOCK + EDITS["no_move"],
    "block, no dwell candidates": _BLOCK + EDITS["no_dwell"],
    "block, no traceback-row store": _BLOCK + EDITS["no_store"],
    "block, the fold alone": _BLOCK + _ALL_BUT_FOLDS,
    "block, barriers only": _BLOCK + _ALL_BUT_FOLDS + EDITS["no_folds"],
}


def _typed(path):
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.banded_dp_forward.argtypes = [ptr] * 5 + [i32] * 6 + [ptr, ptr]
    lib.banded_dp_forward.restype = i32
    return lib


def build_block_path():
    """The K4 library with the block path forced at every W: the parent
    design's kernel (``dp_forward_kernel``, unchanged), for a comparison in
    one run. Returns a ``ctypes`` library with ``banded_dp_forward``
    typed."""
    from remora_tpu_torch.kernels import _build

    _, built = build_variants(SOURCE, {"block path": _BLOCK},
                              flags=_build.SOURCE_FLAGS["banded_dp"])
    return _typed(built["block path"][0])


def fold_sass(nvcc, lib, kernel="dp_forward_staged_kernelILb0E"):
    """The SASS of the staged Viterbi kernel's fold loop: the lines from the
    first FMNMX's loop head to its backward branch."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        if kernel not in block.split("\n", 1)[0]:
            continue
        lines = [ln.split(";")[0].strip() for ln in block.splitlines()
                 if re.match(r"\s*/\*[0-9a-f]{4}\*/", ln)]
        first = next(i for i, ln in enumerate(lines) if "FMNMX" in ln)
        end = next(i for i in range(first, len(lines))
                   if "BRA" in lines[i])
        return lines[max(0, first - 12):end + 1]
    return []


# ---------------- K5, the traceback walk ----------------

_WALK_LOAD = "  const int v = lds_s16(row + 2 * off);\n"
_WALK_WAIT = "      mbar_wait(&full[s], (c / stages) & 1);\n"
_WALK_RELEASE = "      mbar_arrive(&empty[s]);\n    }\n  }\n}\n"
_CLAMP = "  const int off = __vimin_s32_relu(d, W - 1);\n"
TB_VARIANTS = {
    "K5 (as is)": [],
    "K5, no walk": [(_WALK_LOAD, "  const int v = 0;\n")],
    "K5, no staging wait": [(_WALK_WAIT, ""),
                            (_WALK_RELEASE, _WALK_WAIT + _WALK_RELEASE)],
    "K5, clamp as a mask": [
        (_CLAMP, "  const int off = d & (W - 1);\n")],
    "K5, clamp as two IMNMX": [
        (_CLAMP, "  const int off = min(max(d, 0), W - 1);\n")],
}

CHASE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// one thread follows a cycle of 1024 shared-memory words whose values
// are the next word's shared address: n dependent loads between two
// clock64 reads. kS16: 16-bit words loaded with sign extension, as K5's
// steps are.
template <bool kS16>
__global__ void lds_chase(int n, long long* out) {
  __shared__ uint32_t w32[1024];
  __shared__ int16_t w16[1024];
  const uint32_t b32 = static_cast<uint32_t>(__cvta_generic_to_shared(w32));
  const uint32_t b16 = static_cast<uint32_t>(__cvta_generic_to_shared(w16));
  for (int i = 0; i < 1024; ++i) {
    const int j = (i * 389 + 1) % 1024;
    w32[i] = b32 + 4u * j;
    w16[i] = static_cast<int16_t>(b16 + 2u * j);
  }
  uint32_t a = kS16 ? b16 : b32;
  long long t0 = 0;
  for (int rep = 0; rep < 2; ++rep) {  // the first pass warms up
    t0 = clock64();
#pragma unroll 16
    for (int i = 0; i < n; ++i) {
      if (kS16)
        asm volatile("ld.shared.s16 %0, [%0];" : "+r"(a));
      else
        asm volatile("ld.shared.u32 %0, [%0];" : "+r"(a));
    }
  }
  out[0] = clock64() - t0;
  out[1] = a;
}

extern "C" int lds_chase_cycles(int n, int s16, long long* out) {
  if (s16)
    lds_chase<true><<<1, 1>>>(n, out);
  else
    lds_chase<false><<<1, 1>>>(n, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def lds_latency():
    """Cycles of one dependent shared-memory load on the card (u32 and s16
    words), from ``CHASE_SOURCE``'s pointer chase."""
    import tempfile

    import torch

    tmp = tempfile.mkdtemp()
    with open(os.path.join(tmp, "chase.cu"), "w") as fh:
        fh.write(CHASE_SOURCE)
    _, built = build_variants("chase.cu", {"chase": []}, csrc=tmp)
    lib = ctypes.CDLL(built["chase"][0])
    lib.lds_chase_cycles.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.lds_chase_cycles.restype = ctypes.c_int
    n = 1 << 16
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    cycles = {}
    for name, s16 in (("u32", 0), ("s16", 1)):
        if lib.lds_chase_cycles(n, s16, out.data_ptr()) != 0:
            raise SystemExit("the pointer chase did not launch")
        torch.cuda.synchronize()
        cycles[name] = out[0].item() / n
    return cycles


def _typed_tb(path):
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.banded_dp_traceback.argtypes = [ptr] * 4 + [i32] * 3 + [ptr, ptr]
    lib.banded_dp_traceback.restype = i32
    return lib


def walk_sass(nvcc, lib, kernel="dp_traceback_staged_kernel"):
    """The SASS of K5's walk loop: from a few lines before its first
    ``LDS.S16`` to the backward branch after its last."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        if kernel not in block.split("\n", 1)[0]:
            continue
        lines = [ln.split(";")[0].strip() for ln in block.splitlines()
                 if re.match(r"\s*/\*[0-9a-f]{4}\*/", ln)]
        hits = [i for i, ln in enumerate(lines) if "LDS.S16" in ln]
        if not hits:
            return []
        end = next((i for i in range(hits[-1], len(lines))
                    if "BRA" in lines[i]), len(lines) - 1)
        return lines[max(0, hits[0] - 12):end + 1]
    return []


def micro_batch_tb(cuda):
    """The micro-batch's traceback rows (K4, dwell_penalty) with its
    starts, widths and seq_lens."""
    import torch

    from chip_smoke import DP_BASES, DP_READS, dp_reads, dp_tensors, \
        width_bucket
    from remora_tpu_torch.kernels import banded_dp as K
    from remora_tpu_torch.refine.refiner import DEFAULT_REFINE_SHORT_DWELL_PEN

    batch = dp_reads(9, DP_READS, DP_BASES)
    W = width_bucket(batch)
    sig, lvl, st, wd, sl = dp_tensors(batch, W, cuda)
    sdp = torch.tensor(DEFAULT_REFINE_SHORT_DWELL_PEN, dtype=torch.float32,
                       device=cuda)
    tb = K.dp_forward(sig, lvl, st, wd, sdp, True, W)
    return tb, st, wd, sl


def split_traceback(parent_dir=None):
    """K5's split and, with ``parent_dir``, the parent's K5 in turns."""
    import torch

    from chip_smoke import max_sm_clock_hz
    from remora_tpu_torch.kernels import _build
    from remora_tpu_torch.kernels import banded_dp as K

    chase = lds_latency()
    print(f"dependent LDS latency (pointer chase, one thread): u32 "
          f"{chase['u32']:.2f} cycles, s16 {chase['s16']:.2f} cycles",
          flush=True)
    flags = _build.SOURCE_FLAGS["banded_dp"]
    nvcc, built = build_variants(SOURCE, TB_VARIANTS, flags=flags)
    libs = {}
    for name, (path, out) in built.items():
        print(f"{name}: {ptxas_lines(out, 'dp_traceback_staged_kernel')}",
              flush=True)
        libs[name] = _typed_tb(path)
    loop = walk_sass(nvcc, built["K5 (as is)"][0])
    n_ldg = sum("LDG" in ln for ln in loop)
    print(f"K5 walk loop (SASS), global loads in it: {n_ldg}:\n  "
          + "\n  ".join(loop), flush=True)
    if not loop or n_ldg:
        raise SystemExit("K5's walk loop was not found, or holds a global "
                         "load")

    cuda = torch.device("cuda")
    tb, st, wd, sl = micro_batch_tb(cuda)
    R, N, W = tb.shape
    steps = int(sl.max().item()) - 1
    clock = max_sm_clock_hz()
    stream = torch.cuda.current_stream().cuda_stream
    path = torch.empty((R, N + 1), dtype=torch.int32, device=cuda)
    print(f"{R} reads x {N} bases, W = {W}; the longest walk {steps} "
          f"bases; max SM clock {clock / 1e6:.0f} MHz", flush=True)

    def launcher(lib, name, out=path):
        def call():
            err = lib.banded_dp_traceback(
                tb.data_ptr(), st.data_ptr(), wd.data_ptr(), sl.data_ptr(),
                R, N, W, out.data_ptr(), stream)
            if err != 0:
                raise SystemExit(f"{name!r}: launch error {err}")
        return call

    for name, lib in libs.items():
        ms = time_ms(launcher(lib, name))
        print(f"{name}: {ms:.4f} ms ({ms * 1e-3 * clock / steps:.1f} cycles "
              "a walked base)", flush=True)
    if parent_dir is None:
        return
    csrc = os.path.join(parent_dir, "remora_tpu_torch", "csrc")
    _, pbuilt = build_variants(SOURCE, {"parent": []}, flags=flags,
                               csrc=csrc)
    parent = _typed_tb(pbuilt["parent"][0])
    p_path = torch.empty_like(path)
    launcher(parent, "parent", p_path)()
    change = K.dp_traceback(tb, st, wd, sl)
    torch.cuda.synchronize()
    if not torch.equal(p_path, change):
        raise SystemExit("the parent's K5 paths differ from this K5's")
    turns = [(name, time_ms(fn)) for name, fn in (
        ("parent", launcher(parent, "parent", p_path)),
        ("change", lambda: K.dp_traceback(tb, st, wd, sl)),
        ("change", lambda: K.dp_traceback(tb, st, wd, sl)),
        ("parent", launcher(parent, "parent", p_path)))]
    print("K5 at the micro-batch, parent / this / this / parent (the "
          "wrapper, paths equal): " + ", ".join(
              f"{name} {ms:.4f} ms" for name, ms in turns), flush=True)


def block_at_256(W=256):
    """``--block-256``: K4's block path (``dp_forward_kernel``, which every
    band-width bucket past 128 runs) through ``dp_forward`` at phase 8's
    micro-batch padded to the bucket W = 256, both algorithms: the paths
    (``banded_dp_batch``) equal to the native host DP's, its ms beside its
    bound (the larger of the serial fold chain of the read that needs the
    longest, ``chip_smoke.dp_chain_cycles`` at the card's max SM clock,
    and the bytes it must move at 3.35 TB/s: signal, levels, bands and the
    W-wide int16 traceback rows) and the staged path's time on the same
    reads at their own bucket (128)."""
    import numpy as np
    import torch

    from chip_smoke import (DP_BASES, DP_READS, FOLD_STEP_CYCLES,
                            PEAK_BYTES_PER_S, STAY_STEP_CYCLES,
                            dp_chain_cycles, dp_reads, dp_tensors,
                            max_sm_clock_hz, width_bucket)
    from remora_tpu_torch.io.native import banded_dp_path
    from remora_tpu_torch.kernels import banded_dp as K
    from remora_tpu_torch.refine.refiner import DEFAULT_REFINE_SHORT_DWELL_PEN

    cuda = torch.device("cuda")
    sdp_np = np.asarray(DEFAULT_REFINE_SHORT_DWELL_PEN, np.float32)
    sdp = torch.from_numpy(sdp_np).to(cuda)
    batch = dp_reads(9, DP_READS, DP_BASES)
    own = width_bucket(batch)
    for algo in ("Viterbi", "dwell_penalty"):
        dwell = algo == "dwell_penalty"
        sig, lvl, st, wd, sl = dp_tensors(batch, W, cuda)
        R, N = lvl.shape
        path, tb, _ = K.banded_dp_batch(sig, lvl, st, wd, sl, sdp, algo=algo,
                                        w_max=W)
        got = path.cpu().numpy()
        native = [banded_dp_path(s, lv, bd, sdp_np, algo)
                  for s, lv, bd in batch]
        diffs = sum(int((got[r, :lv.size + 1] != native[r]).sum())
                    for r, (_s, lv, _b) in enumerate(batch))
        if diffs or tb.shape[2] != W:
            raise SystemExit(f"K4 {algo} at W={W}: {diffs} path entries "
                             "differ from the native host DP")
        ms = time_ms(lambda: K.dp_forward(sig, lvl, st, wd, sdp, dwell, W))
        cycles, rows, suffix = dp_chain_cycles(st, wd, sdp.numel(), dwell)
        chain_ms = cycles / max_sm_clock_hz() * 1e3
        fwd_bytes = (sig.numel() * 4 + 3 * R * N * 4 + sdp.numel() * 4
                     + tb.numel() * 2)
        bytes_ms = fwd_bytes / PEAK_BYTES_PER_S * 1e3
        s128 = dp_tensors(batch, own, cuda)
        staged_ms = time_ms(lambda: K.dp_forward(*s128[:4], sdp, dwell, own))
        print(f"K4 {algo} block path (dp_forward_kernel), {R} reads x {N} "
              f"bases at W={W}: {ms:.4f} ms ({ms / N * 1e3:.4f} us a base), "
              f"paths equal to the native host DP; bound "
              f"{max(chain_ms, bytes_ms):.4f} ms (chain {rows} folded rows "
              f"x {FOLD_STEP_CYCLES} + {suffix} suffix rows x "
              f"{STAY_STEP_CYCLES} cycles = {chain_ms:.4f} ms; bytes "
              f"{fwd_bytes / 1e6:.2f} MB = {bytes_ms:.4f} ms); the staged "
              f"path on the same reads at their bucket W={own}: "
              f"{staged_ms:.4f} ms", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_dp_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args[:1] == ["--block-256"]:
        block_at_256()
        print(smi_line())
        return 0
    if args[:1] == ["--traceback"]:
        parent = None
        if args[1:2] == ["--compare-parent"]:
            parent = args[2]
        split_traceback(parent)
        print(smi_line())
        return 0
    from chip_smoke import (DP_BASES, DP_READS, dp_reads, dp_tensors,
                            width_bucket)
    from remora_tpu_torch.kernels import _build
    from remora_tpu_torch.refine.refiner import DEFAULT_REFINE_SHORT_DWELL_PEN

    nvcc, built = build_variants(SOURCE, VARIANTS,
                                 flags=_build.SOURCE_FLAGS["banded_dp"])
    libs = {}
    for name, (path, out) in built.items():
        regs = re.findall(r"Used (\d+) registers", out)
        spills = re.findall(r"(\d+) bytes spill stores", out)
        print(f"{name}: registers {regs}, spill stores {spills}", flush=True)
        libs[name] = _typed(path)
    print("staged Viterbi fold loop (SASS):\n  " + "\n  ".join(
        fold_sass(nvcc, built["staged path (as is)"][0])), flush=True)

    cuda = torch.device("cuda")
    batch = dp_reads(9, DP_READS, DP_BASES)
    W = width_bucket(batch)
    sig, lvl, st, wd, _sl = dp_tensors(batch, W, cuda)
    sdp = torch.tensor(DEFAULT_REFINE_SHORT_DWELL_PEN, dtype=torch.float32,
                       device=cuda)
    R, N = lvl.shape
    tb = torch.empty((R, N, W), dtype=torch.int16, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"{R} reads x {N} bases, W = {W}, mean band width "
          f"{wd.float().mean().item():.2f}", flush=True)
    for dwell in (False, True):
        algo = "dwell_penalty" if dwell else "Viterbi"
        for name, lib in libs.items():
            def call():
                err = lib.banded_dp_forward(
                    sig.data_ptr(), lvl.data_ptr(), st.data_ptr(),
                    wd.data_ptr(), sdp.data_ptr(), sdp.numel(), int(dwell),
                    R, N, sig.shape[1], W, tb.data_ptr(), stream)
                if err != 0:
                    raise SystemExit(f"variant {name!r}: launch error {err}")
            ms = time_ms(call)
            print(f"{algo} {name}: {ms:.4f} ms ({ms / N * 1e3:.4f} us a "
                  "base)", flush=True)
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
