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

Imports nothing of JAX or of the JAX package ``remora_tpu``; the build and
timing helpers are ``chip_lstm_fwd_variants.py``'s, the reads
``chip_smoke.py``'s.
"""

import ctypes
import os
import re
import subprocess
import sys

from chip_lstm_fwd_variants import build_variants, smi_line, time_ms

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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_dp_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
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
