#!/usr/bin/env python3
"""Where the step time of K3's f32 kernel goes, on one NVIDIA GPU.

    python3 chip_lstm_bwd_variants.py

Builds the f32 training LSTM backward (``csrc/lstm_bwd_f32.cu``) as it is
and in variants that each take one piece of a step away (textual edits of
the source, made in a temporary directory): phase A (the gate recompute),
the gate math, phase C (dgates . W^T, dx and the dh carry), phase D (the
dW tile), the cp.async staging of the step operands, and all three
products. Times each at the main path's shape (T = 124, B = 2048, C = H =
64) with CUDA events. The variants compute wrong numbers on purpose: they
are timings, never results. Prints the card's name, power limit and SM
clocks, each variant's registers and spills, and the SASS instruction mix
of the kernel's main-path form (16-byte copies, C = H = 64) as built. An
edit that no longer matches the source stops the script: update it with
the kernel.

Imports nothing of JAX or of the JAX package ``remora_tpu``; the build,
timing and SASS helpers are ``chip_lstm_fwd_variants.py``'s.
"""

import ctypes
import re
import sys

from chip_lstm_fwd_variants import build_variants, sass_mix, smi_line, \
    time_ms

SOURCE = "lstm_bwd_f32.cu"
KERNEL = "lstm_bwd_f32_kernelILb1ELi64ELi64E"

EDITS = {
    "no_a": [("for (int k = 0; k < K4; k += 4) {",
              "for (int k = 0; k < 0; k += 4) {")],
    "no_c": [("for (int p = s * half; p < p1; p += 4) {",
              "for (int p = 0; p < 0; p += 4) {")],
    "no_d": [("    if (dw_active) {\n      const float* xk",
              "    if (false) {\n      const float* xk")],
    "no_gate_math": [
        ("    const float ig = sigmoid(z[i][0]);\n"
         "    const float fg = sigmoid(z[i][1]);\n"
         "    const float gg = tanhf(z[i][2]);\n"
         "    const float og = sigmoid(z[i][3]);",
         "    const float ig = z[i][0] * 1e-3f;\n"
         "    const float fg = z[i][1] * 1e-3f;\n"
         "    const float gg = z[i][2] * 1e-3f;\n"
         "    const float og = z[i][3] * 1e-3f;"),
        ("const float tanh_c = tanhf(c_cur[i]);",
         "const float tanh_c = c_cur[i] * 1e-3f;")],
    "no_staging": [("    stage(t - 2);\n", "    cp_async_commit();\n")],
}
VARIANTS = {
    "as is": [],
    "no phase A (gate recompute)": EDITS["no_a"],
    "no gate math": EDITS["no_gate_math"],
    "no phase C (dgates . W^T)": EDITS["no_c"],
    "no phase D (dW tile)": EDITS["no_d"],
    "no operand staging": EDITS["no_staging"],
    "no products (A, C, D)": EDITS["no_a"] + EDITS["no_c"] + EDITS["no_d"],
}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_lstm_bwd_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    nvcc, built = build_variants(SOURCE, VARIANTS,
                                 headers=("mma_sm90.cuh",))
    libs = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (path, out) in built.items():
        regs = re.findall(r"Used (\d+) registers", out)
        spills = re.findall(r"(\d+) bytes spill stores", out)
        line = f"{name}: registers {regs}, spill stores {spills}"
        if name == "as is":
            n, mix = sass_mix(nvcc, path, KERNEL)
            line += f"; {KERNEL} {n} SASS instructions: " + ", ".join(
                f"{op} {c}" for op, c in mix)
        print(line, flush=True)
        lib = ctypes.CDLL(path)
        lib.lstm_bwd_f32.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        lib.lstm_bwd_f32.restype = i32
        libs[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)
    T, B, C, H = 124, 2048, 64, 64
    n_blocks = (B + 15) // 16
    x = torch.randn((T, B, C), device="cuda", generator=gen)
    w = torch.rand((C + H + 1, 4 * H), device="cuda", generator=gen) \
        * 0.25 - 0.125
    hs = torch.rand((T, B, H), device="cuda", generator=gen) * 2 - 1
    cs = torch.randn((T, B, H), device="cuda", generator=gen)
    dhs = torch.randn((T, B, H), device="cuda", generator=gen)
    dx = torch.empty_like(x)
    partials = torch.empty((n_blocks, C + H + 1, 4 * H), device="cuda")
    dw = torch.empty((C + H + 1, 4 * H), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        def call():
            err = lib.lstm_bwd_f32(
                x.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                dhs.data_ptr(), dx.data_ptr(), partials.data_ptr(),
                dw.data_ptr(), T, B, C, H, stream)
            if err != 0:
                raise SystemExit(f"variant {name!r}: launch error {err}")
        ms = time_ms(call)
        print(f"T={T} {name}: {ms:.4f} ms ({ms / T * 1e3:.3f} us a step)",
              flush=True)
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
