#!/usr/bin/env python3
"""Where the step time of K1/K2's bf16 kernel goes, on one NVIDIA GPU.

    python3 chip_lstm_fwd_variants.py

Builds ``remora_tpu_torch/csrc/lstm_fwd_mma.cu`` as it is and in variants
that each take one piece of a step away or make it cheaper (textual edits
of the source, made in a temporary directory), and times each at the main
path's shape (T = 1 and 124, B = 2048, C = H = 64; K1's last-only form and
K2 with cs) with CUDA events. The variants compute wrong numbers on
purpose: they are timings, never results. Prints the card's name, power
limit and SM clocks, each variant's registers, and the SASS instruction
mix of K1's 16-byte form. An edit that no longer matches the source stops
the script: update it with the kernel.

Imports nothing of JAX or of the JAX package ``remora_tpu``.
"""

import collections
import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(REPO, "remora_tpu_torch", "csrc")

_FAST_TANH = (
    "namespace {\n\nconstexpr int kThreads",
    "namespace {\n__device__ __forceinline__ float fast_tanh(float x) {\n"
    "  float y;\n  asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n"
    "  return y;\n}\n\nconstexpr int kThreads",
)
_SIG = "return 1.0f / (1.0f + expf(-z));"
# (name, what it changes, edits)
EDITS = {
    "exp_fast": [(_SIG, "return 1.0f / (1.0f + __expf(-z));")],
    "sigmoid_fast": [(_SIG, "return __fdividef(1.0f, 1.0f + __expf(-z));")],
    "tanh_fast": [("tanhf(", "fast_tanh("), _FAST_TANH],
    "no_x_product": [("        if (more && kt < nkx) x_step(t + 1, kt, accx);\n",
                      "")],
    "no_h_product": [(
        "for (int j = 0; j < 2; ++j) mma_16816(acc[j], a, wh[kt % kHT][j]);",
        "acc[0][0] += __uint_as_float(a[0]);")],
    "no_gate_math": [
        ("        const float ig = sigmoid(acc[0][2 * s] + bias[0]);\n"
         "        const float fg = sigmoid(acc[0][2 * s + 1] + bias[1]);\n"
         "        const float gg = tanhf(acc[1][2 * s] + bias[2]);\n"
         "        const float og = sigmoid(acc[1][2 * s + 1] + bias[3]);",
         "        const float ig = (acc[0][2 * s] + bias[0]) * 1e-3f;\n"
         "        const float fg = (acc[0][2 * s + 1] + bias[1]) * 1e-3f;\n"
         "        const float gg = (acc[1][2 * s] + bias[2]) * 1e-3f;\n"
         "        const float og = (acc[1][2 * s + 1] + bias[3]) * 1e-3f;"),
        ("og * tanhf(c[s])", "og * c[s]")],
}
VARIANTS = {
    "as is": [],
    "fast expf": EDITS["exp_fast"],
    "fast sigmoid (expf, division)": EDITS["sigmoid_fast"],
    "fast tanh": EDITS["tanh_fast"],
    "fast sigmoid and tanh": EDITS["sigmoid_fast"] + EDITS["tanh_fast"],
    "no gate math": EDITS["no_gate_math"],
    "no gate math, no x product": EDITS["no_gate_math"]
    + EDITS["no_x_product"],
    "no gate math, no products": EDITS["no_gate_math"]
    + EDITS["no_x_product"] + EDITS["no_h_product"],
}


def sass_mix(nvcc, lib, tag="ILb0ELb0ELb1E"):
    """(instruction count, the 12 most frequent opcodes) of the kernel
    instantiation whose mangled name holds ``tag``."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        if tag not in block.split("\n", 1)[0]:
            continue
        ops = []
        for line in block.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s*(@!?U?P\w+\s+)?([A-Z]\w*)",
                         line)
            if m:
                ops.append(m.group(2))
        return len(ops), collections.Counter(ops).most_common(12)
    return 0, []


def build_variants(source, variants, headers=(), flags=(), csrc=CSRC):
    """Build ``<csrc>/<source>`` (the package's ``csrc/`` unless another
    checkout's is given) once per variant (name -> list of (old, new)
    textual edits), one ``nvcc`` each with the package's flags and
    ``flags``, all started together, in a temporary directory beside
    copies of ``headers``. Returns {name: (library path, nvcc output)}. An
    edit that no longer matches stops the script."""
    sys.path.insert(0, REPO)
    from remora_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    src = open(os.path.join(csrc, source)).read()
    tmp = tempfile.mkdtemp()
    for header in headers:
        with open(os.path.join(csrc, header)) as fh:
            open(os.path.join(tmp, header), "w").write(fh.read())
    jobs = {}
    for k, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: edit {old!r} no longer "
                                 f"matches {source}")
            text = text.replace(old, new)
        path = os.path.join(tmp, f"v{k}.cu")
        open(path, "w").write(text)
        lib = os.path.join(tmp, f"libv{k}.so")
        jobs[name] = lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, (path, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} does not build:\n{out}")
        built[name] = path, out
    return nvcc, built


def time_ms(fn, n=15, calls=5):
    """Median device time of one ``fn`` call (CUDA events over ``calls``
    calls a sample, ``n`` samples, two warm-ups)."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def smi_line():
    """The card's name, power limit and SM clocks from ``nvidia-smi``."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_lstm_fwd_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    nvcc, built = build_variants("lstm_fwd_mma.cu", VARIANTS,
                                 headers=("mma_sm90.cuh",))
    libs = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (path, out) in built.items():
        regs = re.findall(r"Used (\d+) registers", out)
        n, mix = sass_mix(nvcc, path)
        print(f"{name}: registers {regs}; K1 16-byte form {n} SASS "
              f"instructions: " + ", ".join(f"{op} {c}" for op, c in mix))
        lib = ctypes.CDLL(path)
        lib.lstm_fwd_mma.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.lstm_fwd_mma_last.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
        libs[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, C, H = 2048, 64, 64
    stream = torch.cuda.current_stream().cuda_stream
    for T in (1, 124):
        x = torch.randn((T, B, C), device="cuda", generator=gen).bfloat16()
        w = (torch.rand((C + H + 1, 4 * H), device="cuda", generator=gen)
             * 0.25 - 0.125).bfloat16()
        out = torch.empty((B, H), device="cuda", dtype=torch.bfloat16)
        hs = torch.empty((T, B, H), device="cuda", dtype=torch.bfloat16)
        cs = torch.empty_like(hs)
        for name, lib in libs.items():
            last = time_ms(lambda: lib.lstm_fwd_mma_last(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), T, B, C, H,
                stream))
            seq = time_ms(lambda: lib.lstm_fwd_mma(
                x.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(), T,
                B, C, H, stream))
            print(f"T={T} {name}: K1 {last:.4f} ms ({last / T * 1e3:.3f} "
                  f"us a step), K2 with cs {seq:.4f} ms")
    print(smi_line())
    return 0

if __name__ == "__main__":
    sys.exit(main())
