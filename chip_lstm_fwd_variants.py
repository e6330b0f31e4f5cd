#!/usr/bin/env python3
"""Where the step time of K1/K2's kernels goes, on one NVIDIA GPU.

    python3 chip_lstm_fwd_variants.py
    python3 chip_lstm_fwd_variants.py --wide
    python3 chip_lstm_fwd_variants.py --f32
    python3 chip_lstm_fwd_variants.py --general
    python3 chip_lstm_fwd_variants.py --compare-parent DIR

Builds ``remora_tpu_torch/csrc/lstm_fwd_mma.cu`` as it is and in variants
that each take one piece of a step away or make it cheaper (textual edits
of the source, made in a temporary directory), and times each at the main
path's shape (T = 1 and 124, B = 2048, C = H = 64; K1's last-only form and
K2 with cs) with CUDA events. The variants compute wrong numbers on
purpose: they are timings, never results. Prints the card's name, power
limit and SM clocks, each variant's registers, and the SASS instruction
mix of K1's 16-byte form. An edit that no longer matches the source stops
the script: update it with the kernel.

``--wide`` splits the step of the wide forward instead
(``lstm_wide.cu``'s ``wide_fwd_f32_kernel`` and ``wide_fwd_bf16_kernel``,
K2 with cs at T = 124, B = 2048, C = H = 96 and 128): as it is, without
the x product, without the h product, without the DSMEM exchange and the
cluster barrier (a CTA barrier in its place), without the gate math, and
without the hs/cs stores; registers and spills per variant.
``--f32`` splits the step of K1/K2's f32 kernel (``lstm_fwd_f32.cu``, K2
with cs and K1 at the main shape): as it is, without the x product,
without the h product, without the ring that adds the k groups' sums,
without the gate math, without the hs/cs stores, and with the sigmoid's
reciprocal by ``__frcp_rn`` (whose out-of-range branch the kernel
avoids).
``--general`` splits the step of the general forward's cluster path
(``lstm_general_cluster.cu``'s ``cluster_fwd_bf16_kernel`` and
``cluster_fwd_f32_kernel``, K2 with cs at T = 124, B = 2048 and C = H =
160 and 256 where ``kernels.lstm.general_fwd_plan`` takes the shape, at
the plan's cluster size and rows): as it is, without the x product,
without the h product, without the DSMEM exchange and the cluster
barriers (CTA barriers in their place, h_t into the CTA's own tile),
without the gate math, and without the hs/cs stores; registers and spills
per variant.
``--compare-parent DIR`` times the main-shape f32 K1 and K2 (with cs; T =
124, B = 2048, C = H = 64), the wide K1 and K2 (with cs) and the general
K1 and K2 (with cs) of the parent checkout at DIR and of this one in one
call, parent / this / this / parent, beside cuDNN's forward
(``torch.nn.LSTM``), the wide legs at C = H = 96 and 128 and the general
ones at 160 and 256, f32 and bf16, each design's library called on
preallocated buffers and weight layouts, and prints how far the two
designs' outputs differ.

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


WIDE_SOURCE = "lstm_wide.cu"
_BF16_GATES = (
    "          const float ig = sigmoid(acc[0][2 * s] + bias[0]);\n"
    "          const float fg = sigmoid(acc[0][2 * s + 1] + bias[1]);\n"
    "          const float gg = tanhf(acc[1][2 * s] + bias[2]);\n"
    "          const float og = sigmoid(acc[1][2 * s + 1] + bias[3]);\n")
_F32_GATES = (
    "          const float ig = sigmoid(z[4 * v] + bias[4 * v]);\n"
    "          const float fg = sigmoid(z[4 * v + 1] + bias[4 * v + 1]);\n"
    "          const float gg = tanhf(z[4 * v + 2] + bias[4 * v + 2]);\n"
    "          const float og = sigmoid(z[4 * v + 3] + bias[4 * v + 3]);\n")
# (old, new) textual edits of lstm_wide.cu; each edits both kernels where
# both have the piece
WIDE_EDITS = {
    "no_x_product": [
        ("      x_product(t + 1, accx);\n", ""),
        ("      tile_fma<true>(accx, xs + ((t + 1) % kStagesF32) * x_tile",
         "      if (false) tile_fma<true>(accx, xs + ((t + 1) % kStagesF32) "
         "* x_tile")],
    "no_h_product": [
        ("            mma_16816(acc[0], a, wh[kt][0]);\n"
         "            mma_16816(acc[1], a, wh[kt][1]);\n",
         "            acc[0][0] += __uint_as_float(a[0]);\n"),
        ("      tile_fma<false>(acc, hb + (t & 1) * h_tile + r0 * ldh, ldh, "
         "wh, ldw,", "      if (false) tile_fma<false>(acc, hb + (t & 1) * "
         "h_tile + r0 * ldh, ldh, wh, ldw,")],
    "no_exchange": [
        ("h_dst[r] = cluster.map_shared_rank(hb, r);", "h_dst[r] = hb;"),
        ("h_dst[r] = map_rank(smem_u32(hb), r);",
         "h_dst[r] = map_rank(smem_u32(hb), rank);"),
        ("    cluster_arrive();\n", ""),
        ("    cluster_wait();  // h_t of every unit is in this CTA's tile",
         "    __syncthreads();")],
    "no_gate_math": [
        (_BF16_GATES,
         "          const float ig = acc[0][2 * s] * 1e-3f;\n"
         "          const float fg = acc[0][2 * s + 1] * 1e-3f;\n"
         "          const float gg = acc[1][2 * s] * 1e-3f;\n"
         "          const float og = acc[1][2 * s + 1] * 1e-3f;\n"),
        ("to_bf16(og * tanhf(cc))", "to_bf16(og * cc)"),
        (_F32_GATES,
         "          const float ig = z[4 * v] * 1e-3f;\n"
         "          const float fg = z[4 * v + 1] * 1e-3f;\n"
         "          const float gg = z[4 * v + 2] * 1e-3f;\n"
         "          const float og = z[4 * v + 3] * 1e-3f;\n"),
        ("h[v] = og * tanhf(c[i][v]);", "h[v] = og * c[i][v];")],
    "no_stores": [
        ("    if (kSeq && t > 0) copy_out(t - 1, (long long)(t - 1) * B + "
         "b0);\n", ""),
        ("        if (kSeq && row < B && u0 < H) {",
         "        if (false) {")],
}
WIDE_VARIANTS = {
    "as is": [],
    "no x product": WIDE_EDITS["no_x_product"],
    "no h product": WIDE_EDITS["no_h_product"],
    "no DSMEM exchange, no cluster barrier": WIDE_EDITS["no_exchange"],
    "no gate math": WIDE_EDITS["no_gate_math"],
    "no hs/cs stores": WIDE_EDITS["no_stores"],
}


def ptxas_lines(out, kernel):
    """'registers / spill bytes' of each instantiation of ``kernel`` in an
    ``nvcc -Xptxas=-v`` output."""
    found, name = [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line) or \
            re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1)
            continue
        if name is None or kernel not in name:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            found.append(f"spill {m.group(1)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.append(f"{m.group(1)} regs")
    return ", ".join(found)


def _typed_wide(lib):
    """``lib`` (an ``lstm_wide.cu`` library) with its two launchers typed."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lstm_wide_fwd.argtypes = [i32] + [ptr] * 5 + [i32] * 4 + [ptr]
    lib.lstm_wide_fwd.restype = i32
    lib.lstm_wide_last.argtypes = [i32] + [ptr] * 4 + [i32] * 4 + [ptr]
    lib.lstm_wide_last.restype = i32
    return lib


def split_wide():
    """Each variant of the wide forward, K2 with cs, both dtypes, at T =
    124, B = 2048, C = H = 96 and 128."""
    import torch

    sys.path.insert(0, REPO)
    from remora_tpu_torch.kernels import lstm as K

    _, built = build_variants(WIDE_SOURCE, WIDE_VARIANTS,
                              headers=("mma_sm90.cuh",))
    stream = torch.cuda.current_stream().cuda_stream
    libs = {name: (_typed_wide(ctypes.CDLL(path)), out)
            for name, (path, out) in built.items()}
    T, B = 124, 2048
    for width in (96, 128):
        for dtype, flag in ((torch.float32, 0), (torch.bfloat16, 1)):
            gen = torch.Generator(device="cuda").manual_seed(width)
            x = torch.randn((T, B, width), device="cuda",
                            generator=gen).to(dtype)
            w = ((torch.rand((2 * width + 1, 4 * width), device="cuda",
                             generator=gen) * 2 - 1) / width ** 0.5).to(dtype)
            w_il = None if flag else K.wide_fwd_weights(w, width)
            w_il_ptr = None if w_il is None else w_il.data_ptr()
            hs = torch.empty((T, B, width), device="cuda", dtype=dtype)
            cs = torch.empty_like(hs)
            sfx = "bf16" if flag else "f32"
            for name, (lib, out) in libs.items():
                def call(lib=lib, name=name):
                    err = lib.lstm_wide_fwd(
                        flag, x.data_ptr(), w.data_ptr(), w_il_ptr,
                        hs.data_ptr(), cs.data_ptr(), T, B, width, width,
                        stream)
                    if err != 0:
                        raise SystemExit(f"{name!r}: launch error {err}")
                ms = time_ms(call)
                print(f"wide K2 {sfx} T={T} C=H={width} {name}: {ms:.4f} ms "
                      f"({ms / T * 1e3:.3f} us a step); "
                      f"{ptxas_lines(out, f'wide_fwd_{sfx}_kernel')}",
                      flush=True)


def compare_wide(parent_dir):
    """The wide K1 and K2 (with cs) in one call, parent / this design / this
    design / parent, beside cuDNN's forward (``torch.nn.LSTM``, all T hidden
    states; a yardstick the port never calls), at T = 124, B = 2048 and C =
    H = 96 and 128, f32 and bf16; each design's library called directly on
    preallocated buffers and its own weight layout (the parent's: W_aug[:C +
    H] interleaved by unit, (C + H, H, 4))."""
    import torch

    sys.path.insert(0, REPO)
    from remora_tpu_torch.kernels import lstm as K

    _, built = build_variants(WIDE_SOURCE, {"parent": []},
                              headers=("mma_sm90.cuh",), csrc=os.path.join(
                                  parent_dir, "remora_tpu_torch", "csrc"))
    parent = _typed_wide(ctypes.CDLL(built["parent"][0]))
    change = K._wide_library()
    stream = torch.cuda.current_stream().cuda_stream
    T, B = 124, 2048
    for width in (96, 128):
        C = H = width
        for dtype in (torch.float32, torch.bfloat16):
            flag = int(dtype == torch.bfloat16)
            gen = torch.Generator(device="cuda").manual_seed(width)
            bound = 1.0 / H ** 0.5
            lib_lstm = torch.nn.LSTM(C, H).cuda()
            with torch.no_grad():
                for prm in lib_lstm.parameters():
                    prm.uniform_(-bound, bound, generator=gen)
            lib_lstm = lib_lstm.to(dtype)
            lib_lstm.flatten_parameters()
            params = {"w_ih": lib_lstm.weight_ih_l0.detach(),
                      "w_hh": lib_lstm.weight_hh_l0.detach(),
                      "b_ih": lib_lstm.bias_ih_l0.detach(),
                      "b_hh": lib_lstm.bias_hh_l0.detach()}
            x = torch.randn((T, B, C), device="cuda", generator=gen).to(dtype)
            w = K.make_w_aug(params, dtype)
            layouts = {
                "parent": w[:C + H].reshape(C + H, 4, H).transpose(
                    1, 2).contiguous(),
                "change": None if flag else K.wide_fwd_weights(w, C)}
            outs = {}
            for name, lib in (("parent", parent), ("change", change)):
                w_il = layouts[name]
                w_il_ptr = None if w_il is None else w_il.data_ptr()
                hs = torch.empty((T, B, H), device="cuda", dtype=dtype)
                cs = torch.empty_like(hs)
                last = torch.empty((B, H), device="cuda", dtype=dtype)

                def k2(lib=lib, w_il_ptr=w_il_ptr, hs=hs, cs=cs):
                    err = lib.lstm_wide_fwd(flag, x.data_ptr(), w.data_ptr(),
                                            w_il_ptr, hs.data_ptr(),
                                            cs.data_ptr(), T, B, C, H, stream)
                    if err != 0:
                        raise SystemExit(f"launch error {err}")

                def k1(lib=lib, w_il_ptr=w_il_ptr, last=last):
                    err = lib.lstm_wide_last(flag, x.data_ptr(),
                                             w.data_ptr(), w_il_ptr,
                                             last.data_ptr(), T, B, C, H,
                                             stream)
                    if err != 0:
                        raise SystemExit(f"launch error {err}")
                outs[name] = k1, k2, hs, cs, last
            ms = {}
            for leg, idx in (("K1", 0), ("K2", 1)):
                for name in ("parent", "change", "change", "parent"):
                    ms.setdefault((leg, name), []).append(
                        time_ms(outs[name][idx]))
            with torch.no_grad():
                cudnn = time_ms(lambda: lib_lstm(x))
            for name in ("parent", "change"):
                outs[name][0]()
                outs[name][1]()
            torch.cuda.synchronize()
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(outs["parent"][2:], outs["change"][2:]))
            sfx = "f32" if flag == 0 else "bf16"
            for leg in ("K1", "K2"):
                p, c = ms[(leg, "parent")], ms[(leg, "change")]
                print(f"wide {leg} {sfx} C=H={width}: parent / change / "
                      f"change / parent {p[0]:.4f} / {c[0]:.4f} / "
                      f"{c[1]:.4f} / {p[1]:.4f} ms; cuDNN forward "
                      f"{cudnn:.4f} ms", flush=True)
            print(f"wide {sfx} C=H={width}: the designs' hs, cs, h_(T-1) "
                  f"differ by at most {diff:.3e}", flush=True)


GENERAL_SOURCE = "lstm_general_cluster.cu"
# (old, new) textual edits of lstm_general_cluster.cu; each edits both
# kernels (str.replace takes every match)
GENERAL_EDITS = {
    # (resident: nor x_1's request in the prologue's step, so no copy is in
    # flight when the kernel ends)
    "no_x_product": [
        ("      x_product(t + 1, acc);  // off the chain, while h_t crosses\n",
         ""),
        ("      if (s + 1 < nsteps) load_x(s + 1);",
         "      if (false) load_x(s + 1);"),
        ("      if (threadIdx.x == 0 && s + 1 < nsteps) {",
         "      if (false) {")],
    "no_h_product": [
        ("    for (int kt = 0; kt < nkh; ++kt) {",
         "    for (int kt = 0; kt < 0; ++kt) {"),
        ("    tile(acc, hb + (32 * rw + rq) * ldh, ldh, whs + col0, kh / 4);",
         "    tile(acc, hb + (32 * rw + rq) * ldh, ldh, whs + col0, 0);")],
    "no_exchange": [
        ("    cluster_arrive();  // (A) this CTA is done reading h_{t-1}\n",
         ""),
        ("    cluster_wait();  // (A) every CTA is done reading h_{t-1}",
         "    __syncthreads();"),
        ("      cluster_arrive();  // (B) h_t is published\n", ""),
        ("      cluster_wait();  // (B) h_t of every unit is in this CTA's "
         "tile", "      __syncthreads();"),
        ("for (int r = 0; r < N; ++r) {", "for (int r = 0; r < 1; ++r) {"),
        ("map_rank(h_off, r)", "map_rank(h_off, rank)")],
    "no_gate_math": [
        ("sigmoid(acc[", "(1e-3f * acc["),
        ("tanhf(acc[", "(1e-3f * acc["),
        ("hv[v] = og * tanhf(cv[v]);", "hv[v] = og * cv[v];"),
        ("hv[i][v] = og * tanhf(c[i][v]);", "hv[i][v] = og * c[i][v];")],
    # (resident: nor the wait for them, which would never end)
    "no_operand_loads": [
        ("      if (qn < nsteps * cfg.nkx) load(qn, slot(qn % cfg.S));",
         "      if (false) load(qn, slot(qn % cfg.S));"),
        ("        mbar_wait(bar(), (uint32_t)(s & 1));  // x_s is in",
         "        if (s == 0) mbar_wait(bar(), 0u);"),
        ("      if (s + 1 < nsteps) load_x(s + 1);",
         "      if (false) load_x(s + 1);"),
        ("      if (threadIdx.x == 0 && s + 1 < nsteps) {",
         "      if (false) {")],
    "no_operand_barriers": [
        ("      __syncthreads();  // chunk q is in; every thread is done with "
         "q - 1", ""),
        ("      __syncthreads();  // every thread is done with x_s", "")],
    "w_x_once": [
        ("    for (int e = tid; e < 2 * G; e += blockDim.x) {",
         "    for (int e = tid; e < (qc < cfg.S ? 2 * G : 0); e += "
         "blockDim.x) {"),
        ("    for (int e = tid; e < kChunk * hh; e += blockDim.x) {",
         "    for (int e = tid; e < (qc < cfg.S ? kChunk * hh : 0); e += "
         "blockDim.x) {")],
    "x_once": [("    const bf16_bits* src = x + ((size_t)s * B + b0) * C;\n"
                "    if (kVec) {",
                "    const bf16_bits* src = x + ((size_t)s * B + b0) * C;\n"
                "    if (qc >= cfg.S) return;\n    if (kVec) {"),
               ("    const float* src = x + ((size_t)s * B + b0) * C;\n"
                "    if (kVec) {",
                "    const float* src = x + ((size_t)s * B + b0) * C;\n"
                "    if (qc >= cfg.S) return;\n    if (kVec) {")],
    "no_stores": [("      if (u_ok && row < B) {", "      if (false) {"),
                  ("      if (!kLast && u0 < H && row_ok) {",
                   "      if (false) {")],
}
GENERAL_VARIANTS = {
    "as is": [],
    "no x product": GENERAL_EDITS["no_x_product"],
    "no h product": GENERAL_EDITS["no_h_product"],
    "no DSMEM exchange, no cluster barriers": GENERAL_EDITS["no_exchange"],
    "no gate math": GENERAL_EDITS["no_gate_math"],
    "no hs/cs stores": GENERAL_EDITS["no_stores"],
    "x product without its operands' loads": GENERAL_EDITS["no_operand_loads"],
    "x product without its operands' CTA barriers":
        GENERAL_EDITS["no_operand_barriers"],
    "x product with W_x loaded once (streaming)": GENERAL_EDITS["w_x_once"],
    "x product with x loaded once (streaming)": GENERAL_EDITS["x_once"],
}


def _typed_cluster(lib):
    """``lib`` (an ``lstm_general_cluster.cu`` library) with its launcher
    typed."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lstm_general_cluster_fwd.argtypes = ([i32] + [ptr] * 5 + [i32] * 6
                                             + [ptr])
    lib.lstm_general_cluster_fwd.restype = i32
    return lib


def _general_case(width, dtype):
    """(x, W_aug) of a general forward at T = 124, B = 2048, C = H =
    width, seeded on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(width)
    x = torch.randn((124, 2048, width), device="cuda", generator=gen)
    w = (torch.rand((2 * width + 1, 4 * width), device="cuda",
                    generator=gen) * 2 - 1) / width ** 0.5
    return x.to(dtype), w.to(dtype)


def split_general():
    """Each variant of the general forward's cluster path, K2 with cs, at T
    = 124, B = 2048, C = H = 160 and 256 in each dtype the plan takes
    there, at the plan's N and R on this card, and the kernel as it is at
    every other one-wave (N, R) whose CTA fits."""
    import torch

    sys.path.insert(0, REPO)
    from remora_tpu_torch.kernels import lstm as K

    _, built = build_variants(GENERAL_SOURCE, GENERAL_VARIANTS,
                              headers=("mma_sm90.cuh",))
    stream = torch.cuda.current_stream().cuda_stream
    libs = {name: (_typed_cluster(ctypes.CDLL(path)), out)
            for name, (path, out) in built.items()}
    caps = K.cluster_capacity(0)
    print(f"clusters the card holds: {caps}", flush=True)
    T, B = 124, 2048
    for width in (160, 256):
        for dtype, flag in ((torch.float32, 0), (torch.bfloat16, 1)):
            sfx = "bf16" if flag else "f32"
            plan = K.general_fwd_plan(width, width, dtype, caps)
            if plan is None:
                print(f"general K2 {sfx} C=H={width}: the plan refuses it "
                      "(streaming path)", flush=True)
                continue
            x, w = _general_case(width, dtype)
            hs = torch.empty((T, B, width), device="cuda", dtype=dtype)
            cs = torch.empty_like(hs)
            shapes = [plan[:2]]  # the plan's first, then the other N
            for n in (2, 4, 8):
                r = -(-(-(-B // caps[n])) // 32) * 32
                if n != plan[0] and K.general_fwd_cfg(width, width, dtype, n,
                                                      r) is not None:
                    shapes.append((n, r))
            for N, R in shapes:
                cfg = K.general_fwd_cfg(width, width, dtype, N, R)
                wl = K.general_fwd_weights(w, width, N, cfg["hh"])
                tag = (f"general K2 {sfx} T={T} C=H={width} N={N} R={R} "
                       f"({cfg['smem']} B shared, {cfg['slots']} slots, W_x "
                       f"{'resident' if cfg['resident'] else 'streamed'}"
                       f"{'' if (N, R) == plan[:2] else '; not the plan'})")
                names = libs if (N, R) == plan[:2] else ["as is"]
                for name in names:
                    lib, out = libs[name]

                    def call(lib=lib, name=name):
                        err = lib.lstm_general_cluster_fwd(
                            flag, x.data_ptr(), wl.data_ptr(), hs.data_ptr(),
                            cs.data_ptr(), None, T, B, width, width, N, R,
                            stream)
                        if err != 0:
                            raise SystemExit(f"{name!r}: launch error {err}")
                    ms = time_ms(call, n=7, calls=3)
                    kernel = f"cluster_fwd_{sfx}" + (
                        "_x2" if cfg["ub"] == 2 else "")
                    regs = ptxas_lines(out, kernel + "_kernelILb0ELb1E")
                    print(f"{tag} {name}: {ms:.4f} ms ({ms / T * 1e3:.3f} us "
                          f"a step); {regs}", flush=True)


def _typed_general(lib):
    """``lib`` (an ``lstm_general.cu`` library) with its two forward
    launchers typed."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lstm_general_fwd.argtypes = [i32] + [ptr] * 4 + [i32] * 4 + [ptr]
    lib.lstm_general_fwd.restype = i32
    lib.lstm_general_last.argtypes = [i32] + [ptr] * 3 + [i32] * 4 + [ptr]
    lib.lstm_general_last.restype = i32
    return lib


def compare_general(parent_dir):
    """The general K1 and K2 (with cs) in one call, parent / this design /
    this design / parent, beside cuDNN's forward (``torch.nn.LSTM``, all T
    hidden states; a yardstick the port never calls), at T = 124, B = 2048
    and C = H = 160 and 256, f32 and bf16: the parent's ``lstm_general.cu``
    (the streaming ``general_fwd_kernel`` for every shape, on its (C + H +
    1, H, 4) layout) against this checkout's path (the cluster kernel at
    the plan's N and R on ``general_fwd_weights``' layout, or the streaming
    kernel where the plan refuses the shape), each library called directly
    on preallocated buffers and its layout."""
    import torch

    sys.path.insert(0, REPO)
    from remora_tpu_torch.kernels import lstm as K

    _, built = build_variants("lstm_general.cu", {"parent": []},
                              headers=("lstm_prod.cuh", "mma_sm90.cuh"),
                              csrc=os.path.join(parent_dir, "remora_tpu_torch",
                                                "csrc"))
    parent = _typed_general(ctypes.CDLL(built["parent"][0]))
    streaming = K._general_library()
    cluster = K._cluster_library()
    caps = K.cluster_capacity(0)
    stream = torch.cuda.current_stream().cuda_stream
    T, B = 124, 2048
    for width in (160, 256):
        C = H = width
        for dtype in (torch.float32, torch.bfloat16):
            flag = int(dtype == torch.bfloat16)
            sfx = "bf16" if flag else "f32"
            gen = torch.Generator(device="cuda").manual_seed(width)
            bound = 1.0 / H ** 0.5
            lib_lstm = torch.nn.LSTM(C, H).cuda()
            with torch.no_grad():
                for prm in lib_lstm.parameters():
                    prm.uniform_(-bound, bound, generator=gen)
            lib_lstm = lib_lstm.to(dtype)
            lib_lstm.flatten_parameters()
            params = {"w_ih": lib_lstm.weight_ih_l0.detach(),
                      "w_hh": lib_lstm.weight_hh_l0.detach(),
                      "b_ih": lib_lstm.bias_ih_l0.detach(),
                      "b_hh": lib_lstm.bias_hh_l0.detach()}
            x = torch.randn((T, B, C), device="cuda", generator=gen).to(dtype)
            w = K.make_w_aug(params, dtype)
            w_il = K.general_weights(w)
            plan = K.general_fwd_plan(C, H, dtype, caps)
            launchers = {"parent": (parent, w_il, None)}
            if plan is None:
                launchers["change"] = (streaming, w_il, None)
                tag = "stream"
            else:
                N, R, _ = plan
                launchers["change"] = (cluster, K.general_fwd_weights(
                    w, C, N, K.general_fwd_cfg(C, H, dtype, N, R)["hh"]),
                    (N, R))
                tag = f"cluster N={N} R={R}"
            outs = {}
            for name, (lib, wl, nr) in launchers.items():
                hs = torch.empty((T, B, H), device="cuda", dtype=dtype)
                cs = torch.empty_like(hs)
                last = torch.empty((B, H), device="cuda", dtype=dtype)

                def k2(lib=lib, wl=wl, nr=nr, hs=hs, cs=cs):
                    err = (lib.lstm_general_fwd(
                        flag, x.data_ptr(), wl.data_ptr(), hs.data_ptr(),
                        cs.data_ptr(), T, B, C, H, stream) if nr is None
                        else lib.lstm_general_cluster_fwd(
                            flag, x.data_ptr(), wl.data_ptr(), hs.data_ptr(),
                            cs.data_ptr(), None, T, B, C, H, *nr, stream))
                    if err != 0:
                        raise SystemExit(f"launch error {err}")

                def k1(lib=lib, wl=wl, nr=nr, last=last):
                    err = (lib.lstm_general_last(
                        flag, x.data_ptr(), wl.data_ptr(), last.data_ptr(),
                        T, B, C, H, stream) if nr is None
                        else lib.lstm_general_cluster_fwd(
                            flag, x.data_ptr(), wl.data_ptr(), None, None,
                            last.data_ptr(), T, B, C, H, *nr, stream))
                    if err != 0:
                        raise SystemExit(f"launch error {err}")
                outs[name] = k1, k2, hs, cs, last
            ms = {}
            for leg, idx in (("K1", 0), ("K2", 1)):
                for name in ("parent", "change", "change", "parent"):
                    ms.setdefault((leg, name), []).append(
                        time_ms(outs[name][idx], n=7, calls=3))
            with torch.no_grad():
                cudnn = time_ms(lambda: lib_lstm(x), n=7, calls=3)
            for name in ("parent", "change"):
                outs[name][0]()
                outs[name][1]()
            torch.cuda.synchronize()
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(outs["parent"][2:], outs["change"][2:]))
            for leg in ("K1", "K2"):
                p, c = ms[(leg, "parent")], ms[(leg, "change")]
                print(f"general {leg} {sfx} C=H={width} ({tag}): parent / "
                      f"change / change / parent {p[0]:.4f} / {c[0]:.4f} / "
                      f"{c[1]:.4f} / {p[1]:.4f} ms; cuDNN forward "
                      f"{cudnn:.4f} ms", flush=True)
            print(f"general {sfx} C=H={width}: the designs' hs, cs, h_(T-1) "
                  f"differ by at most {diff:.3e}", flush=True)


F32_SOURCE = "lstm_fwd_f32.cu"
# (old, new) textual edits of lstm_fwd_f32.cu
# (old, new) textual edits of lstm_fwd_f32.cu
_F32_NO_X = (
    "            pass_fma<true>(acc, a, w, bias);  // the bias once, in row kg\n",
    "            for (int j = 0; j < 8; ++j) {\n"
    "              acc[0][j] = bias[j];\n"
    "              acc[1][j] = acc[2][j] = acc[3][j] = 0.f;\n"
    "            }\n")
_F32_NO_H = (
    "        pass_fma<true>(acc, a, w, xsum);\n",
    "        for (int j = 0; j < 8; ++j) {\n"
    "          acc[0][j] = xsum[j];\n"
    "          acc[1][j] = acc[2][j] = acc[3][j] = 0.f;\n"
    "        }\n")
# (old, new) textual edits of lstm_fwd_f32.cu
F32_EDITS = {
    "no_x_product": [("          pass_fma(acc, a, w);\n", "")],
    "no_h_product": [("kKs * kg;\n      pass_fma(acc, a, w);\n",
                      "kKs * kg;\n")],
    "no_ring": [
        ("        ring_reduce(acc, s, src);\n",
         "        for (int j = 0; j < 8; ++j)\n"
         "          s[j] = acc[0][j] + acc[1][j] + acc[2][j] + acc[3][j];\n"),
        ("      ring_reduce(acc, z[3], src);\n",
         "      for (int j = 0; j < 8; ++j)\n"
         "        z[3][j] = acc[0][j] + acc[1][j] + acc[2][j] + acc[3][j];\n")],
    "no_gate_math": [
        ("        const float ig = sigmoid(z[ps][4 * v]);\n"
         "        const float fg = sigmoid(z[ps][4 * v + 1]);\n"
         "        const float gg = tanhf(z[ps][4 * v + 2]);\n"
         "        const float og = sigmoid(z[ps][4 * v + 3]);\n",
         "        const float ig = z[ps][4 * v] * 1e-3f;\n"
         "        const float fg = z[ps][4 * v + 1] * 1e-3f;\n"
         "        const float gg = z[ps][4 * v + 2] * 1e-3f;\n"
         "        const float og = z[ps][4 * v + 3] * 1e-3f;\n"),
        ("h[v] = og * tanhf(c[ps][v]);", "h[v] = og * c[ps][v];")],
    "frcp_rn": [
        ("  const float x = fminf(1.0f + expf(-z), 0x1.fffffep125f);\n"
         "  float r;\n"
         "  asm(\"rcp.approx.ftz.f32 %0, %1;\" : \"=f\"(r) : \"f\"(x));\n"
         "  return fmaf(r, -fmaf(x, r, -1.0f), r);\n",
         "  return __frcp_rn(1.0f + expf(-z));\n")],
    "no_stores": [
        ("      if (kSeq && t >= 2) {\n"
         "        const size_t o = ((size_t)(t - 2) * B + b0) * H;",
         "      if (false) {\n"
         "        const size_t o = ((size_t)(t - 2) * B + b0) * H;")],
}
F32_VARIANTS = {
    "as is": [],
    "no x product": F32_EDITS["no_x_product"],
    "no h product": F32_EDITS["no_h_product"],
    "no ring of k-group sums": F32_EDITS["no_ring"],
    "no gate math": F32_EDITS["no_gate_math"],
    "no hs/cs stores": F32_EDITS["no_stores"],
    "sigmoid by __frcp_rn": F32_EDITS["frcp_rn"],
}


def _typed_f32(lib):
    """``lib`` (an ``lstm_fwd_f32.cu`` library) with its launchers typed."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lstm_fwd_f32.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.lstm_fwd_f32.restype = i32
    lib.lstm_fwd_f32_last.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.lstm_fwd_f32_last.restype = i32
    return lib


def split_f32(variants=None, csrc=CSRC):
    """Each variant of K1/K2's f32 kernel (``lstm_fwd_f32.cu``), K2 with cs
    and K1, at the main shape (T = 124, B = 2048, C = H = 64)."""
    import torch

    _, built = build_variants(F32_SOURCE, variants or F32_VARIANTS,
                              headers=("mma_sm90.cuh",), csrc=csrc)
    stream = torch.cuda.current_stream().cuda_stream
    T, B, C, H = 124, 2048, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((T, B, C), device="cuda", generator=gen)
    w = (torch.rand((C + H + 1, 4 * H), device="cuda", generator=gen) * 2
         - 1) / H ** 0.5
    hs = torch.empty((T, B, H), device="cuda")
    cs = torch.empty_like(hs)
    out = torch.empty((B, H), device="cuda")
    for name, (path, log) in built.items():
        lib = _typed_f32(ctypes.CDLL(path))

        def k2(lib=lib):
            err = lib.lstm_fwd_f32(x.data_ptr(), w.data_ptr(), hs.data_ptr(),
                                   cs.data_ptr(), T, B, C, H, stream)
            if err != 0:
                raise SystemExit(f"{name!r}: launch error {err}")

        def k1(lib=lib):
            err = lib.lstm_fwd_f32_last(x.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), T, B, C, H, stream)
            if err != 0:
                raise SystemExit(f"{name!r}: launch error {err}")
        ms2, ms1 = time_ms(k2), time_ms(k1)
        regs = ptxas_lines(log, "lstm_fwd_f32_kernelILi64ELi64E")
        print(f"f32 K2 T={T} C=H={C} {name}: {ms2:.4f} ms ({ms2 / T * 1e3:.3f}"
              f" us a step); K1 {ms1:.4f} ms; main shape's instantiations "
              f"{regs}", flush=True)


def _parent_f32_launchers(parent_dir):
    """(K2 with cs, K1) launchers of the parent checkout's f32 forward, each
    (x, w_aug, out(s)..., T, B, C, H, stream): ``lstm_fwd_f32.cu`` where the
    parent has it, else the two kernels it replaced (``lstm_train.cu``'s
    ``lstm_fwd_f32``, ``lstm_last.cu``'s ``lstm_last_f32``)."""
    csrc = os.path.join(parent_dir, "remora_tpu_torch", "csrc")
    if os.path.exists(os.path.join(csrc, F32_SOURCE)):
        _, built = build_variants(F32_SOURCE, {"parent": []},
                                  headers=("mma_sm90.cuh",), csrc=csrc)
        lib = _typed_f32(ctypes.CDLL(built["parent"][0]))
        return lib.lstm_fwd_f32, lib.lstm_fwd_f32_last
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = []
    for source, fn, n_ptr in (("lstm_train.cu", "lstm_fwd_f32", 4),
                              ("lstm_last.cu", "lstm_last_f32", 3)):
        _, built = build_variants(source, {"parent": []}, csrc=csrc)
        launcher = getattr(ctypes.CDLL(built["parent"][0]), fn)
        launcher.argtypes = [ptr] * n_ptr + [i32] * 4 + [ptr]
        launcher.restype = i32
        libs.append(launcher)
    return tuple(libs)


def compare_main(parent_dir):
    """The main-shape f32 K2 (with cs) and K1 (T = 124, B = 2048, C = H =
    64) in one call, parent / this design / this design / parent, beside
    cuDNN's forward (``torch.nn.LSTM``, all T hidden states; a yardstick the
    port never calls), each design's launcher called on preallocated
    buffers and W_aug; prints how far the designs' outputs differ."""
    import torch

    sys.path.insert(0, REPO)
    from remora_tpu_torch.kernels import lstm as K

    launchers = {"parent": _parent_f32_launchers(parent_dir)}
    lib = K._f32_fwd_library()
    launchers["change"] = lib.lstm_fwd_f32, lib.lstm_fwd_f32_last
    stream = torch.cuda.current_stream().cuda_stream
    T, B, C, H = 124, 2048, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(C)
    bound = 1.0 / H ** 0.5
    lib_lstm = torch.nn.LSTM(C, H).cuda()
    with torch.no_grad():
        for prm in lib_lstm.parameters():
            prm.uniform_(-bound, bound, generator=gen)
    lib_lstm.flatten_parameters()
    params = {"w_ih": lib_lstm.weight_ih_l0.detach(),
              "w_hh": lib_lstm.weight_hh_l0.detach(),
              "b_ih": lib_lstm.bias_ih_l0.detach(),
              "b_hh": lib_lstm.bias_hh_l0.detach()}
    x = torch.randn((T, B, C), device="cuda", generator=gen)
    w = K.make_w_aug(params, torch.float32)
    outs = {}
    for name, (k2_fn, k1_fn) in launchers.items():
        hs = torch.empty((T, B, H), device="cuda")
        cs = torch.empty_like(hs)
        last = torch.empty((B, H), device="cuda")

        def k2(fn=k2_fn, hs=hs, cs=cs):
            err = fn(x.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                     T, B, C, H, stream)
            if err != 0:
                raise SystemExit(f"launch error {err}")

        def k1(fn=k1_fn, last=last):
            err = fn(x.data_ptr(), w.data_ptr(), last.data_ptr(), T, B, C, H,
                     stream)
            if err != 0:
                raise SystemExit(f"launch error {err}")
        outs[name] = k1, k2, hs, cs, last
    ms = {}
    for leg, idx in (("K1", 0), ("K2", 1)):
        for name in ("parent", "change", "change", "parent"):
            ms.setdefault((leg, name), []).append(time_ms(outs[name][idx]))
    with torch.no_grad():
        cudnn = time_ms(lambda: lib_lstm(x))
    for name in ("parent", "change"):
        outs[name][0]()
        outs[name][1]()
    torch.cuda.synchronize()
    diff = max((a - b).abs().max().item()
               for a, b in zip(outs["parent"][2:], outs["change"][2:]))
    for leg in ("K1", "K2"):
        p, c = ms[(leg, "parent")], ms[(leg, "change")]
        print(f"main {leg} f32 C=H={C}: parent / change / change / parent "
              f"{p[0]:.4f} / {c[0]:.4f} / {c[1]:.4f} / {p[1]:.4f} ms; cuDNN "
              f"forward {cudnn:.4f} ms", flush=True)
    print(f"main f32 C=H={C}: the designs' hs, cs, h_(T-1) differ by at most "
          f"{diff:.3e}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_lstm_fwd_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args[:1] == ["--compare-parent"]:
        compare_main(args[1])
        compare_wide(args[1])
        compare_general(args[1])
        print(smi_line())
        return 0
    if args[:1] == ["--general"]:
        split_general()
        print(smi_line())
        return 0
    if args[:1] == ["--wide"]:
        split_wide()
        print(smi_line())
        return 0
    if args[:1] == ["--f32"]:
        split_f32()
        print(smi_line())
        return 0
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
