#!/usr/bin/env python3
"""Where the step time of K3's f32 kernel, and of the wide K3's reverse
recurrence, goes, on one NVIDIA GPU.

    python3 chip_lstm_bwd_variants.py
    python3 chip_lstm_bwd_variants.py --wide [--parent DIR]
    python3 chip_lstm_bwd_variants.py --compare-parent DIR

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

``--wide`` splits the wide K3's serial part instead
(``lstm_wide_bwd.cu::wide_rec_cluster_kernel``, the products' launches
edited away so that CUDA events time the recurrence alone) at T = 124, B
= 2048, C = H = 96 (the shape ConvLSTM_w_ref at size 96 gives it), f32
and bf16: as it is, without the gate phase's device loads, without
W_h^T's shared loads, without the shared dgates stores, without the
dgates' device stores, without the product's FMA (or HMMA) loop, and
without the DSMEM stores and the cluster barrier (a CTA barrier in its
place). With ``--parent DIR`` it first splits the parent design's
``lstm_wide.cu::wide_rec_kernel`` from the checkout at DIR (its own
edits, matched against that source). Prints registers and spills per
variant. ``--compare-parent DIR`` times the whole wide K3 of the parent
checkout at DIR and of this one in one call, parent / this / this /
parent, beside cuDNN's backward, at C = H = 96 and 128, f32 and bf16.

Imports nothing of JAX or of the JAX package ``remora_tpu``; the build,
timing and SASS helpers are ``chip_lstm_fwd_variants.py``'s.
"""

import ctypes
import os
import re
import sys

from chip_lstm_fwd_variants import CSRC, REPO, build_variants, sass_mix, \
    smi_line, time_ms

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


WIDE_SOURCE = "lstm_wide.cu"
# the parent design (one 256-thread block per 16 rows, W_h^T through L1/L2)
_PARENT_GATE_LOADS = (
    "          const float ig = sigmoid(__ldg(zm));\n"
    "          const float fg = sigmoid(__ldg(zm + H));\n"
    "          const float gg = tanhf(__ldg(zm + 2 * H));\n"
    "          const float og = sigmoid(__ldg(zm + 3 * H));\n"
    "          const float c_prev =\n"
    "              t > 0 ? load(cs + (m - B) * H + u) : 0.f;\n"
    "          const float tanh_c = tanhf(load(cs + m * H + u));\n"
    "          const float dh = load(dhs + m * H + u) + dh_c[i];")
_NO_LOADS = (
    "          const float zv = (float)((row + u + t) & 15) * 0.125f - 1.f;\n"
    "          const float ig = sigmoid(zv);\n"
    "          const float fg = sigmoid(zv + 0.25f);\n"
    "          const float gg = tanhf(zv - 0.25f);\n"
    "          const float og = sigmoid(zv + 0.5f);\n"
    "          const float c_prev = t > 0 ? zv * 0.5f : 0.f;\n"
    "          const float tanh_c = tanhf(zv * 0.75f);\n"
    "          const float dh = zv * 0.1f + dh_c[i];")
PARENT_EDITS = {
    "rec_only": [("  launch_prod<kGates>(p, chunks, s);\n", ""),
                 ("  launch_prod<kDx>(p, chunks, s);\n"
                  "  launch_prod<kDw>(p, chunks, s);\n", ""),
                 ("  launch_ordered_sum<0>(p.partials, "
                  "static_cast<float*>(dw), chunks, n, s);\n", "")],
    "no_gate_loads": [(_PARENT_GATE_LOADS, _NO_LOADS)],
    "no_w_loads": [("const float wv = load(wg);",
                    "const float wv = (float)(g & 7) * 0.01f;")],
    "no_smem_stores": [("        bi[0] = q0;\n"
                        "        bi[H * kRows] = q1;\n"
                        "        bi[2 * H * kRows] = q2;\n"
                        "        bi[3 * H * kRows] = q3;\n", "")],
    "no_dg_stores": [("          dgm[0] = narrow<T>(q0);\n"
                      "          dgm[H] = narrow<T>(q1);\n"
                      "          dgm[2 * H] = narrow<T>(q2);\n"
                      "          dgm[3 * H] = narrow<T>(q3);\n", "")],
    "no_fma": [("for (int g = 0; g < G; ++g, wg += H) {",
                "for (int g = 0; g < 0; ++g, wg += H) {")],
}
PARENT_KERNEL = "wide_rec_kernel"
# this design (lstm_wide_bwd.cu: a cluster of 2 CTAs per 32 rows, each
# CTA's slice of W_h^T in shared memory)
WIDE_BWD_SOURCE = "lstm_wide_bwd.cu"
WIDE_EDITS = {
    "rec_only": [
        ("  cudaError_t err = launch_prod<T, kGates>(p, chunks, s);\n"
         "  if (err != cudaSuccess) return (int)err;\n",
         "  cudaError_t err = cudaSuccess;\n"),
        ("  err = launch_prod<T, kDx>(p, chunks, s);\n"
         "  if (err != cudaSuccess) return (int)err;\n"
         "  err = launch_prod<T, kDw>(p, chunks, s);\n"
         "  if (err != cudaSuccess) return (int)err;\n", ""),
        ("  launch_ordered_sum<0>(p.partials, static_cast<float*>(dw), "
         "chunks,\n                        (C + H + 1) * 4 * H, s);\n", "")],
    "no_gate_loads": [(
        "        load_now(zn[i][g], z + m * G + g * H + u, ok[i]);\n",
        "        zn[i][g] = (float)((u + g + t) & 15) * 0.0625f;\n"),
        ("      load_now(cpn[i], cs + (m - B) * H + u, ok[i] && t > 0);\n"
         "      load_now(dhn[i], dhs + m * H + u, ok[i]);\n",
         "      cpn[i] = narrow<T>((float)((u + t) & 7) * 0.25f);\n"
         "      dhn[i] = narrow<T>((float)((u ^ t) & 7) * 0.1f);\n")],
    "no_w_loads": [
        ("      const float4 b = *reinterpret_cast<const float4*>(wrow + 32 "
         "* j);",
         "      const float4 b = make_float4(av[j], av[j + 1], 0.5f, "
         "0.25f);"),
        ("        ldsm_x4(r, smem_u32(ws + n * cfg.ldw + kk + ((lane >> 3) & "
         "1) * 8));",
         "        r[0] = a[0] + n; r[1] = a[1]; r[2] = a[2]; r[3] = a[3];")],
    "no_smem_stores": [
        ("          ds[dsw(g * hh + j, row)] = q[g];", ""),
        ("          ds[row * cfg.ldd + g * hh + j] = narrow<T>(q[g]);", "")],
    "no_dg_stores": [
        ("        for (int g = 0; g < 4; ++g) dgm[g * H] = narrow<T>(q[g]);",
         "")],
    "no_fma": [
        ("  for (int k = k0; k < k0 + kper; ++k) {",
         "  for (int k = k0; k < k0; ++k) {"),
        ("  for (int kk = 0; kk < cfg.kl; kk += 16) {",
         "  for (int kk = 0; kk < 0; kk += 16) {")],
    "no_cluster": [
        ("      dst[j] = theirs;", "      own[i] += theirs;"),
        ("    cluster_arrive();\n", ""),
        ("    cluster_wait();  // the partner's sums have landed; the tiles "
         "are free", "    __syncthreads();")],
}
WIDE_KERNEL = "wide_rec_cluster_kernel"


def _wide_variants(edits):
    base = edits["rec_only"]
    out = {
        "as is": base,
        "no gate-phase device loads": base + edits["no_gate_loads"],
        "no W_h^T loads": base + edits["no_w_loads"],
        "no shared dgates stores": base + edits["no_smem_stores"],
        "no dgates device stores": base + edits["no_dg_stores"],
        "no FMA loop": base + edits["no_fma"],
    }
    if "no_cluster" in edits:
        out["no DSMEM stores, no cluster barrier"] = base + edits[
            "no_cluster"]
    return out


def split_wide(label, csrc, edits, kernel, source):
    """Time each variant of the wide recurrence built from ``csrc``'s
    ``source``, both dtypes, at T = 124, B = 2048, C = H = 96."""
    import torch

    _, built = build_variants(source, _wide_variants(edits),
                              headers=("mma_sm90.cuh",), csrc=csrc)
    w_xt_arg = source == WIDE_BWD_SOURCE  # this design also takes W_x^T
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    T, B, C, H = 124, 2048, 96, 96
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn((T, B, 4 * H), device="cuda", generator=gen)
    for dtype, flag in ((torch.float32, 0), (torch.bfloat16, 1)):
        sfx = "f32" if flag == 0 else "bf16"
        x = torch.randn((T, B, C), device="cuda", generator=gen).to(dtype)
        w = (torch.rand((C + H + 1, 4 * H), device="cuda", generator=gen)
             * 0.2 - 0.1).to(dtype)
        w_ht = w[C:C + H].t().contiguous()
        w_xt = w[:C].t().contiguous()
        hs = (torch.rand((T, B, H), device="cuda", generator=gen) * 2
              - 1).to(dtype)
        cs = torch.randn((T, B, H), device="cuda", generator=gen).to(dtype)
        dhs = torch.randn((T, B, H), device="cuda", generator=gen).to(dtype)
        dg = torch.empty((T, B, 4 * H), device="cuda", dtype=dtype)
        dx = torch.empty_like(x)
        partials = torch.empty((1, C + H + 1, 4 * H), device="cuda")
        dw = torch.empty((C + H + 1, 4 * H), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for name, (path, out) in built.items():
            lib = ctypes.CDLL(path)
            weights = [w.data_ptr(), w_ht.data_ptr()] + (
                [w_xt.data_ptr()] if w_xt_arg else [])
            lib.lstm_wide_bwd.argtypes = [i32] + [ptr] * (9 + len(
                weights)) + [i32] * 4 + [ptr]
            lib.lstm_wide_bwd.restype = i32

            def call():
                err = lib.lstm_wide_bwd(
                    flag, x.data_ptr(), *weights, hs.data_ptr(),
                    cs.data_ptr(), dhs.data_ptr(), z.data_ptr(),
                    dg.data_ptr(), dx.data_ptr(), partials.data_ptr(),
                    dw.data_ptr(), T, B, C, H, stream)
                if err != 0:
                    raise SystemExit(f"{label} {name!r}: launch error {err}")
            ms = time_ms(call)
            print(f"{label} {sfx} T={T} C=H={H} {name}: {ms:.4f} ms "
                  f"({ms / T * 1e3:.3f} us a step); "
                  f"{_kernel_ptxas(out, kernel, flag)}", flush=True)


def _kernel_ptxas(out, kernel, flag):
    """registers and spill bytes of ``kernel``'s instantiation for the
    dtype (f32: mangled with ``f``, bf16 with ``t``, unsigned short)."""
    found = []
    name = None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line) or \
            re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1)
            continue
        if name is None or kernel not in name:
            continue
        if (flag == 0) != bool(re.search(kernel + r"I[^E]*f", name)):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found.append(f"spills {m.group(1)}/{m.group(2)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.append(f"{m.group(1)} registers")
    return ", ".join(found) or "no ptxas line"


def compare_wide(parent_dir):
    """The wide K3 in one call, parent / this design / this design /
    parent, beside cuDNN's backward (``torch.nn.LSTM``, data and weights;
    a yardstick the port never calls), at T = 124, B = 2048 and C = H = 96
    and 128, f32 and bf16; each design's library called directly on
    preallocated buffers. Also prints the largest |dx| and relative dW
    difference of the two designs' outputs."""
    import torch

    sys.path.insert(0, REPO)
    from remora_tpu_torch.kernels import lstm as K

    _, built = build_variants(WIDE_SOURCE, {"parent": []},
                              headers=("mma_sm90.cuh",), csrc=os.path.join(
                                  parent_dir, "remora_tpu_torch", "csrc"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    parent = ctypes.CDLL(built["parent"][0])
    parent.lstm_wide_bwd.argtypes = [i32] + [ptr] * 11 + [i32] * 4 + [ptr]
    parent.lstm_wide_bwd.restype = i32
    parent.lstm_wide_dw_chunks.argtypes = [i32, i32]
    parent.lstm_wide_dw_chunks.restype = i32
    change = K._wide_bwd_library()
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
            dhs = torch.randn((T, B, H), device="cuda",
                              generator=gen).to(dtype)
            w = K.make_w_aug(params, dtype)
            hs, cs = K.lstm_fwd(x, w)
            w_ht, w_xt = K.wide_bwd_weights(w, C)
            z = torch.empty((T, B, 4 * H), device="cuda")
            dg = torch.empty((T, B, 4 * H), device="cuda", dtype=dtype)
            outs = {}
            for name, lib, weights in (
                    ("parent", parent, (w, w_ht)),
                    ("change", change, (w, w_ht, w_xt))):
                chunks = (parent.lstm_wide_dw_chunks(T, B) if lib is parent
                          else change.lstm_wide_bwd_dw_chunks(T, B))
                dx = torch.empty_like(x)
                partials = torch.empty((chunks, C + H + 1, 4 * H),
                                       device="cuda")
                dw = torch.empty((C + H + 1, 4 * H), device="cuda")
                args = ([flag, x.data_ptr()] + [t.data_ptr() for t in weights]
                        + [hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
                           z.data_ptr(), dg.data_ptr(), dx.data_ptr(),
                           partials.data_ptr(), dw.data_ptr(), T, B, C, H,
                           stream])

                def call(lib=lib, args=args):
                    err = lib.lstm_wide_bwd(*args)
                    if err != 0:
                        raise SystemExit(f"launch error {err}")
                outs[name] = call, dx, dw
            ms = {}
            for name in ("parent", "change", "change", "parent"):
                ms.setdefault(name, []).append(time_ms(outs[name][0]))
            xg = x.clone().requires_grad_()
            out = lib_lstm(xg)[0]
            inputs = (xg, *lib_lstm.parameters())
            cudnn = time_ms(lambda: torch.autograd.grad(
                out, inputs, grad_outputs=dhs, retain_graph=True))
            for name in ("parent", "change"):
                outs[name][0]()
            torch.cuda.synchronize()
            (_, dx_p, dw_p), (_, dx_c, dw_c) = outs["parent"], outs["change"]
            ddx = (dx_p.float() - dx_c.float()).abs().max().item()
            ddw = ((dw_p - dw_c).abs().max() / dw_p.abs().max()).item()
            sfx = "f32" if flag == 0 else "bf16"
            print(f"wide K3 {sfx} C=H={width}: parent / change / change / "
                  f"parent {ms['parent'][0]:.4f} / {ms['change'][0]:.4f} / "
                  f"{ms['change'][1]:.4f} / {ms['parent'][1]:.4f} ms; cuDNN "
                  f"backward {cudnn:.4f} ms; designs differ by dx "
                  f"{ddx:.3e}, dW {ddw:.3e} of its max-abs", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_lstm_bwd_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args[:1] == ["--compare-parent"]:
        compare_wide(args[1])
        print(smi_line())
        return 0
    if args[:1] == ["--wide"]:
        if args[1:2] == ["--parent"]:
            split_wide("parent", os.path.join(
                args[2], "remora_tpu_torch", "csrc"), PARENT_EDITS,
                PARENT_KERNEL, WIDE_SOURCE)
        split_wide("this design", CSRC, WIDE_EDITS, WIDE_KERNEL,
                   WIDE_BWD_SOURCE)
        print(smi_line())
        return 0
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
