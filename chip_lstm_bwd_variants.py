#!/usr/bin/env python3
"""Where the step time of K3's f32 kernel, and of the wide and the general
K3's reverse recurrences, goes, on one NVIDIA GPU.

    python3 chip_lstm_bwd_variants.py
    python3 chip_lstm_bwd_variants.py --wide [--parent DIR]
    python3 chip_lstm_bwd_variants.py --general
    python3 chip_lstm_bwd_variants.py --compare-parent DIR [512]
    python3 chip_lstm_bwd_variants.py --ring [--dtype f32|bf16] [WIDTH ...]
    python3 chip_lstm_bwd_variants.py --legs-512
    python3 chip_lstm_bwd_variants.py --products [--quick]
    python3 chip_lstm_bwd_variants.py --products-split

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
variant.

``--general`` splits the general K3's cluster recurrence
(``lstm_general_rec_cluster.cu``, the recurrence alone, at T = 124, B =
2048 and C = H = 160 and 256 at the plan's N, R, passes and row groups,
f32 and bf16; ``general_rec_cluster_kernel``, or at f32 256
``general_rec_group_kernel``): as it is, without the gate activations,
without the partial product, without the DSMEM exchange and the cluster
barriers (local stores, CTA barriers), without the input loads and
without the dgates' device stores; for the row-group kernel also with
local stores in place of the remote ones (the cluster barriers kept),
and two designs that compute the same dgates (held to it bit for bit):
the next slot's inputs loaded after the product, and the product's
dgates as float4 over 4 k; then the kernel as it is at the other
one-wave plans, and the streaming ``general_rec_kernel`` alone at every
shape.
``--compare-parent DIR`` times the general K3 of the parent checkout at
DIR (its cluster library at this plan's N, R, passes and row groups
where the plan takes the shape, else its streaming ``lstm_general_bwd``)
and of this one (its path by the plan) in one call, parent / this / this
/ parent, with each one's recurrence alone and split by part, beside
cuDNN's backward with TF32 off, at C = H = 160 and 256, f32 and bf16.
``--ring [--dtype f32|bf16] [WIDTH ...]`` measures the card's L2 read
rate (every SM reading one 4 MiB buffer, by loads and by TMA bulk copies;
with f32) and splits the ring path's walk (``lstm_general_rec_ring.cu``
at 257-512) at T = 124, B = 2048 and C = H = 512, 384 and 257 beside the
streaming ``general_rec_kernel``, in both dtypes unless one is named. f32
(``general_rec_ring_kernel``; edited copies): no product, no shared
loads of W_h^T or of dgates, no gate math, no dgates stores, 2 ring
slots, no gate-math input loads, the inputs loaded as used. bf16
(``general_rec_ring_bf16_kernel``; edited copies): CTA 0's clock64 sums
of the gate math and the product a step, each chunk released before its
HMMA, the next step's inputs prefetched into L2 (by TMA 16 chunks ahead,
or by each thread's prefetch at the product's start), the HMMA twice, no
HMMA, no product, no gate math, no dgates bulk stores, the c values by
each lane's loads, no Z or c items, tanh.approx, no barrier after the
product, and no gate math with no Z or c items. ``--compare-parent DIR 512`` times
the general K3 f32 at C = H = 512, T = 124 and 16 (the parent streamed
it) instead of the default cases. ``--legs-512`` times K1-K3 at 512, T =
124, f32 and bf16, beside cuDNN.
``--products`` times each f32 product of ``lstm_prod.cuh`` alone, the
Hopper kernel against the element kernel in turns, beside cuBLAS, at C =
H = 96-512 and T = 124 and 16, then K1-K3 f32 at 512, T = 124 beside
cuDNN (``products``, ``legs_512``); ``--products-split`` times edited
copies of the Hopper kernel at C = H = 256 and 160 (``split_products``).

Imports nothing of JAX or of the JAX package ``remora_tpu``; the build,
timing and SASS helpers are ``chip_lstm_fwd_variants.py``'s.
"""

import ctypes
import functools
import os
import re
import subprocess
import sys
import tempfile

from chip_lstm_fwd_variants import CSRC, REPO, build_variants, cudnn_ms, \
    ptxas_lines, sass_mix, smi_line, time_ms

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
    "slots2": [("c.slots = slots < kMaxSlots ? (int)slots : kMaxSlots;",
                "c.slots = 2;")],
    "no_input_loads": [("const int cnt = rf + i < rows ? nu[qd] : 0;",
                        "const int cnt = 0;")],
    "ahead0": [("constexpr int kAhead = 1;", "constexpr int kAhead = 0;")],
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
    "slots2": [("c.slots = slots < kMaxSlots ? (int)slots : kMaxSlots;",
                "c.slots = 2;")],
    "no_input_loads": [("const int cnt = rf + i < rows ? nu[qd] : 0;",
                        "const int cnt = 0;")],
    "ahead0": [("constexpr int kAhead = 1;", "constexpr int kAhead = 0;")],
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
    """registers and spill bytes of ``kernel``'s instantiations for the
    dtype (f32: mangled with ``f``, bf16 with ``t``, unsigned short; the
    row-group kernel is f32 alone)."""
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
        if "group" not in kernel and (flag == 0) != bool(
                re.search(kernel + r"I[^E]*f", name)):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found.append(f"spills {m.group(1)}/{m.group(2)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.append(f"{m.group(1)} registers")
    return ", ".join(found) or "no ptxas line"


# the general K3's cluster recurrence (lstm_general_rec_cluster.cu): each
# edit takes one piece of a step away
GENERAL_SOURCE = "lstm_general_rec_cluster.cu"
_GENERAL_ACTS = (
    "        const float ig = sigmoid(zr[k][0]), fg = sigmoid(zr[k][1]);\n"
    "        const float gg = tanhf(zr[k][2]), og = sigmoid(zr[k][3]);\n"
    "        const float tanh_c = tanhf(c_cur.get(k)), cp = widen(cpr[k]);")
GENERAL_EDITS = {
    # the activations (three sigmoids, two tanh) by linear stand-ins
    "no_gate_math": [(_GENERAL_ACTS, _GENERAL_ACTS
                      .replace("sigmoid(zr[k][0])", "0.5f + 0.1f * zr[k][0]")
                      .replace("sigmoid(zr[k][1])", "0.5f + 0.1f * zr[k][1]")
                      .replace("tanhf(zr[k][2])", "0.1f * zr[k][2]")
                      .replace("sigmoid(zr[k][3])", "0.5f + 0.1f * zr[k][3]")
                      .replace("tanhf(c_cur.get(k))", "0.1f * c_cur.get(k)"))],
    "no_product": [("        tile.product(ds, ws, cfg, p, tr, tc, lane);\n",
                    "        tile = Tile{};\n")],
    # each CTA's partials into its own receive tile, CTA barriers for the
    # cluster's (no remote store is left in flight at exit)
    "no_exchange": [
        ("      const uint32_t dst = map_rank(rv, s);",
         "      const uint32_t dst = rv + 0 * s;"),
        ("    const uint32_t dst = map_rank(rv, s);",
         "    const uint32_t dst = rv + 0 * s;"),
        ('  asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: '
         '"memory");', ""),
        ('  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: '
         '"memory");', "  __syncthreads();")],
    "no_loads": [
        ("      load_now(zr[k][g], zk + g * H, o);\n",
         "      zr[k][g] = 0.25f * (float)g - 0.3f + 0.01f * (float)(t & 7);\n"),
        ("    load_now(cpr[k], cs + (t > 0 ? hk - (size_t)B * H : 0), o && "
         "t > 0);\n    load_now(dhr[k], dhs + hk, o);\n",
         "    cpr[k] = narrow<T>(0.5f);\n    dhr[k] = narrow<T>(0.125f);\n")],
    "slots2": [("c.slots = slots < kMaxSlots ? (int)slots : kMaxSlots;",
                "c.slots = 2;")],
    "no_input_loads": [("const int cnt = rf + i < rows ? nu[qd] : 0;",
                        "const int cnt = 0;")],
    "ahead0": [("constexpr int kAhead = 1;", "constexpr int kAhead = 0;")],
    "no_dg_stores": [
        ("        for (int g = 0; g < 4; ++g) dgm[g * H] = narrow<T>(q[g]);\n",
         "")],
}
GENERAL_VARIANTS = {
    "as is": [],
    "no gate activations": GENERAL_EDITS["no_gate_math"],
    "no partial product": GENERAL_EDITS["no_product"],
    "no exchange, no cluster barriers": GENERAL_EDITS["no_exchange"],
    "no input loads": GENERAL_EDITS["no_loads"],
    "no dgates device stores": GENERAL_EDITS["no_dg_stores"],
}
# the same pieces of the row-group path (general_rec_group_kernel), and
# two other designs of it that compute the same dgates: the next slot's
# inputs loaded after the product (not held across it), and the product's
# dgates read as float4 over 4 k (fewer loads, more registers)
_GROUP_ACTS = (
    "          const float ig = sigmoid(zr[i][0]), fg = sigmoid(zr[i][1]);\n"
    "          const float gg = tanhf(zr[i][2]), og = sigmoid(zr[i][3]);\n"
    "          const float tanh_c = tanhf(ctr[i]);")
_GROUP_FETCH = (
    "      if (g + 1 < kG) {\n"
    "        fetch(t, g + 1);\n"
    "      } else if (t > 0) {\n"
    "        fetch(t - 1, 0);\n"
    "      }\n")
_GROUP_PRODUCT = "        tile.product(ds, ws, warp, lane);\n"
_GROUP_K2 = (
    "    for (int k = 0; k < kGK; k += 2) {\n"
    "      float2 av[4];\n"
    "#pragma unroll\n"
    "      for (int i = 0; i < 4; ++i) {\n"
    "        av[i] = *reinterpret_cast<const float2*>(a + 4 * i * kGLda + k);\n"
    "      }\n"
    "#pragma unroll\n"
    "      for (int kk = 0; kk < 2; ++kk) {\n")
_GROUP_LOCAL = [
    ("    const uint32_t d0 = map_rank(rv, s), d1 = map_rank(rv, s + 1);",
     "    const uint32_t d0 = rv + 0 * s, d1 = rv + 0 * s;")]
GROUP_EDITS = {
    "no_gate_math": [(_GROUP_ACTS, _GROUP_ACTS
                      .replace("sigmoid(zr[i][0])", "0.5f + 0.1f * zr[i][0]")
                      .replace("sigmoid(zr[i][1])", "0.5f + 0.1f * zr[i][1]")
                      .replace("tanhf(zr[i][2])", "0.1f * zr[i][2]")
                      .replace("sigmoid(zr[i][3])", "0.5f + 0.1f * zr[i][3]")
                      .replace("tanhf(ctr[i])", "0.1f * ctr[i]"))],
    "no_product": [(_GROUP_PRODUCT, "        tile = GroupTile{};\n")],
    "no_exchange": [*_GROUP_LOCAL, *GENERAL_EDITS["no_exchange"][2:]],
    "local_stores": _GROUP_LOCAL,
    "no_loads": [
        ("        load_now(zr[i][q], zk + q * H, o);\n",
         "        zr[i][q] = 0.25f * (float)q - 0.3f + 0.01f * (float)(t & 7);\n"),
        ("      load_now(ctr[i], cs + hk, o);\n"
         "      load_now(cpr[i], cs + (t > 0 ? hk - (size_t)B * H : 0), o && "
         "t > 0);\n      load_now(dhr[i], dhs + hk, o);\n",
         "      ctr[i] = 0.5f;\n      cpr[i] = 0.25f;\n      dhr[i] = 0.125f;\n")],
    "slots2": [("c.slots = slots < kMaxSlots ? (int)slots : kMaxSlots;",
                "c.slots = 2;")],
    "no_input_loads": [("const int cnt = rf + i < rows ? nu[qd] : 0;",
                        "const int cnt = 0;")],
    "ahead0": [("constexpr int kAhead = 1;", "constexpr int kAhead = 0;")],
    "no_dg_stores": [
        ("          for (int c = 0; c < 4; ++c) dgm[c * H] = q[c];\n", "")],
    "fetch_after_product": [
        (_GROUP_FETCH, "      if (t == 0 && g + 1 < kG) fetch(t, g + 1);\n"),
        (_GROUP_PRODUCT, _GROUP_PRODUCT + "        if (g + 1 < kG) {\n"
         "          fetch(t, g + 1);\n        } else {\n"
         "          fetch(t - 1, 0);\n        }\n")],
    "k4": [
        (_GROUP_K2, _GROUP_K2.replace("k += 2", "k += 4")
         .replace("float2", "float4").replace("kk < 2", "kk < 4")),
        ("          const float ak = kk == 0 ? av[i].x : av[i].y;\n",
         "          const float ak = kk == 0   ? av[i].x\n"
         "                           : kk == 1 ? av[i].y\n"
         "                           : kk == 2 ? av[i].z\n"
         "                                     : av[i].w;\n")],
}
GROUP_VARIANTS = {
    "groups as is": [],
    "groups no gate activations": GROUP_EDITS["no_gate_math"],
    "groups no partial product": GROUP_EDITS["no_product"],
    "groups no exchange, no cluster barriers": GROUP_EDITS["no_exchange"],
    "groups local stores, cluster barriers kept": GROUP_EDITS["local_stores"],
    "groups no input loads": GROUP_EDITS["no_loads"],
    "groups no dgates device stores": GROUP_EDITS["no_dg_stores"],
    "groups, inputs loaded after the product":
        GROUP_EDITS["fetch_after_product"],
    "groups, dgates as float4 over 4 k": GROUP_EDITS["k4"],
}


def _typed_rec(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lstm_general_rec_cluster_rec.argtypes = ([i32] + [ptr] * 5
                                                 + [i32] * 7 + [ptr])
    lib.lstm_general_rec_cluster_rec.restype = i32
    return lib


def _general_rec_case(width, dtype, T=124, B=2048, seed=0):
    """Seeded recurrence inputs on the card at C = H = width: Z (f32), cs,
    dhs and W_h^T, and a dgates buffer."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed + width)
    H = width
    z = torch.randn((T, B, 4 * H), device="cuda", generator=gen)
    cs = torch.randn((T, B, H), device="cuda", generator=gen).to(dtype)
    dhs = torch.randn((T, B, H), device="cuda", generator=gen).to(dtype)
    w_ht = ((torch.rand((4 * H, H), device="cuda", generator=gen) * 2 - 1)
            / H ** 0.5).to(dtype)
    dg = torch.empty((T, B, 4 * H), device="cuda", dtype=dtype)
    return z, cs, dhs, w_ht, dg


def split_general():
    """Each variant of the general K3's cluster recurrence alone
    (``lstm_general_rec_cluster_rec``) at T = 124, B = 2048 and C = H = 160
    and 256 in each dtype the plan takes there, at the plan's N, R and
    passes on this card; then the kernel as it is at the other one-wave
    plans whose CTA fits (the fewest passes of each N), and the streaming
    ``general_rec_kernel`` alone at the same shapes (``lstm_general_rec``),
    f32 at 256 included."""
    import torch

    sys.path.insert(0, REPO)
    from remora_tpu_torch.kernels import lstm as K

    _, built = build_variants(GENERAL_SOURCE,
                              {**GENERAL_VARIANTS, **GROUP_VARIANTS},
                              headers=("mma_sm90.cuh", "lstm_prod.cuh"))
    libs = {name: (_typed_rec(ctypes.CDLL(path)), out)
            for name, (path, out) in built.items()}
    streaming = K._general_library()
    caps = K.cluster_capacity(0)
    print(f"clusters the card holds: {caps}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    T, B = 124, 2048
    for width in (160, 256):
        for dtype, flag in ((torch.float32, 0), (torch.bfloat16, 1)):
            sfx = "bf16" if flag else "f32"
            z, cs, dhs, w_ht, dg = _general_rec_case(width, dtype)
            ptrs = (z.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
                    w_ht.data_ptr(), dg.data_ptr())

            def stream_call():
                err = streaming.lstm_general_rec(flag, *ptrs, T, B, width,
                                                 stream)
                if err != 0:
                    raise SystemExit(f"general_rec_kernel: error {err}")
            ms = time_ms(stream_call)
            print(f"general K3 recurrence {sfx} C=H={width} streaming "
                  f"general_rec_kernel: {ms:.4f} ms ({ms / T * 1e3:.3f} us "
                  "a step)", flush=True)
            plan = K.general_rec_plan(width, width, dtype, caps)
            if plan is None:
                print(f"general K3 {sfx} C=H={width}: the plan refuses it "
                      "(streaming path)", flush=True)
                continue
            shapes = [(plan[0], plan[1], plan[3], plan[4])]
            for n in (2, 4, 8):
                rows = -(-(-(-B // caps[n])) // 32) * 32
                for passes in range(1, K.CLUSTER_REC_MAX_PASSES + 1):
                    if K.general_rec_cfg(width, dtype, n, rows,
                                         passes) is not None:
                        if (n, rows, passes, 1) not in shapes:
                            shapes.append((n, rows, passes, 1))
                        break
            grouped = plan[4] > 1
            kernel = ("general_rec_group_kernel" if grouped
                      else "general_rec_cluster_kernel")
            for i, (n, rows, passes, groups) in enumerate(shapes):
                names = ([name for name in libs
                          if name.startswith("groups") == grouped]
                         if i == 0 else ["as is"])
                want = None
                for name in names:
                    lib, out = libs[name]

                    def call(lib=lib):
                        err = lib.lstm_general_rec_cluster_rec(
                            flag, *ptrs, T, B, width, n, rows, passes,
                            groups, stream)
                        if err != 0:
                            raise SystemExit(f"{name!r}: error {err}")
                    ms = time_ms(call)
                    # the designs that compute the same dgates must agree
                    # with the plan's kernel bit for bit
                    same = ""
                    if name in ("groups as is", "as is") and i == 0:
                        call()
                        want = dg.clone()
                    elif name.startswith("groups, ") and want is not None:
                        call()
                        same = ("; dgates identical" if torch.equal(dg, want)
                                else "; dgates DIFFER")
                    tag = "plan" if i == 0 else "other plan"
                    print(f"general K3 recurrence {sfx} C=H={width} "
                          f"({tag}: N={n} R={rows} P={passes} "
                          f"groups={groups}) {name}: "
                          f"{ms:.4f} ms ({ms / T * 1e3:.3f} us a step); "
                          f"{_kernel_ptxas(out, kernel, flag)}{same}",
                          flush=True)


def _typed_general_bwd(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lstm_general_bwd.argtypes = [i32] + [ptr] * 12 + [i32] * 4 + [ptr]
    lib.lstm_general_bwd.restype = i32
    lib.lstm_general_bwd_dw_chunks.argtypes = [i32, i32]
    lib.lstm_general_bwd_dw_chunks.restype = i32
    lib.lstm_general_rec.argtypes = [i32] + [ptr] * 5 + [i32] * 3 + [ptr]
    lib.lstm_general_rec.restype = i32
    return lib


def _typed_parent_cluster(lib):
    """The parent checkout's cluster K3 (N, R, passes and row groups)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lstm_general_rec_cluster_bwd.argtypes = ([i32] + [ptr] * 12
                                                 + [i32] * 8 + [ptr])
    lib.lstm_general_rec_cluster_bwd.restype = i32
    lib.lstm_general_rec_cluster_rec.argtypes = ([i32] + [ptr] * 5
                                                 + [i32] * 7 + [ptr])
    lib.lstm_general_rec_cluster_rec.restype = i32
    lib.lstm_general_rec_cluster_dw_chunks.argtypes = [i32, i32]
    lib.lstm_general_rec_cluster_dw_chunks.restype = i32
    return lib


def _parts_ms(call, calls=3):
    """Device ms of each part of a general K3 call (the gate recompute, the
    recurrence, dx, dW, the ordered dW sum) from torch.profiler over
    ``calls`` calls."""
    import torch
    from torch.autograd import DeviceType

    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    ms = dict.fromkeys(("gates", "recurrence", "dx", "dW", "dW sum"), 0.0)
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA \
                or evt.self_device_time_total <= 0:
            continue
        name = evt.key
        if "general_rec" in name:
            part = "recurrence"
        elif re.search(r"ordered_sum(<0>|ILi0E)", name):
            part = "dW sum"
        else:
            op = re.search(r"Op\)(\d)|OpE(\d)E", name)
            if not re.search("wide_prod|prod_f32_ws", name) or op is None:
                continue
            part = ("gates", "dx", "dW")[int(op.group(1) or op.group(2))]
        ms[part] += evt.self_device_time_total / 1e3 / calls
    return ms


# --compare-parent's cases: (C = H, T, dtypes), B = 2048; with a width
# after DIR, that width's (512: f32 at T = 124 and 16, the ring path)
COMPARE_CASES = {
    None: [(160, 124, ("f32", "bf16")), (256, 124, ("f32", "bf16"))],
    512: [(512, 124, ("f32",)), (512, 16, ("f32",))],
}


def compare_general(parent_dir, cases=COMPARE_CASES[None]):
    """The general K3 in one call, parent / this design / this design /
    parent, beside cuDNN's backward (``torch.nn.LSTM``, data and weights,
    TF32 off as the port's f32 kernels; a yardstick the port never calls),
    at B = 2048 and each of ``cases`` (C = H, T, dtypes): the parent
    checkout's K3 on the path its plan takes (its
    ``lstm_general_rec_cluster.cu`` at the same N, R, passes and row
    groups where the plan takes the shape, else its ``lstm_general.cu``'s
    streaming ``general_rec_kernel``: the ring path is this design's, so
    where this checkout takes it the parent streamed) against this
    checkout's path (``_general_k3_launch``), each library called
    directly on preallocated buffers; each design's split by part
    (torch.profiler) and its recurrence alone, parent / this / this /
    parent; and how far the two designs' dx and dW differ."""
    import torch

    sys.path.insert(0, REPO)
    from remora_tpu_torch.infer.infer import full_f32
    from remora_tpu_torch.kernels import lstm as K

    parent_csrc = os.path.join(parent_dir, "remora_tpu_torch", "csrc")
    _, built = build_variants("lstm_general.cu", {"parent": []},
                              headers=("lstm_prod.cuh", "mma_sm90.cuh"),
                              csrc=parent_csrc)
    parent = _typed_general_bwd(ctypes.CDLL(built["parent"][0]))
    _, built = build_variants(GENERAL_SOURCE, {"parent": []},
                              headers=("lstm_prod.cuh", "mma_sm90.cuh"),
                              csrc=parent_csrc)
    parent_cluster = _typed_parent_cluster(ctypes.CDLL(built["parent"][0]))
    caps = K.cluster_capacity(0)
    stream = torch.cuda.current_stream().cuda_stream
    B = 2048
    for width, T, sfxs in cases:
        C = H = width
        for sfx in sfxs:
            dtype = torch.bfloat16 if sfx == "bf16" else torch.float32
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
            path, run, this_rec, chunks_of, _err = K._general_k3_launch(
                dtype, C, H, x.device)
            plan = K.general_rec_plan(C, H, dtype, caps)
            # the W_h^T each design's recurrence reads
            w_this = (K.general_rec_ring_layout(w, C) if path == "ring"
                      else w_ht)
            if plan is not None:
                npr = plan[0], plan[1], *plan[3:]
                parent_path = "cluster"
                parent_fn = (lambda *a: parent_cluster
                             .lstm_general_rec_cluster_bwd(*a[:-1], *npr,
                                                           a[-1]))
                parent_chunks = (parent_cluster
                                 .lstm_general_rec_cluster_dw_chunks)
                parent_rec = (lambda *a: parent_cluster
                              .lstm_general_rec_cluster_rec(*a[:-1], *npr,
                                                            a[-1]))
            else:
                parent_path = "stream"
                parent_fn = parent.lstm_general_bwd
                parent_chunks = parent.lstm_general_bwd_dw_chunks
                parent_rec = parent.lstm_general_rec
            with full_f32():
                z = K.lstm_bwd_gates_reference(x, w, hs)
            outs, recs = {}, {}
            for name, fn, chunks, rec, w_rec in (
                    ("parent", parent_fn, parent_chunks(T, B), parent_rec,
                     w_ht),
                    ("change", run, chunks_of(T, B), this_rec, w_this)):
                zb = torch.empty((T, B, 4 * H), device="cuda")
                dg = torch.empty((T, B, 4 * H), device="cuda", dtype=dtype)
                dx = torch.empty_like(x)
                partials = torch.empty((chunks, C + H + 1, 4 * H),
                                       device="cuda")
                dw = torch.empty((C + H + 1, 4 * H), device="cuda")
                args = [flag, x.data_ptr(), w.data_ptr(), w_rec.data_ptr(),
                        w_xt.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                        dhs.data_ptr(), zb.data_ptr(), dg.data_ptr(),
                        dx.data_ptr(), partials.data_ptr(), dw.data_ptr(),
                        T, B, C, H, stream]

                def call(fn=fn, args=args, name=name):
                    err = fn(*args)
                    if err != 0:
                        raise SystemExit(f"{name}: launch error {err}")
                outs[name] = call, dx, dw
                dg_alone = torch.empty((T, B, 4 * H), device="cuda",
                                       dtype=dtype)
                rargs = [flag, z.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
                         w_rec.data_ptr(), dg_alone.data_ptr(), T, B, H,
                         stream]

                def rcall(rec=rec, rargs=rargs, name=name):
                    err = rec(*rargs)
                    if err != 0:
                        raise SystemExit(f"{name} recurrence: error {err}")
                recs[name] = rcall, dg_alone
            ms, rec_ms = {}, {}
            for name in ("parent", "change", "change", "parent"):
                ms.setdefault(name, []).append(time_ms(outs[name][0]))
            for name in ("parent", "change", "change", "parent"):
                rec_ms.setdefault(name, []).append(time_ms(recs[name][0]))
            parts = {name: _parts_ms(outs[name][0])
                     for name in ("parent", "change")}
            xg = x.clone().requires_grad_()
            out = lib_lstm(xg)[0]
            inputs = (xg, *lib_lstm.parameters())
            cudnn = cudnn_ms(lambda: torch.autograd.grad(
                out, inputs, grad_outputs=dhs, retain_graph=True))
            for name in ("parent", "change"):
                outs[name][0]()
                recs[name][0]()
            torch.cuda.synchronize()
            (_, dx_p, dw_p), (_, dx_c, dw_c) = outs["parent"], outs["change"]
            ddx = (dx_p.float() - dx_c.float()).abs().max().item()
            ddw = ((dw_p - dw_c).abs().max() / dw_p.abs().max()).item()
            dg_p, dg_c = recs["parent"][1].float(), recs["change"][1].float()
            ddg = ((dg_p - dg_c).abs().max() / dg_p.abs().max()).item()
            print(f"general K3 {sfx} C=H={width} T={T} (parent: "
                  f"{parent_path} "
                  f"path, change: {path} path, plan {plan}): parent / "
                  f"change / change / parent {ms['parent'][0]:.4f} / "
                  f"{ms['change'][0]:.4f} / {ms['change'][1]:.4f} / "
                  f"{ms['parent'][1]:.4f} ms; the recurrence alone "
                  f"{rec_ms['parent'][0]:.4f} / {rec_ms['change'][0]:.4f} / "
                  f"{rec_ms['change'][1]:.4f} / {rec_ms['parent'][1]:.4f} "
                  f"ms; cuDNN backward (TF32 off) {cudnn:.4f} ms; designs "
                  f"differ by dx {ddx:.3e}, dW {ddw:.3e} of its max-abs, "
                  f"dgates {ddg:.3e} of theirs", flush=True)
            for name in ("parent", "change"):
                print(f"general K3 {sfx} C=H={width} T={T} {name} by part "
                      "(torch.profiler): " + ", ".join(
                          f"{k} {v:.4f} ms" for k, v in parts[name].items()),
                      flush=True)


# the f32 products' widths (C = H) and steps timed by --products, B = 2048
PRODUCT_WIDTHS = (96, 128, 160, 256, 512)
PRODUCT_STEPS = (124, 16)


def _product_operands(T, B, C, H, seed=0):
    """x, hs (the forward's range), W_aug and dgates (a gradient's scale),
    f32 on the card, and W_x^T (dx's operand)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((T, B, C), device="cuda", generator=gen)
    hs = torch.rand((T, B, H), device="cuda", generator=gen) * 2 - 1
    w = (torch.rand((C + H + 1, 4 * H), device="cuda", generator=gen) * 2
         - 1) / H ** 0.5
    dg = torch.randn((T, B, 4 * H), device="cuda", generator=gen) * 0.1
    return x, hs, w, dg, w[:C].t().contiguous()


def products(widths=PRODUCT_WIDTHS, steps=PRODUCT_STEPS):
    """``--products``: each f32 product of ``csrc/lstm_prod.cuh`` alone
    (``lstm_prod.cu``'s entry on preallocated buffers) at T in ``steps``, B
    = 2048, C = H in ``widths``: the element kernel (``wide_prod_f32_kernel``,
    the parent design, forced) and the Hopper kernel (``prod_f32_ws_kernel``)
    in turns, element / ws / ws / element, their outputs held equal bit for
    bit; beside each the FP32 bound (67 TFLOP/s), its share of the peak and
    one cuBLAS call on the same operands with TF32 off
    (``chip_smoke.prod_yardsticks``; a yardstick the port never calls).
    Then K3, K1 and K2 f32 at C = H = 512, T = 124 beside cuDNN
    (``legs_512``)."""
    import torch

    sys.path.insert(0, REPO)
    from chip_smoke import prod_work, prod_yardsticks
    from remora_tpu_torch.infer.infer import full_f32
    from remora_tpu_torch.kernels import _build
    from remora_tpu_torch.kernels import lstm as K

    lib = K._prod_library()
    for line in _build.compile_log("lstm_prod").splitlines():
        if "prod_f32_ws_kernel" in line or re.search(
                r"registers|spill", line):
            print(f"lstm_prod ptxas: {line.strip()}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    peak = 67e12
    B = 2048
    for width in widths:
        C = H = width
        for T in steps:
            x, hs, w, dg, wxt = _product_operands(T, B, C, H)
            yardsticks = prod_yardsticks(x, hs, w, dg)
            chunks = lib.lstm_prod_dw_chunks(T, B)
            partials = torch.empty((chunks, C + H + 1, 4 * H), device="cuda")
            total = {"ws": 0.0, "element": 0.0}
            for op in K.PROD_OPS:
                flops = prod_work(op, T * B, C, H)[0]
                outs, calls = {}, {}
                for path in K.PROD_PATHS:
                    out = (torch.empty_like(x) if op == "dx" else
                           torch.empty((C + H + 1, 4 * H), device="cuda")
                           if op == "dw" else
                           torch.empty((T, B, 4 * H), device="cuda"))
                    args = [K.PROD_OPS.index(op),
                            1 + K.PROD_PATHS.index(path), x.data_ptr(),
                            hs.data_ptr(), w.data_ptr(), wxt.data_ptr(),
                            dg.data_ptr(), out.data_ptr(),
                            partials.data_ptr(), T, B, C, H, stream]

                    def call(args=args, path=path):
                        err = lib.lstm_prod_f32(*args)
                        if err != 0:
                            raise SystemExit(
                                f"{op} {path} C=H={width} T={T}: "
                                f"{lib.lstm_prod_error_string(err).decode()}")
                    outs[path], calls[path] = out, call
                ms = {}
                for path in ("element", "ws", "ws", "element"):
                    ms.setdefault(path, []).append(
                        time_ms(calls[path], n=7, calls=3))
                for path in K.PROD_PATHS:
                    calls[path]()
                torch.cuda.synchronize()
                same = torch.equal(outs["ws"], outs["element"])
                with full_f32():
                    lib_ms = time_ms(yardsticks[op], n=7, calls=3)
                best = min(ms["ws"])
                total["ws"] += best
                total["element"] += min(ms["element"])
                bound = flops / peak * 1e3
                print(f"product {op} C=H={width} T={T} B={B}: element / ws "
                      f"/ ws / element {ms['element'][0]:.4f} / "
                      f"{ms['ws'][0]:.4f} / {ms['ws'][1]:.4f} / "
                      f"{ms['element'][1]:.4f} ms; bound {bound:.4f} ms "
                      f"({flops / 1e9:.2f} GFLOP): ws {bound / best:.1%} "
                      f"of the FP32 peak, element "
                      f"{bound / min(ms['element']):.1%}; cuBLAS (TF32 "
                      f"off) {lib_ms:.4f} ms; bit for bit {same}",
                      flush=True)
                if not same:
                    raise SystemExit(f"{op} C=H={width} T={T}: the ws and "
                                     "element outputs differ")
                del outs
            print(f"products C=H={width} T={T}: K3's three (gates, dx, dW) "
                  f"+ Z_x, best of each: ws {total['ws']:.4f} ms, element "
                  f"{total['element']:.4f} ms", flush=True)
            del x, hs, w, dg, wxt, partials, yardsticks
            torch.cuda.empty_cache()


# (old, new) textual edits of lstm_prod.cuh for --products-split: the
# design's pieces taken away (timing only: wrong or no results) and the
# settings it chose against their alternatives (same bits)
_WS_NO_LOADS = [
    ("      ws_expect_arrive(full, kBytes);", "      ws_arrive(full);"),
    ("                                        int c0, int c1, uint32_t bar) "
     "{\n  asm volatile(",
     "                                        int c0, int c1, uint32_t bar) "
     "{\n  if (c0 != 0x7fffffff) return;\n  asm volatile(")]
_WS_NO_STORES = [
    ("          *reinterpret_cast<float4*>(out + (long long)m * G + n) =",
     "          if (p.B < 0) *reinterpret_cast<float4*>(out + (long long)m "
     "* G + n) ="),
    ("          *reinterpret_cast<float4*>(out + (long long)m * N + n) =",
     "          if (p.B < 0) *reinterpret_cast<float4*>(out + (long long)m "
     "* N + n) =")]
_WS_ONE_GROUP = [
    ("  for (int t = 2 * blockIdx.x + ring; t < g.tiles;",
     "  for (int t = 2 * blockIdx.x + ring; ring == 0 && t < g.tiles;"),
    ("  for (int tile = 2 * blockIdx.x + ring; tile < g.tiles;",
     "  for (int tile = 2 * blockIdx.x + ring; ring == 0 && tile < g.tiles;")]
_WS_HALF_LOADS = [
    ("          bt + (4 * kq + kk) * BN + 4 * WN * c);",
     "          bt + (4 * kq + (kk & 2)) * BN + 4 * WN * c);"),
    ("            *reinterpret_cast<const float4*>(at + k * BM + 4 * WM * c);",
     "            *reinterpret_cast<const float4*>(at + (k & ~1) * BM + 4 * "
     "WM * c);"),
    ("            *reinterpret_cast<const float4*>(bt + k * BN + 4 * WN * c);",
     "            *reinterpret_cast<const float4*>(bt + (k & ~1) * BN + 4 * "
     "WN * c);")]
_WS_B_PER_K = [("""  float bq[4][TN];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < TN / 4; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(
          bt + (4 * kq + kk) * BN + 4 * WN * c);
      bq[kk][4 * c] = v.x;
      bq[kk][4 * c + 1] = v.y;
      bq[kk][4 * c + 2] = v.z;
      bq[kk][4 * c + 3] = v.w;
    }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* b = bq[kk];
""", """#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float b[TN];
#pragma unroll
    for (int c = 0; c < TN / 4; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(
          bt + (4 * kq + kk) * BN + 4 * WN * c);
      b[4 * c] = v.x;
      b[4 * c + 1] = v.y;
      b[4 * c + 2] = v.z;
      b[4 * c + 3] = v.w;
    }
""")]
_WS_UNROLL_ALL = [
    ("    return launch_ws<op, 16, 8, 16>(p, chunks, s);",
     "    return launch_ws<op, 16, 8, 16, 2, true>(p, chunks, s);"),
    ("      case 96: return launch_ws<op, 16, 8, 12>(p, chunks, s);",
     "      case 96: return launch_ws<op, 16, 8, 12, 2, true>(p, chunks, s);"),
    ("      case 160: return launch_ws<op, 16, 6, 20>(p, chunks, s);",
     "      case 160: return launch_ws<op, 16, 6, 20, 2, true>(p, chunks, "
     "s);"),
    ("#pragma unroll 4\n    for (int k = 0; k < kWsBK; ++k) {",
     "#pragma unroll\n    for (int k = 0; k < kWsBK; ++k) {")]
PROD_VARIANTS = {
    "as is": [],
    "no TMA loads (timing only)": _WS_NO_LOADS,
    "no stores (timing only)": _WS_NO_STORES,
    "one consumer group, half the tiles (timing only)": _WS_ONE_GROUP,
    "half the shared loads (timing only)": _WS_HALF_LOADS,
    "3 ring slots for every op": [
        ("template <Op op, int WM, int TM, int TN, int kSlots = 2,",
         "template <Op op, int WM, int TM, int TN, int kSlots = 3,")],
    "registers 32/232": [
        ("setmaxnreg.dec.sync.aligned.u32 24;",
         "setmaxnreg.dec.sync.aligned.u32 32;"),
        ("setmaxnreg.inc.sync.aligned.u32 240;",
         "setmaxnreg.inc.sync.aligned.u32 232;")],
    "B rows loaded per k": _WS_B_PER_K,
    "a whole stage unrolled for every op": _WS_UNROLL_ALL,
    "dW at 160 in 160 x 64 tiles, at 256 in (16, 8, 16) threads": [
        ("      case 160: return launch_ws<op, 8, 20, 8, 3>(p, chunks, s);",
         "      case 160: return launch_ws<op, 8, 20, 4, 3>(p, chunks, s);"),
        ("      default: return launch_ws<op, 8, 16, 8, 3>(p, chunks, s);",
         "      default: return launch_ws<op, 16, 8, 16, 3>(p, chunks, s);")],
}


def split_products(widths=(256, 160), T=124, B=2048):
    """``--products-split``: the Hopper kernel's products as edited copies
    of ``lstm_prod.cuh`` (``PROD_VARIANTS``: without the TMA loads, the
    stores, one of the two consumer groups or half the shared loads, all
    timing only; and the settings it chose against their alternatives,
    their outputs held to the design's bit for bit), each op alone at C =
    H in ``widths``, T = 124, B = 2048."""
    import torch

    sys.path.insert(0, REPO)
    from remora_tpu_torch.kernels import lstm as K

    _, built = build_variants("lstm_prod.cu", PROD_VARIANTS,
                              headers=("lstm_prod.cuh", "mma_sm90.cuh"),
                              edit="lstm_prod.cuh")
    libs = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (path, out) in built.items():
        spills = [n for n in re.findall(r"(\d+) bytes spill stores", out)
                  if n != "0"]
        print(f"{name}: spill stores {spills or 'none'}", flush=True)
        lib = ctypes.CDLL(path)
        lib.lstm_prod_f32.argtypes = [i32, i32] + [ptr] * 7 + [i32] * 4 + [ptr]
        lib.lstm_prod_f32.restype = i32
        libs[name] = lib
    stream = torch.cuda.current_stream().cuda_stream
    for width in widths:
        C = H = width
        x, hs, w, dg, wxt = _product_operands(T, B, C, H)
        partials = torch.empty(((T * B + 2047) // 2048, C + H + 1, 4 * H),
                               device="cuda")
        for op in K.PROD_OPS:
            ref = None
            for name, lib in libs.items():
                out = (torch.empty_like(x) if op == "dx" else
                       torch.empty((C + H + 1, 4 * H), device="cuda")
                       if op == "dw" else
                       torch.empty((T, B, 4 * H), device="cuda"))
                args = [K.PROD_OPS.index(op), 1, x.data_ptr(), hs.data_ptr(),
                        w.data_ptr(), wxt.data_ptr(), dg.data_ptr(),
                        out.data_ptr(), partials.data_ptr(), T, B, C, H,
                        stream]

                def call(lib=lib, args=args, name=name):
                    err = lib.lstm_prod_f32(*args)
                    if err != 0:
                        raise SystemExit(f"{name} {op}: launch error {err}")
                ms = time_ms(call, n=7, calls=3)
                call()
                torch.cuda.synchronize()
                if ref is None:
                    ref = out
                same = ("-" if "timing only" in name
                        else torch.equal(out, ref))
                print(f"product {op} C=H={width} T={T}, {name}: {ms:.4f} "
                      f"ms; bits the design's: {same}", flush=True)
                if same is False:
                    raise SystemExit(f"{name} {op}: other bits")
        del x, hs, w, dg, wxt, partials
        torch.cuda.empty_cache()


def legs_512(T=124, B=2048, dtypes=("f32",)):
    """K3, K1 and K2 (with cs) at C = H = 512 through the port's entry
    points (f32: K1/K2 on the streaming ``lstm_general.cu`` kernel, K3's
    walk on the ring path, ``lstm_general_rec_ring.cu``, its products on
    ``lstm_prod.cuh``; bf16: K1/K2 on the forward's ring path,
    ``lstm_general_fwd_ring.cu``, K3's walk on the ring path's
    ``general_rec_ring_bf16_kernel``) beside cuDNN's backward and forward
    (TF32 off), in each of ``dtypes``. In bf16 the streaming K1/K2 and K3
    (the ring paths' parent designs) run on the same inputs, held to the
    ring paths' outputs and timed in turns with them (ring, stream,
    stream, ring), and the ring paths' walks are timed alone."""
    import torch

    sys.path.insert(0, REPO)
    from chip_smoke import ring_walk_call, stream_bwd_call, stream_fwd_call
    from remora_tpu_torch.kernels import lstm as K

    C = H = 512
    for sfx in dtypes:
        dtype = torch.bfloat16 if sfx == "bf16" else torch.float32
        gen = torch.Generator(device="cuda").manual_seed(512)
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
        ms = {
            "K1": time_ms(lambda: K.lstm_last(params, x), n=3, calls=1),
            "K2": time_ms(lambda: K.lstm_fwd(x, w), n=3, calls=1),
            "K3": time_ms(lambda: K.lstm_bwd(x, w, hs, cs, dhs), n=3,
                          calls=1),
        }
        xg = x.clone().requires_grad_()
        out = lib_lstm(xg)[0]
        inputs = (xg, *lib_lstm.parameters())
        fwd = cudnn_ms(lambda: lib_lstm(x), n=3, calls=1)
        bwd = cudnn_ms(lambda: torch.autograd.grad(
            out, inputs, grad_outputs=dhs, retain_graph=True), n=3, calls=1)
        print(f"{sfx} C=H={C} T={T} B={B} (K1/K2 path "
              f"{K.general_fwd_path(dtype, C, H)}, K3 path "
              f"{K.general_bwd_path(dtype, C, H)}): K1 {ms['K1']:.4f} ms, "
              f"K2 {ms['K2']:.4f} ms, cuDNN forward {fwd:.4f} ms; K3 "
              f"{ms['K3']:.4f} ms, cuDNN backward {bwd:.4f} ms (TF32 off)",
              flush=True)
        if sfx != "bf16":
            continue
        last = K.lstm_last(params, x)
        for leg, ring_call, want in (
                ("last", lambda: K.lstm_last(params, x), (last,)),
                ("fwd", lambda: K.lstm_fwd(x, w), (hs, cs))):
            call, outs = stream_fwd_call(leg, x, w)
            call()
            torch.cuda.synchronize()
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(outs, want))
            turns = [time_ms(fn, n=3, calls=1) for fn in (
                ring_call, call, call, ring_call)]
            print(f"bf16 C=H={C} T={T} B={B} K{1 if leg == 'last' else 2}: "
                  f"ring / stream / stream / ring {turns} ms (the streaming "
                  f"kernel {err:.3e} from the ring path's outputs)",
                  flush=True)
        walk, outs = ring_walk_call(x, w)
        walk()
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(outs, (hs, cs)))
        walk_ms = time_ms(walk, n=3, calls=1)
        print(f"bf16 C=H={C} T={T} B={B}: the ring walk alone {walk_ms:.4f} "
              f"ms ({walk_ms / T * 1e3:.2f} us a step; {err:.3e} from K2's "
              "outputs)", flush=True)
        dx, dw = K.lstm_bwd(x, w, hs, cs, dhs)
        call, s_dx, s_dw = stream_bwd_call(x, w, hs, cs, dhs)
        call()
        torch.cuda.synchronize()
        err = (s_dx.float() - dx.float()).abs().max().item()
        dw_rel = ((s_dw - dw).abs().max() / dw.abs().max()).item()
        turns = [time_ms(fn, n=3, calls=1) for fn in (
            lambda: K.lstm_bwd(x, w, hs, cs, dhs), call, call,
            lambda: K.lstm_bwd(x, w, hs, cs, dhs))]
        print(f"bf16 C=H={C} T={T} B={B} K3: ring / stream / stream / ring "
              f"{turns} ms (the streaming K3's dx {err:.3e} from the ring "
              f"path's, dW {dw_rel:.3e} of its max-abs)", flush=True)
        z = K.lstm_bwd_gates_reference(x, w, hs)
        rec_ms = time_ms(lambda: K.general_recurrence(z, cs, dhs, w), n=3,
                         calls=1)
        print(f"bf16 C=H={C} T={T} B={B}: K3's ring walk alone "
              f"{rec_ms:.4f} ms ({rec_ms / T * 1e3:.2f} us a step)",
              flush=True)


# --ring: the L2 read rate, one 4 MiB buffer read by every SM (W_h^T's
# f32 size at H = 512), through loads that bypass L1 and through TMA bulk
# copies into a ring of shared-memory slots, as general_rec_ring_kernel
# streams it
L2_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" __global__ void l2_read_ldg(const float4* __restrict__ buf,
                                       int n4, int reps, float* out) {
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) {
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = __ldcg(buf + i);
      acc += v.x + v.y + v.z + v.w;
    }
  }
  if (acc == 12345.f) out[blockIdx.x] = acc;  // keeps the loads
}

__device__ __forceinline__ void wait_bar(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one thread a block copies all of buf `reps` times into a ring of `slots`
// slots of `chunk` bytes, `slots` copies in flight
extern "C" __global__ void l2_read_bulk(const char* __restrict__ buf,
                                        int chunk, int nchunks, int reps,
                                        int slots) {
  extern __shared__ __align__(128) unsigned char sm[];
  if (threadIdx.x != 0) return;
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(sm);
  const uint32_t ring = bars + 256;
  for (int s = 0; s < slots; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bars + 8 * s) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const int total = nchunks * reps;
  for (int q = 0; q < total; ++q) {
    const int s = q % slots, n = q / slots;
    if (n > 0) wait_bar(bars + 8 * s, (n - 1) & 1);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        :: "r"(bars + 8 * s), "r"(chunk) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(ring + s * chunk), "l"(buf + (size_t)(q % nchunks) * chunk),
           "r"(chunk), "r"(bars + 8 * s) : "memory");
  }
  for (int q = total > slots ? total - slots : 0; q < total; ++q) {
    wait_bar(bars + 8 * (q % slots), (q / slots) & 1);
  }
}

extern "C" int run_ldg(const void* buf, int n4, int reps, void* out,
                       int blocks, void* stream) {
  l2_read_ldg<<<blocks, 512, 0, (cudaStream_t)stream>>>(
      (const float4*)buf, n4, reps, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int run_bulk(const void* buf, int chunk, int nchunks, int reps,
                        int slots, int blocks, void* stream) {
  const int smem = 256 + slots * chunk;
  cudaFuncSetAttribute(l2_read_bulk,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  l2_read_bulk<<<blocks, 32, smem, (cudaStream_t)stream>>>(
      (const char*)buf, chunk, nchunks, reps, slots);
  return (int)cudaGetLastError();
}
"""


def l2_rates(mib=4, reps=8, chunk=16384, slots=(2, 4, 6, 12)):
    """The card's L2 -> SM read rate: every SM's block reads the same
    ``mib`` MiB buffer ``reps`` times, by ``ld.global.cg`` (512 threads a
    block) and by one thread's TMA bulk copies into ``slots`` slots of
    ``chunk`` bytes (the ring kernel's at H = 512), over all SMs and on
    one SM alone (the bulk copies at each count of ``slots``). Prints and
    returns {name: GB/s}."""
    import torch

    sys.path.insert(0, REPO)
    from remora_tpu_torch.kernels import _build

    tmp = tempfile.mkdtemp()
    src = os.path.join(tmp, "l2_probe.cu")
    open(src, "w").write(L2_PROBE)
    lib_path = os.path.join(tmp, "libl2_probe.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                    src], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.run_ldg.argtypes = [ptr, i32, i32, ptr, i32, ptr]
    lib.run_bulk.argtypes = [ptr] + [i32] * 5 + [ptr]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nbytes = mib << 20
    buf = torch.rand(nbytes // 4, device="cuda")
    out = torch.zeros(sms, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for blocks in (sms, 1):
        def ldg(blocks=blocks):
            if lib.run_ldg(buf.data_ptr(), nbytes // 16, reps,
                           out.data_ptr(), blocks, stream):
                raise SystemExit("l2_read_ldg: launch error")

        def bulk(blocks=blocks, n=6):
            if lib.run_bulk(buf.data_ptr(), chunk, nbytes // chunk, reps,
                            n, blocks, stream):
                raise SystemExit("l2_read_bulk: launch error")
        for name, fn in (("ld.global.cg", ldg), *(
                (f"TMA bulk, {n} slots of {chunk >> 10} KiB",
                 functools.partial(bulk, n=n)) for n in slots)):
            ms = time_ms(fn, n=5, calls=3)
            key = f"{name}, {blocks} SM{'s' if blocks > 1 else ''}"
            rates[key] = blocks * nbytes * reps / ms / 1e6
            print(f"L2 read rate, {key} reading one {mib} MiB buffer "
                  f"{reps} times: {rates[key]:.1f} GB/s ({ms:.4f} ms)",
                  flush=True)
    return rates


# edits of lstm_general_rec_ring.cu for --ring's split of the step (the
# variants compute wrong numbers on purpose: timings, never results)
RING_SOURCE = "lstm_general_rec_ring.cu"
RING_EDITS = {
    "no_product": [("for (int kk = 0; kk < 2; ++kk) {",
                    "for (int kk = 0; kk < 0; ++kk) {")],
    "no_w_loads": [
        ("in_tile[0] ? *reinterpret_cast<const float4*>(wr + ub[0])\n"
         "                         : zero4();",
         "make_float4(1e-3f * kk, 2e-3f, 3e-3f, 4e-3f);"),
        ("in_tile[1] ? *reinterpret_cast<const float4*>(wr + ub[1])\n"
         "                         : zero4();",
         "make_float4(5e-3f, 6e-3f * kk, 7e-3f, 8e-3f);")],
    "no_a_loads": [
        ("av[i] = *reinterpret_cast<const float2*>(arow + i * ld +\n"
         "                                                   c * kChunk + "
         "kp);",
         "av[i] = make_float2(1e-3f * i, 1e-3f * c + 1e-3f * kp);")],
    "no_gate_math": [("for (int n = 0; n < 8; ++n) {",
                      "for (int n = 0; n < 0; ++n) {")],
    "slots2": [("c.slots = slots < kMaxSlots ? (int)slots : kMaxSlots;",
                "c.slots = 2;")],
    "no_input_loads": [("const int cnt = rf + i < rows ? nu[qd] : 0;",
                        "const int cnt = 0;")],
    "ahead0": [("#pragma unroll\n    for (int n = 0; n < 1; ++n) "
                "fetch(in[n], t, n);\n", ""),
               ("if (n + 1 < 8) fetch(in[(n + 1) & 1], t, n + 1);",
                "fetch(in[n & 1], t, n);")],
    "no_dg_stores": [
        ("      for (int g = 0; g < 4; ++g) store4<kVec>(dgm + g * H, "
         "q[g], cnt);\n", "")],
}
# edits of the bf16 walk (general_rec_ring_bf16_kernel) for --ring's bf16
# split; each matches that kernel's text alone
RING_BF16_EDITS = {
    "no_mma": [("          mma_16816(acc[2 * p], a[kk], &b[kk][p][0]);\n"
                "          mma_16816(acc[2 * p + 1], a[kk], &b[kk][p][2]);"
                "\n", "")],
    "no_ldsm": [
        ("        ldsm_x4(a[kk], a_base + (uint32_t)((kc * kBfChunk + 16 * "
         "kk) * 2));\n", ""),
        ("          ldsm_x4(b[kk][p], w + b_row[p] + b_seg[kk]);\n", "")],
    "no_gate_math": [("        const bool mine = j < nub;\n",
                      "        const bool mine = j < nub;\n"
                      "        if (j >= 0) continue;\n")],
    "no_dg_stores": [("      for (int r = 0; r < rows; ++r) {\n"
                      "        bulk_store(",
                      "      for (int r = 0; r < 0; ++r) {\n"
                      "        bulk_store(")],
    "c_loads": [("  constexpr bool kCRing = kVec;",
                 "  constexpr bool kCRing = false;")],
    "no_inputs": [("    const int half = kCRing ? j / 3 : j / 2, e = kCRing "
                   "? j % 3 : j % 2;",
                   "    if (j >= 0) {\n      prod::ws_expect_arrive(bar, 0u);"
                   "\n      return;\n    }\n    const int half = kCRing ? "
                   "j / 3 : j / 2, e = kCRing ? j % 3 : j % 2;")],
    # CTA 0's thread 0 sums clock64() over each step's gate math (to the
    # barrier after it) and product (to the barrier after it) and leaves
    # both sums in dg's first 16 bytes (the walk as it is otherwise)
    "clocks": [
        ("  int s = 0;  // the ring's next item: slot s, phase",
         "  int s = 0;  // the ring's next item: slot s, phase\n"
         "  unsigned long long clk_g = 0, clk_p = 0, clk0 = 0;"),
        ("    // 1. the gate math, rows 0-7 then 8-15",
         "    clk0 = clock64();\n    // 1. the gate math, rows 0-7 then 8-15"),
        ("    consumers_sync(kBfConsumers);  // the A tile holds dgates_t\n",
         "    consumers_sync(kBfConsumers);  // the A tile holds dgates_t\n"
         "    clk_g += clock64() - clk0;\n    clk0 = clock64();\n"),
        ("    consumers_sync(kBfConsumers);  // every warp is done with the A "
         "tile\n",
         "    consumers_sync(kBfConsumers);  // every warp is done with the A "
         "tile\n    clk_p += clock64() - clk0;\n"),
        ("  if (kVec && tid == 0) bulk_wait<false>();\n",
         "  if (kVec && tid == 0) bulk_wait<false>();\n"
         "  if (blockIdx.x == 0 && tid == 0) {\n"
         "    reinterpret_cast<unsigned long long*>(dg)[0] = clk_g;\n"
         "    reinterpret_cast<unsigned long long*>(dg)[1] = clk_p;\n"
         "  }\n")],
}
RING_BF16_VARIANTS = {
    "as is": [],
    "phase clocks": RING_BF16_EDITS["clocks"],
    "no HMMA (ldmatrix and the ring's waits kept)": RING_BF16_EDITS["no_mma"],
    "no product (no ldmatrix, no HMMA; the ring's waits kept)":
        RING_BF16_EDITS["no_mma"] + RING_BF16_EDITS["no_ldsm"],
    "no gate math (the product and the ring)":
        RING_BF16_EDITS["no_gate_math"],
    "no dgates device stores (bulk)": RING_BF16_EDITS["no_dg_stores"],
    "c values by each lane's loads (no c items)": RING_BF16_EDITS["c_loads"],
    "no Z or c items (W_h^T's chunks alone)": RING_BF16_EDITS["no_inputs"],
    "no gate math and no Z or c items":
        RING_BF16_EDITS["no_gate_math"] + RING_BF16_EDITS["no_inputs"],
}
RING_VARIANTS = {
    "as is": [],
    "no product (the ring's waits kept)": RING_EDITS["no_product"],
    "no W_h^T shared loads": RING_EDITS["no_w_loads"],
    "no dgates shared loads": RING_EDITS["no_a_loads"],
    "no W_h^T or dgates shared loads": RING_EDITS["no_w_loads"]
    + RING_EDITS["no_a_loads"],
    "no gate math (the product, the exchange, the ring)":
        RING_EDITS["no_gate_math"],
    "no dgates device stores": RING_EDITS["no_dg_stores"],
    "2 ring slots": RING_EDITS["slots2"],
    "no gate-math input loads (zeros)": RING_EDITS["no_input_loads"],
    "gate-math inputs loaded as used": RING_EDITS["ahead0"],
}


def _typed_ring(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lstm_general_rec_ring_rec.argtypes = ([i32] + [ptr] * 5 + [i32] * 3
                                              + [ptr])
    lib.lstm_general_rec_ring_rec.restype = i32
    return lib


def split_ring(widths=(512, 384, 257), T=124, B=2048,
               dtypes=("f32", "bf16")):
    """``--ring``: the L2 read rate (``l2_rates``, with f32); then, in each
    of ``dtypes``, the ring path's walk (``lstm_general_rec_ring_rec``) at
    T = 124, B = 2048 and C = H = ``widths`` beside the streaming
    ``general_rec_kernel`` on the same inputs (how far their dgates
    differ), and edited copies that split its step (f32
    ``general_rec_ring_kernel``: RING_VARIANTS; bf16
    ``general_rec_ring_bf16_kernel``: RING_BF16_VARIANTS), registers and
    spills each."""
    import torch

    sys.path.insert(0, REPO)
    from remora_tpu_torch.kernels import lstm as K

    if "f32" in dtypes:
        l2_rates()
    streaming = K._general_library()
    stream = torch.cuda.current_stream().cuda_stream
    for sfx in dtypes:
        bf16 = int(sfx == "bf16")
        dtype = torch.bfloat16 if bf16 else torch.float32
        kernel = ("general_rec_ring_bf16_kernel" if bf16
                  else "general_rec_ring_kernel")
        _, built = build_variants(
            RING_SOURCE, RING_BF16_VARIANTS if bf16 else RING_VARIANTS,
            headers=("mma_sm90.cuh", "lstm_prod.cuh"))
        libs = {name: (_typed_ring(ctypes.CDLL(path)), out)
                for name, (path, out) in built.items()}
        for width in widths:
            H = width
            z, cs, dhs, w_ht, dg = _general_rec_case(width, dtype, T=T, B=B)
            if bf16:
                w_aug = torch.zeros((H + H + 1, 4 * H), device="cuda",
                                    dtype=dtype)
                w_aug[H:2 * H] = w_ht.t()
                wp = K.general_rec_ring_bf16_weights(w_aug, H)
            else:
                wp = K.general_rec_ring_weights(w_ht)

            def stream_call():
                err = streaming.lstm_general_rec(
                    bf16, z.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
                    w_ht.data_ptr(), dg.data_ptr(), T, B, H, stream)
                if err != 0:
                    raise SystemExit(f"general_rec_kernel: error {err}")
            stream_call()
            want = dg.clone()
            ms = time_ms(stream_call, n=3, calls=1)
            print(f"general K3 walk {sfx} C=H={H} T={T} streaming "
                  f"general_rec_kernel: {ms:.4f} ms ({ms / T * 1e3:.2f} us a "
                  "step)", flush=True)
            for name, (lib, out) in libs.items():
                def call(lib=lib, name=name):
                    err = lib.lstm_general_rec_ring_rec(
                        bf16, z.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
                        wp.data_ptr(), dg.data_ptr(), T, B, H, stream)
                    if err != 0:
                        raise SystemExit(f"{name!r}: error {err}")
                same = ""
                if name == "as is":
                    call()
                    torch.cuda.synchronize()
                    diff = ((dg.float() - want.float()).abs().max()
                            / want.float().abs().max()).item()
                    same = (f"; dgates {diff:.3e} of their max-abs from the "
                            "streaming kernel's")
                ms = time_ms(call, n=5, calls=2)
                if name == "phase clocks":  # CTA 0's sums, SM cycles
                    clk = dg.view(-1).view(torch.int64)[:2].tolist()
                    same = (f"; CTA 0's clock64 a step: gate math "
                            f"{clk[0] / T:.0f} cycles, product "
                            f"{clk[1] / max(1, T - 1):.0f}")
                print(f"general K3 walk {sfx} C=H={H} T={T} ring R="
                      f"{K.RING_REC_ROWS} {name}: {ms:.4f} ms "
                      f"({ms / T * 1e3:.2f} us a step); "
                      f"{ptxas_lines(out, kernel)}{same}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_lstm_bwd_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args[:1] == ["--legs-512"]:
        legs_512(dtypes=("f32", "bf16"))
        print(smi_line())
        return 0
    if args[:1] == ["--ring"]:
        dtypes = ("f32", "bf16")
        if args[1:2] == ["--dtype"]:
            dtypes, args = (args[2],), args[2:]
        widths = tuple(int(a) for a in args[1:]) or (512, 384, 257)
        split_ring(widths, dtypes=dtypes)
        print(smi_line())
        return 0
    if args[:1] == ["--products-split"]:
        split_products()
        print(smi_line())
        return 0
    if args[:1] == ["--products"]:
        if args[1:2] == ["--quick"]:  # a first look: 96 and 256, T = 124
            products(widths=(96, 256), steps=(124,))
        else:
            products()
            legs_512()
        print(smi_line())
        return 0
    if args[:1] == ["--compare-parent"]:
        compare_general(args[1], COMPARE_CASES[int(args[2]) if args[2:]
                                               else None])
        print(smi_line())
        return 0
    if args[:1] == ["--general"]:
        split_general()
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
