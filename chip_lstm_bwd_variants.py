#!/usr/bin/env python3
"""Where the step time of K3's f32 kernel, and of the wide and the general
K3's reverse recurrences, goes, on one NVIDIA GPU.

    python3 chip_lstm_bwd_variants.py
    python3 chip_lstm_bwd_variants.py --wide [--parent DIR]
    python3 chip_lstm_bwd_variants.py --general
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
DIR (on the path its plan takes: its cluster library at this plan's N, R
and passes where this plan runs one row group, else its streaming
``lstm_general_bwd``) and of this one (its path by the plan) in one
call, parent / this / this / parent, with each one's recurrence alone
and split by part, beside cuDNN's backward with TF32 off, at C = H = 160
and 256, f32 and bf16.

Imports nothing of JAX or of the JAX package ``remora_tpu``; the build,
timing and SASS helpers are ``chip_lstm_fwd_variants.py``'s.
"""

import ctypes
import os
import re
import sys

from chip_lstm_fwd_variants import CSRC, REPO, build_variants, cudnn_ms, \
    sass_mix, smi_line, time_ms

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
    """The parent checkout's cluster K3 (N, R and passes; no row groups)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lstm_general_rec_cluster_bwd.argtypes = ([i32] + [ptr] * 12
                                                 + [i32] * 7 + [ptr])
    lib.lstm_general_rec_cluster_bwd.restype = i32
    lib.lstm_general_rec_cluster_rec.argtypes = ([i32] + [ptr] * 5
                                                 + [i32] * 6 + [ptr])
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
            if "wide_prod" not in name or op is None:
                continue
            part = ("gates", "dx", "dW")[int(op.group(1) or op.group(2))]
        ms[part] += evt.self_device_time_total / 1e3 / calls
    return ms


def compare_general(parent_dir):
    """The general K3 in one call, parent / this design / this design /
    parent, beside cuDNN's backward (``torch.nn.LSTM``, data and weights,
    TF32 off as the port's f32 kernels; a yardstick the port never calls),
    at T = 124, B = 2048 and C = H = 160 and 256, f32 and bf16: the parent
    checkout's K3 on the path its plan takes (its
    ``lstm_general_rec_cluster.cu`` at the same N, R and passes where this
    plan runs one row group, else its ``lstm_general.cu``'s streaming
    ``general_rec_kernel``) against this checkout's path
    (``_general_bwd_launch``), each library called directly on
    preallocated buffers; each design's split by part (torch.profiler) and
    its recurrence alone, parent / this / this / parent; and how far the
    two designs' dx and dW differ."""
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
    this_cluster = _typed_rec(K._general_rec_library())
    this_stream = _typed_general_bwd(K._general_library())
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
            dhs = torch.randn((T, B, H), device="cuda",
                              generator=gen).to(dtype)
            w = K.make_w_aug(params, dtype)
            hs, cs = K.lstm_fwd(x, w)
            w_ht, w_xt = K.wide_bwd_weights(w, C)
            run, chunks_of, _err, path = K._general_bwd_launch(
                dtype, C, H, x.device)
            plan = K.general_rec_plan(C, H, dtype, caps)
            if plan is not None and plan[4] == 1:
                npr = plan[0], plan[1], plan[3]
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
            if plan is None:
                this_rec = this_stream.lstm_general_rec
            else:
                this_rec = (lambda *a: this_cluster
                            .lstm_general_rec_cluster_rec(
                                *a[:-1], *plan[:2], *plan[3:], a[-1]))
            with full_f32():
                z = K.lstm_bwd_gates_reference(x, w, hs)
            outs, recs = {}, {}
            for name, fn, chunks, rec in (
                    ("parent", parent_fn, parent_chunks(T, B), parent_rec),
                    ("change", run, chunks_of(T, B), this_rec)):
                zb = torch.empty((T, B, 4 * H), device="cuda")
                dg = torch.empty((T, B, 4 * H), device="cuda", dtype=dtype)
                dx = torch.empty_like(x)
                partials = torch.empty((chunks, C + H + 1, 4 * H),
                                       device="cuda")
                dw = torch.empty((C + H + 1, 4 * H), device="cuda")
                args = [flag, x.data_ptr(), w.data_ptr(), w_ht.data_ptr(),
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
                         w_ht.data_ptr(), dg_alone.data_ptr(), T, B, H,
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
            print(f"general K3 {sfx} C=H={width} (parent: {parent_path} "
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
                print(f"general K3 {sfx} C=H={width} {name} by part "
                      "(torch.profiler): " + ", ".join(
                          f"{k} {v:.4f} ms" for k, v in parts[name].items()),
                      flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_lstm_bwd_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args[:1] == ["--compare-parent"]:
        compare_general(args[1])
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
