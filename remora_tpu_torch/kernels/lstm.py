"""LSTM recurrences as Hopper kernels: inference (K1) and training (K2, K3).

Counterpart of ``remora_tpu/kernels/pallas_lstm.py``:

  * ``lstm_last`` (K1) is ``lstm_last_fused``: the whole time loop in one
    launch, writing only h_{T-1};
  * ``lstm_fwd`` (K2) and ``lstm_bwd`` (K3) are ``_fwd_call`` and
    ``_bwd_call``: the full forward that writes hs (and cs for the
    backward), and the reverse-time backward that emits dx and dW_aug.
    Each routes by dtype. K1 and K2 in f32 run ``csrc/lstm_fwd_f32.cu``,
    one FP32 recurrence with the x product off its chain; in bf16
    ``csrc/lstm_fwd_mma.cu``, one tensor-core recurrence (each last-only
    for K1). K3 in f32 runs ``csrc/lstm_bwd_f32.cu``, one launch; in bf16
    ``csrc/lstm_bwd_mma.cu``, three tensor-core parts
    with wrappers and plain twins of their own (``lstm_bwd_gates``,
    ``lstm_bwd_recurrence``, ``lstm_bwd_products``). ``LSTMFused`` ties K2
    and K3 into one ``torch.autograd.Function`` and ``lstm_fused`` is the
    drop-in for ``layers.lstm``, as in the JAX package.

Those kernels take the main shape (C = H = 64) and the shapes near it
(``route``). Every other 1 <= C <= 128, 1 <= H <= 128 goes, in both dtypes
and all three legs, to the kernels written for the wider layers:
``csrc/lstm_wide.cu`` for K1 and K2 and ``csrc/lstm_wide_bwd.cu`` for K3,
each walking time on clusters of two CTAs that split the hidden units,
hold their units' slice of W on chip and swap h_t (K3: partial dh sums)
through distributed shared memory. C or H above 128, up to
``GENERAL_MAX_C`` / ``GENERAL_MAX_H`` (1024), goes to the general leg. Its
K1 and K2 take one of two paths, chosen on the host by shape before the
launch (``general_fwd_plan``, ``general_fwd_path``): the cluster path,
``csrc/lstm_general_cluster.cu``, where the plan finds clusters of N = 2,
4 or 8 CTAs over R rows that run the batch in one wave and fit a CTA
(bf16 at sizes 160 and 256, f32 at 160): each CTA keeps its units' slice
of W_h on chip, h_t crosses the cluster through distributed shared
memory, x_t . W_x runs off the chain, bf16 on the tensor cores (f32 at
193-256, where no such CTA fits, keeps the h tile instead and streams
W_h's slice through a ring, after one product of x_t . W_x + b over all
T, ``general_fwd_ring_cfg``); the ring path,
``csrc/lstm_general_fwd_ring.cu``, bf16 at 257-512 units
(``general_fwd_bf16_ring_plan``): x_t . W_x + b for all T as one
tensor-core product, then a CTA of 16 rows walks all H units with no
exchange between CTAs, W_h streamed by TMA through a ring of shared-memory
slots into ``mma.sync``; and the streaming path,
``csrc/lstm_general.cu``'s ``general_fwd_kernel``, for the shapes no other
path takes (f32 past 256, bf16 past 512): one block
per 8 batch rows walks time with h and c in shared memory and W read
through L2 each step. K3 there runs ``csrc/lstm_prod.cuh``'s gate
recompute and products (the wide K3's) around a reverse recurrence on one
of three paths, chosen the same way (``general_rec_plan``,
``general_rec_ring_plan``, ``general_bwd_path``):
``csrc/lstm_general_rec_cluster.cu``'s clusters of
N CTAs, each holding its gate columns' slice of W_h^T and trading partial
dh sums through distributed shared memory (bf16 at 160 and 256, f32 at
160; f32 at 193-256 walks the cluster's rows as groups of 48, whose
partials fit where all R rows' do not); both dtypes at 257-512,
``csrc/lstm_general_rec_ring.cu``'s ring path (a CTA of 16 rows walks all
H units with no exchange between CTAs, W_h^T's rows streamed by TMA
through a ring of shared-memory slots; f32 on FFMA tiles, bf16 on
``mma.sync`` with dh kept in the registers of the warp that owns its
units); else ``lstm_general.cu``'s ``general_rec_kernel`` (past 512, both
dtypes). Above 1024 every entry point raises; a launch
on any path that fails raises, never moving to another path.

The f32 products of those K3 legs and the W_h-ring K1/K2's Z_x run
``csrc/lstm_prod.cuh``'s ``prod_f32_ws_kernel`` (persistent blocks, a TMA
producer warp a ring, two FFMA consumer warpgroups) wherever C and H are
multiples of 4 and the operands 16-byte aligned (``prod_f32_path``), else
its element kernel; ``lstm_prod_f32`` runs one product alone on a path
the caller may force (counts in ``LAUNCHES_PROD``).

The source notes give each kernel's design and bound. Each entry point
launches its kernel for a CUDA tensor and uses its plain version
(``lstm_last_reference``, ``lstm_fwd_reference``, ``lstm_bwd_reference``
and the three parts' ``*_reference``) only for a CPU tensor. There is no
fallback: a CUDA input a kernel does not take, a failed build or a refused
launch raises.
"""

import ctypes
import functools

import numpy as np
import torch

from remora_tpu_torch.kernels import _build
from remora_tpu_torch.models import layers as L

# kernel launches in this process: K1 (one per ``lstm_last`` call on CUDA),
# K2 (one per ``lstm_fwd``) and K3 (one per ``lstm_bwd``), either dtype;
# K3's bf16 parts count apart, one per call of each part's wrapper
LAUNCHES = 0
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
LAUNCHES_BWD_MMA = dict.fromkeys(("gates", "recurrence", "products"), 0)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the shapes ``csrc/lstm_fwd_mma.cu`` takes (its ``lstm_fwd_mma_max_c`` /
# ``_max_h``): W_x's B fragments in registers, 4 hidden units a warp of 16
FWD_MMA_MAX_C = 128
FWD_MMA_MAX_H = 64
# the shapes ``csrc/lstm_bwd_f32.cu`` takes (its ``lstm_bwd_f32_fits``):
# 8 hidden units for each of 8 warps, one 8 x 16 dW tile for each of 256
# threads
BWD_F32_MAX_C = 128
BWD_F32_MAX_H = 64
BWD_F32_MAX_TILES = 256
# the shapes ``lstm_fwd_f32.cu`` takes (f32 K1, K2; its
# ``lstm_fwd_f32_max_c`` / ``_max_h``): 32 unit pairs a role
F32_FWD_MAX_C = 128
F32_FWD_MAX_H = 64
# the shapes ``lstm_bwd_mma.cu`` takes (its ``fits``: 8 hidden units for
# each of 8 warps, C + H staged at most 128 deep)
BWD_MMA_MAX_H = 64
BWD_MMA_MAX_K = 128
# the shapes ``lstm_wide.cu`` (K1, K2) and ``lstm_wide_bwd.cu`` (K3) take:
# every LSTM leg at C, H <= 128, each in both dtypes (their kMaxC/kMaxH size
# their tiles; a launch beyond them is refused)
WIDE_MAX_C = 128
WIDE_MAX_H = 128
# launches of the wide kernels (one per wide call of each leg; the leg's
# own count above moves too)
LAUNCHES_WIDE = dict.fromkeys(("last", "fwd", "bwd"), 0)
# the shapes ``lstm_general.cu`` takes (its ``lstm_general_max_c`` /
# ``_max_h``): every LSTM leg at 1 <= C, H <= 1024 in both dtypes, the
# forward's x, h and c tiles and the recurrence's dgates, dh and dc tiles
# of 8 rows within a block's shared memory; it runs what the wide kernels
# do not take
GENERAL_MAX_C = 1024
GENERAL_MAX_H = 1024
# launches of the general leg (one per general call of each leg; the leg's
# own count above moves too)
LAUNCHES_GENERAL = dict.fromkeys(("last", "fwd", "bwd"), 0)
# the general K1/K2 launches by path (one per general call of ``lstm_last``
# or ``lstm_fwd``): "cluster" ``lstm_general_cluster.cu``, "ring"
# ``lstm_general_fwd_ring.cu``, "stream" ``lstm_general.cu``'s
# ``general_fwd_kernel`` (``general_fwd_path``)
LAUNCHES_GENERAL_FWD = dict.fromkeys(("cluster", "ring", "stream"), 0)
# ``lstm_general_cluster.cu``'s budget: a block's shared memory, threads a
# CTA by dtype (its __launch_bounds__), ring slots at most, k a slot holds,
# and the batch its plan sizes a wave for (the model paths' batch)
CLUSTER_SMEM_MAX = 232448
CLUSTER_MAX_THREADS = {torch.bfloat16: 512, torch.float32: 480}
CLUSTER_MAX_THREADS_X2 = 320  # bf16 warps of two unit blocks
CLUSTER_MAX_SLOTS = 16
CLUSTER_CHUNK = 16
# its W_h-ring path (``cluster_fwd_f32_whring_kernel``, f32 where no CTA of
# the kernels above fits): warps of 48 rows and 8 units, threads a CTA at
# most (168 registers a thread), W_h's k a ring slot holds
CLUSTER_RING_ROWS = 48
CLUSTER_RING_MAX_THREADS = 384
CLUSTER_RING_CHUNK = 64
GENERAL_FWD_PLAN_BATCH = 2048
# clusters of N CTAs an H100 80GB HBM3 (132 SMs) holds at once, one CTA an
# SM (``lstm_general_cluster_capacity``): its GPCs' SMs split into clusters
H100_CLUSTERS = {2: 66, 4: 30, 8: 15}
# the general K3's launches by path (one per general call of ``lstm_bwd``
# or ``general_recurrence``): "cluster" ``lstm_general_rec_cluster.cu``,
# "ring" ``lstm_general_rec_ring.cu``, "stream" ``lstm_general.cu``'s
# ``general_rec_kernel`` (``general_bwd_path``)
LAUNCHES_GENERAL_BWD = dict.fromkeys(("cluster", "ring", "stream"), 0)
# ``lstm_general_rec_cluster.cu``'s budget besides CLUSTER_SMEM_MAX: threads
# a CTA (its __launch_bounds__: 168 registers a thread), the (row, unit)
# pairs a thread may own (its instantiations), and the exchange's passes at
# most
CLUSTER_REC_MAX_THREADS = 384
CLUSTER_REC_PAIRS = {torch.float32: (8, 12), torch.bfloat16: (8, 14)}
CLUSTER_REC_MAX_PASSES = 8
# its row-group path (``general_rec_group_kernel``, f32, where no pass count
# fits): clusters of 8 CTAs of 32 units, the R rows walked as 3 groups of
# 48 (R = 144: an H100's 15 clusters of 8 a wave; a fourth group's
# carries outgrow 168 registers), 12 warps
CLUSTER_REC_GROUP_N = 8
CLUSTER_REC_GROUP_UNITS = 32
CLUSTER_REC_GROUP_ROWS = 48
CLUSTER_REC_GROUPS = 3
# ``lstm_general_rec_ring.cu``'s budget (``general_rec_ring_kernel``, f32):
# rows a CTA, W_h^T's rows a ring slot, ring slots at most, the mbarriers'
# bytes, hidden units at most (two groups of 4 consumer warps of 128
# units); the plan takes it at RING_REC_MIN_H <= H <= RING_REC_MAX_H, where
# no cluster plan fits
RING_REC_ROWS = 16
RING_REC_CHUNK = 8
RING_REC_MAX_SLOTS = 16
RING_REC_BAR_BYTES = 256
RING_REC_MIN_H = 257
RING_REC_MAX_H = 512
# its bf16 budget (``general_rec_ring_bf16_kernel``, the same R and H range):
# consumer warps a CTA (n8 tiles of units split among them; a producer
# warpgroup beside them), W_h^T's k a ring slot holds (two mma steps), Z's
# rows an item
RING_REC_BF16_WARPS = 8
RING_REC_BF16_CHUNK = 32
RING_REC_BF16_ZROWS = 4
# ``lstm_general_fwd_ring.cu``'s budget (``fwd_ring_kernel``, bf16 K1/K2):
# rows a CTA (one m16 tile), warps a CTA (8-unit blocks split among them;
# no producer warp), W_h's k a ring slot holds (one mma step), ring slots
# at most, the mbarriers' and slot counters' bytes, hidden units at most;
# the plan takes it at
# FWD_RING_MIN_H <= H <= FWD_RING_MAX_H, where no cluster plan fits
FWD_RING_ROWS = 16
FWD_RING_WARPS = 8
FWD_RING_CHUNK = 16
FWD_RING_MAX_SLOTS = 16
FWD_RING_BAR_BYTES = 256
FWD_RING_MIN_H = 257
FWD_RING_MAX_H = 512
# ``csrc/lstm_prod.cuh``'s f32 products (K3's gate recompute, dx and dW,
# the W_h-ring K1/K2's Z_x), by the library's op number, and their two
# paths: "ws" (``prod_f32_ws_kernel``, Hopper's persistent warp-specialized
# FFMA GEMM fed by TMA) where ``prod_f32_path`` finds C, H and the operands
# fit it, else "element" (``wide_prod_f32_kernel``); one launch counted a
# product run, through ``lstm_prod_f32`` or inside a K3 or K1/K2 call
PROD_OPS = ("gates", "dx", "dw", "gates_x")
PROD_PATHS = ("ws", "element")
LAUNCHES_PROD = {(op, path): 0 for op in PROD_OPS for path in PROD_PATHS}


def make_w_aug(params, dtype):
    """[W_ih^T ; W_hh^T ; b_ih + b_hh] stacked, (C + H + 1, 4H) in ``dtype``
    (built as ``lstm_last_fused`` builds it)."""
    H = params["w_hh"].shape[1]
    bias = (params["b_ih"] + params["b_hh"]).reshape(1, 4 * H)
    return torch.cat(
        [params["w_ih"].T.to(dtype), params["w_hh"].T.to(dtype),
         bias.to(dtype)],
        dim=0,
    ).contiguous()


def lstm_last_reference(params, x):
    """Plain version: the scan's final hidden state, (B, H) in x's dtype."""
    return L.lstm(params, x, impl="scan")[-1].to(x.dtype)


def _f32_fwd_library():
    """The library of K1's and K2's f32 leg (``csrc/lstm_fwd_f32.cu``)."""
    lib = _build.load("lstm_fwd_f32")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lstm_fwd_f32.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.lstm_fwd_f32.restype = i32
        lib.lstm_fwd_f32_last.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
        lib.lstm_fwd_f32_last.restype = i32
        for fn in ("lstm_fwd_f32_max_c", "lstm_fwd_f32_max_h"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i32
        lib.lstm_fwd_f32_error_string.argtypes = [i32]
        lib.lstm_fwd_f32_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def fwd_mma_shape_error(name, C, H):
    """The ``ValueError`` message with which ``name`` refuses a bf16 call of
    C inputs and H hidden units that ``csrc/lstm_fwd_mma.cu`` does not take,
    or None."""
    if 1 <= C <= FWD_MMA_MAX_C and 1 <= H <= FWD_MMA_MAX_H:
        return None
    return (f"{name}: the bf16 kernel takes 1 <= C <= {FWD_MMA_MAX_C} and "
            f"1 <= H <= {FWD_MMA_MAX_H}, got C={C}, H={H}")


def bwd_f32_shape_error(C, H):
    """The ``ValueError`` message with which ``lstm_bwd`` refuses an f32 call
    of C inputs and H hidden units that ``csrc/lstm_bwd_f32.cu`` does not
    take, or None: C <= 128, H <= 64, and one 8 x 16 tile of the (C + H) x
    4H weight gradient for each of 256 threads."""
    if 1 <= C <= BWD_F32_MAX_C and 1 <= H <= BWD_F32_MAX_H:
        tiles = -(-(C + H) // 8) * -(-H // 4)
        if tiles <= BWD_F32_MAX_TILES:
            return None
    return (f"lstm_bwd: the f32 kernel takes 1 <= C <= {BWD_F32_MAX_C}, "
            f"1 <= H <= {BWD_F32_MAX_H} and ceil((C + H) / 8) * ceil(H / 4) "
            f"<= {BWD_F32_MAX_TILES} weight-gradient tiles (C + H <= 128 at "
            f"H = 64), got C={C}, H={H}")


def shape_error(name, C, H):
    """The ``ValueError`` message with which ``name`` refuses C inputs and
    H hidden units that no kernel takes, or None."""
    if 1 <= C <= GENERAL_MAX_C and 1 <= H <= GENERAL_MAX_H:
        return None
    return (f"{name}: no kernel takes C={C}, H={H}; the LSTM kernels take "
            f"1 <= C <= {GENERAL_MAX_C} and 1 <= H <= {GENERAL_MAX_H}")


def route(leg, dtype, C, H):
    """The kernel of a CUDA call of ``leg`` ("last" K1, "fwd" K2, "bwd" K3)
    in ``dtype`` at C inputs and H hidden units: "main" for the main-shape
    kernel of that leg and dtype (``lstm_fwd_f32.cu``, ``lstm_fwd_mma.cu``,
    ``lstm_bwd_f32.cu``, ``lstm_bwd_mma.cu``) where it takes the shape, else
    "wide" (``lstm_wide.cu``, K3 ``lstm_wide_bwd.cu``) up to C, H = 128 and
    "general" (``lstm_general.cu``) above; a shape no kernel takes raises
    ``ValueError``."""
    name = {"last": "lstm_last", "fwd": "lstm_fwd", "bwd": "lstm_bwd"}[leg]
    msg = shape_error(name, C, H)
    if msg is not None:
        raise ValueError(msg)
    if C > WIDE_MAX_C or H > WIDE_MAX_H:
        return "general"
    if dtype == torch.bfloat16:
        main = (fwd_mma_shape_error(name, C, H) is None if leg != "bwd"
                else H <= BWD_MMA_MAX_H and C + H <= BWD_MMA_MAX_K)
    elif leg != "bwd":
        main = C <= F32_FWD_MAX_C and H <= F32_FWD_MAX_H
    else:
        main = bwd_f32_shape_error(C, H) is None
    return "main" if main else "wide"


def wide_fwd_units(H):
    """Hidden units each CTA of ``lstm_wide.cu``'s forward cluster owns at H
    (its ``lstm_wide_fwd_units``): half of H, rounded up to 16."""
    half = -(-H // 2)
    return -(-half // 16) * 16


def wide_fwd_weights(w_aug, C):
    """``lstm_wide.cu``'s f32 layout of W_aug (C + H + 1, 4H): (cp + hp, 2
    ``wide_fwd_units(H)``, 4), cp and hp C and H rounded up to 4. Row k < C
    is W_x's row k and row cp + k (k < H) W_h's, each unit's four gate
    weights side by side ([u][g] = W_aug[row][g * H + u]); the rows and units
    between are zero. A CTA's slice of a row, all four gates of its units,
    is then one contiguous run, and a k quad never reaches past W_x."""
    H = w_aug.shape[1] // 4
    cp, hp = -(-C // 4) * 4, -(-H // 4) * 4
    w = w_aug[:C + H].reshape(C + H, 4, H).transpose(1, 2)
    out = w_aug.new_zeros((cp + hp, 2 * wide_fwd_units(H), 4))
    out[:C, :H] = w[:C]
    out[cp:cp + H, :H] = w[C:]
    return out


def _wide_launch(fn, dtype, w_aug, C):
    """``lstm_wide.cu``'s forward launcher ``fn`` behind the main-shape
    launchers' signature (x, W_aug, outputs..., T, B, C, H, stream): the
    dtype flag first and, after W_aug, the f32 kernel's layout
    (``wide_fwd_weights``; none for bf16, which gathers its slices from
    W_aug)."""
    bf16 = int(dtype == torch.bfloat16)
    w_il = None if bf16 else wide_fwd_weights(w_aug, C)

    def launch(x_ptr, w_ptr, *rest):
        return fn(bf16, x_ptr, w_ptr,
                  None if w_il is None else w_il.data_ptr(), *rest)

    return launch


def _wide_library():
    lib = _build.load("lstm_wide")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lstm_wide_fwd.argtypes = [i32] + [ptr] * 5 + [i32] * 4 + [ptr]
        lib.lstm_wide_fwd.restype = i32
        lib.lstm_wide_last.argtypes = [i32] + [ptr] * 4 + [i32] * 4 + [ptr]
        lib.lstm_wide_last.restype = i32
        lib.lstm_wide_fwd_units.argtypes = [i32]
        lib.lstm_wide_fwd_units.restype = i32
        lib.lstm_wide_error_string.argtypes = [i32]
        lib.lstm_wide_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _wide_bwd_library():
    lib = _build.load("lstm_wide_bwd")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lstm_wide_bwd.argtypes = [i32] + [ptr] * 12 + [i32] * 4 + [ptr]
        lib.lstm_wide_bwd.restype = i32
        lib.lstm_wide_bwd_dw_chunks.argtypes = [i32, i32]
        lib.lstm_wide_bwd_dw_chunks.restype = i32
        lib.lstm_wide_bwd_error_string.argtypes = [i32]
        lib.lstm_wide_bwd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def wide_bwd_weights(w_aug, C):
    """(W_h^T (4H, H), W_x^T (4H, C)) of W_aug (C + H + 1, 4H), contiguous:
    what ``lstm_wide_bwd.cu`` and ``lstm_general.cu`` read, the
    recurrence's W_h^T (the wide one's slice of its rows per CTA) and dx's B
    operand with its columns contiguous. Any width: plain transposes."""
    H = w_aug.shape[1] // 4
    return (w_aug[C:C + H].t().contiguous(), w_aug[:C].t().contiguous())


def general_weights(w_aug):
    """``lstm_general.cu``'s layout of W_aug (C + H + 1, 4H): (C + H + 1, H,
    4), each unit's four gate weights side by side ([k][u][g] =
    W_aug[k][g * H + u]), so a thread reads its unit's row of a k as one
    16-byte (bf16: 8-byte) load; the bias row stays last."""
    H = w_aug.shape[1] // 4
    return w_aug.reshape(w_aug.shape[0], 4, H).transpose(1, 2).contiguous()


def _ceil(a, b):
    return -(-a // b)


def general_fwd_ring_cfg(C, H, N, R):
    """The W_h-ring path's launch shape (``lstm_general_cluster.cu``'s
    ``make_ring_cfg``, f32): clusters of N CTAs over R rows, a multiple of
    CLUSTER_RING_ROWS; the [R][H] f32 h tile (H rounded up to 8, plus 4)
    and S ring slots of W_h's chunk of CLUSTER_RING_CHUNK k
    ([CLUSTER_RING_CHUNK][4hh] f32; x_t . W_x + b is a product of its own
    before the walk). The same dict as
    ``general_fwd_cfg``'s (``ub`` 1, never ``resident``) with ``ring``
    True, or None where it does not fit one CTA."""
    if not (1 <= C <= GENERAL_MAX_C and 1 <= H <= GENERAL_MAX_H):
        return None
    if N not in (2, 4, 8) or R < CLUSTER_RING_ROWS or R % CLUSTER_RING_ROWS:
        return None
    hh = _ceil(_ceil(H, N), 8) * 8
    threads = 32 * (hh // 8) * (R // CLUSTER_RING_ROWS)
    if threads > CLUSTER_RING_MAX_THREADS:
        return None
    G, C16 = 4 * hh, CLUSTER_CHUNK * _ceil(C, CLUSTER_CHUNK)
    kh = _ceil(H, 8) * 8
    w_off = R * (kh + 4) * 4
    slot = CLUSTER_RING_CHUNK * G * 4
    if w_off + 2 * slot > CLUSTER_SMEM_MAX:
        return None
    slots = min((CLUSTER_SMEM_MAX - w_off) // slot, CLUSTER_MAX_SLOTS)
    return {"hh": hh, "ub": 1, "threads": threads, "slots": slots,
            "resident": False, "smem": w_off + slots * slot,
            "layout": N * G * (C16 + kh + 1), "ring": True}


def general_fwd_cfg(C, H, dtype, N, R):
    """``lstm_general_cluster.cu``'s launch shape for clusters of N CTAs over
    R rows (its ``make_cfg``; the card's ``lstm_general_cluster_cfg`` gives
    the same): a dict of ``hh`` (hidden units a CTA: ceil(H / N) rounded up
    to 8, or to 16 where ``ub`` is 2), ``ub`` (the 8-unit blocks a warp
    owns: 2 in bf16 where one a warp would need more than 512 threads),
    ``threads`` (a warp per 32 rows and ``ub`` blocks), ``resident`` (W_x's
    slice and a step's x tile fit in shared memory beside W_h's slice and
    the h tile), ``slots`` (else the x / W_x ring's k16 chunks; 0 when
    resident), ``smem`` (bytes) and ``layout`` (elements of
    ``general_fwd_weights``) and ``ring`` (False), or None where the shape
    does not fit one CTA. ``general_fwd_cfg`` is what the library launches
    at (N, R): this shape where it fits, else in f32 the W_h-ring path's
    (``general_fwd_ring_cfg``)."""
    cfg = _general_fwd_tile_cfg(C, H, dtype, N, R)
    if cfg is None and dtype == torch.float32:
        return general_fwd_ring_cfg(C, H, N, R)
    return cfg


def _general_fwd_tile_cfg(C, H, dtype, N, R):
    """``general_fwd_cfg`` of the kernels of ``make_cfg``, or None."""
    if not (1 <= C <= GENERAL_MAX_C and 1 <= H <= GENERAL_MAX_H):
        return None
    if N not in (2, 4, 8) or R < 32 or R % 32:
        return None
    bf16 = dtype == torch.bfloat16
    hh, ub = _ceil(_ceil(H, N), 8) * 8, 1
    if bf16 and 32 * (hh // 8) * (R // 32) > CLUSTER_MAX_THREADS[dtype]:
        hh, ub = _ceil(_ceil(H, N), 16) * 16, 2
    threads = 32 * (hh // (8 * ub)) * (R // 32)
    if threads > (CLUSTER_MAX_THREADS_X2 if ub == 2
                  else CLUSTER_MAX_THREADS[dtype]):
        return None
    nkx = _ceil(C, CLUSTER_CHUNK)
    G, C16 = 4 * hh, CLUSTER_CHUNK * nkx
    esz, pad = (2, 8) if bf16 else (4, 4)
    kh = _ceil(H, 16 if bf16 else 8) * (16 if bf16 else 8)
    ldh, ldx = kh + pad, C16 + pad
    x_off = (G * ldh * 2 if bf16 else kh * G * 4) + R * ldh * esz
    x_off += threads * 16 * 4 if ub == 2 else 0  # the c carry
    # resident: the x tile, W_x's slice, the mbarrier
    res_end = x_off + R * ldx * esz + (G * ldx * 2 if bf16 else C16 * G * 4)
    slot = (R * (CLUSTER_CHUNK + pad) * esz + G * CLUSTER_CHUNK * esz
            + (G * 8 * 2 if bf16 else 0))
    if res_end + 16 <= CLUSTER_SMEM_MAX:
        resident, slots, smem = True, 0, res_end + 16
    elif x_off + 2 * slot <= CLUSTER_SMEM_MAX:
        resident = False
        slots = min((CLUSTER_SMEM_MAX - x_off) // slot, CLUSTER_MAX_SLOTS)
        smem = x_off + slots * slot
    else:
        return None
    return {"hh": hh, "ub": ub, "threads": threads, "slots": slots,
            "resident": resident, "smem": smem,
            "layout": N * G * (C16 + kh + 1), "ring": False}


def general_fwd_plan(C, H, dtype, clusters=None):
    """The general forward's cluster plan at C inputs and H hidden units in
    ``dtype``: (N, R, shared-memory bytes) for ``lstm_general_cluster.cu``,
    or None, where the shape runs the ring path
    (``general_fwd_bf16_ring_plan``) or, where that refuses it too, the
    streaming ``general_fwd_kernel``.
    ``clusters`` maps N to the clusters of N CTAs the card holds at once
    (default ``H100_CLUSTERS``). For N in 2, 4, 8, R is the fewest rows (a
    multiple of 32) with which GENERAL_FWD_PLAN_BATCH rows run in one wave
    of clusters (a second wave would double the walk: a step's latency does
    not shrink with its work); among the N whose CTA then fits
    (``general_fwd_cfg``) it takes W_x resident (its x product then loads a
    step's x a step ahead, one CTA barrier a step, where a streamed W_x
    waits on L2 every k16 chunk: at bf16 160 N = 4 with R = 96 beats N = 2
    with R = 32 though a CTA does 1.5x the work), then the least work a CTA
    (R x hh, rows and units rounded up), then the deepest ring, then the
    smaller cluster. Where no such CTA fits, f32 takes the W_h-ring path
    (``general_fwd_ring_cfg``) by the same key, R then the fewest rows, a
    multiple of CLUSTER_RING_ROWS, that run the batch in one wave (f32 at
    193-256: N = 8, R = 144)."""
    clusters = clusters or H100_CLUSTERS
    for ring in (False, True):
        rows = CLUSTER_RING_ROWS if ring else 32
        best = None
        for N in (2, 4, 8):
            # the fewest rows a cluster with which the batch takes one wave
            R = _ceil(_ceil(GENERAL_FWD_PLAN_BATCH, clusters[N]), rows) * rows
            cfg = general_fwd_cfg(C, H, dtype, N, R)
            if cfg is None or cfg["ring"] != ring:
                continue
            key = (not cfg["resident"], R * cfg["hh"], -cfg["slots"], N)
            if best is None or key < best[0]:
                best = key, (N, R, cfg["smem"])
        if best is not None:
            return best[1]
    return None


def general_fwd_bf16_ring_cfg(H, dtype):
    """``lstm_general_fwd_ring.cu``'s launch shape (its ``make_cfg``; the
    card's ``lstm_general_fwd_ring_cfg`` gives the same): bf16, CTAs of R =
    FWD_RING_ROWS rows (no cluster), 1 <= H <= FWD_RING_MAX_H. A dict of
    ``hp`` (H rounded up to 8: the 8-unit blocks), ``kp`` (H rounded up to
    16: the mma steps), ``ub`` (blocks a warp, ceil(hp / 8 /
    FWD_RING_WARPS)), ``threads`` (FWD_RING_WARPS warps; the last warp
    done with a slot refills it), ``slots`` (ring slots, each the larger
    of W_h's k16 chunk over all 4hp gate columns, [4hp][16] bf16, and half
    a step's Z_x rows, [R / 2][4H + 8] f32; as many as fit, at most
    FWD_RING_MAX_SLOTS) and ``smem`` (bytes: the mbarriers and slot
    counters, the two h tiles [R][kp + 8] bf16 and the ring), or None where
    it does not take the shape or fewer than two slots fit."""
    if dtype != torch.bfloat16 or not 1 <= H <= FWD_RING_MAX_H:
        return None
    R = FWD_RING_ROWS
    hp, kp = _ceil(H, 8) * 8, _ceil(H, FWD_RING_CHUNK) * FWD_RING_CHUNK
    w_off = FWD_RING_BAR_BYTES + 2 * R * (kp + 8) * 2
    slot = max(4 * hp * FWD_RING_CHUNK * 2, R // 2 * (4 * H + 8) * 4)
    if w_off + 2 * slot > CLUSTER_SMEM_MAX:
        return None
    slots = min((CLUSTER_SMEM_MAX - w_off) // slot, FWD_RING_MAX_SLOTS)
    return {"hp": hp, "kp": kp, "ub": _ceil(hp // 8, FWD_RING_WARPS),
            "threads": 32 * FWD_RING_WARPS, "slots": slots,
            "smem": w_off + slots * slot}


def general_fwd_bf16_ring_plan(C, H, dtype):
    """The general K1/K2's ring plan at C inputs and H hidden units in
    ``dtype``: (R, shared-memory bytes) for ``lstm_general_fwd_ring.cu``,
    or None. It takes bf16 at FWD_RING_MIN_H <= H <= FWD_RING_MAX_H (where
    ``general_fwd_plan`` finds no cluster that holds W_h's slice), any C:
    CTAs of R = FWD_RING_ROWS rows with no cluster (each streams all of
    W_h a step; GENERAL_FWD_PLAN_BATCH rows are one wave of 128 CTAs), so
    the card's cluster capacity does not enter."""
    if not 1 <= C <= GENERAL_MAX_C or dtype != torch.bfloat16:
        return None
    if not FWD_RING_MIN_H <= H <= FWD_RING_MAX_H:
        return None
    cfg = general_fwd_bf16_ring_cfg(H, dtype)
    return None if cfg is None else (FWD_RING_ROWS, cfg["smem"])


def general_fwd_bf16_ring_weights(w_aug, C):
    """``lstm_general_fwd_ring.cu``'s layout of W_h (W_aug's rows C ..
    C + H - 1), in W_aug's dtype and device: (kp / 16, 4hp, 16), chunk c's
    column n holding k = 16 c .. 16 c + 15 of gate n % 32 // 8 of unit 8
    (n // 32) + n % 8 (``general_fwd_weights``' bf16 column order), the two
    8-k halves of a column swapped where n & 4 (the kernel's ldmatrix reads
    8 columns of 32 bytes: the swap puts them on 8 distinct bank quads);
    zero past H in k and units. Flat, so each ring slot is one contiguous
    copy."""
    H = w_aug.shape[1] // 4
    hp = _ceil(H, 8) * 8
    kp = _ceil(H, FWD_RING_CHUNK) * FWD_RING_CHUNK
    w = w_aug.new_zeros((kp, 4, hp))
    w[:H, :, :H] = w_aug[C:C + H].reshape(H, 4, H)
    # [k][n], n = 32 b + 8 j + e, then [c][n][half][8]
    w = w.reshape(kp, 4, hp // 8, 8).permute(0, 2, 1, 3).reshape(kp, 4 * hp)
    w = w.reshape(kp // 16, 2, 8, 4 * hp).permute(0, 3, 1, 2)
    swap = ((torch.arange(4 * hp, device=w.device) >> 2) & 1).bool()
    w = torch.where(swap[None, :, None, None], w.flip(2), w)
    return w.contiguous().reshape(-1)


def general_fwd_path(dtype, C, H, clusters=None):
    """The path of a general K1/K2 call (``route`` "general"): "cluster"
    where ``general_fwd_plan`` takes the shape, "ring" where
    ``general_fwd_bf16_ring_plan`` does, else "stream". Chosen by shape
    before the launch; a launch that fails raises on its path."""
    if general_fwd_plan(C, H, dtype, clusters) is not None:
        return "cluster"
    if general_fwd_bf16_ring_plan(C, H, dtype) is not None:
        return "ring"
    return "stream"


def general_rec_group_cfg(H, dtype, N, R, groups):
    """The row-group path's launch shape (``lstm_general_rec_cluster.cu``'s
    ``make_group_cfg``): f32, clusters of CLUSTER_REC_GROUP_N CTAs of 32
    units (H to 256), one pass, R = 48 ``groups`` rows walked as ``groups``
    (CLUSTER_REC_GROUPS) groups of 48; a thread owns 4 pairs a group.
    Shared memory: W_h^T's slice [128][256] f32, two dgates tiles [48][132]
    f32 and a receive tile [8][48][32] f32. None where it does not take
    the shape."""
    units, rows = CLUSTER_REC_GROUP_UNITS, CLUSTER_REC_GROUP_ROWS
    if dtype != torch.float32 or N != CLUSTER_REC_GROUP_N:
        return None
    if not 1 <= H <= N * units or groups != CLUSTER_REC_GROUPS:
        return None
    if R != groups * rows:
        return None
    k4 = 4 * units
    smem = k4 * N * units * 4 + 2 * rows * (k4 + 4) * 4 + N * rows * units * 4
    return {"hh": units, "hc": units, "nct": N * units,
            "pairs": 4 * groups, "threads": CLUSTER_REC_MAX_THREADS,
            "smem": smem, "groups": groups}


def general_rec_cfg(H, dtype, N, R, P, groups=1):
    """``lstm_general_rec_cluster.cu``'s launch shape for clusters of N CTAs
    over R rows with the exchange in P passes, the rows walked as
    ``groups`` groups (its ``make_cfg``; the card's
    ``lstm_general_rec_cluster_cfg`` gives the same; ``groups`` above 1 is
    the row-group path, ``general_rec_group_cfg``): a dict of ``hh``
    (hidden units a CTA: ceil(H / N) rounded up to 8 P), ``hc`` (units a
    pass, hh / P), ``nct`` (columns of a pass's product: N hc rounded up to
    a 32-unit tile), ``pairs`` (the (row, unit) pairs a thread owns: the
    first of the dtype's CLUSTER_REC_PAIRS within 384 threads), ``threads``
    (hh x
    ceil(R / pairs), rounded up to a warp) and ``smem`` (bytes: W_h^T's
    slice, the dgates tile, the receive tile [N][R][hc] f32 and, with
    passes, the dh tile [R][hh] f32) and ``groups`` (1), or None where the
    shape does not fit one CTA."""
    if groups != 1:
        if P != 1:
            return None
        return general_rec_group_cfg(H, dtype, N, R, groups)
    if not 1 <= H <= GENERAL_MAX_H or N not in (2, 4, 8):
        return None
    if R < 32 or R % 32 or not 1 <= P <= CLUSTER_REC_MAX_PASSES:
        return None
    hh = _ceil(_ceil(H, N), 8 * P) * 8 * P
    hc = hh // P
    nct = _ceil(N * hc, 32) * 32
    k4 = 4 * hh
    if dtype == torch.bfloat16:
        w_bytes = P * nct * (k4 + 8) * 2
        d_bytes = R * (k4 + 8) * 2
    else:
        w_bytes = k4 * (P * nct + 4) * 4
        d_bytes = R * (k4 + 4) * 4
    for pairs in CLUSTER_REC_PAIRS[dtype]:
        threads = _ceil(hh * _ceil(R, pairs), 32) * 32
        if threads <= CLUSTER_REC_MAX_THREADS:
            break
    else:
        return None
    smem = w_bytes + d_bytes + N * R * hc * 4 + (R * hh * 4 if P > 1 else 0)
    if smem > CLUSTER_SMEM_MAX:
        return None
    return {"hh": hh, "hc": hc, "nct": nct, "pairs": pairs,
            "threads": threads, "smem": smem, "groups": 1}


def general_rec_plan(C, H, dtype, clusters=None):
    """The general K3's cluster plan at C inputs and H hidden units in
    ``dtype``: (N, R, shared-memory bytes, passes P, row groups) for
    ``lstm_general_rec_cluster.cu``'s recurrence, or None, where the shape
    runs the ring path (``general_rec_ring_plan``) or, where that refuses
    it too, the streaming ``general_rec_kernel``. ``clusters`` maps N to the
    clusters of N CTAs the card holds at once (default ``H100_CLUSTERS``).
    For N in 2, 4, 8, R is the fewest rows (a multiple of 32) with which
    GENERAL_FWD_PLAN_BATCH rows run in one wave of clusters, and P the
    fewest passes with which the CTA fits (``general_rec_cfg``); among the
    N that fit it takes the fewest passes (each costs a cluster barrier's
    round trip on the chain), then the least work a CTA (R x hh, the
    (row, unit) pairs of its gate math and the rows x columns of its
    product), then the smaller cluster: ``general_rec_cluster_kernel``,
    one row group. Where none fits, f32 takes the row-group path
    (``general_rec_group_cfg``) if it fits: clusters of 8 over the fewest
    rows, a multiple of 48, that run the batch in one wave, walked as
    groups of 48. C does not enter: the products around the walk take any
    width."""
    clusters = clusters or H100_CLUSTERS
    if not 1 <= C <= GENERAL_MAX_C:
        return None
    best = None
    for N in (2, 4, 8):
        R = _ceil(_ceil(GENERAL_FWD_PLAN_BATCH, clusters[N]), 32) * 32
        for P in range(1, CLUSTER_REC_MAX_PASSES + 1):
            cfg = general_rec_cfg(H, dtype, N, R, P)
            if cfg is not None:
                key = (P, R * cfg["hh"], N)
                if best is None or key < best[0]:
                    best = key, (N, R, cfg["smem"], P, 1)
                break
    if best is not None:
        return best[1]
    N, rows = CLUSTER_REC_GROUP_N, CLUSTER_REC_GROUP_ROWS
    groups = _ceil(_ceil(GENERAL_FWD_PLAN_BATCH, clusters[N]), rows)
    cfg = general_rec_cfg(H, dtype, N, groups * rows, 1, groups)
    return None if cfg is None else (N, groups * rows, cfg["smem"], 1, groups)


def general_rec_ring_cfg(H, dtype):
    """``lstm_general_rec_ring.cu``'s launch shape (its ``make_cfg``; the
    card's ``lstm_general_rec_ring_cfg`` gives the same), CTAs of R =
    RING_REC_ROWS rows (no cluster), 1 <= H <= RING_REC_MAX_H, or None where
    it does not take the shape or too few slots fit. f32: a dict of ``hp``
    (H rounded up to 4), ``warps`` (consumer warps a group, two groups that
    take every other chunk: ceil(hp / 128)), ``threads`` (both groups and
    one producer warp), ``slots`` (ring slots of RING_REC_CHUNK rows of
    W_h^T, [RING_REC_CHUNK][hp] f32, as many as fit, at most
    RING_REC_MAX_SLOTS, at least 2) and ``smem`` (bytes: the mbarriers, the
    dgates tile [R][4hp] f32, the groups' exchange tile [R][hp] f32 and the
    ring). bf16: ``hp`` (H rounded up to 8), ``ub`` (n8 tiles of units a
    consumer warp: ceil(hp / 8 / RING_REC_BF16_WARPS)), ``threads`` (the
    consumer warps and a producer warpgroup), ``slots`` (at
    least 3: a half's gate math holds its two Z items and its c item) and
    ``smem`` (the full and empty mbarriers, the A tile [R][4hp + 8] bf16,
    then the ring from a 128-byte boundary; a slot the largest of a W_h^T
    chunk [hp][RING_REC_BF16_CHUNK] bf16, a Z item [RING_REC_BF16_ZROWS][4H
    rounded up to 16, + 8] f32 and a c item [3][8][hp | 8] bf16, rounded up
    to 128 bytes)."""
    if dtype not in (torch.float32, torch.bfloat16):
        return None
    if not 1 <= H <= RING_REC_MAX_H:
        return None
    R = RING_REC_ROWS
    if dtype == torch.bfloat16:
        hp = _ceil(H, 8) * 8
        w_off = _ceil(RING_REC_BAR_BYTES + R * (4 * hp + 8) * 2, 128) * 128
        z_item = RING_REC_BF16_ZROWS * (_ceil(4 * H, 16) * 16 + 8) * 4
        slot = _ceil(max(RING_REC_BF16_CHUNK * hp * 2, z_item,
                         3 * 8 * (hp | 8) * 2), 128) * 128
        if w_off + 3 * slot > CLUSTER_SMEM_MAX:
            return None
        slots = min((CLUSTER_SMEM_MAX - w_off) // slot, RING_REC_MAX_SLOTS)
        return {"hp": hp, "ub": _ceil(hp // 8, RING_REC_BF16_WARPS),
                "threads": 32 * RING_REC_BF16_WARPS + 128, "slots": slots,
                "smem": w_off + slots * slot}
    hp = _ceil(H, 4) * 4
    warps = _ceil(hp, 128)
    w_off = RING_REC_BAR_BYTES + R * 4 * hp * 4 + R * hp * 4
    slot = RING_REC_CHUNK * hp * 4
    if w_off + 2 * slot > CLUSTER_SMEM_MAX:
        return None
    slots = min((CLUSTER_SMEM_MAX - w_off) // slot, RING_REC_MAX_SLOTS)
    return {"hp": hp, "warps": warps, "threads": 32 * (2 * warps + 1),
            "slots": slots, "smem": w_off + slots * slot}


def general_rec_ring_plan(C, H, dtype):
    """The general K3's ring plan at C inputs and H hidden units in
    ``dtype``: (R, shared-memory bytes) for ``lstm_general_rec_ring.cu``,
    or None. It takes f32 and bf16 at RING_REC_MIN_H <= H <= RING_REC_MAX_H
    (where ``general_rec_plan`` finds no cluster that holds W_h^T's slice),
    any C: CTAs of R = RING_REC_ROWS rows with no cluster (each streams all
    of W_h^T a step; GENERAL_FWD_PLAN_BATCH rows are one wave of 128 CTAs),
    so the card's cluster capacity does not enter."""
    if not 1 <= C <= GENERAL_MAX_C:
        return None
    if not RING_REC_MIN_H <= H <= RING_REC_MAX_H:
        return None
    cfg = general_rec_ring_cfg(H, dtype)
    return None if cfg is None else (RING_REC_ROWS, cfg["smem"])


def general_rec_ring_weights(w_ht):
    """``lstm_general_rec_ring.cu``'s f32 layout of W_h^T (4H, H)
    (``wide_bwd_weights``' first): (4hp, hp) f32, hp = H rounded up to 4,
    row g hp + u' gate g of unit u' (W_h^T's row g H + u'), zero past H in
    rows and columns, so every ring chunk is one 16-byte-aligned copy.
    W_h^T itself where H is a multiple of 4."""
    G, H = w_ht.shape
    hp = _ceil(H, 4) * 4
    if hp == H:
        return w_ht
    out = w_ht.new_zeros((4, hp, hp))
    out[:, :H, :H] = w_ht.reshape(4, H, H)
    return out.reshape(4 * hp, hp)


def general_rec_ring_bf16_weights(w_aug, C):
    """``lstm_general_rec_ring.cu``'s bf16 layout of W_h^T (W_aug's rows C ..
    C + H - 1, transposed), in W_aug's dtype and device: (4hp / 32, hp, 32),
    hp = H rounded up to 8; chunk c's row n (a unit of dh) holds k = 32 c ..
    32 c + 31 (k = g hp + u', gate g of unit u': W_aug[C + n, g H + u']) as
    four 16-byte segments of 8 k, segment p stored at p ^ ((n >> 1) & 3)
    (the kernel's ldmatrix reads 8 rows n of 64 bytes: the swizzle puts
    them on 8 distinct bank quads); zero past H in k and n. Flat, so each
    ring slot is one contiguous copy."""
    H = w_aug.shape[1] // 4
    hp = _ceil(H, 8) * 8
    w = w_aug.new_zeros((4, hp, hp))  # [g][u'][n]
    w[:, :H, :H] = w_aug[C:C + H].reshape(H, 4, H).permute(1, 2, 0)
    nk = 4 * hp // RING_REC_BF16_CHUNK
    # [k][n] -> [c][n][segment][8]
    w = w.reshape(nk, 4, 8, hp).permute(0, 3, 1, 2)
    n = torch.arange(hp, device=w.device)
    seg = torch.arange(4, device=w.device)[None, :] ^ ((n[:, None] >> 1) & 3)
    return w[:, n[:, None], seg].contiguous().reshape(-1)


def general_rec_ring_layout(w_aug, C):
    """The ring path's W_h^T in W_aug's dtype: ``general_rec_ring_weights``
    of W_aug[C:C + H]^T in f32, ``general_rec_ring_bf16_weights`` in
    bf16."""
    if w_aug.dtype == torch.bfloat16:
        return general_rec_ring_bf16_weights(w_aug, C)
    H = w_aug.shape[1] // 4
    return general_rec_ring_weights(w_aug[C:C + H].t().contiguous())


def general_bwd_path(dtype, C, H, clusters=None):
    """The path of a general K3 call (``route`` "general"): "cluster" where
    ``general_rec_plan`` takes the shape, "ring" where
    ``general_rec_ring_plan`` does, else "stream". Chosen by shape before
    the launch; a launch that fails raises on its path."""
    if general_rec_plan(C, H, dtype, clusters) is not None:
        return "cluster"
    if general_rec_ring_plan(C, H, dtype) is not None:
        return "ring"
    return "stream"


@functools.lru_cache(maxsize=None)
def _cluster_index(C, H, N, hh, bf16):
    """Flat indices into W_aug (C + H + 1, 4H) of each element of
    ``general_fwd_weights``' layout; (C + H + 1) 4H (one past W_aug) where
    the element is zero."""
    G = 4 * hh
    C16 = _ceil(C, CLUSTER_CHUNK) * CLUSTER_CHUNK
    kh = _ceil(H, 16 if bf16 else 8) * (16 if bf16 else 8)
    zero = (C + H + 1) * 4 * H
    n = np.arange(N * G)
    nn = n % G
    if bf16:
        unit, gate = 8 * (nn // 32) + nn % 8, (nn % 32) // 8
    else:
        unit, gate = nn // 4, nn % 4
    unit = (n // G) * hh + unit
    col = np.where(unit < H, gate * H + unit, -1)

    def block(row0, n_rows, depth):
        k = np.arange(depth)[:, None]
        idx = np.where((k < n_rows) & (col >= 0)[None, :],
                       (row0 + k) * 4 * H + col[None, :], zero)
        return (idx.T if bf16 else idx).reshape(-1)

    return np.concatenate([block(0, C, C16), block(C, H, kh),
                           block(C + H, 1, 1)]).astype(np.int64)


_CLUSTER_INDEX_ON = {}


def general_fwd_weights(w_aug, C, N, hh):
    """``lstm_general_cluster.cu``'s layout of W_aug (C + H + 1, 4H) for
    clusters of N CTAs of hh units each (``general_fwd_cfg``), in W_aug's
    dtype and device: W_x (16 ceil(C / 16)
    k), then W_h (H rounded up to 16 in bf16, to 8 in f32), then the bias,
    each over N 4hh gate columns, CTA r's r 4hh .. (r + 1) 4hh. Column n of a
    CTA is gate (n % 32) // 8 of its unit 8 (n // 32) + n % 8 in bf16 (a
    warp's 4 n8 mma tiles, one gate each), gate n % 4 of unit n // 4 in f32
    (a unit's four gates side by side); units past H and k past C, H are
    zero. bf16 stores each of W_x, W_h gate-column-major (N 4hh, k), f32
    k-major (k, N 4hh)."""
    H = w_aug.shape[1] // 4
    key = (C, H, N, hh, w_aug.dtype == torch.bfloat16, w_aug.device)
    idx = _CLUSTER_INDEX_ON.get(key)
    if idx is None:
        idx = torch.from_numpy(_cluster_index(*key[:5])).to(w_aug.device)
        _CLUSTER_INDEX_ON[key] = idx
    flat = torch.cat([w_aug.reshape(-1), w_aug.new_zeros(1)])
    return flat[idx]


def _cluster_library():
    lib = _build.load("lstm_general_cluster")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lstm_general_cluster_fwd.argtypes = ([i32] + [ptr] * 5
                                                 + [i32] * 6 + [ptr])
        lib.lstm_general_cluster_fwd.restype = i32
        lib.lstm_general_ring_fwd.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        lib.lstm_general_ring_fwd.restype = i32
        lib.lstm_general_cluster_cfg.argtypes = [i32] * 5 + [ptr]
        lib.lstm_general_cluster_cfg.restype = i32
        lib.lstm_general_cluster_capacity.argtypes = [i32]
        lib.lstm_general_cluster_capacity.restype = i32
        lib.lstm_general_cluster_error_string.argtypes = [i32]
        lib.lstm_general_cluster_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def cluster_capacity(index):
    """{N: clusters of N CTAs} that CUDA device ``index`` holds at once, one
    CTA an SM (``lstm_general_cluster_capacity``); raises where the card
    holds none."""
    lib = _cluster_library()
    with torch.cuda.device(index):
        caps = {n: lib.lstm_general_cluster_capacity(n) for n in (2, 4, 8)}
    if min(caps.values()) < 1:
        raise RuntimeError(f"lstm_general_cluster: the card holds no "
                           f"cluster of some size: {caps}")
    return caps


def _general_fwd_launch(leg, x, w_aug, C, H):
    """(launch, error string, path) of a general K1/K2 call: the cluster
    kernel behind the main-shape launchers' signature where
    ``general_fwd_plan`` takes the shape on this card, the ring library
    where ``general_fwd_bf16_ring_plan`` does, else the streaming
    ``general_fwd_kernel``. The f32 W_h-ring kernel (``general_fwd_cfg``'s
    ``ring``) and the ring library take a Z_x scratch of (T, B, 4H) f32,
    allocated a call (1.04 GB at T = 124, B = 2048, H = 256; 2.08 GB at
    512)."""
    plan = general_fwd_plan(C, H, x.dtype,
                            cluster_capacity(x.device.index or 0))
    bf16 = int(x.dtype == torch.bfloat16)
    if plan is None and general_fwd_bf16_ring_plan(C, H, x.dtype):
        lib = _general_fwd_ring_library()
        wr = general_fwd_bf16_ring_weights(w_aug, C)

        def ring(x_ptr, w_ptr, out_ptr, *rest):
            if leg == "last":  # (out, T, B, C, H, stream)
                hs_ptr, cs_ptr, last_ptr = None, None, out_ptr
            else:  # (hs, cs, T, B, C, H, stream)
                (hs_ptr, cs_ptr, last_ptr), rest = (out_ptr, rest[0], None), \
                    rest[1:]
            T, B = rest[:2]
            zx = torch.empty((T, B, 4 * H), dtype=torch.float32,
                             device=x.device)
            return lib.lstm_general_fwd_ring(
                x_ptr, w_ptr, wr.data_ptr(), zx.data_ptr(), hs_ptr, cs_ptr,
                last_ptr, *rest)

        return ring, lib.lstm_general_fwd_ring_error_string, "ring"
    if plan is None:
        lib = _general_library()
        fn = lib.lstm_general_last if leg == "last" else lib.lstm_general_fwd
        return (_general_launch(fn, x.dtype, w_aug),
                lib.lstm_general_error_string, "stream")
    N, R, _ = plan
    lib = _cluster_library()
    cfg = general_fwd_cfg(C, H, x.dtype, N, R)
    wl = general_fwd_weights(w_aug, C, N, cfg["hh"])

    def ring(x_ptr, _w_ptr, out_ptr, *rest):
        if leg == "last":  # (out, T, B, C, H, stream)
            hs_ptr, cs_ptr, last_ptr = None, None, out_ptr
        else:  # (hs, cs, T, B, C, H, stream)
            (hs_ptr, cs_ptr, last_ptr), rest = (out_ptr, rest[0], None), \
                rest[1:]
        T, B = rest[:2]
        zx = torch.empty((T, B, 4 * H), dtype=torch.float32, device=x.device)
        err = lib.lstm_general_ring_fwd(
            x_ptr, w_aug.data_ptr(), wl.data_ptr(), zx.data_ptr(), hs_ptr,
            cs_ptr, last_ptr, *rest[:4], N, R, 3, rest[4])
        if err == 0 and T * B > 0:
            LAUNCHES_PROD["gates_x", prod_f32_path("gates_x", C, H, x,
                                                   w_aug)] += 1
        return err

    if cfg["ring"]:
        return ring, lib.lstm_general_cluster_error_string, "cluster"

    def launch(x_ptr, _w_ptr, out_ptr, *rest):
        if leg == "last":  # (out, T, B, C, H, stream)
            return lib.lstm_general_cluster_fwd(
                bf16, x_ptr, wl.data_ptr(), None, None, out_ptr, *rest[:4],
                N, R, rest[4])
        cs_ptr, *rest = rest  # (hs, cs, T, B, C, H, stream)
        return lib.lstm_general_cluster_fwd(
            bf16, x_ptr, wl.data_ptr(), out_ptr, cs_ptr, None, *rest[:4], N,
            R, rest[4])

    return launch, lib.lstm_general_cluster_error_string, "cluster"


def _general_fwd_ring_library():
    lib = _build.load("lstm_general_fwd_ring")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lstm_general_fwd_ring.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
        lib.lstm_general_fwd_ring.restype = i32
        lib.lstm_general_fwd_ring_walk.argtypes = [ptr] * 5 + [i32] * 3 \
            + [ptr]
        lib.lstm_general_fwd_ring_walk.restype = i32
        lib.lstm_general_fwd_ring_cfg.argtypes = [i32, ptr]
        lib.lstm_general_fwd_ring_cfg.restype = i32
        lib.lstm_general_fwd_ring_error_string.argtypes = [i32]
        lib.lstm_general_fwd_ring_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _general_library():
    lib = _build.load("lstm_general")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lstm_general_fwd.argtypes = [i32] + [ptr] * 4 + [i32] * 4 + [ptr]
        lib.lstm_general_fwd.restype = i32
        lib.lstm_general_last.argtypes = [i32] + [ptr] * 3 + [i32] * 4 + [ptr]
        lib.lstm_general_last.restype = i32
        lib.lstm_general_bwd.argtypes = [i32] + [ptr] * 12 + [i32] * 4 + [ptr]
        lib.lstm_general_bwd.restype = i32
        lib.lstm_general_rec.argtypes = [i32] + [ptr] * 5 + [i32] * 3 + [ptr]
        lib.lstm_general_rec.restype = i32
        lib.lstm_general_bwd_dw_chunks.argtypes = [i32, i32]
        lib.lstm_general_bwd_dw_chunks.restype = i32
        for fn in ("lstm_general_max_c", "lstm_general_max_h"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i32
        lib.lstm_general_error_string.argtypes = [i32]
        lib.lstm_general_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _general_rec_library():
    lib = _build.load("lstm_general_rec_cluster")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lstm_general_rec_cluster_bwd.argtypes = ([i32] + [ptr] * 12
                                                     + [i32] * 8 + [ptr])
        lib.lstm_general_rec_cluster_bwd.restype = i32
        lib.lstm_general_rec_cluster_rec.argtypes = ([i32] + [ptr] * 5
                                                     + [i32] * 7 + [ptr])
        lib.lstm_general_rec_cluster_rec.restype = i32
        lib.lstm_general_rec_cluster_cfg.argtypes = [i32] * 6 + [ptr]
        lib.lstm_general_rec_cluster_cfg.restype = i32
        lib.lstm_general_rec_cluster_dw_chunks.argtypes = [i32, i32]
        lib.lstm_general_rec_cluster_dw_chunks.restype = i32
        lib.lstm_general_rec_cluster_error_string.argtypes = [i32]
        lib.lstm_general_rec_cluster_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _general_rec_ring_library():
    lib = _build.load("lstm_general_rec_ring")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lstm_general_rec_ring_bwd.argtypes = ([i32] + [ptr] * 12
                                                  + [i32] * 4 + [ptr])
        lib.lstm_general_rec_ring_bwd.restype = i32
        lib.lstm_general_rec_ring_rec.argtypes = ([i32] + [ptr] * 5
                                                  + [i32] * 3 + [ptr])
        lib.lstm_general_rec_ring_rec.restype = i32
        lib.lstm_general_rec_ring_cfg.argtypes = [i32, i32, ptr]
        lib.lstm_general_rec_ring_cfg.restype = i32
        lib.lstm_general_rec_ring_dw_chunks.argtypes = [i32, i32]
        lib.lstm_general_rec_ring_dw_chunks.restype = i32
        lib.lstm_general_rec_ring_error_string.argtypes = [i32]
        lib.lstm_general_rec_ring_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


# each general K3 path's library loader and entries: (loader, K3, the
# recurrence alone, dW chunks, error string)
_GENERAL_BWD_ENTRIES = {
    "cluster": ("_general_rec_library", "lstm_general_rec_cluster_bwd",
                "lstm_general_rec_cluster_rec",
                "lstm_general_rec_cluster_dw_chunks",
                "lstm_general_rec_cluster_error_string"),
    "ring": ("_general_rec_ring_library", "lstm_general_rec_ring_bwd",
             "lstm_general_rec_ring_rec", "lstm_general_rec_ring_dw_chunks",
             "lstm_general_rec_ring_error_string"),
    "stream": ("_general_library", "lstm_general_bwd", "lstm_general_rec",
               "lstm_general_bwd_dw_chunks", "lstm_general_error_string"),
}


def _with_plan(fn, plan, *args):
    """``fn`` with the cluster plan's N, R, passes and row groups before
    the stream, its last argument."""
    return fn(*args[:-1], *plan, args[-1])


def _general_k3_launch(dtype, C, H, device):
    """(path, K3, the recurrence alone, dW chunks, error string) of a
    general K3 call on the path ``general_bwd_path`` picks by shape on this
    card, before the launch: the library entries of ``_GENERAL_BWD_ENTRIES``
    (``lstm_general_rec_cluster.cu``, ``lstm_general_rec_ring.cu`` or
    ``lstm_general.cu``'s streaming kernel). K3 takes (bf16, 12 pointers,
    T, B, C, H, stream), the recurrence (bf16, z, cs, dhs, W_h^T, dg, T, B,
    H, stream); on the ring path W_h^T is ``general_rec_ring_layout``'s."""
    caps = cluster_capacity(device.index or 0)
    path = general_bwd_path(dtype, C, H, caps)
    loader, *names = _GENERAL_BWD_ENTRIES[path]
    lib = globals()[loader]()
    bwd, rec, chunks, error_string = (getattr(lib, n) for n in names)
    if path == "cluster":
        N, R, _, P, groups = general_rec_plan(C, H, dtype, caps)
        bwd, rec = (functools.partial(_with_plan, fn, (N, R, P, groups))
                    for fn in (bwd, rec))
    return path, bwd, rec, chunks, error_string


def general_recurrence(z, cs, dhs, w_aug):
    """The general K3's reverse recurrence alone: dgates (T, B, 4H) in cs's
    dtype (``lstm_bwd_recurrence_reference``, its plain version, on CPU
    tensors) on the path ``general_bwd_path`` picks for the shape
    (``_general_k3_launch``): ``lstm_general_rec_cluster.cu``'s clusters,
    ``lstm_general_rec_ring.cu`` or ``lstm_general.cu``'s
    ``general_rec_kernel``. Counted in LAUNCHES_GENERAL_BWD by path."""
    if cs.device.type == "cpu":
        return lstm_bwd_recurrence_reference(z, cs, dhs, w_aug)
    name = "general_recurrence"
    if cs.device.type != "cuda" or cs.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: no kernel for {cs.dtype} on {cs.device}")
    if cs.dim() != 3:
        raise ValueError(f"{name}: cs must be (T, B, H), got "
                         f"{tuple(cs.shape)}")
    T, B, H = cs.shape
    C = w_aug.shape[0] - H - 1
    if w_aug.shape[1] != 4 * H or route("bwd", cs.dtype, C, H) != "general":
        raise ValueError(f"{name}: W_aug {tuple(w_aug.shape)} is not a "
                         f"general leg's at H={H}")
    for t, shape, dtype in ((z, (T, B, 4 * H), torch.float32),
                            (dhs, (T, B, H), cs.dtype),
                            (w_aug, w_aug.shape, cs.dtype)):
        if t.shape != shape or t.dtype != dtype or t.device != cs.device \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {tuple(t.shape)} {t.dtype} is not a contiguous "
                f"{tuple(shape)} {dtype} on {cs.device}")
    if not cs.is_contiguous():
        raise ValueError(f"{name}: operands must be contiguous")
    path, _, run, _, error_string = _general_k3_launch(cs.dtype, C, H,
                                                       cs.device)
    w_ht = (general_rec_ring_layout(w_aug, C) if path == "ring"
            else w_aug[C:C + H].t().contiguous())
    dg = torch.empty((T, B, 4 * H), dtype=cs.dtype, device=cs.device)
    with torch.cuda.device(cs.device):
        err = run(int(cs.dtype == torch.bfloat16), z.data_ptr(),
                  cs.data_ptr(), dhs.data_ptr(), w_ht.data_ptr(),
                  dg.data_ptr(), T, B, H,
                  torch.cuda.current_stream().cuda_stream)
    _raise_on(error_string, name, err)
    LAUNCHES_GENERAL_BWD[path] += 1
    return dg


def _general_launch(fn, dtype, w_aug):
    """``lstm_general.cu``'s forward launcher ``fn`` behind the main-shape
    launchers' signature (x, W_aug, outputs..., T, B, C, H, stream): the
    dtype flag first, and W_aug replaced by ``general_weights``' layout."""
    bf16 = int(dtype == torch.bfloat16)
    w_il = general_weights(w_aug)

    def launch(x_ptr, _w_ptr, *rest):
        return fn(bf16, x_ptr, w_il.data_ptr(), *rest)

    return launch


def _fwd_mma_library(name, C, H):
    """The library of K1's and K2's bf16 leg, after the shape check."""
    msg = fwd_mma_shape_error(name, C, H)
    if msg is not None:
        raise ValueError(msg)
    lib = _build.load("lstm_fwd_mma")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lstm_fwd_mma.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.lstm_fwd_mma.restype = i32
        lib.lstm_fwd_mma_last.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
        lib.lstm_fwd_mma_last.restype = i32
        for fn in ("lstm_fwd_mma_max_c", "lstm_fwd_mma_max_h"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i32
        lib.lstm_fwd_mma_error_string.argtypes = [i32]
        lib.lstm_fwd_mma_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def lstm_last(params, x):
    """Final hidden state h_{T-1} of a forward LSTM over x (T, B, C): (B, H)
    in x's dtype. f32 runs full-f32 arithmetic (``lstm_fwd_f32.cu``); bf16
    takes bf16 operands (h included) with f32 sums and f32 h/c carries on
    the tensor cores (``lstm_fwd_mma.cu``, last-only). Shapes those
    kernels refuse run ``lstm_wide.cu`` or, above C, H = 128, the general
    leg on the path ``general_fwd_path`` picks (``route``)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return lstm_last_reference(params, x)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_last: no kernel for device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"lstm_last: unsupported dtype {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("lstm_last: x must be a contiguous (T, B, C) tensor")
    T, B, C = x.shape
    H = params["w_hh"].shape[1]
    if params["w_ih"].shape != (4 * H, C):
        raise ValueError(
            f"lstm_last: w_ih {tuple(params['w_ih'].shape)} does not match "
            f"C={C}, H={H}"
        )
    w_aug = make_w_aug(params, x.dtype)
    if w_aug.device != x.device:
        raise ValueError("lstm_last: params and x are on different devices")
    kind = route("last", x.dtype, C, H)
    path = None
    if kind == "general":
        launch, error_string, path = _general_fwd_launch("last", x, w_aug, C,
                                                         H)
    elif kind == "wide":
        lib = _wide_library()
        launch = _wide_launch(lib.lstm_wide_last, x.dtype, w_aug, C)
        error_string = lib.lstm_wide_error_string
    elif x.dtype == torch.bfloat16:
        lib = _fwd_mma_library("lstm_last", C, H)
        launch, error_string = lib.lstm_fwd_mma_last, \
            lib.lstm_fwd_mma_error_string
    else:
        lib = _f32_fwd_library()
        launch, error_string = lib.lstm_fwd_f32_last, \
            lib.lstm_fwd_f32_error_string
    out = torch.empty((B, H), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), w_aug.data_ptr(), out.data_ptr(), T, B, C,
                     H, torch.cuda.current_stream().cuda_stream)
    _raise_on(error_string, "lstm_last", err)
    LAUNCHES += 1
    _count_leg(kind, "last", path)
    return out


def _count_leg(kind, leg, path=None):
    """One launch of ``leg`` on the wide or the general kernels (``path``:
    the general leg's, "cluster", "ring" or "stream")."""
    if kind == "wide":
        LAUNCHES_WIDE[leg] += 1
    elif kind == "general":
        LAUNCHES_GENERAL[leg] += 1
        if path is not None:
            paths = LAUNCHES_GENERAL_BWD if leg == "bwd" \
                else LAUNCHES_GENERAL_FWD
            paths[path] += 1


# ---------------- K2 / K3: the training pair ----------------


def _gates(z, H):
    return (torch.sigmoid(z[..., :H]), torch.sigmoid(z[..., H:2 * H]),
            torch.tanh(z[..., 2 * H:3 * H]), torch.sigmoid(z[..., 3 * H:]))


def lstm_fwd_reference(x, w_aug, want_cs=True):
    """Plain version of K2: (hs, cs) of a forward LSTM over x (T, B, C) with
    W_aug (C + H + 1, 4H), both (T, B, H) in x's dtype (cs None unless
    ``want_cs``). The kernel's numerics: operands in x's dtype (h rounded
    into it every step), f32 products and sums, h and c carried in f32."""
    T, B, C = x.shape
    H = w_aug.shape[1] // 4
    w = w_aug[: C + H].float()
    x_proj = _x_projection(x, w_aug)
    hs = x.new_empty((T, B, H))
    cs = x.new_empty((T, B, H)) if want_cs else None
    h_op = x.new_zeros((B, H))
    c = x_proj.new_zeros((B, H))
    for t in range(T):
        i, f, g, o = _gates(x_proj[t] + h_op.float() @ w[C:], H)
        c = f * c + i * g
        h_op = (o * torch.tanh(c)).to(x.dtype)
        hs[t] = h_op
        if want_cs:
            cs[t] = c.to(x.dtype)
    return hs, cs


def _x_projection(x, w_aug):
    """x_t . W_x + b of every step, (T, B, 4H) f32 from f32 sums of the
    operands in x's dtype: the forward's x part (the W_h-ring path's Z_x)."""
    T, B, C = x.shape
    H = w_aug.shape[1] // 4
    z = (x.reshape(T * B, C).float() @ w_aug[: C + H].float()[:C])
    return z.reshape(T, B, 4 * H) + w_aug[C + H].float()


def _xh(x, hs):
    """[x_t ; h_{t-1}] of every step, (T, B, C + H) in x's dtype, with
    h_{-1} = 0."""
    zero = hs.new_zeros((1, *hs.shape[1:]))
    return torch.cat([x, torch.cat([zero, hs[:-1]])], dim=-1)


def lstm_bwd_gates_reference(x, w_aug, hs):
    """Plain version of K3's gate recompute: Z = [x_t ; h_{t-1}] @
    W_aug[:C+H] + b for every step, (T, B, 4H) f32 from f32 sums of the
    operands in x's dtype. Needs no carry: one matmul."""
    T, B, C = x.shape
    H = w_aug.shape[1] // 4
    w = w_aug[: C + H].float()
    z = (_xh(x, hs).reshape(T * B, C + H).float() @ w).reshape(T, B, 4 * H)
    return z + w_aug[C + H].float()


def lstm_bwd_recurrence_reference(z, cs, dhs, w_aug):
    """Plain version of K3's reverse recurrence, its only serial part: the
    gate cotangents dgates (T, B, 4H) in cs's dtype from the gate
    pre-activations z (``lstm_bwd_gates_reference``), the saved c and the
    hidden-state cotangents. ``_bwd_kernel``'s math: the dh and dc carries
    are f32, dgates are rounded into cs's dtype once, and the carry
    dh_{t-1} = dgates_t @ W_h^T takes the rounded dgates."""
    T, B, G = z.shape
    H = G // 4
    C = w_aug.shape[0] - H - 1
    dt = cs.dtype
    i, f, g, o = _gates(z, H)
    c_prev = torch.cat([cs.new_zeros((1, B, H)), cs[:-1]]).float()
    tanh_c = torch.tanh(cs.float())
    dg = cs.new_empty((T, B, G))
    dh_c = z.new_zeros((B, H))
    dc_c = z.new_zeros((B, H))
    w_h_t = w_aug[C: C + H].float().T
    for t in range(T - 1, -1, -1):
        dh = dhs[t].float() + dh_c
        dc = dc_c + dh * o[t] * (1.0 - tanh_c[t] * tanh_c[t])
        dg[t] = torch.cat([
            dc * g[t] * i[t] * (1.0 - i[t]),
            dc * c_prev[t] * f[t] * (1.0 - f[t]),
            dc * i[t] * (1.0 - g[t] * g[t]),
            dh * tanh_c[t] * o[t] * (1.0 - o[t]),
        ], dim=-1).to(dt)
        dc_c = dc * f[t]
        dh_c = dg[t].float() @ w_h_t
    return dg


def lstm_bwd_products_reference(x, hs, w_aug, dg):
    """Plain version of K3's two products off the chain: dx = dgates @
    W_x^T (x's dtype, rounded once) and dW_aug = [x ; h_{t-1} ; 1]^T @
    dgates (f32, C + H + 1 rows: the last, the bias's, is the dgates
    sum)."""
    T, B, C = x.shape
    H = w_aug.shape[1] // 4
    dg2 = dg.reshape(T * B, 4 * H).float()
    dx = (dg2 @ w_aug[:C].float().T).reshape(T, B, C).to(x.dtype)
    dw = torch.cat([_xh(x, hs).reshape(T * B, C + H).float().T @ dg2,
                    dg2.sum(0, keepdim=True)])
    return dx, dw


def lstm_bwd_reference(x, w_aug, hs, cs, dhs):
    """Plain version of K3: (dx in x's dtype, dW_aug f32 (C + H + 1, 4H)),
    the composition of its three parts. ``_bwd_kernel``'s math: the gates
    are recomputed from the saved h and c (read as f32 from x's dtype),
    the dh and dc carries are f32, dgates are rounded into x's dtype before
    every product, and the bias row of dW is the dgates sum. Only the
    carries walk time in reverse; the gates of every step come from one
    matmul before, and dx and dW from two after."""
    z = lstm_bwd_gates_reference(x, w_aug, hs)
    dg = lstm_bwd_recurrence_reference(z, cs, dhs, w_aug)
    return lstm_bwd_products_reference(x, hs, w_aug, dg)


def _bwd_f32_library(C, H):
    """The library of K3's f32 leg, after the shape check."""
    msg = bwd_f32_shape_error(C, H)
    if msg is not None:
        raise ValueError(msg)
    lib = _build.load("lstm_bwd_f32")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lstm_bwd_f32.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        lib.lstm_bwd_f32.restype = i32
        lib.lstm_bwd_f32_blocks.argtypes = [i32]
        lib.lstm_bwd_f32_blocks.restype = i32
        lib.lstm_bwd_f32_fits.argtypes = [i32, i32]
        lib.lstm_bwd_f32_fits.restype = i32
        lib.lstm_bwd_f32_error_string.argtypes = [i32]
        lib.lstm_bwd_f32_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_cuda(name, x, w_aug, *seq):
    """Device, dtype, shape and contiguity checks of a CUDA launch; returns
    (T, B, C, H). ``seq`` are (T, B, H) tensors in x's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (T, B, C), got {tuple(x.shape)}")
    T, B, C = x.shape
    H = w_aug.shape[1] // 4
    if w_aug.shape != (C + H + 1, 4 * H):
        raise ValueError(
            f"{name}: W_aug {tuple(w_aug.shape)} does not match C={C}"
        )
    for t in (x, w_aug, *seq):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: operands differ in dtype or device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for t in seq:
        if t.shape != (T, B, H):
            raise ValueError(
                f"{name}: {tuple(t.shape)} is not (T, B, H) = {(T, B, H)}"
            )
    return T, B, C, H


def _raise_on(error_string, name, err):
    """Raise for a launcher's nonzero cudaError_t; ``error_string`` is the
    library's function that names it."""
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{error_string(err).decode()} (cudaError {err})"
        )


def lstm_fwd(x, w_aug, want_cs=True):
    """K2: (hs, cs) of a forward LSTM over x (T, B, C), each (T, B, H) in
    x's dtype; cs is None unless ``want_cs``. f32 runs
    ``lstm_fwd_f32.cu``, bf16 ``lstm_fwd_mma.cu``; shapes
    those kernels refuse ``lstm_wide.cu`` or, above C, H = 128, the
    general leg on the path ``general_fwd_path`` picks (``route``)."""
    global LAUNCHES_FWD
    if x.device.type == "cpu":
        return lstm_fwd_reference(x, w_aug, want_cs)
    T, B, C, H = _check_cuda("lstm_fwd", x, w_aug)
    kind = route("fwd", x.dtype, C, H)
    path = None
    if kind == "general":
        launch, error_string, path = _general_fwd_launch("fwd", x, w_aug, C,
                                                         H)
    elif kind == "wide":
        lib = _wide_library()
        launch = _wide_launch(lib.lstm_wide_fwd, x.dtype, w_aug, C)
        error_string = lib.lstm_wide_error_string
    elif x.dtype == torch.bfloat16:
        lib = _fwd_mma_library("lstm_fwd", C, H)
        launch, error_string = lib.lstm_fwd_mma, lib.lstm_fwd_mma_error_string
    else:
        lib = _f32_fwd_library()
        launch, error_string = lib.lstm_fwd_f32, lib.lstm_fwd_f32_error_string
    hs = torch.empty((T, B, H), dtype=x.dtype, device=x.device)
    cs = torch.empty_like(hs) if want_cs else None
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), w_aug.data_ptr(), hs.data_ptr(),
            None if cs is None else cs.data_ptr(), T, B, C, H,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(error_string, "lstm_fwd", err)
    LAUNCHES_FWD += 1
    _count_leg(kind, "fwd", path)
    return hs, cs


def _mma_library():
    lib = _build.load("lstm_bwd_mma")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn, n_ptr in (("lstm_bwd_mma_gates", 4),
                          ("lstm_bwd_mma_recurrence", 5),
                          ("lstm_bwd_mma_products", 7)):
            getattr(lib, fn).argtypes = [ptr] * n_ptr + [i32] * 4 + [ptr]
            getattr(lib, fn).restype = i32
        lib.lstm_bwd_mma_chunks.argtypes = [i32] * 4
        lib.lstm_bwd_mma_chunks.restype = i32
        lib.lstm_bwd_mma_fits.argtypes = [i32, i32]
        lib.lstm_bwd_mma_fits.restype = i32
        for fn in ("lstm_bwd_mma_max_h", "lstm_bwd_mma_max_k"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i32
        lib.lstm_bwd_mma_error_string.argtypes = [i32]
        lib.lstm_bwd_mma_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _mma_lib(name, ref, C, H):
    """The library of K3's bf16 parts, after the checks each part adds to
    the shapes': a bf16 tensor on the card and a shape the kernels take."""
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {ref.device}")
    if ref.dtype != torch.bfloat16:
        raise ValueError(
            f"{name}: the tensor-core kernels take bf16, got {ref.dtype} "
            "(lstm_bwd runs f32 on lstm_bwd_f32.cu's kernel)"
        )
    lib = _mma_library()
    if not lib.lstm_bwd_mma_fits(C, H):
        raise ValueError(
            f"{name}: kernel takes H <= {lib.lstm_bwd_mma_max_h()} and C + H "
            f"<= {lib.lstm_bwd_mma_max_k()}, got C={C}, H={H}"
        )
    return lib


def lstm_bwd_gates(x, w_aug, hs):
    """K3 bf16, part (a): the gate pre-activations Z (T, B, 4H) f32 of every
    step (``lstm_bwd_gates_reference``), on the tensor cores."""
    if x.device.type == "cpu":
        return lstm_bwd_gates_reference(x, w_aug, hs)
    T, B, C, H = _check_cuda("lstm_bwd_gates", x, w_aug, hs)
    lib = _mma_lib("lstm_bwd_gates", x, C, H)
    z = torch.empty((T, B, 4 * H), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.lstm_bwd_mma_gates(
            x.data_ptr(), hs.data_ptr(), w_aug.data_ptr(), z.data_ptr(), T,
            B, C, H, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib.lstm_bwd_mma_error_string, "lstm_bwd_gates", err)
    LAUNCHES_BWD_MMA["gates"] += 1
    return z


def lstm_bwd_recurrence(z, cs, dhs, w_aug):
    """K3 bf16, part (b): dgates (T, B, 4H) bf16 from the gate
    pre-activations z (f32), the saved c and the hidden-state cotangents
    (``lstm_bwd_recurrence_reference``): the reverse walk, one block per 16
    batch rows, dh_{t-1} = dgates_t @ W_h^T on the tensor cores."""
    if cs.device.type == "cpu":
        return lstm_bwd_recurrence_reference(z, cs, dhs, w_aug)
    name = "lstm_bwd_recurrence"
    if cs.dim() != 3:
        raise ValueError(f"{name}: cs must be (T, B, H), got "
                         f"{tuple(cs.shape)}")
    T, B, H = cs.shape
    C = w_aug.shape[0] - H - 1
    if w_aug.shape[1] != 4 * H:
        raise ValueError(f"{name}: W_aug {tuple(w_aug.shape)} does not "
                         f"match H={H}")
    for t, shape, dtype in ((z, (T, B, 4 * H), torch.float32),
                            (dhs, (T, B, H), cs.dtype),
                            (w_aug, w_aug.shape, cs.dtype)):
        if t.shape != shape or t.dtype != dtype or t.device != cs.device:
            raise ValueError(
                f"{name}: {tuple(t.shape)} {t.dtype} is not {tuple(shape)} "
                f"{dtype} on {cs.device}"
            )
    lib = _mma_lib(name, cs, C, H)
    if not all(t.is_contiguous() for t in (z, cs, dhs, w_aug)):
        raise ValueError(f"{name}: operands must be contiguous")
    dg = torch.empty((T, B, 4 * H), dtype=cs.dtype, device=cs.device)
    with torch.cuda.device(cs.device):
        err = lib.lstm_bwd_mma_recurrence(
            z.data_ptr(), cs.data_ptr(), dhs.data_ptr(), w_aug.data_ptr(),
            dg.data_ptr(), T, B, C, H,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib.lstm_bwd_mma_error_string, "lstm_bwd_recurrence", err)
    LAUNCHES_BWD_MMA["recurrence"] += 1
    return dg


def lstm_bwd_products(x, hs, w_aug, dg):
    """K3 bf16, part (c): (dx (T, B, C) bf16, dW_aug (C + H + 1, 4H) f32)
    from dgates (``lstm_bwd_products_reference``): dx and the chunked dW on
    the tensor cores, then the chunks' partials summed in order."""
    if x.device.type == "cpu":
        return lstm_bwd_products_reference(x, hs, w_aug, dg)
    T, B, C, H = _check_cuda("lstm_bwd_products", x, w_aug, hs)
    lib = _mma_lib("lstm_bwd_products", x, C, H)
    if dg.shape != (T, B, 4 * H) or dg.dtype != x.dtype \
            or dg.device != x.device or not dg.is_contiguous():
        raise ValueError(
            "lstm_bwd_products: dgates must be a contiguous (T, B, 4H) "
            f"tensor in x's dtype, got {tuple(dg.shape)} {dg.dtype}"
        )
    dx = torch.empty_like(x)
    partials = torch.empty(
        (lib.lstm_bwd_mma_chunks(T, B, C, H), C + H + 1, 4 * H),
        dtype=torch.float32, device=x.device,
    )
    dw = torch.empty((C + H + 1, 4 * H), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = lib.lstm_bwd_mma_products(
            x.data_ptr(), hs.data_ptr(), w_aug.data_ptr(), dg.data_ptr(),
            dx.data_ptr(), partials.data_ptr(), dw.data_ptr(), T, B, C, H,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib.lstm_bwd_mma_error_string, "lstm_bwd_products", err)
    LAUNCHES_BWD_MMA["products"] += 1
    return dx, dw


def lstm_bwd(x, w_aug, hs, cs, dhs):
    """K3: (dx in x's dtype, dW_aug f32 (C + H + 1, 4H)) from the forward's
    saved hs and cs and the hidden-state cotangents dhs. bf16 runs the
    three tensor-core parts, f32 ``lstm_bwd_f32.cu``'s one-launch kernel;
    shapes those kernels refuse run ``lstm_wide_bwd.cu``'s parts or, above
    C, H = 128, ``lstm_general.cu``'s (``route``; above its limits the call
    raises)."""
    global LAUNCHES_BWD
    if x.device.type == "cpu":
        return lstm_bwd_reference(x, w_aug, hs, cs, dhs)
    T, B, C, H = _check_cuda("lstm_bwd", x, w_aug, hs, cs, dhs)
    kind = route("bwd", x.dtype, C, H)
    if kind != "main":
        return _lstm_bwd_split(kind, x, w_aug, hs, cs, dhs)
    if x.dtype == torch.bfloat16:
        z = lstm_bwd_gates(x, w_aug, hs)
        dg = lstm_bwd_recurrence(z, cs, dhs, w_aug)
        dx, dw = lstm_bwd_products(x, hs, w_aug, dg)
        LAUNCHES_BWD += 1
        return dx, dw
    lib = _bwd_f32_library(C, H)
    dx = torch.empty_like(x)
    partials = torch.empty(
        (lib.lstm_bwd_f32_blocks(B), C + H + 1, 4 * H), dtype=torch.float32,
        device=x.device,
    )
    dw = torch.empty((C + H + 1, 4 * H), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = lib.lstm_bwd_f32(
            x.data_ptr(), w_aug.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            dhs.data_ptr(), dx.data_ptr(), partials.data_ptr(),
            dw.data_ptr(), T, B, C, H,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib.lstm_bwd_f32_error_string, "lstm_bwd", err)
    LAUNCHES_BWD += 1
    return dx, dw


def _lstm_bwd_split(kind, x, w_aug, hs, cs, dhs):
    """K3 in parts, one call of the library (after ``_check_cuda``): the
    gate recompute, the reverse recurrence and the products with their
    ordered dW sum (``lstm_prod.cuh``). ``kind`` "wide" runs
    ``lstm_wide_bwd.cu``'s recurrence on clusters of two CTAs (dh = dgates .
    W_h^T, each CTA's slice of W_h^T in shared memory; a cluster the card
    cannot hold raises), "general" ``lstm_general_rec_cluster.cu``'s on
    clusters of N CTAs where ``general_rec_plan`` takes the shape,
    ``lstm_general_rec_ring.cu``'s where ``general_rec_ring_plan`` does
    (257-512, both dtypes: 16 rows a CTA, W_h^T streamed by TMA), else
    ``lstm_general.cu``'s (one block per 8 rows, W_h^T read through L2)."""
    global LAUNCHES_BWD
    T, B, C = x.shape
    H = w_aug.shape[1] // 4
    path = None
    if kind == "general":
        path, run, _, chunks, error_string = _general_k3_launch(
            x.dtype, C, H, x.device)
    else:
        lib = _wide_bwd_library()
        run, chunks, error_string = (lib.lstm_wide_bwd,
                                     lib.lstm_wide_bwd_dw_chunks,
                                     lib.lstm_wide_bwd_error_string)
    dev = x.device
    if path == "ring":
        w_ht = general_rec_ring_layout(w_aug, C)
        w_xt = w_aug[:C].t().contiguous()
    else:
        w_ht, w_xt = wide_bwd_weights(w_aug, C)
    z = torch.empty((T, B, 4 * H), dtype=torch.float32, device=dev)
    dg = torch.empty((T, B, 4 * H), dtype=x.dtype, device=dev)
    dx = torch.empty_like(x)
    partials = torch.empty((chunks(T, B), C + H + 1, 4 * H),
                           dtype=torch.float32, device=dev)
    dw = torch.empty((C + H + 1, 4 * H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = run(
            int(x.dtype == torch.bfloat16), x.data_ptr(), w_aug.data_ptr(),
            w_ht.data_ptr(), w_xt.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            dhs.data_ptr(), z.data_ptr(), dg.data_ptr(), dx.data_ptr(),
            partials.data_ptr(), dw.data_ptr(), T, B, C, H,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(error_string, "lstm_bwd", err)
    LAUNCHES_BWD += 1
    _count_leg(kind, "bwd", path)
    if x.dtype == torch.float32 and T * B > 0:
        by_shape = prod_f32_path("gates", C, H, x, hs, w_aug, w_xt, dg)
        for op in ("gates", "dx", "dw"):
            LAUNCHES_PROD[op, by_shape] += 1
    return dx, dw


# ---------------- the f32 products alone (csrc/lstm_prod.cuh) ----------------


def prod_f32_path(op, C, H, *operands):
    """The path an f32 product takes by shape (``launch_f32_op``'s p.vec):
    "ws" where C (and H, but for "gates_x", which reads no h) are multiples
    of 4 and every operand (None for one the op does not read) lies on a
    16-byte boundary, else "element"."""
    fits = C % 4 == 0 and (op == "gates_x" or H % 4 == 0) and all(
        t.data_ptr() % 16 == 0 for t in operands if t is not None)
    return "ws" if fits else "element"


def _prod_library():
    lib = _build.load("lstm_prod")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lstm_prod_f32.argtypes = [i32, i32] + [ptr] * 7 + [i32] * 4 + [ptr]
        lib.lstm_prod_f32.restype = i32
        lib.lstm_prod_dw_chunks.argtypes = [i32, i32]
        lib.lstm_prod_dw_chunks.restype = i32
        lib.lstm_prod_error_string.argtypes = [i32]
        lib.lstm_prod_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def lstm_prod_f32_reference(op, x, hs, w_aug, dg=None):
    """Plain twin of one f32 product: "gates" Z (T, B, 4H)
    (``lstm_bwd_gates_reference``), "gates_x" Z_x = x_t . W_x + b (T, B,
    4H), the forward's x part, "dx" (T, B, C) and "dw" (C + H + 1, 4H)
    (``lstm_bwd_products_reference``, dgates ``dg``)."""
    if op == "gates":
        return lstm_bwd_gates_reference(x, w_aug, hs)
    if op == "gates_x":
        return _x_projection(x, w_aug)
    dx, dw = lstm_bwd_products_reference(x, hs, w_aug, dg)
    return dx if op == "dx" else dw


def lstm_prod_f32(op, x, hs, w_aug, dg=None, path=None):
    """One of K3's f32 products, or the W_h-ring K1/K2's Z_x, alone
    (``lstm_prod_f32_reference``, its plain twin, on CPU tensors): ``op``
    one of PROD_OPS over x (T, B, C), hs (T, B, H; None for "gates_x"),
    W_aug (C + H + 1, 4H) and, for "dx" and "dw", dgates ``dg`` (T, B, 4H),
    all f32. On the card ``csrc/lstm_prod.cu`` runs it on ``path``: None
    the one the shape takes (``prod_f32_path``), "ws" or "element" forced;
    a forced path the shape refuses raises. Counted in LAUNCHES_PROD by
    (op, path)."""
    name = "lstm_prod_f32"
    if op not in PROD_OPS:
        raise ValueError(f"{name}: op {op!r} is not one of {PROD_OPS}")
    if path is not None and path not in PROD_PATHS:
        raise ValueError(f"{name}: path {path!r} is not one of "
                         f"{PROD_PATHS}")
    reads_h, reads_dg = op != "gates_x", op in ("dx", "dw")
    if reads_h and hs is None or reads_dg and dg is None:
        raise ValueError(f"{name}: {op} reads hs{' and dg' * reads_dg}")
    if x.device.type == "cpu":
        return lstm_prod_f32_reference(op, x, hs, w_aug, dg)
    T, B, C, H = _check_cuda(name, x, w_aug, *([hs] if reads_h else []))
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: f32 only, got {x.dtype}")
    if reads_dg and (dg.shape != (T, B, 4 * H) or dg.dtype != torch.float32
                     or dg.device != x.device or not dg.is_contiguous()):
        raise ValueError(f"{name}: dg must be a contiguous (T, B, 4H) f32 "
                         f"tensor on {x.device}, got {tuple(dg.shape)} "
                         f"{dg.dtype}")
    w_xt = w_aug[:C].t().contiguous() if op == "dx" else None
    operands = (x, hs if reads_h else None, w_aug, w_xt,
                dg if reads_dg else None)
    by_shape = prod_f32_path(op, C, H, *operands)
    path = by_shape if path is None else path
    if path == "ws" and by_shape != "ws":
        raise ValueError(
            f"{name}: the ws path takes C, H multiples of 4 and 16-byte "
            f"aligned operands, not C={C}, H={H} at these addresses")
    lib = _prod_library()
    dev = x.device
    partials = None
    if op == "dx":
        out = torch.empty_like(x)
    elif op == "dw":
        out = torch.empty((C + H + 1, 4 * H), dtype=torch.float32,
                          device=dev)
        partials = torch.empty((lib.lstm_prod_dw_chunks(T, B), C + H + 1,
                                4 * H), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((T, B, 4 * H), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = lib.lstm_prod_f32(
            PROD_OPS.index(op), 1 + PROD_PATHS.index(path),
            *map(ptr, operands[:2]), w_aug.data_ptr(), ptr(w_xt),
            ptr(operands[4]), out.data_ptr(), ptr(partials), T, B, C, H,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib.lstm_prod_error_string, name, err)
    if T * B > 0:
        LAUNCHES_PROD[op, path] += 1
    return out


class LSTMFused(torch.autograd.Function):
    """hs = LSTM(x; W_aug) with K2 forward and K3 backward (the JAX
    package's ``_lstm_core`` custom VJP). The forward saves (x, W_aug, hs,
    cs); dW leaves the backward in W_aug's dtype."""

    @staticmethod
    def forward(ctx, x, w_aug):
        hs, cs = lstm_fwd(x, w_aug, want_cs=any(ctx.needs_input_grad))
        ctx.save_for_backward(x, w_aug, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x, w_aug, hs, cs = ctx.saved_tensors
        dx, dw = lstm_bwd(x, w_aug, hs, cs, dhs.to(x.dtype).contiguous())
        return dx, dw.to(w_aug.dtype)


def lstm_fused(params, x, reverse=False):
    """LSTM hidden states (T, B, H) in x's dtype over x (T, B, C) through
    K2/K3; the drop-in for ``layers.lstm``. Differentiable end to end:
    autograd through the W_aug concat splits dW back into w_ih, w_hh, b_ih
    and b_hh. Without a gradient to take, the forward skips the cs write."""
    w_aug = make_w_aug(params, x.dtype)
    if reverse:
        x = x.flip(0)
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w_aug.requires_grad):
        hs = LSTMFused.apply(x, w_aug)
    else:
        hs, _ = lstm_fwd(x, w_aug, want_cs=False)
    return hs.flip(0) if reverse else hs
