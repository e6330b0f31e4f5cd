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
memory, x_t . W_x runs off the chain, bf16 on the tensor cores; and the
streaming path, ``csrc/lstm_general.cu``'s ``general_fwd_kernel``, for
every shape the plan refuses (f32 at 256, every shape at 1024): one block
per 8 batch rows walks time with h and c in shared memory and W read
through L2 each step. K3 there is ``lstm_general.cu``'s own reverse
recurrence between ``csrc/lstm_prod.cuh``'s gate recompute and products,
the wide K3's. Above 1024 every entry point raises; a launch on either
path that fails raises, never moving to the other path.

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
# or ``lstm_fwd``): "cluster" ``lstm_general_cluster.cu``, "stream"
# ``lstm_general.cu``'s ``general_fwd_kernel`` (``general_fwd_path``)
LAUNCHES_GENERAL_FWD = dict.fromkeys(("cluster", "stream"), 0)
# ``lstm_general_cluster.cu``'s budget: a block's shared memory, threads a
# CTA by dtype (its __launch_bounds__), ring slots at most, k a slot holds,
# and the batch its plan sizes a wave for (the model paths' batch)
CLUSTER_SMEM_MAX = 232448
CLUSTER_MAX_THREADS = {torch.bfloat16: 512, torch.float32: 480}
CLUSTER_MAX_THREADS_X2 = 320  # bf16 warps of two unit blocks
CLUSTER_MAX_SLOTS = 16
CLUSTER_CHUNK = 16
GENERAL_FWD_PLAN_BATCH = 2048
# clusters of N CTAs an H100 80GB HBM3 (132 SMs) holds at once, one CTA an
# SM (``lstm_general_cluster_capacity``): its GPCs' SMs split into clusters
H100_CLUSTERS = {2: 66, 4: 30, 8: 15}


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
    ``general_fwd_weights``), or None where the shape does not fit one
    CTA."""
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
            "layout": N * G * (C16 + kh + 1)}


def general_fwd_plan(C, H, dtype, clusters=None):
    """The general forward's cluster plan at C inputs and H hidden units in
    ``dtype``: (N, R, shared-memory bytes) for ``lstm_general_cluster.cu``,
    or None, where the shape runs the streaming ``general_fwd_kernel``.
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
    smaller cluster."""
    clusters = clusters or H100_CLUSTERS
    best = None
    for N in (2, 4, 8):
        # the fewest rows a cluster with which the batch takes one wave
        R = _ceil(_ceil(GENERAL_FWD_PLAN_BATCH, clusters[N]), 32) * 32
        cfg = general_fwd_cfg(C, H, dtype, N, R)
        if cfg is None:
            continue
        key = (not cfg["resident"], R * cfg["hh"], -cfg["slots"], N)
        if best is None or key < best[0]:
            best = key, (N, R, cfg["smem"])
    return None if best is None else best[1]


def general_fwd_path(dtype, C, H, clusters=None):
    """The path of a general K1/K2 call (``route`` "general"): "cluster"
    where ``general_fwd_plan`` takes the shape, else "stream". Chosen by
    shape before the launch; a launch that fails raises on its path."""
    return "stream" if general_fwd_plan(C, H, dtype, clusters) is None \
        else "cluster"


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
    ``general_fwd_plan`` takes the shape on this card, else the streaming
    ``general_fwd_kernel``."""
    plan = general_fwd_plan(C, H, x.dtype,
                            cluster_capacity(x.device.index or 0))
    bf16 = int(x.dtype == torch.bfloat16)
    if plan is None:
        lib = _general_library()
        fn = lib.lstm_general_last if leg == "last" else lib.lstm_general_fwd
        return (_general_launch(fn, x.dtype, w_aug),
                lib.lstm_general_error_string, "stream")
    N, R, _ = plan
    lib = _cluster_library()
    wl = general_fwd_weights(w_aug, C, N,
                             general_fwd_cfg(C, H, x.dtype, N, R)["hh"])

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
        lib.lstm_general_bwd_dw_chunks.argtypes = [i32, i32]
        lib.lstm_general_bwd_dw_chunks.restype = i32
        for fn in ("lstm_general_max_c", "lstm_general_max_h"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i32
        lib.lstm_general_error_string.argtypes = [i32]
        lib.lstm_general_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


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
    kernels refuse run ``lstm_wide.cu`` or, above C, H = 128,
    ``lstm_general.cu`` (``route``)."""
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
    the general forward's, "cluster" or "stream")."""
    if kind == "wide":
        LAUNCHES_WIDE[leg] += 1
    elif kind == "general":
        LAUNCHES_GENERAL[leg] += 1
        if path is not None:
            LAUNCHES_GENERAL_FWD[path] += 1


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
    x_proj = (x.reshape(T * B, C).float() @ w[:C]).reshape(T, B, 4 * H)
    x_proj = x_proj + w_aug[C + H].float()
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
    those kernels refuse ``lstm_wide.cu`` or, above C, H = 128,
    ``lstm_general.cu`` (``route``)."""
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
    cannot hold raises), "general" ``lstm_general.cu``'s (one block per 8
    rows, W_h^T read through L2)."""
    global LAUNCHES_BWD
    T, B, C = x.shape
    H = w_aug.shape[1] // 4
    if kind == "general":
        lib = _general_library()
        run, chunks, error_string = (lib.lstm_general_bwd,
                                     lib.lstm_general_bwd_dw_chunks,
                                     lib.lstm_general_error_string)
    else:
        lib = _wide_bwd_library()
        run, chunks, error_string = (lib.lstm_wide_bwd,
                                     lib.lstm_wide_bwd_dw_chunks,
                                     lib.lstm_wide_bwd_error_string)
    dev = x.device
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
    _count_leg(kind, "bwd")
    return dx, dw


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
