"""LSTM recurrences as Hopper kernels: inference (K1) and training (K2, K3).

Counterpart of ``remora_tpu/kernels/pallas_lstm.py``:

  * ``lstm_last`` (K1, ``csrc/lstm_last.cu``) is ``lstm_last_fused``: the
    whole time loop in one launch, writing only h_{T-1};
  * ``lstm_fwd`` (K2) and ``lstm_bwd`` (K3), both in ``csrc/lstm_train.cu``,
    are ``_fwd_call`` and ``_bwd_call``: the full forward that writes hs
    (and cs for the backward), and the reverse-time backward that emits dx
    and dW_aug. ``LSTMFused`` ties them into one ``torch.autograd.Function``
    and ``lstm_fused`` is the drop-in for ``layers.lstm``, as in the JAX
    package.

The source notes give each kernel's design and bound. Each entry point
launches its kernel for a CUDA tensor and uses its plain version
(``lstm_last_reference``, ``lstm_fwd_reference``, ``lstm_bwd_reference``)
only for a CPU tensor. There is no fallback: a CUDA input a kernel does not
take, a failed build or a refused launch raises.
"""

import ctypes

import torch

from remora_tpu_torch.kernels import _build
from remora_tpu_torch.models import layers as L

# kernel launches in this process: K1 (one per ``lstm_last`` call on CUDA),
# K2 (one per ``lstm_fwd``) and K3 (one per ``lstm_bwd``)
LAUNCHES = 0
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0

_DTYPES = {torch.float32: "lstm_last_f32", torch.bfloat16: "lstm_last_bf16"}
_TRAIN_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def _library():
    lib = _build.load("lstm_last")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in _DTYPES.values():
            getattr(lib, fn).argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                         ptr]
            getattr(lib, fn).restype = i32
        for fn in ("lstm_last_max_c", "lstm_last_max_h"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i32
        lib.lstm_last_error_string.argtypes = [i32]
        lib.lstm_last_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def lstm_last(params, x):
    """Final hidden state h_{T-1} of a forward LSTM over x (T, B, C): (B, H)
    in x's dtype. f32 runs full-f32 arithmetic; bf16 takes bf16 operands
    (h included) with f32 sums and f32 h/c carries."""
    global LAUNCHES
    if x.device.type == "cpu":
        return lstm_last_reference(params, x)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_last: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
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
    lib = _library()
    if C > lib.lstm_last_max_c() or H > lib.lstm_last_max_h():
        raise ValueError(
            f"lstm_last: kernel takes C <= {lib.lstm_last_max_c()} and "
            f"H <= {lib.lstm_last_max_h()}, got C={C}, H={H}"
        )
    w_aug = make_w_aug(params, x.dtype)
    if w_aug.device != x.device:
        raise ValueError("lstm_last: params and x are on different devices")
    out = torch.empty((B, H), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(lib, _DTYPES[x.dtype])(
            x.data_ptr(), w_aug.data_ptr(), out.data_ptr(), T, B, C, H,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "lstm_last kernel launch failed: "
            f"{lib.lstm_last_error_string(err).decode()} (cudaError {err})"
        )
    LAUNCHES += 1
    return out


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


def lstm_bwd_reference(x, w_aug, hs, cs, dhs):
    """Plain version of K3: (dx in x's dtype, dW_aug f32 (C + H + 1, 4H)).

    ``_bwd_kernel``'s math: the gates are recomputed from the saved h and c
    (read as f32 from x's dtype), the dh and dc carries are f32, dgates are
    rounded into x's dtype before both products, and the bias row of dW is
    the dgates sum. The gates of every step come from one matmul (they need
    no carry); only the carries walk time in reverse."""
    T, B, C = x.shape
    H = w_aug.shape[1] // 4
    dt = x.dtype
    w = w_aug[: C + H].float()
    zero = x.new_zeros((1, B, H))
    xh = torch.cat([x, torch.cat([zero, hs[:-1]])], dim=-1)
    z = (xh.reshape(T * B, C + H).float() @ w).reshape(T, B, 4 * H)
    i, f, g, o = _gates(z + w_aug[C + H].float(), H)
    c_prev = torch.cat([zero, cs[:-1]]).float()
    tanh_c = torch.tanh(cs.float())
    dg = x.new_empty((T, B, 4 * H))
    dh_c = z.new_zeros((B, H))
    dc_c = z.new_zeros((B, H))
    w_h_t = w[C:].T
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
    dg2 = dg.reshape(T * B, 4 * H).float()
    dx = (dg2 @ w[:C].T).reshape(T, B, C).to(dt)
    dw = torch.cat([xh.reshape(T * B, C + H).float().T @ dg2,
                    dg2.sum(0, keepdim=True)])
    return dx, dw


def _train_library():
    lib = _build.load("lstm_train")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for sfx in _TRAIN_SUFFIX.values():
            fwd = getattr(lib, f"lstm_fwd_{sfx}")
            fwd.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
            fwd.restype = i32
            bwd = getattr(lib, f"lstm_bwd_{sfx}")
            bwd.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
            bwd.restype = i32
        for fn in ("lstm_train_max_c", "lstm_train_max_h"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i32
        lib.lstm_train_blocks.argtypes = [i32]
        lib.lstm_train_blocks.restype = i32
        lib.lstm_bwd_fits.argtypes = [i32, i32]
        lib.lstm_bwd_fits.restype = i32
        lib.lstm_train_error_string.argtypes = [i32]
        lib.lstm_train_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_cuda(name, x, w_aug, *seq):
    """Device, dtype, shape and contiguity checks of a CUDA launch; returns
    (T, B, C, H). ``seq`` are (T, B, H) tensors in x's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _TRAIN_SUFFIX:
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


def _raise_on(lib, name, err):
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.lstm_train_error_string(err).decode()} (cudaError {err})"
        )


def lstm_fwd(x, w_aug, want_cs=True):
    """K2: (hs, cs) of a forward LSTM over x (T, B, C), each (T, B, H) in
    x's dtype; cs is None unless ``want_cs``."""
    global LAUNCHES_FWD
    if x.device.type == "cpu":
        return lstm_fwd_reference(x, w_aug, want_cs)
    T, B, C, H = _check_cuda("lstm_fwd", x, w_aug)
    lib = _train_library()
    if C > lib.lstm_train_max_c() or H > lib.lstm_train_max_h():
        raise ValueError(
            f"lstm_fwd: kernel takes C <= {lib.lstm_train_max_c()} and "
            f"H <= {lib.lstm_train_max_h()}, got C={C}, H={H}"
        )
    hs = torch.empty((T, B, H), dtype=x.dtype, device=x.device)
    cs = torch.empty_like(hs) if want_cs else None
    with torch.cuda.device(x.device):
        err = getattr(lib, f"lstm_fwd_{_TRAIN_SUFFIX[x.dtype]}")(
            x.data_ptr(), w_aug.data_ptr(), hs.data_ptr(),
            None if cs is None else cs.data_ptr(), T, B, C, H,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, "lstm_fwd", err)
    LAUNCHES_FWD += 1
    return hs, cs


def lstm_bwd(x, w_aug, hs, cs, dhs):
    """K3: (dx in x's dtype, dW_aug f32 (C + H + 1, 4H)) from the forward's
    saved hs and cs and the hidden-state cotangents dhs."""
    global LAUNCHES_BWD
    if x.device.type == "cpu":
        return lstm_bwd_reference(x, w_aug, hs, cs, dhs)
    T, B, C, H = _check_cuda("lstm_bwd", x, w_aug, hs, cs, dhs)
    lib = _train_library()
    if not lib.lstm_bwd_fits(C, H):
        raise ValueError(
            f"lstm_bwd: kernel takes C <= {lib.lstm_train_max_c()}, H <= "
            f"{lib.lstm_train_max_h()} and a (C + H) x 4H weight gradient "
            f"of at most 256 register tiles (C + H <= 128 at H = 64), got "
            f"C={C}, H={H}"
        )
    dx = torch.empty_like(x)
    partials = torch.empty(
        (lib.lstm_train_blocks(B), C + H + 1, 4 * H), dtype=torch.float32,
        device=x.device,
    )
    dw = torch.empty((C + H + 1, 4 * H), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(lib, f"lstm_bwd_{_TRAIN_SUFFIX[x.dtype]}")(
            x.data_ptr(), w_aug.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            dhs.data_ptr(), dx.data_ptr(), partials.data_ptr(),
            dw.data_ptr(), T, B, C, H,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, "lstm_bwd", err)
    LAUNCHES_BWD += 1
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
