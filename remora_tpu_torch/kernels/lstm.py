"""Last-only LSTM forward: the inference recurrence as a Hopper kernel.

Counterpart of ``remora_tpu/kernels/pallas_lstm.py::lstm_last_fused``.
The kernel (``csrc/lstm_last.cu``) runs the whole time loop in one launch
and writes only h_{T-1}; its source note gives the design and the bound.

``lstm_last`` launches the kernel for a CUDA tensor and uses the plain
version, ``lstm_last_reference``, only for a CPU tensor. There is no
fallback: a CUDA input the kernel does not take, a failed build or a
refused launch raises.
"""

import ctypes

import torch

from remora_tpu_torch.kernels import _build
from remora_tpu_torch.models import layers as L

# kernel launches in this process (one per ``lstm_last`` call on CUDA)
LAUNCHES = 0

_DTYPES = {torch.float32: "lstm_last_f32", torch.bfloat16: "lstm_last_bf16"}


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
    return L.lstm(params, x)[-1].to(x.dtype)


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
