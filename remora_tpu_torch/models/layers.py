"""Neural-net building blocks for the eval forward (PyTorch).

Counterpart of ``remora_tpu/models/layers.py``: the same functions over
the same layouts and parameter names, so weights and activations carry
across the two packages unchanged.

  * functions take a params mapping (``{"w", "b"}``, ``{"gamma",
    "beta"}``, ...) and tensors in the JAX package's layouts: convs are
    channels-last (B, T, C) with torch (O, I, K) weights, the LSTM runs
    over (T, B, C);
  * modules hold those names as parameters (BatchNorm's running
    ``mean``/``var`` as buffers), so a state-dict key ``sig_conv1.w`` is
    the checkpoint key ``sig_conv1/w``;
  * ``*_init`` draw torch's default initialisation (kaiming-uniform
    fan-in bounds) from an explicit ``torch.Generator``.

Matmuls that the JAX package runs with ``preferred_element_type=f32``
upcast their operands to f32 here: a bf16 product is exact in f32, so
the result is the f32-accumulated product of the bf16 operands.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def swish(x):
    return x * torch.sigmoid(x)


def _uniform(generator, shape, bound, dtype, device):
    vals = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((2 * vals - 1) * bound).to(device=device, dtype=dtype)


def _dot_f32(x, w):
    """x @ w.T with f32 operands and result (``preferred_element_type``)."""
    return x.float() @ w.float().T


# ---------------- Conv1d ----------------


def conv1d_init(generator, in_ch, out_ch, kernel, dtype=torch.float32,
                device=None):
    bound = 1.0 / math.sqrt(in_ch * kernel)
    return {
        "w": _uniform(generator, (out_ch, in_ch, kernel), bound, dtype,
                      device),
        "b": _uniform(generator, (out_ch,), bound, dtype, device),
    }


def conv1d(params, x, stride=1):
    """x: (B, T, C_in) -> (B, T', C_out), VALID padding.

    The channels-last input is a transposed view of the (B, C, T) tensor
    that ``F.conv1d`` takes and returns, so a chain of convs with
    elementwise ops between them moves no extra bytes.
    """
    out = F.conv1d(x.transpose(1, 2), params["w"], params["b"], stride=stride)
    return out.transpose(1, 2)


# ---------------- BatchNorm1d (eval) ----------------


def batchnorm_init(num_feat, dtype=torch.float32, device=None):
    params = {
        "gamma": torch.ones(num_feat, dtype=dtype, device=device),
        "beta": torch.zeros(num_feat, dtype=dtype, device=device),
    }
    state = {
        "mean": torch.zeros(num_feat, dtype=dtype, device=device),
        "var": torch.ones(num_feat, dtype=dtype, device=device),
    }
    return params, state


def batchnorm(params, state, x, eps=1e-5):
    """Eval-mode BatchNorm over the last axis of x (B, T, C), from the
    running statistics."""
    inv = torch.rsqrt(state["var"] + eps) * params["gamma"]
    return (x - state["mean"]) * inv + params["beta"]


def conv_bn_swish(conv_params, bn_params, state, x, stride=1):
    """swish(BatchNorm1d(Conv1d(x))) in eval mode."""
    return swish(batchnorm(bn_params, state, conv1d(conv_params, x, stride)))


# ---------------- LSTM ----------------


def lstm_init(generator, input_size, hidden_size, dtype=torch.float32,
              device=None):
    bound = 1.0 / math.sqrt(hidden_size)
    H4 = 4 * hidden_size
    return {
        "w_ih": _uniform(generator, (H4, input_size), bound, dtype, device),
        "w_hh": _uniform(generator, (H4, hidden_size), bound, dtype, device),
        "b_ih": _uniform(generator, (H4,), bound, dtype, device),
        "b_hh": _uniform(generator, (H4,), bound, dtype, device),
    }


def lstm_cell_step0(params, x):
    """One LSTM cell step from the zero state: h1 for input x (B, C).

    With h0 = c0 = 0 the recurrent and forget terms vanish:
    c1 = sigmoid(i) * tanh(g); h1 = sigmoid(o) * tanh(c1).
    """
    gates = _dot_f32(x, params["w_ih"]) + params["b_ih"] + params["b_hh"]
    i, _f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c)


def lstm(params, x, reverse=False):
    """Single-layer LSTM over (T, B, C); returns hidden states (T, B, H)
    in f32.

    A step-by-step loop (the JAX package's ``lax.scan``): the input
    projection for all timesteps is one matmul, the loop carries only
    h @ W_hh^T. It is the plain version the last-only kernel is held to.
    """
    T, B, C = x.shape
    H = params["w_hh"].shape[1]
    x_proj = (
        _dot_f32(x.reshape(T * B, C), params["w_ih"]).reshape(T, B, 4 * H)
        + params["b_ih"]
        + params["b_hh"]
    )
    if reverse:
        x_proj = x_proj.flip(0)
    w_hh_t = params["w_hh"].float().T
    h = x_proj.new_zeros((B, H))
    c = x_proj.new_zeros((B, H))
    hs = []
    for t in range(T):
        gates = x_proj[t] + h @ w_hh_t
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    hs = torch.stack(hs) if hs else x_proj.new_zeros((0, B, H))
    return hs.flip(0) if reverse else hs


def lstm_last(params, x):
    """Final hidden state of a forward LSTM over (T, B, C): (B, H) in x's
    dtype. Runs the last-only kernel on CUDA tensors (the plain scan on
    CPU tensors); see ``kernels.lstm``."""
    from remora_tpu_torch.kernels import lstm as lstm_kernel

    return lstm_kernel.lstm_last(params, x)


# ---------------- Linear ----------------


def linear_init(generator, in_feat, out_feat, dtype=torch.float32,
                device=None):
    bound = 1.0 / math.sqrt(in_feat)
    return {
        "w": _uniform(generator, (out_feat, in_feat), bound, dtype, device),
        "b": _uniform(generator, (out_feat,), bound, dtype, device),
    }


def linear(params, x):
    return _dot_f32(x, params["w"]) + params["b"]


# ---------------- modules ----------------


class _ParamsModule(nn.Module):
    """Holds a layer's tensors under their checkpoint names."""

    def __init__(self, params, state=None):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))
        for name, value in (state or {}).items():
            self.register_buffer(name, value)

    @property
    def params(self):
        return dict(self.named_parameters(recurse=False))

    @property
    def state(self):
        return dict(self.named_buffers(recurse=False))


class Conv1d(_ParamsModule):
    def __init__(self, in_ch, out_ch, kernel, stride=1, generator=None,
                 dtype=torch.float32, device=None):
        super().__init__(
            conv1d_init(generator, in_ch, out_ch, kernel, dtype, device)
        )
        self.stride = stride

    def forward(self, x):
        return conv1d(self.params, x, self.stride)


class BatchNorm(_ParamsModule):
    def __init__(self, num_feat, dtype=torch.float32, device=None):
        super().__init__(*batchnorm_init(num_feat, dtype, device))

    def forward(self, x):
        return batchnorm(self.params, self.state, x)


class LSTM(_ParamsModule):
    def __init__(self, input_size, hidden_size, generator=None,
                 dtype=torch.float32, device=None):
        super().__init__(
            lstm_init(generator, input_size, hidden_size, dtype, device)
        )


class Linear(_ParamsModule):
    def __init__(self, in_feat, out_feat, generator=None,
                 dtype=torch.float32, device=None):
        super().__init__(
            linear_init(generator, in_feat, out_feat, dtype, device)
        )

    def forward(self, x):
        return linear(self.params, x)
