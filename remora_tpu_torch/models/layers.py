"""Neural-net building blocks, eval and train (PyTorch).

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

Train mode: ``batchnorm(train=True)`` and ``conv_bn_swish(train=True)``
return the new running statistics beside the output, as the JAX functions
do (the models write them into their BatchNorm buffers under
``torch.no_grad()``); ``lstm`` runs the K2/K3 kernel pair on CUDA tensors.
"""

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from remora_tpu_torch import RemoraError


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


def batchnorm(params, state, x, train=False, momentum=0.1, eps=1e-5):
    """BatchNorm over the last axis of x (B, T, C). Returns (out,
    new_state): eval mode normalises with the running statistics and keeps
    them; train mode normalises with the batch's and moves the running ones
    (unbiased variance), outside the graph."""
    if train:
        mean = x.mean((0, 1))
        var = x.var((0, 1), correction=0)
        n = x.shape[0] * x.shape[1]
        with torch.no_grad():
            unbiased = var * n / max(n - 1, 1)
            new_state = {
                "mean": (1 - momentum) * state["mean"] + momentum * mean,
                "var": (1 - momentum) * state["var"] + momentum * unbiased,
            }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = torch.rsqrt(var + eps) * params["gamma"]
    return (x - mean) * inv + params["beta"], new_state


# ------------- fused Conv1d + BatchNorm1d(train) + swish -------------
#
# ``ConvBNSwish`` is the JAX package's ``_cbs_core`` custom VJP: the conv
# runs without its bias (an additive bias cancels in y - mean(y); it only
# shifts the running mean, added back below, and its gradient is the sum of
# the conv-output cotangent); the forward saves only (w, gamma, beta, x, mu,
# r) and the backward recomputes the conv, reduces only dgamma and dbeta
# and forms the conv-output cotangent with the folded identity
#     dy = gamma*r * (dz - dbeta/N - xhat * dgamma/N).
# dw and dx come from cuDNN's conv gradients (the JAX package leaves this
# conv to XLA).


def _conv_nobias(w, x, stride):
    """(B, T, C_in) -> (B, T', C_out); w in torch (O, I, K) format."""
    return F.conv1d(x.transpose(1, 2), w, None, stride=stride).transpose(1, 2)


class ConvBNSwish(torch.autograd.Function):
    """(out, mu, var) of swish(BN_train(conv(x, w))); mu and var are the
    biasless batch statistics, for the running-state update only."""

    @staticmethod
    def forward(ctx, w, b, gamma, beta, x, stride, eps):
        del b  # cancels in the normalisation; its gradient is sum(dy)
        y = _conv_nobias(w, x, stride)
        mu = y.mean((0, 1))
        var = y.var((0, 1), correction=0)
        r = torch.rsqrt(var + eps)
        z = gamma * ((y - mu) * r) + beta
        ctx.save_for_backward(w, gamma, beta, x, mu, r)
        ctx.stride = stride
        ctx.mark_non_differentiable(mu, var)
        return z * torch.sigmoid(z), mu, var

    @staticmethod
    def backward(ctx, dout, _dmu, _dvar):
        w, gamma, beta, x, mu, r = ctx.saved_tensors
        y = _conv_nobias(w, x, ctx.stride)  # recompute: cheaper than residuals
        xhat = (y - mu) * r
        z = gamma * xhat + beta
        s = torch.sigmoid(z)
        dz = dout * (s + z * s * (1.0 - s))
        dgamma = (dz * xhat).sum((0, 1))
        dbeta = dz.sum((0, 1))
        n = y.shape[0] * y.shape[1]
        dy = gamma * r * (dz - dbeta / n - xhat * (dgamma / n))
        db = dy.sum((0, 1))
        x_ncw, dy_ncw = x.transpose(1, 2), dy.transpose(1, 2)
        dw = torch.nn.grad.conv1d_weight(x_ncw, w.shape, dy_ncw,
                                         stride=ctx.stride)
        dx = torch.nn.grad.conv1d_input(x_ncw.shape, w, dy_ncw,
                                        stride=ctx.stride)
        return dw, db, dgamma, dbeta, dx.transpose(1, 2), None, None


# REMORA_TPU_CONVBN modes of the JAX package that are not ported, with the
# ROADMAP item that brings each
_CONVBN_LATER = {
    "pallas": "ROADMAP queue 2, K6",
    "remat": "ROADMAP queue 1 item 11",
    "fused_resid": "ROADMAP queue 1 item 11",
    "packed": "ROADMAP queue 1 item 11",
}


def convbn_impl(device):
    """The train-mode conv+BN+swish implementation: REMORA_TPU_CONVBN
    (plain|fused|auto), auto being plain on the CPU and fused on CUDA, as
    the JAX package picks by backend."""
    mode = os.environ.get("REMORA_TPU_CONVBN", "auto")
    if mode in _CONVBN_LATER:
        raise RemoraError(
            f"REMORA_TPU_CONVBN={mode} is not ported yet "
            f"({_CONVBN_LATER[mode]}); use plain, fused or auto"
        )
    if mode not in ("plain", "fused", "auto"):
        raise RemoraError(f"unknown REMORA_TPU_CONVBN mode {mode!r}")
    if mode == "auto":
        return "plain" if torch.device(device).type == "cpu" else "fused"
    return mode


def conv_bn_swish(conv_params, bn_params, state, x, stride=1, train=False,
                  momentum=0.1, eps=1e-5, impl=None):
    """swish(BatchNorm1d(Conv1d(x))) with the running-state update. Returns
    (out, new_state). ``impl`` (train mode) is "plain" (autograd through
    BN) or "fused" (``ConvBNSwish``); None picks by ``convbn_impl``."""
    if not train:
        y = conv1d(conv_params, x, stride)
        return swish(batchnorm(bn_params, state, y)[0]), state
    if impl is None:
        impl = convbn_impl(x.device)
    if impl == "plain":
        y = conv1d(conv_params, x, stride)
        y, new_state = batchnorm(bn_params, state, y, True, momentum, eps)
        return swish(y), new_state
    if impl != "fused":
        raise RemoraError(f"unknown conv_bn_swish impl {impl!r}")
    out, mu, var = ConvBNSwish.apply(
        conv_params["w"], conv_params["b"], bn_params["gamma"],
        bn_params["beta"], x, stride, eps,
    )
    with torch.no_grad():
        mu = mu + conv_params["b"]
        y_cols = (x.shape[1] - conv_params["w"].shape[2]) // stride + 1
        n = x.shape[0] * y_cols
        unbiased = var * n / max(n - 1, 1)
        new_state = {
            "mean": (1 - momentum) * state["mean"] + momentum * mu,
            "var": (1 - momentum) * state["var"] + momentum * unbiased,
        }
    return out, new_state


def apply_conv_bn_swish(conv, bn, x, train=False):
    """``conv_bn_swish`` over a ``Conv1d`` and a ``BatchNorm`` module; in
    train mode the new running statistics go into ``bn``'s buffers."""
    out, new_state = conv_bn_swish(conv.params, bn.params, bn.state, x,
                                   conv.stride, train=train)
    if train:
        with torch.no_grad():
            for name, value in new_state.items():
                getattr(bn, name).copy_(value)
    return out


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


def lstm(params, x, reverse=False, impl=None):
    """Single-layer LSTM over (T, B, C); returns hidden states (T, B, H).

    ``impl`` "fused" runs the K2/K3 kernel pair (``kernels.lstm``; hs in
    x's dtype), "scan" a step-by-step loop (the JAX package's ``lax.scan``;
    hs in f32): the input projection for all timesteps is one matmul, the
    loop carries only h @ W_hh^T. None takes the kernels for a CUDA tensor
    and the scan for a CPU one, as the JAX package takes its kernels on the
    TPU and the scan on the CPU.
    """
    if impl is None:
        impl = "fused" if x.device.type == "cuda" else "scan"
    if impl == "fused":
        from remora_tpu_torch.kernels import lstm as lstm_kernel

        return lstm_kernel.lstm_fused(params, x, reverse=reverse)
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


def param_count(model):
    return sum(p.numel() for p in model.parameters())


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
        return batchnorm(self.params, self.state, x)[0]


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
