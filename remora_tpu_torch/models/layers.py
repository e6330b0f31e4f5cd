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

Reduced-precision inference on the CPU follows the JAX package's CPU
backend (XLA) op for op (``rounds_per_op``): every op rounds to the
tensor's dtype, a conv's bias is added after the conv, BatchNorm's and
the logistic's transcendentals (1 / (1 + exp(-x)) in ``swish``) are taken
in f32 and rounded, and the LSTMs run the f32 scan. torch's own bf16 CPU
ops round a fused op once and its bf16 ``rsqrt`` is not correctly
rounded, which moves a sensitive head's ML bytes by several units. CUDA
tensors, and a forward that autograd records, keep torch's fused ops
(torch's backward rules round elsewhere than JAX's transposes anyway).

Train mode: ``batchnorm(train=True)`` and ``conv_bn_swish(train=True)``
return the new running statistics beside the output, as the JAX functions
do (the models write them into their BatchNorm buffers under
``torch.no_grad()``); ``lstm`` runs the K2/K3 kernel pair on CUDA tensors,
and ``REMORA_TPU_CONVBN=pallas`` runs the stride-1 conv blocks' backward
as K6. Inside ``synced_bn(mesh)`` every train-mode BatchNorm takes the
global batch's statistics over a data-parallel mesh (``BNSync``).
"""

import contextlib
import math
import os

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from remora_tpu_torch import RemoraError


def rounds_per_op(x):
    """True where the layers compute as the JAX package's CPU backend does
    (module docstring): a reduced-precision CPU tensor outside autograd."""
    return (x.device.type == "cpu" and x.dtype != torch.float32
            and not torch.is_grad_enabled())


def swish(x):
    if rounds_per_op(x):
        e = torch.exp(-x.float()).to(x.dtype)
        return x * torch.reciprocal((e + 1).float()).to(x.dtype)
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
    if rounds_per_op(x):
        out = F.conv1d(x.transpose(1, 2), params["w"], stride=stride)
        return out.transpose(1, 2) + params["b"]
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


def _unbiased(var, n):
    """The biased variance over n rows made unbiased (n a count or, under
    ``BNSync``, a 0-d tensor)."""
    if torch.is_tensor(n):
        return var * n / (n - 1).clamp(min=1)
    return var * n / max(n - 1, 1)


def batchnorm(params, state, x, train=False, momentum=0.1, eps=1e-5,
              sync=None):
    """BatchNorm over the last axis of x (B, T, C). Returns (out,
    new_state): eval mode normalises with the running statistics and keeps
    them; train mode normalises with the batch's and moves the running ones
    (unbiased variance), outside the graph; ``sync`` (a ``BNSync``) takes
    the global batch's statistics in train mode."""
    if train and sync is not None:
        out, mean, var = BatchNormSync.apply(x, params["gamma"],
                                             params["beta"], eps, sync)
        return out, _moved_state(state, mean, var, sync.n, momentum)
    if train:
        mean = x.mean((0, 1))
        var = x.var((0, 1), correction=0)
        n = x.shape[0] * x.shape[1]
        new_state = _moved_state(state, mean, var, n, momentum)
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    if rounds_per_op(x):
        inv = torch.rsqrt((var + eps).float()).to(var.dtype)
    else:
        inv = torch.rsqrt(var + eps)
    return (x - mean) * (inv * params["gamma"]) + params["beta"], new_state


def _moved_state(state, mean, var, n, momentum):
    """The running statistics moved toward a batch's (outside the graph)."""
    with torch.no_grad():
        return {
            "mean": (1 - momentum) * state["mean"] + momentum * mean,
            "var": ((1 - momentum) * state["var"]
                    + momentum * _unbiased(var, n)),
        }


# ---------------- synced BatchNorm (data parallel, ``sync_bn``) -----------
#
# A data-parallel rank holds its shard of the global batch. ``synced_bn``
# makes every train-mode BatchNorm in its scope normalise with the global
# batch's statistics, as one device holding the whole batch would (the JAX
# package's ``sync_bn``, where XLA inserts the reductions): per layer the
# forward all-reduces (sum, row count) and then the centred sum of squares,
# the single-device two-pass arithmetic; the backward all-reduces its two
# per-channel sums, sum(dz) and sum(dz * xhat), in one vector before it
# forms the conv-output cotangent. The parameter gradients stay this
# rank's partial sums: the data-parallel step's one all-reduce adds them.
# K6 (pallas mode) computes those sums inside its own body, so under
# ``synced_bn`` its backward gathers x and dout over the mesh and runs on
# the global batch, as GSPMD runs the JAX package's unpartitionable
# ``pallas_call`` on replicated operands.

_SYNC_MESH = None


@contextlib.contextmanager
def synced_bn(mesh):
    """Train-mode BatchNorm inside takes the global batch's statistics
    over ``mesh`` (a ``parallel.mesh.Mesh``; None leaves it per rank)."""
    global _SYNC_MESH
    saved, _SYNC_MESH = _SYNC_MESH, mesh
    try:
        yield
    finally:
        _SYNC_MESH = saved


class BNSync:
    """One train-mode BatchNorm call's collectives over a mesh; ``n`` is
    the global row count of its forward (a 0-d f32 tensor)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n = None

    def stats(self, y):
        """(mean, biased var) of y (B, T, C) over the global batch, in y's
        dtype (sums in f32): two all-reduces."""
        rows = y.shape[0] * y.shape[1]
        s = torch.cat([y.sum((0, 1), dtype=torch.float32),
                       torch.full((1,), rows, dtype=torch.float32,
                                  device=y.device)])
        self.mesh.all_reduce(s)
        self.n = s[-1]
        mean = (s[:-1] / self.n).to(y.dtype)
        d = (y - mean).float().square().sum((0, 1))
        self.mesh.all_reduce(d)
        return mean, (d / self.n).to(y.dtype)

    def sums(self, dgamma, dbeta):
        """The global sum(dz * xhat) and sum(dz): one all-reduce."""
        s = torch.cat([dgamma, dbeta]).float()
        self.mesh.all_reduce(s)
        g, b = s.chunk(2)
        return g.to(dgamma.dtype), b.to(dbeta.dtype)


class BatchNormSync(torch.autograd.Function):
    """(out, mean, var) of train-mode BatchNorm over the global batch
    (``batchnorm``'s formula); gamma's and beta's gradients are this
    rank's sums."""

    @staticmethod
    def forward(ctx, y, gamma, beta, eps, sync):
        mean, var = sync.stats(y)
        r = torch.rsqrt(var + eps)
        ctx.save_for_backward(gamma, (y - mean) * r, r)
        ctx.sync = sync
        ctx.mark_non_differentiable(mean, var)
        return (y - mean) * (r * gamma) + beta, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        gamma, xhat, r = ctx.saved_tensors
        dgamma = (dout * xhat).sum((0, 1))
        dbeta = dout.sum((0, 1))
        g_dgamma, g_dbeta = ctx.sync.sums(dgamma, dbeta)
        n = ctx.sync.n
        dy = gamma * r * (dout - g_dbeta / n - xhat * (g_dgamma / n))
        return dy, dgamma, dbeta, None, None


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
# conv to XLA). The other REMORA_TPU_CONVBN modes of the JAX package:
#   * remat: the plain path under activation checkpointing;
#   * fused_resid (``ConvBNSwishResid``): the forward also saves xhat, so
#     the backward skips the conv recompute;
#   * packed (``ConvBNSwishPacked``): ``_cbs_bwd_packed``'s math, whose
#     lane packing is a TPU layout trick; what carries over are its rounding
#     points (f32 BN math, dy rounded once to x's dtype, db from that dy);
#   * pallas (``ConvBNSwishK6``): the backward is K6, ``kernels.convbn``.


def _conv_nobias(w, x, stride):
    """(B, T, C_in) -> (B, T', C_out); w in torch (O, I, K) format."""
    return F.conv1d(x.transpose(1, 2), w, None, stride=stride).transpose(1, 2)


def _bn_swish_fwd(y, gamma, beta, eps, sync=None):
    """(out, mu, var, r, xhat) of swish(BN_train(y)); ``sync`` takes the
    global batch's statistics."""
    if sync is None:
        mu = y.mean((0, 1))
        var = y.var((0, 1), correction=0)
    else:
        mu, var = sync.stats(y)
    r = torch.rsqrt(var + eps)
    xhat = (y - mu) * r
    z = gamma * xhat + beta
    return z * torch.sigmoid(z), mu, var, r, xhat


def _folded_dy(dout, gamma, beta, xhat, r, sync=None):
    """(dy, dgamma, dbeta): the BN+swish backward with the folded identity
    (``_cbs_bwd``'s order of operations). Under ``sync`` dy takes the
    global sums and row count; dgamma and dbeta stay this rank's."""
    z = gamma * xhat + beta
    s = torch.sigmoid(z)
    dz = dout * (s + z * s * (1.0 - s))
    dgamma = (dz * xhat).sum((0, 1))
    dbeta = dz.sum((0, 1))
    g_dgamma, g_dbeta, n = dgamma, dbeta, xhat.shape[0] * xhat.shape[1]
    if sync is not None:
        (g_dgamma, g_dbeta), n = sync.sums(dgamma, dbeta), sync.n
    dy = gamma * r * (dz - g_dbeta / n - xhat * (g_dgamma / n))
    return dy, dgamma, dbeta


def _conv_grads(x, w, dy, stride):
    """(dw, dx) of the biasless conv for the conv-output cotangent dy."""
    x_ncw, dy_ncw = x.transpose(1, 2), dy.transpose(1, 2)
    dw = torch.nn.grad.conv1d_weight(x_ncw, w.shape, dy_ncw, stride=stride)
    dx = torch.nn.grad.conv1d_input(x_ncw.shape, w, dy_ncw, stride=stride)
    return dw, dx.transpose(1, 2)


class ConvBNSwish(torch.autograd.Function):
    """(out, mu, var) of swish(BN_train(conv(x, w))); mu and var are the
    biasless batch statistics, for the running-state update only. Every
    core takes a ``BNSync`` (or None) last: the global batch's statistics
    and sums."""

    @staticmethod
    def forward(ctx, w, b, gamma, beta, x, stride, eps, sync=None):
        del b  # cancels in the normalisation; its gradient is sum(dy)
        out, mu, var, r, _ = _bn_swish_fwd(_conv_nobias(w, x, stride), gamma,
                                           beta, eps, sync)
        ctx.save_for_backward(w, gamma, beta, x, mu, r)
        ctx.stride, ctx.sync = stride, sync
        ctx.mark_non_differentiable(mu, var)
        return out, mu, var

    @staticmethod
    def backward(ctx, dout, _dmu, _dvar):
        w, gamma, beta, x, mu, r = ctx.saved_tensors
        y = _conv_nobias(w, x, ctx.stride)  # recompute: cheaper than residuals
        dy, dgamma, dbeta = _folded_dy(dout, gamma, beta, (y - mu) * r, r,
                                       ctx.sync)
        dw, dx = _conv_grads(x, w, dy, ctx.stride)
        return dw, dy.sum((0, 1)), dgamma, dbeta, dx, None, None, None


class ConvBNSwishResid(torch.autograd.Function):
    """``ConvBNSwish`` whose forward saves xhat (``_cbs_fwd_resid``), so
    the backward reads it instead of recomputing the conv."""

    @staticmethod
    def forward(ctx, w, b, gamma, beta, x, stride, eps, sync=None):
        del b
        out, mu, var, r, xhat = _bn_swish_fwd(_conv_nobias(w, x, stride),
                                              gamma, beta, eps, sync)
        ctx.save_for_backward(w, gamma, beta, x, xhat, r)
        ctx.stride, ctx.sync = stride, sync
        ctx.mark_non_differentiable(mu, var)
        return out, mu, var

    @staticmethod
    def backward(ctx, dout, _dmu, _dvar):
        w, gamma, beta, x, xhat, r = ctx.saved_tensors
        dy, dgamma, dbeta = _folded_dy(dout, gamma, beta, xhat, r, ctx.sync)
        dw, dx = _conv_grads(x, w, dy, ctx.stride)
        return dw, dy.sum((0, 1)), dgamma, dbeta, dx, None, None, None


class ConvBNSwishPacked(torch.autograd.Function):
    """``_cbs_bwd_packed``: the forward saves xhat; the backward runs the
    BN+swish math in f32, rounds dy once to x's dtype (the JAX package's
    optimization barrier), sums db from that rounded dy and casts db,
    dgamma and dbeta to their parameters' dtypes. The forward is
    ``ConvBNSwishResid``'s."""

    @staticmethod
    def forward(ctx, w, b, gamma, beta, x, stride, eps, sync=None):
        return ConvBNSwishResid.forward(ctx, w, b, gamma, beta, x, stride,
                                        eps, sync)

    @staticmethod
    def backward(ctx, dout, _dmu, _dvar):
        w, gamma, beta, x, xhat, r = ctx.saved_tensors
        f32 = torch.float32
        g, be, r32, xh = (t.to(f32) for t in (gamma, beta, r, xhat))
        z = g * xh + be
        s = torch.sigmoid(z)
        dz = dout.to(f32) * (s + z * s * (1.0 - s))
        dgamma = (dz * xh).sum((0, 1))
        dbeta = dz.sum((0, 1))
        g_dgamma, g_dbeta, n = dgamma, dbeta, xhat.shape[0] * xhat.shape[1]
        if ctx.sync is not None:
            (g_dgamma, g_dbeta), n = ctx.sync.sums(dgamma, dbeta), ctx.sync.n
        dy = ((g * r32) * (dz - g_dbeta / n - xh * (g_dgamma / n))).to(
            x.dtype)
        db = dy.to(f32).sum((0, 1))
        dw, dx = _conv_grads(x, w, dy, ctx.stride)
        return (dw, db.to(w.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), dx, None, None, None)


class ConvBNSwishK6(torch.autograd.Function):
    """``ConvBNSwish`` whose backward is K6 (``kernels.convbn``, stride 1):
    ``_cbs_bwd_pallas``, with dw and db cast to w's dtype and dgamma and
    dbeta to gamma's. The forward is ``ConvBNSwish``'s.

    Under ``sync`` K6 runs on the global batch: x and dout are gathered
    over the mesh (every rank holds a shard of one size), dx keeps this
    rank's rows, and dw, db, dgamma and dbeta, which are then the global
    sums, are divided by the world size so the step's all-reduce adds them
    back up."""

    @staticmethod
    def forward(ctx, w, b, gamma, beta, x, stride, eps, sync=None):
        return ConvBNSwish.forward(ctx, w, b, gamma, beta, x, stride, eps,
                                   sync)

    @staticmethod
    def backward(ctx, dout, _dmu, _dvar):
        from remora_tpu_torch.kernels import convbn

        w, gamma, beta, x, mu, r = ctx.saved_tensors
        dout = dout.to(x.dtype)
        rows = x.shape[0]
        mesh = None if ctx.sync is None else ctx.sync.mesh
        if mesh is not None:
            x, dout = mesh.all_gather(x), mesh.all_gather(dout)
        dx, dw, db, dgamma, dbeta = convbn.conv_bn_swish_bwd(
            x, dout, w, gamma, beta, mu, r, stride=ctx.stride,
            need_dx=ctx.needs_input_grad[4],
        )
        if mesh is not None:
            if dx is not None:
                dx = dx[mesh.rank * rows:(mesh.rank + 1) * rows]
            dw, db, dgamma, dbeta = (t / mesh.world
                                     for t in (dw, db, dgamma, dbeta))
        return (dw.to(w.dtype), db.to(w.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), dx, None, None, None)


CONVBN_MODES = ("plain", "remat", "fused", "fused_resid", "packed", "pallas")


def convbn_impl(device):
    """The train-mode conv+BN+swish implementation: REMORA_TPU_CONVBN (one
    of ``CONVBN_MODES``, or auto), auto being plain on the CPU and fused on
    CUDA, as the JAX package picks by backend."""
    mode = os.environ.get("REMORA_TPU_CONVBN", "auto")
    if mode == "auto":
        return "plain" if torch.device(device).type == "cpu" else "fused"
    if mode not in CONVBN_MODES:
        raise RemoraError(f"unknown REMORA_TPU_CONVBN mode {mode!r}")
    return mode


def _cbs_plain(w, b, gamma, beta, x, stride, eps, sync=None):
    """(out, mean, var) of swish(BatchNorm1d_train(Conv1d(x))), the plain
    path's arithmetic (``batchnorm``'s formula); mean and var (with the
    bias) leave the graph."""
    y = conv1d({"w": w, "b": b}, x, stride)
    if sync is not None:
        out, mean, var = BatchNormSync.apply(y, gamma, beta, eps, sync)
        return swish(out), mean, var
    mean = y.mean((0, 1))
    var = y.var((0, 1), correction=0)
    out = (y - mean) * (torch.rsqrt(var + eps) * gamma) + beta
    return swish(out), mean.detach(), var.detach()


def conv_bn_swish(conv_params, bn_params, state, x, stride=1, train=False,
                  momentum=0.1, eps=1e-5, impl=None):
    """swish(BatchNorm1d(Conv1d(x))) with the running-state update. Returns
    (out, new_state). ``impl`` (train mode) is one of ``CONVBN_MODES``:
    "plain" (autograd through BN), "remat" (the plain path recomputed in
    the backward; the running-state update stays outside the recompute),
    "fused" (``ConvBNSwish``), "fused_resid", "packed" or "pallas" (K6 for
    stride-1 blocks); None picks by ``convbn_impl``. Inside ``synced_bn``
    train mode takes the global batch's statistics in every mode."""
    if not train:
        y = conv1d(conv_params, x, stride)
        return swish(batchnorm(bn_params, state, y)[0]), state
    if impl is None:
        impl = convbn_impl(x.device)
    sync = None if _SYNC_MESH is None else BNSync(_SYNC_MESH)
    if impl == "plain":
        y = conv1d(conv_params, x, stride)
        y, new_state = batchnorm(bn_params, state, y, True, momentum, eps,
                                 sync)
        return swish(y), new_state
    args = (conv_params["w"], conv_params["b"], bn_params["gamma"],
            bn_params["beta"], x, stride, eps, sync)
    if impl == "remat":
        out, mu, var = torch.utils.checkpoint.checkpoint(
            _cbs_plain, *args, use_reentrant=False)
    else:
        if impl == "pallas" and stride == 1:
            core = ConvBNSwishK6
        elif impl == "packed":
            core = ConvBNSwishPacked
        elif impl == "fused_resid":
            core = ConvBNSwishResid
        elif impl in ("fused", "pallas"):
            # a strided block in pallas mode takes ConvBNSwish: the JAX
            # package runs its Pallas backward on stride-1 blocks only
            core = ConvBNSwish
        else:
            raise RemoraError(f"unknown conv_bn_swish impl {impl!r}")
        out, mu, var = core.apply(*args)
        mu = mu + conv_params["b"].detach()
    if sync is None:
        y_cols = (x.shape[1] - conv_params["w"].shape[2]) // stride + 1
        n = x.shape[0] * y_cols
    else:
        n = sync.n
    return out, _moved_state(state, mu, var, n, momentum)


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
    loop carries only h @ W_hh^T. None (or "auto") takes the kernels for a
    CUDA tensor and the scan for a CPU one, as the JAX package takes its
    kernels on the TPU and the scan on the CPU; REMORA_TPU_LSTM=fused|scan
    overrides that (``lstm_impl``).
    """
    if impl is None or impl == "auto":
        impl = lstm_impl() or ("fused" if x.device.type == "cuda" else "scan")
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


def lstm_impl():
    """The LSTM implementation REMORA_TPU_LSTM asks for: "fused", "scan",
    or None (unset or any other value: auto), the rule of the JAX
    package's ``pallas_lstm.default_to_fused``."""
    mode = os.environ.get("REMORA_TPU_LSTM", "auto")
    return mode if mode in ("fused", "scan") else None


def lstm_last(params, x, impl=None):
    """Final hidden state of a forward LSTM over (T, B, C): (B, H).

    "fused" runs the last-only kernel (``kernels.lstm.lstm_last``; in x's
    dtype, its plain version for a CPU tensor), "scan" is ``lstm(params,
    x, impl="scan")[-1]`` (f32) on any device. None (or "auto") takes
    REMORA_TPU_LSTM's choice, else the kernel for a CUDA tensor and the
    scan for a CPU one, as ``lstm`` and the JAX package's ``lstm_last``
    pick.
    """
    if impl is None or impl == "auto":
        impl = lstm_impl() or ("fused" if x.device.type == "cuda" else "scan")
    if impl == "scan":
        return lstm(params, x, impl="scan")[-1]
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
