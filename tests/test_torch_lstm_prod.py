"""The f32 LSTM products (``kernels/lstm.py::lstm_prod_f32``) on the CPU:
each op's plain twin against the JAX package's math on the same numpy
inputs (``pallas_lstm._dot``, full precision in f32; dW in chunks of the
kernels' ``kDwChunkRows`` rows summed in chunk order, as the kernels sum
their partials), the path rule the CUDA library applies by shape, and the
wrapper's argument checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remora_tpu.kernels import pallas_lstm as PL
from remora_tpu_torch.kernels import lstm as K

# csrc/lstm_prod.cuh's kDwChunkRows: dW's partial sums a chunk of rows
DW_CHUNK_ROWS = 2048

# TB past one dW chunk (3 x 700 = 2100 rows: a full chunk and a short one),
# C != H both ways, odd widths, one row a step, one step
SHAPES = [(3, 700, 8, 12), (5, 9, 20, 12), (2, 7, 6, 5), (4, 1, 12, 20),
          (1, 6, 9, 4)]


def _inputs(T, B, C, H, seed=0):
    rng = np.random.default_rng(seed + T * B + C)
    bound = 1.0 / np.sqrt(H)
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    hs = rng.uniform(-1, 1, (T, B, H)).astype(np.float32)
    w_aug = rng.uniform(-bound, bound, (C + H + 1, 4 * H)).astype(np.float32)
    dg = (rng.normal(size=(T, B, 4 * H)) * 0.1).astype(np.float32)
    return x, hs, w_aug, dg


def _jax_product(op, x, hs, w_aug, dg):
    """The product as the JAX package's kernels compute it, f32 at full
    precision: Z = [x_t ; h_{t-1}] . W + b (h_{-1} = 0), Z_x = x_t . W_x +
    b, dx = dgates . W_x^T, dW_aug = [x ; h_{t-1} ; 1]^T . dgates."""
    T, B, C = x.shape
    H = w_aug.shape[1] // 4
    h_prev = np.concatenate([np.zeros_like(hs[:1]), hs[:-1]])
    xh = jnp.asarray(np.concatenate([x, h_prev], -1).reshape(T * B, C + H))
    w = jnp.asarray(w_aug)
    dg2 = jnp.asarray(dg.reshape(T * B, 4 * H))
    if op == "gates":
        return (PL._dot(xh, w[:C + H]) + w[C + H]).reshape(T, B, 4 * H)
    if op == "gates_x":
        return (PL._dot(jnp.asarray(x.reshape(T * B, C)), w[:C])
                + w[C + H]).reshape(T, B, 4 * H)
    if op == "dx":
        return PL._dot(dg2, w[:C].T).reshape(T, B, C)
    dw = jnp.zeros((C + H + 1, 4 * H), jnp.float32)
    for r0 in range(0, T * B, DW_CHUNK_ROWS):
        rows = slice(r0, r0 + DW_CHUNK_ROWS)
        part = jnp.concatenate([PL._dot(xh[rows].T, dg2[rows]),
                                dg2[rows].sum(0, keepdims=True)])
        dw = dw + part
    return dw


@pytest.mark.parametrize("op", K.PROD_OPS)
@pytest.mark.parametrize("T,B,C,H", SHAPES)
def test_prod_twin_matches_the_jax_math(op, T, B, C, H):
    """Each op's plain twin (what ``lstm_prod_f32`` runs on CPU tensors)
    against the JAX package's: Z, Z_x and dx within 1e-5 abs, dW within
    1e-4 of its max-abs (f32 sums in another order)."""
    x, hs, w_aug, dg = _inputs(T, B, C, H)
    launches = dict(K.LAUNCHES_PROD)
    got = K.lstm_prod_f32(op, *map(torch.from_numpy, (x, hs, w_aug)),
                          dg=torch.from_numpy(dg))
    assert K.LAUNCHES_PROD == launches
    want = np.asarray(_jax_product(op, x, hs, w_aug, dg))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max()
    if op == "dw":
        assert err <= 1e-4 * np.abs(want).max(), err
    else:
        assert err <= 1e-5, err


@pytest.mark.parametrize("T,B,C,H", SHAPES[:3])
def test_prod_twin_is_the_k3_references(T, B, C, H):
    """The twins are K3's plain parts: the gates and the products bit for
    bit, and Z_x the forward's x part, the gates with h = 0 within f32
    rounding."""
    x, hs, w_aug, dg = map(torch.from_numpy, _inputs(T, B, C, H))
    assert torch.equal(K.lstm_prod_f32("gates", x, hs, w_aug),
                       K.lstm_bwd_gates_reference(x, w_aug, hs))
    dx, dw = K.lstm_bwd_products_reference(x, hs, w_aug, dg)
    assert torch.equal(K.lstm_prod_f32("dx", x, hs, w_aug, dg), dx)
    assert torch.equal(K.lstm_prod_f32("dw", x, hs, w_aug, dg), dw)
    z_x = K.lstm_prod_f32("gates_x", x, None, w_aug)
    zero_h = K.lstm_prod_f32("gates", x, torch.zeros_like(hs), w_aug)
    assert (z_x - zero_h).abs().max().item() <= 1e-6


def test_prod_path_rule():
    """The Hopper kernel's path takes C and H (but for Z_x, which reads no
    h) multiples of 4 and 16-byte aligned operands; anything else is the
    element kernel's, as the CUDA library's p.vec decides."""
    x, hs, w_aug, dg = map(torch.from_numpy, _inputs(3, 5, 8, 12))
    assert all(K.prod_f32_path(op, 8, 12, x, hs, w_aug, dg) == "ws"
               for op in K.PROD_OPS)
    for C, H in ((130, 12), (8, 129), (6, 4)):
        for op in ("gates", "dx", "dw"):
            assert K.prod_f32_path(op, C, H) == "element"
    assert K.prod_f32_path("gates_x", 8, 129) == "ws"
    assert K.prod_f32_path("gates_x", 130, 12) == "element"
    off = torch.empty(x.numel() + 1)[1:].view_as(x)
    assert off.data_ptr() % 16 != 0
    assert K.prod_f32_path("gates_x", 8, 12, off, w_aug) == "element"
    assert K.prod_f32_path("gates_x", 8, 12, x, None, w_aug) == "ws"


def test_lstm_prod_f32_refuses_bad_arguments():
    x, hs, w_aug, dg = map(torch.from_numpy, _inputs(2, 3, 8, 4))
    with pytest.raises(ValueError, match="op"):
        K.lstm_prod_f32("dh", x, hs, w_aug, dg)
    with pytest.raises(ValueError, match="path"):
        K.lstm_prod_f32("dx", x, hs, w_aug, dg, path="tiles")
    with pytest.raises(ValueError, match="reads hs"):
        K.lstm_prod_f32("gates", x, None, w_aug)
    with pytest.raises(ValueError, match="reads hs and dg"):
        K.lstm_prod_f32("dw", x, hs, w_aug)
