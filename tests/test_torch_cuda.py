"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips where no CUDA device is present. On a
machine with a GPU and ``nvcc``:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from remora_tpu_torch.infer.infer import full_f32
from remora_tpu_torch.kernels import lstm as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(T, B, C, H, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    params = {
        name: torch.from_numpy(
            rng.uniform(-bound, bound, shape).astype(np.float32)
        ).to(device, dtype)
        for name, shape in (("w_ih", (4 * H, C)), ("w_hh", (4 * H, H)),
                            ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))
    }
    x = torch.from_numpy(rng.normal(size=(T, B, C)).astype(np.float32))
    return params, x.to(device, dtype)


# f32 is held to full-f32 arithmetic; bf16 rounds the h operand every step
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "T,B,C,H",
    [(1, 16, 64, 64), (13, 37, 64, 64), (24, 40, 24, 16), (9, 5, 128, 48)],
)
def test_lstm_last_kernel_matches_plain(cuda, T, B, C, H, dtype, tol):
    params, x = _case(T, B, C, H, dtype, cuda)
    launches = K.LAUNCHES
    with full_f32():
        got = K.lstm_last(params, x)
        want = K.lstm_last_reference(params, x)
    torch.cuda.synchronize()
    assert K.LAUNCHES == launches + 1
    assert got.shape == (B, H) and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


def test_lstm_last_kernel_refuses_bad_inputs(cuda):
    params, x = _case(5, 16, 64, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.lstm_last(params, x.transpose(0, 1))
    with pytest.raises(ValueError, match="dtype"):
        K.lstm_last(params, x.double())
    wide, xw = _case(5, 16, 64, 96, torch.float32, cuda)
    with pytest.raises(ValueError, match="kernel takes"):
        K.lstm_last(wide, xw)


def _w_aug(params):
    return K.make_w_aug(params, params["w_ih"].dtype)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


# K2/K3 against their plain versions at small, ragged shapes (batch not a
# multiple of the 16-row tile, H not a multiple of 16, C != H); f32 is held
# to full-f32 arithmetic, bf16 rounds h and dgates every step
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "T,B,C,H",
    [(1, 16, 64, 64), (13, 37, 64, 64), (24, 40, 24, 16), (9, 5, 100, 12)],
)
def test_lstm_train_kernels_match_plain(cuda, T, B, C, H, dtype, tol):
    params, x = _case(T, B, C, H, dtype, cuda)
    w_aug = _w_aug(params)
    dhs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(T, B, H)).astype(np.float32)).to(cuda, dtype)
    launches = (K.LAUNCHES_FWD, K.LAUNCHES_BWD)
    with full_f32():
        hs, cs = K.lstm_fwd(x, w_aug)
        hs_ref, cs_ref = K.lstm_fwd_reference(x, w_aug)
        hs_nocs, _ = K.lstm_fwd(x, w_aug, want_cs=False)
        dx, dw = K.lstm_bwd(x, w_aug, hs, cs, dhs)
        dx_ref, dw_ref = K.lstm_bwd_reference(x, w_aug, hs, cs, dhs)
    torch.cuda.synchronize()
    assert (K.LAUNCHES_FWD, K.LAUNCHES_BWD) == (launches[0] + 2,
                                                launches[1] + 1)
    assert hs.dtype == cs.dtype == dx.dtype == dtype
    assert dw.dtype == torch.float32 and dw.shape == (C + H + 1, 4 * H)
    assert torch.equal(hs_nocs, hs)
    for got, want in ((hs, hs_ref), (cs, cs_ref), (dx, dx_ref)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, err
    assert _rel(dw, dw_ref) <= (1e-4 if dtype == torch.float32 else tol)


def test_lstm_bwd_repeats_bit_for_bit(cuda):
    """K3 sums its per-block dW partials in block order (no atomics), so
    two runs on the same inputs give the same bits."""
    params, x = _case(31, 96, 64, 64, torch.float32, cuda)
    w_aug = _w_aug(params)
    dhs = torch.from_numpy(np.random.default_rng(3).normal(
        size=(31, 96, 64)).astype(np.float32)).to(cuda)
    hs, cs = K.lstm_fwd(x, w_aug)
    first = K.lstm_bwd(x, w_aug, hs, cs, dhs)
    second = K.lstm_bwd(x, w_aug, hs, cs, dhs)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_lstm_fused_autograd_on_card(cuda):
    """LSTMFused's gradients (K2 forward, K3 backward) against autograd
    through the plain scan, f32 on the card."""
    params, x = _case(17, 33, 64, 64, torch.float32, cuda)
    probe = torch.from_numpy(np.random.default_rng(2).normal(
        size=(17, 33, 64)).astype(np.float32)).to(cuda)
    grads = []
    with full_f32():
        for impl in ("fused", "scan"):
            p = {k: v.clone().requires_grad_() for k, v in params.items()}
            xx = x.clone().requires_grad_()
            hs = K.L.lstm(p, xx, impl=impl)
            (hs * probe).sum().backward()
            grads.append([xx.grad] + [p[k].grad for k in sorted(p)])
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-4


def test_lstm_train_kernels_refuse_bad_inputs(cuda):
    params, x = _case(5, 16, 64, 64, torch.float32, cuda)
    w_aug = _w_aug(params)
    with pytest.raises(ValueError, match="contiguous"):
        K.lstm_fwd(x.transpose(0, 1).contiguous().transpose(0, 1), w_aug)
    with pytest.raises(ValueError, match="dtype"):
        K.lstm_fwd(x.double(), w_aug.double())
    wide, xw = _case(5, 16, 128, 64, torch.float32, cuda)
    ww = _w_aug(wide)
    hs, cs = K.lstm_fwd(xw, ww)
    with pytest.raises(ValueError, match="kernel takes"):
        K.lstm_bwd(xw, ww, hs, cs, hs)
