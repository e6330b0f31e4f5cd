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
