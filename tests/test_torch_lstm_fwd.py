"""K1 and K2 on the CPU: the shapes the bf16 tensor-core kernel
(``csrc/lstm_fwd_mma.cu``) and the f32 kernel (``csrc/lstm_fwd_f32.cu``)
take, and the bf16 plain versions the kernel is held to on the card
against the JAX kernels in interpret mode, at the kernel's own test shapes
(a batch under one 16-row tile, H = 12, C = 100). The f32 plain versions
meet the JAX kernels at the f32 kernel's widths in
``test_torch_kernels.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remora_tpu.kernels import pallas_lstm as PL
from remora_tpu_torch.kernels import lstm as K


def _case(T, B, C, H, seed=0):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    params = {
        name: rng.uniform(-bound, bound, shape).astype(np.float32)
        for name, shape in (("w_ih", (4 * H, C)), ("w_hh", (4 * H, H)),
                            ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))
    }
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("C,H", [(64, 64), (100, 12), (128, 64), (1, 1),
                                 (128, 8)])
def test_fwd_mma_takes_the_kernel_shapes(C, H):
    assert K.fwd_mma_shape_error("lstm_fwd", C, H) is None


@pytest.mark.parametrize("C,H", [(129, 64), (64, 65), (256, 96), (0, 8),
                                 (8, 0)])
def test_fwd_mma_refuses_other_shapes(C, H):
    msg = K.fwd_mma_shape_error("lstm_last", C, H)
    assert msg == (
        f"lstm_last: the bf16 kernel takes 1 <= C <= 128 and 1 <= H <= 64, "
        f"got C={C}, H={H}"
    )
    with pytest.raises(ValueError, match="the bf16 kernel takes"):
        K._fwd_mma_library("lstm_last", C, H)


def test_f32_fwd_shape_rule_takes_every_shape_of_the_old_kernels():
    """f32 K1 and K2 keep the shape rule of the kernels ``lstm_fwd_f32.cu``
    replaces (``lstm_last.cu``, ``lstm_train.cu``: 1 <= C <= 128, 1 <= H <=
    64): every such shape routes to the main-shape kernel, every wider one
    up to 128 to the wide kernels, and the limits are the new kernel's (32
    unit pairs a role, two 64-k chunks of W_x)."""
    assert (K.F32_FWD_MAX_C, K.F32_FWD_MAX_H) == (128, 64)
    for C in range(1, 129):
        for H in range(1, 129):
            want = "main" if H <= 64 else "wide"
            for leg in ("last", "fwd"):
                assert K.route(leg, torch.float32, C, H) == want, (leg, C, H)


def test_cpu_tensors_take_the_plain_version_at_any_width():
    """A shape the bf16 kernel refuses still runs on the CPU (the plain
    versions have no limit) and launches nothing."""
    params, x = _case(3, 5, 130, 8)
    tparams = {k: torch.from_numpy(v).bfloat16() for k, v in params.items()}
    xb = torch.from_numpy(x).bfloat16()
    launches = K.LAUNCHES, K.LAUNCHES_FWD
    hs, cs = K.lstm_fwd(xb, K.make_w_aug(tparams, torch.bfloat16))
    last = K.lstm_last(tparams, xb)
    assert (K.LAUNCHES, K.LAUNCHES_FWD) == launches
    # the scan (K1's plain version) carries h in f32, K2's rounds it
    assert (last.float() - hs[-1].float()).abs().max() <= 2e-2
    assert hs.dtype == cs.dtype == last.dtype == torch.bfloat16


def _jax_bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _torch_bf16(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


# bf16, the JAX kernels in interpret mode (one batch tile of B rows, time
# chunks of 4, a ragged tail) against the plain versions on the same bf16
# inputs: both round h to bf16 every step and sum in f32 in other orders,
# so a rounding may flip (one bf16 step is 2**-8 of a value)
@pytest.mark.parametrize("T,B,C,H", [(1, 7, 100, 12), (9, 7, 100, 12),
                                     (6, 17, 64, 64), (5, 3, 24, 16)])
def test_plain_bf16_forward_matches_pallas(monkeypatch, T, B, C, H):
    monkeypatch.setattr(PL, "_tile_plan", lambda *a, **k: (B, 4))
    params, x = _case(T, B, C, H, seed=T + B)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jx = _jax_bf16(x)
    j_last = PL.lstm_last_fused(jparams, jx, interpret=True)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    w_aug = K.make_w_aug(tparams, torch.bfloat16)
    j_hs, j_cs = PL._fwd_call(jx, jnp.asarray(w_aug.float().numpy()).astype(
        jnp.bfloat16), interpret=True)
    xb = torch.from_numpy(x).bfloat16()
    hs, cs = K.lstm_fwd(xb, w_aug)
    last = K.lstm_last({k: v.bfloat16() for k, v in tparams.items()}, xb)
    assert hs.dtype == cs.dtype == last.dtype == torch.bfloat16
    for got, want in ((hs, j_hs), (cs, j_cs), (last, j_last)):
        err = (got.float() - _torch_bf16(want)).abs().max().item()
        assert err <= 2e-2, err
