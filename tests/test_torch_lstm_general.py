"""The LSTM above the wide layers (C or H past 128: ConvLSTM_w_ref at sizes
above 128) on the CPU: the plain versions the general leg's kernels
(``csrc/lstm_general.cu``) are held to, and the model's eval logits and one
train step at size 160, against the JAX package run through its Pallas
kernels in interpret mode; the shape rule that sends a CUDA call to the
general leg, and the weight layout its forward reads."""

import numpy as np
import pytest
import torch

from remora_tpu.kernels import pallas_lstm as PL
from remora_tpu.models import conv_lstm_model as jax_convlstm
from remora_tpu.models import model_io as jax_io
from remora_tpu_torch.kernels import lstm as K
from remora_tpu_torch.models import conv_lstm_model
from remora_tpu_torch.train import train
from tests.test_torch_lstm_wide import (
    BIAS_NOISE,
    _case,
    _jax,
    _jax_step,
    _np,
    _port_model,
    _rel,
    pallas_interpret,  # noqa: F401 (fixture)
)
from tests.test_torch_models import _inputs, _numpy_trees

F32, BF16 = torch.float32, torch.bfloat16


# f32 is held to full-f32 arithmetic (hs, cs, h_{T-1}, dx <= 1e-5, dW <=
# 1e-4 of its largest entry); bf16 rounds h and dgates every step in both
# packages, after f32 sums in other orders, so a rounding may flip (one
# bf16 step is 2**-8 of a value)
@pytest.mark.parametrize("dtype,tol,dw_tol", [(F32, 1e-5, 1e-4),
                                              (BF16, 2e-2, 2e-2)])
@pytest.mark.parametrize("C,H", [(160, 160), (144, 200)])
def test_general_lstm_matches_pallas(pallas_interpret, C, H, dtype, tol,
                                     dw_tol):
    """K1, K2 and K3's plain versions at the general leg's widths (what
    the wrappers run on the CPU and its kernels are held to on the card)
    against ``_fwd_call``, ``_fwd_last_call`` and ``_bwd_call`` in
    interpret mode, and ``lstm_fused`` / ``lstm_last_fused`` end to end;
    the backward on the JAX forward's hs and cs. No kernel launches."""
    assert K.route("fwd", dtype, C, H) == "general"
    T, B = 8, 16
    x, w_aug, dhs = _case(T, B, C, H, dtype, seed=C + H)
    params = {"w_ih": w_aug[:C].T, "w_hh": w_aug[C:C + H].T,
              "b_ih": w_aug[C + H], "b_hh": torch.zeros_like(w_aug[C + H])}
    j_hs, j_cs = PL._fwd_call(_jax(x), _jax(w_aug), interpret=True)
    j_last = PL._fwd_last_call(_jax(x), _jax(w_aug), interpret=True)
    j_params = {k: _jax(v.contiguous()) for k, v in params.items()}
    j_fused = PL.lstm_fused(j_params, _jax(x))
    j_last_fused = PL.lstm_last_fused(j_params, _jax(x))
    launches = dict(K.LAUNCHES_GENERAL)
    hs, cs = K.lstm_fwd(x, w_aug)
    last = K.lstm_last(params, x)
    fused = K.lstm_fused(params, x)
    assert hs.dtype == cs.dtype == last.dtype == dtype
    for got, want in ((hs, j_hs), (cs, j_cs), (last, j_last),
                      (fused, j_fused), (last, j_last_fused)):
        assert np.abs(got.float().numpy() - _np(want)).max() <= tol

    j_dx, j_dw = PL._bwd_call(_jax(x), _jax(w_aug), j_hs, j_cs, _jax(dhs),
                              interpret=True)
    hs_j = torch.from_numpy(_np(j_hs)).to(dtype)
    cs_j = torch.from_numpy(_np(j_cs)).to(dtype)
    dx, dw = K.lstm_bwd(x, w_aug, hs_j, cs_j, dhs)
    assert dx.dtype == dtype and dw.shape == (C + H + 1, 4 * H)
    assert np.abs(dx.float().numpy() - _np(j_dx)).max() <= tol
    assert _rel(dw.numpy(), _np(j_dw)) <= dw_tol
    # the CPU runs the plain versions
    assert K.LAUNCHES_GENERAL == launches


def test_general_convlstm_matches_jax(pallas_interpret):
    """ConvLSTM_w_ref at size 160 (C = H = 160), f32, both LSTMs fused:
    eval logits (``lstm_last``) <= 1e-5, and one train step
    (``LSTMFused``): loss <= 1e-5, gradients <= 1e-4 of their largest
    entry (conv biases by an absolute bound)."""
    size = 160
    params, bn_state = _numpy_trees(conv_lstm_model, size, 9, 3, seed=size)
    rng = np.random.default_rng(size)
    sigs, seqs = _inputs(rng, 6, 60, 9)
    want, _ = jax_convlstm.forward(params, bn_state, sigs, seqs)
    model = _port_model(size, params, bn_state)
    with torch.no_grad():
        got = model(torch.from_numpy(sigs), torch.from_numpy(seqs))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5

    sigs, seqs = (a.swapaxes(1, 2) for a in _inputs(rng, 8, 50, 9))
    labels = rng.integers(0, 3, 8).astype(np.int32)
    (j_loss, _), j_grads = _jax_step()(params, bn_state, sigs, seqs, labels)
    model = _port_model(size, params, bn_state)
    loss_fn = train.make_loss_fn(model, channels_last=True)
    launches = dict(K.LAUNCHES_GENERAL)
    loss, _ = loss_fn(torch.from_numpy(np.array(sigs)),
                      torch.from_numpy(np.array(seqs)),
                      torch.from_numpy(labels).long())
    loss.backward()
    assert K.LAUNCHES_GENERAL == launches
    assert abs(loss.item() - float(j_loss)) <= 1e-5
    grads = {k.replace(".", "/"): p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    assert grads["lstm1/w_hh"].shape == (4 * size, size)
    for key, want in jax_io.flatten_tree(j_grads).items():
        if key not in grads:
            assert not np.asarray(want).any(), key
        elif "conv" in key and key.endswith("/b"):
            assert np.abs(grads[key].numpy()).max() <= BIAS_NOISE, key
        else:
            assert _rel(grads[key].numpy(), want) <= 1e-4, key


@pytest.mark.parametrize("leg", ["last", "fwd", "bwd"])
@pytest.mark.parametrize("C,H,want", [
    (129, 129, "general"), (160, 160, "general"), (256, 256, "general"),
    (1024, 1024, "general"), (1, 1024, "general"), (1024, 1, "general"),
    (129, 8, "general"), (8, 129, "general"), (128, 128, "wide"),
    (1025, 8, None), (8, 1025, None), (2048, 2048, None)])
def test_general_route(leg, C, H, want):
    """C or H past 128 and up to 1024 go to ``lstm_general.cu`` in every leg
    and dtype; 128 stays on the wide kernels; past 1024 ``route`` raises,
    naming the limit."""
    for dtype in (F32, BF16):
        if want is None:
            with pytest.raises(ValueError, match=(
                    r"the LSTM kernels take 1 <= C <= 1024 and 1 <= H <= "
                    r"1024")):
                K.route(leg, dtype, C, H)
        else:
            assert K.route(leg, dtype, C, H) == want
    assert (K.GENERAL_MAX_C, K.GENERAL_MAX_H) == (1024, 1024)


@pytest.mark.parametrize("C,H", [(129, 3), (5, 160), (144, 200)])
def test_general_weights_layout(C, H):
    """``lstm_general.cu``'s forward reads W_aug as (C + H + 1, H, 4):
    [k][u][g] = W_aug[k][g * H + u], the bias row last; rebuilt here in
    numpy, in both dtypes."""
    rng = np.random.default_rng(C * 1000 + H)
    w_aug = rng.normal(size=(C + H + 1, 4 * H)).astype(np.float32)
    want = np.zeros((C + H + 1, H, 4), np.float32)
    for k in range(C + H + 1):
        for u in range(H):
            for g in range(4):
                want[k, u, g] = w_aug[k, g * H + u]
    for dtype in (F32, BF16):
        got = K.general_weights(torch.from_numpy(w_aug).to(dtype))
        assert got.shape == want.shape and got.is_contiguous()
        assert got.dtype == dtype
        np.testing.assert_array_equal(
            got.float().numpy(), torch.from_numpy(want).to(dtype).float())
