"""The LSTM at the wide layers (C, H up to 128: ConvLSTM_w_ref at sizes 65 to
128) on the CPU: the port's forward and backward, and the model's eval
logits and one train step at sizes 96 and 128, against the JAX package
run through its Pallas kernels in interpret mode; the REMORA_TPU_LSTM
override in ``layers.lstm`` and ``layers.lstm_last``; and the shape rule
that sends a CUDA call to the main-shape kernels, to ``csrc/lstm_wide.cu``
(K3: ``csrc/lstm_wide_bwd.cu``), above 128 to ``csrc/lstm_general.cu``, or
to a ``ValueError``; the wide forward's
split of the units over its cluster and the weight layouts the wide
kernels read."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remora_tpu.kernels import pallas_lstm as PL
from remora_tpu.models import conv_lstm_model as jax_convlstm
from remora_tpu.models import model_io as jax_io
from remora_tpu.train import train as jax_train
from remora_tpu_torch.kernels import lstm as K
from remora_tpu_torch.models import conv_lstm_model
from remora_tpu_torch.models import layers as L
from remora_tpu_torch.models import model_io
from remora_tpu_torch.train import train
from tests.test_torch_models import _inputs, _numpy_trees

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# a conv bias's gradient is rounding noise under train-mode BatchNorm
# (tests/test_torch_train.py), held to this absolute bound
BIAS_NOISE = 1e-5


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's LSTM through its Pallas kernels in interpret mode
    (one batch tile, time chunks of 4), and REMORA_TPU_LSTM=fused in both
    packages."""
    monkeypatch.setattr(PL, "_tile_plan", lambda B, *a, **k: (B, 4))
    monkeypatch.setattr(PL, "lstm_fused",
                        functools.partial(PL.lstm_fused, interpret=True))
    monkeypatch.setattr(PL, "lstm_last_fused",
                        functools.partial(PL.lstm_last_fused, interpret=True))
    monkeypatch.setenv("REMORA_TPU_LSTM", "fused")


def _case(T, B, C, H, dtype, seed=0):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    w_aug = rng.uniform(-bound, bound, (C + H + 1, 4 * H)).astype(np.float32)
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    dhs = rng.normal(size=(T, B, H)).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(w_aug).to(dtype),
            torch.from_numpy(dhs).to(dtype))


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(_JDT[t.dtype])


def _np(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# f32 is held to full-f32 arithmetic (hs, cs, dx <= 1e-5, dW <= 1e-4 of
# its largest entry); bf16 rounds h and dgates every step in both
# packages, after f32 sums in other orders, so a rounding may flip (one
# bf16 step is 2**-8 of a value)
@pytest.mark.parametrize("dtype,tol,dw_tol", [(torch.float32, 1e-5, 1e-4),
                                              (torch.bfloat16, 2e-2, 2e-2)])
@pytest.mark.parametrize("C,H", [(96, 96), (128, 128), (128, 100)])
def test_wide_lstm_matches_pallas(pallas_interpret, C, H, dtype, tol,
                                  dw_tol):
    """K1, K2 and K3's plain versions (what the wrappers run on the CPU
    and the wide kernels are held to on the card) against ``_fwd_call``,
    ``_fwd_last_call`` and ``_bwd_call`` in interpret mode; the backward
    on the JAX forward's hs and cs."""
    T, B = 6, 5
    x, w_aug, dhs = _case(T, B, C, H, dtype, seed=C + H)
    j_hs, j_cs = PL._fwd_call(_jax(x), _jax(w_aug), interpret=True)
    j_last = PL._fwd_last_call(_jax(x), _jax(w_aug), interpret=True)
    hs, cs = K.lstm_fwd(x, w_aug)
    params = {"w_ih": w_aug[:C].T, "w_hh": w_aug[C:C + H].T,
              "b_ih": w_aug[C + H], "b_hh": torch.zeros_like(w_aug[C + H])}
    last = K.lstm_last(params, x)
    assert hs.dtype == cs.dtype == last.dtype == dtype
    for got, want in ((hs, j_hs), (cs, j_cs), (last, j_last)):
        assert np.abs(got.float().numpy() - _np(want)).max() <= tol

    j_dx, j_dw = PL._bwd_call(_jax(x), _jax(w_aug), j_hs, j_cs, _jax(dhs),
                              interpret=True)
    hs_j = torch.from_numpy(_np(j_hs)).to(dtype)
    cs_j = torch.from_numpy(_np(j_cs)).to(dtype)
    dx, dw = K.lstm_bwd(x, w_aug, hs_j, cs_j, dhs)
    assert dx.dtype == dtype and dw.shape == (C + H + 1, 4 * H)
    assert np.abs(dx.float().numpy() - _np(j_dx)).max() <= tol
    assert _rel(dw.numpy(), _np(j_dw)) <= dw_tol


@functools.lru_cache(maxsize=None)
def _jax_step():
    loss_fn = jax_train.make_loss_fn(jax_convlstm, channels_last=True)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _port_model(size, params, bn_state):
    model = conv_lstm_model.init(size=size, kmer_len=9, num_out=3)
    model.load_state_dict(model_io.params_from_numpy(params, bn_state))
    return model


@pytest.mark.parametrize("size", [96, 128])
def test_wide_convlstm_matches_jax(pallas_interpret, size):
    """ConvLSTM_w_ref at a wide size, f32, both LSTMs fused: eval logits
    (``lstm_last``) <= 1e-5, and one train step (``LSTMFused``): loss <=
    1e-5, gradients <= 1e-4 of their largest entry (conv biases by an
    absolute bound)."""
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
    launches = K.LAUNCHES_FWD, K.LAUNCHES_BWD
    loss, _ = loss_fn(torch.from_numpy(np.array(sigs)),
                      torch.from_numpy(np.array(seqs)),
                      torch.from_numpy(labels).long())
    loss.backward()
    # the CPU runs the plain versions: no kernel launched
    assert (K.LAUNCHES_FWD, K.LAUNCHES_BWD) == launches
    assert abs(loss.item() - float(j_loss)) <= 1e-5
    grads = {k.replace(".", "/"): p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    assert "lstm1/w_hh" in grads
    for key, want in jax_io.flatten_tree(j_grads).items():
        if key not in grads:
            assert not np.asarray(want).any(), key
        elif "conv" in key and key.endswith("/b"):
            assert np.abs(grads[key].numpy()).max() <= BIAS_NOISE, key
        else:
            assert _rel(grads[key].numpy(), want) <= 1e-4, key


# ---------------- REMORA_TPU_LSTM ----------------


def _spy(monkeypatch, name):
    calls = []
    real = getattr(K, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(K, name, spy)
    return calls


@pytest.mark.parametrize("env,want", [("fused", "fused"), ("scan", "scan"),
                                      (None, None), ("pallas", None)],
                         ids=["fused", "scan", "unset", "unknown"])
def test_remora_tpu_lstm_routes(monkeypatch, env, want):
    """fused and scan force the implementation in ``lstm`` and
    ``lstm_last``; unset or any other value is auto: the scan for a CPU
    tensor in both, as the JAX package's auto picks its scan on the
    CPU."""
    if env is None:
        monkeypatch.delenv("REMORA_TPU_LSTM", raising=False)
    else:
        monkeypatch.setenv("REMORA_TPU_LSTM", env)
    assert L.lstm_impl() == want
    x, w_aug, _ = _case(4, 3, 12, 8, torch.float32)
    params = {"w_ih": w_aug[:12].T, "w_hh": w_aug[12:20].T,
              "b_ih": w_aug[20], "b_hh": torch.zeros(32)}
    fused = _spy(monkeypatch, "lstm_fused")
    last = _spy(monkeypatch, "lstm_last")
    hs = L.lstm(params, x)
    h_last = L.lstm_last(params, x)
    assert fused == (["lstm_fused"] if want == "fused" else [])
    assert last == (["lstm_last"] if want == "fused" else [])
    scan = L.lstm(params, x, impl="scan")
    assert torch.allclose(hs, scan, atol=1e-6, rtol=0)
    assert torch.allclose(h_last, scan[-1], atol=1e-6, rtol=0)
    # an explicit impl wins over the environment
    fused.clear()
    L.lstm(params, x, impl="fused")
    assert fused == ["lstm_fused"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_last_scan_is_the_scans_last_step(monkeypatch, dtype):
    monkeypatch.setenv("REMORA_TPU_LSTM", "fused")
    x, w_aug, _ = _case(5, 4, 16, 8, dtype)
    params = {"w_ih": w_aug[:16].T, "w_hh": w_aug[16:24].T,
              "b_ih": w_aug[24], "b_hh": torch.zeros(32, dtype=dtype)}
    last = _spy(monkeypatch, "lstm_last")
    got = L.lstm_last(params, x, impl="scan")
    assert last == []
    assert torch.equal(got, L.lstm(params, x, impl="scan")[-1])


# ---------------- the shape rule ----------------

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("leg,dtype,C,H,want", [
    # the main shape and the shapes near it keep today's kernels
    ("last", F32, 64, 64, "main"), ("last", F32, 128, 64, "main"),
    ("last", BF16, 100, 12, "main"), ("fwd", F32, 64, 64, "main"),
    ("fwd", BF16, 128, 64, "main"), ("bwd", F32, 64, 64, "main"),
    ("bwd", F32, 128, 44, "main"), ("bwd", BF16, 64, 64, "main"),
    ("bwd", BF16, 100, 28, "main"),
    # wider layers go to lstm_wide.cu (K3 to lstm_wide_bwd.cu)
    ("last", F32, 64, 65, "wide"), ("last", BF16, 96, 96, "wide"),
    ("fwd", F32, 128, 128, "wide"), ("fwd", BF16, 128, 100, "wide"),
    ("bwd", F32, 128, 64, "wide"), ("bwd", F32, 96, 96, "wide"),
    ("bwd", BF16, 100, 29, "wide"), ("bwd", BF16, 128, 128, "wide"),
])
def test_route(leg, dtype, C, H, want):
    assert K.route(leg, dtype, C, H) == want


@pytest.mark.parametrize("leg", ["last", "fwd", "bwd"])
@pytest.mark.parametrize("C,H", [(129, 64), (64, 129), (129, 129), (0, 8),
                                 (8, 0), (1025, 64), (64, 1025),
                                 (1025, 1025)])
def test_route_raises_above_the_limits(leg, C, H):
    """Past the wide kernels' 128 a shape goes to the general leg
    (``lstm_general.cu``); past its 1024, or below 1, no kernel takes it
    and ``route`` raises, naming the limits."""
    for dtype in (F32, BF16):
        if 1 <= C <= 1024 and 1 <= H <= 1024:
            assert K.route(leg, dtype, C, H) == "general"
            continue
        with pytest.raises(ValueError, match=(
                f"no kernel takes C={C}, H={H}; the LSTM kernels take "
                r"1 <= C <= 1024 and 1 <= H <= 1024")):
            K.route(leg, dtype, C, H)


def test_route_keeps_every_shape_of_the_main_kernels():
    """Every (C, H) up to 128 has a kernel in every leg and dtype, and a
    shape goes to the wide kernels exactly where the main-shape kernel of
    its leg and dtype refuses it."""
    for C in range(1, 129):
        for H in range(1, 129):
            mma_fwd = K.fwd_mma_shape_error("x", C, H) is None
            for leg, dtype, main in (
                    ("last", F32, H <= 64), ("fwd", F32, H <= 64),
                    ("last", BF16, mma_fwd), ("fwd", BF16, mma_fwd),
                    ("bwd", F32, K.bwd_f32_shape_error(C, H) is None),
                    ("bwd", BF16, H <= 64 and C + H <= 128)):
                assert K.route(leg, dtype, C, H) == (
                    "main" if main else "wide"), (leg, dtype, C, H)


def test_wide_fwd_units_split_the_layer():
    """Each CTA of the wide forward's cluster of two owns a run of
    ``wide_fwd_units(H)`` units: a multiple of 16 (the f32 kernel's
    quarter-warps of 8 unit pairs, the bf16 kernel's 4 warps of 4 units),
    the two runs cover H, and no smaller multiple of 16 would."""
    for H in range(1, 129):
        hh = K.wide_fwd_units(H)
        assert hh % 16 == 0 and 2 * hh >= H > 2 * (hh - 16), H
        assert hh <= K.WIDE_MAX_H // 2


@pytest.mark.parametrize("C,H", [(5, 3), (1, 65), (7, 97), (96, 96),
                                 (128, 127), (3, 128)])
def test_wide_fwd_weights_layout(C, H):
    """``lstm_wide.cu``'s f32 forward reads W_aug as (cp + hp, 2 hh, 4): row
    k < C is W_x's, row cp + k < cp + H W_h's, [u][g] = W_aug[row][g * H +
    u], zero in the rows and units between (cp, hp: C, H rounded up to 4;
    hh = ``wide_fwd_units(H)``); rebuilt here in numpy."""
    rng = np.random.default_rng(C * 1000 + H)
    w_aug = rng.normal(size=(C + H + 1, 4 * H)).astype(np.float32)
    got = K.wide_fwd_weights(torch.from_numpy(w_aug), C)
    cp, hp, hh = -(-C // 4) * 4, -(-H // 4) * 4, K.wide_fwd_units(H)
    want = np.zeros((cp + hp, 2 * hh, 4), np.float32)
    for k in range(C + H):
        row = k if k < C else cp + k - C
        for u in range(H):
            for g in range(4):
                want[row, u, g] = w_aug[k, g * H + u]
    assert got.shape == want.shape and got.is_contiguous()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("C,H", [(5, 3), (1, 65), (7, 4)])
def test_wide_bwd_weights_layout(C, H):
    """``lstm_wide_bwd.cu`` reads W_h^T (4H, H), element [g][u] =
    W_aug[C + u][g], whose rows of a CTA's own gate columns (gate * H + the
    CTA's units) make its shared slice, and W_x^T (4H, C), element [g][c] =
    W_aug[c][g]: dx's B operand, columns contiguous."""
    w_aug = torch.arange((C + H + 1) * 4 * H, dtype=torch.float32).reshape(
        C + H + 1, 4 * H)
    w_ht, w_xt = K.wide_bwd_weights(w_aug, C)
    assert w_ht.shape == (4 * H, H) and w_ht.is_contiguous()
    assert w_xt.shape == (4 * H, C) and w_xt.is_contiguous()
    for g in range(4 * H):
        for u in range(H):
            assert w_ht[g, u] == w_aug[C + u, g]
        for c in range(C):
            assert w_xt[g, c] == w_aug[c, g]
