"""The LSTM above the wide layers (C or H past 128: ConvLSTM_w_ref at sizes
above 128) on the CPU: the plain versions the general leg's kernels
(``csrc/lstm_general.cu``, the forward's cluster path
``csrc/lstm_general_cluster.cu``) are held to, and the model's eval logits
and one train step at size 160, against the JAX package run through its
Pallas kernels in interpret mode; the shape rule that sends a CUDA call to
the general leg, the plan that picks the forward's path, and the weight
layouts both forward paths read."""

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
@pytest.mark.parametrize("C,H", [(160, 160), (144, 200), (256, 256),
                                 (300, 300)])
def test_general_lstm_matches_pallas(pallas_interpret, C, H, dtype, tol,
                                     dw_tol):
    """K1, K2 and K3's plain versions at the general leg's widths (what
    the wrappers run on the CPU and its kernels are held to on the card)
    against ``_fwd_call``, ``_fwd_last_call`` and ``_bwd_call`` in
    interpret mode, and ``lstm_fused`` / ``lstm_last_fused`` end to end;
    the backward on the JAX forward's hs and cs. No kernel launches. (256,
    256) is the widest shape the forward's cluster plan takes in bf16 (f32
    refuses it), (300, 300) one it refuses in both dtypes: the plain twins
    pin the contract on both sides of the plan's limit."""
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


# the cluster plan over C, H in 129..1024 (C != H included): what it takes
# fits a CTA's 227 KB and runs GENERAL_FWD_PLAN_BATCH rows in one wave of
# the clusters an H100 holds; what it refuses runs the streaming kernel
_PLAN_SIDES = (129, 130, 144, 160, 192, 200, 255, 256, 257, 300, 384, 512,
               640, 1000, 1024)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("C", _PLAN_SIDES)
def test_general_fwd_plan_grid(dtype, C):
    caps = K.H100_CLUSTERS
    for H in (1, 8, 100, *_PLAN_SIDES):
        if K.route("fwd", dtype, C, H) != "general":
            continue
        plan = K.general_fwd_plan(C, H, dtype)
        path = K.general_fwd_path(dtype, C, H)
        # the one-wave R of each N, and whether its CTA fits
        fits = {n: K.general_fwd_cfg(C, H, dtype, n, -(-(-(-2048 // caps[n]))
                                                       // 32) * 32)
                for n in (2, 4, 8)}
        if plan is None:
            assert path == "stream", (C, H)
            assert not any(fits.values()), (C, H)
            continue
        assert path == "cluster", (C, H)
        N, R, smem = plan
        cfg = K.general_fwd_cfg(C, H, dtype, N, R)
        assert cfg == fits[N]
        assert N in (2, 4, 8) and R % 32 == 0
        assert smem == cfg["smem"] <= K.CLUSTER_SMEM_MAX == 232448
        clusters = -(-K.GENERAL_FWD_PLAN_BATCH // R)
        assert clusters <= caps[N] and clusters * N <= 132  # one wave
        assert clusters * R >= K.GENERAL_FWD_PLAN_BATCH == 2048
        assert cfg["threads"] <= (K.CLUSTER_MAX_THREADS_X2 if cfg["ub"] == 2
                                  else K.CLUSTER_MAX_THREADS[dtype])
        assert cfg["ub"] == 1 or (dtype == BF16 and cfg["hh"] % 16 == 0)
        assert (cfg["slots"] == 0 if cfg["resident"]
                else 2 <= cfg["slots"] <= K.CLUSTER_MAX_SLOTS)
        assert N * cfg["hh"] >= H and cfg["hh"] % (8 * cfg["ub"]) == 0
        # W_x resident first, then the least work a CTA (rows x units)
        work = R * cfg["hh"]
        for n, alt in fits.items():
            if alt is None:
                continue
            assert cfg["resident"] or not alt["resident"], (C, H, n)
            if alt["resident"] == cfg["resident"]:
                rows = -(-(-(-2048 // caps[n])) // 32) * 32
                assert work <= rows * alt["hh"], (C, H, n)


def test_general_fwd_plan_takes_the_model_widths():
    """bf16 at 160 and 256 and f32 at 160 run the cluster kernel in one
    wave of the clusters an H100 holds (66 of 2, 30 of 4, 15 of 8 CTAs): 4
    CTAs of 96 rows at bf16 160 (W_x resident), 8 of 160 at bf16 256
    (warps of two unit blocks), 4 of 96 at f32 160.
    f32 at 256 does not fit (at N = 8 one wave needs 160 rows: W_h's slice
    and the h tile take 297,472 bytes; at N = 4 and 2 W_h's slice alone is
    262,144 and 524,288) and streams; so does every shape at 1024; a card
    holding more clusters gets fewer rows a cluster."""
    assert K.H100_CLUSTERS == {2: 66, 4: 30, 8: 15}
    assert K.general_fwd_plan(160, 160, BF16)[:2] == (4, 96)
    assert K.general_fwd_plan(256, 256, BF16)[:2] == (8, 160)
    assert K.general_fwd_plan(160, 160, F32)[:2] == (4, 96)
    assert K.general_fwd_plan(256, 256, F32) is None
    assert K.general_fwd_path(F32, 256, 256) == "stream"
    assert K.route("fwd", F32, 256, 256) == "general"
    for dtype in (F32, BF16):
        assert K.general_fwd_plan(1024, 1024, dtype) is None
        assert K.general_fwd_path(dtype, 1024, 1024) == "stream"
        assert K.general_fwd_cfg(160, 160, dtype, 3, 64) is None
        assert K.general_fwd_cfg(160, 160, dtype, 4, 48) is None
    cfg = K.general_fwd_cfg(160, 160, BF16, 4, 96)
    assert cfg["resident"] and (cfg["hh"], cfg["ub"]) == (40, 1)
    assert cfg["threads"] == 480
    cfg = K.general_fwd_cfg(256, 256, BF16, 8, 160)
    assert not cfg["resident"] and (cfg["hh"], cfg["ub"]) == (32, 2)
    assert cfg["threads"] == 320
    assert K.general_fwd_cfg(200, 200, BF16, 8, 160)["hh"] == 32
    assert K.general_fwd_plan(256, 256, BF16, {2: 66, 4: 33, 8: 16})[:2] == (
        8, 128)


def _layout_spec(C, H, N, hh, bf16):
    """{(section, CTA column, k): W_aug (row, column)} of the cluster
    kernel's layout for CTAs of hh units, from its spec: a CTA column's
    unit and gate, the sections W_x (k < C), W_h (k < H) and the bias."""
    spec = {}
    for r in range(N):
        for n in range(4 * hh):
            if bf16:
                unit, gate = r * hh + 8 * (n // 32) + n % 8, (n % 32) // 8
            else:
                unit, gate = r * hh + n // 4, n % 4
            if unit >= H:
                continue
            col = gate * H + unit
            for k in range(C):
                spec[("x", r * 4 * hh + n, k)] = (k, col)
            for k in range(H):
                spec[("h", r * 4 * hh + n, k)] = (C + k, col)
            spec[("b", r * 4 * hh + n, 0)] = (C + H, col)
    return spec


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("C,H,N,R", [(20, 37, 4, 32), (17, 129, 2, 32),
                                     (1, 9, 8, 64), (20, 200, 8, 160)])
def test_general_fwd_weights_round_trip(dtype, C, H, N, R):
    """``general_fwd_weights`` holds every element of W_aug exactly once,
    where the cluster kernel reads it (W_x, then W_h, then the bias; bf16
    gate-column-major, f32 k-major; a CTA's 4hh columns contiguous), and
    zeros everywhere else; the layout reads back to W_aug. (20, 200) at N =
    8, R = 160 is bf16's layout for warps of two unit blocks (hh rounded up
    to 16)."""
    bf16 = dtype == BF16
    # (f32 takes no CTA of 160 rows at H = 200: its layout at 32 rows)
    cfg = (K.general_fwd_cfg(C, H, dtype, N, R)
           or K.general_fwd_cfg(C, H, dtype, N, 32))
    hh = cfg["hh"]
    spec = _layout_spec(C, H, N, hh, bf16)
    cols = N * 4 * hh
    c16 = -(-C // 16) * 16
    kh = -(-H // (16 if bf16 else 8)) * (16 if bf16 else 8)
    rng = np.random.default_rng(C + H + N)
    w_aug = torch.from_numpy(rng.normal(
        size=(C + H + 1, 4 * H)).astype(np.float32)).to(dtype)
    got = K.general_fwd_weights(w_aug, C, N, hh)
    assert got.dtype == dtype and got.shape == (cols * (c16 + kh + 1),)
    assert got.numel() == cfg["layout"]
    sections = {"x": (0, c16), "h": (cols * c16, kh),
                "b": (cols * (c16 + kh), 1)}
    flat = got.float().numpy()
    back = np.zeros((C + H + 1, 4 * H), np.float32)
    seen = np.zeros(flat.shape, bool)
    for (sec, n, k), (row, col) in spec.items():
        off, depth = sections[sec]
        pos = off + (n * depth + k if bf16 else k * cols + n)
        assert not seen[pos]
        seen[pos] = True
        back[row, col] = flat[pos]
    np.testing.assert_array_equal(back, w_aug.float().numpy())
    assert not flat[~seen].any()


def test_general_fwd_launch_picks_the_path_by_shape(monkeypatch):
    """``_general_fwd_launch`` decides the path from the plan alone, before
    any launch: the cluster library with the plan's N and R where the plan
    takes the shape, the streaming library where it refuses it; a launch
    that returns an error raises (``_raise_on``), with no second try on the
    other path."""
    calls = []

    class Fake:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, fn):
            def call(*args):
                calls.append((self.name, fn, args))
                return 7
            return call

    monkeypatch.setattr(K, "_cluster_library", lambda: Fake("cluster"))
    monkeypatch.setattr(K, "_general_library", lambda: Fake("stream"))
    monkeypatch.setattr(K, "cluster_capacity",
                        lambda index: K.H100_CLUSTERS)
    for dtype, C, H, want in ((BF16, 160, 160, "cluster"),
                              (BF16, 256, 256, "cluster"),
                              (F32, 160, 160, "cluster"),
                              (F32, 256, 256, "stream"),
                              (BF16, 1024, 1024, "stream")):
        x = torch.zeros((2, 3, C), dtype=dtype)
        w_aug = torch.zeros((C + H + 1, 4 * H), dtype=dtype)
        for leg in ("last", "fwd"):
            calls.clear()
            launch, error_string, path = K._general_fwd_launch(
                leg, x, w_aug, C, H)
            assert path == want
            rest = (2, 3, C, H, 0) if leg == "last" else (0, 2, 3, C, H, 0)
            err = launch(1, 2, 3, *rest)
            assert [c[0] for c in calls] == [want]
            if want == "cluster":
                N, R, _ = K.general_fwd_plan(C, H, dtype)
                assert calls[0][1] == "lstm_general_cluster_fwd"
                assert calls[0][2][-3:-1] == (N, R)
            else:
                assert calls[0][1] == ("lstm_general_last" if leg == "last"
                                       else "lstm_general_fwd")
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                K._raise_on(lambda e: b"refused", "lstm_fwd", err)
    assert set(K.LAUNCHES_GENERAL_FWD) == {"cluster", "stream"}
