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
    256) is the widest shape the forward's cluster plan takes (f32 on the
    W_h-ring path), (300, 300) one it refuses in both dtypes: the plain
    twins pin the contract on both sides of the plan's limit."""
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
# the clusters an H100 holds, on the W_h-ring path (f32, rows a multiple of
# 48) only where no CTA of the other kernels fits; what it refuses runs the
# streaming kernel
_PLAN_SIDES = (129, 130, 144, 160, 192, 200, 255, 256, 257, 300, 384, 512,
               640, 1000, 1024)


def _one_wave_rows(n, rows, caps):
    return -(-(-(-2048 // caps[n])) // rows) * rows


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("C", _PLAN_SIDES)
def test_general_fwd_plan_grid(dtype, C):
    caps = K.H100_CLUSTERS
    for H in (1, 8, 100, *_PLAN_SIDES):
        if K.route("fwd", dtype, C, H) != "general":
            continue
        plan = K.general_fwd_plan(C, H, dtype)
        path = K.general_fwd_path(dtype, C, H)
        # the one-wave R of each N and each path, and whether its CTA fits
        fits, ring_fits = {}, {}
        for n in (2, 4, 8):
            cfg = K.general_fwd_cfg(C, H, dtype, n, _one_wave_rows(n, 32,
                                                                   caps))
            fits[n] = cfg if cfg and not cfg["ring"] else None
            cfg = K.general_fwd_cfg(C, H, dtype, n, _one_wave_rows(
                n, K.CLUSTER_RING_ROWS, caps))
            ring_fits[n] = cfg if cfg and cfg["ring"] else None
        if plan is None:
            assert path == "stream", (C, H)
            assert not any(fits.values()), (C, H)
            assert not any(ring_fits.values()), (C, H)
            continue
        assert path == "cluster", (C, H)
        N, R, smem = plan
        cfg = K.general_fwd_cfg(C, H, dtype, N, R)
        assert N in (2, 4, 8)
        assert smem == cfg["smem"] <= K.CLUSTER_SMEM_MAX == 232448
        clusters = -(-K.GENERAL_FWD_PLAN_BATCH // R)
        assert clusters <= caps[N] and clusters * N <= 132  # one wave
        assert clusters * R >= K.GENERAL_FWD_PLAN_BATCH == 2048
        assert (cfg["slots"] == 0 if cfg["resident"]
                else 2 <= cfg["slots"] <= K.CLUSTER_MAX_SLOTS)
        assert N * cfg["hh"] >= H and cfg["hh"] % (8 * cfg["ub"]) == 0
        if cfg["ring"]:  # only where no other CTA fits
            assert not any(fits.values()), (C, H)
            assert dtype == F32 and cfg == ring_fits[N]
            assert R % K.CLUSTER_RING_ROWS == 0 and cfg["ub"] == 1
            assert not cfg["resident"]
            assert cfg["threads"] == 32 * (cfg["hh"] // 8) * (R // 48) \
                <= K.CLUSTER_RING_MAX_THREADS == 384
            fits = ring_fits
        else:
            assert cfg == fits[N] and R % 32 == 0
            assert cfg["threads"] <= (K.CLUSTER_MAX_THREADS_X2
                                      if cfg["ub"] == 2
                                      else K.CLUSTER_MAX_THREADS[dtype])
            assert cfg["ub"] == 1 or (dtype == BF16 and cfg["hh"] % 16 == 0)
        # W_x resident first, then the least work a CTA (rows x units)
        work = R * cfg["hh"]
        for n, alt in fits.items():
            if alt is None:
                continue
            assert cfg["resident"] or not alt["resident"], (C, H, n)
            if alt["resident"] == cfg["resident"]:
                rows = _one_wave_rows(n, 48 if cfg["ring"] else 32, caps)
                assert work <= rows * alt["hh"], (C, H, n)


def test_general_fwd_plan_takes_the_model_widths():
    """bf16 at 160 and 256 and f32 at 160 run the cluster kernels in one
    wave of the clusters an H100 holds (66 of 2, 30 of 4, 15 of 8 CTAs): 4
    CTAs of 96 rows at bf16 160 (W_x resident), 8 of 160 at bf16 256
    (warps of two unit blocks), 4 of 96 at f32 160.
    At f32 256 no CTA of those kernels fits (at N = 8 one wave needs 160
    rows: W_h's slice and the h tile take 297,472 bytes; at N = 4 and 2
    W_h's slice alone is 262,144 and 524,288): it takes the W_h-ring path,
    8 CTAs of 144 rows (``test_general_fwd_ring_takes_f32_at_256``). f32
    at 512 and every shape at 1024 stream; a card holding more clusters
    gets fewer rows a cluster."""
    assert K.H100_CLUSTERS == {2: 66, 4: 30, 8: 15}
    assert K.general_fwd_plan(160, 160, BF16)[:2] == (4, 96)
    assert K.general_fwd_plan(256, 256, BF16)[:2] == (8, 160)
    assert K.general_fwd_plan(160, 160, F32)[:2] == (4, 96)
    assert K.general_fwd_plan(256, 256, F32)[:2] == (8, 144)
    assert K.general_fwd_cfg(256, 256, F32, 8, 144)["ring"]
    assert K.general_fwd_path(F32, 256, 256) == "cluster"
    assert K.route("fwd", F32, 256, 256) == "general"
    assert K.general_fwd_plan(512, 512, F32) is None
    assert K.general_fwd_path(F32, 512, 512) == "stream"
    for dtype in (F32, BF16):
        assert K.general_fwd_plan(1024, 1024, dtype) is None
        assert K.general_fwd_path(dtype, 1024, 1024) == "stream"
        assert K.general_fwd_cfg(160, 160, dtype, 3, 64) is None
        assert K.general_fwd_cfg(160, 160, dtype, 4, 40) is None
    # 48 rows: no kernel of 32-row warps; in f32 the W_h-ring path's
    assert K.general_fwd_cfg(160, 160, BF16, 4, 48) is None
    assert K.general_fwd_cfg(160, 160, F32, 4, 48)["ring"]
    cfg = K.general_fwd_cfg(160, 160, BF16, 4, 96)
    assert cfg["resident"] and (cfg["hh"], cfg["ub"]) == (40, 1)
    assert cfg["threads"] == 480
    cfg = K.general_fwd_cfg(256, 256, BF16, 8, 160)
    assert not cfg["resident"] and (cfg["hh"], cfg["ub"]) == (32, 2)
    assert cfg["threads"] == 320
    assert K.general_fwd_cfg(200, 200, BF16, 8, 160)["hh"] == 32
    assert K.general_fwd_plan(256, 256, BF16, {2: 66, 4: 33, 8: 16})[:2] == (
        8, 128)
    # the plans the other kernels took stay theirs
    for C, dtype in ((160, BF16), (256, BF16), (160, F32)):
        N, R, _ = K.general_fwd_plan(C, C, dtype)
        assert not K.general_fwd_cfg(C, C, dtype, N, R)["ring"]


def test_general_fwd_ring_takes_f32_at_256():
    """f32 at C = H = 256 on the W_h-ring path: clusters of 8 CTAs of 32
    units over 144 rows (one wave of 15 clusters needs 137; the warps own
    48 rows), 12 warps of 8 units; shared memory the [144][260] f32 h tile
    and 2 ring slots of W_h's k64 chunk, [64][128] f32 (x_t . W_x + b is
    a product before the walk). The path takes f32 alone, rows in 48s and
    at most 384 threads; f32 at 193 (an hh of 25 rounds up to 32) takes the
    same CTA shape, 257 (hh 40: 15 warps) streams."""
    assert K.general_fwd_plan(256, 256, F32) == (8, 144, 215296)
    cfg = K.general_fwd_cfg(256, 256, F32, 8, 144)
    assert (cfg["hh"], cfg["ub"], cfg["threads"], cfg["slots"],
            cfg["resident"], cfg["ring"]) == (32, 1, 384, 2, False, True)
    h_tile = 144 * (256 + 4) * 4
    slot = K.CLUSTER_RING_CHUNK * 128 * 4
    assert h_tile == 149760 and slot == 32768
    assert cfg["smem"] == h_tile + 2 * slot == 215296
    assert h_tile + 3 * slot > K.CLUSTER_SMEM_MAX
    assert cfg["layout"] == 8 * 128 * (256 + 256 + 1)
    assert cfg == K.general_fwd_ring_cfg(256, 256, 8, 144)
    assert K.general_fwd_cfg(256, 256, BF16, 8, 144) is None
    assert K.general_fwd_ring_cfg(256, 256, 8, 160) is None  # not 48s
    assert K.general_fwd_ring_cfg(256, 256, 4, 96) is None   # 16 warps
    assert K.general_fwd_ring_cfg(256, 256, 8, 192) is None  # 16 warps
    assert K.general_fwd_ring_cfg(257, 257, 8, 144) is None  # 15 warps
    assert K.general_fwd_plan(193, 193, F32)[:2] == (8, 144)
    assert K.general_fwd_cfg(193, 193, F32, 8, 144)["hh"] == 32
    assert K.general_fwd_plan(257, 257, F32) is None


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
                                     (1, 9, 8, 64), (20, 200, 8, 160),
                                     (20, 200, 8, 144)])
def test_general_fwd_weights_round_trip(dtype, C, H, N, R):
    """``general_fwd_weights`` holds every element of W_aug exactly once,
    where the cluster kernel reads it (W_x, then W_h, then the bias; bf16
    gate-column-major, f32 k-major; a CTA's 4hh columns contiguous), and
    zeros everywhere else; the layout reads back to W_aug. (20, 200) at N =
    8, R = 160 is bf16's layout for warps of two unit blocks (hh rounded up
    to 16); at R = 144 f32's is the W_h-ring path's (the same layout)."""
    bf16 = dtype == BF16
    # (f32 takes no CTA of 160 rows at H = 200, bf16 none of 144: the
    # layout at 32 rows)
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
    takes the shape (f32 at 256 its W_h-ring entry, the product and the
    walk), the streaming library where it refuses it; a launch that
    returns an error raises (``_raise_on``), with no second try on the
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
                              (F32, 256, 256, "cluster"),
                              (F32, 512, 512, "stream"),
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
            if want == "cluster" and K.general_fwd_cfg(
                    C, H, dtype, *K.general_fwd_plan(C, H, dtype)[:2])["ring"]:
                # the W_h-ring kernel, Z_x's product and the walk (parts 3)
                N, R, _ = K.general_fwd_plan(C, H, dtype)
                assert calls[0][1] == "lstm_general_ring_fwd"
                assert calls[0][2][-6:] == (C, H, N, R, 3, 0)
                assert calls[0][2][0] == 1
                outs = (None, None, 3) if leg == "last" else (3, 0, None)
                assert calls[0][2][4:7] == outs
            elif want == "cluster":
                N, R, _ = K.general_fwd_plan(C, H, dtype)
                assert calls[0][1] == "lstm_general_cluster_fwd"
                assert calls[0][2][-3:-1] == (N, R)
            else:
                assert calls[0][1] == ("lstm_general_last" if leg == "last"
                                       else "lstm_general_fwd")
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                K._raise_on(lambda e: b"refused", "lstm_fwd", err)
    assert set(K.LAUNCHES_GENERAL_FWD) == {"cluster", "stream"}


# K3's cluster plan over the same sides (C != H included): what it takes
# fits a CTA's 227 KB and 384 threads and runs GENERAL_FWD_PLAN_BATCH rows
# in one wave of the clusters an H100 holds; where no cluster size and
# pass count fit all R rows, f32 walks them in row groups if those fit;
# what it refuses runs the streaming general_rec_kernel
def _group_fit(H, dtype, caps):
    """(R, groups, cfg) of the row-group path at clusters of 8's one-wave
    rows, or None."""
    groups = -(-(-(-2048 // caps[8])) // K.CLUSTER_REC_GROUP_ROWS)
    rows = groups * K.CLUSTER_REC_GROUP_ROWS
    cfg = K.general_rec_cfg(H, dtype, 8, rows, 1, groups)
    return None if cfg is None else (rows, groups, cfg)


def _rec_fits(H, dtype, caps):
    """{N: (R, P, cfg) of the fewest passes that fit at N's one-wave R, or
    None}."""
    out = {}
    for n in (2, 4, 8):
        rows = -(-(-(-2048 // caps[n])) // 32) * 32
        out[n] = next(((rows, p, cfg) for p in range(
            1, K.CLUSTER_REC_MAX_PASSES + 1)
            if (cfg := K.general_rec_cfg(H, dtype, n, rows, p)) is not None),
            None)
    return out


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("C", _PLAN_SIDES)
def test_general_rec_plan_grid(dtype, C):
    caps = K.H100_CLUSTERS
    for H in (1, 8, 100, *_PLAN_SIDES):
        if K.route("bwd", dtype, C, H) != "general":
            continue
        plan = K.general_rec_plan(C, H, dtype)
        path = K.general_bwd_path(dtype, C, H)
        fits = _rec_fits(H, dtype, caps)
        group = _group_fit(H, dtype, caps)
        if plan is None:
            assert path == "stream", (C, H)
            assert not any(fits.values()) and group is None, (C, H)
            continue
        assert path == "cluster", (C, H)
        N, R, smem, P, groups = plan
        if groups > 1:  # the row-group path: only where no pass count fits
            assert not any(fits.values()), (C, H)
            assert dtype == F32 and group[:2] == (R, groups) and N == 8
            cfg = group[2]
            assert cfg == K.general_rec_cfg(H, dtype, N, R, P, groups)
            assert smem == cfg["smem"] <= K.CLUSTER_SMEM_MAX
            assert P == 1 and cfg["groups"] == groups
            assert R == groups * K.CLUSTER_REC_GROUP_ROWS
            clusters = -(-K.GENERAL_FWD_PLAN_BATCH // R)
            assert clusters <= caps[N] and clusters * R >= 2048
            # a thread a unit of the CTA and 4 rows of every group
            assert cfg["threads"] == 32 * 12 == K.CLUSTER_REC_MAX_THREADS
            assert cfg["pairs"] * (cfg["threads"] // cfg["hh"]) == R
            assert N * cfg["hh"] >= H and cfg["hh"] == cfg["hc"] == 32
            assert cfg["nct"] == N * cfg["hc"] == 256
            continue
        assert groups == 1
        assert fits[N] is not None and fits[N][:2] == (R, P)
        cfg = fits[N][2]
        assert cfg == K.general_rec_cfg(H, dtype, N, R, P)
        assert cfg["groups"] == 1
        assert smem == cfg["smem"] <= K.CLUSTER_SMEM_MAX == 232448
        clusters = -(-K.GENERAL_FWD_PLAN_BATCH // R)
        assert clusters <= caps[N] and clusters * N <= 132  # one wave
        assert clusters * R >= K.GENERAL_FWD_PLAN_BATCH == 2048
        assert cfg["threads"] <= K.CLUSTER_REC_MAX_THREADS == 384
        assert cfg["pairs"] in K.CLUSTER_REC_PAIRS[dtype]
        # every (row, unit) pair of the CTA has a thread
        assert (cfg["threads"] // cfg["hh"]) * cfg["pairs"] >= R
        assert N * cfg["hh"] >= H and cfg["hh"] % (8 * P) == 0
        assert cfg["hc"] * P == cfg["hh"] and cfg["nct"] % 32 == 0
        assert cfg["nct"] >= N * cfg["hc"]
        # the fewest passes, then the least work a CTA, then the smaller N
        for n, alt in fits.items():
            if alt is not None:
                key = (alt[1], alt[0] * alt[2]["hh"], n)
                assert (P, R * cfg["hh"], N) <= key, (C, H, n)


def test_general_rec_plan_takes_the_model_widths():
    """K3's recurrence at the model's widths: bf16 at 160 on clusters of 2
    CTAs over 32 rows (the least work a CTA: 2560 (row, unit) pairs, where
    4 x 96 and 8 x 160 give 3840; the chip's split measured 9.5 against
    16.3 and 18.9 us a step), f32 at 160 on 4 x 96 (N = 2 does not fit:
    W_h^T's slice alone is 320 x 164 f32), bf16 at 256 on 8 x 160 with
    the exchange in two passes (one pass needs 276,992 bytes); f32 at 256
    (W_h^T's slice and the dgates tile of all 160 rows take 217,600 bytes
    before any partials) on 8 x 144 rows walked as 3 groups of 48: W_h^T's
    128 x 256 f32 slice, two 48 x 132 f32 dgates tiles and an 8 x 48 x 32
    f32 receive tile; f32 at 512 and every shape at 1024 stream."""
    assert K.general_rec_plan(160, 160, BF16) == (2, 32, 146432, 1, 1)
    assert K.general_rec_plan(160, 160, F32) == (4, 96, 229376, 1, 1)
    assert K.general_rec_plan(256, 256, BF16) == (8, 160, 215552, 2, 1)
    smem = 128 * 256 * 4 + 2 * 48 * 132 * 4 + 8 * 48 * 32 * 4
    assert smem == 230912 <= K.CLUSTER_SMEM_MAX
    assert K.general_rec_plan(256, 256, F32) == (8, 144, smem, 1, 3)
    assert K.general_bwd_path(F32, 256, 256) == "cluster"
    assert K.general_rec_cfg(256, F32, 8, 160, 1) is None  # all 160 rows
    cfg = K.general_rec_cfg(256, F32, 8, 144, 1, 3)
    assert (cfg["hh"], cfg["hc"], cfg["nct"], cfg["pairs"],
            cfg["threads"], cfg["groups"]) == (32, 32, 256, 12, 384, 3)
    # the row-group path is f32 on clusters of 8, one pass, 3 groups of
    # 48 rows, H to 256
    assert K.general_rec_cfg(256, BF16, 8, 144, 1, 3) is None
    assert K.general_rec_cfg(256, F32, 4, 144, 1, 3) is None
    assert K.general_rec_cfg(256, F32, 8, 144, 2, 3) is None
    assert K.general_rec_cfg(256, F32, 8, 160, 1, 3) is None
    assert K.general_rec_cfg(257, F32, 8, 144, 1, 3) is None
    assert K.general_rec_cfg(256, F32, 8, 192, 1, 4) is None
    assert K.general_rec_cfg(256, F32, 8, 48, 1, 1) is None
    assert K.general_rec_cfg(256, F32, 8, 96, 1, 2) is None
    # a card holding 22 clusters of 8 (R = 96) fits all rows' partials in
    # four passes; one holding 14 would need a fourth group, whose carries
    # outgrow the registers: it streams; f32 at 224 (an hh of 28 rounds up
    # to 32) takes the same CTA as 256
    assert K.general_rec_plan(256, 256, F32, {2: 66, 4: 30, 8: 22}) == (
        8, 96, 220672, 4, 1)
    assert K.general_rec_plan(256, 256, F32, {2: 66, 4: 30, 8: 14}) is None
    assert K.general_rec_plan(224, 224, F32) == (8, 144, smem, 1, 3)
    assert K.general_rec_plan(512, 512, F32) is None
    assert K.general_bwd_path(F32, 512, 512) == "stream"
    for dtype in (F32, BF16):
        assert K.general_rec_plan(1024, 1024, dtype) is None
        assert K.general_bwd_path(dtype, 1024, 1024) == "stream"
        assert K.general_rec_cfg(160, dtype, 3, 64, 1) is None
        assert K.general_rec_cfg(160, dtype, 4, 48, 1) is None
        assert K.general_rec_cfg(160, dtype, 4, 96, 0) is None
    assert K.general_rec_cfg(256, BF16, 8, 160, 1) is None
    assert K.general_rec_cfg(160, F32, 2, 32, 1) is None
    cfg = K.general_rec_cfg(160, BF16, 2, 32, 1)
    assert (cfg["hh"], cfg["pairs"], cfg["threads"]) == (80, 8, 320)
    cfg = K.general_rec_cfg(160, F32, 4, 96, 1)
    assert (cfg["hh"], cfg["pairs"], cfg["threads"]) == (40, 12, 320)
    cfg = K.general_rec_cfg(256, BF16, 8, 160, 2)
    assert (cfg["hh"], cfg["hc"], cfg["pairs"], cfg["threads"]) == (
        32, 16, 14, 384)
    # 256 x 136 bf16 W_h^T slice, 160 x 136 dgates tile, receive tile
    # 8 x 160 x 16 f32, dh tile 160 x 32 f32
    assert cfg["smem"] == 256 * 136 * 2 + 160 * 136 * 2 + 8 * 160 * 16 * 4 \
        + 160 * 32 * 4
    # a card holding more clusters gets fewer rows a cluster (at 33 of 4,
    # 64 rows: bf16 256 then fits 4 CTAs in fewer passes than 8)
    assert K.general_rec_plan(160, 160, BF16, {2: 68, 4: 33, 8: 16})[:2] == (
        2, 32)
    assert K.general_rec_plan(256, 256, BF16, {2: 66, 4: 33, 8: 16})[:2] == (
        4, 64)


def test_general_bwd_launch_picks_the_path_by_shape(monkeypatch):
    """``_general_bwd_launch`` decides K3's path from the plan alone, before
    any launch: the cluster library with the plan's N, R, passes and row
    groups (f32 at 256: 3) where the plan takes the shape, ``lstm_general.cu``'s K3 where it refuses
    it; a launch that returns an error raises (``_raise_on``), with no
    second try on the other path."""
    calls = []

    class Fake:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, fn):
            def call(*args):
                calls.append((self.name, fn, args))
                return 7
            return call

    monkeypatch.setattr(K, "_general_rec_library", lambda: Fake("cluster"))
    monkeypatch.setattr(K, "_general_library", lambda: Fake("stream"))
    monkeypatch.setattr(K, "cluster_capacity",
                        lambda index: K.H100_CLUSTERS)
    for dtype, C, H, want in ((BF16, 160, 160, "cluster"),
                              (BF16, 256, 256, "cluster"),
                              (F32, 160, 160, "cluster"),
                              (F32, 256, 256, "cluster"),
                              (F32, 512, 512, "stream"),
                              (BF16, 1024, 1024, "stream")):
        calls.clear()
        run, _chunks, _error_string, path = K._general_bwd_launch(
            dtype, C, H, torch.device("cpu"))
        assert path == want
        err = run(int(dtype == BF16), *range(1, 13), 2, 3, C, H, 0)
        assert [c[0] for c in calls] == [want]
        if want == "cluster":
            N, R, _, P, groups = K.general_rec_plan(C, H, dtype)
            assert calls[0][1] == "lstm_general_rec_cluster_bwd"
            assert calls[0][2][-5:] == (N, R, P, groups, 0)
            assert calls[0][2][13:17] == (2, 3, C, H)
        else:
            assert calls[0][1] == "lstm_general_bwd"
            assert calls[0][2][-5:] == (2, 3, C, H, 0)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            K._raise_on(lambda e: b"refused", "lstm_bwd", err)
    assert set(K.LAUNCHES_GENERAL_BWD) == {"cluster", "stream"}


def test_general_recurrence_on_the_cpu_is_the_plain_twin():
    """On CPU tensors ``general_recurrence`` is
    ``lstm_bwd_recurrence_reference`` (what the card's kernels are held to)
    and launches nothing; the twin takes the dgates rounded to the dtype
    into the dh carry."""
    T, B, C, H = 3, 5, 130, 136
    rng = np.random.default_rng(0)
    for dtype in (F32, BF16):
        z = torch.from_numpy(rng.normal(size=(T, B, 4 * H)).astype(
            np.float32))
        cs, dhs = (torch.from_numpy(rng.normal(size=(T, B, H)).astype(
            np.float32)).to(dtype) for _ in range(2))
        w_aug = torch.from_numpy((rng.normal(size=(C + H + 1, 4 * H))
                                  * 0.1).astype(np.float32)).to(dtype)
        before = dict(K.LAUNCHES_GENERAL_BWD)
        got = K.general_recurrence(z, cs, dhs, w_aug)
        assert K.LAUNCHES_GENERAL_BWD == before
        assert torch.equal(got, K.lstm_bwd_recurrence_reference(
            z, cs, dhs, w_aug))
        assert got.dtype == dtype and got.shape == (T, B, 4 * H)
