"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips where no CUDA device is present. On a
machine with a GPU and ``nvcc``:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import tb_row_case
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
    wide, xw = _case(2, 3, 64, 1025, torch.float32, cuda)
    with pytest.raises(ValueError, match="kernels take"):
        K.lstm_last(wide, xw)


def _w_aug(params):
    return K.make_w_aug(params, params["w_ih"].dtype)


# K1's and K2's bf16 leg, one tensor-core kernel (lstm_fwd_mma.cu), against
# the plain versions: the main path's batch, its last short batch and a
# batch under one 16-row tile; the main widths and H = 12, C = 100 (the
# element copies, zero-padded k tiles, masked units); one step and the
# training length. bf16 rounds h every step (one bf16 step is 2**-8).
@pytest.mark.parametrize("T", [1, 124])
@pytest.mark.parametrize("C,H", [(64, 64), (100, 12)])
@pytest.mark.parametrize("B", [2048, 1111, 7])
def test_lstm_fwd_mma_matches_plain(cuda, T, B, C, H):
    params, x = _case(T, B, C, H, torch.bfloat16, cuda)
    w_aug = _w_aug(params)
    launches = (K.LAUNCHES_FWD, K.LAUNCHES)
    with full_f32():
        hs, cs = K.lstm_fwd(x, w_aug)
        hs_nocs, none = K.lstm_fwd(x, w_aug, want_cs=False)
        last = K.lstm_last(params, x)
        hs_ref, cs_ref = K.lstm_fwd_reference(x, w_aug)
        last_ref = K.lstm_last_reference(params, x)
    torch.cuda.synchronize()
    assert (K.LAUNCHES_FWD, K.LAUNCHES) == (launches[0] + 2,
                                            launches[1] + 1)
    assert none is None and hs.shape == cs.shape == (T, B, H)
    assert hs.dtype == cs.dtype == last.dtype == torch.bfloat16
    assert last.shape == (B, H)
    assert torch.equal(hs_nocs, hs)
    assert torch.equal(last, hs[-1])
    for got, want in ((hs, hs_ref), (cs, cs_ref), (last, last_ref)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2, err


def test_lstm_fwd_mma_repeats_bit_for_bit(cuda):
    params, x = _case(31, 1111, 64, 64, torch.bfloat16, cuda)
    w_aug = _w_aug(params)
    first = K.lstm_fwd(x, w_aug), K.lstm_last(params, x)
    second = K.lstm_fwd(x, w_aug), K.lstm_last(params, x)
    torch.cuda.synchronize()
    for a, b in zip((*first[0], first[1]), (*second[0], second[1])):
        assert torch.equal(a, b)


def test_lstm_fwd_routes_by_dtype(cuda, monkeypatch):
    """bf16 K1/K2 load lstm_fwd_mma's library, f32 lstm_fwd_f32's (one
    kernel for both); each library's limits are the wrapper's."""
    from remora_tpu_torch.kernels import _build

    loaded = []
    load = _build.load

    def spy(name):
        loaded.append(name)
        return load(name)

    monkeypatch.setattr(_build, "load", spy)
    for dtype, want in ((torch.bfloat16, ["lstm_fwd_mma"] * 2),
                        (torch.float32, ["lstm_fwd_f32"] * 2)):
        params, x = _case(5, 24, 64, 64, dtype, cuda)
        loaded.clear()
        K.lstm_fwd(x, _w_aug(params))
        K.lstm_last(params, x)
        torch.cuda.synchronize()
        assert loaded == want
    lib = load("lstm_fwd_mma")
    assert (lib.lstm_fwd_mma_max_c(), lib.lstm_fwd_mma_max_h()) == (
        K.FWD_MMA_MAX_C, K.FWD_MMA_MAX_H)
    lib = load("lstm_fwd_f32")
    assert (lib.lstm_fwd_f32_max_c(), lib.lstm_fwd_f32_max_h()) == (
        K.F32_FWD_MAX_C, K.F32_FWD_MAX_H)


# K1's and K2's f32 leg (lstm_fwd_f32.cu) against the plain versions: the
# main shape (the main path's batch and its last short batch, T = 124) on
# the compile-time instantiation; the generic one at the main shape with x
# off 16-byte alignment (4-byte staging), at C = 128 (two 64-k chunks of
# W_x), at C and H off 4 and 16, and at T = 0 (K1 gives zeros). Each
# repeats bit for bit, hs is the same with and without cs, and K1's
# h_(T-1) is K2's last hs.
@pytest.mark.parametrize("T,B,C,H,offset", [
    (124, 2048, 64, 64, 0), (124, 1111, 64, 64, 0), (17, 40, 64, 64, 1),
    (6, 21, 128, 64, 0), (4, 17, 66, 61, 0), (0, 16, 64, 64, 0)])
def test_lstm_fwd_f32_matches_plain_and_repeats(cuda, T, B, C, H, offset):
    params, xc = _case(T, B, C, H, torch.float32, cuda)
    # a contiguous x at ``offset`` floats into its buffer
    x = torch.empty(xc.numel() + offset, device=cuda)[offset:].view(T, B, C)
    x.copy_(xc)
    w_aug = _w_aug(params)
    launches = (K.LAUNCHES_FWD, K.LAUNCHES)
    with full_f32():
        hs, cs = K.lstm_fwd(x, w_aug)
        hs_nocs, _ = K.lstm_fwd(x, w_aug, want_cs=False)
        last = K.lstm_last(params, x)
        again = K.lstm_fwd(x, w_aug), K.lstm_last(params, x)
        hs_ref, cs_ref = K.lstm_fwd_reference(x, w_aug)
    torch.cuda.synchronize()
    assert (K.LAUNCHES_FWD, K.LAUNCHES) == (launches[0] + 3,
                                            launches[1] + 2)
    assert torch.equal(again[0][0], hs) and torch.equal(again[0][1], cs)
    assert torch.equal(again[1], last) and torch.equal(hs_nocs, hs)
    if T == 0:
        assert torch.equal(last, torch.zeros((B, H), device=cuda))
        return
    assert torch.equal(last, hs[-1])
    for got, want in ((hs, hs_ref), (cs, cs_ref)):
        err = (got - want).abs().max().item()
        assert err <= 1e-5, err


# shapes above every kernel's limits (the bf16 kernel's refusals of H 65
# to 128 now go to lstm_wide.cu)
@pytest.mark.parametrize("C,H", [(1025, 64), (64, 1025), (16, 2000)])
def test_lstm_fwd_mma_refuses_shapes(cuda, C, H):
    params, x = _case(3, 16, C, H, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="no kernel takes"):
        K.lstm_fwd(x, _w_aug(params))
    with pytest.raises(ValueError, match="no kernel takes"):
        K.lstm_last(params, x)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


# K2/K3 against their plain versions at small, ragged shapes (batch not a
# multiple of the 16-row tile, H not a multiple of 16, C != H; for K3 f32's
# tiles also C + H off its 8- and 16-row k tiles, C and H off 4 (the
# 4-byte staging), one unit, and C + H = 128 at H = 32); f32 is held to
# full-f32 arithmetic, bf16 rounds h and dgates every step
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "T,B,C,H",
    [(1, 16, 64, 64), (13, 37, 64, 64), (24, 40, 24, 16), (9, 5, 100, 12),
     (5, 23, 13, 6), (3, 33, 1, 1), (4, 50, 96, 32)],
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


# K3 f32 at shapes the bf16 leg does not take (C + H > 128): the largest
# shared-memory layout (128, 44) and C = 128 at H = 32, ragged batches
@pytest.mark.parametrize("T,B,C,H", [(3, 21, 128, 44), (2, 35, 128, 32)])
def test_lstm_bwd_f32_wide_shapes_match_plain(cuda, T, B, C, H):
    x, w_aug, hs, cs, dhs = _bwd_inputs(T, B, C, H, torch.float32, cuda)
    with full_f32():
        dx, dw = K.lstm_bwd(x, w_aug, hs, cs, dhs)
        dx_ref, dw_ref = K.lstm_bwd_reference(x, w_aug, hs, cs, dhs)
    torch.cuda.synchronize()
    assert (dx - dx_ref).abs().max().item() <= 1e-5
    assert _rel(dw, dw_ref) <= 1e-4


def test_lstm_bwd_f32_routes_to_its_kernel(cuda, monkeypatch):
    """f32 K3 loads lstm_bwd_f32's library and launches once (no bf16
    part); the library's rule is ``bwd_f32_shape_error``'s, and a shape
    outside it raises with that message."""
    from remora_tpu_torch.kernels import _build

    loaded = []
    load = _build.load

    def spy(name):
        loaded.append(name)
        return load(name)

    x, w_aug, hs, cs, dhs = _bwd_inputs(6, 24, 64, 64, torch.float32, cuda)
    monkeypatch.setattr(_build, "load", spy)
    launches = K.LAUNCHES_BWD, dict(K.LAUNCHES_BWD_MMA)
    K.lstm_bwd(x, w_aug, hs, cs, dhs)
    torch.cuda.synchronize()
    assert loaded == ["lstm_bwd_f32"]
    assert K.LAUNCHES_BWD == launches[0] + 1
    assert K.LAUNCHES_BWD_MMA == launches[1]
    lib = load("lstm_bwd_f32")
    for C in (1, 13, 64, 100, 120, 128, 129):
        for H in (1, 12, 44, 45, 60, 64, 65):
            assert bool(lib.lstm_bwd_f32_fits(C, H)) == (
                K.bwd_f32_shape_error(C, H) is None), (C, H)
    # above every kernel's limits ((128, 64), which this kernel refuses,
    # runs lstm_wide.cu, and (129, 64) lstm_general.cu)
    params, x = _case(3, 16, 1025, 64, torch.float32, cuda)
    hs = torch.zeros((3, 16, 64), device=cuda)
    with pytest.raises(ValueError, match="no kernel takes"):
        K.lstm_bwd(x, _w_aug(params), hs, hs, hs)
    assert K.LAUNCHES_BWD == launches[0] + 1


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


# the wide legs (lstm_wide.cu, K3 lstm_wide_bwd.cu) against their plain
# versions at the sizes the main-shape kernels refuse: ConvLSTM_w_ref at 96
# and 128, and C != H; ragged batches (not a multiple of the clusters' 32
# rows or the 128-row product tile, fewer rows than one cluster, one row)
# and one step; at the cluster split's edges, H whose second CTA holds
# fewer units (65, 97, 113, 127), H off 8 and 16 (90, 100), C = 1, C odd and
# C, H off the 16-byte staging; today's tolerances
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,B,C,H", [(7, 37, 96, 96), (5, 133, 128, 128),
                                     (1, 5, 128, 100), (9, 21, 128, 100),
                                     (5, 17, 1, 65), (1, 33, 96, 97),
                                     (6, 33, 128, 127), (3, 64, 7, 127),
                                     (2, 31, 33, 90), (4, 65, 126, 113),
                                     (3, 32, 120, 66), (2, 1, 128, 128)])
def test_lstm_wide_legs_match_plain(cuda, T, B, C, H, dtype, tol):
    params, x = _case(T, B, C, H, dtype, cuda)
    w_aug = _w_aug(params)
    dhs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(T, B, H)).astype(np.float32)).to(cuda, dtype)
    launches = dict(K.LAUNCHES_WIDE)
    with full_f32():
        last = K.lstm_last(params, x)
        last_ref = K.lstm_last_reference(params, x)
        hs, cs = K.lstm_fwd(x, w_aug)
        hs_ref, cs_ref = K.lstm_fwd_reference(x, w_aug)
        hs_nocs, _ = K.lstm_fwd(x, w_aug, want_cs=False)
        dx, dw = K.lstm_bwd(x, w_aug, hs, cs, dhs)
        dx_ref, dw_ref = K.lstm_bwd_reference(x, w_aug, hs, cs, dhs)
        again = (K.lstm_last(params, x), *K.lstm_fwd(x, w_aug),
                 *K.lstm_bwd(x, w_aug, hs, cs, dhs))
    torch.cuda.synchronize()
    assert K.LAUNCHES_WIDE == {"last": launches["last"] + 2,
                               "fwd": launches["fwd"] + 3,
                               "bwd": launches["bwd"] + 2}
    assert last.dtype == hs.dtype == cs.dtype == dx.dtype == dtype
    assert dw.dtype == torch.float32 and dw.shape == (C + H + 1, 4 * H)
    assert torch.equal(hs_nocs, hs)
    for got, want in ((last, last_ref), (hs, hs_ref), (cs, cs_ref),
                      (dx, dx_ref)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, err
    assert _rel(dw, dw_ref) <= (1e-4 if dtype == torch.float32 else tol)
    for a, b in zip(again, (last, hs, cs, dx, dw)):
        assert torch.equal(a, b)


# K3 alone at wide shapes whose forward is a main-shape kernel's (H <= 64:
# the recurrence's smaller unit classes), both dtypes, ragged batches; a
# repeated call repeats the bits
@pytest.mark.parametrize("dtype,T,B,C,H", [
    (torch.float32, 3, 21, 128, 48), (torch.float32, 4, 45, 104, 52),
    (torch.float32, 2, 19, 65, 64),
    (torch.bfloat16, 3, 17, 128, 8), (torch.bfloat16, 2, 33, 100, 40),
    (torch.bfloat16, 5, 40, 72, 64), (torch.bfloat16, 1, 7, 127, 3)])
def test_lstm_wide_bwd_small_units_match_plain(cuda, dtype, T, B, C, H):
    assert K.route("bwd", dtype, C, H) == "wide"
    x, w_aug, hs, cs, dhs = _bwd_inputs(T, B, C, H, dtype, cuda)
    launches = K.LAUNCHES_WIDE["bwd"]
    with full_f32():
        dx, dw = K.lstm_bwd(x, w_aug, hs, cs, dhs)
        dx_ref, dw_ref = K.lstm_bwd_reference(x, w_aug, hs, cs, dhs)
        again = K.lstm_bwd(x, w_aug, hs, cs, dhs)
    torch.cuda.synchronize()
    assert K.LAUNCHES_WIDE["bwd"] == launches + 2
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (dx.float() - dx_ref.float()).abs().max().item() <= tol
    assert _rel(dw, dw_ref) <= (1e-4 if dtype == torch.float32 else tol)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


def test_lstm_libraries_match_the_shape_rule(cuda):
    """The limits behind ``route`` are the kernels': lstm_wide.cu refuses a
    launch past WIDE_MAX_C/H before it reads a pointer and splits the units
    as ``wide_fwd_units`` says; lstm_general.cu's maxima are
    GENERAL_MAX_C/H, past which ``route`` raises and the library refuses a
    launch of any leg before it reads a pointer; and the f32 forwards' and
    the bf16 backward's maxima are the main-shape rule's."""
    from remora_tpu_torch.kernels import _build

    K.lstm_last(*_case(2, 3, 96, 96, torch.float32, cuda))
    wide = _build.load("lstm_wide")
    for C, H in ((K.WIDE_MAX_C + 1, 8), (8, K.WIDE_MAX_H + 1), (0, 8)):
        assert wide.lstm_wide_fwd(0, *[None] * 5, 1, 1, C, H, None) != 0
    # the wide forward's split of the units, which its f32 weight layout
    # (wide_fwd_weights) follows
    for H in range(1, K.WIDE_MAX_H + 1):
        assert wide.lstm_wide_fwd_units(H) == K.wide_fwd_units(H)
    K.lstm_last(*_case(2, 3, 160, 160, torch.float32, cuda))
    general = K._general_library()
    assert (general.lstm_general_max_c(), general.lstm_general_max_h()) == (
        K.GENERAL_MAX_C, K.GENERAL_MAX_H)
    for C, H in ((K.GENERAL_MAX_C + 1, 8), (8, K.GENERAL_MAX_H + 1), (0, 8),
                 (8, 0)):
        assert K.shape_error("lstm_fwd", C, H) is not None
        for bf16 in (0, 1):
            assert general.lstm_general_fwd(
                bf16, *[None] * 4, 1, 1, C, H, None) != 0
            assert general.lstm_general_last(
                bf16, *[None] * 3, 1, 1, C, H, None) != 0
            assert general.lstm_general_bwd(
                bf16, *[None] * 12, 1, 1, C, H, None) != 0
    for C, H in ((K.WIDE_MAX_C + 1, 8), (8, K.WIDE_MAX_H + 1),
                 (K.GENERAL_MAX_C, K.GENERAL_MAX_H)):
        assert K.shape_error("lstm_fwd", C, H) is None
        assert K.route("fwd", torch.float32, C, H) == "general"
    f32 = _build.load("lstm_fwd_f32")
    assert (f32.lstm_fwd_f32_max_c(), f32.lstm_fwd_f32_max_h()) == (
        K.F32_FWD_MAX_C, K.F32_FWD_MAX_H)
    mma = _build.load("lstm_bwd_mma")
    assert (mma.lstm_bwd_mma_max_h(), mma.lstm_bwd_mma_max_k()) == (
        K.BWD_MMA_MAX_H, K.BWD_MMA_MAX_K)


# the general leg (lstm_general.cu: K1, K2 with and without cs, K3; K1/K2
# on lstm_general_cluster.cu where general_fwd_plan takes the shape) against
# the plain versions at C or H past 128: the model's sizes 160 and 256, C !=
# H, C = 1 and H = 129 (one unit past a block's 128 slots), C and H off the
# products' 16-byte staging (bf16: off 8; the cluster kernels' x staging:
# C = 161, 257, 193), H odd (unpaired stores; 199 on the f32 W_h-ring
# path, whose last W_h chunk is k8 there), a batch off and below a block's
# 8 rows and a cluster's R, one row, more rows than one wave of clusters
# (2100; 2200 on the W_h-ring path at 256: 16 clusters of 144), T = 1,
# and the limit 1024; today's tolerances, a repeated call repeats the
# bits, and each K1/K2 launch takes the plan's path
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,B,C,H", [(5, 37, 160, 160), (3, 16, 256, 256),
                                     (4, 9, 144, 200), (3, 5, 1, 129),
                                     (2, 13, 257, 131), (1, 3, 129, 1),
                                     (3, 20, 130, 200), (2, 3, 1024, 1024),
                                     (4, 70, 161, 160), (3, 1, 160, 133),
                                     (2, 2100, 160, 160),
                                     (2, 2200, 256, 256),
                                     (3, 37, 193, 199)])
def test_lstm_general_legs_match_plain(cuda, T, B, C, H, dtype, tol):
    assert K.route("bwd", dtype, C, H) == "general"
    path = K.general_fwd_path(dtype, C, H,
                              K.cluster_capacity(cuda.index or 0))
    params, x = _case(T, B, C, H, dtype, cuda)
    w_aug = _w_aug(params)
    dhs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(T, B, H)).astype(np.float32)).to(cuda, dtype)
    launches = dict(K.LAUNCHES_GENERAL)
    paths = dict(K.LAUNCHES_GENERAL_FWD)
    bwd_paths = dict(K.LAUNCHES_GENERAL_BWD)
    with full_f32():
        last = K.lstm_last(params, x)
        last_ref = K.lstm_last_reference(params, x)
        hs, cs = K.lstm_fwd(x, w_aug)
        hs_ref, cs_ref = K.lstm_fwd_reference(x, w_aug)
        hs_nocs, _ = K.lstm_fwd(x, w_aug, want_cs=False)
        dx, dw = K.lstm_bwd(x, w_aug, hs, cs, dhs)
        dx_ref, dw_ref = K.lstm_bwd_reference(x, w_aug, hs, cs, dhs)
        again = (K.lstm_last(params, x), *K.lstm_fwd(x, w_aug),
                 *K.lstm_bwd(x, w_aug, hs, cs, dhs))
    torch.cuda.synchronize()
    assert K.LAUNCHES_GENERAL == {"last": launches["last"] + 2,
                                  "fwd": launches["fwd"] + 3,
                                  "bwd": launches["bwd"] + 2}
    paths[path] += 5
    assert K.LAUNCHES_GENERAL_FWD == paths
    bwd_paths[K.general_bwd_path(dtype, C, H,
                                 K.cluster_capacity(cuda.index or 0))] += 2
    assert K.LAUNCHES_GENERAL_BWD == bwd_paths
    assert last.dtype == hs.dtype == cs.dtype == dx.dtype == dtype
    assert dw.dtype == torch.float32 and dw.shape == (C + H + 1, 4 * H)
    assert torch.equal(hs_nocs, hs)
    for got, want in ((last, last_ref), (hs, hs_ref), (cs, cs_ref),
                      (dx, dx_ref)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, err
    assert _rel(dw, dw_ref) <= (1e-4 if dtype == torch.float32 else tol)
    for a, b in zip(again, (last, hs, cs, dx, dw)):
        assert torch.equal(a, b)


def test_lstm_general_cluster_library_matches_the_plan(cuda):
    """lstm_general_cluster.cu's launch shapes are ``general_fwd_cfg``'s;
    it refuses a cluster size, a row count or a shape outside its budget
    before it reads a pointer (the f32 W_h-ring path's included: rows in
    48s, its own entry); the card holds the clusters ``H100_CLUSTERS`` says (on an H100
    80GB HBM3), and the plan's clusters at 160 and 256 run in one wave
    (f32 at 256 on the W_h-ring path); K1 at T = 0 is h_{-1} = 0 on the
    cluster paths."""
    import ctypes

    lib = K._cluster_library()
    info = (ctypes.c_longlong * 8)()
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = int(dtype == torch.bfloat16)
        for C, H in ((160, 160), (256, 256), (144, 200), (1, 129),
                     (129, 1), (257, 131), (1024, 1024), (193, 199),
                     (257, 257)):
            for N, R in ((2, 32), (4, 64), (8, 128), (4, 96), (8, 160),
                         (8, 144), (4, 48), (8, 192)):
                cfg = K.general_fwd_cfg(C, H, dtype, N, R)
                rc = lib.lstm_general_cluster_cfg(bf16, C, H, N, R, info)
                # each entry refuses what is not its own before it reads
                # a pointer: the W_h-ring kernel's shapes are
                # lstm_general_ring_fwd's (f32 alone), the rest the other's
                if cfg is None or cfg["ring"]:
                    assert lib.lstm_general_cluster_fwd(
                        bf16, *[None] * 5, 1, 1, C, H, N, R, None) != 0
                if not bf16 and (cfg is None or not cfg["ring"]):
                    assert lib.lstm_general_ring_fwd(
                        *[None] * 7, 1, 1, C, H, N, R, 3, None) != 0
                if cfg is None:
                    assert rc == -1, (dtype, C, H, N, R)
                    continue
                assert rc == 0 and list(info) == [
                    cfg["hh"], cfg["ub"], cfg["threads"], cfg["slots"],
                    int(cfg["resident"]), cfg["smem"], cfg["layout"],
                    int(cfg["ring"])]
        for bad in ((3, 64), (16, 256), (4, 40), (4, 16)):
            assert lib.lstm_general_cluster_cfg(bf16, 160, 160, *bad,
                                                info) == -1
        assert lib.lstm_general_cluster_cfg(bf16, 160, 160, 4, 48,
                                            info) == -bf16
    # the card's cluster capacity is the table the CPU tests plan with
    caps = K.cluster_capacity(cuda.index or 0)
    if torch.cuda.get_device_properties(cuda).name == "NVIDIA H100 80GB HBM3":
        assert caps == K.H100_CLUSTERS, caps
    for dtype, C in ((torch.bfloat16, 160), (torch.bfloat16, 256),
                     (torch.float32, 160), (torch.float32, 256)):
        N, R, _ = K.general_fwd_plan(C, C, dtype, caps)
        assert -(-K.GENERAL_FWD_PLAN_BATCH // R) <= caps[N], (dtype, C)
        assert K.general_fwd_cfg(C, C, dtype, N, R)["ring"] == (
            dtype == torch.float32 and C == 256)
    for dtype, C in ((torch.bfloat16, 160), (torch.float32, 256)):
        params, x = _case(0, 5, C, C, dtype, cuda)
        assert not K.lstm_last(params, x).float().abs().max().item()


# the general K3's recurrence alone (``general_recurrence``) against its
# plain twin on the same Z: the cluster path at the model's sizes 160 (both
# dtypes) and 256 (bf16: two passes; f32: row groups), batches off a
# cluster's R rows and beyond one wave, H off the 8-unit tiles, T = 1; the
# streaming path where the plan refuses (f32 at 512); dgates within 1e-5
# (f32) or 2e-2 (bf16) of their largest entry, a repeated call identical,
# one launch a call on the plan's path
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,C,H", [(6, 37, 160, 160), (4, 100, 256, 256),
                                     (3, 161, 144, 200), (1, 9, 160, 160),
                                     (3, 2100, 160, 160), (5, 40, 129, 133),
                                     (3, 2200, 256, 256), (1, 50, 240, 240),
                                     (2, 20, 512, 512)])
def test_general_recurrence_matches_twin(cuda, T, B, C, H, dtype):
    params, x = _case(T, B, C, H, dtype, cuda, seed=H)
    w_aug = _w_aug(params)
    rng = np.random.default_rng(T + B)
    dhs = torch.from_numpy(rng.normal(size=(T, B, H)).astype(
        np.float32)).to(cuda, dtype)
    path = K.general_bwd_path(dtype, C, H,
                              K.cluster_capacity(cuda.index or 0))
    if (C, H) in ((160, 160), (256, 256)):
        assert path == "cluster"
    if H == 512:
        assert path == "stream"
    paths = dict(K.LAUNCHES_GENERAL_BWD)
    with full_f32():
        hs, cs = K.lstm_fwd_reference(x, w_aug)
        z = K.lstm_bwd_gates_reference(x, w_aug, hs)
        got = K.general_recurrence(z, cs, dhs, w_aug)
        want = K.lstm_bwd_recurrence_reference(z, cs, dhs, w_aug)
        again = K.general_recurrence(z, cs, dhs, w_aug)
    torch.cuda.synchronize()
    paths[path] += 2
    assert K.LAUNCHES_GENERAL_BWD == paths
    assert got.dtype == dtype and got.shape == (T, B, 4 * H)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert _rel(got, want) <= tol, _rel(got, want)
    assert torch.equal(again, got)


def test_general_rec_cluster_library_matches_the_plan(cuda):
    """lstm_general_rec_cluster.cu's launch shapes are
    ``general_rec_cfg``'s, the row-group path's included; it refuses a
    cluster size, row count, pass count, group count, shape outside its
    budget or batch past its 32-bit offsets before it reads a pointer; the
    plan's clusters at 160 and 256 run in one wave."""
    import ctypes

    lib = K._general_rec_library()
    info = (ctypes.c_longlong * 6)()
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = int(dtype == torch.bfloat16)
        for H in (1, 8, 129, 160, 200, 256, 257, 300, 1024):
            for N, R, G in ((2, 32, 1), (4, 96, 1), (8, 160, 1), (4, 64, 1),
                            (8, 96, 2), (8, 144, 3), (8, 192, 4),
                            (8, 160, 3), (4, 144, 3), (8, 48, 1)):
                for P in (1, 2, 3, 4):
                    cfg = K.general_rec_cfg(H, dtype, N, R, P, G)
                    rc = lib.lstm_general_rec_cluster_cfg(bf16, H, N, R, P,
                                                          G, info)
                    if cfg is None:
                        assert rc == -1, (dtype, H, N, R, P, G)
                        assert lib.lstm_general_rec_cluster_rec(
                            bf16, *[None] * 5, 1, 1, H, N, R, P, G,
                            None) != 0
                        continue
                    assert rc == 0 and list(info) == [
                        cfg["hh"], cfg["pairs"], cfg["threads"], cfg["smem"],
                        cfg["hc"], cfg["nct"]], (dtype, H, N, R, P, G)
        for bad in ((3, 64, 1, 1), (16, 256, 1, 1), (4, 48, 1, 1),
                    (4, 96, 0, 1), (4, 96, 9, 1), (4, 96, 1, 0),
                    (8, 144, 2, 3)):
            assert lib.lstm_general_rec_cluster_cfg(bf16, 160, *bad,
                                                    info) == -1
        assert lib.lstm_general_rec_cluster_bwd(
            bf16, *[None] * 12, 1, 1, 1025, 160, 4, 96, 1, 1, None) != 0
        # a batch whose (B + R) 4H offsets pass 2^32
        assert lib.lstm_general_rec_cluster_rec(
            bf16, *[None] * 5, 1, 2 ** 30, 160, 4, 96, 1, 1, None) != 0
    assert lib.lstm_general_rec_cluster_rec(
        0, *[None] * 5, 1, 2 ** 22, 256, 8, 144, 1, 3, None) != 0
    caps = K.cluster_capacity(cuda.index or 0)
    for dtype, C in ((torch.bfloat16, 160), (torch.bfloat16, 256),
                     (torch.float32, 160), (torch.float32, 256)):
        N, R = K.general_rec_plan(C, C, dtype, caps)[:2]
        assert -(-K.GENERAL_FWD_PLAN_BATCH // R) <= caps[N], (dtype, C)


def test_lstm_fused_autograd_general_on_card(cuda):
    """LSTMFused at C = H = 160 (K2 and K3 on lstm_general.cu) against
    autograd through the plain scan, f32 on the card."""
    params, x = _case(7, 19, 160, 160, torch.float32, cuda)
    probe = torch.from_numpy(np.random.default_rng(2).normal(
        size=(7, 19, 160)).astype(np.float32)).to(cuda)
    grads = []
    launches = dict(K.LAUNCHES_GENERAL)
    with full_f32():
        for impl in ("fused", "scan"):
            p = {k: v.clone().requires_grad_() for k, v in params.items()}
            xx = x.clone().requires_grad_()
            hs = K.L.lstm(p, xx, impl=impl)
            (hs * probe).sum().backward()
            grads.append([xx.grad] + [p[k].grad for k in sorted(p)])
    assert K.LAUNCHES_GENERAL["fwd"] == launches["fwd"] + 1
    assert K.LAUNCHES_GENERAL["bwd"] == launches["bwd"] + 1
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-4


def test_lstm_fused_autograd_wide_on_card(cuda):
    """LSTMFused at C = H = 96 (K2 and K3 on lstm_wide.cu) against
    autograd through the plain scan, f32 on the card."""
    params, x = _case(11, 19, 96, 96, torch.float32, cuda)
    probe = torch.from_numpy(np.random.default_rng(2).normal(
        size=(11, 19, 96)).astype(np.float32)).to(cuda)
    grads = []
    launches = dict(K.LAUNCHES_WIDE)
    with full_f32():
        for impl in ("fused", "scan"):
            p = {k: v.clone().requires_grad_() for k, v in params.items()}
            xx = x.clone().requires_grad_()
            hs = K.L.lstm(p, xx, impl=impl)
            (hs * probe).sum().backward()
            grads.append([xx.grad] + [p[k].grad for k in sorted(p)])
    assert K.LAUNCHES_WIDE["fwd"] == launches["fwd"] + 1
    assert K.LAUNCHES_WIDE["bwd"] == launches["bwd"] + 1
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-4


def test_lstm_train_kernels_refuse_bad_inputs(cuda):
    params, x = _case(5, 16, 64, 64, torch.float32, cuda)
    w_aug = _w_aug(params)
    with pytest.raises(ValueError, match="contiguous"):
        K.lstm_fwd(x.transpose(0, 1).contiguous().transpose(0, 1), w_aug)
    with pytest.raises(ValueError, match="dtype"):
        K.lstm_fwd(x.double(), w_aug.double())
    wide, xw = _case(2, 3, 1025, 64, torch.float32, cuda)
    ww = _w_aug(wide)
    with pytest.raises(ValueError, match="kernels take"):
        K.lstm_fwd(xw, ww)
    hs = torch.zeros((2, 3, 64), device=cuda)
    with pytest.raises(ValueError, match="kernels take"):
        K.lstm_bwd(xw, ww, hs, hs, hs)


def _bwd_inputs(T, B, C, H, dtype, device):
    params, x = _case(T, B, C, H, dtype, device)
    w_aug = _w_aug(params)
    dhs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(T, B, H)).astype(np.float32)).to(device, dtype)
    hs, cs = K.lstm_fwd(x, w_aug)
    return x, w_aug, hs, cs, dhs


# K3's bf16 parts, each against its plain twin on the same inputs: the gates
# (f32 sums of the same bf16 products in another order), the recurrence
# (dgates rounded to bf16 once; the carries in f32, summed in another order)
# and the products (dx rounded once; dW the f32 sum of the same products)
@pytest.mark.parametrize(
    "T,B,C,H",
    [(1, 16, 64, 64), (13, 37, 64, 64), (24, 40, 24, 16), (9, 5, 100, 12)],
)
def test_lstm_bwd_mma_parts_match_plain(cuda, T, B, C, H):
    x, w_aug, hs, cs, dhs = _bwd_inputs(T, B, C, H, torch.bfloat16, cuda)
    launches = dict(K.LAUNCHES_BWD_MMA)
    with full_f32():
        z = K.lstm_bwd_gates(x, w_aug, hs)
        z_ref = K.lstm_bwd_gates_reference(x, w_aug, hs)
        dg = K.lstm_bwd_recurrence(z, cs, dhs, w_aug)
        dg_ref = K.lstm_bwd_recurrence_reference(z, cs, dhs, w_aug)
        dx, dw = K.lstm_bwd_products(x, hs, w_aug, dg)
        dx_ref, dw_ref = K.lstm_bwd_products_reference(x, hs, w_aug, dg)
    torch.cuda.synchronize()
    assert K.LAUNCHES_BWD_MMA == {k: n + 1 for k, n in launches.items()}
    assert z.dtype == torch.float32 and z.shape == (T, B, 4 * H)
    assert dg.dtype == torch.bfloat16 and dg.shape == (T, B, 4 * H)
    assert _rel(z, z_ref) <= 1e-4
    assert _rel(dg, dg_ref) <= 2e-2
    assert (dx.float() - dx_ref.float()).abs().max().item() <= 2e-2
    assert _rel(dw, dw_ref) <= 1e-4


def test_lstm_bwd_routes_by_dtype(cuda):
    """bf16 goes to the tensor-core parts, f32 to lstm_bwd_f32.cu's kernel;
    a part refuses f32 and a shape it does not take, which ``lstm_bwd``
    sends to lstm_wide_bwd.cu instead."""
    for dtype, parts in ((torch.bfloat16, 1), (torch.float32, 0)):
        x, w_aug, hs, cs, dhs = _bwd_inputs(9, 24, 64, 64, dtype, cuda)
        launches = dict(K.LAUNCHES_BWD_MMA), K.LAUNCHES_BWD
        K.lstm_bwd(x, w_aug, hs, cs, dhs)
        torch.cuda.synchronize()
        assert K.LAUNCHES_BWD == launches[1] + 1
        assert K.LAUNCHES_BWD_MMA == {k: n + parts
                                      for k, n in launches[0].items()}
    with pytest.raises(ValueError, match="take bf16"):
        K.lstm_bwd_gates(x, w_aug, hs)
    x, w_aug, hs, cs, dhs = _bwd_inputs(3, 16, 72, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="kernel takes"):
        K.lstm_bwd_gates(x, w_aug, hs)
    launches = dict(K.LAUNCHES_BWD_MMA), K.LAUNCHES_WIDE["bwd"]
    K.lstm_bwd(x, w_aug, hs, cs, dhs)
    torch.cuda.synchronize()
    assert (K.LAUNCHES_BWD_MMA, K.LAUNCHES_WIDE["bwd"]) == (
        launches[0], launches[1] + 1)


def test_lstm_bwd_bf16_repeats_bit_for_bit(cuda):
    """K3's bf16 parts sum dW's chunk partials in chunk order and the
    recurrence's warp partials in warp order (no atomics): two runs on the
    same inputs give the same bits."""
    x, w_aug, hs, cs, dhs = _bwd_inputs(31, 96, 64, 64, torch.bfloat16, cuda)
    first = K.lstm_bwd(x, w_aug, hs, cs, dhs)
    second = K.lstm_bwd(x, w_aug, hs, cs, dhs)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ---------------- K4 / K5: the banded refinement DP ----------------


def _dp_case(seed, lengths, stall=False, stall_len=220, narrow=False):
    """Reads of ``lengths`` bases (one with a ``stall_len``-sample stall
    when ``stall``), bands as the refiner builds them, or when ``narrow``
    bases of 2 or 3 samples in bands of the base's samples +- 2 (widths 4
    to 8); (reads, sdp, bucket)."""
    from remora_tpu_torch.refine import band
    from remora_tpu_torch.refine.refiner import DEFAULT_REFINE_SHORT_DWELL_PEN

    rng = np.random.default_rng(seed)
    reads = []
    for k, n in enumerate(lengths):
        spb = rng.integers(2, 4, n) if narrow else rng.integers(1, 12, n)
        if stall and k == 1:
            spb[n // 2] = stall_len
        bps = np.concatenate([[0], np.cumsum(spb)]).astype(np.int64)
        levels = rng.normal(size=n).astype(np.float32)
        signal = rng.normal(size=int(bps[-1])).astype(np.float32)
        if narrow:
            seq_band = np.clip(np.stack([bps[:-1] - 2, bps[1:] + 2]), 0,
                               bps[-1])
        else:
            seq_band = band.convert_to_seq_band(
                band.compute_sig_band(bps, levels, bhw=5))
        band.adjust_seq_band(seq_band)
        reads.append((signal, levels, seq_band))
    w = max(16, max(int((b[1] - b[0]).max()) for _s, _l, b in reads))
    sdp = np.asarray(DEFAULT_REFINE_SHORT_DWELL_PEN, np.float32)
    return reads, sdp, 1 << (w - 1).bit_length()


def _dp_inputs(reads, w_max, device):
    from remora_tpu_torch.kernels import banded_dp as DP

    packed = DP.pad_reads_for_dp(reads, w_max=w_max)
    return [torch.from_numpy(packed[k]).to(device)
            for k in ("signal", "levels", "band_starts", "band_widths",
                      "seq_lens")]


# ragged launches: one read, reads of very different lengths, a launch
# whose band widths differ 4x (a stall), and widths that are not a
# multiple of the block's 128 threads
@pytest.mark.parametrize("algo", ["Viterbi", "dwell_penalty"])
@pytest.mark.parametrize("lengths,stall", [
    ((37,), False), ((5, 300, 61, 1 + 128), False), ((40, 50, 30), True),
])
def test_banded_dp_kernels_match_plain_and_native(cuda, algo, lengths,
                                                  stall):
    from remora_tpu_torch.io.native import banded_dp_path
    from remora_tpu_torch.kernels import banded_dp as DP

    reads, sdp_np, w_max = _dp_case(len(lengths), lengths, stall)
    sig, lvl, st, wd, sl = _dp_inputs(reads, w_max, cuda)
    sdp = torch.from_numpy(sdp_np).to(cuda)
    dwell = algo == "dwell_penalty"
    W = DP.launch_width(w_max)
    launches = (DP.LAUNCHES_FWD, DP.LAUNCHES_TB)
    tb = DP.dp_forward(sig, lvl, st, wd, sdp, dwell, W)
    path = DP.dp_traceback(tb, st, wd, sl)
    torch.cuda.synchronize()
    assert (DP.LAUNCHES_FWD, DP.LAUNCHES_TB) == (launches[0] + 1,
                                                 launches[1] + 1)
    tb_ref = DP.dp_forward_reference(sig, lvl, st, wd, sdp, dwell, W)
    assert torch.equal(tb, tb_ref)
    assert torch.equal(path, DP.dp_traceback_reference(tb_ref, st, wd, sl))
    got = path.cpu().numpy()
    for r, (signal, levels, seq_band) in enumerate(reads):
        want = banded_dp_path(signal, levels, seq_band, sdp_np, algo)
        assert np.array_equal(got[r, : levels.size + 1], want)


# the launch widths at the kernel's limits: W = 8 (narrow bands, the warp
# path's smallest instantiation) and W = 4096 (a 3500-sample stall, the
# block path at REFINE_DEVICE_MAX_BAND); held to the plain versions and
# the native host DP
@pytest.mark.parametrize("algo", ["Viterbi", "dwell_penalty"])
@pytest.mark.parametrize("W,case", [
    (8, dict(lengths=(60, 45, 70), narrow=True)),
    (4096, dict(lengths=(20, 24), stall=True, stall_len=3500)),
])
def test_banded_dp_kernels_at_the_band_limits(cuda, algo, W, case):
    from remora_tpu_torch.io.native import banded_dp_path
    from remora_tpu_torch.kernels import banded_dp as DP

    reads, sdp_np, _ = _dp_case(W, **case)
    w_max = max(int((b[1] - b[0]).max()) for _s, _l, b in reads)
    assert (DP.launch_width(w_max) == W if W == 8
            else 2048 < w_max <= W)
    sig, lvl, st, wd, sl = _dp_inputs(reads, w_max, cuda)
    sdp = torch.from_numpy(sdp_np).to(cuda)
    dwell = algo == "dwell_penalty"
    tb = DP.dp_forward(sig, lvl, st, wd, sdp, dwell, W)
    path = DP.dp_traceback(tb, st, wd, sl)
    torch.cuda.synchronize()
    tb_ref = DP.dp_forward_reference(sig, lvl, st, wd, sdp, dwell, W)
    assert torch.equal(tb, tb_ref)
    assert torch.equal(path, DP.dp_traceback_reference(tb_ref, st, wd, sl))
    got = path.cpu().numpy()
    for r, (signal, levels, seq_band) in enumerate(reads):
        want = banded_dp_path(signal, levels, seq_band, sdp_np, algo)
        assert np.array_equal(got[r, : levels.size + 1], want)


# a NaN signal sample and a NaN level: the staged path (W <= 128) folds
# such a base with the strict-< select, so both paths keep the plain
# version's tb and path (the native host DP differs on such inputs)
@pytest.mark.parametrize("algo", ["Viterbi", "dwell_penalty"])
@pytest.mark.parametrize("lengths,stall", [((60, 80, 50), False),
                                           ((40, 50, 30), True)])
def test_banded_dp_kernels_follow_the_plain_version_on_nan(cuda, algo,
                                                           lengths, stall):
    from remora_tpu_torch.kernels import banded_dp as DP

    reads, sdp_np, w_max = _dp_case(7, lengths, stall)
    reads[1][0][100] = np.nan
    reads[2][1][10] = np.nan
    sig, lvl, st, wd, sl = _dp_inputs(reads, w_max, cuda)
    sdp = torch.from_numpy(sdp_np).to(cuda)
    dwell = algo == "dwell_penalty"
    W = DP.launch_width(w_max)
    assert (W <= 128) != stall
    tb = DP.dp_forward(sig, lvl, st, wd, sdp, dwell, W)
    path = DP.dp_traceback(tb, st, wd, sl)
    torch.cuda.synchronize()
    tb_ref = DP.dp_forward_reference(sig, lvl, st, wd, sdp, dwell, W)
    assert torch.equal(tb, tb_ref)
    assert torch.equal(path, DP.dp_traceback_reference(tb_ref, st, wd, sl))


def test_banded_dp_kernels_repeat_bit_for_bit(cuda):
    from remora_tpu_torch.kernels import banded_dp as DP

    reads, sdp_np, w_max = _dp_case(5, (200, 150, 90, 260))
    sig, lvl, st, wd, sl = _dp_inputs(reads, w_max, cuda)
    sdp = torch.from_numpy(sdp_np).to(cuda)
    runs = [DP.banded_dp_batch(sig, lvl, st, wd, sl, sdp, w_max=w_max)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_banded_dp_kernels_refuse_bad_inputs(cuda):
    from remora_tpu_torch import RemoraError
    from remora_tpu_torch.kernels import banded_dp as DP

    reads, sdp_np, w_max = _dp_case(6, (30, 40))
    sig, lvl, st, wd, sl = _dp_inputs(reads, w_max, cuda)
    sdp = torch.from_numpy(sdp_np).to(cuda)
    with pytest.raises(RemoraError, match="device DP limit"):
        DP.dp_forward(sig, lvl, st, wd, sdp, True, 4104)
    with pytest.raises(RemoraError, match="contiguous"):
        DP.dp_forward(sig.double(), lvl, st, wd, sdp, True, w_max)
    with pytest.raises(RemoraError, match="is on cpu"):
        DP.dp_forward(sig, lvl.cpu(), st, wd, sdp, True, w_max)
    with pytest.raises(RemoraError, match="launch width"):
        DP.banded_dp_batch(sig, lvl, st, wd, sl, sdp, w_max=8)


# K5 on rows no DP wrote, bit for bit: the ring's shapes at W = 8 (8
# stages of 256 rows), 128 (3 of 128) and 4096 (3 of 4), walks that wrap
# the ring and end on a partial chunk, and reads of 1 and N bases
@pytest.mark.parametrize("kind", ["codes", "wild"])
@pytest.mark.parametrize("W,R,N", [(8, 6, 2301), (128, 6, 601),
                                   (4096, 3, 23)])
def test_dp_traceback_kernel_on_arbitrary_rows(cuda, W, R, N, kind):
    from remora_tpu_torch.kernels import banded_dp as DP

    tb, st, wd, sl = tb_row_case(W + N, R, N, W, kind, cuda)
    launches = DP.LAUNCHES_TB
    path = DP.dp_traceback(tb, st, wd, sl)
    torch.cuda.synchronize()
    assert DP.LAUNCHES_TB == launches + 1
    assert torch.equal(path, DP.dp_traceback_reference(tb, st, wd, sl))


def test_dp_traceback_kernel_more_reads_than_sms(cuda):
    from remora_tpu_torch.kernels import banded_dp as DP

    tb, st, wd, sl = tb_row_case(3, 300, 50, 128, "codes", cuda)
    assert 300 > torch.cuda.get_device_properties(cuda).multi_processor_count
    runs = [DP.dp_traceback(tb, st, wd, sl) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], DP.dp_traceback_reference(tb, st, wd, sl))
    assert torch.equal(runs[0], runs[1])


def test_dp_traceback_kernel_refuses_what_it_cannot_copy(cuda):
    from remora_tpu_torch import RemoraError
    from remora_tpu_torch.kernels import banded_dp as DP

    tb, st, wd, sl = tb_row_case(4, 2, 30, 16, "codes", cuda)
    launches = DP.LAUNCHES_TB
    buf = torch.zeros(tb.numel() + 8, dtype=torch.int16, device=cuda)
    shifted = buf[1:1 + tb.numel()].view(tb.shape)
    shifted.copy_(tb)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    with pytest.raises(RemoraError, match="16-byte boundary"):
        DP.dp_traceback(shifted, st, wd, sl)
    with pytest.raises(RemoraError, match="multiple of 8"):
        DP.dp_traceback(tb[:, :, :12].contiguous(), st, wd, sl)
    assert DP.LAUNCHES_TB == launches


def test_refine_reads_batch_on_card_matches_cpu(cuda):
    """The device refiner on the card against the same call on the CPU
    (the plain versions), scale_iters 0 and 2."""
    from remora_tpu_torch.data.read import RemoraRead
    from remora_tpu_torch.refine.refiner import SigMapRefiner

    base_lvl = {"A": -1.0, "C": -0.3, "G": 0.3, "T": 1.0}
    table = {a + b + c: base_lvl[b] + 0.2 * base_lvl[a] + 0.1 * base_lvl[c]
             for a in "ACGT" for b in "ACGT" for c in "ACGT"}
    rng = np.random.default_rng(7)
    reads = []
    for n in (120, 300, 80):
        int_seq = rng.integers(0, 4, n)
        dwells = rng.integers(3, 11, n)
        s2s = np.concatenate([[0], np.cumsum(dwells)])
        sig = rng.normal(0, 1, s2s[-1])
        reads.append(RemoraRead(dacs=sig * 15 + 50, shift=48.0, scale=16.0,
                                seq_to_sig_map=s2s, int_seq=int_seq))
    for scale_iters in (0, 2):
        out = []
        for device in (None, "cpu"):
            smr = SigMapRefiner.load_from_dict(
                table, do_rough_rescale=True, scale_iters=scale_iters,
                backend="device", device=device)
            leg = [rd.copy() for rd in reads]
            np.random.seed(1)
            assert smr.refine_reads_batch(leg) == [None] * len(leg)
            out.append(leg)
        for a, b in zip(*out):
            assert np.array_equal(a.seq_to_sig_map, b.seq_to_sig_map)
            assert a.shift == b.shift and a.scale == b.scale


# ---------------- duplex inference: K1 at every bucket size ------------


# RemoraRead.run_model pads a strand's calls to a power of two, 1 to 2048:
# B = 1, 2, 4 and 8 are partial blocks of the f32 kernel's 16 rows
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_lstm_last_at_every_duplex_bucket(cuda, dtype, tol):
    for b in (1 << k for k in range(12)):
        params, x = _case(124, b, 64, 64, dtype, cuda, seed=b)
        launches = K.LAUNCHES
        with full_f32():
            got = K.lstm_last(params, x)
            want = K.lstm_last_reference(params, x)
        torch.cuda.synchronize()
        assert K.LAUNCHES == launches + 1
        assert got.shape == (b, 64) and got.dtype == dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (b, err)


def test_infer_duplex_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``infer_duplex`` on 4 pairs (one without a duplex record, one
    without its complement's signal) with the handle on the card against
    the CPU: the same records, MM identical, ML within 1, K1 once an
    eval_fn call on the card and never on the CPU."""
    import chip_smoke as cs
    from remora_tpu_torch.infer.infer import ModelHandle
    from remora_tpu_torch.io import bam
    from remora_tpu_torch.io.pod5_write import Pod5Writer

    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE", "0")
    monkeypatch.setenv("LOG_SAFE", "1")
    path = str(tmp_path / "model.npz")
    cs.seeded_checkpoint(path)
    key = str(tmp_path / "simplex.pod5")
    with Pod5Writer(key) as p5w:
        paths = cs.write_duplex_set(
            str(tmp_path), 4, 600, bam,
            lambda rid, dacs: p5w.add_read(rid, dacs, 90.0, 20.0))
    got = {}
    for device in ("cuda", "cpu"):
        handle = ModelHandle.load(path, device=device)
        tags, counts, _wall, _lines = cs.duplex_leg(
            key, paths, handle, str(tmp_path / f"{device}.bam"), device)
        assert counts["written"] == 2
        want_k1 = counts["eval_calls"] if device == "cuda" else 0
        assert counts["k1"] == want_k1 and counts["eval_calls"] == 4
        got[device] = tags
    assert got["cuda"].keys() == got["cpu"].keys()
    mm, _ml, worst = cs.tag_diff(got["cuda"], got["cpu"])
    assert mm == 0 and worst <= 1


def test_cli_infer_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``infer from_pod5_and_bam`` through the command line with no
    ``--device`` (the card) and with ``--device cpu``, on 6 reads of 4000
    bases (a POD5 file written by the port) at batch 256: the same
    records, MM identical, ML within 1, K1 once a batch on the card and
    never on the CPU."""
    import chip_smoke as cs

    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE", "0")
    monkeypatch.setenv("LOG_SAFE", "1")
    path = str(tmp_path / "model.npz")
    cs.seeded_checkpoint(path)
    table, center = cs.synth_level_table()
    key, bam_path = cs.write_stream_set(str(tmp_path), "cli", 6, table,
                                        center)
    got = {}
    for device, flags in (("cuda", []), ("cpu", ["--device", "cpu"])):
        out = str(tmp_path / f"{device}.bam")
        counts, _wall, _lines = cs.cli_leg(
            ["infer", "from_pod5_and_bam", key, bam_path, "--model", path,
             "--out-bam", out, "--batch-size", 256, *flags], device)
        tags = got[device] = cs.bam_tags(out)
        n_batches = -(-sum(ml.size for _mm, ml in tags.values()) // 256)
        assert counts["k1"] == (n_batches if device == "cuda" else 0)
    assert len(got["cuda"]) == 6 and got["cuda"].keys() == got["cpu"].keys()
    mm, _ml, worst = cs.tag_diff(got["cuda"], got["cpu"])
    assert mm == 0 and worst <= 1


# ---------------- K6: the conv+BN(train)+swish backward ----------------


def _convbn_case(B, Ti, I, O, K, dtype, device, view, seed=0):
    """K6 inputs; ``view`` gives x and dout as channels-last views of
    (B, C, T) storage (the training path's layout), else contiguous."""
    rng = np.random.default_rng(seed)
    To = Ti - K + 1

    def arr(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32)).to(device)

    if view:
        x = arr(B, I, Ti).to(dtype).transpose(1, 2)
        dout = arr(B, O, To).to(dtype).transpose(1, 2)
    else:
        x, dout = arr(B, Ti, I).to(dtype), arr(B, To, O).to(dtype)
    w = arr(O, I, K, scale=1.0 / np.sqrt(I * K)).to(dtype)
    gamma = arr(O, scale=0.2).add(1.0).to(dtype)
    beta = arr(O, scale=0.1).to(dtype)
    mu = arr(O, scale=0.1).to(dtype)
    r = arr(O, scale=0.2).abs().add(0.5).to(dtype)
    return x, dout, w, gamma, beta, mu, r


# f32 is held to f32 sums in another order; bf16 rounds dy and dx to bf16
# (one bf16 step is 2**-8 of a value); db, a centred sum, by an absolute
# bound
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("view", [False, True], ids=["contiguous", "view"])
#
# Shapes: the row kernels (I or O below 8), K = 11 (f32 rows, bf16 mma.sync
# with two tap chunks in dw), and the tile edges of the tiled products: O =
# 12 (not a multiple of 8) with I * K = 180 (not a multiple of 16); To one
# more and one less than mma.sync's 128-row tile (129, 127) and than the f32
# tiles' 256-row tile at O = 64 (257, 255); B = 1; merge_conv1's widths at
# B = 3.
@pytest.mark.parametrize("B,Ti,I,O,K", [
    (5, 40, 1, 4, 5), (3, 61, 16, 32, 11), (4, 30, 128, 64, 5),
    (2, 300, 36, 16, 5), (2, 50, 36, 12, 5), (1, 133, 24, 16, 5),
    (2, 131, 16, 24, 5), (2, 261, 64, 64, 5), (1, 259, 32, 64, 5),
    (3, 128, 128, 64, 5),
])
def test_convbn_kernel_matches_plain(cuda, B, Ti, I, O, K, view, dtype, tol):
    from remora_tpu_torch.kernels import convbn as CB

    args = _convbn_case(B, Ti, I, O, K, dtype, cuda, view)
    launches = CB.LAUNCHES
    with full_f32():
        got = CB.conv_bn_swish_bwd(*args)
        want = CB.conv_bn_swish_bwd_reference(*args)
    torch.cuda.synchronize()
    assert CB.LAUNCHES == launches + 1
    for name, a, b in zip(("dx", "dw", "db", "dgamma", "dbeta"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "db":
            assert (a - b).abs().max().item() <= 1e-4, name
        else:
            assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_convbn_kernel_repeats_bit_for_bit(cuda, dtype):
    """K6 sums every cross-block partial in block order (no atomics), on
    the register tiles (f32) and the tensor cores (bf16) at merge_conv1's
    widths."""
    from remora_tpu_torch.kernels import convbn as CB

    args = _convbn_case(64, 128, 128, 64, 5, dtype, cuda, True)
    first = CB.conv_bn_swish_bwd(*args)
    second = CB.conv_bn_swish_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_convbn_product_paths(cuda):
    """The library's product path by shape: the four stride-1 blocks of the
    main path, and K != 5 in f32 (the tiles unroll five taps)."""
    from remora_tpu_torch.kernels import convbn as CB

    f32, bf16 = torch.float32, torch.bfloat16
    for (I, O, Ti), paths in (
            ((1, 4, 400), ("fp32 rows", "fp32 rows")),
            ((4, 16, 396), ("fp32 rows", "fp32 rows")),
            ((36, 16, 400), ("fp32 register tiles", "mma.sync bf16")),
            ((128, 64, 128), ("fp32 register tiles", "mma.sync bf16"))):
        assert (CB.products(2048, Ti, I, O, 5, f32),
                CB.products(2048, Ti, I, O, 5, bf16)) == paths
    assert CB.products(3, 61, 16, 32, 11, f32) == "fp32 rows"
    assert CB.products(3, 61, 16, 32, 11, bf16) == "mma.sync bf16"
    assert CB.products(2, 60, 4, 8, 41, f32) is None


def test_convbn_kernel_refuses_bad_inputs(cuda):
    from remora_tpu_torch.kernels import convbn as CB

    x, dout, w, gamma, beta, mu, r = _convbn_case(
        2, 20, 4, 8, 5, torch.float32, cuda, False)
    with pytest.raises(ValueError, match="stride 1"):
        CB.conv_bn_swish_bwd(x, dout, w, gamma, beta, mu, r, stride=2)
    with pytest.raises(ValueError, match="dtype"):
        CB.conv_bn_swish_bwd(x.double(), dout.double(), w, gamma, beta, mu,
                             r)
    with pytest.raises(ValueError, match="not \\(B, To, O\\)"):
        CB.conv_bn_swish_bwd(x, dout[:, 1:], w, gamma, beta, mu, r)
    with pytest.raises(ValueError, match="does not take"):
        CB.conv_bn_swish_bwd(x[..., 1:], dout, w, gamma, beta, mu, r)
    with pytest.raises(ValueError, match="kernel takes K"):
        xk, dk, wk = x.new_zeros(2, 60, 4), x.new_zeros(2, 20, 8), \
            w.new_zeros(8, 4, 41)
        CB.conv_bn_swish_bwd(xk, dk, wk, gamma, beta, mu, r)


def test_convbn_k6_autograd_on_card(cuda):
    """ConvBNSwishK6 (K6 backward) against ConvBNSwish (cuDNN gradients),
    f32 on the card, with the input needing a gradient and not."""
    from remora_tpu_torch.kernels import convbn as CB
    from remora_tpu_torch.models import layers as L

    rng = np.random.default_rng(4)
    conv = {"w": rng.normal(size=(16, 8, 5)) * 0.3, "b": rng.normal(size=16)}
    bn = {"gamma": rng.uniform(0.5, 1.5, 16), "beta": rng.normal(size=16)}
    state = {"mean": np.zeros(16), "var": np.ones(16)}
    x = rng.normal(size=(6, 50, 8))
    probe = torch.from_numpy(rng.normal(size=(6, 46, 16))).float().to(cuda)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    for x_grad in (True, False):
        grads = []
        for impl in ("pallas", "fused"):
            tc = {k: t(v).requires_grad_() for k, v in conv.items()}
            tb = {k: t(v).requires_grad_() for k, v in bn.items()}
            tx = t(x).requires_grad_(x_grad)
            launches = CB.LAUNCHES
            with full_f32():
                out, _ = L.conv_bn_swish(tc, tb, {k: t(v) for k, v in
                                                  state.items()}, tx, 1,
                                         train=True, impl=impl)
                (out * probe).sum().backward()
            torch.cuda.synchronize()
            assert CB.LAUNCHES - launches == (impl == "pallas")
            grads.append([tc["w"].grad, tb["gamma"].grad, tb["beta"].grad]
                         + ([tx.grad] if x_grad else []))
            assert (tx.grad is None) != x_grad
            assert tc["b"].grad.abs().max().item() <= 1e-4
        for got, want in zip(*grads):
            assert _rel(got, want) <= 1e-4
