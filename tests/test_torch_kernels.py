"""The port's kernel modules against the JAX package on the CPU: the plain
versions of the LSTM kernels (K1, and the training pair K2/K3), and the
device featurizer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remora_tpu.data import encoded_kmers as host_enc
from remora_tpu.kernels import encoded_kmers as jax_enc
from remora_tpu.kernels import pallas_lstm as PL
from remora_tpu.models import layers as JL
from remora_tpu_torch import RemoraError
from remora_tpu_torch.data import encoded_kmers as port_host_enc
from remora_tpu_torch.kernels import _build
from remora_tpu_torch.kernels import encoded_kmers as port_enc
from remora_tpu_torch.kernels import lstm as K


def _lstm_case(T, B, C, H, seed=0):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    params = {
        name: rng.uniform(-bound, bound, shape).astype(np.float32)
        for name, shape in (("w_ih", (4 * H, C)), ("w_hh", (4 * H, H)),
                            ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))
    }
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    return params, x


# ragged tails, an exact multiple of the time chunk, one chunk; C == H and
# C != H both ways; the f32 kernel's own widths (C = H = 64, the main
# shape, and C = 128 at H = 64, its two 64-k chunks of W_x)
@pytest.mark.parametrize(
    "T,C,H", [(7, 16, 16), (13, 24, 16), (24, 16, 32), (13, 8, 8),
              (7, 64, 64), (9, 128, 64)]
)
def test_lstm_last_plain_matches_pallas_and_scan(monkeypatch, T, C, H):
    B = 16
    monkeypatch.setattr(PL, "_tile_plan", lambda *a, **k: (8, 4))
    params, x = _lstm_case(T, B, C, H)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    pallas = np.asarray(PL.lstm_last_fused(jparams, jnp.asarray(x),
                                           interpret=True))
    scan = np.asarray(JL.lstm(jparams, jnp.asarray(x), impl="scan"))[-1]
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    launches = K.LAUNCHES
    got = K.lstm_last(tparams, torch.from_numpy(x))
    assert K.LAUNCHES == launches  # the CPU runs the plain version
    assert got.shape == (B, H) and got.dtype == torch.float32
    assert np.allclose(got.numpy(), pallas, atol=1e-5, rtol=0)
    assert np.allclose(got.numpy(), scan, atol=1e-5, rtol=0)
    full = K.L.lstm(tparams, torch.from_numpy(x)).numpy()
    assert np.allclose(
        full, np.asarray(JL.lstm(jparams, jnp.asarray(x), impl="scan")),
        atol=1e-5, rtol=0,
    )


def _w_aug(params):
    bias = params["b_ih"] + params["b_hh"]
    return np.concatenate(
        [params["w_ih"].T, params["w_hh"].T, bias[None]], axis=0
    )


# Pallas in interpret mode on a small plan: two batch tiles, time chunks of
# 4 with a ragged tail (T not a multiple of KT), and one exact multiple;
# C == H and C != H both ways; the f32 forward kernel's own widths (C = H
# = 64 and C = 128 at H = 64)
@pytest.mark.parametrize(
    "T,C,H", [(7, 16, 16), (13, 24, 16), (12, 16, 32), (7, 64, 64),
              (9, 128, 64)]
)
def test_lstm_train_plain_matches_pallas(monkeypatch, T, C, H):
    B = 16
    monkeypatch.setattr(PL, "_tile_plan", lambda *a, **k: (8, 4))
    params, x = _lstm_case(T, B, C, H, seed=T)
    w_aug = _w_aug(params)
    dhs = np.random.default_rng(T + 1).normal(size=(T, B, H)).astype(
        np.float32
    )
    j_hs, j_cs = PL._fwd_call(jnp.asarray(x), jnp.asarray(w_aug),
                              interpret=True)
    j_dx, j_dw = PL._bwd_call(jnp.asarray(x), jnp.asarray(w_aug), j_hs, j_cs,
                              jnp.asarray(dhs), interpret=True)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w_aug)
    launches = (K.LAUNCHES_FWD, K.LAUNCHES_BWD)
    hs, cs = K.lstm_fwd(tx, tw)
    assert hs.dtype == cs.dtype == torch.float32
    assert np.allclose(hs.numpy(), np.asarray(j_hs), atol=1e-5, rtol=0)
    assert np.allclose(cs.numpy(), np.asarray(j_cs), atol=1e-5, rtol=0)
    hs_nocs, none = K.lstm_fwd(tx, tw, want_cs=False)
    assert none is None and torch.equal(hs_nocs, hs)
    dx, dw = K.lstm_bwd(tx, tw, hs, cs, torch.from_numpy(dhs))
    assert dx.dtype == dw.dtype == torch.float32
    assert np.allclose(dx.numpy(), np.asarray(j_dx), atol=1e-5, rtol=0)
    # gradients: 1e-4 relative to the largest entry
    scale = np.abs(np.asarray(j_dw)).max()
    assert np.abs(dw.numpy() - np.asarray(j_dw)).max() <= 1e-4 * scale
    assert (K.LAUNCHES_FWD, K.LAUNCHES_BWD) == launches  # plain on the CPU


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_fused_grads_match_jax_scan(reverse):
    """``lstm_fused`` (K2/K3's plain versions through ``LSTMFused``) against
    ``jax.vjp`` of the JAX scan, and against autograd through the port's
    plain loop: values <= 1e-5, gradients <= 1e-4 relative."""
    T, B, C, H = 9, 6, 12, 8
    params, x = _lstm_case(T, B, C, H, seed=3)
    probe = np.random.default_rng(4).normal(size=(T, B, H)).astype(
        np.float32
    )
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    want, vjp = jax.vjp(
        lambda p, xx: JL.lstm(p, xx, reverse=reverse, impl="scan"),
        jparams, jnp.asarray(x),
    )
    j_dp, j_dx = vjp(jnp.asarray(probe))

    def port(impl):
        tp = {k: torch.from_numpy(v).requires_grad_() for k, v in
              params.items()}
        tx = torch.from_numpy(x).requires_grad_()
        hs = K.L.lstm(tp, tx, reverse=reverse, impl=impl)
        (hs * torch.from_numpy(probe)).sum().backward()
        return hs.detach().numpy(), {k: v.grad.numpy() for k, v in
                                     tp.items()}, tx.grad.numpy()

    def close_rel(got, ref):
        ref = np.asarray(ref)
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()

    fused, scan = port("fused"), port("scan")
    for hs, dp, dx in (fused, scan):
        assert np.allclose(hs, np.asarray(want), atol=1e-5, rtol=0)
        close_rel(dx, j_dx)
        for name in params:
            close_rel(dp[name], j_dp[name])
    close_rel(fused[2], scan[2])
    for name in params:
        close_rel(fused[1][name], scan[1][name])


def test_lstm_train_plain_bf16_numerics():
    """bf16 K2/K3 plain versions: outputs and dx in bf16, dW in f32, within
    bf16 rounding of the f32 run on the same (bf16-representable) inputs."""
    T, B, C, H = 6, 5, 8, 8
    params, x = _lstm_case(T, B, C, H, seed=9)
    w = torch.from_numpy(_w_aug(params)).bfloat16()
    xb = torch.from_numpy(x).bfloat16()
    dhs = torch.from_numpy(
        np.random.default_rng(2).normal(size=(T, B, H)).astype(np.float32)
    ).bfloat16()
    hs, cs = K.lstm_fwd(xb, w)
    hs32, cs32 = K.lstm_fwd(xb.float(), w.float())
    assert hs.dtype == cs.dtype == torch.bfloat16
    assert (hs.float() - hs32).abs().max() <= 2e-2
    assert (cs.float() - cs32).abs().max() <= 2e-2
    dx, dw = K.lstm_bwd(xb, w, hs, cs, dhs)
    dx32, dw32 = K.lstm_bwd(xb.float(), w.float(), hs32, cs32, dhs.float())
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert (dx.float() - dx32).abs().max() <= 2e-2 * dx32.abs().max()
    assert (dw - dw32).abs().max() <= 2e-2 * dw32.abs().max()


def test_lstm_fused_skips_cs_without_grad(monkeypatch):
    params, x = _lstm_case(4, 3, 8, 8)
    tparams = {k: torch.from_numpy(v).requires_grad_() for k, v in
               params.items()}
    seen = []
    fwd = K.lstm_fwd

    def spy(x, w_aug, want_cs=True):
        seen.append(want_cs)
        return fwd(x, w_aug, want_cs)

    monkeypatch.setattr(K, "lstm_fwd", spy)
    with torch.no_grad():
        K.lstm_fused(tparams, torch.from_numpy(x))
    K.lstm_fused(tparams, torch.from_numpy(x))
    assert seen == [False, True]


def test_make_w_aug_matches_pallas_layout():
    params, _ = _lstm_case(3, 4, 12, 8)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    w = K.make_w_aug(tparams, torch.float32).numpy()
    bias = params["b_ih"] + params["b_hh"]
    want = np.concatenate(
        [params["w_ih"].T, params["w_hh"].T, bias[None]], axis=0
    )
    assert w.shape == (12 + 8 + 1, 32)
    assert np.array_equal(w, want)


def test_lstm_last_refuses_devices_without_a_kernel():
    params, x = _lstm_case(3, 4, 8, 8)
    tparams = {k: torch.from_numpy(v).to("meta") for k, v in params.items()}
    with pytest.raises(ValueError, match="no kernel for device"):
        K.lstm_last(tparams, torch.from_numpy(x).to("meta"))
    w_aug = torch.from_numpy(_w_aug(params)).to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        K.lstm_fwd(torch.from_numpy(x).to("meta"), w_aug)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    assert "lstm_fwd_f32" in _build.sources()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RemoraError, match="nvcc not found"):
        _build._nvcc()


def _ragged_chunks(rng, B, S, kmer_len, sig_len):
    """Chunks as a dataset stores them: seqs padded with -1 past the real
    bases (context included), maps monotonic up to seq_len then garbage."""
    seq_lens = rng.integers(1, S + 1, B)
    seq_lens[0] = S
    seqs = np.full((B, S + kmer_len - 1), -1, np.int8)
    maps = rng.integers(0, sig_len + 1, (B, S + 1)).astype(np.int16)
    for b, sl in enumerate(seq_lens):
        # the read may end inside the after-context: -1 from there on
        n_real = sl + kmer_len - 1 - rng.integers(0, 3)
        seqs[b, :n_real] = rng.integers(0, 4, n_real)
        maps[b, 0] = 0
        maps[b, 1:sl] = np.sort(rng.integers(0, sig_len + 1, sl - 1))
        maps[b, sl] = sig_len
    return seqs, maps, seq_lens.astype(np.int16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_featurizer_bit_equal(seed):
    bb, ab = 4, 4
    kmer_len, S, sig_len, B = bb + ab + 1, 30, 120, 12
    rng = np.random.default_rng(seed)
    seqs, maps, lens = _ragged_chunks(rng, B, S, kmer_len, sig_len)
    host = host_enc.compute_encoded_kmer_batch(bb, ab, seqs, maps, lens)
    assert np.array_equal(
        host,
        port_host_enc.compute_encoded_kmer_batch(bb, ab, seqs, maps, lens),
    )
    assert host.sum() > 0
    t_args = [torch.from_numpy(a) for a in (seqs, maps, lens)]
    pos = port_enc.seq_pos_of_sig(t_args[1], t_args[2], sig_len).numpy()
    assert np.array_equal(
        pos, np.asarray(jax_enc.seq_pos_of_sig(maps, lens, sig_len))
    )
    assert np.array_equal(
        pos, host_enc.compute_seq_pos_of_sig(maps, lens, sig_len)
    )
    for channels_last in (False, True):
        want = np.asarray(jax_enc.compute_encoded_kmer_batch(
            bb, ab, seqs, maps, lens, sig_len, channels_last=channels_last
        ))
        got = port_enc.compute_encoded_kmer_batch(
            bb, ab, *t_args, sig_len, channels_last=channels_last
        )
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)
        want_host = host.transpose(0, 2, 1) if channels_last else host
        assert np.array_equal(got.numpy(), want_host)
        bf16 = port_enc.compute_encoded_kmer_batch(
            bb, ab, *t_args, sig_len, out_dtype=torch.bfloat16,
            channels_last=channels_last,
        )
        assert bf16.dtype == torch.bfloat16
        assert np.array_equal(bf16.float().numpy(), want)


def test_featurizer_short_stored_context():
    """Seqs narrower than S + kmer_len - 1 read -1 padding past their end
    (the JAX featurizer zero-pads its one-hots there)."""
    bb, ab, S, sig_len = 2, 2, 10, 40
    rng = np.random.default_rng(5)
    seqs, maps, lens = _ragged_chunks(rng, 6, S, bb + ab + 1, sig_len)
    seqs = seqs[:, : S + 1]
    want = np.asarray(jax_enc.compute_encoded_kmer_batch(
        bb, ab, seqs, maps, lens, sig_len
    ))
    got = port_enc.compute_encoded_kmer_batch(
        bb, ab, *(torch.from_numpy(a) for a in (seqs, maps, lens)), sig_len
    )
    assert np.array_equal(got.numpy(), want)
