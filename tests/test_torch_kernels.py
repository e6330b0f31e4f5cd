"""The port's kernel modules against the JAX package on the CPU: the
last-only LSTM's plain version, and the device featurizer."""

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
# C != H both ways
@pytest.mark.parametrize(
    "T,C,H", [(7, 16, 16), (13, 24, 16), (24, 16, 32), (13, 8, 8)]
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


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    assert "lstm_last" in _build.sources()
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
