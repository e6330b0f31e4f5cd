"""K6 (the conv+BN(train)+swish backward) against the JAX package on the
CPU: the port's plain version ``conv_bn_swish_bwd_reference`` against
``pallas_convbn.conv_bn_swish_bwd`` in interpret mode (as the JAX package
runs it off the TPU), against an f64 oracle, and the pallas and packed
modes at the block level in bf16. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_convbn.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remora_tpu.kernels import pallas_convbn as PC
from remora_tpu.models import layers as JL
from remora_tpu_torch.kernels import convbn as CB
from remora_tpu_torch.models import layers as L


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs(B, Ti, I, O, K, seed):
    """numpy K6 inputs; mu and r are the batch statistics of conv(x, w)."""
    rng = np.random.default_rng(seed)
    To = Ti - K + 1
    x = rng.normal(size=(B, Ti, I)).astype(np.float32)
    w = (rng.normal(size=(O, I, K)) / np.sqrt(I * K)).astype(np.float32)
    y = np.zeros((B, To, O))
    for k in range(K):
        y += np.einsum("bti,oi->bto", x[:, k:k + To], w[:, :, k])
    mu = y.mean((0, 1)).astype(np.float32)
    r = (1.0 / np.sqrt(y.var((0, 1)) + 1e-5)).astype(np.float32)
    return {
        "x": x,
        "dout": rng.normal(size=(B, To, O)).astype(np.float32),
        "w": w,
        "gamma": rng.uniform(0.5, 1.5, O).astype(np.float32),
        "beta": rng.normal(size=O).astype(np.float32) * 0.1,
        "mu": mu,
        "r": r,
    }


def _torch_args(a, view):
    """Port arguments; ``view`` hands x and dout over as channels-last
    views of (B, C, T) storage, the layout of the port's activations."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    if view:
        for k in ("x", "dout"):
            t[k] = torch.from_numpy(
                np.ascontiguousarray(a[k].transpose(0, 2, 1))).transpose(1, 2)
            assert not t[k].is_contiguous()
    return [t[k] for k in ("x", "dout", "w", "gamma", "beta", "mu", "r")]


SHAPES = [(8, 40, 16, 32, 5), (4, 30, 4, 8, 3), (3, 50, 6, 12, 11)]


@pytest.mark.parametrize("view", [False, True], ids=["contiguous", "view"])
@pytest.mark.parametrize("B,Ti,I,O,K", SHAPES)
def test_k6_plain_matches_pallas(B, Ti, I, O, K, view):
    """dx, dw, dgamma, dbeta <= 1e-5 relative; db (a centred sum) <= 1e-5
    absolute."""
    a = _inputs(B, Ti, I, O, K, seed=B * Ti)
    want = PC.conv_bn_swish_bwd(*(jnp.asarray(a[k]) for k in (
        "x", "dout", "w", "gamma", "beta", "mu", "r")), interpret=True)
    got = CB.conv_bn_swish_bwd(*_torch_args(a, view))
    names = ("dx", "dw", "db", "dgamma", "dbeta")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == w.shape, name
        assert g.dtype == torch.float32, name
        if name == "db":
            assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5
        else:
            assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


@pytest.mark.parametrize("B,T,I,O,K", SHAPES[:2])
def test_k6_plain_meets_f64_oracle(B, T, I, O, K):
    """``tests/test_kernels.py``'s criterion for the Pallas kernel: through
    ``conv_bn_swish`` with ``impl="pallas"`` (K6's plain version on the
    CPU), every gradient is within 4x the fused path's error against an f64
    oracle of the same formulas, plus 1e-6."""
    rng = np.random.default_rng(11 + K)
    bound = 1.0 / np.sqrt(I * K)
    conv = {"w": rng.uniform(-bound, bound, (O, I, K)),
            "b": rng.uniform(-bound, bound, O)}
    bn = {"gamma": np.ones(O), "beta": np.zeros(O)}
    state = {"mean": np.linspace(-1.0, 1.0, O), "var": np.linspace(0.5, 2, O)}
    x = rng.normal(size=(B, T, I))
    To = T - K + 1
    probe = rng.normal(size=(B, To, O))

    def t(v):
        return torch.from_numpy(np.asarray(v, np.float32))

    got = {}
    for impl in ("fused", "pallas"):
        tc = {k: t(v).requires_grad_() for k, v in conv.items()}
        tb = {k: t(v).requires_grad_() for k, v in bn.items()}
        tx = t(x).requires_grad_()
        out, _ = L.conv_bn_swish(tc, tb, {k: t(v) for k, v in state.items()},
                                 tx, 1, train=True, impl=impl)
        (out * t(probe)).sum().backward()
        got[impl] = {"conv_w": tc["w"].grad, "conv_b": tc["b"].grad,
                     "gamma": tb["gamma"].grad, "beta": tb["beta"].grad,
                     "x": tx.grad}

    xw = np.asarray(t(x), np.float64)
    w64 = np.asarray(t(conv["w"]), np.float64)
    dout = np.asarray(t(probe), np.float64)
    y = np.zeros((B, To, O))
    for k in range(K):
        y += np.einsum("bti,oi->bto", xw[:, k:k + To], w64[:, :, k])
    r = 1.0 / np.sqrt(y.var((0, 1)) + 1e-5)
    xhat = (y - y.mean((0, 1))) * r
    s = 1.0 / (1.0 + np.exp(-xhat))  # gamma = 1, beta = 0
    dz = dout * (s + xhat * s * (1.0 - s))
    dgamma = (dz * xhat).sum((0, 1))
    dbeta = dz.sum((0, 1))
    n = B * To
    dy = r * (dz - dbeta / n - xhat * (dgamma / n))
    dw = np.zeros_like(w64)
    dx = np.zeros_like(xw)
    for k in range(K):
        dw[:, :, k] = np.einsum("bto,bti->oi", dy, xw[:, k:k + To])
        dx[:, k:k + To] += np.einsum("bto,oi->bti", dy, w64[:, :, k])
    oracle = {"conv_w": dw, "conv_b": dy.sum((0, 1)), "gamma": dgamma,
              "beta": dbeta, "x": dx}
    for name, ref in oracle.items():
        e_fused = np.abs(got["fused"][name].numpy() - ref).max()
        e_k6 = np.abs(got["pallas"][name].numpy() - ref).max()
        assert e_k6 <= 4.0 * e_fused + 1e-6, (name, e_k6, e_fused)


def test_k6_entry_point_on_the_cpu():
    """A CPU tensor takes the plain version; dx is skipped on request; a
    stride other than 1 and mismatched shapes raise."""
    a = _inputs(2, 20, 3, 5, 5, seed=3)
    args = _torch_args(a, False)
    launches = CB.LAUNCHES
    full = CB.conv_bn_swish_bwd(*args)
    no_dx = CB.conv_bn_swish_bwd(*args, need_dx=False)
    assert CB.LAUNCHES == launches  # no kernel ran
    assert no_dx[0] is None
    for got, want in zip(no_dx[1:], full[1:]):
        assert torch.equal(got, want)
    for got, want in zip(full, CB.conv_bn_swish_bwd_reference(*args)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="stride 1"):
        CB.conv_bn_swish_bwd(*args, stride=3)
    with pytest.raises(ValueError, match="not \\(B, To, O\\)"):
        CB.conv_bn_swish_bwd(args[0], args[1][:, 1:], *args[2:])


def test_pack_weights_layout():
    """The kernel's float4 weight groups: wp[g, k, c, j] = W[4g + j, c, k],
    zero past C_out."""
    w = torch.arange(6 * 3 * 2, dtype=torch.float32).reshape(6, 3, 2)
    wp = CB.pack_weights(w)
    assert wp.shape == (2, 2, 3, 4) and wp.is_contiguous()
    for g in range(2):
        for k in range(2):
            for c in range(3):
                for j in range(4):
                    o = 4 * g + j
                    want = w[o, c, k].item() if o < 6 else 0.0
                    assert wp[g, k, c, j].item() == want


@pytest.mark.parametrize("pack,order,dtype", [
    (CB.pack_weights_mma, "knc", torch.bfloat16),
    (CB.pack_weights_tiles, "kcn", torch.float32),
], ids=["mma", "tiles"])
def test_pack_weights_tiled_layouts(pack, order, dtype):
    """The tiled products' weights: (K, n_pad, c_pad) bf16 for mma.sync's
    col-major B operand, (K, c_pad, n_pad) f32 for the register tiles;
    unpacked they give back w (exact in bf16: integers below 256), zeros
    in the padding."""
    c_out, c_in, K = 12, 36, 5
    w = torch.arange(c_out * c_in * K, dtype=torch.float32).reshape(
        c_out, c_in, K) % 251
    n_pad, c_pad = 16, 48
    wq = pack(w, n_pad, c_pad)
    assert wq.dtype == dtype and wq.is_contiguous()
    if order == "knc":
        assert wq.shape == (K, n_pad, c_pad)
        back = wq.permute(1, 2, 0)
    else:
        assert wq.shape == (K, c_pad, n_pad)
        back = wq.permute(2, 1, 0)
    assert torch.equal(back[:c_out, :c_in].float(), w)
    assert not back[c_out:].any() and not back[:, c_in:].any()


# bf16 at the block level: both packages compute the forward statistics in
# bf16 and round at other places inside it (XLA keeps excess precision in
# fused elementwise chains), so the output and the gradients are held to
# 2e-2 of their largest entry (measured: <= 7.3e-3, two bf16 steps), the
# conv bias, a centred sum of bf16-rounded terms, to 5e-2 absolute
# (measured: 8.9e-3 packed)
@pytest.mark.parametrize("impl", ["packed", "pallas"])
def test_conv_bn_swish_bf16_matches_jax(impl):
    rng = np.random.default_rng(17)
    conv = {"w": (rng.normal(size=(16, 8, 5)) * 0.3).astype(np.float32),
            "b": rng.normal(size=16).astype(np.float32)}
    bn = {"gamma": rng.uniform(0.5, 1.5, 16).astype(np.float32),
          "beta": rng.normal(size=16).astype(np.float32)}
    state = {"mean": np.zeros(16, np.float32), "var": np.ones(16, np.float32)}
    x = rng.normal(size=(6, 60, 8)).astype(np.float32)
    probe = rng.normal(size=(6, 56, 16)).astype(np.float32)
    bf = jnp.bfloat16

    def jax_loss(c, b, xx):
        out, _ = JL.conv_bn_swish(c, b, state, xx, 1, train=True, impl=impl)
        return jnp.sum(out.astype(jnp.float32) * probe), out

    cast = lambda tree: jax.tree.map(lambda v: jnp.asarray(v, bf), tree)  # noqa: E731
    (_, j_out), (j_dc, j_db, j_dx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(cast(conv), cast(bn),
                                                   jnp.asarray(x, bf))

    def t(v):
        return torch.from_numpy(v).to(torch.bfloat16)

    tc = {k: t(v).requires_grad_() for k, v in conv.items()}
    tb = {k: t(v).requires_grad_() for k, v in bn.items()}
    tx = t(x).requires_grad_()
    out, _ = L.conv_bn_swish(tc, tb, {k: t(v) for k, v in state.items()}, tx,
                             1, train=True, impl=impl)
    (out.float() * torch.from_numpy(probe)).sum().backward()

    def f32(v):
        return np.asarray(jnp.asarray(v, jnp.float32))

    assert out.dtype == torch.bfloat16
    assert _rel(out.detach().float(), f32(j_out)) <= 2e-2
    for got, want in ((tc["w"].grad, j_dc["w"]), (tb["gamma"].grad,
                      j_db["gamma"]), (tb["beta"].grad, j_db["beta"]),
                      (tx.grad, j_dx)):
        assert got.dtype == torch.bfloat16
        assert _rel(got.float(), f32(want)) <= 2e-2
    assert np.abs(tc["b"].grad.float().numpy() - f32(j_dc["b"])).max() <= 5e-2
