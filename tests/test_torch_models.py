"""The port's layers, models and checkpoints against the JAX package on
the CPU (f32, the same numpy-made weights and inputs on both sides)."""

import jax
import numpy as np
import pytest
import torch

from remora_tpu.models import conv_lstm_model as jax_convlstm
from remora_tpu.models import conv_model as jax_conv
from remora_tpu.models import layers as JL
from remora_tpu.models import model_io as jax_io
from remora_tpu_torch.models import conv_lstm_model, conv_model
from remora_tpu_torch.models import layers as L
from remora_tpu_torch.models import model_io

ATOL = 1e-5
# (JAX module, port module, chunk width): the Conv head is sized for a
# (50, 50) chunk context
ARCHS = [(jax_convlstm, conv_lstm_model, 60), (jax_conv, conv_model, 100)]
# one XLA program per forward (op-by-op dispatch compiles every primitive)
JAX_FORWARD = {
    m: jax.jit(m.forward, static_argnames=("train", "channels_last_in"))
    for m in (jax_convlstm, jax_conv)
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(want)
    assert np.allclose(got, np.asarray(want), atol=atol, rtol=0)


def _numpy_trees(port_model, size, kmer_len, num_out, seed):
    """(params, bn_state) pytrees of numpy-made f32 arrays in the JAX
    layout: fan-in uniform weights, BatchNorm away from identity."""
    params, bn_state = model_io.module_to_trees(port_model.init(
        size=size, kmer_len=kmer_len, num_out=num_out
    ))
    rng = np.random.default_rng(seed)

    def u(lo, hi, a):
        return rng.uniform(lo, hi, a.shape).astype(np.float32)

    for leaves in params.values():
        if "gamma" in leaves:
            leaves.update(gamma=u(0.5, 1.5, leaves["gamma"]),
                          beta=u(-0.2, 0.2, leaves["beta"]))
            continue
        w = next(a for a in leaves.values() if a.ndim > 1)
        bound = 1 / np.sqrt(np.prod(w.shape[1:]))
        for leaf, a in leaves.items():
            leaves[leaf] = u(-bound, bound, a)
    for leaves in bn_state.values():
        leaves.update(mean=u(-0.2, 0.2, leaves["mean"]),
                      var=u(0.1, 0.5, leaves["var"]))
    return params, bn_state


def _inputs(rng, B, width, kmer_len):
    sigs = rng.normal(size=(B, 1, width)).astype(np.float32)
    seqs = (rng.random((B, 4 * kmer_len, width)) < 0.25).astype(np.float32)
    return sigs, seqs


@pytest.mark.parametrize("stride", [1, 3])
def test_conv_bn_swish_layers(stride):
    rng = np.random.default_rng(stride)
    conv = {"w": rng.normal(size=(8, 5, 7)).astype(np.float32),
            "b": rng.normal(size=8).astype(np.float32)}
    bn = {"gamma": rng.uniform(0.5, 1.5, 8).astype(np.float32),
          "beta": rng.normal(size=8).astype(np.float32)}
    state = {"mean": rng.normal(size=8).astype(np.float32),
             "var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    x = rng.normal(size=(3, 40, 5)).astype(np.float32)
    tc, tb, ts = ({k: _t(v) for k, v in d.items()} for d in (conv, bn, state))
    y = L.conv1d(tc, _t(x), stride)
    _close(y, JL.conv1d(conv, x, stride))
    _close(L.batchnorm(tb, ts, y)[0], JL.batchnorm(bn, state, np.asarray(y),
                                                   False)[0])
    _close(L.conv_bn_swish(tc, tb, ts, _t(x), stride)[0],
           JL.conv_bn_swish(conv, bn, state, x, stride)[0])
    _close(L.swish(_t(x)), JL.swish(x))


def test_linear_and_lstm_layers():
    rng = np.random.default_rng(7)
    C, H, T, B = 12, 8, 9, 5
    gen = torch.Generator().manual_seed(1)
    lstm, lin = (
        {k: v.numpy() for k, v in p.items()}
        for p in (L.lstm_init(gen, C, H), L.linear_init(gen, C, 3))
    )
    tl, tlin = ({k: _t(v) for k, v in p.items()} for p in (lstm, lin))
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    _close(L.linear(tlin, _t(x[0])), JL.linear(lin, x[0]))
    _close(L.lstm_cell_step0(tl, _t(x[0])), JL.lstm_cell_step0(lstm, x[0]))
    for reverse in (False, True):
        _close(L.lstm(tl, _t(x), reverse=reverse),
               JL.lstm(lstm, x, reverse=reverse, impl="scan"))
    _close(L.lstm_last(tl, _t(x)), JL.lstm_last(lstm, x, impl="scan"))


def test_inits_follow_torch_bounds():
    gen = torch.Generator().manual_seed(0)
    conv = L.conv1d_init(gen, 4, 16, 5)
    lstm = L.lstm_init(gen, 16, 8)
    lin = L.linear_init(gen, 8, 2)
    assert conv["w"].shape == (16, 4, 5) and conv["b"].shape == (16,)
    assert conv["w"].abs().max() <= 1 / np.sqrt(20)
    assert lstm["w_hh"].shape == (32, 8)
    assert lstm["b_ih"].abs().max() <= 1 / np.sqrt(8)
    assert lin["w"].shape == (2, 8)
    again = L.conv1d_init(torch.Generator().manual_seed(0), 4, 16, 5)
    assert torch.equal(again["w"], conv["w"])


@pytest.mark.parametrize("channels_last_in", [False, True])
@pytest.mark.parametrize("jax_model,port_model,width", ARCHS,
                         ids=["ConvLSTM", "Conv"])
def test_eval_forward_matches_jax(jax_model, port_model, width,
                                  channels_last_in):
    kmer_len, size, num_out = 9, 16, 3
    params, bn_state = _numpy_trees(port_model, size, kmer_len, num_out, 0)
    model = port_model.init(size=size, kmer_len=kmer_len, num_out=num_out)
    model.load_state_dict(model_io.params_from_numpy(params, bn_state))
    sigs, seqs = _inputs(np.random.default_rng(1), 6, width, kmer_len)
    if channels_last_in:
        sigs, seqs = sigs.swapaxes(1, 2), seqs.swapaxes(1, 2)
    want, _ = JAX_FORWARD[jax_model](params, bn_state, sigs, seqs,
                                     channels_last_in=channels_last_in)
    with torch.no_grad():
        got = model(_t(sigs), _t(seqs), channels_last_in=channels_last_in)
    assert got.dtype == torch.float32
    _close(got, want)
    # the train-mode forward (batch statistics) too
    want, _ = JAX_FORWARD[jax_model](params, bn_state, sigs, seqs, train=True,
                                     channels_last_in=channels_last_in)
    with torch.no_grad():
        got = model(_t(sigs), _t(seqs), train=True,
                    channels_last_in=channels_last_in)
    _close(got, want)


def _meta(name, chunk_context):
    return {
        "model_name": name,
        "model_params": {"size": 16, "kmer_len": 9, "num_out": 2},
        "model_version": 3,
        "chunk_context": list(chunk_context),
        "motifs": [["CG", 0]],
        "num_motifs": 1,
        "reverse_signal": False,
        "mod_bases": ["m"],
        "mod_long_names": ["5mC"],
        "kmer_context_bases": [4, 4],
        "base_start_justify": False,
        "offset": 0,
        "pa_scaling": None,
        "refine_kmer_center_idx": 2,
        "refine_do_rough_rescale": False,
        "refine_scale_iters": -1,
        "refine_algo": "dwell_penalty",
        "refine_half_bandwidth": 5,
        "rough_rescale_method": "least_squares",
    }


@pytest.mark.parametrize("jax_model,port_model,width", ARCHS,
                         ids=["ConvLSTM", "Conv"])
def test_checkpoints_cross_load(tmp_path, jax_model, port_model, width):
    params, bn_state = _numpy_trees(port_model, 16, 9, 2, 3)
    meta = _meta(jax_model.NAME, (width // 2, width // 2))
    sd_arr = np.linspace(0.5, 1.5, 5).astype(np.float32)
    jax_path = tmp_path / "from_jax.npz"
    jax_io.save_model(jax_path, params, bn_state, dict(meta),
                      meta_arrays={"refine_sd_arr": sd_arr})
    sigs, seqs = _inputs(np.random.default_rng(4), 5, width, 9)
    want, _ = JAX_FORWARD[jax_model](params, bn_state, sigs, seqs)

    model, port_meta = model_io.load_model(jax_path)
    assert type(model).__name__ == port_model.NAME
    assert port_meta["chunk_len"] == width and port_meta["kmer_len"] == 9
    assert port_meta["can_base"] == "C"
    refine = port_meta["refine_settings"]
    assert refine["refine_algo"] == "dwell_penalty"
    assert refine["refine_kmer_center_idx"] == 2
    assert refine["rough_rescale_method"] == "least_squares"
    assert np.array_equal(refine["refine_sd_arr"], sd_arr)
    assert {k for k in port_meta if k.startswith("refine_")} == {
        "refine_settings"
    }
    with torch.no_grad():
        got = model(_t(sigs), _t(seqs))
    _close(got, want)

    port_path = tmp_path / "from_port.npz"
    model_io.save_model(port_path, model, dict(meta),
                        meta_arrays={"refine_sd_arr": sd_arr})
    j_model, j_params, j_bn, j_meta = jax_io.load_model(port_path)
    assert j_model is jax_model
    assert np.array_equal(j_meta["sig_map_refiner"].sd_arr, sd_arr)
    for tree, back in ((params, j_params), (bn_state, j_bn)):
        flat, flat_back = jax_io.flatten_tree(tree), jax_io.flatten_tree(back)
        assert flat.keys() == flat_back.keys()
        for key in flat:
            assert np.array_equal(flat[key], flat_back[key]), key
    again, _ = JAX_FORWARD[j_model](j_params, j_bn, sigs, seqs)
    assert np.array_equal(np.asarray(again), np.asarray(want))
