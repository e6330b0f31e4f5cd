"""The port's training slice against the JAX package on the CPU (f32 unless
stated): the train-mode conv+BN+swish block, the train-mode forward, loss
and gradients of both models, the optimizers, checkpoints with optimizer
state, and ``train_model`` end to end.

A trap shapes these tests. A conv's bias cancels inside train-mode
BatchNorm, so its gradient is rounding noise (~1e-9), and Adam divides that
noise by sqrt(v_hat) + 1e-8: parameters after an AdamW step cannot match
across the packages on the conv biases. So gradients are held against JAX
(the conv-bias gradients by an absolute bound), the optimizers are fed
identical gradients, and the end-to-end parity run uses SGD.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from remora_tpu.models import conv_lstm_model as jax_convlstm
from remora_tpu.models import conv_model as jax_conv
from remora_tpu.models import layers as JL
from remora_tpu.models import model_io as jax_io
from remora_tpu.train import optim as jax_optim
from remora_tpu.train import train as jax_train
from remora_tpu_torch import RemoraError
from remora_tpu_torch.kernels import lstm as K
from remora_tpu_torch.models import conv_lstm_model, conv_model
from remora_tpu_torch.models import layers as L
from remora_tpu_torch.models import model_io
from remora_tpu_torch.train import optim, train
from tests.test_torch_data import write_config, write_synth_dataset
from tests.test_torch_models import _numpy_trees

# a conv bias's gradient is the sum of a cotangent that train-mode BN
# centres: rounding noise in both packages, held to this absolute bound
BIAS_NOISE = 1e-5
ARCHS = {"ConvLSTM": (jax_convlstm, conv_lstm_model, 50),
         "Conv": (jax_conv, conv_model, 100)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _is_conv_bias(key):
    return "conv" in key and key.endswith("/b")


# ---------------- conv + BN(train) + swish ----------------


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("impl", L.CONVBN_MODES)
def test_conv_bn_swish_train_matches_jax(impl, stride):
    """Every REMORA_TPU_CONVBN mode against the JAX package's same mode
    (pallas: K6's plain version against the Pallas kernel in interpret
    mode on stride-1 blocks, ``ConvBNSwish`` against ``_cbs_core`` on
    strided ones): output, new statistics and gradients <= 1e-5."""
    rng = np.random.default_rng(stride)
    conv = {"w": rng.normal(size=(8, 5, 7)).astype(np.float32) * 0.3,
            "b": rng.normal(size=8).astype(np.float32)}
    bn = {"gamma": rng.uniform(0.5, 1.5, 8).astype(np.float32),
          "beta": rng.normal(size=8).astype(np.float32)}
    state = {"mean": rng.normal(size=8).astype(np.float32),
             "var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    x = rng.normal(size=(4, 40, 5)).astype(np.float32)
    probe = rng.normal(size=(4, (40 - 7) // stride + 1, 8)).astype(
        np.float32)

    def jax_loss(c, b, xx):
        out, ns = JL.conv_bn_swish(c, b, state, xx, stride, train=True,
                                   impl=impl)
        return jnp.sum(out * probe), (out, ns)

    (_, (j_out, j_state)), (j_dc, j_db, j_dx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(conv, bn, x)

    tc = {k: _t(v).requires_grad_() for k, v in conv.items()}
    tb = {k: _t(v).requires_grad_() for k, v in bn.items()}
    tx = _t(x).requires_grad_()
    out, new_state = L.conv_bn_swish(tc, tb, {k: _t(v) for k, v in
                                              state.items()}, tx, stride,
                                     train=True, impl=impl)
    (out * _t(probe)).sum().backward()
    assert _rel_err(out.detach(), j_out) <= 1e-5
    for k in ("mean", "var"):
        assert not new_state[k].requires_grad
        assert _rel_err(new_state[k], j_state[k]) <= 1e-5
    for got, want in ((tc["w"].grad, j_dc["w"]), (tb["gamma"].grad,
                      j_db["gamma"]), (tb["beta"].grad, j_db["beta"]),
                      (tx.grad, j_dx)):
        assert _rel_err(got, want) <= 1e-5
    # the bias gradient is centred-cotangent noise in both packages
    assert np.abs(tc["b"].grad.numpy()).max() <= BIAS_NOISE
    assert np.abs(np.asarray(j_dc["b"])).max() <= BIAS_NOISE


def test_convbn_modes(monkeypatch):
    """auto picks by device; every mode of the JAX package is taken on
    either device; an unknown mode raises, from the env and as ``impl``."""
    assert L.convbn_impl("cpu") == "plain"
    assert L.convbn_impl("cuda") == "fused"
    assert set(L.CONVBN_MODES) == {"plain", "remat", "fused", "fused_resid",
                                   "packed", "pallas"}
    for mode in L.CONVBN_MODES:
        monkeypatch.setenv("REMORA_TPU_CONVBN", mode)
        assert L.convbn_impl("cpu") == L.convbn_impl("cuda") == mode
    monkeypatch.setenv("REMORA_TPU_CONVBN", "lanes")
    with pytest.raises(RemoraError, match="unknown REMORA_TPU_CONVBN"):
        L.convbn_impl("cpu")
    x = torch.zeros(2, 9, 3)
    conv = {"w": torch.zeros(4, 3, 5), "b": torch.zeros(4)}
    bn = {"gamma": torch.ones(4), "beta": torch.zeros(4)}
    with pytest.raises(RemoraError, match="unknown conv_bn_swish impl"):
        L.conv_bn_swish(conv, bn, {"mean": torch.zeros(4),
                                   "var": torch.ones(4)}, x, train=True,
                        impl="lanes")


# ---------------- train-mode forward, loss, gradients ----------------


@functools.lru_cache(maxsize=None)
def _jax_step(jax_model, thr, channels_last, compute_dtype, convbn=None):
    """The JAX package's jitted loss and gradients; ``convbn`` keys the
    cache by the REMORA_TPU_CONVBN mode the caller set (read at trace)."""
    loss_fn = jax_train.make_loss_fn(
        jax_model, high_conf_incorrect_thr_frac=thr,
        compute_dtype=compute_dtype, channels_last=channels_last,
    )
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _batch(width, channels_last, n=24, seed=1):
    rng = np.random.default_rng(seed)
    sigs = rng.normal(size=(n, 1, width)).astype(np.float32)
    seqs = (rng.random((n, 36, width)) < 0.25).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    if channels_last:
        sigs, seqs = sigs.swapaxes(1, 2), seqs.swapaxes(1, 2)
    return sigs, seqs, labels


def _port_step(port_model, params, bn_state, sigs, seqs, labels, thr,
               channels_last, compute_dtype=None):
    model = port_model.init(size=16, kmer_len=9, num_out=3)
    model.load_state_dict(model_io.params_from_numpy(params, bn_state))
    loss_fn = train.make_loss_fn(model, high_conf_incorrect_thr_frac=thr,
                                 compute_dtype=compute_dtype,
                                 channels_last=channels_last)
    loss, n_filt = loss_fn(_t(sigs), _t(seqs), _t(labels).long())
    loss.backward()
    grads = {k.replace(".", "/"): p.grad for k, p in
             model.named_parameters() if p.grad is not None}
    return loss.item(), int(n_filt), grads, model_io.module_to_trees(model)[1]


@pytest.mark.parametrize("thr", [None, (0.3, 0.2)], ids=["nofilt", "filt"])
@pytest.mark.parametrize("arch,channels_last", [
    (arch, cl) for arch in ("ConvLSTM", "Conv", "ConvLSTM-fused")
    for cl in (False, True)
] + [("ConvLSTM-pallas", True), ("Conv-pallas", True)])
def test_train_loss_and_grads_match_jax(monkeypatch, arch, channels_last,
                                        thr):
    """f32: loss <= 1e-5, gradients <= 1e-4 relative (conv biases by an
    absolute bound), new BatchNorm statistics <= 1e-5. "ConvLSTM-fused"
    runs the LSTM through ``LSTMFused`` (K2/K3's plain versions) and the
    conv blocks through ``ConvBNSwish``; the "-pallas" cases run
    REMORA_TPU_CONVBN=pallas in both packages (K6's plain version against
    the Pallas kernel in interpret mode, in every stride-1 block)."""
    jax_model, port_model, width = ARCHS[arch.split("-")[0]]
    convbn = None
    if arch.endswith("fused"):
        monkeypatch.setattr(L, "lstm", functools.partial(L.lstm,
                                                         impl="fused"))
        convbn = "fused"
    elif arch.endswith("pallas"):
        convbn = "pallas"
    if convbn is not None:
        monkeypatch.setenv("REMORA_TPU_CONVBN", convbn)
    params, bn_state = _numpy_trees(port_model, 16, 9, 3, seed=5)
    sigs, seqs, labels = _batch(width, channels_last)
    (j_loss, (j_bn, j_filt)), j_grads = _jax_step(
        jax_model, thr, channels_last, None, convbn)(params, bn_state, sigs,
                                                     seqs, labels)
    launches = K.LAUNCHES_FWD
    loss, n_filt, grads, new_bn = _port_step(
        port_model, params, bn_state, sigs, seqs, labels, thr,
        channels_last)
    assert K.LAUNCHES_FWD == launches
    assert abs(loss - float(j_loss)) <= 1e-5
    assert n_filt == int(j_filt)
    if thr is not None:
        assert n_filt > 0  # the filter drops some examples
    j_flat = jax_io.flatten_tree(j_grads)
    # the zero-state cell step never reads lstm2's w_hh: no gradient here,
    # zeros in JAX (the train step fills in zeros)
    assert set(j_flat) - set(grads) <= {"lstm2/w_hh"}
    for key, want in j_flat.items():
        if key not in grads:
            assert not np.asarray(want).any()
        elif _is_conv_bias(key):
            assert np.abs(grads[key].numpy()).max() <= BIAS_NOISE, key
        else:
            assert _rel_err(grads[key], want) <= 1e-4, key
    for key, want in jax_io.flatten_tree(j_bn).items():
        got = model_io.flatten_tree(new_bn)[key]
        assert _rel_err(got, want) <= 1e-5, key


@pytest.mark.parametrize("arch", ["ConvLSTM", "Conv"])
def test_train_loss_and_grads_bf16(arch):
    """bf16 compute: both packages round at other places (XLA keeps excess
    precision inside fused elementwise chains), so the loss is held to
    2e-2 absolute, the gradients of the layers the loss reaches to 0.1 of
    their largest entry, and the new BatchNorm statistics (stored as f32
    from bf16) to 2e-2 relative."""
    jax_model, port_model, width = ARCHS[arch]
    params, bn_state = _numpy_trees(port_model, 16, 9, 3, seed=6)
    sigs, seqs, labels = _batch(width, True)
    (j_loss, (j_bn, _)), j_grads = _jax_step(
        jax_model, None, True, jnp.bfloat16)(params, bn_state, sigs, seqs,
                                             labels)
    loss, _, grads, new_bn = _port_step(
        port_model, params, bn_state, sigs, seqs, labels, None, True,
        torch.bfloat16)
    assert abs(loss - float(j_loss)) <= 2e-2
    for key, want in jax_io.flatten_tree(j_grads).items():
        if key in grads and not _is_conv_bias(key):
            assert grads[key].dtype == torch.float32
            assert _rel_err(grads[key], want) <= 0.1, key
    for key, want in jax_io.flatten_tree(j_bn).items():
        got = model_io.flatten_tree(new_bn)[key]
        assert got.dtype == np.float32
        assert _rel_err(got, want) <= 2e-2, key


# ---------------- optimizers ----------------


@pytest.mark.parametrize("name,kwargs", [
    ("adamw", (("weight_decay", 1e-2, "float"),)),
    ("adam", ()),
    ("sgd", (("momentum", 0.9, "float"),)),
])
def test_optimizers_match_optax(name, kwargs):
    """Identical gradients for three steps with a learning-rate change:
    params and optimizer state (as optax leaves) <= 1e-6."""
    rng = np.random.default_rng(0)
    tree = {"a": {"b": rng.normal(size=3), "w": rng.normal(size=(2, 3))},
            "fc": {"w": rng.normal(size=4)}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    opts = dict(optimizer_str=name, opt_kwargs=kwargs, learning_rate=0.01)
    tx = jax_optim.TrainOpts(**opts).load_optimizer()
    j_params = jax.tree.map(jnp.asarray, tree)
    j_state = tx.init(j_params)
    flat = model_io.flatten_tree(tree)
    t_params = [torch.nn.Parameter(_t(flat[k])) for k in sorted(flat)]
    opt = optim.TrainOpts(**opts).load_optimizer(t_params)
    for step, lr in enumerate((0.01, 0.01, 0.003)):
        grads = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        j_state = jax_train.set_learning_rate(j_state, lr)
        updates, j_state = tx.update(grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        train.set_learning_rate(opt, lr)
        g_flat = model_io.flatten_tree(grads)
        for p, k in zip(t_params, sorted(flat)):
            p.grad = _t(g_flat[k])
        opt.step()
        want = jax_io.flatten_tree(j_params)
        for p, k in zip(t_params, sorted(flat)):
            assert np.abs(p.detach().numpy() - want[k]).max() <= 1e-6
        got = optim.optimizer_leaves(opt, t_params, step + 1)
        leaves = jax.tree_util.tree_leaves(j_state)
        assert len(got) == len(leaves)
        for g, w in zip(got, leaves):
            assert g.dtype == np.asarray(w).dtype and g.shape == w.shape
            assert np.abs(g - np.asarray(w)).max() <= 1e-6


def test_rolling_mad_matches_jax():
    rng = np.random.default_rng(3)
    port, ref = optim.RollingMAD(4, 2.0, window=5), \
        jax_optim.RollingMAD(4, 2.0, window=5)
    for _ in range(9):
        vals = rng.random(4).tolist()
        got, want = port.update(vals), ref.update(vals)
        assert (got is None) == (want is None)
        if want is not None:
            assert np.array_equal(got, want)
    assert optim.med_mad(np.arange(9.0)) == jax_optim.med_mad(np.arange(9.0))
    sched = optim.TrainOpts(epochs=6).load_scheduler()
    jsched = jax_optim.TrainOpts(epochs=6).load_scheduler()
    assert [sched(e) for e in range(6)] == [jsched(e) for e in range(6)]


# ---------------- train_model end to end ----------------


@pytest.fixture(scope="module")
def synth_config(tmp_path_factory):
    """Two synthetic members (one written by each package), a config, and
    a seeded size-16 ConvLSTM checkpoint both packages fine-tune from."""
    root = tmp_path_factory.mktemp("train")
    a = write_synth_dataset("jax", root / "a", 120, seed=2)
    b = write_synth_dataset("port", root / "b", 100, seed=3)
    config = write_config(root / "cfg.jsn", [(a, 1), (b, 1)])
    params, bn_state = _numpy_trees(conv_lstm_model, 16, 9, 2, seed=8)
    init = root / "init.npz"
    meta = {"model_name": "ConvLSTM_w_ref", "chunk_context": [25, 25],
            "kmer_context_bases": [4, 4], "motifs": [["CG", 0]],
            "mod_bases": ["m"], "mod_long_names": ["5mC"],
            "model_params": {"size": 16, "kmer_len": 9, "num_out": 2}}
    jax_io.save_model(init, params, bn_state, meta)
    return root, config, str(init)


def _run(pkg, out, config, opts, **kw):
    args = dict(seed=5, out_path=str(out), remora_dataset_path=config,
                chunk_context=(25, 25), kmer_context_bases=(4, 4),
                batch_size=32, model_name="ConvLSTM_w_ref", size=16,
                chunks_per_epoch=96, num_test_chunks=32)
    args.update(kw)
    if pkg == "jax":
        return jax_train.train_model(
            train_opts=jax_optim.TrainOpts(**opts), **args)
    return train.train_model(train_opts=optim.TrainOpts(**opts),
                             device="cpu", **args)


def _table(path):
    with open(path) as fh:
        rows = [line.rstrip("\n").split("\t") for line in fh]
    return rows[0], rows[1:]


def _same_logs(got_dir, want_dir, tol=1e-4):
    head, got = _table(os.path.join(got_dir, "batch.log"))
    assert head == _table(os.path.join(want_dir, "batch.log"))[0]
    want = _table(os.path.join(want_dir, "batch.log"))[1]
    assert [r[0] for r in got] == [r[0] for r in want]
    assert np.abs(np.array([float(r[1]) for r in got])
                  - np.array([float(r[1]) for r in want])).max() <= tol
    head, got = _table(os.path.join(got_dir, "validation.log"))
    want = _table(os.path.join(want_dir, "validation.log"))[1]
    assert len(got) == len(want)
    cols = {name: i for i, name in enumerate(head)}
    for g, w in zip(got, want):
        for name in ("Val_Type", "Epoch", "Iteration", "Accuracy",
                     "Confusion_Matrix", "Num_Calls"):
            assert g[cols[name]] == w[cols[name]], name
        assert abs(float(g[cols["Loss"]]) - float(w[cols["Loss"]])) <= tol


SGD = dict(epochs=2, optimizer_str="sgd", learning_rate=0.05,
           lr_scheduler_str="constant")
ADAMW = dict(epochs=1, optimizer_str="adamw", learning_rate=0.01,
             lr_scheduler_str="constant")


def test_train_model_matches_jax(synth_config):
    root, config, init = synth_config
    for pkg in ("jax", "port"):
        _run(pkg, root / f"sgd_{pkg}", config, SGD, finetune_path=init)
    _same_logs(root / "sgd_port", root / "sgd_jax")
    for name in ("epoch_summary.txt", "dataset_config.jsn"):
        with open(root / "sgd_port" / name) as g, \
                open(root / "sgd_jax" / name) as w:
            assert g.read() == w.read()
    # the final checkpoints: the same weights (conv biases aside: SGD moves
    # them by lr x noise) and metadata
    _, j_params, j_bn, j_meta = jax_io.load_model(
        root / "sgd_jax" / "model_final.checkpoint")
    model, meta = model_io.load_model(root / "sgd_port" /
                                      "model_final.checkpoint")
    p_params, p_bn = model_io.module_to_trees(model)
    for tree, want in ((p_params, j_params), (p_bn, j_bn)):
        want = jax_io.flatten_tree(want)
        for key, got in model_io.flatten_tree(tree).items():
            assert _rel_err(got, want[key]) <= 1e-4, key
    assert meta["epoch"] == j_meta["epoch"] == 2
    assert np.array_equal(meta["sig_map_refiner"].sd_arr,
                          j_meta["sig_map_refiner"].sd_arr)


def test_adamw_checkpoints_resume_across_packages(synth_config):
    """An AdamW run saved by the JAX package resumes in the port and vice
    versa: the optimizer state is read back leaf for leaf, and the port's
    resumed epoch logs the JAX package's resumed epoch's losses."""
    root, config, init = synth_config
    _run("jax", root / "adamw_jax", config, ADAMW, finetune_path=init)
    ckpt = root / "adamw_jax" / "model_final.checkpoint"
    resumed = dict(ADAMW, epochs=2)
    _run("port", root / "resume_port", config, resumed,
         resume_from_checkpoint=str(ckpt))
    _run("jax", root / "resume_jax", config, resumed,
         resume_from_checkpoint=str(ckpt))
    _same_logs(root / "resume_port", root / "resume_jax", tol=1e-3)

    # the port's checkpoint (epoch 2, 6 updates) into a fresh optax state
    port_ckpt = root / "resume_port" / "model_final.checkpoint"
    _, j_params, _, j_meta = jax_io.load_model(port_ckpt)
    assert j_meta["epoch"] == 2
    tx = jax_optim.TrainOpts(**resumed).load_optimizer()
    state = jax_io.load_opt_state(port_ckpt, tx.init(j_params))
    leaves = model_io.load_opt_state(port_ckpt)
    for got, want in zip(jax.tree_util.tree_leaves(state), leaves):
        assert np.array_equal(np.asarray(got), want)
    assert int(leaves[0]) == 6
    # and the JAX package's into the port's optimizer
    model, _ = model_io.load_model(ckpt)
    params = [p for _, p in train.sorted_params(model)]
    opt = optim.TrainOpts(**ADAMW).load_optimizer(params)
    stored = model_io.load_opt_state(ckpt)
    assert optim.load_optimizer_leaves(opt, params, stored) == 3
    for got, want in zip(optim.optimizer_leaves(opt, params, 3), stored):
        assert np.array_equal(got, want)
    with pytest.raises(RemoraError, match="leaves expected"):
        optim.load_optimizer_leaves(
            optim.TrainOpts(optimizer_str="sgd").load_optimizer(params),
            params, stored)


def test_train_model_options(synth_config, monkeypatch):
    """Freezing, the filter, gradient clipping, host featurization and an
    external validation set run; unported options and a missing GPU
    raise."""
    root, config, init = synth_config
    out = root / "opts"
    _run("port", out, config, dict(SGD, epochs=1), finetune_path=init,
         freeze_num_layers=4, high_conf_incorrect_thr_frac=(0.3, 0.2),
         gradient_clip_num_mads=3.0, featurize_on_device=False,
         ext_val=[config], ext_val_names=["again"])
    _, rows = _table(out / "validation.log")
    assert [r[0] for r in rows] == ["val", "trn", "again"] * 2
    assert (out / "model_ext_val_again_best.checkpoint").is_file()
    model, _ = model_io.load_model(out / "model_final.checkpoint")
    frozen = dict(train.sorted_params(model)[:4])
    init_model, _ = model_io.load_model(init)
    for name, p in train.sorted_params(init_model)[:4]:
        assert torch.equal(frozen[name], p), name
    head, rows = _table(out / "batch.log")
    assert head == ["Iteration", "Loss", "NumberFiltered"]
    assert len(rows) == 3
    for kw in ({"mesh": object()}, {"sync_bn": True}):
        with pytest.raises(RemoraError, match="item 7"):
            _run("port", root / "x", config, SGD, **kw)
    monkeypatch.setenv("REMORA_TPU_CONVBN", "lanes")
    with pytest.raises(RemoraError, match="unknown REMORA_TPU_CONVBN"):
        _run("port", root / "x", config, SGD)
    if not torch.cuda.is_available():
        with pytest.raises(RemoraError, match="no CUDA device"):
            train.train_model(
                seed=1, out_path=str(root / "x"),
                remora_dataset_path=config, chunk_context=None,
                kmer_context_bases=None, batch_size=32,
                model_name="ConvLSTM_w_ref", size=16,
                train_opts=optim.TrainOpts(), chunks_per_epoch=32,
                num_test_chunks=32)


def _read(path):
    with open(path) as fh:
        return fh.read()


@pytest.fixture(scope="module")
def window_config(synth_config):
    """Two members of 144 chunks read in super batches of 64: every batch
    holds 32 chunks, so each window stacks (the JAX package's window
    cannot stack the short batch that ends a super batch)."""
    root, _, init = synth_config
    members = [(write_synth_dataset(pkg, root / f"w{pkg}", 144, seed=s), 1)
               for pkg, s in (("jax", 4), ("port", 5))]
    return root, write_config(root / "window.jsn", members), init


def test_train_model_steps_per_launch(window_config, synth_config):
    """``steps_per_launch=3`` over 4 batches an epoch (a window of 3, then
    one single step), SGD with gradient clipping set: batch.log and
    validation.log within 1e-4 of the JAX package's same run. Without
    clipping, identical to the port's one-step-a-call run, logs and final
    weights, here and on a config whose short batches break windows up."""
    root, config, init = window_config
    kw = dict(finetune_path=init, chunks_per_epoch=128, steps_per_launch=3,
              super_batch_size=64)
    for pkg in ("jax", "port"):
        _run(pkg, root / f"spl_{pkg}", config, SGD,
             gradient_clip_num_mads=3.0, **kw)
    _same_logs(root / "spl_port", root / "spl_jax")
    _, rows = _table(root / "spl_port" / "batch.log")
    assert [r[0] for r in rows] == [str(i) for i in range(8)]

    ragged = synth_config[1]
    for cfg, tag, extra in ((config, "w", {}),
                            (ragged, "r", {"super_batch_size": None})):
        for spl in (3, 1):
            args = dict(kw, steps_per_launch=spl, **extra)
            if args["super_batch_size"] is None:
                del args["super_batch_size"]
            _run("port", root / f"spl{spl}{tag}", cfg, SGD, **args)
        for name in ("batch.log", "validation.log"):
            assert _read(root / f"spl3{tag}" / name) == \
                _read(root / f"spl1{tag}" / name)
        models = [model_io.load_model(root / f"spl{spl}{tag}" /
                                      "model_final.checkpoint")[0]
                  for spl in (3, 1)]
        for (name, a), (_, b) in zip(*(train.sorted_params(m)
                                       for m in models)):
            assert torch.equal(a, b), name


def test_train_model_writes_first_epoch_trace(synth_config, monkeypatch):
    """REMORA_TPU_JAX_TRACE_DIR: a torch.profiler Chrome trace of epoch 0
    (the JAX package's first-epoch device trace under the same variable)."""
    import json

    root, config, init = synth_config
    trace_dir = root / "trace"
    monkeypatch.setenv("REMORA_TPU_JAX_TRACE_DIR", str(trace_dir))
    _run("port", root / "traced", config, dict(SGD, epochs=1),
         finetune_path=init)
    traces = sorted(trace_dir.iterdir())
    assert [p.name for p in traces] == ["train_epoch0.trace.json"]
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("conv1d" in str(e.get("name", "")) for e in events)
