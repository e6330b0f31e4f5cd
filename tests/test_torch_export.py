"""The port's model export (``models/export.py``), TorchScript import
(``models/model_io.py``) and model registry against the JAX package's,
on the CPU, through both CLIs' ``model export`` and ``model inspect``.

- ``model export --format dorado``: the JAX exporter's file set, every
  ``.tensor`` bit-equal, ``config.toml`` identical but for
  ``creation_date`` (a plain checkpoint and one carrying a refiner);
- ``model export --format torchscript``: each package's ``.pt`` loads in
  the other's ``load_torchscript_model`` with bit-equal parameters and
  equal metadata; the scripted module's logits are within 1e-5 of the
  port's eval forward; a JAX-exported ``.pt`` served through the port's
  ``ModelHandle.load`` (``infer --model x.pt``) writes its ``.npz``'s
  tags;
- the registry: a model file of the port's contract and a reference-style
  ``network`` file load through ``--model``/``--model-path``; an unknown
  file raises.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import bench
from chip_smoke import synth_level_table
from remora_tpu.models import model_io as jax_io
from remora_tpu_torch import RemoraError
from remora_tpu_torch.infer.infer import ModelHandle
from remora_tpu_torch.kernels.encoded_kmers import compute_encoded_kmer_batch
from remora_tpu_torch.models import model_io

from tests.test_torch_cli import CLIS, CPU, run_port_cli
from tests.test_torch_cli import _no_index_cache  # noqa: F401 (autouse)
from tests.test_torch_infer_pipeline import (CTX, KMER_LEN,
                                             assert_identical_outputs,
                                             write_model)
from tests.test_torch_io import jax_native_loaded  # noqa: F401 (autouse)
from tests.test_torch_io import write_test_set


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_export")


@pytest.fixture(scope="module")
def models(workdir):
    """{kind: .npz path}: a plain size-16 checkpoint and one carrying a
    9-mer refiner (rough rescale, one DP round), both written by the JAX
    package."""
    from remora_tpu.refine.refiner import SigMapRefiner

    table, center = synth_level_table(KMER_LEN)
    refiner = SigMapRefiner(_levels_array=table, center_idx=center,
                            do_rough_rescale=True, scale_iters=0)
    return {"plain": write_model(workdir, "plain16.npz"),
            "refine": write_model(workdir, "refine16.npz", refiner=refiner)}


@pytest.fixture(scope="module")
def exports(workdir, models):
    """{(kind, format, package): path} of every export through each
    package's CLI."""
    out = {}
    for kind, path in models.items():
        for fmt, suffix in (("dorado", ""), ("torchscript", ".pt")):
            for package, run in CLIS.items():
                dest = workdir / f"{kind}_{fmt}_{package}{suffix}"
                run("model", "export", path, dest, "--format", fmt)
                out[(kind, fmt, package)] = dest
    return out


def _tensor(path):
    return torch.jit.load(str(path), map_location="cpu").state_dict()["0"]


@pytest.mark.parametrize("kind", ["plain", "refine"])
def test_dorado_export_matches_jax(kind, exports):
    got, want = (exports[(kind, "dorado", p)] for p in ("port", "jax"))
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names
    assert ("refine_kmer_levels.tensor" in names) == (kind == "refine")
    n_tensors = 0
    for name in names:
        if name.endswith(".tensor"):
            g, w = _tensor(got / name), _tensor(want / name)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert np.array_equal(g.numpy().view(np.uint8),
                                  w.numpy().view(np.uint8)), name
            n_tensors += 1
    # 6 fused convs and the head (2 each), 2 LSTMs (4 each)
    assert n_tensors == 22 + (kind == "refine")

    def config(path):
        return [line for line in (path / "config.toml").read_text()
                .splitlines() if not line.startswith("creation_date")]

    assert config(got) == config(want)
    assert 'model = "conv_lstm"' in config(want)


def _refiner_fields(smr):
    return {k: (np.asarray(v).tolist() if v is not None else None)
            for k, v in smr.asdict().items()}


def _meta_fields(meta):
    """Metadata as comparable values: the refiner by its serialized
    fields, the creation date left out."""
    out = {}
    for key, value in meta.items():
        if key == "creation_date":
            continue
        if key == "sig_map_refiner":
            value = _refiner_fields(value)
        elif isinstance(value, np.ndarray):
            value = value.tolist()
        out[key] = value
    return out


def _flat(tree):
    return {k: np.asarray(v) for k, v in jax_io.flatten_tree(tree).items()}


@pytest.mark.parametrize("kind", ["plain", "refine"])
def test_torchscript_exports_cross_load(kind, exports, models):
    """Both packages' ``.pt`` files load in both packages' loaders to the
    same parameters, bit for bit, and the same metadata; the parameters
    are the checkpoint's."""
    _m, params, bn_state, _meta = jax_io.load_model(models[kind])
    want = {**_flat(params), **_flat(bn_state)}
    metas = []
    for exporter in ("jax", "port"):
        path = str(exports[(kind, "torchscript", exporter)])
        _jm, jp, jbn, jmeta = jax_io.load_torchscript_model(path)
        pmodel, pmeta = model_io.load_torchscript_model(path)
        pp, pbn = model_io.module_to_trees(pmodel)
        for got in ({**_flat(jp), **_flat(jbn)}, {**_flat(pp), **_flat(pbn)}):
            assert got.keys() == want.keys()
            for key, value in want.items():
                assert got[key].dtype == value.dtype, key
                assert np.array_equal(got[key], value), (exporter, key)
        metas += [_meta_fields(jmeta), _meta_fields(pmeta)]
    assert all(m == metas[0] for m in metas[1:])
    assert metas[0]["sig_map_refiner"]["refine_do_rough_rescale"] == (
        kind == "refine")


def test_scripted_module_matches_port_forward(exports, models):
    """The port's TorchScript program (plain torch layers, full LSTMs)
    against the port's eval forward (last-only K1 path) on seeded
    chunks."""
    width = sum(CTX)
    sigs, seqs, maps, lens = (torch.from_numpy(a) for a in
                              bench._synth_inputs(256, width, KMER_LEN)[:4])
    enc = compute_encoded_kmer_batch(4, 4, seqs, maps, lens, width)
    net = torch.jit.load(str(exports[("plain", "torchscript", "port")]))
    handle = ModelHandle.load(models["plain"], device="cpu")
    with torch.no_grad():
        got = net(sigs, enc)
        want = handle.model(sigs, enc)
    err = (got - want).abs().max().item()
    assert err <= 1e-5, err
    assert want.std().item() > 0.1


def test_jax_exported_pt_serves_through_port(exports, models, workdir):
    """``infer from_pod5_and_bam --model x.pt`` (the JAX package's
    TorchScript export) writes the same tags as the same checkpoint's
    ``.npz``."""
    sub = workdir / "set"
    sub.mkdir()
    pod5, bam = write_test_set(sub)
    outs = {}
    for tag, model in (("npz", models["plain"]),
                       ("pt", exports[("plain", "torchscript", "jax")])):
        outs[tag] = workdir / f"serve_{tag}.bam"
        run_port_cli("infer", "from_pod5_and_bam", pod5, bam, "--model",
                     model, "--out-bam", outs[tag], "--batch-size", "64",
                     *CPU)
    want, n_calls = assert_identical_outputs(outs["pt"], outs["npz"])
    assert len(want) > 5 and n_calls > 64
    handle = ModelHandle.load(exports[("plain", "torchscript", "jax")],
                              device="cpu")
    assert type(handle.model).__name__ == "ConvLSTM_w_ref"


# ---------------- the registry ----------------

PORT_NATIVE = '''
import torch
from remora_tpu_torch.models import conv_lstm_model


class Doubled(conv_lstm_model.ConvLSTM_w_ref):
    def forward(self, *args, **kwargs):
        return 2 * super().forward(*args, **kwargs)


def init(generator=None, size=64, kmer_len=9, num_out=2,
         dtype=torch.float32, device=None):
    return Doubled(size, kmer_len, num_out, generator, dtype, device)
'''

REFERENCE_STYLE = '''
from torch import nn


class network(nn.Module):
    def __init__(self, size=64, kmer_len=9, num_out=2):
        super().__init__()
        self.sig_conv1 = nn.Conv1d(1, 4, 5)
        self.merge_conv1 = nn.Conv1d(size * 2, size, 5)
        self.lstm1 = nn.LSTM(size, size, 1)
        self.fc = nn.Linear(size, num_out)
'''

UNMAPPED = REFERENCE_STYLE.replace("lstm1", "gru1")


@pytest.fixture(scope="module")
def model_files(workdir):
    out = {}
    for name, text in (("native", PORT_NATIVE), ("reference", REFERENCE_STYLE),
                       ("unmapped", UNMAPPED), ("empty", "X = 1\n")):
        out[name] = workdir / f"{name}_arch.py"
        out[name].write_text(text)
    return out


def test_model_path_loads_model_files(models, model_files, capsys):
    path = models["plain"]
    base, _meta = model_io.load_model(path)
    native, _meta = model_io.load_model(path, model_path=model_files["native"])
    ref, _meta = model_io.load_model(path,
                                     model_path=model_files["reference"])
    assert type(native).__name__ == "Doubled"
    assert type(ref).__name__ == "ConvLSTM_w_ref"
    width = sum(CTX)
    sigs, seqs, maps, lens = (torch.from_numpy(a) for a in
                              bench._synth_inputs(16, width, KMER_LEN)[:4])
    enc = compute_encoded_kmer_batch(4, 4, seqs, maps, lens, width)
    with torch.no_grad():
        assert torch.equal(native.eval()(sigs, enc), 2 * base.eval()(sigs, enc))
        assert torch.equal(ref.eval()(sigs, enc), base(sigs, enc))
    for name in ("native", "reference"):
        run_port_cli("model", "inspect", path, "--model-path",
                     model_files[name])
        assert "num_params" in capsys.readouterr().out
    for name, match in (("unmapped", "Cannot map"),
                        ("empty", "neither init nor")):
        with pytest.raises(RemoraError, match=match):
            model_io.load_model(path, model_path=model_files[name])
    with pytest.raises(RemoraError, match="Unknown model"):
        model_io.load_model(path, model_path="NoSuchModel")


def test_model_train_takes_a_model_file(model_files, workdir):
    """``model train --model file.py``: the checkpoint records the file,
    and ``--model`` of ``infer`` and ``load_model`` load it back through
    it."""
    from tests.test_torch_data import write_synth_dataset

    ds = write_synth_dataset("port", workdir / "train_ds", 96, seed=3)
    cfg = workdir / "train.cfg"
    cfg.write_text(f'[["{ds}", 1.0]]')
    out = workdir / "train_native"
    run_port_cli("model", "train", cfg, "--output-path", out, *CPU,
                 "--model", model_files["native"], "--size", "8",
                 "--batch-size", "16", "--epochs", "1",
                 "--chunks-per-epoch", "32", "--num-test-chunks", "16",
                 "--seed", "1", "--scheduler", "constant")
    ckpt = out / "model_final.checkpoint"
    model, meta = model_io.load_model(ckpt)
    assert meta["model_name"] == str(model_files["native"])
    assert type(model).__name__ == "Doubled"
    handle = ModelHandle.load(ckpt, device="cpu")
    assert type(handle.model).__name__ == "Doubled"


def test_repr_and_arch_helpers_match_jax(models):
    _m, params, _bn, jmeta = jax_io.load_model(models["plain"])
    _model, pmeta = model_io.load_model(models["plain"])
    drop = ("sig_map_refiner",)
    assert model_io.repr_model_metadata(
        {k: v for k, v in pmeta.items() if k not in drop}) == \
        jax_io.repr_model_metadata(
            {k: v for k, v in jmeta.items() if k not in drop})
    sd = model_io.params_to_torch_state_dict(params, _bn)
    assert {k: v.shape for k, v in sd.items()} == {
        k: v.shape for k, v in jax_io.params_to_torch_state_dict(
            params, _bn).items()}
    back, bn_back = model_io.torch_state_dict_to_params(sd)
    assert _flat(back).keys() == _flat(params).keys()
    assert model_io.conv_arch_from_params(params).NAME == "ConvLSTM_w_ref"
    with pytest.raises(RemoraError, match="Unknown layer setup"):
        model_io.conv_arch_from_params({"fc": {}})
    assert dataclasses.is_dataclass(pmeta["sig_map_refiner"])
