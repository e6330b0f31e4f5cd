"""Model export: Dorado directory format + TorchScript.

Counterpart of ``remora_tpu/models/export.py`` (reference analogs
``model_util.export_model_dorado`` and ``export_model_torchscript``).
The checkpoint's module is read back as (params, bn_state) arrays and
Conv+BN fusion is computed on them in NumPy, as the JAX package does, so
the two packages write the same tensors. The TorchScript program is a
plain ``nn.Conv1d``/``nn.BatchNorm1d``/``nn.LSTM``/``nn.Linear`` module
under Remora's layer names, built on the CPU: the package's own module
calls the CUDA kernel wrappers and is never scripted.
"""

import datetime
import json
import os

import numpy as np

from remora_tpu_torch import RemoraError, log
from remora_tpu_torch.models import model_io

LOGGER = log.get_logger()

_CONV_TO_BN = {
    "sig_conv1": "sig_bn1",
    "sig_conv2": "sig_bn2",
    "sig_conv3": "sig_bn3",
    "seq_conv1": "seq_bn1",
    "seq_conv2": "seq_bn2",
    "seq_conv3": "seq_bn3",
    "merge_conv1": ("merge_bn", "merge_bn1"),
    "merge_conv2": "merge_bn2",
    "merge_conv3": "merge_bn3",
    "merge_conv4": "merge_bn4",
}

_LSTM_MODEL_LAYERS = {
    "sig_conv1", "sig_conv2", "sig_conv3", "seq_conv1", "seq_conv2",
    "merge_conv1", "lstm1", "lstm2", "fc",
}
_CONV_MODEL_LAYERS = {
    "sig_conv1", "sig_conv2", "sig_conv3", "seq_conv1", "seq_conv2",
    "seq_conv3", "merge_conv1", "merge_conv2", "merge_conv3", "merge_conv4",
    "fc",
}


def _load_trees(checkpoint_path, model_path):
    """(params, bn_state, metadata) of a model artifact: its module's
    parameters and buffers as arrays in the JAX package's layout."""
    model, meta = model_io.load_model(checkpoint_path, model_path=model_path)
    return (*model_io.module_to_trees(model), meta)


def fuse_conv_bn(conv, bn_params, bn_state, eps=1e-5):
    """Fold batchnorm into the preceding conv's weight/bias."""
    scale = np.asarray(bn_params["gamma"]) / np.sqrt(
        np.asarray(bn_state["var"]) + eps
    )
    w = np.asarray(conv["w"]) * scale[:, None, None]
    b = (np.asarray(conv["b"]) - np.asarray(bn_state["mean"])) * scale + (
        np.asarray(bn_params["beta"])
    )
    return {"w": w, "b": b}


def _toml_value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    if v is None:
        return '""'
    return json.dumps(str(v))


def write_toml(path, data):
    """Minimal TOML writer for nested dicts of scalars/lists."""
    with open(path, "w") as fh:
        scalars = {k: v for k, v in data.items() if not isinstance(v, dict)}
        for k, v in scalars.items():
            fh.write(f"{k} = {_toml_value(v)}\n")
        for section, values in data.items():
            if not isinstance(values, dict):
                continue
            fh.write(f"\n[{section}]\n")
            for k, v in values.items():
                if isinstance(v, (list, tuple)):
                    fh.write(
                        f"{k} = [{', '.join(_toml_value(x) for x in v)}]\n"
                    )
                else:
                    fh.write(f"{k} = {_toml_value(v)}\n")


def export_model_dorado(checkpoint_path, save_dir, model_path=None):
    """Export a native checkpoint to the Dorado modbase-model directory."""
    import torch
    from torch import nn

    params, bn_state, meta = _load_trees(checkpoint_path, model_path)
    save_dir = os.path.expanduser(save_dir)
    os.makedirs(save_dir, exist_ok=True)

    def save_tensor(fn, x):
        m = torch.nn.Module()
        par = nn.Parameter(torch.from_numpy(np.ascontiguousarray(x)),
                           requires_grad=False)
        m.register_parameter("0", par)
        torch.jit.script(m).save(f"{save_dir}/{fn}.tensor")
        LOGGER.info(f"{save_dir}/{fn}.tensor")

    layer_names = set()
    for name, p in params.items():
        if "bn" in name:
            continue
        if name in _CONV_TO_BN:
            bn_names = _CONV_TO_BN[name]
            if isinstance(bn_names, tuple):
                bn_name = next(b for b in bn_names if b in params)
            else:
                bn_name = bn_names
            fused = fuse_conv_bn(p, params[bn_name], bn_state[bn_name])
            save_tensor(f"{name}.weight", fused["w"])
            save_tensor(f"{name}.bias", fused["b"])
        elif name.startswith("lstm"):
            save_tensor(f"{name}.weight_ih_l0", np.asarray(p["w_ih"]))
            save_tensor(f"{name}.weight_hh_l0", np.asarray(p["w_hh"]))
            save_tensor(f"{name}.bias_ih_l0", np.asarray(p["b_ih"]))
            save_tensor(f"{name}.bias_hh_l0", np.asarray(p["b_hh"]))
        else:
            save_tensor(f"{name}.weight", np.asarray(p["w"]))
            save_tensor(f"{name}.bias", np.asarray(p["b"]))
        layer_names.add(name)

    general = {
        "creation_date": datetime.datetime.now().strftime(
            "%m/%d/%Y, %H:%M:%S"
        )
    }
    if layer_names == _CONV_MODEL_LAYERS:
        general["model"] = "conv_only"
    elif layer_names == _LSTM_MODEL_LAYERS:
        general["model"] = "conv_lstm"
    else:
        LOGGER.warning("Unknown layer setup in export")
        general["model"] = "unknown"

    smr = meta["sig_map_refiner"]
    refinement = {"refine_do_rough_rescale": int(smr.do_rough_rescale)}
    if smr.do_rough_rescale:
        refinement["refine_kmer_center_idx"] = int(smr.center_idx)
        save_tensor(
            "refine_kmer_levels", smr.levels_array.astype(np.float32)
        )

    modbases = {
        "mod_bases": "".join(meta["mod_bases"]),
        "offset": meta["offset"],
        "reverse_signal": meta["reverse_signal"],
        "pa_scaling": list(meta["pa_scaling"]) if meta["pa_scaling"] else "",
    }
    for i, mln in enumerate(meta["mod_long_names"]):
        modbases[f"mod_long_names_{i}"] = str(mln)
    for key in ("chunk_context", "kmer_context_bases"):
        for idx in range(2):
            modbases[f"{key}_{idx}"] = meta[key][idx]
    if len(meta["motifs"]) > 1:
        raise RemoraError("Dorado only supports models with a single motif")
    for motif, motif_offset in meta["motifs"]:
        modbases["motif"] = motif
        modbases["motif_offset"] = motif_offset

    write_toml(
        os.path.join(save_dir, "config.toml"),
        {
            "general": general,
            "model_params": meta["model_params"],
            "modbases": modbases,
            "refinement": refinement,
        },
    )
    LOGGER.info(f"Dorado model exported to {save_dir}")


def _build_torch_module(params, bn_state, meta):
    """Reference Remora's nn.Module (plain torch layers) holding
    ``params`` and ``bn_state``, in eval mode on the CPU."""
    import torch
    from torch import nn

    size = meta["model_params"]["size"]
    kmer_len = meta["model_params"]["kmer_len"]
    num_out = meta["model_params"]["num_out"]
    is_lstm = "lstm1" in params

    class LstmNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.sig_conv1 = nn.Conv1d(1, 4, 5)
            self.sig_bn1 = nn.BatchNorm1d(4)
            self.sig_conv2 = nn.Conv1d(4, 16, 5)
            self.sig_bn2 = nn.BatchNorm1d(16)
            self.sig_conv3 = nn.Conv1d(16, size, 9, 3)
            self.sig_bn3 = nn.BatchNorm1d(size)
            self.seq_conv1 = nn.Conv1d(kmer_len * 4, 16, 5)
            self.seq_bn1 = nn.BatchNorm1d(16)
            self.seq_conv2 = nn.Conv1d(16, size, 13, 3)
            self.seq_bn2 = nn.BatchNorm1d(size)
            self.merge_conv1 = nn.Conv1d(size * 2, size, 5)
            self.merge_bn = nn.BatchNorm1d(size)
            self.lstm1 = nn.LSTM(size, size, 1)
            self.lstm2 = nn.LSTM(size, size, 1)
            self.fc = nn.Linear(size, num_out)
            self.dropout = nn.Dropout(p=0.3)

        def forward(self, sigs, seqs):
            x = self.sig_bn1(self.sig_conv1(sigs))
            x = x * torch.sigmoid(x)
            x = self.sig_bn2(self.sig_conv2(x))
            x = x * torch.sigmoid(x)
            x = self.sig_bn3(self.sig_conv3(x))
            x = x * torch.sigmoid(x)
            y = self.seq_bn1(self.seq_conv1(seqs))
            y = y * torch.sigmoid(y)
            y = self.seq_bn2(self.seq_conv2(y))
            y = y * torch.sigmoid(y)
            z = torch.cat((x, y), 1)
            z = self.merge_bn(self.merge_conv1(z))
            z = z * torch.sigmoid(z)
            z = z.permute(2, 0, 1)
            z = self.lstm1(z)[0]
            z = z * torch.sigmoid(z)
            z = self.lstm2(torch.flip(z, (0,)))[0]
            z = torch.flip(z * torch.sigmoid(z), (0,))
            z = z[-1]
            return self.fc(z)

    class ConvNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.sig_conv1 = nn.Conv1d(1, 4, 11)
            self.sig_bn1 = nn.BatchNorm1d(4)
            self.sig_conv2 = nn.Conv1d(4, 16, 11)
            self.sig_bn2 = nn.BatchNorm1d(16)
            self.sig_conv3 = nn.Conv1d(16, size, 9, 3)
            self.sig_bn3 = nn.BatchNorm1d(size)
            self.seq_conv1 = nn.Conv1d(kmer_len * 4, 16, 11)
            self.seq_bn1 = nn.BatchNorm1d(16)
            self.seq_conv2 = nn.Conv1d(16, 32, 11)
            self.seq_bn2 = nn.BatchNorm1d(32)
            self.seq_conv3 = nn.Conv1d(32, size, 9, 3)
            self.seq_bn3 = nn.BatchNorm1d(size)
            self.merge_conv1 = nn.Conv1d(size * 2, size, 5)
            self.merge_bn1 = nn.BatchNorm1d(size)
            self.merge_conv2 = nn.Conv1d(size, size, 5)
            self.merge_bn2 = nn.BatchNorm1d(size)
            self.merge_conv3 = nn.Conv1d(size, size, 3, stride=2)
            self.merge_bn3 = nn.BatchNorm1d(size)
            self.merge_conv4 = nn.Conv1d(size, size, 3, stride=2)
            self.merge_bn4 = nn.BatchNorm1d(size)
            self.fc = nn.Linear(size * 3, num_out)

        def forward(self, sigs, seqs):
            x = self.sig_bn1(self.sig_conv1(sigs))
            x = x * torch.sigmoid(x)
            x = self.sig_bn2(self.sig_conv2(x))
            x = x * torch.sigmoid(x)
            x = self.sig_bn3(self.sig_conv3(x))
            x = x * torch.sigmoid(x)
            y = self.seq_bn1(self.seq_conv1(seqs))
            y = y * torch.sigmoid(y)
            y = self.seq_bn2(self.seq_conv2(y))
            y = y * torch.sigmoid(y)
            y = self.seq_bn3(self.seq_conv3(y))
            y = y * torch.sigmoid(y)
            z = self.merge_bn1(self.merge_conv1(torch.cat((x, y), 1)))
            z = z * torch.sigmoid(z)
            z = self.merge_bn2(self.merge_conv2(z))
            z = z * torch.sigmoid(z)
            z = self.merge_bn3(self.merge_conv3(z))
            z = z * torch.sigmoid(z)
            z = self.merge_bn4(self.merge_conv4(z))
            z = z * torch.sigmoid(z)
            z = torch.flatten(z, start_dim=1)
            return self.fc(z)

    net = LstmNet() if is_lstm else ConvNet()
    sd = model_io.params_to_torch_state_dict(params, bn_state)
    net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()})
    net.eval()
    return net


def export_model_torchscript(checkpoint_path, save_filename,
                             model_path=None):
    """Export a native checkpoint as reference-compatible TorchScript."""
    import torch

    params, bn_state, meta = _load_trees(checkpoint_path, model_path)
    net = _build_torch_module(params, bn_state, meta)
    m = torch.jit.script(net)

    smr = meta["sig_map_refiner"]
    ts_meta = {
        "creation_date": datetime.datetime.now().strftime(
            "%m/%d/%Y, %H:%M:%S"
        ),
        "kmer_context_bases": list(meta["kmer_context_bases"]),
        "chunk_context": list(meta["chunk_context"]),
        "modified_base_labels": meta["modified_base_labels"],
        "mod_bases": "".join(meta["mod_bases"]) or None,
        "reverse_signal": meta["reverse_signal"],
        "refine_kmer_center_idx": int(smr.center_idx),
        "refine_do_rough_rescale": bool(smr.do_rough_rescale),
        "refine_scale_iters": int(smr.scale_iters),
        "refine_algo": smr.algo,
        "refine_half_bandwidth": int(smr.half_bandwidth),
        "base_start_justify": meta["base_start_justify"],
        "offset": meta["offset"],
        "pa_scaling": (
            None if meta["pa_scaling"] is None else list(meta["pa_scaling"])
        ),
        "model_params": meta["model_params"],
        "num_motifs": str(len(meta["motifs"])),
        "doc_string": "Nanopore Remora model (remora_tpu export)",
        "model_version": meta.get("model_version", 3),
    }
    for i, mln in enumerate(meta["mod_long_names"]):
        ts_meta[f"mod_long_names_{i}"] = str(mln)
    for i, (motif, motif_offset) in enumerate(meta["motifs"]):
        ts_meta[f"motif_{i}"] = str(motif)
        ts_meta[f"motif_offset_{i}"] = str(motif_offset)
    ts_meta["refine_kmer_levels"] = (
        None
        if smr.levels_array is None
        else smr.levels_array.astype(np.float32).tobytes().decode("cp437")
    )
    ts_meta["refine_sd_arr"] = (
        None
        if smr.sd_arr is None
        else np.asarray(smr.sd_arr, np.float32).tobytes().decode("cp437")
    )
    extra_files = {"meta.txt": json.dumps(ts_meta, indent=4)}
    torch.jit.save(m, save_filename, _extra_files=extra_files)
    LOGGER.info(f"TorchScript model exported to {save_filename}")
