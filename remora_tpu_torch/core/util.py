"""Miscellaneous host-side helpers (copy of ``remora_tpu/core/util.py``)."""

import os
from os.path import expanduser, realpath
from pathlib import Path
from shutil import rmtree

from remora_tpu_torch import RemoraError, log


def resolve_path(fn_path):
    """Resolve relative and linked paths."""
    if fn_path is None:
        return None
    return realpath(expanduser(str(fn_path)))


def prepare_out_dir(out_dir, overwrite):
    out_path = Path(out_dir)
    if overwrite:
        if out_path.is_dir():
            rmtree(out_path)
        elif out_path.exists():
            out_path.unlink()
    elif out_path.exists():
        raise RemoraError("Refusing to overwrite existing directory.")
    out_path.mkdir(parents=True, exist_ok=True)
    log.init_logger(os.path.join(out_path, "log.txt"))


def human_format(num):
    num = float(f"{num:.3g}")
    mag = 0
    while num >= 1000:
        mag += 1
        num /= 1000.0
    return num, ["", "K", "M", "B", "T"][mag]


def to_str(value):
    try:
        return value.decode()
    except AttributeError:
        return str(value)


def pad_rows(arr, n_rows):
    """Zero-pad a host array's leading axis up to ``n_rows`` (shared by
    every ragged-batch path that must hit a fixed compiled shape)."""
    import numpy as np

    arr = np.asarray(arr)
    if arr.shape[0] >= n_rows:
        return arr
    pad = np.zeros((n_rows - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad])


def resolve_device(device=None):
    """The torch device entry points run on: ``device`` when given, else
    the GPU; raises when no GPU is present and no device was named."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RemoraError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU"
        )
    return torch.device("cuda")
