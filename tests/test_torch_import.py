"""remora_tpu_torch stands alone: no JAX, nothing of remora_tpu, no
pyarrow, zstandard or tqdm needed to import it, and no silent CPU run
when no GPU is present."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from remora_tpu_torch import RemoraError
from remora_tpu_torch.infer.infer import ModelHandle
from remora_tpu_torch.models import conv_lstm_model, model_io

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "remora_tpu_torch"


def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__"
        )
        for p in PORT.rglob("*.py")
    )


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where importing
    jax fails."""
    mods = _port_modules()
    assert {"remora_tpu_torch.kernels.lstm",
            "remora_tpu_torch.kernels.convbn"} <= set(mods)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'remora_tpu' or m.startswith('remora_tpu.')\n"
        "               for m in sys.modules)\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_port_imports_without_optional_host_packages():
    """Every module of the port imports where pyarrow, zstandard and tqdm
    are absent: the POD5 reader and the driver's progress bar import them
    only when they run (the GPU machine has no zstandard)."""
    code = (
        "import sys\n"
        "for name in ('jax', 'pyarrow', 'zstandard', 'tqdm'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize(
    "path",
    [*sorted(PORT.rglob("*.py")), REPO / "chip_smoke.py",
     REPO / "chip_lstm_fwd_variants.py", REPO / "chip_lstm_bwd_variants.py",
     REPO / "chip_dp_variants.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_or_remora_tpu_import(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "remora_tpu"), (path, name)


def test_load_needs_a_device_without_gpu(tmp_path):
    """With no GPU and no device named, ModelHandle.load raises instead of
    running on the CPU; naming the CPU works."""
    path = tmp_path / "m.npz"
    model = conv_lstm_model.init(torch.Generator().manual_seed(0), size=8)
    meta = {
        "model_name": "ConvLSTM_w_ref",
        "chunk_context": [20, 20],
        "kmer_context_bases": [4, 4],
        "motifs": [["CG", 0]],
        "mod_bases": ["m"],
        "mod_long_names": ["5mC"],
    }
    model_io.save_model(path, model, meta)
    if torch.cuda.is_available():
        assert ModelHandle.load(path).device.type == "cuda"
    else:
        with pytest.raises(RemoraError, match="no CUDA device"):
            ModelHandle.load(path)
    handle = ModelHandle.load(path, device="cpu")
    assert handle.device.type == "cpu"
    sd = model.state_dict()
    for key, value in handle.model.state_dict().items():
        assert np.array_equal(value.numpy(), sd[key].numpy()), key
