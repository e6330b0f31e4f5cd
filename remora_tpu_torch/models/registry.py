"""Model registry: the built-in architectures, and models from ``.py`` files.

Counterpart of ``remora_tpu/models/registry.py``. Each module exposes
``init(generator, size, kmer_len, num_out, dtype, device) -> nn.Module``
whose ``forward(sigs, seqs, channels_last_in=False)`` returns logits.

A model file is either a module of this package's contract (an ``init``
as above, returning a module whose state-dict keys are the checkpoint's
layer names) or a reference-style torch file with a ``network`` class,
which maps onto the builtin with its layer set (reference analog
``model_util._load_python_model``). No other torch architecture is
translated.
"""

import importlib.machinery
import importlib.util

from remora_tpu_torch import RemoraError
from remora_tpu_torch.models import conv_lstm_model, conv_model

BUILTIN_MODELS = {
    "ConvLSTM_w_ref": conv_lstm_model,
    "Conv_w_ref": conv_model,
}


def get_model(name_or_path):
    """Resolve a model module by builtin name or python file path."""
    if name_or_path in BUILTIN_MODELS:
        return BUILTIN_MODELS[name_or_path]
    if str(name_or_path).endswith(".py"):
        return load_python_model(name_or_path)
    raise RemoraError(
        f"Unknown model {name_or_path!r}; builtins: "
        f"{', '.join(BUILTIN_MODELS)}"
    )


def load_python_model(model_file):
    """Exec-load a model definition module from a file path: a module of
    this package's contract (``init``), or a reference-style torch file
    (a ``network`` class) mapped onto a builtin."""
    loader = importlib.machinery.SourceFileLoader("netmodule", str(model_file))
    spec = importlib.util.spec_from_loader(loader.name, loader)
    netmodule = importlib.util.module_from_spec(spec)
    loader.exec_module(netmodule)
    if hasattr(netmodule, "init"):
        return netmodule
    if hasattr(netmodule, "network"):
        return _adapt_reference_model(netmodule, model_file)
    raise RemoraError(
        f"Model file {model_file} defines neither init nor a torch "
        "'network' class"
    )


def _adapt_reference_model(netmodule, model_file):
    """The builtin architecture a reference torch model file describes,
    identified by its layer set."""
    net = netmodule.network(size=8, kmer_len=3, num_out=2)
    layer_names = {n.split(".")[0] for n, _ in net.named_parameters()}
    if "lstm1" in layer_names:
        return conv_lstm_model
    if "merge_conv4" in layer_names:
        return conv_model
    raise RemoraError(
        f"Cannot map torch architecture in {model_file} to a builtin "
        "remora_tpu_torch model"
    )
