"""Model registry: the built-in architectures by name.

Counterpart of ``remora_tpu/models/registry.py``. Each module exposes
``init(generator, size, kmer_len, num_out, dtype, device) -> nn.Module``
whose ``forward(sigs, seqs, channels_last_in=False)`` returns logits.
Loading an architecture from a user ``.py`` file is not ported yet.
"""

from remora_tpu_torch import RemoraError
from remora_tpu_torch.models import conv_lstm_model, conv_model

BUILTIN_MODELS = {
    "ConvLSTM_w_ref": conv_lstm_model,
    "Conv_w_ref": conv_model,
}


def get_model(name):
    """Resolve a model module by builtin name."""
    if name in BUILTIN_MODELS:
        return BUILTIN_MODELS[name]
    raise RemoraError(
        f"Unknown model {name!r}; builtins: {', '.join(BUILTIN_MODELS)}"
    )
