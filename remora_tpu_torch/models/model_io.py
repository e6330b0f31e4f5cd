"""Model artifact I/O: the JAX package's native ``.npz`` checkpoints.

Counterpart of ``remora_tpu/models/model_io.py``. A checkpoint is one
``.npz``: ``__meta__`` (JSON metadata as bytes), ``params/<layer>/<leaf>``
and ``bn/<layer>/<leaf>`` arrays, and ``meta_arr/<key>`` arrays. The
layout is the JAX package's, so checkpoints cross-load both ways. A
module's state-dict key ``<layer>.<leaf>`` is the checkpoint key
``<layer>/<leaf>``: parameters go under ``params/``, buffers (BatchNorm
running statistics) under ``bn/``.

Refinement settings (``refine_*`` keys and arrays) are carried through
unchanged as a plain ``refine_settings`` dict.

Optimizer state rides as ``opt_leaf/<i>`` arrays in the leaf order of the
JAX package's optax state (``train/optim.py`` maps torch's optimizers to
and from it), so a training run resumes across the two packages.
"""

import json

import numpy as np
import torch

from remora_tpu_torch import constants
from remora_tpu_torch.models.registry import get_model

_REFINE_KEYS = ("rough_rescale_method",)


# ---------------- param pytree <-> flat arrays ----------------


def flatten_tree(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_tree(v, prefix=f"{key}/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def params_from_numpy(params, bn_state):
    """State dict of the port's module from the JAX package's (params,
    bn_state) pytrees of arrays; load it with ``model.load_state_dict``."""
    flat = {**flatten_tree(params), **flatten_tree(bn_state)}
    return {
        key.replace("/", "."): torch.from_numpy(np.array(v))
        for key, v in flat.items()
    }


def module_to_trees(model):
    """(params, bn_state) pytrees of numpy arrays from a module: its
    parameters and its buffers, in the JAX package's layout."""

    def tree(named):
        return unflatten_tree(
            {
                k.replace(".", "/"): v.detach().float().cpu().numpy()
                for k, v in named
            }
        )

    return tree(model.named_parameters()), tree(model.named_buffers())


# ---------------- metadata ----------------


def default_refine_settings():
    """The ``refine_*`` settings of a dataset that carries none: those of
    the JAX package's default ``SigMapRefiner`` (no levels table, no
    rescaling, no refinement)."""
    target, limit, weight = constants.DEFAULT_REFINE_SHORT_DWELL_PARAMS
    dwell = np.arange(min(limit, target), dtype=np.float32)
    return {
        "refine_kmer_levels": None,
        "refine_kmer_center_idx": -1,
        "refine_do_rough_rescale": False,
        "refine_scale_iters": -1,
        "refine_algo": constants.DEFAULT_REFINE_ALGO,
        "refine_half_bandwidth": constants.DEFAULT_REFINE_HBW,
        "refine_sd_arr": weight * np.square(dwell - target),
    }


def make_model_metadata(dataset_metadata, model_name, model_params):
    """Assemble the checkpoint metadata dict and its arrays from dataset
    metadata (the JAX package's ``make_model_metadata``)."""
    md = dataset_metadata
    meta = {
        "model_name": model_name,
        "model_params": dict(model_params),
        "model_version": constants.MODEL_VERSION,
        "chunk_context": list(md.chunk_context),
        "motifs": [list(m) for m in md.motifs],
        "num_motifs": md.num_motifs,
        "reverse_signal": md.reverse_signal,
        "mod_bases": list(md.mod_bases),
        "mod_long_names": list(md.mod_long_names),
        "modified_base_labels": md.modified_base_labels,
        "kmer_context_bases": list(md.kmer_context_bases),
        "base_start_justify": md.base_start_justify,
        "offset": md.offset,
        "pa_scaling": (
            None if md.pa_scaling is None else list(md.pa_scaling)
        ),
    }
    refine = default_refine_settings()
    refine.update(
        (k, v) for k, v in (md.refine_settings or {}).items() if v is not None
    )
    # levels/sd arrays ride as npz arrays, the rest as JSON scalars
    meta["refine_kmer_center_idx"] = int(refine["refine_kmer_center_idx"])
    meta["refine_do_rough_rescale"] = bool(refine["refine_do_rough_rescale"])
    meta["refine_scale_iters"] = int(refine["refine_scale_iters"])
    meta["refine_algo"] = refine["refine_algo"]
    meta["refine_half_bandwidth"] = int(refine["refine_half_bandwidth"])
    meta["rough_rescale_method"] = md.rough_rescale_method
    arrays = {}
    if refine["refine_kmer_levels"] is not None:
        arrays["refine_kmer_levels"] = np.asarray(
            refine["refine_kmer_levels"], np.float32
        )
    arrays["refine_sd_arr"] = np.asarray(refine["refine_sd_arr"], np.float32)
    return meta, arrays


def add_derived_metadata(meta):
    """Populate derived fields used throughout inference."""
    meta.setdefault("reverse_signal", False)
    meta.setdefault("pa_scaling", None)
    meta["kmer_context_bases"] = tuple(meta["kmer_context_bases"])
    meta["chunk_context"] = tuple(meta["chunk_context"])
    meta["kmer_len"] = sum(meta["kmer_context_bases"]) + 1
    meta["chunk_len"] = sum(meta["chunk_context"])
    meta["motifs"] = [(str(m), int(o)) for m, o in meta["motifs"]]
    meta["can_base"] = meta["motifs"][0][0][meta["motifs"][0][1]]
    if len(meta["motifs"]) == 1:
        meta["motif"] = meta["motifs"][0]
    else:
        meta["motif"] = (meta["can_base"], 0)
    if meta.get("pa_scaling") is not None:
        meta["pa_scaling"] = tuple(meta["pa_scaling"])
    if meta.get("mod_bases") is None:
        meta["mod_bases"] = []
        meta["mod_long_names"] = []
    mod_str = "; ".join(
        f"{b}={ln}"
        for b, ln in zip(meta["mod_bases"], meta["mod_long_names"])
    )
    meta["alphabet_str"] = (
        f"loaded modified base model to call (alt to {meta['can_base']}): "
        f"{mod_str}"
    )
    meta["refine_settings"] = {
        k: meta.pop(k)
        for k in list(meta)
        if k.startswith("refine_") or k in _REFINE_KEYS
    }
    return meta


# ---------------- native save/load ----------------


def save_model(path, model, meta, meta_arrays=None, opt_state=None):
    """Write a single-file ``.npz`` model artifact (the JAX package's
    ``save_model`` layout). ``opt_state`` is a sequence of arrays, the
    optimizer state's leaves in optax order (``optim.optimizer_leaves``)."""
    params, bn_state = module_to_trees(model)
    payload = {"__meta__": np.frombuffer(
        json.dumps(meta, default=_json_default).encode(), dtype=np.uint8
    )}
    payload.update(
        {f"params/{k}": v for k, v in flatten_tree(params).items()}
    )
    payload.update(
        {f"bn/{k}": v for k, v in flatten_tree(bn_state).items()}
    )
    if meta_arrays:
        payload.update({f"meta_arr/{k}": v for k, v in meta_arrays.items()})
    for i, leaf in enumerate(opt_state or ()):
        payload[f"opt_leaf/{i:05d}"] = np.asarray(leaf)
    with open(path, "wb") as fh:
        np.savez(fh, **payload)


def _json_default(obj):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"Cannot serialize {type(obj)}")


def load_model(path):
    """Load an ``.npz`` checkpoint into a module on the CPU.

    Returns (model, metadata); metadata has all derived fields set
    (kmer_len, chunk_len, can_base, refine_settings, ...).
    """
    with np.load(str(path), allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        params = unflatten_tree(
            {
                k[len("params/"):]: data[k]
                for k in data.files
                if k.startswith("params/")
            }
        )
        bn_state = unflatten_tree(
            {k[len("bn/"):]: data[k] for k in data.files
             if k.startswith("bn/")}
        )
        for k in data.files:
            if k.startswith("meta_arr/"):
                meta[k[len("meta_arr/"):]] = data[k]
    meta = add_derived_metadata(meta)
    arch = get_model(meta.get("model_name", "ConvLSTM_w_ref"))
    # both builtins: merge_conv1 (size, 2 * size, k), seq_conv1 (16, 4K, k)
    model = arch.init(
        size=params["merge_conv1"]["w"].shape[0],
        kmer_len=params["seq_conv1"]["w"].shape[1] // 4,
        num_out=params["fc"]["w"].shape[0],
    )
    model.load_state_dict(params_from_numpy(params, bn_state))
    return model, meta


def load_opt_state(path):
    """The optimizer-state leaves ``save_model`` stored (optax order), or
    None when the checkpoint holds none."""
    with np.load(str(path), allow_pickle=False) as data:
        keys = sorted(k for k in data.files if k.startswith("opt_leaf/"))
        if not keys:
            return None
        return [data[k] for k in keys]
