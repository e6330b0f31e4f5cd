"""Optimizer, LR schedule, and adaptive gradient clipping.

Counterpart of ``remora_tpu/train/optim.py`` (reference ``TrainOpts`` /
``CustomPlusCoolDownScheduler`` and ``RollingMAD``). ``med_mad``,
``RollingMAD`` and ``cosine_with_cooldown`` are copies. The JAX package
builds optax transforms with an injected learning rate; here
``TrainOpts.load_optimizer`` builds the ``torch.optim`` optimizer with the
same update:

  * ``optax.adamw`` decays every leaf (biases and BatchNorm's gamma/beta
    too): p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), which is
    ``torch.optim.AdamW`` with one parameter group;
  * ``optax.adam`` is ``torch.optim.Adam`` without weight decay;
  * ``optax.sgd`` with momentum m keeps trace = g + m * trace, which is
    ``torch.optim.SGD(momentum=m, dampening=0)``.

The learning rate is set per epoch (``train.set_learning_rate``).
``optimizer_leaves`` and ``load_optimizer_leaves`` map the optimizer's
state to and from the leaf order of the optax state the JAX package saves
in its checkpoints, so a run resumes across the two packages.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from remora_tpu_torch import RemoraError, constants, log

LOGGER = log.get_logger()


def med_mad(data, factor=constants.PA_TO_NORM_SCALING_FACTOR, axis=None):
    dmed = np.median(data, axis=axis, keepdims=True)
    dmad = factor * np.median(abs(data - dmed), axis=axis, keepdims=True)
    if axis is None:
        return dmed.flatten()[0], dmad.flatten()[0]
    return dmed.squeeze(axis), dmad.squeeze(axis)


class RollingMAD:
    """Rolling median + n*MAD threshold over a window per tracked value."""

    def __init__(self, nparams, n_mads=0, window=1000, default_to=None):
        self.n_mads = n_mads
        self.default_to = default_to
        self._window_data = np.empty((nparams, window), dtype="f4")
        self._curr_iter = 0

    @property
    def nparams(self):
        return self._window_data.shape[0]

    @property
    def window(self):
        return self._window_data.shape[1]

    def update(self, vals):
        assert len(vals) == self.nparams
        self._window_data[:, self._curr_iter % self.window] = vals
        self._curr_iter += 1
        if self._curr_iter < self.window:
            return self.default_to
        med, mad = med_mad(self._window_data, axis=1)
        return med + (mad * self.n_mads)


def cosine_with_cooldown(initial_lr, epochs, cool_down_epochs, cool_down_lr,
                         eta_min=1e-6, t_max=None):
    """lr(epoch) mirroring torch CosineAnnealingLR stepped per epoch plus
    a flat cool-down tail."""
    if t_max is None:
        t_max = epochs

    def lr_at(epoch):
        if epoch >= epochs - 1:
            return cool_down_lr
        return eta_min + (initial_lr - eta_min) * (
            1 + math.cos(math.pi * epoch / t_max)
        ) / 2

    return lr_at


# optax's injected hyperparameters, in its (sorted) leaf order
_HYPERPARAMS = {
    "adamw": ("b1", "b2", "eps", "eps_root", "learning_rate",
              "weight_decay"),
    "adam": ("b1", "b2", "eps", "eps_root", "learning_rate"),
    "sgd": ("learning_rate", "momentum"),
}


@dataclass
class TrainOpts:
    epochs: int = constants.DEFAULT_EPOCHS
    early_stopping: int = constants.DEFAULT_EARLY_STOPPING
    optimizer_str: str = constants.DEFAULT_OPTIMIZER
    opt_kwargs: tuple = constants.DEFAULT_OPT_VALUES
    learning_rate: float = constants.DEFAULT_LR
    lr_scheduler_str: str = constants.DEFAULT_SCHEDULER
    lr_scheduler_kwargs: tuple = constants.DEFAULT_SCH_VALUES
    lr_cool_down_epochs: int = constants.DEFAULT_SCH_COOL_DOWN_EPOCHS
    lr_cool_down_lr: float = constants.DEFAULT_SCH_COOL_DOWN_LR

    def _parsed_kwargs(self, kwargs):
        return {
            key: constants.TYPE_CONVERTERS[typ](val)
            for key, val, typ in kwargs
        }

    def load_optimizer(self, params):
        """A ``torch.optim`` optimizer over ``params`` (one group) with the
        update of the JAX package's optax transform."""
        kw = self._parsed_kwargs(self.opt_kwargs)
        name = self.optimizer_str.lower()
        if name == "adamw":
            return torch.optim.AdamW(
                params,
                lr=self.learning_rate,
                betas=(kw.get("beta1", 0.9), kw.get("beta2", 0.999)),
                eps=kw.get("eps", 1e-8),
                weight_decay=kw.get("weight_decay", 1e-4),
            )
        if name == "adam":
            return torch.optim.Adam(params, lr=self.learning_rate,
                                    weight_decay=0.0)
        if name == "sgd":
            return torch.optim.SGD(params, lr=self.learning_rate,
                                   momentum=kw.get("momentum", 0.0),
                                   dampening=0.0)
        raise ValueError(f"Unknown optimizer {self.optimizer_str}")

    def load_scheduler(self):
        skw = self._parsed_kwargs(self.lr_scheduler_kwargs)
        name = self.lr_scheduler_str.lower()
        if name in ("cosine", "cosineannealinglr"):
            return cosine_with_cooldown(
                self.learning_rate,
                self.epochs,
                self.lr_cool_down_epochs,
                self.lr_cool_down_lr,
                eta_min=skw.get("eta_min", 1e-6),
                t_max=skw.get("T_max"),
            )
        if name in ("constant", "none"):
            return lambda epoch: self.learning_rate
        raise ValueError(f"Unknown scheduler {self.lr_scheduler_str}")


def _kind(optimizer):
    # AdamW subclasses Adam: test it first
    if isinstance(optimizer, torch.optim.AdamW):
        return "adamw"
    if isinstance(optimizer, torch.optim.Adam):
        return "adam"
    if isinstance(optimizer, torch.optim.SGD):
        return "sgd"
    raise RemoraError(f"no optax layout for {type(optimizer).__name__}")


def _hyperparam_values(optimizer):
    group = optimizer.param_groups[0]
    betas = group.get("betas", (0.0, 0.0))
    return {
        "b1": betas[0], "b2": betas[1], "eps": group.get("eps"),
        "eps_root": 0.0, "learning_rate": group["lr"],
        "weight_decay": group.get("weight_decay"),
        "momentum": group.get("momentum"),
    }


def optimizer_leaves(optimizer, params, count):
    """The optimizer's state as the leaves of the JAX package's optax state,
    in its flattened order: ``count`` (int32), the injected hyperparameters
    by name, then for Adam/AdamW the inner ``count``, ``mu`` and ``nu``
    (one leaf per parameter, ``params`` in sorted flatten-key order) and for
    SGD the momentum ``trace``. ``count`` is the number of updates taken."""
    kind = _kind(optimizer)
    values = _hyperparam_values(optimizer)
    leaves = [np.asarray(count, np.int32)]
    leaves += [np.asarray(values[h], np.float32) for h in _HYPERPARAMS[kind]]

    def state(p, key):
        t = optimizer.state.get(p, {}).get(key)
        if t is None:
            return np.zeros(tuple(p.shape), np.float32)
        return t.detach().float().cpu().numpy()

    if kind == "sgd":
        return leaves + [state(p, "momentum_buffer") for p in params]
    leaves.append(np.asarray(count, np.int32))
    leaves += [state(p, "exp_avg") for p in params]
    return leaves + [state(p, "exp_avg_sq") for p in params]


def load_optimizer_leaves(optimizer, params, leaves):
    """Restore ``optimizer_leaves`` output (from either package's
    checkpoint) into ``optimizer``, hyperparameters included; returns the
    stored update count."""
    kind = _kind(optimizer)
    names = _HYPERPARAMS[kind]
    n_state = len(params) * (1 if kind == "sgd" else 2)
    n_expected = 1 + len(names) + (kind != "sgd") + n_state
    if len(leaves) != n_expected:
        raise RemoraError(
            "Optimizer state in checkpoint does not match the configured "
            f"optimizer ({n_expected} leaves expected, {len(leaves)} stored)"
        )
    count = int(leaves[0])
    hyper = {n: float(v) for n, v in zip(names, leaves[1:1 + len(names)])}
    group = optimizer.param_groups[0]
    group["lr"] = hyper["learning_rate"]
    state = leaves[1 + len(names) + (kind != "sgd"):]

    def tensor(arr, p):
        return torch.as_tensor(np.asarray(arr), dtype=p.dtype,
                               device=p.device).clone()

    if kind == "sgd":
        group["momentum"] = hyper["momentum"]
        if hyper["momentum"] != 0.0:
            for p, trace in zip(params, state):
                optimizer.state[p] = {"momentum_buffer": tensor(trace, p)}
        return count
    group["betas"] = (hyper["b1"], hyper["b2"])
    group["eps"] = hyper["eps"]
    if kind == "adamw":
        group["weight_decay"] = hyper["weight_decay"]
    n = len(params)
    for p, mu, nu in zip(params, state[:n], state[n:]):
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": tensor(mu, p),
            "exp_avg_sq": tensor(nu, p),
        }
    return count
