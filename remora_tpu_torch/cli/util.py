"""CLI-adjacent helpers (counterpart of ``remora_tpu/cli/util.py``)."""

from pathlib import Path

from remora_tpu_torch import RemoraError

# the data-parallel and multi-host options: parsed, not ported yet
DISTRIBUTED_OPTIONS = ("data_parallel", "coordinator_address",
                       "num_processes", "process_id", "sync_bn")


def parse_device(device):
    """The torch device of ``--device``: cpu, cuda, cuda:N, or an integer
    N meaning cuda:N; None is the GPU, and raises when there is none (no
    silent CPU run)."""
    from remora_tpu_torch.core.util import resolve_device

    if device is not None and str(device).isdigit():
        device = f"cuda:{int(device)}"
    return resolve_device(device)


def refuse_distributed(args):
    """Raise when any data-parallel or multi-host option was given."""
    given = [
        "--" + name.replace("_", "-")
        for name in DISTRIBUTED_OPTIONS
        if getattr(args, name, None) not in (None, False)
    ]
    if given:
        raise RemoraError(
            f"{', '.join(given)}: data-parallel and multi-host runs are "
            "not ported yet (ROADMAP queue 1 item 7)"
        )


def parse_picoamps(bc_model, sig_map_refiner):
    """Extract pA standardisation factors from a Dorado basecall model dir.

    Reference analog ``util.parse_picoamps``; uses stdlib tomllib instead
    of the toml package.
    """
    import tomllib

    if bc_model is None:
        return None
    if sig_map_refiner.do_rough_rescale or sig_map_refiner.scale_iters > -1:
        raise RemoraError(
            "Cannot specify signal scaling/mapping refinement and "
            "picoamp scaling options."
        )
    bc_cfg = Path(bc_model) / "config.toml"
    if not bc_cfg.exists():
        raise RemoraError(f"Basecalling model config does not exist: {bc_cfg}")
    with open(bc_cfg, "rb") as fh:
        cfg = tomllib.load(fh)
    try:
        std_cfg = cfg["standardisation"]
        do_std = std_cfg["standardise"]
        pa_scaling = (std_cfg["mean"], std_cfg["stdev"])
    except KeyError:
        raise RemoraError("Basecalling model is not picoamp scaling model")
    if do_std != 1:
        raise RemoraError("Basecalling model is not picoamp scaling model")
    return pa_scaling
