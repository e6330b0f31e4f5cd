"""CLI-adjacent helpers (counterpart of ``remora_tpu/cli/util.py``)."""

from pathlib import Path

from remora_tpu_torch import RemoraError


def parse_device(device):
    """The torch device of ``--device``: cpu, cuda, cuda:N, or an integer
    N meaning cuda:N; None is the GPU, and raises when there is none (no
    silent CPU run)."""
    from remora_tpu_torch.core.util import resolve_device

    if device is not None and str(device).isdigit():
        device = f"cuda:{int(device)}"
    return resolve_device(device)


def rank_device(args):
    """A rank's device: ``--device`` when given, else cuda:(process id %
    visible GPUs); no GPU and no ``--device`` raises."""
    import torch

    if args.device is not None or not torch.cuda.is_available():
        return parse_device(args.device)
    return torch.device("cuda",
                        (args.process_id or 0) % torch.cuda.device_count())


def start_distributed(args, device, data_parallel=False):
    """The process group the distributed options ask for: with
    ``--num-processes N`` this process is rank ``--process-id`` of N
    meeting at ``--coordinator-address``; ``data_parallel``
    (``--data-parallel`` alone) is a group of one. NCCL on a GPU, gloo on
    the CPU. Returns this rank's ``parallel.mesh.Mesh``, or None when no
    option asks for a group.

    The JAX package's ``--data-parallel`` alone spans every local device
    in one process; here a process drives one device, so with more than
    one visible GPU it raises and points to ``--num-processes``."""
    import torch

    from remora_tpu_torch.parallel.mesh import init_multihost, make_mesh

    if not args.num_processes and not data_parallel:
        return None
    if not args.num_processes and device.type == "cuda" \
            and torch.cuda.device_count() > 1:
        raise RemoraError(
            f"--data-parallel alone runs one process on one GPU, and "
            f"{torch.cuda.device_count()} are visible: start one process "
            "per GPU with --num-processes N --process-id I "
            "--coordinator-address HOST:PORT"
        )
    init_multihost(args.coordinator_address, args.num_processes,
                   args.process_id, device=device)
    return make_mesh(device)


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
