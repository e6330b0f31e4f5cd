"""Device-aware resolution of the ``auto`` refine backend.

Port of ``remora_tpu/refine/autoselect.py``. The ``auto`` banded-DP
backend means "host native C++ (NumPy fallback)" unless the link to the
GPU is fast enough that the batched device DP (K4/K5) wins: the routing
is a MEASURED property of the link. The probe times one 3 MiB host-to-
device copy and a small device-to-host read back with ``torch.cuda``, once
per process: in a subprocess that imports neither JAX nor ``remora_tpu``
(so a wedged device degrades to the host path instead of hanging the
caller), or in-process for callers that already hold a CUDA context.

Reference anchor for the DP being routed:
``src/remora/refine_signal_map.py:778`` (the reference has exactly one
backend — its Cython core).
"""

import os
import subprocess
import sys
from pathlib import Path

from remora_tpu_torch import log
from remora_tpu_torch.constants import (
    REFINE_BACKEND_AUTO,
    REFINE_BACKEND_DEVICE,
)

LOGGER = log.get_logger()

# device wins when one ~3MB h2d + small d2h round trip beats this (the
# JAX package's threshold): the device-DP batch ships ~3MB of signal per
# 64-read launch, so a co-located GPU clears the bar with a wide margin
DEFAULT_PROBE_THRESHOLD_S = 0.05

_PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])
_PROBE_SRC = (
    "from remora_tpu_torch.refine.autoselect import probe_main; probe_main()"
)

_probe_cache = {}


def _time_roundtrip(device="cuda"):
    """Seconds of one 3 MiB h2d copy and a 16 KiB d2h read back."""
    import time

    import numpy as np
    import torch

    payload = torch.from_numpy(np.zeros(3 << 18, np.float32))  # 3 MiB
    x = payload.to(device)  # warm: context init + alloc
    x[:4096].cpu()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    x = payload.to(device)
    x[:4096].cpu()  # d2h leg
    return time.perf_counter() - t0


def probe_main():
    """The subprocess probe: prints ``PROBE <seconds>`` or ``PROBE none``."""
    import torch

    if torch.cuda.is_available():
        print(f"PROBE {_time_roundtrip():.6f}")
    else:
        print("PROBE none")


def probe_device_roundtrip_inprocess(device):
    """In-process h2d+d2h round-trip seconds to ``device``, or None when
    it is not a GPU.

    For callers that already hold a CUDA context on ``device`` (the
    inference driver, whose models are on the GPU before the backend is
    resolved and whose device DP would run in the same process): timing
    the round trip there opens nothing new. Cached per process (shared
    cache with the subprocess probe)."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return None
    if "t" not in _probe_cache:
        _probe_cache["t"] = _time_roundtrip(device)
    return _probe_cache["t"]


def probe_device_roundtrip(timeout_s=120.0):
    """Measured h2d+d2h round-trip seconds to the default GPU, or None
    when there is no GPU / the probe fails or times out.

    Runs in a subprocess, so a refinement pipeline never hangs on a routing
    decision and does not open a CUDA context just to make one. Cached
    per process."""
    if "t" in _probe_cache:
        return _probe_cache["t"]
    result = None
    try:
        path = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p
        )
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC],
            capture_output=True,
            text=True,
            timeout=timeout_s,
            env={**os.environ, "PYTHONPATH": path},
        )
        for line in (proc.stdout or "").splitlines():
            if line.startswith("PROBE "):
                field = line.split()[1]
                result = None if field == "none" else float(field)
    except (subprocess.TimeoutExpired, ValueError, OSError):
        result = None
    _probe_cache["t"] = result
    return result


def resolve_auto_backend(refiners, probe=None):
    """Concrete backend for ``auto``-backed refiners at pipeline start.

    Returns ``device`` when a refiner will actually run the banded DP
    and the probed link round trip beats the threshold; otherwise
    returns ``auto`` (the host native/NumPy routing, unchanged).

    Overrides: REMORA_TPU_REFINE_AUTO=device|auto|native|numpy pins the
    answer (no probe); REMORA_TPU_REFINE_PROBE_THRESHOLD sets the
    round-trip budget in seconds (default 0.05).
    """
    forced = os.getenv("REMORA_TPU_REFINE_AUTO")
    if forced:
        return forced
    if isinstance(refiners, (list, tuple)):
        refiners = [r for r in refiners if r is not None]
    else:
        refiners = [refiners] if refiners is not None else []
    will_refine = any(
        r.is_loaded and r.scale_iters >= 0
        and r.backend == REFINE_BACKEND_AUTO
        for r in refiners
    )
    if not will_refine:
        return REFINE_BACKEND_AUTO
    if probe is None:
        probe = probe_device_roundtrip  # late-bound (monkeypatchable)
    rt = probe()
    if rt is None:
        return REFINE_BACKEND_AUTO
    threshold = float(
        os.getenv(
            "REMORA_TPU_REFINE_PROBE_THRESHOLD", DEFAULT_PROBE_THRESHOLD_S
        )
    )
    if rt < threshold:
        LOGGER.info(
            f"refine backend auto -> device (probed round trip "
            f"{rt * 1e3:.1f}ms < {threshold * 1e3:.0f}ms)"
        )
        return REFINE_BACKEND_DEVICE
    LOGGER.info(
        f"refine backend auto -> host native (probed round trip "
        f"{rt * 1e3:.1f}ms >= {threshold * 1e3:.0f}ms)"
    )
    return REFINE_BACKEND_AUTO
