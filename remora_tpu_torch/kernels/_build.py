"""Build the package's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles into ``csrc/build/lib<name>.so``, a
shared library with a plain C interface that the kernel wrappers load
with ``ctypes``. A library newer than its source is reused. Builds write
to a temporary file and rename it into place, so concurrent processes
never load a half-written library.
"""

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from remora_tpu_torch import RemoraError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# flags of one source only: the DP kernels must never contract a product
# and a sum into an FMA (their paths are bit-exact to the host DP)
SOURCE_FLAGS = {"banded_dp": ("--fmad=false",)}

_LIBS = {}
_LOCK = threading.Lock()
# name -> (seconds, compiler output) of the builds this process ran
BUILD_LOG = {}


def sources():
    """Names of every CUDA source of the package."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.is_file():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RemoraError(
            f"nvcc not found (looked in {cuda_home}/bin and on PATH); "
            "the CUDA kernels cannot be built"
        )
    return found


def _lib_path(name):
    return BUILD_DIR / f"lib{name}.so"


def _is_fresh(name):
    lib = _lib_path(name)
    src = CSRC / f"{name}.cu"
    return lib.is_file() and lib.stat().st_mtime >= src.stat().st_mtime


def _start(name):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o",
           str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, time.monotonic()


def _finish(name, proc, tmp, t0):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RemoraError(f"nvcc failed to build {name}.cu:\n{log}")
    os.replace(tmp, _lib_path(name))
    _lib_path(name).with_suffix(".log").write_text(log)
    BUILD_LOG[name] = (time.monotonic() - t0, log)


def compile_log(name):
    """The compiler output (``-Xptxas=-v``: registers and spills of each
    kernel) of the build that made ``csrc/build/lib<name>.so``."""
    return _lib_path(name).with_suffix(".log").read_text()


def build_all():
    """Compile every stale source, one ``nvcc`` per source, all at once."""
    with _LOCK:
        started = [(n, *_start(n)) for n in sources() if not _is_fresh(n)]
        errors = []
        for name, proc, tmp, t0 in started:
            try:
                _finish(name, proc, tmp, t0)
            except RemoraError as err:
                errors.append(err)
        if errors:
            raise errors[0]


def load(name):
    """The ``ctypes`` library built from ``csrc/<name>.cu``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not _is_fresh(name):
                _finish(name, *_start(name))
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib
