"""Build the package's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles into ``csrc/build/lib<name>.<key>.so``, a
shared library with a plain C interface that the kernel wrappers load
with ``ctypes``. The key is a hash of everything the build depends on: the
source's text, the text of every package header it includes (``#include
"..."``, followed through the headers), and the full ``nvcc`` flag list.
A library is reused only under its own key, so a changed source, header
or flag list always rebuilds, whatever the files' times say. Builds write
to a temporary file and rename it into place, so concurrent processes
never load a half-written library. Each library's compiler output is kept
beside it as ``lib<name>.<key>.log``.
"""

import ctypes
import hashlib
import os
import re
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
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


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


def _flags(name):
    return (*NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()))


def _key(name):
    """Hash of the source's text, its package headers' texts and its flag
    list: the part of the library's name that says what it was built
    from."""
    digest = hashlib.sha256("\0".join(_flags(name)).encode())
    pending, seen = [CSRC / f"{name}.cu"], set()
    while pending:
        path = pending.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_text()
        digest.update(f"\0{path.name}\0{text}".encode())
        for inc in _INCLUDE.findall(text):
            header = path.parent / inc
            if header.is_file():
                pending.append(header)
    return digest.hexdigest()[:16]


def _lib_path(name):
    return BUILD_DIR / f"lib{name}.{_key(name)}.so"


def _start(name):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _lib_path(name)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, lib, time.monotonic()


def _finish(name, proc, tmp, lib, t0):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RemoraError(f"nvcc failed to build {name}.cu:\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)
    BUILD_LOG[name] = (time.monotonic() - t0, log)


def compile_log(name):
    """The compiler output (``-Xptxas=-v``: registers and spills of each
    kernel) of the build that made the current ``csrc/<name>.cu``'s
    library."""
    return _lib_path(name).with_suffix(".log").read_text()


def library_path(name):
    """The library of the current ``csrc/<name>.cu`` and flags, built
    first if no library has that key."""
    with _LOCK:
        lib = _lib_path(name)
        if not lib.is_file():
            _finish(name, *_start(name))
        return lib


def build_all():
    """Compile every source whose key has no library, one ``nvcc`` per
    source, all at once."""
    with _LOCK:
        started = [(n, *_start(n)) for n in sources()
                   if not _lib_path(n).is_file()]
        errors = []
        for name, *job in started:
            try:
                _finish(name, *job)
            except RemoraError as err:
                errors.append(err)
        if errors:
            raise errors[0]


def load(name):
    """The ``ctypes`` library built from ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        with _LOCK:
            lib = _LIBS.setdefault(name, ctypes.CDLL(str(path)))
    return lib
