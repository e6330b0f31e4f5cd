"""ctypes bindings for the port's native host helpers in ``csrc/host/``.

Counterpart of the aligner, banded-DP, Theil–Sen and BAM-scan part of
``remora_tpu/io/native.py``. The port builds its own copies of
``align.cpp``, ``banded_dp.cpp``, ``rescale.cpp`` and ``bam_scan.cpp``
(``remora_tpu_torch/csrc/host/``) with ``g++`` at first use, into the
gitignored ``csrc/build/``. When no compiler is available the callers
take their NumPy or Python paths, as in the JAX package
(``sg_align_native`` runs ``sg_align_numpy``; ``banded_dp_path``,
``theil_sen_slope`` and ``bam_scan_index`` return None).
"""

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

from remora_tpu_torch import RemoraError, log

LOGGER = log.get_logger()


class ScanResult(ctypes.Structure):
    _fields_ = [
        ("n_records", ctypes.c_int64),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("flags", ctypes.POINTER(ctypes.c_uint16)),
        ("name_offs", ctypes.POINTER(ctypes.c_uint32)),
        ("pi_offs", ctypes.POINTER(ctypes.c_uint32)),
        ("has_req", ctypes.POINTER(ctypes.c_uint8)),
        ("name_blob", ctypes.POINTER(ctypes.c_char)),
        ("blob_size", ctypes.c_int64),
        ("body_start", ctypes.c_int64),
    ]


_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
_LIB = None
_BUILD_FAILED = False


def _lib_path():
    """The library's path, named for the host it is built on: the build
    takes ``-march=native``, so a library built on another CPU (say, in a
    checkout copied between machines) is never loaded here."""
    try:
        target = subprocess.run(
            ["g++", "-march=native", "-Q", "--help=target"],
            capture_output=True, text=True, check=True,
        ).stdout
    except (OSError, subprocess.CalledProcessError):
        target = ""
    host = hashlib.sha1(f"{platform.machine()}\n{target}".encode())
    name = f"libremora_torch_host-{host.hexdigest()[:16]}.so"
    return _CSRC.parent / "build" / name


def _build_library(lib_path):
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    srcs = [str(p) for p in sorted(_CSRC.glob("*.cpp"))]
    # concurrent processes each build to their own file, then rename
    tmp = lib_path.with_name(f".{lib_path.name}.{os.getpid()}.tmp")
    # -ffp-contract=off keeps float rounding identical to the NumPy
    # reference paths (no FMA contraction)
    for arch_flags in (["-march=native"], []):
        cmd = [
            "g++", "-O3", *arch_flags, "-ffp-contract=off", "-std=c++17",
            "-shared", "-fPIC", *srcs, "-o", str(tmp), "-lz",
        ]
        LOGGER.debug(f"Building native library: {' '.join(cmd)}")
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            tmp.replace(lib_path)
            return
        except subprocess.CalledProcessError:
            if not arch_flags:
                raise


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _LIB, _BUILD_FAILED
    if _LIB is not None:
        return _LIB
    if _BUILD_FAILED:
        return None
    try:
        lib_path = _lib_path()
        src_mtime = max(p.stat().st_mtime for p in _CSRC.glob("*.cpp"))
        if not lib_path.exists() or lib_path.stat().st_mtime < src_mtime:
            _build_library(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        lib.sg_align.restype = ctypes.c_int
        lib.sg_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.banded_dp.restype = ctypes.c_int
        lib.banded_dp.argtypes = [
            f32p, ctypes.c_int32,  # signal
            f32p, ctypes.c_int32,  # levels
            i32p, i32p,            # band starts/ends
            f32p, ctypes.c_int32,  # sdp
            ctypes.c_int32,        # use_dwell
            i32p,                  # path out
        ]
        lib.bam_scan_index.restype = ctypes.c_int
        lib.bam_scan_index.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int32, ctypes.POINTER(ScanResult),
        ]
        lib.bam_scan_free.restype = None
        lib.bam_scan_free.argtypes = [ctypes.POINTER(ScanResult)]
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.theil_sen_median_slope.restype = ctypes.c_double
        lib.theil_sen_median_slope.argtypes = [f64p, f64p, ctypes.c_int64]
        _LIB = lib
        return _LIB
    except Exception as e:
        LOGGER.warning(f"Native library unavailable ({e}); using NumPy paths")
        _BUILD_FAILED = True
        return None


def sg_align_native(query, ref, gap_open=10, gap_extend=2):
    """Semi-global align query vs ref via the C++ kernel.

    Returns (cigartuples, ref_start, ref_end, query_start, query_end)
    with leading/trailing indels trimmed.
    """
    lib = get_lib()
    if lib is None:
        return sg_align_numpy(query, ref, gap_open, gap_extend)
    max_ops = len(query) + len(ref) + 2
    ops = (ctypes.c_int32 * max_ops)()
    lens = (ctypes.c_int32 * max_ops)()
    coords = (ctypes.c_int32 * 4)()
    n = lib.sg_align(
        query.encode("ascii"), len(query),
        ref.encode("ascii"), len(ref),
        gap_open, gap_extend,
        ops, lens, max_ops, coords,
    )
    if n < 0:
        raise RemoraError("Pairwise alignment failed")
    cigar = [(int(ops[i]), int(lens[i])) for i in range(n)]
    return cigar, coords[0], coords[1], coords[2], coords[3]


def sg_align_numpy(query, ref, gap_open=10, gap_extend=2):
    """The host kernel's NumPy twin, run when the host library is
    unavailable: the same scoring and optimal score, though a tie may
    break another way than in the host kernel (as in the JAX package)."""
    q = np.frombuffer(query.encode("ascii"), np.uint8)
    r = np.frombuffer(ref.encode("ascii"), np.uint8)
    n, m = q.size, r.size
    NEG = -(1 << 30)
    goe = gap_open + gap_extend
    acgt = np.frombuffer(b"ACGT", np.uint8)
    q_ok = np.isin(q, acgt)
    r_ok = np.isin(r, acgt)
    # substitution scores per row computed on the fly
    Hprev = np.zeros(m + 1, np.int64)
    Fprev = np.full(m + 1, NEG, np.int64)
    tb = np.zeros((n + 1, m + 1), np.uint8)
    H_E, H_F, E_EXT, F_EXT = 1, 2, 4, 8
    for i in range(1, n + 1):
        sub = np.where(
            q_ok[i - 1] & r_ok,
            np.where(q[i - 1] == r, 5, -4),
            -2,
        )
        f_open = Hprev - goe
        f_ext = Fprev - gap_extend
        Fcur = np.maximum(f_open, f_ext)
        cell = np.where(f_ext > f_open, F_EXT, 0).astype(np.uint8)
        diag = Hprev[:-1] + sub
        # E requires a within-row scan: E[j] = max(H[j-1]-goe, E[j-1]-ge);
        # H[j] = max(diag[j], E[j], F[j]). Resolve with the min-plus trick:
        # candidates without E: base[j] = max(diag[j], Fcur[j]) (j>=1)
        base = np.maximum(diag, Fcur[1:])
        # E[j] = max over k<j of (H[k] - goe - ge*(j-1-k)); H[k] >= base-chain
        # solve sequentially (m is bounded here; native path covers big jobs)
        Hcur = np.empty(m + 1, np.int64)
        Hcur[0] = Fcur[0]
        Ecur = np.empty(m + 1, np.int64)
        Ecur[0] = NEG
        rowtb = tb[i]
        rowtb[0] = H_F | (F_EXT if i > 1 else 0)
        for j in range(1, m + 1):
            e_open = Hcur[j - 1] - goe
            e_ext = Ecur[j - 1] - gap_extend
            if e_ext > e_open:
                Ecur[j] = e_ext
                rowtb[j] = cell[j] | E_EXT
            else:
                Ecur[j] = e_open
                rowtb[j] = cell[j]
            h = base[j - 1]
            hsrc = 0 if diag[j - 1] >= Fcur[j] else H_F
            if Ecur[j] > h:
                h = Ecur[j]
                hsrc = H_E
            Hcur[j] = h
            rowtb[j] |= hsrc
        Hprev, Fprev = Hcur, Fcur
    best_j = int(np.flatnonzero(Hprev == Hprev.max())[-1])

    rops, rlens = [], []

    def push(op):
        if rops and rops[-1] == op:
            rlens[-1] += 1
        else:
            rops.append(op)
            rlens.append(1)

    i, j, state = n, best_j, 0
    while i > 0:
        cell = tb[i, j]
        if state == 0:
            hsrc = cell & 3
            if hsrc == 0:
                push(0)
                i -= 1
                j -= 1
            elif hsrc == H_E:
                state = 1
            else:
                state = 2
        elif state == 1:
            push(2)
            state = 1 if (cell & E_EXT) else 0
            j -= 1
        else:
            push(1)
            state = 2 if (cell & F_EXT) else 0
            i -= 1
    ref_start, ref_end = j, best_j
    query_start, query_end = 0, n
    lo, hi = 0, len(rops)
    while hi > lo:
        op, ln = rops[hi - 1], rlens[hi - 1]
        if op == 1:
            query_start += ln
            hi -= 1
        elif op == 2:
            ref_start += ln
            hi -= 1
        else:
            break
    while hi > lo:
        op, ln = rops[lo], rlens[lo]
        if op == 1:
            query_end -= ln
            lo += 1
        elif op == 2:
            ref_end -= ln
            lo += 1
        else:
            break
    cigar = [
        (rops[k], rlens[k]) for k in range(hi - 1, lo - 1, -1)
    ]
    return cigar, ref_start, ref_end, query_start, query_end


def banded_dp_path(signal, levels, seq_band, sdp, algo):
    """Native banded DP returning the refined path, or None when the
    native library is unavailable (caller falls back to NumPy)."""
    lib = get_lib()
    if lib is None:
        return None
    signal = np.ascontiguousarray(signal, np.float32)
    levels = np.ascontiguousarray(levels, np.float32)
    starts = np.ascontiguousarray(seq_band[0], np.int32)
    ends = np.ascontiguousarray(seq_band[1], np.int32)
    sdp = np.ascontiguousarray(sdp, np.float32)
    path = np.empty(levels.size + 1, np.int32)
    rc = lib.banded_dp(
        signal, np.int32(signal.size),
        levels, np.int32(levels.size),
        starts, ends,
        sdp, np.int32(sdp.size),
        np.int32(1 if algo == "dwell_penalty" else 0),
        path,
    )
    if rc != 0:
        return None
    return path


def theil_sen_slope(event_means, model_means):
    """Native median pairwise slope, or None when the library is
    unavailable (caller falls back to the NumPy matrix path)."""
    lib = get_lib()
    if lib is None:
        return None
    e = np.ascontiguousarray(event_means, np.float64)
    m = np.ascontiguousarray(model_means, np.float64)
    return float(lib.theil_sen_median_slope(e, m, np.int64(e.size)))


def bam_scan_index(path, req_tags=()):
    """Native whole-file BAM index scan.

    Returns (offsets i64, flags u16, names list[str], pi list[str|None],
    has_req bool array) or None when the native library is unavailable.
    Offsets index into the decompressed stream (FastBamScanner space).
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "bam_scan_index"):
        return None
    with open(path, "rb") as fh:
        data = fh.read()
    if any(len(t) != 2 for t in req_tags):
        raise ValueError(f"BAM tags are two characters: {req_tags!r}")
    req = "".join(req_tags)
    res = ScanResult()
    rc = lib.bam_scan_index(
        data, len(data), req.encode("ascii"), len(req_tags),
        ctypes.byref(res),
    )
    if rc != 0:
        LOGGER.debug(f"native bam scan failed rc={rc}")
        return None
    try:
        n = res.n_records
        offsets = np.ctypeslib.as_array(res.offsets, (n,)).copy()
        flags = np.ctypeslib.as_array(res.flags, (n,)).copy()
        name_offs = np.ctypeslib.as_array(res.name_offs, (n,)).copy()
        pi_offs = np.ctypeslib.as_array(res.pi_offs, (n,)).copy()
        has_req = np.ctypeslib.as_array(res.has_req, (n,)).copy().astype(bool)
        blob = ctypes.string_at(res.name_blob, res.blob_size)
    finally:
        lib.bam_scan_free(ctypes.byref(res))

    def at(off):
        end = blob.index(b"\x00", off)
        return blob[off:end].decode("ascii")

    names = [at(o) for o in name_offs]
    no_pi = np.uint32(0xFFFFFFFF)
    pis = [None if o == no_pi else at(o) for o in pi_offs]
    return offsets, flags, names, pis, has_req
