"""K3, the training LSTM backward, on the CPU: its three plain parts (gates,
recurrence, products) against the composed plain version and the JAX
kernel in interpret mode; the f32 kernel's shape rule; the CUDA build's
library key; and the port's fail-fast on an unknown ``REMORA_TPU_CONVBN``."""

import os
import shutil
import stat
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remora_tpu.kernels import pallas_lstm as PL
from remora_tpu.models import layers as JL
from remora_tpu_torch import RemoraError
from remora_tpu_torch.kernels import _build
from remora_tpu_torch.kernels import lstm as K
from remora_tpu_torch.models import layers as TL

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# a ragged batch (not a multiple of 8 or 16), H not a multiple of 16 and
# C != H both ways, one step past a time chunk of 4
SHAPES = [(7, 16, 16, 16), (13, 13, 20, 12), (9, 5, 24, 8)]


def _case(T, B, C, H, dtype):
    rng = np.random.default_rng(T * B + C)
    bound = 1.0 / np.sqrt(H)
    w_ih = rng.uniform(-bound, bound, (4 * H, C)).astype(np.float32)
    w_hh = rng.uniform(-bound, bound, (4 * H, H)).astype(np.float32)
    bias = rng.uniform(-bound, bound, 4 * H).astype(np.float32)
    w_aug = np.concatenate([w_ih.T, w_hh.T, bias[None]], axis=0)
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    dhs = rng.normal(size=(T, B, H)).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(w_aug).to(dtype),
            torch.from_numpy(dhs).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,C,H", SHAPES)
def test_lstm_bwd_parts_compose_to_reference(T, B, C, H, dtype):
    """The three parts' wrappers, which take their plain versions for CPU
    tensors, give ``lstm_bwd_reference``'s and ``lstm_bwd``'s bits; the
    intermediates have the kernels' shapes and dtypes."""
    x, w_aug, dhs = _case(T, B, C, H, dtype)
    hs, cs = K.lstm_fwd(x, w_aug)
    launches = dict(K.LAUNCHES_BWD_MMA), K.LAUNCHES_BWD
    z = K.lstm_bwd_gates(x, w_aug, hs)
    assert z.shape == (T, B, 4 * H) and z.dtype == torch.float32
    dg = K.lstm_bwd_recurrence(z, cs, dhs, w_aug)
    assert dg.shape == (T, B, 4 * H) and dg.dtype == dtype
    dx, dw = K.lstm_bwd_products(x, hs, w_aug, dg)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    assert dw.shape == (C + H + 1, 4 * H)
    for want in (K.lstm_bwd_reference(x, w_aug, hs, cs, dhs),
                 K.lstm_bwd(x, w_aug, hs, cs, dhs)):
        assert torch.equal(dx, want[0]) and torch.equal(dw, want[1])
    # the recurrence's first step takes h_{-1} = 0: z[0] is x_0's part
    w = w_aug.float()
    z0 = x[0].float() @ w[:C] + w[C + H]
    assert torch.allclose(z[0], z0, atol=1e-6, rtol=0)
    assert (dict(K.LAUNCHES_BWD_MMA), K.LAUNCHES_BWD) == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,C,H", SHAPES)
def test_lstm_bwd_parts_match_pallas(monkeypatch, T, B, C, H, dtype):
    """The composed parts against ``_bwd_call`` in interpret mode (one batch
    tile of B rows, time chunks of 4), on the JAX forward's hs and cs: dx
    <= 1e-5, dW <= 1e-4 of its largest entry, in f32 and in bf16."""
    monkeypatch.setattr(PL, "_tile_plan", lambda *a, **k: (B, 4))
    x, w_aug, dhs = _case(T, B, C, H, dtype)
    jdt = _JDT[dtype]

    def jax_of(t):
        return jnp.asarray(t.float().numpy()).astype(jdt)

    j_hs, j_cs = PL._fwd_call(jax_of(x), jax_of(w_aug), interpret=True)
    j_dx, j_dw = PL._bwd_call(jax_of(x), jax_of(w_aug), j_hs, j_cs,
                              jax_of(dhs), interpret=True)

    def torch_of(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)

    hs, cs = torch_of(j_hs), torch_of(j_cs)
    z = K.lstm_bwd_gates(x, w_aug, hs)
    dx, dw = K.lstm_bwd_products(
        x, hs, w_aug, K.lstm_bwd_recurrence(z, cs, dhs, w_aug))
    want_dx = np.asarray(j_dx.astype(jnp.float32))
    assert np.abs(dx.float().numpy() - want_dx).max() <= 1e-5
    want_dw = np.asarray(j_dw)
    assert np.abs(dw.numpy() - want_dw).max() <= 1e-4 * np.abs(want_dw).max()


def test_lstm_bwd_parts_refuse_devices_without_a_kernel():
    x, w_aug, dhs = _case(3, 4, 8, 8, torch.bfloat16)
    hs, cs = K.lstm_fwd(x, w_aug)
    z = K.lstm_bwd_gates(x, w_aug, hs)
    dg = K.lstm_bwd_recurrence(z, cs, dhs, w_aug)
    meta = [t.to("meta") for t in (x, w_aug, hs, cs, dhs, z, dg)]
    mx, mw, mhs, mcs, mdhs, mz, mdg = meta
    for call in (lambda: K.lstm_bwd_gates(mx, mw, mhs),
                 lambda: K.lstm_bwd_recurrence(mz, mcs, mdhs, mw),
                 lambda: K.lstm_bwd_products(mx, mhs, mw, mdg),
                 lambda: K.lstm_bwd(mx, mw, mhs, mcs, mdhs)):
        with pytest.raises(ValueError, match="no kernel for device"):
            call()


# ---------------- the f32 kernel's shapes ----------------


@pytest.mark.parametrize("C,H,takes", [
    (64, 64, True), (100, 12, True), (64, 16, True), (1, 1, True),
    (129, 64, False), (64, 65, False), (0, 8, False),
    # 16 x 16 = 256 dW tiles at C + H = 128; 24 x 16 past 256 here
    (128, 64, False),
])
def test_bwd_f32_shape_rule(C, H, takes):
    msg = K.bwd_f32_shape_error(C, H)
    assert (msg is None) == takes
    if not takes:
        assert f"C={C}, H={H}" in msg and "the f32 kernel takes" in msg


def test_bwd_f32_shape_rule_takes_every_shape_of_the_old_kernel():
    """Every (C, H) the one-launch kernel of the earlier design took (C <=
    128, H <= 64, at most 256 tiles of 8 k x 16 gate columns) is taken, and
    nothing else."""
    for C in range(1, 129):
        for H in range(1, 65):
            old = -(-(C + H) // 8) * -(-4 * H // 16) <= 256
            assert (K.bwd_f32_shape_error(C, H) is None) == old, (C, H)


@pytest.mark.parametrize("C,H", [(129, 64), (128, 64), (3, 70), (160, 160),
                                 (144, 200)])
def test_lstm_bwd_takes_any_width_on_the_cpu(C, H):
    """CPU tensors take the plain version whatever the kernel's rule says,
    and launch nothing."""
    x, w_aug, dhs = _case(3, 5, C, H, torch.float32)
    hs, cs = K.lstm_fwd(x, w_aug)
    launches = K.LAUNCHES_BWD, dict(K.LAUNCHES_BWD_MMA)
    dx, dw = K.lstm_bwd(x, w_aug, hs, cs, dhs)
    want = K.lstm_bwd_reference(x, w_aug, hs, cs, dhs)
    assert torch.equal(dx, want[0]) and torch.equal(dw, want[1])
    assert (K.LAUNCHES_BWD, dict(K.LAUNCHES_BWD_MMA)) == launches


# ---------------- the CUDA build's library key ----------------

_FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{calls}"
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; echo library > "$1"; fi
  shift
done
echo "ptxas info    : Used 10 registers"
"""


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    """A package tree with one source k.cu that includes h.cuh, built by a
    fake ``nvcc`` on PATH that writes its ``-o`` file; returns (csrc,
    a function giving the nvcc command lines run so far)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\nint k(void) { return 1; }\n')
    (csrc / "h.cuh").write_text("#pragma once\n")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "calls.txt"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(calls=calls))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", csrc / "build")
    monkeypatch.setattr(_build, "SOURCE_FLAGS", {})

    def ran():
        return calls.read_text().splitlines() if calls.exists() else []

    return csrc, ran


def test_build_reuses_the_library_of_the_same_key(fake_nvcc):
    csrc, ran = fake_nvcc
    lib = _build.library_path("k")
    assert lib.is_file() and lib.parent == csrc / "build"
    assert lib.name.startswith("libk.") and lib.suffix == ".so"
    assert len(ran()) == 1 and "-Xptxas=-v" in ran()[0]
    assert "Used 10 registers" in _build.compile_log("k")
    os.utime(csrc / "k.cu")  # a newer source file, the same text
    assert _build.library_path("k") == lib
    _build.build_all()
    assert len(ran()) == 1


@pytest.mark.parametrize("change", ["source_flags", "source", "header"])
def test_build_rebuilds_when_its_inputs_change(monkeypatch, fake_nvcc,
                                               change):
    csrc, ran = fake_nvcc
    first = _build.library_path("k")
    if change == "source_flags":
        monkeypatch.setattr(_build, "SOURCE_FLAGS", {"k": ("--fmad=false",)})
    elif change == "source":
        with open(csrc / "k.cu", "a") as fh:
            fh.write("int k2(void) { return 2; }\n")
    else:
        (csrc / "h.cuh").write_text("#pragma once\n#define KEY 1\n")
    _build.build_all()
    second = _build.library_path("k")
    assert second != first and second.is_file() and first.is_file()
    assert len(ran()) == 2
    assert ("--fmad=false" in ran()[1]) == (change == "source_flags")


@pytest.mark.parametrize("name", ["lstm_fwd_mma", "lstm_bwd_mma",
                                  "lstm_bwd_f32", "convbn_bwd",
                                  "lstm_wide", "lstm_wide_bwd",
                                  "lstm_fwd_f32", "lstm_general"])
def test_build_key_covers_the_shared_header(fake_nvcc, name):
    """The package's sources that include the shared header
    (``mma_sm90.cuh``: the tensor-core and cp.async helpers), copied as they
    are, rebuild when it changes, and only then."""
    csrc, ran = fake_nvcc
    real = Path(_build.__file__).resolve().parent.parent / "csrc"
    for f in (f"{name}.cu", "mma_sm90.cuh"):
        shutil.copy(real / f, csrc / f)
    assert '#include "mma_sm90.cuh"' in (csrc / f"{name}.cu").read_text()
    first = _build.library_path(name)
    assert _build.library_path(name) == first and len(ran()) == 1
    with open(csrc / "mma_sm90.cuh", "a") as fh:
        fh.write("// a changed helper\n")
    second = _build.library_path(name)
    assert second != first and second.is_file() and len(ran()) == 2


# ---------------- REMORA_TPU_CONVBN: a deliberate difference ----------------


@pytest.mark.parametrize("value", ["Pallas", "fast"])
def test_unknown_convbn_mode_raises_in_the_port(monkeypatch, value):
    """The port refuses an unknown ``REMORA_TPU_CONVBN`` (as the JAX package
    refuses an unknown ``REMORA_TPU_REFINE_DP``); the JAX package's
    ``_convbn_impl`` falls back to auto, plain on the CPU."""
    monkeypatch.setenv("REMORA_TPU_CONVBN", value)
    with pytest.raises(RemoraError, match="unknown REMORA_TPU_CONVBN"):
        TL.convbn_impl("cpu")
    assert JL._convbn_impl() == "plain"
    monkeypatch.setenv("REMORA_TPU_CONVBN", "pallas")
    assert TL.convbn_impl("cpu") == JL._convbn_impl() == "pallas"
