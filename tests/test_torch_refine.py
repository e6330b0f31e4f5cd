"""Signal-mapping refinement in remora_tpu_torch against the JAX package:
the building blocks.

The same numpy inputs (made from seeds) go through both packages on the
CPU: band construction, level tables and rescaling bit for bit; the plain
versions of K4/K5 against the Pallas kernels in interpret mode and the
host DPs; the native host library. The refiner and the stage it feeds are
in ``test_torch_prepare_stage.py``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import tb_row_case
from remora_tpu import RemoraError as JaxRemoraError
from remora_tpu.io import native as jax_native
from remora_tpu.kernels.pallas_dp import refine_batch_pallas
from remora_tpu.refine import band as jax_band
from remora_tpu.refine import dp as jax_dp
from remora_tpu.refine import levels as jax_levels
from remora_tpu.refine import refiner as jax_refiner
from remora_tpu.refine import rescale as jax_rescale
from remora_tpu_torch import RemoraError
from remora_tpu_torch.io import native as port_native
from remora_tpu_torch.kernels import banded_dp as K
from remora_tpu_torch.refine import band as port_band
from remora_tpu_torch.refine import dp as port_dp
from remora_tpu_torch.refine import levels as port_levels
from remora_tpu_torch.refine import rescale as port_rescale

from tests.test_torch_io import jax_native_loaded  # noqa: F401 (autouse)

ALGOS = ["Viterbi", "dwell_penalty"]
SDP = jax_refiner.compute_dwell_pen_array(4, 3, 0.5)


def _bps(rng, seq_len, max_spb):
    spb = rng.integers(1, max_spb, seq_len)
    return np.concatenate([[0], np.cumsum(spb)]).astype(np.int64)


# ---------------- band, levels, rescale: bit for bit ----------------


@pytest.mark.parametrize("seed", range(4))
def test_band_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        seq_len = int(rng.integers(5, 80))
        bps = _bps(rng, seq_len, 12)
        levels = rng.normal(size=seq_len).astype(np.float32)
        levels[rng.random(seq_len) < 0.05] = np.nan
        bhw = int(rng.integers(1, 8))
        sig_j = jax_band.compute_sig_band(bps, levels, bhw=bhw)
        sig_p = port_band.compute_sig_band(bps, levels, bhw=bhw)
        assert np.array_equal(sig_j, sig_p) and sig_j.dtype == sig_p.dtype
        seq_j = jax_band.convert_to_seq_band(sig_j)
        seq_p = port_band.convert_to_seq_band(sig_p)
        assert np.array_equal(seq_j, seq_p)
        jax_band.adjust_seq_band(seq_j, min_step=2)
        port_band.adjust_seq_band(seq_p, min_step=2)
        assert np.array_equal(seq_j, seq_p)
        ok_j = ok_p = True
        try:
            jax_band.validate_band(seq_j, sig_len=int(bps[-1]),
                                   seq_len=seq_len, is_sig_band=False)
        except JaxRemoraError:
            ok_j = False
        try:
            port_band.validate_band(seq_p, sig_len=int(bps[-1]),
                                    seq_len=seq_len, is_sig_band=False)
        except RemoraError:
            ok_p = False
        assert ok_j == ok_p


def _kmer_table(k=3):
    base_lvl = {"A": -1.0, "C": -0.3, "G": 0.3, "T": 1.0}
    return {
        kmer: base_lvl[kmer[k // 2]] + 0.2 * base_lvl[kmer[0]]
        + 0.1 * base_lvl[kmer[-1]]
        for kmer in jax_levels.all_kmers(k)
    }


def test_levels_match_jax(tmp_path):
    table = _kmer_table(5)
    path = tmp_path / "levels.txt"
    with open(path, "w") as fh:
        for kmer, level in table.items():
            fh.write(f"{kmer}\t{level}\n")
    got = port_levels.load_kmer_table(path)
    want = jax_levels.load_kmer_table(path)
    assert got == want
    arr_p = port_levels.levels_dict_to_array(*got)
    arr_j = jax_levels.levels_dict_to_array(*want)
    assert np.array_equal(arr_p, arr_j) and arr_p.dtype == arr_j.dtype
    assert port_levels.determine_dominant_pos(*got) == \
        jax_levels.determine_dominant_pos(*want)
    assert np.array_equal(port_levels.fix_gauge(arr_p),
                          jax_levels.fix_gauge(arr_j))
    int_seq = np.random.default_rng(0).integers(0, 4, 200)
    assert np.array_equal(
        port_levels.extract_levels(int_seq, arr_p, 5, 2),
        jax_levels.extract_levels(int_seq, arr_j, 5, 2),
    )


@pytest.mark.parametrize("n_points", [40, 1500])
def test_rescale_matches_jax(n_points):
    """Every estimator, including the Theil–Sen subsample past
    MAX_POINTS_FOR_THEIL_SEN, which draws from the global numpy RNG."""
    rng = np.random.default_rng(n_points)
    expected = rng.normal(size=n_points)
    raw = expected * 20 + 90 + rng.normal(0, 2, n_points)
    quants = np.arange(0.05, 1, 0.05)
    for name in ("quantile_lstsq_rescale", "quantile_theil_sen_rescale"):
        assert getattr(port_rescale, name)(raw, expected, 85.0, 18.0,
                                           quants) == \
            getattr(jax_rescale, name)(raw, expected, 85.0, 18.0, quants)
    for name in ("point_lstsq_rescale", "point_theil_sen_rescale"):
        np.random.seed(7)
        got = getattr(port_rescale, name)(raw, expected, 85.0, 18.0)
        np.random.seed(7)
        want = getattr(jax_rescale, name)(raw, expected, 85.0, 18.0)
        assert got == want, name


def test_native_matches_jax():
    rng = np.random.default_rng(5)
    e, m = rng.normal(size=300), rng.normal(size=300)
    assert port_native.theil_sen_slope(e, m) == \
        jax_native.theil_sen_slope(e, m)
    for algo in ALGOS:
        for _ in range(5):
            signal, levels, seq_band = _dp_read(rng, int(rng.integers(10, 120)))
            got = port_native.banded_dp_path(signal, levels, seq_band, SDP,
                                             algo)
            want = jax_native.banded_dp_path(signal, levels, seq_band, SDP,
                                             algo)
            assert got is not None and np.array_equal(got, want)


# ---------------- the plain K4/K5 against Pallas and the host ----------


def _dp_read(rng, seq_len, max_spb=8, bhw=5, stall=None):
    spb = rng.integers(1, max_spb, seq_len)
    if stall is not None:
        spb[seq_len // 2] = stall
    bps = np.concatenate([[0], np.cumsum(spb)]).astype(np.int64)
    levels = rng.normal(size=seq_len).astype(np.float32)
    signal = rng.normal(size=int(bps[-1])).astype(np.float32)
    seq_band = jax_band.convert_to_seq_band(
        jax_band.compute_sig_band(bps, levels, bhw=bhw))
    jax_band.adjust_seq_band(seq_band)
    return signal, levels, seq_band


def _dp_cases(kind):
    """The cases of tests/test_kernels.py: random reads of 8-30 bases, and
    heterogeneous band widths in one launch (one read with a 220-sample
    stall); plus reads of 5 to 60 bases in one launch."""
    if kind == "random":
        rng = np.random.default_rng(11)
        return [_dp_read(rng, int(rng.integers(8, 30)), bhw=3)
                for _ in range(4)]
    if kind == "stall":
        rng = np.random.default_rng(23)
        reads = []
        for k in range(6):
            seq_len = int(rng.integers(10, 24))
            if k % 3 == 2:
                reads.append(_dp_read(rng, seq_len, max_spb=40))
            else:
                reads.append(_dp_read(rng, seq_len, max_spb=5,
                                      stall=220 if k % 3 == 1 else None))
        widths = [int((sb[1] - sb[0]).max()) for _s, _l, sb in reads]
        assert max(widths) > 4 * min(widths), widths
        return reads
    rng = np.random.default_rng(37)
    return [_dp_read(rng, n) for n in (5, 60, 17, 33, 1 + 40)]


@pytest.mark.parametrize("kind", ["random", "stall", "lengths"])
@pytest.mark.parametrize("algo", ALGOS)
def test_plain_dp_matches_pallas_and_host(algo, kind):
    reads = _dp_cases(kind)
    got = K.refine_batch(reads, SDP, algo=algo, device="cpu")
    pallas = refine_batch_pallas(reads, SDP, algo=algo, interpret=True)
    for (signal, levels, seq_band), g, p in zip(reads, got, pallas):
        host = jax_dp.seq_banded_dp(signal, levels, seq_band, SDP, algo)[1]
        assert g.dtype == np.int32
        assert np.array_equal(g, p)
        assert np.array_equal(g, host)
        port_host = port_dp.seq_banded_dp(signal, levels, seq_band, SDP,
                                          algo)[1]
        assert np.array_equal(g, port_host)


def test_banded_dp_batch_layout():
    """tb is (R, N, W) int16 with W the launch width and 0 past each
    base's band; the path holds 0 first and the signal end from seq_len
    on; the CPU takes the plain versions and counts no launch."""
    reads = _dp_cases("lengths")
    packed = K.pad_reads_for_dp(reads)
    W = K.launch_width(packed["w_max"] + 5)
    launches = (K.LAUNCHES_FWD, K.LAUNCHES_TB)
    path, tb, _ = K.banded_dp_batch(
        packed["signal"], packed["levels"], packed["band_starts"],
        packed["band_widths"], packed["seq_lens"], SDP,
        w_max=packed["w_max"] + 5, device="cpu")
    assert (K.LAUNCHES_FWD, K.LAUNCHES_TB) == launches
    R, N = packed["levels"].shape
    assert tb.shape == (R, N, W) and tb.dtype == torch.int16
    assert path.shape == (R, N + 1) and path.dtype == torch.int32
    widths = torch.from_numpy(packed["band_widths"])
    past = torch.arange(W)[None, None, :] >= widths[:, :, None]
    assert not tb[past].any()
    for r, (_s, _l, seq_band) in enumerate(reads):
        n = packed["seq_lens"][r]
        assert path[r, 0] == 0
        assert (path[r, n:] == int(seq_band[1][-1])).all()
    with pytest.raises(RemoraError, match="launch width"):
        K.banded_dp_batch(
            packed["signal"], packed["levels"], packed["band_starts"],
            packed["band_widths"], packed["seq_lens"], SDP,
            w_max=packed["w_max"] - 8, device="cpu")


def test_dp_wrappers_refuse_other_devices():
    x = torch.zeros((1, 8), device="meta")
    with pytest.raises(RemoraError, match="no kernel for device"):
        K.dp_forward(x, x, x.int(), x.int(), x[0], True, 8)
    with pytest.raises(RemoraError, match="no kernel for device"):
        K.dp_traceback(torch.zeros((1, 2, 8), dtype=torch.int16,
                                   device="meta"), x.int(), x.int(), x[0])


# ---------------- K5's plain version against the Pallas walk ----------


def _pallas_traceback(tb, starts, widths, seq_lens, K=8):
    """The Pallas ``_traceback_kernel`` in interpret mode on (R, N, W)
    traceback rows, launched as ``_dp_jit`` launches it (the (N, W, R)
    layout, reads padded to ``LANES`` and bases to K) and its path
    assembled as ``_dp_jit`` assembles it."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from remora_tpu.kernels.pallas_dp import LANES, _traceback_kernel

    R0, N0, W = tb.shape
    R = -(-R0 // LANES) * LANES
    NC = -(-N0 // K)
    N = NC * K
    tb_p = np.zeros((N, W, R), np.int16)
    tb_p[:N0, :, :R0] = tb.transpose(1, 2, 0)
    st_p = np.zeros((R, N), np.int32)
    st_p[:R0, :N0] = starts
    st_p[:R0, N0:] = starts[:, -1:]
    wd_p = np.ones((R, N), np.int32)
    wd_p[:R0, :N0] = widths
    sl_p = np.ones(R, np.int32)
    sl_p[:R0] = np.maximum(seq_lens, 1)
    ridx = np.arange(R)
    ends = (st_p[ridx, sl_p - 1] + wd_p[ridx, sl_p - 1]).astype(np.int32)
    path_mid = pl.pallas_call(
        partial(_traceback_kernel, K=K, W=W, NC=NC),
        grid=(R // LANES, NC),
        in_specs=[
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec((K, LANES), lambda r, c: (NC - 1 - c, r),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, LANES), lambda r, c: (0, r),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, LANES), lambda r, c: (0, r),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((K, LANES), lambda r, c: (NC - 1 - c, r),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((N, R), jnp.int32),
        scratch_shapes=[
            pltpu.VMEM((8, LANES), jnp.int32),
            pltpu.VMEM((2, W, LANES), jnp.int16),
            pltpu.SemaphoreType.DMA((2,)),
        ],
        interpret=True,
    )(jnp.asarray(tb_p), jnp.asarray(st_p.T), jnp.asarray(sl_p[None, :]),
      jnp.asarray(ends[None, :]))
    path = np.concatenate([np.zeros((R, 1), np.int32),
                           np.asarray(path_mid).T[:, 1:N0],
                           np.zeros((R, 1), np.int32)], 1)
    path[ridx, sl_p] = ends
    return path[:R0], ends[:R0]


@pytest.mark.parametrize("kind", ["codes", "wild"])
@pytest.mark.parametrize("W", [8, 16])
def test_plain_traceback_matches_pallas_on_arbitrary_rows(W, kind):
    """The plain K5 (what ``dp_traceback`` runs on CPU tensors) against the
    Pallas walk, exactly, on the rows ``chip_smoke.py`` holds the kernel to
    (``tb_row_case``): entries clamped to the row, steps of either sign and
    wider than W, paths that leave the band, seq_lens 1 and N."""
    case = tb_row_case(W + (kind == "wild"), 5, 37, W, kind, "cpu")
    launches = K.LAUNCHES_TB
    got = K.dp_traceback(*case).numpy()
    assert K.LAUNCHES_TB == launches
    tb, starts, widths, seq_lens = (t.numpy() for t in case)
    want, ends = _pallas_traceback(tb, starts, widths, seq_lens)
    N = tb.shape[1]
    # the Pallas assembly leaves column N at 0 past seq_len (callers read
    # path[:seq_len + 1]); the port writes the signal end there
    assert np.array_equal(got[:, :N], want[:, :N])
    assert np.array_equal(got[:, N], ends)
    assert np.array_equal(want[seq_lens == N, N], ends[seq_lens == N])
    walked = np.concatenate([got[r, 1:n] for r, n in enumerate(seq_lens)])
    assert np.unique(walked).size > N  # the walks really moved
