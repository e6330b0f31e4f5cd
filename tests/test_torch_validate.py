"""The port's validation subcommands against the JAX package's on the
CPU, both CLIs in-process.

- ``validate from_remora_dataset --device cpu``: the size-16 checkpoint
  of ``tests/test_torch_infer_pipeline.py`` on a dataset that the port's
  ``dataset prepare`` wrote from ``tests/test_torch_prepare.py``'s set;
- ``validate from_modbams``: the modBAM that the port's ``infer`` wrote
  from ``tests/test_torch_io.py``'s set, against a ground-truth BED that
  labels the forward reads' spans 5mC and C in turn (the port's
  ``validate_modbam.py`` over its BAM scanner).

Both write the same tables: every text field equal and every metric
within 1e-6. The full-results files hold equal text too; their per-chunk
probabilities (from_remora_dataset) come from the two packages' f32
forwards, held to the port's f32 logit contract, 1e-5 (ROADMAP's ground
rules); from_modbams' are the BAM's bytes and held to 1e-6.
"""

import re

import numpy as np
import pytest

from remora_tpu_torch.io.bam import FastBamScanner

from tests.test_torch_cli import CLIS, CPU, run_port_cli
from tests.test_torch_cli import _no_index_cache  # noqa: F401 (autouse)
from tests.test_torch_infer_pipeline import write_model
from tests.test_torch_io import jax_native_loaded  # noqa: F401 (autouse)
from tests.test_torch_io import write_test_set
from tests.test_torch_prepare import write_prepare_set

_NUMBER = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_validate")


@pytest.fixture(scope="module")
def model_path(workdir):
    return write_model(workdir, "size16.npz")


def assert_same_tables(got, want, tol=1e-6):
    """Equal text with every numeric field within ``tol``."""
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines) > 0
    n_numbers = 0
    for g_line, w_line in zip(got_lines, want_lines):
        g_fields, w_fields = re.split(r"[\s,]+", g_line), re.split(
            r"[\s,]+", w_line)
        assert len(g_fields) == len(w_fields), (g_line, w_line)
        for g, w in zip(g_fields, w_fields):
            if _NUMBER.match(w) and _NUMBER.match(g):
                assert abs(float(g) - float(w)) <= tol, (g_line, w_line)
                n_numbers += 1
            else:
                assert g == w, (g_line, w_line)
    return n_numbers


def test_validate_from_dataset_matches_jax(workdir, model_path, capsys):
    sub = workdir / "prep"
    sub.mkdir()
    pod5, bam = write_prepare_set(sub)
    ds = workdir / "dataset"
    np.random.seed(3)
    run_port_cli("dataset", "prepare", pod5, bam, "--output-path", ds,
                 "--mod-base", "m", "5mC", "--motif", "CG", "0",
                 "--chunk-context", "50", "50", "--kmer-context-bases", "4",
                 "4", "--min-samples-per-base", "6")
    capsys.readouterr()
    outs = {}
    for package, run in CLIS.items():
        table = workdir / f"val_{package}.txt"
        full = workdir / f"val_full_{package}.txt"
        run("validate", "from_remora_dataset", ds, "--model", model_path,
            "--batch-size", "64", "--out-file", table,
            "--full-results-filename", full, *CPU)
        outs[package] = (table.read_text(), full.read_text(),
                         capsys.readouterr().out)
    for got, want, tol in zip(outs["port"], outs["jax"], (1e-6, 1e-5, 1e-6)):
        assert_same_tables(got, want, tol)
    assert outs["jax"][2].startswith("acc=")
    # one row a chunk after the header
    assert len(outs["jax"][1].splitlines()) > 64


def _ground_truth_bed(bam, path):
    """5mC over every other forward read's span, C over the others."""
    lines = []
    fwd = [r for r in FastBamScanner(bam)
           if r.is_mapped and not r.is_reverse and not r.is_secondary]
    for i, rec in enumerate(fwd):
        name = "m" if i % 2 == 0 else "C"
        lines.append(f"{rec.reference_name}\t{rec.reference_start}\t"
                     f"{rec.reference_end}\t{name}\t0\t+\n")
    path.write_text("".join(lines))
    return str(path)


def test_validate_from_modbams_matches_jax(workdir, model_path):
    sub = workdir / "set"
    sub.mkdir()
    pod5, bam = write_test_set(sub)
    modbam = workdir / "calls.bam"
    run_port_cli("infer", "from_pod5_and_bam", pod5, bam, "--model",
                 model_path, "--out-bam", modbam, "--batch-size", "64", *CPU)
    bed = _ground_truth_bed(bam, workdir / "gt.bed")
    outs = {}
    for package, run in CLIS.items():
        table = workdir / f"modbam_{package}.txt"
        full = workdir / f"modbam_full_{package}.txt"
        run("validate", "from_modbams", "--bam-and-bed", modbam, bed,
            "--seed", "1", "--out-file", table, "--full-results-filename",
            full, "--name", "synth", "--pct-filt", "20")
        outs[package] = (table.read_text(), full.read_text())
    n_numbers = 0
    for got, want in zip(outs["port"], outs["jax"]):
        n_numbers += assert_same_tables(got, want)
    assert "synth" in outs["jax"][0] and n_numbers > 100
