"""The port's command line (``python -m remora_tpu_torch``) against the
JAX package's (``python -m remora_tpu``) on the CPU.

Both CLIs run in-process on synthetic sets
(``tests/test_torch_io.py::write_test_set``,
``tests/test_torch_prepare.py::write_prepare_set``,
``chip_smoke.py::write_duplex_set``) with the size-16 checkpoint of
``tests/test_torch_infer_pipeline.py``:

- every subcommand has the JAX CLI's option strings and positional arity;
- the same argv reaches each wrapped driver with equal arguments, apart
  from the port's explicit device;
- ``dataset prepare`` writes the JAX CLI's arrays and metadata, and
  ``dataset inspect``, ``head``, ``copy``, ``make_config`` and ``merge``
  its outputs; ``model inspect`` and ``list_pretrained`` print its text;
- ``infer from_pod5_and_bam`` and ``infer duplex_from_pod5_and_bam``
  with ``--device cpu`` write its f32 MM/ML tags by read id;
- ``analyze estimate_kmer_levels`` writes its level table, and the two
  plot subcommands write a non-empty file;
- ``model train --device cpu`` writes a checkpoint the JAX package
  loads;
- without ``--device`` and without a GPU a subcommand raises (no silent
  CPU run). The data-parallel flags run in
  ``tests/test_torch_multiprocess.py``.

Every run that forks pipeline stages is time-bounded.
"""

import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch

import remora_tpu_torch
from chip_smoke import synth_level_table, write_duplex_set
from remora_tpu.cli import main as jax_main
from remora_tpu.io import bam as jax_bam
from remora_tpu.io.pod5_write import Pod5Writer
from remora_tpu_torch import RemoraError
from remora_tpu_torch.cli import main as port_main

from tests.test_torch_infer_pipeline import (assert_identical_outputs,
                                             ml_of, time_limit, write_model)
from tests.test_torch_io import jax_native_loaded  # noqa: F401 (autouse)
from tests.test_torch_io import write_test_set
from tests.test_torch_prepare import assert_same_datasets, write_prepare_set

CPU = ["--device", "cpu"]


def run_jax_cli(*argv):
    """The JAX CLI in-process (its ``run`` without the platform switch,
    which the tests' environment already sets)."""
    args = jax_main.build_parser().parse_args([str(a) for a in argv])
    with time_limit():
        args.func(args)


def run_port_cli(*argv):
    with time_limit():
        port_main.run([str(a) for a in argv])


CLIS = {"jax": run_jax_cli, "port": run_port_cli}


def write_level_table(path, kmer_len=5):
    """``chip_smoke.synth_level_table`` as a k-mer level file."""
    from remora_tpu_torch.refine.levels import all_kmers

    table, _center = synth_level_table(kmer_len)
    with open(path, "w") as fh:
        for kmer, level in zip(all_kmers(kmer_len), table):
            fh.write(f"{kmer}\t{level}\n")
    return str(path)


def prepare_argv(pod5, bam, out, table):
    """``dataset prepare`` at ``tests/test_torch_prepare.py``'s settings,
    with the native refiner on ``table``."""
    return ["dataset", "prepare", pod5, bam, "--output-path", out,
            "--mod-base", "m", "5mC", "--motif", "CG", "0",
            "--chunk-context", "50", "50", "--kmer-context-bases", "2", "2",
            "--min-samples-per-base", "6", "--max-chunks-per-read", "100",
            "--refine-kmer-level-table", table, "--refine-rough-rescale",
            "--refine-scale-iters", "0", "--refine-backend", "native"]


@pytest.fixture(scope="module", autouse=True)
def _no_index_cache():
    """No BAM index cache under $HOME, for the module's fixtures too."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REMORA_TPU_BAM_INDEX_CACHE", "0")
        yield


def assert_same_dataset_dirs(got, want):
    """Identical datasets (``tests/test_torch_prepare.py``'s check), the
    CLI's log file aside: each run writes its own ``log.txt`` there."""
    for path in (got, want):
        (path / "log.txt").unlink(missing_ok=True)
    return assert_same_datasets(got, want)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_cli")


@pytest.fixture(scope="module")
def data_set(workdir):
    sub = workdir / "set"
    sub.mkdir()
    return write_test_set(sub)


@pytest.fixture(scope="module")
def model_path(workdir):
    return write_model(workdir, "size16.npz")


@pytest.fixture(scope="module")
def level_table(workdir):
    return write_level_table(workdir / "levels_5mer.txt")


@pytest.fixture(scope="module")
def prepared(workdir, level_table):
    """{package: dataset path} of ``dataset prepare`` through each CLI on
    the prepare set, the global NumPy RNG seeded alike first."""
    sub = workdir / "prep"
    sub.mkdir()
    pod5, bam = write_prepare_set(sub)
    outs = {}
    for package, run in CLIS.items():
        outs[package] = workdir / f"prep_{package}"
        np.random.seed(5)
        run(*prepare_argv(pod5, bam, outs[package], level_table))
    return outs


# ---------------- the flag surface ----------------


def _surface(parser, prefix=""):
    """{subcommand: (option strings, positional arities)}: the walk of
    ``tests/test_cli.py::test_cli_flag_surface_matches_reference``."""
    out, opts, pos = {}, set(), []
    for a in parser._actions:
        opts.update(a.option_strings)
        if not a.option_strings and not isinstance(
                a, argparse._SubParsersAction):
            pos.append("v" if a.nargs in ("*", "+") else a.nargs)
        if hasattr(a, "choices") and isinstance(a.choices, dict):
            for name, sub in a.choices.items():
                out.update(_surface(sub, f"{prefix}{name} "))
    out[prefix.strip()] = (opts, pos)
    return out


def test_flag_surface_matches_jax():
    want = _surface(jax_main.build_parser())
    got = _surface(port_main.build_parser())
    assert got.keys() == want.keys()
    assert len(want) == 25
    for key, (opts, pos) in want.items():
        assert got[key][0] == opts, (key, opts ^ got[key][0])
        assert got[key][1] == pos, key


# ---------------- driver arguments ----------------


def _plain(value):
    """A comparable form of a driver argument: dataclasses (Motif,
    SigMapRefiner, TrainOpts) by their fields, the refiner's runtime
    device left out."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__, {
            f.name: _plain(getattr(value, f.name))
            for f in dataclasses.fields(value) if f.name != "device"})
    if isinstance(value, np.ndarray):
        return ("array", value.dtype.str, value.shape, value.tolist())
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, [_plain(v) for v in value])
    if isinstance(value, np.generic):
        return value.item()
    return value


def _capture(monkeypatch, module, name):
    calls = []

    def fake(*args, **kwargs):
        assert not args
        calls.append(kwargs)

    monkeypatch.setattr(module, name, fake)
    return calls


def _driver_argv(kind, paths):
    pod5, bam, model, out = (paths[k] for k in ("pod5", "bam", "model",
                                                "out"))
    if kind == "train":
        return ["model", "train", paths["config"], "--output-path", out,
                "--overwrite", "--size", "8", "--epochs", "2", "--seed",
                "3", "--opt-kwargs", "weight_decay", "1e-5", "float",
                "--high-conf-incorrect-thr-frac", "0.1", "0.2",
                "--chunk-context", "50", "50", "--bf16", *CPU]
    if kind == "prepare":
        return [*prepare_argv(pod5, bam, out, paths["table"]),
                "--overwrite", "--num-reads", "5", "--reverse-signal"]
    if kind == "infer":
        return ["infer", "from_pod5_and_bam", pod5, bam, "--model", model,
                "--out-bam", out, "--batch-size", "64",
                "--reference-anchored", "--refine-backend", "native",
                "--bf16", *CPU]
    if kind == "duplex":
        return ["infer", "duplex_from_pod5_and_bam", pod5, bam, bam,
                paths["pairs"], "--model", model, "--out-bam", out,
                "--duplex-delim", ":", "--num-duplex-prep-workers", "2",
                *CPU]
    return ["validate", "from_modbams", "--bam-and-bed", bam,
            paths["bed"], "--seed", "2", "--pct-filt", "5",
            "--max-sites-per-read", "3", "--extra-bases", "h"]


DRIVERS = {
    "train": ("train.train", "train_model"),
    "prepare": ("prepare", "extract_chunk_dataset"),
    "infer": ("infer.infer", "infer_from_pod5_and_bam"),
    "duplex": ("infer.duplex_infer", "infer_duplex"),
    "validate_modbams": ("validate_modbam", "validate_modbams"),
}


@pytest.mark.parametrize("kind", DRIVERS)
def test_driver_arguments_match_jax(kind, workdir, data_set, model_path,
                                    level_table, monkeypatch):
    """The same argv through both CLIs reaches the wrapped driver with
    equal keyword arguments; the port's also carry the device, and the
    streaming inference driver's its mesh (none without the distributed
    options)."""
    import importlib

    paths = {"pod5": data_set[0], "bam": data_set[1], "model": model_path,
             "out": str(workdir / f"args_{kind}"), "table": level_table,
             "config": str(workdir / "args.cfg"),
             "pairs": str(workdir / "args_pairs.txt"),
             "bed": str(workdir / "args.bed")}
    argv = _driver_argv(kind, paths)
    module, name = DRIVERS[kind]
    calls = {}
    for package, run in (("remora_tpu", run_jax_cli),
                         ("remora_tpu_torch", run_port_cli)):
        mod = importlib.import_module(f"{package}.{module}")
        calls[package] = _capture(monkeypatch, mod, name)
        run(*argv)
    (want,), (got,) = calls["remora_tpu"], calls["remora_tpu_torch"]
    if kind == "train":
        assert got.pop("device") == torch.device("cpu")
    if kind == "infer":
        assert got.pop("mesh") is None
    if kind in ("infer", "duplex"):
        # ModelHandles of each package, f32 on the CPU (--bf16 is
        # ignored there by both CLIs)
        jm, pm = want.pop("models"), got.pop("models")
        assert len(jm) == len(pm) == 1
        assert pm[0].device == torch.device("cpu")
        assert pm[0].compute_dtype is None and jm[0].compute_dtype is None
        assert pm[0].metadata["alphabet_str"] == jm[0].metadata[
            "alphabet_str"]
    assert got.keys() == want.keys()
    for key in want:
        assert _plain(got[key]) == _plain(want[key]), key


# ---------------- the device rule and the flags that raise ----------------


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("kind", ["train", "infer", "duplex", "validate"])
def test_no_device_flag_without_gpu_raises(kind, workdir, data_set,
                                           model_path, monkeypatch):
    """With no GPU, a subcommand that runs a model and names no device
    raises before it runs anything: it never falls back to the CPU."""
    _no_gpu(monkeypatch)
    out = workdir / f"nogpu_{kind}"
    pod5, bam = data_set
    if kind == "train":
        argv = ["model", "train", workdir / "none.cfg", "--output-path", out]
    elif kind == "infer":
        argv = ["infer", "from_pod5_and_bam", pod5, bam, "--model",
                model_path, "--out-bam", out]
    elif kind == "duplex":
        argv = ["infer", "duplex_from_pod5_and_bam", pod5, bam, bam,
                workdir / "none.txt", "--model", model_path, "--out-bam",
                out]
    else:
        argv = ["validate", "from_remora_dataset", workdir / "none",
                "--model", model_path]
    with pytest.raises(RemoraError, match="no CUDA device"):
        run_port_cli(*argv)
    assert not out.exists()


def test_run_takes_an_argument_list(capsys):
    """``run(argv)`` parses the list it is given (``chip_smoke.py`` and
    the tests drive the CLI in-process)."""
    with pytest.raises(SystemExit) as err:
        port_main.run(["--version"])
    assert err.value.code == 0
    assert capsys.readouterr().out.strip() == (
        f"remora_tpu_torch {remora_tpu_torch.__version__}")


def test_device_flag_forms():
    from remora_tpu_torch.cli.util import parse_device

    assert parse_device("cpu") == torch.device("cpu")
    assert parse_device("cuda") == torch.device("cuda")
    assert parse_device("1") == torch.device("cuda", 1)
    assert parse_device("cuda:2") == torch.device("cuda", 2)


# ---------------- dataset subcommands ----------------


def test_dataset_prepare_matches_jax(prepared):
    assert_same_dataset_dirs(prepared["port"], prepared["jax"])


def test_dataset_inspect_matches_jax(prepared, workdir, capsys):
    out = {}
    for package, run in CLIS.items():
        cfg = workdir / f"inspect_{package}.jsn"
        run("dataset", "inspect", prepared["port"], "--out-path", cfg)
        out[package] = (capsys.readouterr().out, cfg.read_text())
    assert out["port"] == out["jax"]
    assert "size" in out["port"][0].lower()


@pytest.mark.parametrize("sub", ["head", "copy", "make_config", "merge"])
def test_dataset_subcommands_match_jax(sub, prepared, workdir):
    ds = prepared["port"]
    outs = {}
    for package, run in CLIS.items():
        out = outs[package] = workdir / f"{sub}_{package}"
        if sub == "head":
            run("dataset", "head", out, ds, 17)
        elif sub == "copy":
            run("dataset", "copy", ds, out)
        elif sub == "make_config":
            run("dataset", "make_config", out, ds, prepared["jax"],
                "--dataset-weights", "1", "3")
        else:
            np.random.seed(8)
            run("dataset", "merge", out, ds, prepared["jax"],
                "--max-size", "150")
    if sub == "make_config":
        want = json.loads(outs["jax"].read_text())
        assert json.loads(outs["port"].read_text()) == want
        assert len(want) == 2 and len(want[0]) == 3
    else:
        want = assert_same_dataset_dirs(outs["port"], outs["jax"])
        if sub == "head":
            assert want["labels"].size == 17


# ---------------- model subcommands ----------------


def test_model_inspect_and_list_pretrained_match_jax(model_path, capsys):
    out = {}
    for package, run in CLIS.items():
        run("model", "inspect", model_path)
        run("model", "list_pretrained", "--pore", "dna_r10.4.1_e8.2_400bps",
            "--modified-bases", "5mc")
        out[package] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert "num_params" in out["port"] and "Model_Name" in out["port"]


def test_model_train_writes_a_checkpoint_jax_loads(prepared, workdir):
    """``model train --device cpu``: one short epoch on the prepared
    dataset; the JAX package loads the checkpoint with the port's
    weights."""
    from remora_tpu.models import model_io as jax_io
    from remora_tpu_torch.models import model_io

    cfg = workdir / "train.cfg"
    cfg.write_text(json.dumps([[str(prepared["port"]), 1.0]]))
    out = workdir / "train_out"
    run_port_cli("model", "train", cfg, "--output-path", out, *CPU,
                 "--size", "8", "--batch-size", "16", "--epochs", "1",
                 "--chunks-per-epoch", "32", "--num-test-chunks", "16",
                 "--seed", "1", "--scheduler", "constant")
    ckpt = out / "model_final.checkpoint"
    _model, params, _bn, meta = jax_io.load_model(str(ckpt))
    port_model, port_meta = model_io.load_model(ckpt)
    assert meta["model_params"] == port_meta["model_params"]
    assert meta["model_params"]["size"] == 8
    sd = port_model.state_dict()
    assert np.array_equal(np.asarray(params["lstm1"]["w_ih"]),
                          sd["lstm1.w_ih"].numpy())
    with open(out / "batch.log") as fh:
        assert len(fh.readlines()) == 3  # the header and two steps


# ---------------- inference ----------------


def test_infer_tags_match_jax(data_set, model_path, workdir):
    outs = {}
    for package, run in CLIS.items():
        outs[package] = workdir / f"infer_{package}.bam"
        run("infer", "from_pod5_and_bam", *data_set, "--model", model_path,
            "--out-bam", outs[package], "--batch-size", "64", *CPU)
    want, n_calls = assert_identical_outputs(outs["port"], outs["jax"])
    assert len(want) > 5 and n_calls > 64


def test_infer_duplex_tags_match_jax(model_path, workdir):
    from remora_tpu_torch.refine.levels import extract_levels

    from tests.test_torch_infer_pipeline import KMER_LEN

    sub = workdir / "duplex"
    sub.mkdir()
    pod5 = sub / "simplex.pod5"
    table, center = synth_level_table(KMER_LEN)
    with Pod5Writer(str(pod5)) as p5w:
        paths = write_duplex_set(
            str(sub), 6, 240, jax_bam,
            lambda rid, dacs: p5w.add_read(rid, dacs, 90.0, 20.0),
            levels_of=lambda s: extract_levels(s, table, KMER_LEN, center))
    outs = {}
    for package, run in CLIS.items():
        outs[package] = sub / f"{package}.bam"
        run("infer", "duplex_from_pod5_and_bam", pod5, *paths, "--model",
            model_path, "--out-bam", outs[package], *CPU)
    tags = {}
    for package, path in outs.items():
        tags[package] = {
            rec.query_name: (rec.tag_dict()["MM"], ml_of(rec).tolist())
            for rec in jax_bam.FastBamScanner(str(path))}
    # two pairs lack a duplex record or a complement's signal
    assert len(tags["jax"]) == 4
    assert tags["port"] == tags["jax"]


# ---------------- analyze ----------------


def test_estimate_kmer_levels_matches_jax(data_set, workdir):
    outs = {}
    for package, run in CLIS.items():
        outs[package] = workdir / f"levels_{package}.txt"
        run("analyze", "estimate_kmer_levels", "--pod5-and-bam", *data_set,
            "--out-path", outs[package], "--kmer-context-bases", "1", "1",
            "--min-coverage", "1", "--chunk-len", "2000")
    want = outs["jax"].read_text()
    assert outs["port"].read_text() == want
    lines = want.splitlines()
    assert len(lines) == 64
    assert sum(not line.endswith("nan") for line in lines) > 32


def test_plot_subcommands_write_files(data_set, workdir):
    from remora_tpu_torch.io.bam import FastBamScanner

    rec = next(r for r in FastBamScanner(data_set[1])
               if not r.is_reverse and r.is_mapped)
    start = rec.reference_start + 20
    bed = workdir / "regions.bed"
    bed.write_text(f"{rec.reference_name}\t{start}\t{start + 30}\t.\t0\t+\n")
    pdf = workdir / "regions.pdf"
    run_port_cli("analyze", "plot", "ref_region", "--pod5-and-bam",
                 *data_set, "--ref-regions", bed, "--plots-filename", pdf)
    svg = workdir / "region.svg"
    run_port_cli("analyze", "plot_ref_region", "--pod5-and-bam", *data_set,
                 "--ref-reg", f"{rec.reference_name}:{start}-{start + 30}:+",
                 "--out-path", svg)
    assert pdf.stat().st_size > 1000 and svg.stat().st_size > 1000
