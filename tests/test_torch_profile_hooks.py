"""The streaming driver's per-stage cProfile hooks on the CPU: the port's
``REMORA_TPU_INFER_{BATCH,RUN_MODEL,UNBATCH}_PROFILE_FILE`` (and the unused
``PREP_DATA`` one), read once at import as in the JAX package. Each stage's
variable alone makes its thread dump a loadable pstats file holding the
stage's function, and leaves the f32 tags byte-identical to a run without
it and to the JAX driver's. Two at once raise ``RemoraError`` before any
stage starts where cProfile cannot run them together (Python 3.12 and
later), a deliberate difference: the JAX driver loses one stage mid-stream
instead."""

import os
import pstats
import subprocess
import sys
import types

import pytest

from remora_tpu_torch import RemoraError
from remora_tpu_torch.infer import infer
from tests.test_torch_infer_pipeline import (  # noqa: F401 (fixtures)
    _no_index_cache,
    assert_identical_outputs,
    data_set,
    model_path,
    run_jax,
    run_port,
    workdir,
)

# the stage: the module attribute that holds its variable, the variable,
# and the functions of ``infer/infer.py`` that only that stage's thread runs
STAGES = {
    "batch": ("_PROF_BATCH_FN", "REMORA_TPU_INFER_BATCH_PROFILE_FILE",
              {"batch_reads", "add", "_paste", "_reset", "drain"}),
    "run_model": ("_PROF_MODEL_FN", "REMORA_TPU_INFER_RUN_MODEL_PROFILE_FILE",
                  {"run_model_batched", "launch", "emit_oldest",
                   "_timed_iter", "_eval"}),
    "unbatch": ("_PROF_UNBATCH_FN", "REMORA_TPU_INFER_UNBATCH_PROFILE_FILE",
                {"unbatch", "feed", "flush", "_join"}),
}


@pytest.fixture(scope="module")
def unprofiled(data_set, model_path, workdir):
    """The JAX driver's and the port's f32 runs without a profile."""
    pod5, bam = data_set
    n_jax, _ = run_jax(pod5, bam, model_path, workdir / "prof_jax.bam")
    n_port, _ = run_port(pod5, bam, model_path, workdir / "prof_port.bam")
    assert n_port == n_jax > 0
    return workdir / "prof_jax.bam", workdir / "prof_port.bam"


@pytest.fixture
def no_profiles(monkeypatch):
    for attr, _var, _funcs in STAGES.values():
        monkeypatch.setattr(infer, attr, None)


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_profile_writes_pstats(stage, data_set, model_path, workdir,
                                     unprofiled, no_profiles, monkeypatch):
    attr, _var, funcs = STAGES[stage]
    prof = workdir / f"{stage}.pstats"
    monkeypatch.setattr(infer, attr, str(prof))
    pod5, bam = data_set
    out = workdir / f"prof_{stage}.bam"
    n, _ = run_port(pod5, bam, model_path, out)
    assert n > 0
    # from Python 3.12 cProfile records every thread while the stage runs,
    # on one call stack: a call still open when it stops (the stage's own
    # function may be one, its context popped by another thread's return)
    # is left out, so the file is held to the stage's calls that returned
    stats = pstats.Stats(str(prof))
    names = {func for path, _line, func in stats.stats
             if path.endswith(os.path.join("infer", "infer.py"))}
    assert names & funcs, sorted(names)
    assert stats.total_calls > 0
    want_jax, want_port = unprofiled
    assert_identical_outputs(out, want_port)
    assert_identical_outputs(out, want_jax)


@pytest.mark.parametrize("pair", [("batch", "run_model"),
                                  ("batch", "unbatch"),
                                  ("run_model", "unbatch")])
def test_two_stage_profiles_raise_before_any_stage(pair, data_set,
                                                   model_path, workdir,
                                                   no_profiles, monkeypatch):
    """Two stages' variables at once: ``RemoraError`` naming both, before
    the BAM index is read or a stage is started (nothing is written)."""
    for stage in pair:
        monkeypatch.setattr(infer, STAGES[stage][0],
                            str(workdir / f"two_{stage}.pstats"))

    def started(*_a, **_k):
        raise AssertionError("a stage started")

    monkeypatch.setattr(infer, "ReadIndexedBam", started)
    monkeypatch.setattr(infer, "source_stage", started)
    pod5, bam = data_set
    out = workdir / "two.bam"
    handle = infer.ModelHandle.load(model_path, device="cpu")
    names = " and ".join(STAGES[stage][1] for stage in pair)
    with pytest.raises(RemoraError, match=names):
        infer.infer_from_pod5_and_bam(pod5, bam, [handle], str(out),
                                      batch_size=64)
    assert not out.exists()
    assert not any((workdir / f"two_{s}.pstats").exists() for s in pair)


def test_two_stage_profiles_pass_before_3_12(monkeypatch):
    """The refusal is 3.12's: before it, cProfile runs a profile a thread,
    and the check lets two stages' profiles through."""
    for stage in ("batch", "unbatch"):
        monkeypatch.setattr(infer, STAGES[stage][0], f"{stage}.pstats")
    monkeypatch.setattr(infer, "sys",
                        types.SimpleNamespace(version_info=(3, 11, 9)))
    infer._check_stage_profiles()
    monkeypatch.setattr(infer, "sys",
                        types.SimpleNamespace(version_info=(3, 12, 0)))
    with pytest.raises(RemoraError, match="one profile a process"):
        infer._check_stage_profiles()


def test_profile_variables_are_read_at_import(tmp_path):
    """The four variables are read when the module is imported, as the JAX
    package reads them; PREP_DATA is read and unused."""
    env = dict(os.environ)
    for key, (_attr, var, _funcs) in STAGES.items():
        env[var] = str(tmp_path / f"{key}.pstats")
    env["REMORA_TPU_INFER_PREP_DATA_PROFILE_FILE"] = str(tmp_path / "prep")
    code = ("from remora_tpu_torch.infer import infer as m; print(m."
            "_PROF_PREP_FN, m._PROF_BATCH_FN, m._PROF_MODEL_FN, "
            "m._PROF_UNBATCH_FN)")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.split() == [str(tmp_path / name) for name in (
        "prep", "batch.pstats", "run_model.pstats", "unbatch.pstats")]
