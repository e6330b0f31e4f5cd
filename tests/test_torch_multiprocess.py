"""The port's data parallelism end to end over spawned gloo ranks on the
CPU: ``train_model`` with a mesh, multi-process and multi-device
inference, the command line's distributed flags and
``parallel.mesh.dryrun_multichip``.

- ``train_model`` over 2 ranks, each streaming its own super-batch
  stripe (``data.dataset.shard_for_process``): the ranks write the same
  ``batch.log``, ``validation.log`` and checkpoints, and the losses are
  within 1e-4 of the JAX package's 2-device step fed the concatenated
  stripes (``tests/test_multihost.py``'s contract, on synthetic data).
- ``infer from_pod5_and_bam --num-processes 2`` writes one merged BAM
  equal to the port's one-process run and, record for record in order,
  to the JAX package's 2-process merge (``tests/_dist_infer_worker.py``).
- The device stage split over two CPU replicas writes the tags of one
  device, at a batch that divides and one that does not.

Every rank runs under ``parallel.mesh.spawn_ranks``: a rank that dies
fails the test at once, a hung run at its time limit, and collectives
time out after 60 s (``REMORA_TPU_DIST_TIMEOUT_S``).
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from remora_tpu_torch import RemoraError
from remora_tpu_torch.parallel import mesh as P

REPO = str(Path(__file__).resolve().parent.parent)
WORLD, BATCH, SIZE, CTX = 2, 32, 16, (25, 25)
SUPER_BATCH, CHUNKS_PER_EPOCH, TEST_CHUNKS = 32, 96, 32
SGD = dict(epochs=2, optimizer_str="sgd", learning_rate=0.05,
           lr_scheduler_str="constant")
INFER_BATCH = 128  # tests/_dist_infer_worker.py's
RANK_TIMEOUT_S = 240


def rank_env(**extra):
    """The ranks' environment: this checkout importable, one OpenMP
    thread, collectives timing out after 60 s, no BAM index cache, no
    progress bars."""
    return dict(P.package_env(), OMP_NUM_THREADS="1",
                REMORA_TPU_DIST_TIMEOUT_S="60",
                REMORA_TPU_BAM_INDEX_CACHE="0", LOG_SAFE="1", **extra)


def train_rank(rank, world, port, config, init, out):
    """One rank of ``train_model`` with a gloo mesh (SGD, fine-tuning from
    ``init``), writing into ``out``."""
    from remora_tpu_torch.train import optim, train

    P.init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo",
                     device="cpu", timeout_s=60)
    try:
        train.train_model(
            seed=5, out_path=out, remora_dataset_path=config,
            chunk_context=CTX, kmer_context_bases=(4, 4),
            batch_size=BATCH, model_name="ConvLSTM_w_ref", size=SIZE,
            train_opts=optim.TrainOpts(**SGD),
            chunks_per_epoch=CHUNKS_PER_EPOCH, num_test_chunks=TEST_CHUNKS,
            super_batch_size=SUPER_BATCH, finetune_path=init,
            mesh=P.make_mesh("cpu"),
        )
    finally:
        P.teardown()


def cli_train_argv(config, out, rank, port, sync_bn):
    return [sys.executable, "-m", "remora_tpu_torch", "model", "train",
            config, "--output-path", out, "--device", "cpu", "--size", "8",
            "--batch-size", str(BATCH), "--epochs", "1",
            "--chunks-per-epoch", "64", "--num-test-chunks", "16",
            "--super-batch-size", str(SUPER_BATCH), "--seed", "1",
            "--scheduler", "constant", "--num-processes", str(WORLD),
            "--process-id", str(rank), "--coordinator-address",
            f"127.0.0.1:{port}", *(["--sync-bn"] if sync_bn else [])]


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    """Two synthetic members (one written by each package), their config
    and a seeded size-16 ConvLSTM checkpoint to fine-tune from."""
    from remora_tpu.models import model_io as jax_io
    from remora_tpu_torch.models import conv_lstm_model
    from tests.test_torch_data import write_config, write_synth_dataset
    from tests.test_torch_models import _numpy_trees

    root = tmp_path_factory.mktemp("dp_train")
    a = write_synth_dataset("jax", root / "a", 120, seed=2)
    b = write_synth_dataset("port", root / "b", 100, seed=3)
    config = write_config(root / "cfg.jsn", [(a, 1), (b, 1)])
    params, bn_state = _numpy_trees(conv_lstm_model, SIZE, 9, 2, seed=8)
    init = root / "init.npz"
    meta = {"model_name": "ConvLSTM_w_ref", "chunk_context": list(CTX),
            "kmer_context_bases": [4, 4], "motifs": [["CG", 0]],
            "mod_bases": ["m"], "mod_long_names": ["5mC"],
            "model_params": {"size": SIZE, "kmer_len": 9, "num_out": 2}}
    jax_io.save_model(init, params, bn_state, meta)
    return root, config, str(init)


@pytest.fixture(scope="module")
def train_runs(train_set):
    """Three 2-rank runs at once: ``train_model`` with a mesh, and the
    command line with and without ``--sync-bn``."""
    root, config, init = train_set
    ports = [P.free_port() for _ in range(3)]
    runs = {"train": lambda r: [
        sys.executable, "-m", "tests.test_torch_multiprocess", "train",
        str(r), str(WORLD), str(ports[0]), config, init,
        str(root / f"train{r}")]}
    for i, sync in ((1, False), (2, True)):
        runs[f"cli_sync{int(sync)}"] = (
            lambda r, i=i, sync=sync: cli_train_argv(
                config, str(root / f"cli{int(sync)}_{r}"), r, ports[i],
                sync))
    argv = [run(r) for run in runs.values() for r in range(WORLD)]
    outs = P.spawn_ranks(lambda k: argv[k], len(argv), RANK_TIMEOUT_S,
                         env=rank_env(), cwd=REPO)
    return root, outs


def _read(path):
    with open(path) as fh:
        return fh.read()


def assert_same_rank_outputs(dirs):
    """The ranks' logs are the same bytes and their checkpoints hold the
    same arrays and metadata."""
    from remora_tpu_torch.models import model_io

    for name in ("batch.log", "validation.log", "epoch_summary.txt"):
        assert _read(dirs[0] / name) == _read(dirs[1] / name), name
    for name in ("model_final.checkpoint", "model_best.checkpoint"):
        got = [dict(np.load(d / name, allow_pickle=True)) for d in dirs]
        assert got[0].keys() == got[1].keys()
        for key in got[0]:
            assert np.array_equal(got[0][key], got[1][key]), (name, key)
        model_io.load_model(dirs[0] / name)


def batch_losses(path):
    with open(path) as fh:
        return np.array([float(line.split("\t")[1])
                         for line in fh.readlines()[1:]])


def jax_stripe_losses(config, init, n_steps):
    """The JAX package's 2-device ``make_dp_train_step`` fed, each step,
    the concatenation of the two ranks' stripes as ``train_model`` draws
    them (the train split of the config, ``shard_for_process``, batch_size
    / 2 per stripe, raw arrays): the per-step losses."""
    import jax

    from remora_tpu.data.dataset import (
        ComposedDataset, CoreDataset, load_dataset, shard_for_process)
    from remora_tpu.models import conv_lstm_model
    from remora_tpu.models import model_io as jax_io
    from remora_tpu.parallel import mesh as M
    from remora_tpu.train.optim import TrainOpts

    override = {"extra_arrays": {}, "kmer_context_bases": (4, 4),
                "chunk_context": CTX}
    paths, props, hashes = load_dataset(config)
    stripes = []
    for r in range(WORLD):
        ds = ComposedDataset(
            [CoreDataset(p, override_metadata=override.copy())
             for p in paths], props, hashes, batch_size=BATCH,
            super_batch_size=SUPER_BATCH)
        trn, _val = ds.train_test_split(TEST_CHUNKS,
                                        override_metadata=override)
        shard_for_process(trn, r, WORLD)
        trn.set_batch_size(BATCH // WORLD)
        stripes.append(trn.iter_batches(raw=True))
    _, params, bn, _ = jax_io.load_model(init)
    tx = TrainOpts(**SGD).load_optimizer()
    mesh = M.make_mesh(jax.devices()[:WORLD])
    step = M.make_dp_train_step(conv_lstm_model, tx, mesh,
                                featurize_args=((4, 4), sum(CTX)))
    p, b, o = (M.replicate(mesh, t) for t in (params, bn, tx.init(params)))
    dsh = M.data_sharding(mesh)
    names = ("signal", "sequence", "sequence_to_signal_mapping",
             "sequence_lengths", "labels")
    losses = []
    for _ in range(n_steps):
        halves = [next(it) for it in stripes]
        data = [jax.device_put(np.concatenate([h[n] for h in halves]), dsh)
                for n in names]
        p, b, o, loss, _nf, _gm = step(p, b, o, *data)
        losses.append(float(loss))
    return np.array(losses)


def test_train_model_two_ranks(train_set, train_runs):
    """``train_model`` over 2 gloo ranks: identical logs and checkpoints
    on both ranks, losses within 1e-4 of the JAX package's 2-device step
    on the same stripes, 3 steps an epoch over 2 epochs."""
    root, config, init = train_set
    dirs = [root / f"train{r}" for r in range(WORLD)]
    assert_same_rank_outputs(dirs)
    got = batch_losses(dirs[0] / "batch.log")
    assert got.size == 6
    want = jax_stripe_losses(config, init, got.size)
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("sync_bn", [False, True])
def test_cli_train_num_processes(train_runs, sync_bn):
    """``model train --num-processes 2 --device cpu`` (with and without
    ``--sync-bn``): each rank writes its own output directory, the same
    bytes in both, and each rank's log names its stripe."""
    root, outs = train_runs
    dirs = [root / f"cli{int(sync_bn)}_{r}" for r in range(WORLD)]
    assert_same_rank_outputs(dirs)
    assert batch_losses(dirs[0] / "batch.log").size == 2
    for r in range(WORLD):
        log = _read(dirs[r] / "log.txt")
        assert f"Process {r}/{WORLD} streams {BATCH // WORLD} chunks" in log


def test_cli_data_parallel_alone(train_set, tmp_path):
    """``--data-parallel`` alone on the CPU is a gloo group of one, in
    this process: its losses are the plain run's (one all-reduce of one
    rank's sums against the mean loss); with more than one visible GPU it
    raises and points to --num-processes."""
    from remora_tpu_torch.cli import main as port_main
    from remora_tpu_torch.cli.util import start_distributed
    from tests.test_torch_infer_pipeline import time_limit

    _, config, _ = train_set
    argv = ["model", "train", config, "--device", "cpu", "--size", "8",
            "--batch-size", "16", "--epochs", "1", "--chunks-per-epoch",
            "32", "--num-test-chunks", "16", "--seed", "1", "--scheduler",
            "constant"]
    for dp in (False, True):
        with time_limit():
            port_main.run(argv + ["--output-path", str(tmp_path / f"dp{dp}")]
                          + (["--data-parallel"] if dp else []))
    assert not torch.distributed.is_initialized()
    got, want = (batch_losses(tmp_path / f"dp{dp}" / "batch.log")
                 for dp in (True, False))
    assert got.size == 2 and np.abs(got - want).max() <= 2e-6
    assert "Data-parallel training over 1 devices" in _read(
        tmp_path / "dpTrue" / "log.txt")

    class Args:
        num_processes = coordinator_address = process_id = None

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "device_count", lambda: 2)
        with pytest.raises(RemoraError, match="--num-processes"):
            start_distributed(Args, torch.device("cuda", 0),
                              data_parallel=True)
    assert start_distributed(Args, torch.device("cpu")) is None


# ---------------- inference ----------------


@pytest.fixture(scope="module")
def infer_set(tmp_path_factory):
    """``write_synth_set``'s reads, the size-16 checkpoint of
    ``tests/test_torch_infer_pipeline.py`` and the port's one-process
    run (no index cache)."""
    from benchmarks.synth_set import write_synth_set
    from remora_tpu_torch.infer import infer
    from tests.test_torch_infer_pipeline import time_limit, write_model

    root = tmp_path_factory.mktemp("dp_infer")
    pod5, bam = write_synth_set(str(root), n_reads=10, n_bases=1200)
    model = write_model(root, "size16.npz")
    single = root / "single.bam"
    with pytest.MonkeyPatch.context() as mp, time_limit():
        mp.setenv("REMORA_TPU_BAM_INDEX_CACHE", "0")
        n = infer.infer_from_pod5_and_bam(
            pod5, bam, [infer.ModelHandle.load(model, device="cpu")],
            str(single), batch_size=INFER_BATCH)
    assert n == 10
    return root, pod5, bam, model, single


def bam_records(path):
    """[(read id, MM, ML bytes)] of a BAM, in file order."""
    from remora_tpu_torch.io.bam import FastBamScanner

    out = []
    for rec in FastBamScanner(str(path)):
        td = rec.tag_dict()
        out.append((rec.query_name, td["MM"],
                    bytes(np.asarray(td["ML"], np.uint8))))
    return out


def test_infer_two_processes(infer_set):
    """The command line's 2-process inference and the JAX package's
    (``tests/_dist_infer_worker.py``) at once: the port's merged BAM holds
    the JAX package's merge record for record in order, and the port's
    one-process run's records; the parts are gone and every JAX rank
    reports the global count, as the port's rank 0 logs it.

    The port's ranks see two local devices (``infer_cli_rank``): a rank of
    the group keeps to its own device and never splits its batches over
    them."""
    root, pod5, bam, model, single = infer_set
    port_merged, jax_merged = root / "port_merged.bam", root / "jax.bam"
    ports = (P.free_port(), P.free_port())
    worker = os.path.join(REPO, "tests", "_dist_infer_worker.py")

    def argv(k):
        r = k % WORLD
        if k < WORLD:
            return [sys.executable, "-m", "tests.test_torch_multiprocess",
                    "infer", "from_pod5_and_bam", pod5, bam, "--model", model,
                    "--out-bam", str(port_merged), "--device", "cpu",
                    "--batch-size", str(INFER_BATCH), "--num-processes",
                    str(WORLD), "--process-id", str(r),
                    "--coordinator-address", f"127.0.0.1:{ports[0]}"]
        return [sys.executable, worker, str(r), str(ports[1]), model, pod5,
                bam, str(jax_merged)]

    outs = P.spawn_ranks(argv, 2 * WORLD, RANK_TIMEOUT_S, cwd=REPO,
                         env=rank_env(
                             JAX_PLATFORMS="cpu", JAX_NUM_CPU_DEVICES="4",
                             XLA_FLAGS="--xla_force_host_platform_"
                                       "device_count=4"))
    got = bam_records(port_merged)
    assert got == bam_records(jax_merged)
    assert sorted(got) == sorted(bam_records(single))
    assert len(got) == 10
    assert sorted(p.name for p in root.iterdir()
                  if ".part" in p.name) == []
    assert f"Merged {len(got)} records from {WORLD} rank parts" in outs[0]
    for r in range(WORLD):
        assert f"INFER_RESULT pid={r} n={len(got)}" in outs[WORLD + r]


@pytest.mark.parametrize("batch_size", [INFER_BATCH, 101])
def test_device_split_tags_identical(infer_set, batch_size, monkeypatch):
    """The device stage split over two CPU replicas of the handle
    (``ModelHandle.shard_over``), at a batch that divides over them and
    one that does not (its device batch padded to 102): the one-device
    run's tags."""
    from remora_tpu_torch.infer import infer
    from tests.test_torch_infer_pipeline import time_limit

    root, pod5, bam, model, single = infer_set
    cpu = torch.device("cpu")
    monkeypatch.setattr(infer, "local_devices", lambda device: [cpu, cpu])
    monkeypatch.setenv("REMORA_TPU_BAM_INDEX_CACHE", "0")
    handle = infer.ModelHandle.load(model, device="cpu")
    out = root / f"split{batch_size}.bam"
    with time_limit():
        n = infer.infer_from_pod5_and_bam(pod5, bam, [handle], str(out),
                                          batch_size=batch_size)
    assert n == 10 and len(handle.replicas) == 2
    assert sorted(bam_records(out)) == sorted(bam_records(single))


def test_infer_device_split_resolution(monkeypatch):
    """REMORA_TPU_INFER_DP as the JAX package resolves it, the GPU count
    monkeypatched to 8: 0 keeps one device, 4 takes four, more than are
    attached raises; unset takes all eight, padding a batch that does not
    divide; a CPU handle stays on its one device; a rank of a group of
    two stays on its own device, and asking it to split raises."""
    from remora_tpu_torch.infer import infer

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    gpu = torch.device("cuda", 0)
    monkeypatch.setenv("REMORA_TPU_INFER_DP", "0")
    assert infer._infer_device_split(128, gpu) == (None, 128)
    monkeypatch.setenv("REMORA_TPU_INFER_DP", "4")
    devs, dev_batch = infer._infer_device_split(128, gpu)
    assert devs == [torch.device("cuda", i) for i in range(4)]
    assert dev_batch == 128
    monkeypatch.setenv("REMORA_TPU_INFER_DP", "99")
    with pytest.raises(RemoraError, match="local devices"):
        infer._infer_device_split(128, gpu)
    monkeypatch.delenv("REMORA_TPU_INFER_DP")
    devs, dev_batch = infer._infer_device_split(50, gpu)
    assert len(devs) == 8 and dev_batch == 56
    assert infer._infer_device_split(1001, gpu)[1] == 1008
    assert infer._infer_device_split(50, torch.device("cpu")) == (None, 50)
    # a rank of a 2-process group keeps its own device
    assert infer._infer_device_split(50, gpu, world=2) == (None, 50)
    monkeypatch.setenv("REMORA_TPU_INFER_DP", "1")
    assert infer._infer_device_split(50, gpu, world=2) == (None, 50)
    monkeypatch.setenv("REMORA_TPU_INFER_DP", "2")
    with pytest.raises(RemoraError, match="rank of 2"):
        infer._infer_device_split(50, gpu, world=2)


def test_dryrun_multichip(monkeypatch):
    """``dryrun_multichip(2)``: the raw-path loss falls over 3 steps on a
    repeated batch, one all-reduce a step, a sync_bn step's 19, and the
    sharded eval's logits the same on both ranks."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    summary = P.dryrun_multichip(2, timeout_s=RANK_TIMEOUT_S)
    assert summary["sync_bn_all_reduces"] == 19
    assert summary["losses"][-1] < summary["losses"][0]


def infer_cli_rank(argv):
    """A rank of the command line's multi-process inference that sees two
    local devices, where splitting a batch over them fails the rank."""
    from remora_tpu_torch.cli import main as port_main
    from remora_tpu_torch.infer import infer

    def refuse(handle, devices):
        raise AssertionError(f"a rank split its batches over {devices}")

    cpu = torch.device("cpu")
    infer.local_devices = lambda device: [cpu, cpu]
    infer.ModelHandle.shard_over = refuse
    port_main.run(argv)


if __name__ == "__main__":
    if sys.argv[1] == "train":
        train_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                   *sys.argv[5:8])
    elif sys.argv[1] == "infer":
        infer_cli_rank(sys.argv[1:])
