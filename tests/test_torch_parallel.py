"""The port's data-parallel step, synced BatchNorm and sharded eval
(``remora_tpu_torch.parallel.mesh``) against the JAX package on the CPU.

Two gloo ranks run every case of ``CASES`` in one spawn (this module run
as ``python -m tests.test_torch_parallel RANK WORLD PORT DIR``: no JAX in
the ranks), each rank on its half of a seeded global batch of 16; the
JAX package's ``make_dp_train_step`` runs the same halves on a 2-device
mesh of the 8 virtual CPU devices. After 3 SGD steps (Adam would divide a
conv bias's rounding-noise gradient by its own root: see
``test_torch_train.py``): loss <= 1e-5 absolute, gradients <= 1e-4
relative (conv biases by an absolute bound), BatchNorm running statistics
<= 1e-5, the filtered count identical, and the two ranks' gradients,
parameters and statistics identical to the bit. Each rank counts
``torch.distributed.all_reduce`` (one a step without ``sync_bn``) and
``all_gather`` calls.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from remora_tpu_torch.models import conv_lstm_model, conv_model
from remora_tpu_torch.models import model_io
from remora_tpu_torch.parallel import mesh as P
from remora_tpu_torch.train import train

WORLD, BATCH, WIDTH, KMER_LEN, NUM_OUT, STEPS, LR = 2, 16, 100, 9, 3, 3, 0.05
SIZES = {"Conv": 8, "ConvLSTM": 16}
PORT_ARCHS = {"Conv": conv_model, "ConvLSTM": conv_lstm_model}
BIAS_NOISE = 1e-5  # a conv bias's gradient: train-mode BN centres it
RANK_TIMEOUT_S = 150
REPO = str(Path(__file__).resolve().parent.parent)
CASES = {
    "default": dict(arch="Conv"),
    "filter": dict(arch="Conv", thr=(0.3, 0.2)),
    "clip": dict(arch="Conv", clip=True),
    "raw": dict(arch="ConvLSTM", raw=True),
    "sync_bn": dict(arch="Conv", sync=True),
    "sync_bn_filter": dict(arch="Conv", sync=True, thr=(0.3, 0.2)),
    "sync_bn_raw_clip": dict(arch="ConvLSTM", sync=True, raw=True,
                             clip=True),
    # the port's other REMORA_TPU_CONVBN modes under sync_bn, held to the
    # port's single-process step in the same mode
    "sync_bn_fused": dict(arch="Conv", sync=True, convbn="fused"),
    "sync_bn_remat": dict(arch="Conv", sync=True, convbn="remat"),
    "sync_bn_pallas": dict(arch="ConvLSTM", sync=True, convbn="pallas"),
}
JAX_CASES = [name for name, c in CASES.items() if "convbn" not in c]
SYNC_CASES = [name for name, c in CASES.items() if c.get("sync")]


def case_data(name):
    """The global batch of a case, seeded: (signal, enc_kmers, labels) or
    the raw (signal, sequence, mapping, lengths, labels)."""
    rng = np.random.default_rng(list(CASES).index(name))
    sigs = rng.normal(size=(BATCH, 1, WIDTH)).astype(np.float32)
    labels = rng.integers(0, NUM_OUT, BATCH).astype(np.int64)
    if not CASES[name].get("raw"):
        kmers = (rng.random((BATCH, 4 * KMER_LEN, WIDTH)) < 0.25).astype(
            np.float32)
        return [sigs, kmers, labels]
    S = 20
    seq_lens = rng.integers(S // 2, S + 1, BATCH).astype(np.int16)
    seqs = rng.integers(0, 4, (BATCH, S + KMER_LEN - 1)).astype(np.int8)
    maps = np.zeros((BATCH, S + 1), np.int16)
    for b in range(BATCH):
        sl = seq_lens[b]
        maps[b, 1:sl] = np.sort(rng.integers(0, WIDTH + 1, sl - 1))
        maps[b, sl] = WIDTH
    return [sigs, seqs, maps, seq_lens, labels]


def featurize_args(name):
    return ((4, 4), WIDTH) if CASES[name].get("raw") else None


def eval_data():
    rng = np.random.default_rng(11)
    n = 37  # ragged over 2 ranks
    return (rng.normal(size=(n, 1, WIDTH)).astype(np.float32),
            (rng.random((n, 4 * KMER_LEN, WIDTH)) < 0.25).astype(np.float32))


def port_model(root, arch):
    model = PORT_ARCHS[arch].init(size=SIZES[arch], kmer_len=KMER_LEN,
                                  num_out=NUM_OUT)
    trees = [model_io.unflatten_tree(dict(np.load(
        os.path.join(root, f"{arch}_{part}.npz")))) for part in ("p", "bn")]
    model.load_state_dict(model_io.params_from_numpy(*trees))
    return model


def run_port_steps(step, model, data):
    """STEPS steps of ``step`` (a clip case's thresholds: half the last
    step's maxima); (losses, n_filts, grad-clip maxima)."""
    losses, n_filts, threshs = [], [], None
    for _ in range(STEPS):
        loss, n_filt, maxs = step(*data, grad_threshs=threshs)
        losses.append(float(loss))
        n_filts.append(int(n_filt))
        if maxs is not None:
            threshs = [float(m) * 0.5 for m in maxs]
    return losses, n_filts


def port_state(model):
    """{grads/..., params/..., bn/...}: the last step's gradients (after
    clipping), the parameters and the BatchNorm running statistics."""
    out = {}
    for name, p in train.sorted_params(model):
        out[f"grads/{name}"] = p.grad.detach().numpy().copy()
        out[f"params/{name}"] = p.detach().numpy().copy()
    bn = model_io.module_to_trees(model)[1]
    for key, val in model_io.flatten_tree(bn).items():
        out[f"bn/{key}"] = np.asarray(val).copy()
    return out


# ---------------- the ranks ----------------


def rank_main(rank, world, port, root):
    P.init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo",
                     device="cpu", timeout_s=60)
    try:
        mesh = P.make_mesh("cpu")
        for name, case in CASES.items():
            os.environ["REMORA_TPU_CONVBN"] = case.get("convbn", "auto")
            model = port_model(root, case["arch"])
            opt = torch.optim.SGD(
                [p for _, p in train.sorted_params(model)], lr=LR)
            step = P.make_dp_train_step(
                model, opt, mesh,
                high_conf_incorrect_thr_frac=case.get("thr"),
                sync_bn=case.get("sync", False),
                use_grad_clip=case.get("clip", False),
                featurize_args=featurize_args(name),
            )
            per = BATCH // world
            shard = [torch.from_numpy(a[rank * per:(rank + 1) * per])
                     for a in case_data(name)]
            counts = []

            def counted_step(*data, grad_threshs=None):
                with P.count_calls("all_reduce") as reduces, \
                        P.count_calls("all_gather") as gathers:
                    out = step(*data, grad_threshs=grad_threshs)
                counts.append((reduces[0], gathers[0]))
                return out

            losses, n_filts = run_port_steps(counted_step, model, shard)
            np.savez(os.path.join(root, f"{name}.rank{rank}.npz"),
                     losses=losses, n_filts=n_filts, counts=counts,
                     **port_state(model))
        os.environ.pop("REMORA_TPU_CONVBN")
        model = port_model(root, "Conv")
        logits = P.make_dp_eval_fn(model, mesh)(*eval_data())
        np.save(os.path.join(root, f"eval.rank{rank}.npy"), logits)
    finally:
        P.teardown()


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Every case over 2 gloo ranks; the weights both packages start
    from."""
    from tests.test_torch_models import _numpy_trees

    root = tmp_path_factory.mktemp("dp")
    weights = {}
    for arch, size in SIZES.items():
        params, bn = _numpy_trees(PORT_ARCHS[arch], size, KMER_LEN, NUM_OUT,
                                  seed=5)
        weights[arch] = (params, bn)
        for part, tree in (("p", params), ("bn", bn)):
            np.savez(root / f"{arch}_{part}.npz",
                     **model_io.flatten_tree(tree))
    port = P.free_port()
    P.spawn_ranks(
        lambda r: [sys.executable, "-m", "tests.test_torch_parallel",
                   str(r), str(WORLD), str(port), str(root)],
        WORLD, RANK_TIMEOUT_S, env=dict(P.package_env(), OMP_NUM_THREADS="2"),
        cwd=REPO,
    )
    ranks = {name: [dict(np.load(root / f"{name}.rank{r}.npz"))
                    for r in range(WORLD)] for name in CASES}
    return root, weights, ranks


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _is_conv_bias(key):
    return "conv" in key and key.endswith("/b")


def check_state(got, losses, n_filts, grads, bn):
    """``got`` (a rank's npz) against another run: losses <= 1e-5,
    filtered counts identical, gradients <= 1e-4 relative (conv biases
    absolute), BatchNorm statistics <= 1e-5 relative."""
    assert np.abs(got["losses"] - np.asarray(losses)).max() <= 1e-5
    assert list(got["n_filts"]) == list(n_filts)
    for key, want in grads.items():
        g = got[f"grads/{key}"]
        if _is_conv_bias(key):
            assert np.abs(g).max() <= BIAS_NOISE, key
        else:
            assert _rel_err(g, want) <= 1e-4, key
    for key, want in bn.items():
        assert _rel_err(got[f"bn/{key}"], want) <= 1e-5, key


def test_ranks_hold_identical_replicas(dp_runs):
    """After every case the two ranks hold the same bytes: losses,
    filtered counts, gradients, parameters and running statistics."""
    _, _, ranks = dp_runs
    for name, (r0, r1) in ranks.items():
        assert r0.keys() == r1.keys()
        for key in r0:
            if key != "counts":
                assert np.array_equal(r0[key], r1[key]), (name, key)


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_per_step(dp_runs, name):
    """Exactly one all_reduce and no all_gather a step without sync_bn;
    under sync_bn the count ``sync_bn_collectives`` states (3 all-reduces
    per BatchNorm layer and the step's one; K6's blocks gather x and dout;
    the filter gathers once)."""
    root, _, ranks = dp_runs
    case = CASES[name]
    want = (1, 0)
    if case.get("sync"):
        want = P.sync_bn_collectives(port_model(root, case["arch"]),
                                     case.get("convbn", "plain"),
                                     filtered="thr" in case)
    for got in ranks[name]:
        assert [tuple(c) for c in got["counts"]] == [want] * STEPS


def _capture():
    """An optax transformation whose state keeps the last updates it was
    given: chained before SGD it holds the step's reduced gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )


def jax_dp_run(name, params, bn):
    """The JAX package's make_dp_train_step on 2 of the 8 virtual CPU
    devices, the same halves, STEPS SGD steps: (losses, n_filts, grads,
    BatchNorm statistics), the last two flattened."""
    import jax
    import optax

    from remora_tpu.models import conv_lstm_model as jax_convlstm
    from remora_tpu.models import conv_model as jax_conv
    from remora_tpu.models import model_io as jax_io
    from remora_tpu.parallel import mesh as M

    case = CASES[name]
    model = {"Conv": jax_conv, "ConvLSTM": jax_convlstm}[case["arch"]]
    mesh = M.make_mesh(jax.devices()[:WORLD])
    tx = optax.chain(_capture(), optax.sgd(LR))
    step = M.make_dp_train_step(
        model, tx, mesh,
        high_conf_incorrect_thr_frac=case.get("thr"),
        sync_bn=case.get("sync", False),
        use_grad_clip=case.get("clip", False),
        featurize_args=featurize_args(name),
    )
    # fresh copies: the step donates its replicated state
    params, bn = (jax.tree.map(np.array, t) for t in (params, bn))
    p, b, o = (M.replicate(mesh, t) for t in (params, bn, tx.init(params)))
    dsh = M.data_sharding(mesh)
    data = case_data(name)
    data[-1] = data[-1].astype(np.int32)
    data = [jax.device_put(x, dsh) for x in data]
    losses, n_filts, threshs = [], [], None
    for _ in range(STEPS):
        extra = (threshs,) if case.get("clip") else ()
        p, b, o, loss, n_filt, gm = step(p, b, o, *data, *extra)
        losses.append(float(loss))
        n_filts.append(int(n_filt))
        if case.get("clip"):
            threshs = jax.tree.map(lambda m: m * 0.5, gm)
    return (losses, n_filts, jax_io.flatten_tree(jax.device_get(o[0])),
            jax_io.flatten_tree(jax.device_get(b)))


@pytest.mark.parametrize("name", JAX_CASES)
def test_dp_step_matches_jax(dp_runs, name):
    """The port's 2-rank step against the JAX package's 2-device step on
    the same halves: default, the filter, gradient clipping, the raw path
    and sync_bn (alone, with the filter, with the raw path and clipping)."""
    _, weights, ranks = dp_runs
    losses, n_filts, grads, bn = jax_dp_run(name, *weights[CASES[name][
        "arch"]])
    if "thr" in CASES[name]:
        assert sum(n_filts) > 0  # the filter drops some examples
    check_state(ranks[name][0], losses, n_filts, grads, bn)


@pytest.mark.parametrize("name", SYNC_CASES)
def test_sync_bn_matches_one_process(dp_runs, name, monkeypatch):
    """sync_bn over 2 ranks equals one process stepping on the whole
    batch (``train.make_train_step``) in the same REMORA_TPU_CONVBN mode:
    global-batch BatchNorm in every mode, K6's plain version on the
    gathered batch in pallas mode, the filter's global threshold."""
    root, _, ranks = dp_runs
    case = CASES[name]
    monkeypatch.setenv("REMORA_TPU_CONVBN", case.get("convbn", "auto"))
    model = port_model(root, case["arch"])
    opt = torch.optim.SGD([p for _, p in train.sorted_params(model)], lr=LR)
    if case.get("raw"):
        step = train.make_train_step_raw(
            model, opt, *featurize_args(name),
            high_conf_incorrect_thr_frac=case.get("thr"),
            use_grad_clip=case.get("clip", False))
    else:
        step = train.make_train_step(
            model, opt, high_conf_incorrect_thr_frac=case.get("thr"),
            use_grad_clip=case.get("clip", False))
    data = [torch.from_numpy(a) for a in case_data(name)]
    losses, n_filts = run_port_steps(step, model, data)
    want = port_state(model)
    grads = {k[6:]: v for k, v in want.items() if k.startswith("grads/")}
    bn = {k[3:]: v for k, v in want.items() if k.startswith("bn/")}
    check_state(ranks[name][0], losses, n_filts, grads, bn)


def test_dp_eval_fn_ragged_batch(dp_runs):
    """make_dp_eval_fn on 37 rows over 2 ranks: the same logits bytes on
    both ranks, <= 1e-5 of the one-process eval of the whole batch."""
    root, _, _ = dp_runs
    got = [np.load(root / f"eval.rank{r}.npy") for r in range(WORLD)]
    assert got[0].shape == (37, NUM_OUT)
    assert np.array_equal(got[0], got[1])
    sigs, kmers = eval_data()
    want = train.make_eval_step(port_model(root, "Conv"))(
        torch.from_numpy(sigs), torch.from_numpy(kmers)).numpy()
    assert np.abs(got[0] - want).max() <= 1e-5


def test_sync_bn_layer_counts():
    """The stated collectives of a sync_bn step: ConvLSTM_w_ref's six
    BatchNorm layers take 19 all-reduces (3 each and the step's one), 31
    under remat, and in pallas mode its four stride-1 blocks gather x and
    dout instead of all-reducing their backward sums."""
    model = conv_lstm_model.init(size=8, kmer_len=KMER_LEN)
    assert P.sync_bn_collectives(model) == (19, 0)
    assert P.sync_bn_collectives(model, "fused", filtered=True) == (19, 1)
    assert P.sync_bn_collectives(model, "remat") == (31, 0)
    assert P.sync_bn_collectives(model, "pallas") == (15, 8)


def test_dataset_stripes_match_jax(tmp_path):
    """``shard_for_process`` gives each rank the JAX package's disjoint
    super-batch stripe (the same batches), and ``worker_init`` the JAX
    package's seeded super-batch offsets."""
    from remora_tpu.data import dataset as jax_dataset
    from remora_tpu_torch.data import dataset as port_dataset
    from tests.test_torch_data import write_synth_dataset

    path = write_synth_dataset("port", tmp_path / "ds", 96, seed=1)
    batches = {}
    for name, mod in (("jax", jax_dataset), ("port", port_dataset)):
        for r in range(WORLD):
            ds = mod.ComposedDataset([mod.CoreDataset(path)], np.ones(1),
                                     batch_size=8, super_batch_size=16)
            assert mod.shard_for_process(ds, r, WORLD) is ds
            assert [(m.shard_index, m.num_shards) for m in ds.datasets] == [
                (r, WORLD)]
            it = ds.iter_batches()
            batches[name, r] = [next(it)["labels"] for _ in range(4)]
        mod.worker_init(ds, seed=3, worker_id=2)
        batches[name, "offsets"] = ds.super_batch_offsets
    for r in range(WORLD):
        for got, want in zip(batches["port", r], batches["jax", r]):
            assert np.array_equal(got, want)
    assert not all(np.array_equal(a, b) for a, b in
                   zip(batches["port", 0], batches["port", 1]))
    assert batches["port", "offsets"] == batches["jax", "offsets"]


def test_init_multihost_arguments():
    """Refusals that need no process group: a rank outside the world,
    several processes without a coordinator address, NCCL on the CPU, and
    no device named with no GPU present (no silent CPU group)."""
    from remora_tpu_torch import RemoraError

    with pytest.raises(RemoraError, match="not in"):
        P.init_multihost("127.0.0.1:1", 2, 2, device="cpu")
    with pytest.raises(RemoraError, match="coordinator address"):
        P.init_multihost(None, 2, 0, device="cpu")
    with pytest.raises(RemoraError, match="NCCL needs a CUDA device"):
        P.init_multihost(None, 1, 0, backend="nccl", device="cpu")
    with pytest.raises(RemoraError, match="no CUDA device"):
        P.init_multihost(None, 1, 0)
    assert not dist.is_initialized()
    with pytest.raises(RemoraError, match="no process group"):
        P.make_mesh("cpu")


def test_group_of_one_on_the_cpu():
    """A gloo group of one: the step is the one-process step (its one
    all-reduce of a single rank), the eval the one-process eval; with no
    GPU, a mesh on no named device raises."""
    from remora_tpu_torch import RemoraError

    P.init_multihost(device="cpu", timeout_s=30)
    try:
        with pytest.raises(RemoraError, match="no CUDA device"):
            P.make_mesh()
        mesh = P.make_mesh("cpu")
        assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, "gloo")
        data = [torch.from_numpy(a) for a in case_data("filter")]
        runs = []
        for dp in (True, False):
            torch.manual_seed(0)
            model = conv_model.init(size=8, kmer_len=KMER_LEN,
                                    num_out=NUM_OUT)
            opt = torch.optim.SGD(model.parameters(), lr=LR)
            kw = dict(high_conf_incorrect_thr_frac=(0.3, 0.2))
            step = (P.make_dp_train_step(model, opt, mesh, **kw) if dp
                    else train.make_train_step(model, opt, **kw))
            runs.append((run_port_steps(step, model, data),
                         port_state(model)))
        (dp_run, dp_state), (one_run, one_state) = runs
        assert dp_run[1] == one_run[1]
        assert np.abs(np.subtract(dp_run[0], one_run[0])).max() <= 1e-6
        for key, want in one_state.items():
            if _is_conv_bias(key.split("/", 1)[1]) and key.startswith(
                    "grads/"):
                continue
            assert _rel_err(dp_state[key], want) <= 1e-5, key
    finally:
        P.teardown()


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
              sys.argv[4])
