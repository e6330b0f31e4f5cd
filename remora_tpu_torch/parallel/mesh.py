"""Data parallelism over ``torch.distributed`` process groups.

Counterpart of ``remora_tpu/parallel/mesh.py``. The JAX package runs one
program over a 1-D ``data`` mesh of devices; here every rank is its own
process holding one device, its own replica of the parameters, optimizer
and BatchNorm state, and its own slice of each global batch, and the
ranks meet in ``torch.distributed`` collectives: NCCL when the ranks sit
on separate GPUs, gloo on the CPU and for ranks that share a card (gloo
takes CUDA tensors in the collectives used here; ``chip_smoke.py`` phase
6f checks it on the card). So the JAX
package's ``shard_batch``, ``replicate`` and ``host_shard_to_global``
have no counterpart: a rank already holds its own slice and replica.

``make_dp_train_step`` keeps the JAX step's contract of ONE collective a
step: gradients, BatchNorm running statistics, the loss sum and the
kept and filtered counts ride one flat f32 all-reduce (no
``DistributedDataParallel``, which buckets gradients into several
all-reduces and leaves the BatchNorm statistics out). ``sync_bn=True``
normalises with the global batch's statistics instead
(``models.layers.synced_bn``), at 3 more all-reduces per BatchNorm layer
(``sync_bn_collectives`` counts them).

``python -m remora_tpu_torch.parallel.mesh --dryrun N`` runs
``dryrun_multichip(N)``.
"""

import contextlib
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from remora_tpu_torch import RemoraError, log
from remora_tpu_torch.core.util import resolve_device

LOGGER = log.get_logger()

# seconds a collective waits for every rank before it raises (and the
# rendezvous of ``init_multihost``): a rank that died fails the others
DIST_TIMEOUT_S = float(os.environ.get("REMORA_TPU_DIST_TIMEOUT_S", "600"))


@dataclass
class Mesh:
    """A rank's place in a data-parallel process group: the group, this
    rank, the world size, this rank's device and the group's backend."""

    group: object
    rank: int
    world: int
    device: torch.device
    backend: str

    def all_reduce(self, t):
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t):
        """Every rank's ``t`` (one shape on all ranks) concatenated along
        the first axis in rank order; the same bytes on every rank."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def broadcast(self, t, src=0):
        """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
        dist.broadcast(t, src, group=self.group)
        return t

    def gather_counts(self, values):
        """Every rank's ``values`` (a list of numbers) as a (world, len)
        f64 array, on every rank (a CUDA tensor under NCCL)."""
        device = self.device if self.backend == "nccl" else "cpu"
        t = torch.tensor(values, dtype=torch.float64, device=device)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.stack(parts).cpu().numpy()

    def barrier(self):
        """Wait for every rank of the group."""
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def mesh_device(device=None):
    """``device`` when given, else the current GPU (with its index); no
    GPU and no device named raises (``core.util.resolve_device``)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(device=None):
    """This rank's ``Mesh`` over the default process group (which
    ``init_multihost`` starts) on ``device``: default the current GPU,
    and a raise when there is none (name ``device="cpu"``)."""
    if not dist.is_initialized():
        raise RemoraError("no process group: call init_multihost first")
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                mesh_device(device), dist.get_backend())


def free_port():
    """A TCP port on localhost that the OS reports free."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, backend=None, device=None,
                   timeout_s=None):
    """Start the default process group: ``num_processes`` ranks (default
    1) meeting at ``coordinator_address`` (host:port; a free local port
    for a group of one), this process rank ``process_id`` (default 0).

    The backend defaults to NCCL for a CUDA ``device`` (default: the
    current GPU; no GPU and no device named raises) and gloo for the CPU
    (``device="cpu"``); it never changes on its own.
    NCCL refuses ranks that share a device, and so does this function,
    before any NCCL collective runs. Returns the backend."""
    num_processes = 1 if num_processes is None else int(num_processes)
    process_id = 0 if process_id is None else int(process_id)
    if not 0 <= process_id < num_processes:
        raise RemoraError(f"process id {process_id} is not in "
                          f"[0, {num_processes})")
    if coordinator_address is None:
        if num_processes > 1:
            raise RemoraError(f"{num_processes} processes need a "
                              "coordinator address (host:port)")
        coordinator_address = f"127.0.0.1:{free_port()}"
    device = mesh_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        if device.type != "cuda":
            raise RemoraError(f"NCCL needs a CUDA device, not {device}")
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(
        seconds=DIST_TIMEOUT_S if timeout_s is None else timeout_s)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=timeout,
    )
    if backend == "nccl" and num_processes > 1:
        _refuse_shared_devices(device)
    LOGGER.info(
        f"torch.distributed initialized ({backend}): process "
        f"{process_id} of {num_processes} on {device}"
    )
    return backend


def _refuse_shared_devices(device):
    """Raise (group torn down) when two NCCL ranks hold one card: the
    ranks compare (host, card UUID) over a gloo side group."""
    here = (socket.gethostname(),
            str(torch.cuda.get_device_properties(device.index).uuid))
    side = dist.new_group(backend="gloo")
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, here, group=side)
    dist.destroy_process_group(side)
    if len(set(seen)) < len(seen):
        dist.destroy_process_group()
        raise RemoraError(
            "NCCL ranks share a device; run one rank per GPU, or gloo "
            "for ranks that share a card"
        )


def teardown():
    """Destroy the default process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------- the data-parallel train step ----------------


def sync_bn_collectives(model, convbn="plain", filtered=False):
    """(all-reduces, all-gathers) of one ``sync_bn`` step of ``model``:
    3 all-reduces per BatchNorm layer (2 forward, 1 backward; 5 under
    remat, whose recompute repeats the forward's) and the step's one;
    under ``pallas`` a stride-1 block's backward all-gathers x and dout
    in place of its all-reduce; the filter gathers every rank's
    confidences once."""
    from remora_tpu_torch.models import layers as L

    convs = [m for m in model.modules() if isinstance(m, L.Conv1d)]
    per_layer = 5 if convbn == "remat" else 3
    reduces, gathers = per_layer * len(convs) + 1, int(filtered)
    if convbn == "pallas":
        k6 = sum(m.stride == 1 for m in convs)
        reduces -= k6
        gathers += 2 * k6
    return reduces, gathers


def make_dp_train_step(model, optimizer, mesh,
                       high_conf_incorrect_thr_frac=None,
                       compute_dtype=None, sync_bn=False,
                       use_grad_clip=False, featurize_args=None):
    """Data-parallel train step: ``step(*this rank's arrays,
    grad_threshs=None) -> (loss, n_filtered, grad_maxs)``, the signature
    of ``train.make_train_step``'s step, every result the global one.

    Each rank runs forward and backward on its shard with the loss SUM
    (``make_loss_fn(reduction="sum")``), then packs [flat gradients, flat
    BatchNorm running statistics, loss sum, kept count, filtered count]
    into one f32 vector and makes ONE ``all_reduce(SUM)``, divided by the
    world size. The gradients are divided by the global kept mean, so
    they are those of the global masked-mean loss; the running
    statistics are averaged (per-rank batch statistics, the standard
    unsynced data-parallel BatchNorm); the filtered count is rounded back
    from its mean. The high-confidence-incorrect filter takes its dynamic
    threshold per shard. Gradient-clip maxima come from the reduced
    gradients, with no second collective. Every rank then holds the same
    bytes and takes the same optimizer step, so the replicas stay equal.

    ``sync_bn=True``: global-batch BatchNorm (``layers.synced_bn``) and
    the filter's threshold over the global batch, as one device holding
    the whole batch; every rank's running statistics are then the global
    ones and stay out of the vector (``sync_bn_collectives`` counts the
    collectives). ``featurize_args=(kmer_context_bases, chunk_width)``
    takes the RAW arrays (signal, sequence, mapping, lengths, labels) and
    featurizes this rank's shard on its device."""
    from remora_tpu_torch.kernels.encoded_kmers import (
        compute_encoded_kmer_batch as dev_enc,
    )
    from remora_tpu_torch.models import layers as L
    from remora_tpu_torch.train.train import make_loss_fn, sorted_params

    raw = featurize_args is not None
    loss_fn = make_loss_fn(
        model,
        high_conf_incorrect_thr_frac=high_conf_incorrect_thr_frac,
        compute_dtype=compute_dtype,
        reduction="sum",
        channels_last=raw,  # the raw path featurizes channels-last
        mesh=mesh if sync_bn else None,
    )
    params = [p for _, p in sorted_params(model)]
    buffers = [] if sync_bn else [b for _, b in sorted(model.named_buffers())]
    n_grads = sum(p.numel() for p in params)
    n_bufs = sum(b.numel() for b in buffers)

    def step(*data, grad_threshs=None):
        if raw:
            (bb, ab), chunk_width = featurize_args
            signal, sequence, seq_maps, seq_lens, labels = data
            kmers = dev_enc(bb, ab, sequence, seq_maps, seq_lens,
                            chunk_width, out_dtype=compute_dtype,
                            channels_last=True)
            sigs = signal.transpose(1, 2)
        else:
            sigs, kmers, labels = data
        model.zero_grad(set_to_none=True)
        with L.synced_bn(mesh if sync_bn else None):
            loss_sum, n_filt, n_kept = loss_fn(sigs, kmers, labels)
            loss_sum.backward()
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.grad gives
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        packed = torch.cat(
            [g.reshape(-1).float() for g in grads]
            + [b.reshape(-1).float() for b in buffers]
            + [loss_sum.detach().reshape(1).float(),
               n_kept.reshape(1).float(), n_filt.reshape(1).float()]
        )
        mesh.all_reduce(packed)  # the ONE collective of the step
        packed /= mesh.world
        kept_mean = packed[n_grads + n_bufs + 1]  # global kept / world
        flat_g = packed[:n_grads] / kept_mean
        offset = 0
        for p in params:
            p.grad = flat_g[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        with torch.no_grad():
            for b in buffers:
                b.copy_(packed[offset:offset + b.numel()].view_as(b))
                offset += b.numel()
        loss = packed[n_grads + n_bufs] / kept_mean
        n_filt = torch.round(packed[n_grads + n_bufs + 2]
                             * mesh.world).to(torch.int32)
        grad_maxs = None
        if use_grad_clip:
            grad_maxs = torch.stack([p.grad.abs().max() for p in params])
            if grad_threshs is not None:
                for p, t in zip(params, grad_threshs):
                    p.grad.clamp_(-t, t)
        optimizer.step()
        return loss, n_filt, grad_maxs

    return step


# ---------------- sharded evaluation ----------------


def make_dp_eval_step(model, mesh):
    """Eval-mode logits of this rank's rows, gathered: ``eval_step(sigs,
    enc_kmers)`` on this rank's slice (one row count on every rank)
    returns every rank's logits in rank order, the same bytes on every
    rank."""
    from remora_tpu_torch.train.train import make_eval_step

    local = make_eval_step(model)

    def eval_step(sigs, enc_kmers):
        return mesh.all_gather(local(sigs, enc_kmers))

    return eval_step


def make_dp_eval_fn(model, mesh):
    """Validation ``eval_fn(sigs, enc_kmers) -> numpy logits`` over ragged
    host batches: the rows are padded up to a multiple of the world size,
    each rank computes its 1/world slice and the gathered logits are
    sliced back to the batch. Every rank holds the same logits bytes, so
    every rank writes the same ``validation.log``."""
    from remora_tpu_torch.core.util import pad_rows
    from remora_tpu_torch.infer.infer import _put

    step = make_dp_eval_step(model, mesh)

    def eval_fn(sigs, enc_kmers):
        sigs, enc_kmers = np.asarray(sigs), np.asarray(enc_kmers)
        n = sigs.shape[0]
        n_full = -(-n // mesh.world) * mesh.world
        per = n_full // mesh.world
        lo = mesh.rank * per
        sigs, enc_kmers = (pad_rows(a, n_full)[lo:lo + per]
                           for a in (sigs, enc_kmers))
        logits = step(_put(sigs, mesh.device), _put(enc_kmers, mesh.device))
        return logits.cpu().numpy()[:n]

    return eval_fn


# ---------------- ranks as processes ----------------


def spawn_ranks(argv_of, world, timeout_s, env=None, cwd=None):
    """Run ``world`` processes, rank r running ``argv_of(r)``, each with
    its output in a file. A rank that exits non-zero, or a run past
    ``timeout_s``, kills every rank still running and raises
    ``RemoraError`` with the ranks' output tails. Returns each rank's
    output."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(argv_of(r), stdout=logs[r],
                                  stderr=subprocess.STDOUT, env=env,
                                  cwd=cwd)
                 for r in range(world)]
        deadline = time.monotonic() + timeout_s
        failure = None
        try:
            while failure is None and any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.returncode not in (None, 0)]
                if bad:
                    failure = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                elif time.monotonic() > deadline:
                    failure = f"ranks ran past {timeout_s} s"
                else:
                    time.sleep(0.05)
            if failure is None:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failure = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for fh in logs:
            fh.seek(0)
            outs.append(fh.read())
            fh.close()
    if failure is not None:
        tails = "\n".join(f"--- rank {r} ---\n{out[-3000:]}"
                          for r, out in enumerate(outs))
        raise RemoraError(f"{failure}\n{tails}")
    return outs


def package_env():
    """The environment with this package's checkout first on PYTHONPATH
    (for ranks started as ``python -m``)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ,
                PYTHONPATH=root if not path else f"{root}{os.pathsep}{path}")


@contextlib.contextmanager
def count_calls(name="all_reduce"):
    """``torch.distributed.<name>`` counted while the block runs; yields
    the one-element list that holds the count."""
    inner, count = getattr(dist, name), [0]

    def counted(*args, **kwargs):
        count[0] += 1
        return inner(*args, **kwargs)

    setattr(dist, name, counted)
    try:
        yield count
    finally:
        setattr(dist, name, inner)


def dryrun_multichip(n_devices, timeout_s=300):
    """Run the data-parallel path over ``n_devices`` gloo ranks on the CPU
    (the JAX package's ``__graft_entry__.dryrun_multichip``): 3 raw-path
    steps on a repeated batch (the loss must fall), one all-reduce a step
    (counted), one ``sync_bn`` step (its collectives counted) and one
    sharded eval of a ragged batch (the same logits bytes on every rank).
    Raises on any failure; returns rank 0's summary."""
    import json

    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(
            lambda r: [sys.executable, "-m", "remora_tpu_torch.parallel.mesh",
                       "--dryrun-rank",
                       str(r), str(n_devices), str(port), tmp],
            n_devices, timeout_s, env=package_env(),
        )
        summaries = []
        for r in range(n_devices):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                summaries.append(json.load(fh))
    if any(s["logits"] != summaries[0]["logits"] for s in summaries):
        raise RemoraError("sharded eval: the ranks' logits differ")
    if any(s["losses"] != summaries[0]["losses"] for s in summaries):
        raise RemoraError("the ranks' losses differ")
    return summaries[0]


def _dryrun_rank(rank, world, port, out_dir):
    import hashlib
    import json

    from remora_tpu_torch.models import conv_lstm_model as M
    from remora_tpu_torch.train.optim import TrainOpts

    init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo",
                   device="cpu", timeout_s=60)
    try:
        mesh = make_mesh("cpu")
        batch, width, kmer_len, num_out = 4 * world, 96, 9, 2
        rng = np.random.default_rng(0)
        max_seq = width // 5
        seq_lens = rng.integers(max_seq // 2, max_seq + 1, batch)
        maps = np.zeros((batch, max_seq + 1), np.int16)
        for b in range(batch):
            sl = seq_lens[b]
            maps[b, 1:sl] = np.sort(rng.integers(0, width + 1, sl - 1))
            maps[b, sl] = width
        arrays = (
            rng.normal(size=(batch, 1, width)).astype(np.float32),
            rng.integers(0, 4, (batch, max_seq + kmer_len - 1)).astype(
                np.int8),
            maps, seq_lens.astype(np.int16),
            rng.integers(0, num_out, batch).astype(np.int64),
        )
        per = batch // world
        shard = [torch.from_numpy(a[rank * per:(rank + 1) * per])
                 for a in arrays]
        featurize_args = ((kmer_len // 2, kmer_len // 2), width)
        summary = {}
        for sync in (False, True):
            model = M.init(torch.Generator().manual_seed(0), size=16,
                           kmer_len=kmer_len, num_out=num_out)
            opt = TrainOpts(epochs=2).load_optimizer(
                [p for _, p in sorted(model.named_parameters())])
            step = make_dp_train_step(model, opt, mesh, sync_bn=sync,
                                      featurize_args=featurize_args)
            losses, counts = [], []
            for _ in range(1 if sync else 3):
                with count_calls() as count:
                    loss, _n_filt, _gm = step(*shard)
                losses.append(float(loss))
                counts.append(count[0])
            if sync:
                want = sync_bn_collectives(model)[0]
                if counts != [want]:
                    raise RemoraError(f"sync_bn step: {counts} all-reduces, "
                                      f"{want} expected")
                summary["sync_bn_all_reduces"] = counts[0]
                continue
            if counts != [1, 1, 1]:
                raise RemoraError(f"{counts} all-reduces in 3 steps, "
                                  "1 a step expected")
            if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
                raise RemoraError(f"loss did not fall: {losses}")
            summary["losses"] = losses
        eval_fn = make_dp_eval_fn(model, mesh)
        n = 4 * world + 1
        logits = eval_fn(
            rng.normal(size=(n, 1, width)).astype(np.float32),
            (rng.random((n, 4 * kmer_len, width)) < 0.25).astype(np.float32))
        if logits.shape != (n, num_out):
            raise RemoraError(f"sharded eval: logits {logits.shape}")
        summary["logits"] = hashlib.sha256(logits.tobytes()).hexdigest()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(summary, fh)
    finally:
        teardown()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-rank"]:
        _dryrun_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                     sys.argv[5])
    elif sys.argv[1:2] == ["--dryrun"] and len(sys.argv) == 3:
        print(dryrun_multichip(int(sys.argv[2])))
    else:
        sys.exit("usage: python -m remora_tpu_torch.parallel.mesh "
                 "--dryrun N")
