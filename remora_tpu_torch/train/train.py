"""Training: train/eval steps + epoch loop.

Counterpart of ``remora_tpu/train/train.py`` (reference
``src/remora/train_model.py:164–643``). A train step is forward (train
mode: batch-statistics BatchNorm, the K2 LSTM forward on CUDA), CE loss
with the optional high-confidence-incorrect filter, backward (K3 for the
LSTM), optional RollingMAD value clipping and the optimizer update. Host
code streams batches and handles the epoch schedule, validation,
checkpoints and early stopping, as the JAX package's loop does, and
writes the same ``batch.log``, ``validation.log``, ``epoch_summary.txt``
and checkpoints.

``train_model`` runs on the GPU unless the caller names ``device="cpu"``;
with no GPU and no device named it raises. ``steps_per_launch > 1`` runs K
optimizer steps per call over K batches put on the device at once (the JAX
package's ``lax.scan`` window); ``REMORA_TPU_JAX_TRACE_DIR`` writes a
torch.profiler trace of the first epoch there. ``mesh`` (a
``parallel.mesh.Mesh``: this process's rank of a data-parallel group, on
the mesh's device) trains data-parallel: each rank streams its own
super-batch stripe of batch_size / world chunks a step, the step makes one
all-reduce (``parallel.mesh.make_dp_train_step``; ``sync_bn`` for
global-batch BatchNorm), validation splits every batch over the ranks, and
every rank writes the same logs and checkpoints into its own ``out_path``.

Precision: the f32 path runs convs and matmuls in full f32 (TF32 off).
``bf16_compute`` runs the forward and backward on bf16 casts of the f32
parameters and BatchNorm statistics (the new statistics are computed in
bf16 and stored as f32), with f32 gradients into the f32 optimizer state.
"""

import json
import os
import time
from collections import deque

import numpy as np
import torch

from remora_tpu_torch import RemoraError, constants, log
from remora_tpu_torch.data.dataset import (
    ComposedDataset,
    CoreDataset,
    load_dataset,
)
from remora_tpu_torch.infer.infer import _put, full_f32, resolve_device
from remora_tpu_torch.kernels.encoded_kmers import (
    compute_encoded_kmer_batch as dev_enc,
)
from remora_tpu_torch.models import layers as L
from remora_tpu_torch.models import model_io
from remora_tpu_torch.models.registry import get_model
from remora_tpu_torch.train.optim import (
    RollingMAD,
    TrainOpts,
    load_optimizer_leaves,
    optimizer_leaves,
)
from remora_tpu_torch.train.validate import ValidationLogger

LOGGER = log.get_logger()
BREACH_THRESHOLD = 0.8
REGRESSION_THRESHOLD = 0.7


def cross_entropy_loss(logits, labels):
    return -torch.log_softmax(logits, 1).gather(1, labels[:, None]).mean()


def sorted_params(model):
    """(flatten key, parameter) pairs in the JAX package's leaf order
    (``tree_leaves`` of the params pytree: sorted by "layer/leaf")."""
    return sorted(
        (name.replace(".", "/"), p) for name, p in model.named_parameters()
    )


def train_forward(model, sigs, enc_kmers, compute_dtype=None,
                  channels_last=False):
    """Train-mode f32 logits; the model's BatchNorm buffers move.

    Under ``compute_dtype`` the forward runs on casts of the f32
    parameters and buffers (gradients flow back to the f32 parameters
    through the casts); the new running statistics are computed in
    ``compute_dtype`` and stored back as f32, as the JAX step does."""
    kwargs = {"train": True, "channels_last_in": channels_last}
    if compute_dtype is None:
        return model(sigs, enc_kmers, **kwargs)

    def cast(named):
        return {
            name: t.to(compute_dtype) if t.dtype == torch.float32 else t
            for name, t in named
        }

    buffers = cast(model.named_buffers())
    logits = torch.func.functional_call(
        model, {**cast(model.named_parameters()), **buffers},
        (sigs.to(compute_dtype), enc_kmers.to(compute_dtype)), kwargs,
    )
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(buffers[name])
    return logits.float()


def make_loss_fn(model, high_conf_incorrect_thr_frac=None,
                 compute_dtype=None, reduction="mean", channels_last=False,
                 mesh=None):
    """CE loss closure: ``loss_fn(sigs, enc_kmers, labels) -> (loss,
    n_filtered)`` (the model's BatchNorm buffers move as a side effect).

    ``reduction="sum"`` returns the SUM of kept per-example losses and a
    third element ``n_kept``, from which a data-parallel caller rebuilds
    the exact global masked mean. ``mesh`` (a ``parallel.mesh.Mesh``)
    takes the filter's dynamic threshold over the global batch: every
    rank's confidences and matches are gathered once."""

    def loss_fn(sigs, enc_kmers, labels):
        logits = train_forward(model, sigs, enc_kmers, compute_dtype,
                               channels_last)
        logp = torch.log_softmax(logits, 1)
        per_ex = -logp.gather(1, labels[:, None])[:, 0]
        bsz = logits.shape[0]
        if high_conf_incorrect_thr_frac is None:
            n_kept = torch.tensor(float(bsz), device=logits.device)
            loss = per_ex.sum() if reduction == "sum" else per_ex.mean()
            n_filt = torch.zeros((), dtype=torch.int32, device=logits.device)
        else:
            conf_thresh, max_frac_skip = high_conf_incorrect_thr_frac
            preds = torch.softmax(logits.detach(), 1)
            highest_preds = preds.max(1).values
            high_conf_cl = preds.argmax(1)
            cl_match = labels == high_conf_cl
            # confidences of mismatched examples (the global batch's under
            # a mesh), descending
            mm_preds = torch.where(
                cl_match, torch.full_like(highest_preds, -np.inf),
                highest_preds,
            )
            if mesh is not None:
                mm_preds = mesh.all_gather(mm_preds)
            n_all = mm_preds.shape[0]
            max_nr_skip = int(np.floor(n_all * max_frac_skip))
            n_mm = (mm_preds > -np.inf).sum()
            mm_sorted = -torch.sort(-mm_preds).values
            thresh = torch.tensor(conf_thresh, dtype=preds.dtype,
                                  device=preds.device)
            dyn_thresh = torch.where(
                n_mm > max_nr_skip,
                torch.maximum(thresh,
                              mm_sorted[min(max_nr_skip, n_all - 1)]),
                thresh,
            )
            mask = cl_match | (highest_preds < dyn_thresh)
            n_filt = (bsz - mask.sum()).to(torch.int32)
            n_kept = mask.sum().clamp(min=1).float()
            loss = (per_ex * mask).sum()
            if reduction != "sum":
                loss = loss / n_kept
        if reduction == "sum":
            return loss, n_filt, n_kept
        return loss, n_filt

    return loss_fn


def make_train_step(model, optimizer, high_conf_incorrect_thr_frac=None,
                    use_grad_clip=False, compute_dtype=None,
                    channels_last=False):
    """One optimizer step: ``step(sigs, enc_kmers, labels,
    grad_threshs=None) -> (loss, n_filtered, grad_maxs)``, scalars left on
    the device. ``grad_maxs`` (with ``use_grad_clip``) holds max|grad| per
    parameter in ``sorted_params`` order; ``grad_threshs`` (same order)
    clips the gradients before the update.

    Every parameter gets a gradient, zero where the loss does not reach it
    (``lstm2.w_hh``: the zero-state cell step never reads it), as
    ``jax.grad`` gives, so the optimizer moves every leaf as optax does."""
    loss_fn = make_loss_fn(
        model,
        high_conf_incorrect_thr_frac=high_conf_incorrect_thr_frac,
        compute_dtype=compute_dtype,
        channels_last=channels_last,
    )
    params = [p for _, p in sorted_params(model)]

    def step(sigs, enc_kmers, labels, grad_threshs=None):
        model.zero_grad(set_to_none=True)
        loss, n_filt = loss_fn(sigs, enc_kmers, labels)
        loss.backward()
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        grad_maxs = None
        if use_grad_clip:
            grad_maxs = torch.stack([g.abs().max() for g in grads])
            if grad_threshs is not None:
                for g, t in zip(grads, grad_threshs):
                    g.clamp_(-t, t)
        optimizer.step()
        return loss.detach(), n_filt, grad_maxs

    return step


def make_train_step_raw(model, optimizer, kmer_context_bases, chunk_width,
                        high_conf_incorrect_thr_frac=None,
                        use_grad_clip=False, compute_dtype=None):
    """Train step taking the RAW ragged arrays (signal (B, 1, W), int8
    sequence, int16 mapping and lengths, labels): the encoded-kmer
    featurizer runs on the device and emits the channels-last (B, W, 4K)
    layout, so each step ships the compact arrays instead of the ~50x
    larger float features."""
    bb, ab = kmer_context_bases
    inner = make_train_step(
        model,
        optimizer,
        high_conf_incorrect_thr_frac=high_conf_incorrect_thr_frac,
        use_grad_clip=use_grad_clip,
        compute_dtype=compute_dtype,
        channels_last=True,
    )

    def step(signal, sequence, seq_maps, seq_lens, labels,
             grad_threshs=None):
        enc_kmers = dev_enc(
            bb, ab, sequence, seq_maps, seq_lens, chunk_width,
            out_dtype=compute_dtype, channels_last=True,
        )
        return inner(signal.transpose(1, 2), enc_kmers, labels,
                     grad_threshs)

    return step


def make_train_step_raw_multi(step, use_grad_clip=False):
    """k optimizer steps of ``step`` per call over k stacked batches: the
    JAX package's ``lax.scan`` window, run eagerly. ``multi(*arrays,
    grad_threshs=None) -> (losses[k], n_filt[k], grad_maxs[k, n_params] |
    None)``, each array stacked along a leading axis of k (``signal[k, B,
    1, W], seqs, maps, lens, labels`` for a ``make_train_step_raw`` step),
    the results left on the device so the host reads them once per window;
    ``grad_threshs`` stay frozen over the window."""

    def multi(*arrays, grad_threshs=None):
        outs = [step(*(a[j] for a in arrays), grad_threshs=grad_threshs)
                for j in range(arrays[0].shape[0])]
        losses, n_filts, grad_maxs = zip(*outs)
        return (torch.stack(losses), torch.stack(n_filts),
                torch.stack(grad_maxs) if use_grad_clip else None)

    return multi


def _stack(arrays):
    """The window's host arrays stacked along a new leading axis (a view
    for a window of one)."""
    return arrays[0][None] if len(arrays) == 1 else np.stack(arrays)


def _write_batch_line(batch_fp, entry, high_conf_incorrect_thr_frac):
    """Write one batch.log row, converting the (lagged) device scalars."""
    it, loss, n_filt = entry
    batch_fp.write(f"{it}\t{float(loss):.6f}")
    if high_conf_incorrect_thr_frac is not None:
        batch_fp.write(f"\t{int(n_filt)}")
    batch_fp.write("\n")


def make_eval_step(model):
    """Eval-mode logits ``eval_step(sigs, enc_kmers)`` (f32, full-f32
    arithmetic; K1 carries the LSTM on CUDA)."""

    @torch.inference_mode()
    def eval_step(sigs, enc_kmers):
        with full_f32():
            return model(sigs, enc_kmers, train=False)

    return eval_step


def set_learning_rate(optimizer, lr):
    """Set the learning rate of every parameter group (the JAX package
    injects it into the optax state)."""
    if not optimizer.param_groups:
        raise RemoraError("No learning rate to set in the optimizer")
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def _start_trace(device):
    """A running torch.profiler over the host and, on a GPU, the card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof, trace_dir, device):
    """Stop ``prof`` and write its Chrome trace into ``trace_dir``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "train_epoch0.trace.json")
    prof.export_chrome_trace(path)
    LOGGER.info(f"torch.profiler trace written to {path}")


def train_model(
    seed,
    out_path,
    remora_dataset_path,
    chunk_context,
    kmer_context_bases,
    batch_size,
    model_name,
    size,
    train_opts: TrainOpts,
    chunks_per_epoch,
    num_test_chunks,
    save_freq=10,
    filt_frac=constants.DEFAULT_FILT_FRAC,
    ext_val=None,
    ext_val_names=None,
    high_conf_incorrect_thr_frac=None,
    finetune_path=None,
    freeze_num_layers=0,
    super_batch_size=constants.DEFAULT_SUPER_BATCH_SIZE,
    super_batch_sample_frac=None,
    gradient_clip_num_mads=None,
    mesh=None,
    featurize_on_device=True,
    resume_from_checkpoint=None,
    bf16_compute=False,
    sync_bn=False,
    read_batches_from_disk=False,
    steps_per_launch=1,
    device=None,
):
    if mesh is not None:
        # a rank trains on its mesh device
        if device is not None and torch.device(device) != mesh.device:
            raise RemoraError(f"device {device} is not the mesh's "
                              f"{mesh.device}")
        device = mesh.device
    device = resolve_device(device)
    L.convbn_impl(device)  # refuses an unknown REMORA_TPU_CONVBN mode
    out_path = str(out_path)
    os.makedirs(out_path, exist_ok=True)
    if seed is None:
        seed = np.random.randint(0, np.iinfo(np.uint32).max, dtype=np.uint32)
        if mesh is not None:
            # one seed on every rank: the same initial replicas
            seed = int(mesh.broadcast(torch.tensor(
                [int(seed)], dtype=torch.int64, device=device))[0])
    LOGGER.info(f"Seed selected is {seed}")
    np.random.seed(int(seed))
    generator = torch.Generator().manual_seed(int(seed))

    LOGGER.info("Loading dataset from dataset config")
    override_metadata = {"extra_arrays": {}}
    if kmer_context_bases is not None:
        override_metadata["kmer_context_bases"] = kmer_context_bases
    if chunk_context is not None:
        override_metadata["chunk_context"] = chunk_context
    paths, props, hashes = load_dataset(str(remora_dataset_path))
    dataset = ComposedDataset(
        [
            CoreDataset(path, override_metadata=override_metadata.copy())
            for path in paths
        ],
        props,
        hashes,
        batch_size=batch_size,
        super_batch_size=super_batch_size,
        super_batch_sample_frac=super_batch_sample_frac,
    )
    with open(os.path.join(out_path, "dataset_config.jsn"), "w") as fh:
        json.dump(dataset.get_config(), fh)
    dataset.metadata.write(os.path.join(out_path, "dataset_metadata.jsn"))
    LOGGER.info(f"Dataset summary:\n{dataset.summary}")

    LOGGER.info("Loading model")
    arch = get_model(model_name)
    model_params = {
        "size": size,
        "kmer_len": dataset.metadata.kmer_len,
        "num_out": dataset.metadata.num_labels,
    }
    model = arch.init(generator, **model_params)

    if finetune_path is not None:
        model, f_meta = model_io.load_model(finetune_path)
        if tuple(f_meta["chunk_context"]) != tuple(
            dataset.metadata.chunk_context
        ):
            raise RemoraError(
                "The chunk context of the pre-trained model and the dataset "
                "do not match."
            )
        if tuple(f_meta["kmer_context_bases"]) != tuple(
            dataset.metadata.kmer_context_bases
        ):
            raise RemoraError(
                "The kmer context bases of the pre-trained model and the "
                "dataset do not match."
            )
        arch = get_model(f_meta.get("model_name", model_name))
        if f_meta["model_params"]["num_out"] != dataset.metadata.num_labels:
            # swap classification head for new label space
            model.fc = L.Linear(
                model.fc.w.shape[1], dataset.metadata.num_labels, generator
            )
        model_params["size"] = f_meta["model_params"]["size"]
        LOGGER.info(f"Fine-tuning from {finetune_path}")

    start_epoch = 0
    restored = None
    if resume_from_checkpoint is not None:
        model, r_meta = model_io.load_model(resume_from_checkpoint)
        arch = get_model(r_meta.get("model_name", model_name))
        model_params = r_meta["model_params"]
        restored = model_io.load_opt_state(resume_from_checkpoint)
        start_epoch = int(r_meta.get("epoch", 0))
        LOGGER.info(
            f"Resuming from {resume_from_checkpoint} at epoch {start_epoch}"
        )
    model = model.to(device)

    named = sorted_params(model)
    frozen = set()
    if finetune_path is not None and freeze_num_layers:
        frozen = {name for name, _ in named[:freeze_num_layers]}
        LOGGER.info(f"Freezing params: {sorted(frozen)}")
    trainable = [p for name, p in named if name not in frozen]
    LOGGER.info(f"Params (k) {L.param_count(model) / 1000:.2f}")

    optimizer = train_opts.load_optimizer(trainable)
    opt_count = 0
    if restored is not None:
        opt_count = load_optimizer_leaves(optimizer, trainable, restored)
    lr_schedule = train_opts.load_scheduler()

    LOGGER.debug("Splitting dataset")
    trn_ds, val_ds = dataset.train_test_split(
        num_test_chunks, override_metadata=override_metadata
    )
    val_ds.super_batch_sample_frac = None
    val_ds.do_check_super_batches = True
    val_trn_ds = trn_ds.head(num_test_chunks,
                             override_metadata=override_metadata)
    val_trn_ds.super_batch_sample_frac = None
    val_trn_ds.do_check_super_batches = True
    if not read_batches_from_disk:
        val_ds.load_all_batches()
        val_trn_ds.load_all_batches()

    ext_datasets = []
    if ext_val:
        if ext_val_names is None:
            ext_val_names = [f"e_val_{i}" for i in range(len(ext_val))]
        for e_name, e_path in zip(ext_val_names, ext_val):
            e_paths, e_props, e_hashes = load_dataset(e_path.strip())
            e_ds = ComposedDataset(
                [
                    CoreDataset(
                        p,
                        override_metadata=override_metadata.copy(),
                        infinite_iter=False,
                        do_check_super_batches=True,
                    )
                    for p in e_paths
                ],
                e_props,
                e_hashes,
                batch_size=batch_size,
            )
            e_ds.update_metadata(dataset)
            if not read_batches_from_disk:
                e_ds.load_all_batches()
            ext_datasets.append((e_name, e_ds))

    use_grad_clip = gradient_clip_num_mads is not None
    world = 1
    if mesh is not None:
        from remora_tpu_torch.data.dataset import shard_for_process
        from remora_tpu_torch.parallel import mesh as mesh_mod

        world = mesh.world
        LOGGER.info(f"Data-parallel training over {world} devices")
        if world > 1:
            # per-rank input sharding: every rank streams a disjoint
            # super-batch stripe and contributes its slice of the global
            # batch
            if batch_size % world:
                raise RemoraError(
                    f"batch size ({batch_size}) must divide evenly over "
                    f"{world} processes"
                )
            shard_for_process(trn_ds, mesh.rank, world)
            trn_ds.set_batch_size(batch_size // world)
            LOGGER.info(
                f"Process {mesh.rank}/{world} streams "
                f"{batch_size // world} chunks per global batch "
                f"from its dataset stripe"
            )
    compute_dtype = torch.bfloat16 if bf16_compute else None
    if bf16_compute:
        LOGGER.info("Training compute in bfloat16 (f32 master weights)")
    names = (("signal", "sequence", "sequence_to_signal_mapping",
              "sequence_lengths", "labels") if featurize_on_device
             else ("signal", "enc_kmers", "labels"))
    if mesh is not None:
        # one all-reduce a step: grads, BN statistics, loss and counts
        train_step = mesh_mod.make_dp_train_step(
            model,
            optimizer,
            mesh,
            high_conf_incorrect_thr_frac=high_conf_incorrect_thr_frac,
            compute_dtype=compute_dtype,
            use_grad_clip=use_grad_clip,
            sync_bn=sync_bn,
            featurize_args=(
                (dataset.metadata.kmer_context_bases,
                 dataset.metadata.chunk_width)
                if featurize_on_device else None
            ),
        )
    elif featurize_on_device:
        train_step = make_train_step_raw(
            model,
            optimizer,
            dataset.metadata.kmer_context_bases,
            dataset.metadata.chunk_width,
            high_conf_incorrect_thr_frac=high_conf_incorrect_thr_frac,
            use_grad_clip=use_grad_clip,
            compute_dtype=compute_dtype,
        )
    else:
        train_step = make_train_step(
            model,
            optimizer,
            high_conf_incorrect_thr_frac=high_conf_incorrect_thr_frac,
            use_grad_clip=use_grad_clip,
            compute_dtype=compute_dtype,
        )
    # every call runs a window of stacked batches: steps_per_launch steps on
    # the raw path, one step otherwise; numerics per step identical
    # (grad-clip thresholds frozen within each window)
    multi_step = make_train_step_raw_multi(train_step, use_grad_clip)
    if steps_per_launch > 1:
        if featurize_on_device and mesh is None:
            LOGGER.info(
                f"Launching {steps_per_launch} optimizer steps per call"
            )
        else:
            LOGGER.info(
                "--steps-per-launch requires the raw (on-device "
                "featurization) single-host path; running one step per "
                "launch"
            )
            steps_per_launch = 1
    if mesh is not None:
        # sharded validation: each rank computes 1/world of every batch;
        # the gathered logits, and so validation.log, are the same bytes
        # on every rank
        eval_fn = mesh_mod.make_dp_eval_fn(model, mesh)
    else:
        eval_step = make_eval_step(model)

        def eval_fn(sigs, enc_kmers):
            return eval_step(_put(sigs, device),
                             _put(enc_kmers, device)).cpu().numpy()

    rolling_mads = None
    grad_threshs = None
    if use_grad_clip:
        rolling_mads = RollingMAD(len(named), gradient_clip_num_mads)

    with open(os.path.join(out_path, "validation.log"), "w",
              buffering=1) as val_fp, \
            open(os.path.join(out_path, "batch.log"), "w",
                 buffering=1) as batch_fp:
        val_logger = ValidationLogger(val_fp)
        if high_conf_incorrect_thr_frac is not None:
            batch_fp.write("Iteration\tLoss\tNumberFiltered\n")
        else:
            batch_fp.write("Iteration\tLoss\n")
        LOGGER.info("Running initial validation")
        val_metrics = val_logger.validate_model(
            eval_fn, dataset.metadata.mod_bases, val_ds, filt_frac
        )
        trn_metrics = val_logger.validate_model(
            eval_fn, dataset.metadata.mod_bases, val_trn_ds, filt_frac, "trn"
        )
        batches_per_epoch = int(np.ceil(chunks_per_epoch / batch_size))
        with open(os.path.join(out_path, "epoch_summary.txt"), "w") as fh:
            fh.write(trn_ds.epoch_summary(batches_per_epoch) + "\n")
        best_alt_val_accs = {name: 0 for name, _ in ext_datasets}
        for ext_name, ext_ds in ext_datasets:
            val_logger.validate_model(
                eval_fn, dataset.metadata.mod_bases, ext_ds, filt_frac,
                ext_name,
            )

        ckpt_meta, ckpt_meta_arrays = model_io.make_model_metadata(
            dataset.metadata, getattr(arch, "NAME", str(model_name)),
            model_params,
        )

        def save(name):
            model_io.save_model(
                os.path.join(out_path, name),
                model,
                {**ckpt_meta, "epoch": epoch + 1},
                ckpt_meta_arrays,
                opt_state=optimizer_leaves(optimizer, trainable, opt_count),
            )

        LOGGER.info("Start training")
        best_val_acc = 0
        early_stop_epochs = 0
        breached = False
        epoch = start_epoch
        trn_iter = trn_ds.iter_batches(raw=featurize_on_device)
        pending_losses = deque()
        # optional trace of the first epoch (the JAX package's device trace
        # under the same variable): a Chrome trace for chrome://tracing or
        # Perfetto
        trace_dir = os.environ.get("REMORA_TPU_JAX_TRACE_DIR")
        with full_f32():
            for epoch in range(start_epoch, train_opts.epochs):
                prof = None
                if trace_dir is not None and epoch == 0:
                    prof = _start_trace(device)
                set_learning_rate(optimizer, lr_schedule(epoch))
                t0 = time.monotonic()
                n_chunks = 0
                epoch_i = 0
                carry = None  # the batch that ended the last window early
                while epoch_i < batches_per_epoch:
                    # a window of steps_per_launch batches while the epoch
                    # has room for one, else of one; a batch whose shapes
                    # differ from the window's first (a short batch at a
                    # super batch's end) ends it early and opens the next
                    k = (steps_per_launch
                         if epoch_i + steps_per_launch <= batches_per_epoch
                         else 1)
                    batches = [next(trn_iter) if carry is None else carry]
                    carry = None
                    shapes = [batches[0][n].shape for n in names]
                    while len(batches) < k:
                        batch = next(trn_iter)
                        if [batch[n].shape for n in names] != shapes:
                            carry = batch
                            break
                        batches.append(batch)
                    step_inputs = tuple(
                        _put(_stack([b[n] for b in batches]), device)
                        for n in names
                    )
                    losses, n_filts, grad_maxs = multi_step(
                        *step_inputs, grad_threshs=grad_threshs)
                    opt_count += len(batches)
                    n_chunks += sum(b["labels"].shape[0]
                                    for b in batches) * world
                    if use_grad_clip:
                        # one RollingMAD update per step, from the window's
                        # stacked maxima (the thresholds were frozen within
                        # it)
                        for maxs in grad_maxs.cpu().tolist():
                            threshs = rolling_mads.update(maxs)
                        if threshs is not None:
                            grad_threshs = [float(t) for t in threshs]
                    # fetch losses with a lag so the scalar read does not
                    # fence every window: the device stays several steps
                    # ahead (grad clipping already fences on grad_maxs)
                    for j in range(len(batches)):
                        pending_losses.append(
                            (epoch * batches_per_epoch + epoch_i + j,
                             losses[j], n_filts[j])
                        )
                        if len(pending_losses) > 8:
                            _write_batch_line(
                                batch_fp, pending_losses.popleft(),
                                high_conf_incorrect_thr_frac,
                            )
                    epoch_i += len(batches)
                while pending_losses:
                    _write_batch_line(
                        batch_fp, pending_losses.popleft(),
                        high_conf_incorrect_thr_frac,
                    )
                dt = time.monotonic() - t0
                if prof is not None:
                    _stop_trace(prof, trace_dir, device)
                LOGGER.info(
                    f"Epoch {epoch + 1}: {n_chunks / dt:,.0f} chunks/s "
                    f"({batches_per_epoch} batches in {dt:.1f}s)"
                )

                val_metrics = val_logger.validate_model(
                    eval_fn,
                    dataset.metadata.mod_bases,
                    val_ds,
                    filt_frac,
                    nepoch=epoch + 1,
                    niter=(epoch + 1) * batches_per_epoch,
                )
                trn_metrics = val_logger.validate_model(
                    eval_fn,
                    dataset.metadata.mod_bases,
                    val_trn_ds,
                    filt_frac,
                    "trn",
                    nepoch=epoch + 1,
                    niter=(epoch + 1) * batches_per_epoch,
                )
                LOGGER.info(
                    f"Epoch {epoch + 1} val_acc {val_metrics.acc:.4f} "
                    f"trn_acc {trn_metrics.acc:.4f} "
                    f"val_loss {val_metrics.loss:.6f}"
                )

                if breached:
                    if val_metrics.acc <= REGRESSION_THRESHOLD:
                        LOGGER.warning("Remora training unstable")
                elif val_metrics.acc >= BREACH_THRESHOLD:
                    breached = True
                    LOGGER.debug(
                        f"{BREACH_THRESHOLD * 100}% accuracy threshold "
                        "surpassed"
                    )

                if val_metrics.acc > best_val_acc:
                    best_val_acc = val_metrics.acc
                    early_stop_epochs = 0
                    save(constants.BEST_MODEL_FILENAME)
                else:
                    early_stop_epochs += 1

                for ext_name, ext_ds in ext_datasets:
                    ext_ms = val_logger.validate_model(
                        eval_fn,
                        dataset.metadata.mod_bases,
                        ext_ds,
                        filt_frac,
                        ext_name,
                        nepoch=epoch + 1,
                        niter=(epoch + 1) * batches_per_epoch,
                    )
                    if ext_ms.acc > best_alt_val_accs[ext_name]:
                        best_alt_val_accs[ext_name] = ext_ms.acc
                        early_stop_epochs = 0
                        save(f"model_ext_val_{ext_name}_best.checkpoint")

                if (epoch + 1) % save_freq == 0:
                    save(f"model_{epoch + 1:06d}.checkpoint")

                if (
                    train_opts.early_stopping
                    and early_stop_epochs >= train_opts.early_stopping
                ):
                    LOGGER.info(
                        "No validation accuracy improvement after "
                        f"{train_opts.early_stopping} epochs. Training "
                        "stopped early."
                    )
                    break

        LOGGER.info("Saving final model checkpoint")
        save(constants.FINAL_MODEL_FILENAME)
        return best_val_acc
