"""Sub-command registration + runners (reference analog ``parsers.py``).

Counterpart of ``remora_tpu/cli/parsers.py``: the same subcommands, with
the same option strings and positional arity. Each ``register_*`` wires
argparse flags; each ``run_*`` lazy-imports the heavy modules and drives
the workload.

Where the JAX package switches its process-wide device
(``jax_setup.select_device``), this package resolves ``--device`` once
(``cli.util.parse_device``: cpu, cuda, cuda:N, or an integer N meaning
cuda:N; without it the GPU, and a run raises when there is none) and
hands the device to the model loader and the drivers. The distributed
flags start a ``torch.distributed`` process group of one process per
device (``cli.util.start_distributed``); each rank writes its own
outputs, and ``infer from_pod5_and_bam``'s rank 0 merges the BAM parts.
"""

import json
import os
import sys

from remora_tpu_torch import constants

DEVICE_HELP = (
    "torch device: cpu, cuda, cuda:N, or an integer N (cuda:N). Default: "
    "the GPU; the run raises when there is none"
)


# --------------------------------------------------------------------
# dataset
# --------------------------------------------------------------------


def register_dataset(subparsers):
    parser = subparsers.add_parser(
        "dataset", help="dataset preparation and manipulation"
    )
    parser.set_defaults(func=lambda args: parser.print_help())
    ssub = parser.add_subparsers(title="dataset commands")
    register_dataset_prepare(ssub)
    register_dataset_inspect(ssub)
    register_dataset_make_config(ssub)
    register_dataset_merge(ssub)
    register_dataset_head(ssub)
    register_dataset_copy(ssub)


def register_dataset_prepare(ssub):
    p = ssub.add_parser(
        "prepare", help="extract training chunks from POD5 + BAM"
    )
    p.add_argument("pod5", help="POD5 file or directory")
    p.add_argument("in_bam", help="BAM with basecalls, mv (+MD) tags")
    out = p.add_argument_group("Output Arguments")
    out.add_argument("--output-path", default="remora_training_dataset")
    out.add_argument("--overwrite", action="store_true")
    out.add_argument("--log-filename")
    data = p.add_argument_group("Data Arguments")
    data.add_argument(
        "--mod-base", nargs=2, metavar=("SHORT_NAME", "LONG_NAME")
    )
    data.add_argument("--mod-base-control", action="store_true")
    data.add_argument(
        "--motif", nargs=2, action="append", metavar=("MOTIF", "FOCUS_POS")
    )
    data.add_argument("--focus-reference-positions")
    data.add_argument(
        "--chunk-context", nargs=2, type=int,
        default=constants.DEFAULT_CHUNK_CONTEXT,
    )
    data.add_argument(
        "--min-samples-per-base", type=int,
        default=constants.DEFAULT_MIN_SAMPLES_PER_BASE,
    )
    data.add_argument(
        "--kmer-context-bases", nargs=2, type=int,
        default=constants.DEFAULT_KMER_CONTEXT_BASES,
    )
    data.add_argument(
        "--max-chunks-per-read", type=int,
        default=constants.DEFAULT_MAX_CHUNKS_PER_READ,
    )
    data.add_argument(
        "--chunk-extract-offset", "--offset", type=int, default=0
    )
    data.add_argument(
        "--chunk-extract-base-start", "--base-start-justify",
        action="store_true",
        help="extract chunks justified at the start of the focus base",
    )
    data.add_argument("--num-reads", type=int)
    data.add_argument("--basecall-anchor", action="store_true")
    data.add_argument("--reverse-signal", action="store_true")
    data.add_argument("--skip-shuffle", action="store_true")
    data.add_argument(
        "--save-every", type=int, default=100_000,
        help="flush dataset every N chunks",
    )
    data.add_argument(
        "--basecall-model", "--picoamp-scaling-basecall-model",
        help="Dorado basecall model dir for pA scaling (config.toml)",
    )
    refine = p.add_argument_group("Signal Mapping Refine Arguments")
    refine.add_argument("--refine-kmer-level-table")
    refine.add_argument("--refine-rough-rescale", action="store_true")
    refine.add_argument(
        "--refine-scale-iters", type=int, default=-1,
        help="Iterations of refinement+rescale. 0: refine only; "
        "-1 (default): skip refinement",
    )
    refine.add_argument(
        "--refine-half-bandwidth", type=int,
        default=constants.DEFAULT_REFINE_HBW,
    )
    refine.add_argument(
        "--refine-algo", default=constants.DEFAULT_REFINE_ALGO,
        choices=constants.REFINE_ALGOS,
    )
    refine.add_argument(
        "--refine-short-dwell-parameters", nargs=3, type=float,
        default=constants.DEFAULT_REFINE_SHORT_DWELL_PARAMS,
        metavar=("TARGET", "LIMIT", "WEIGHT"),
    )
    refine.add_argument(
        "--refine-rough-rescale-method", "--rough-rescale-method",
        default=constants.DEFAULT_ROUGH_RESCALE_METHOD,
        choices=constants.ROUGH_RESCALE_METHODS,
    )
    refine.add_argument(
        "--refine-backend", default=constants.REFINE_BACKEND_AUTO,
        choices=constants.REFINE_BACKENDS,
        help="Banded-DP execution backend: auto (native C++ core when "
        "built, else NumPy), native, numpy, or device (batched K4/K5 "
        "CUDA kernel launches on the GPU). Routing only; results are "
        "identical across backends",
    )
    comp = p.add_argument_group("Compute Arguments")
    comp.add_argument("--num-extract-alignment-workers", type=int, default=1)
    comp.add_argument("--num-extract-chunks-workers", type=int, default=1)
    p.set_defaults(func=run_dataset_prepare)


def _build_refiner(args):
    from remora_tpu_torch.refine.refiner import SigMapRefiner

    return SigMapRefiner(
        kmer_model_filename=args.refine_kmer_level_table,
        do_rough_rescale=args.refine_rough_rescale,
        scale_iters=args.refine_scale_iters,
        algo=args.refine_algo,
        half_bandwidth=args.refine_half_bandwidth,
        sd_params=tuple(args.refine_short_dwell_parameters),
        do_fix_guage=True,
        rough_rescale_method=args.refine_rough_rescale_method,
        backend=args.refine_backend,
    )


def run_dataset_prepare(args):
    from remora_tpu_torch import RemoraError
    from remora_tpu_torch.core.seq import Motif
    from remora_tpu_torch.core.util import prepare_out_dir
    from remora_tpu_torch.io.refregion import parse_bed
    from remora_tpu_torch.prepare import extract_chunk_dataset

    if args.mod_base is None and not args.mod_base_control:
        raise RemoraError("Must specify either --mod-base or --mod-base-control")
    prepare_out_dir(args.output_path, args.overwrite)
    motifs = [Motif(m, int(p)) for m, p in (args.motif or [("N", 0)])]
    focus_ref_pos = (
        None
        if args.focus_reference_positions is None
        else parse_bed(args.focus_reference_positions)
    )
    sig_map_refiner = _build_refiner(args)
    pa_scaling = None
    if args.basecall_model is not None:
        from remora_tpu_torch.cli.util import parse_picoamps

        pa_scaling = parse_picoamps(args.basecall_model, sig_map_refiner)
    extract_chunk_dataset(
        bam_path=args.in_bam,
        pod5_path=args.pod5,
        out_path=args.output_path,
        mod_base=args.mod_base,
        mod_base_control=args.mod_base_control,
        motifs=motifs,
        focus_ref_pos=focus_ref_pos,
        chunk_context=tuple(args.chunk_context),
        min_samps_per_base=args.min_samples_per_base,
        max_chunks_per_read=args.max_chunks_per_read,
        pa_scaling=pa_scaling,
        sig_map_refiner=sig_map_refiner,
        kmer_context_bases=tuple(args.kmer_context_bases),
        base_start_justify=args.chunk_extract_base_start,
        offset=args.chunk_extract_offset,
        num_reads=args.num_reads,
        num_extract_alignment_workers=args.num_extract_alignment_workers,
        num_extract_chunks_workers=args.num_extract_chunks_workers,
        basecall_anchor=args.basecall_anchor,
        rev_sig=args.reverse_signal,
        save_every=args.save_every,
        skip_shuffle=args.skip_shuffle,
    )


def register_dataset_inspect(ssub):
    p = ssub.add_parser("inspect", help="summarize a dataset")
    p.add_argument("dataset_path")
    p.add_argument("--out-path", help="write a config for this dataset")
    p.set_defaults(func=run_dataset_inspect)


def run_dataset_inspect(args):
    from remora_tpu_torch import log
    from remora_tpu_torch.data.dataset import ComposedDataset, CoreDataset, load_dataset

    logger = log.get_logger()
    paths, props, hashes = load_dataset(args.dataset_path)
    ds = ComposedDataset(
        [CoreDataset(p) for p in paths], props, hashes, batch_size=1
    )
    print(ds.summary)
    for sub in ds.datasets:
        print(sub.summary)
    if args.out_path is not None:
        with open(args.out_path, "w") as fh:
            json.dump(ds.get_config(), fh)
        logger.info(f"Wrote dataset config to {args.out_path}")


def register_dataset_make_config(ssub):
    p = ssub.add_parser(
        "make_config", help="compose datasets into a weighted config"
    )
    p.add_argument("out_path")
    p.add_argument(
        "datasets", nargs="*",
        help="core dataset (or config) paths; weights via "
        "--dataset-weights (default: dataset sizes)",
    )
    p.add_argument(
        "--dataset-weights", type=float, nargs="+",
        help="weight per positional dataset (same length)",
    )
    p.add_argument(
        "--dataset", nargs=2, action="append",
        metavar=("PATH", "WEIGHT"),
        help="alternative (PATH, WEIGHT) pair form; may repeat",
    )
    p.add_argument("--log-filename")
    p.add_argument("--skip-hash", action="store_true")
    p.set_defaults(func=run_dataset_make_config)


def run_dataset_make_config(args):
    from remora_tpu_torch import RemoraError, log
    from remora_tpu_torch.data.dataset import CoreDataset

    if args.log_filename:
        log.init_logger(args.log_filename)
    pairs = [(p, float(w)) for p, w in (args.dataset or [])]
    if args.datasets:
        from remora_tpu_torch.data.dataset import load_dataset

        weights = args.dataset_weights
        if weights is not None and len(weights) != len(args.datasets):
            raise RemoraError(
                "--dataset-weights must match the number of datasets"
            )
        for i, ds_path in enumerate(args.datasets):
            # a positional input may itself be a config: expand it to
            # its core datasets (reference run_dataset_make_config)
            core_paths, core_props, _hashes = load_dataset(ds_path)
            if weights is not None:
                w = float(weights[i])
                total = sum(core_props)
                pairs.extend(
                    (p, w * prop / total)
                    for p, prop in zip(core_paths, core_props)
                )
            else:
                # reference default: weight each core dataset by size
                pairs.extend(
                    (p, float(CoreDataset(p).size)) for p in core_paths
                )
    if not pairs:
        raise RemoraError("No datasets given")
    cfg = []
    for path, weight in pairs:
        if args.skip_hash:
            cfg.append([path, weight])
        else:
            cfg.append([path, weight, CoreDataset.hash(path)])
    with open(args.out_path, "w") as fh:
        json.dump(cfg, fh)


def register_dataset_merge(ssub):
    p = ssub.add_parser(
        "merge",
        help="physically merge core datasets into one new core dataset",
    )
    p.add_argument("out_path", help="path for the merged dataset")
    p.add_argument(
        "dataset_paths", nargs="+",
        help="core datasets or configs to merge",
    )
    p.add_argument("--max-size", type=int)
    p.add_argument("--overwrite", action="store_true")
    p.set_defaults(func=run_dataset_merge)


def run_dataset_merge(args):
    import numpy as np

    from remora_tpu_torch import log
    from remora_tpu_torch.core.util import prepare_out_dir
    from remora_tpu_torch.data.dataset import (
        ComposedDataset,
        CoreDataset,
        compute_best_split,
        load_dataset,
    )

    logger = log.get_logger()
    prepare_out_dir(args.out_path, args.overwrite)
    all_paths = [
        sub
        for ds_path in args.dataset_paths
        for sub in load_dataset(ds_path)[0]
    ]
    dataset = ComposedDataset(
        [
            CoreDataset(p, infinite_iter=False, do_check_super_batches=True)
            for p in all_paths
        ],
        np.ones(len(all_paths)) / len(all_paths),
    )
    merged_metadata = dataset.metadata.copy()
    ds_out_sizes = np.array([ds.size for ds in dataset.datasets])
    if args.max_size is not None and ds_out_sizes.sum() > args.max_size:
        ds_out_sizes = compute_best_split(
            args.max_size, ds_out_sizes / ds_out_sizes.sum()
        )
    merged_metadata.allocate_size = int(ds_out_sizes.sum())
    merged_metadata.max_seq_len = max(
        ds.metadata.max_seq_len for ds in dataset.datasets
    )
    merged_metadata.dataset_start = 0
    merged_metadata.dataset_end = 0
    merged = CoreDataset(
        data_path=args.out_path, mode="w", metadata=merged_metadata
    )
    seq_w = merged_metadata.sequence_width
    map_w = merged_metadata.sequence_to_signal_mapping_width
    for ds, out_size in zip(dataset.datasets, ds_out_sizes):
        if ds.metadata.dataset_end != out_size:
            ds.metadata.dataset_end = int(out_size)
        ds.adjust_batch_params()
        for sb in ds.iter_super_batches():
            # widen ragged arrays to the merged max_seq_len
            seq = sb["sequence"]
            if seq.shape[1] < seq_w:
                seq = np.pad(seq, ((0, 0), (0, seq_w - seq.shape[1])))
            maps = sb["sequence_to_signal_mapping"]
            if maps.shape[1] < map_w:
                maps = np.pad(maps, ((0, 0), (0, map_w - maps.shape[1])))
            sb = dict(sb, sequence=seq, sequence_to_signal_mapping=maps)
            merged.write_batch(sb)
            merged.flush()
            merged.write_metadata()
    logger.info("Shuffling merged dataset")
    merged.shuffle()
    merged.flush()
    merged.write_metadata()
    logger.info(f"Saved merged dataset with {merged.size:,} chunks")


def register_dataset_head(ssub):
    p = ssub.add_parser("head", help="copy the first N chunks to a new dataset")
    # reference argument order (parsers.py "dataset head")
    p.add_argument("output_dataset")
    p.add_argument("input_dataset")
    p.add_argument("num_chunks", type=int)
    p.add_argument("--overwrite", action="store_true")
    p.set_defaults(func=run_dataset_head)


def run_dataset_head(args):
    _copy_dataset(args.input_dataset, args.output_dataset, args.num_chunks,
                  overwrite=args.overwrite)


def register_dataset_copy(ssub):
    p = ssub.add_parser("copy", help="copy a dataset (compacting allocation)")
    p.add_argument("input_dataset")
    p.add_argument("output_dataset")
    p.add_argument("--overwrite", action="store_true")
    p.set_defaults(func=run_dataset_copy)


def run_dataset_copy(args):
    _copy_dataset(args.input_dataset, args.output_dataset, None,
                  overwrite=args.overwrite)


def _copy_dataset(in_path, out_path, num_chunks, overwrite=False):
    import shutil

    from remora_tpu_torch import RemoraError
    from remora_tpu_torch.data.dataset import CoreDataset

    if os.path.exists(out_path):
        if not overwrite:
            raise RemoraError(
                f"{out_path} exists; use --overwrite to replace it"
            )
        if os.path.isdir(out_path):
            shutil.rmtree(out_path)
        else:
            os.unlink(out_path)

    src = CoreDataset(in_path)
    size = src.size if num_chunks is None else min(num_chunks, src.size)
    md = src.metadata.copy()
    md.allocate_size = size
    md.dataset_start = 0
    md.dataset_end = 0
    dst = CoreDataset(data_path=out_path, mode="w", metadata=md)
    st = src.metadata.dataset_start
    arrays = {
        name: getattr(src, name)[st : st + size] for name in src.array_names
    }
    dst.write_batch(arrays)
    dst.write_metadata()
    dst.flush()


# --------------------------------------------------------------------
# model
# --------------------------------------------------------------------


def register_model(subparsers):
    parser = subparsers.add_parser("model", help="model training and management")
    parser.set_defaults(func=lambda args: parser.print_help())
    ssub = parser.add_subparsers(title="model commands")
    register_model_train(ssub)
    register_model_inspect(ssub)
    register_model_export(ssub)
    register_model_list_pretrained(ssub)
    register_model_download(ssub)


def register_model_train(ssub):
    p = ssub.add_parser("train", help="train a modified-base model")
    p.add_argument("remora_dataset_path", help="core dataset dir or config")
    data = p.add_argument_group("Data Arguments")
    data.add_argument("--chunk-context", nargs=2, type=int)
    data.add_argument("--kmer-context-bases", nargs=2, type=int)
    data.add_argument(
        "--batch-size", type=int, default=constants.DEFAULT_BATCH_SIZE
    )
    data.add_argument(
        "--chunks-per-epoch", type=int,
        default=constants.DEFAULT_CHUNKS_PER_EPOCH,
    )
    data.add_argument(
        "--num-test-chunks", type=int,
        default=constants.DEFAULT_NUM_TEST_CHUNKS,
    )
    data.add_argument(
        "--filt-frac", "--filter-fraction", type=float,
        default=constants.DEFAULT_FILT_FRAC,
    )
    data.add_argument(
        "--super-batch-size", type=int,
        default=constants.DEFAULT_SUPER_BATCH_SIZE,
    )
    data.add_argument(
        "--super-batch-sample-frac", "--super-batch-sample-fraction",
        type=float, default=constants.DEFAULT_SUPER_BATCH_SAMPLE_FRAC,
    )
    data.add_argument(
        "--read-batches-from-disk", action="store_true",
        help="re-stream validation batches from disk each epoch instead "
        "of caching them in memory",
    )
    data.add_argument("--ext-val", nargs="+")
    data.add_argument("--ext-val-names", nargs="+")
    out = p.add_argument_group("Output Arguments")
    out.add_argument("--output-path", default="remora_train_results")
    out.add_argument("--overwrite", action="store_true")
    out.add_argument("--save-freq", type=int, default=10)
    mdl = p.add_argument_group("Model Arguments")
    mdl.add_argument(
        "--model", default="ConvLSTM_w_ref",
        help="builtin model name or model .py file",
    )
    mdl.add_argument("--size", type=int, default=constants.DEFAULT_NN_SIZE)
    mdl.add_argument("--finetune-path")
    mdl.add_argument("--freeze-num-layers", type=int, default=0)
    trn = p.add_argument_group("Training Arguments")
    trn.add_argument("--epochs", type=int, default=constants.DEFAULT_EPOCHS)
    trn.add_argument("--optimizer", default=constants.DEFAULT_OPTIMIZER)
    trn.add_argument("--lr", type=float, default=constants.DEFAULT_LR)
    trn.add_argument(
        "--opt-kwargs", "--optimizer-kwargs", nargs=3, action="append",
        metavar=("NAME", "VALUE", "TYPE"),
        help="typed optimizer kwarg passthrough, e.g. weight_decay 1e-5 float",
    )
    trn.add_argument(
        "--lr-scheduler-kwargs", nargs=3, action="append",
        metavar=("NAME", "VALUE", "TYPE"),
    )
    trn.add_argument(
        "--scheduler", "--lr-scheduler", default=constants.DEFAULT_SCHEDULER
    )
    trn.add_argument(
        "--lr-cool-down-epochs", type=int,
        default=constants.DEFAULT_SCH_COOL_DOWN_EPOCHS,
    )
    trn.add_argument(
        "--lr-cool-down-lr", "--lr-cool-down-learning-rate", type=float,
        default=constants.DEFAULT_SCH_COOL_DOWN_LR,
    )
    trn.add_argument(
        "--early-stopping", type=int, default=constants.DEFAULT_EARLY_STOPPING
    )
    trn.add_argument("--seed", type=int)
    trn.add_argument(
        "--high-conf-incorrect-thr-frac", nargs=2, type=float,
        metavar=("THRESHOLD", "MAX_FRAC"),
    )
    trn.add_argument("--gradient-clip-num-mads", type=float)
    trn.add_argument("--resume-from-checkpoint")
    trn.add_argument(
        "--bf16", action="store_true",
        help="run forward/backward in bfloat16 against f32 master weights",
    )
    trn.add_argument(
        "--steps-per-launch", type=int, default=1,
        help="optimizer steps per call (a window of stacked batches); "
        "amortizes dispatch latency. Requires the default raw "
        "single-host path; grad-clip thresholds update once per call",
    )
    p.add_argument(
        "--device",
        help=DEVICE_HELP,
    )
    dist = p.add_argument_group("Distributed Arguments")
    dist.add_argument(
        "--data-parallel", action="store_true",
        help="train data-parallel: alone, a group of one process on "
        "this device; with --num-processes, over the process group",
    )
    dist.add_argument("--coordinator-address",
                      help="host:port where the processes meet")
    dist.add_argument("--num-processes", type=int,
                      help="ranks of the process group, one process per "
                      "device (NCCL on GPUs, gloo on the CPU)")
    dist.add_argument("--process-id", type=int,
                      help="this process's rank (its GPU: --device, else "
                      "the process id modulo the visible GPUs)")
    dist.add_argument(
        "--sync-bn", action="store_true",
        help="global-batch BatchNorm under data parallelism "
        "(bit-matches single-device training; extra per-layer "
        "collectives). Default: per-device BN with one fused "
        "collective per step",
    )
    p.set_defaults(func=run_model_train)


def run_model_train(args):
    from remora_tpu_torch.core.util import prepare_out_dir
    from remora_tpu_torch.cli.util import rank_device, start_distributed
    from remora_tpu_torch.parallel.mesh import teardown

    device = rank_device(args)
    prepare_out_dir(args.output_path, args.overwrite)
    mesh = start_distributed(args, device, data_parallel=args.data_parallel)
    try:
        _train(args, device, mesh)
    finally:
        if mesh is not None:
            teardown()


def _train(args, device, mesh):
    from remora_tpu_torch.train.optim import TrainOpts
    from remora_tpu_torch.train.train import train_model
    from remora_tpu_torch import constants as _c

    train_opts = TrainOpts(
        epochs=args.epochs,
        early_stopping=args.early_stopping,
        optimizer_str=args.optimizer,
        learning_rate=args.lr,
        lr_scheduler_str=args.scheduler,
        lr_cool_down_epochs=args.lr_cool_down_epochs,
        lr_cool_down_lr=args.lr_cool_down_lr,
        opt_kwargs=tuple(
            tuple(kw) for kw in (args.opt_kwargs or _c.DEFAULT_OPT_VALUES)
        ),
        lr_scheduler_kwargs=tuple(
            tuple(kw)
            for kw in (args.lr_scheduler_kwargs or _c.DEFAULT_SCH_VALUES)
        ),
    )
    train_model(
        seed=args.seed,
        out_path=args.output_path,
        remora_dataset_path=args.remora_dataset_path,
        chunk_context=(
            None if args.chunk_context is None else tuple(args.chunk_context)
        ),
        kmer_context_bases=(
            None
            if args.kmer_context_bases is None
            else tuple(args.kmer_context_bases)
        ),
        batch_size=args.batch_size,
        model_name=args.model,
        size=args.size,
        train_opts=train_opts,
        chunks_per_epoch=args.chunks_per_epoch,
        num_test_chunks=args.num_test_chunks,
        save_freq=args.save_freq,
        filt_frac=args.filt_frac,
        ext_val=args.ext_val,
        ext_val_names=args.ext_val_names,
        high_conf_incorrect_thr_frac=(
            None
            if args.high_conf_incorrect_thr_frac is None
            else tuple(args.high_conf_incorrect_thr_frac)
        ),
        finetune_path=args.finetune_path,
        freeze_num_layers=args.freeze_num_layers,
        super_batch_size=args.super_batch_size,
        super_batch_sample_frac=args.super_batch_sample_frac,
        gradient_clip_num_mads=args.gradient_clip_num_mads,
        resume_from_checkpoint=args.resume_from_checkpoint,
        bf16_compute=args.bf16,
        mesh=mesh,
        sync_bn=args.sync_bn,
        read_batches_from_disk=args.read_batches_from_disk,
        steps_per_launch=args.steps_per_launch,
        device=device,
    )


def register_model_inspect(ssub):
    p = ssub.add_parser("inspect", help="show model metadata")
    p.add_argument("checkpoint_path")
    p.add_argument(
        "--model-path",
        help="model architecture .py override (default: from checkpoint)",
    )
    p.set_defaults(func=run_model_inspect)


def run_model_inspect(args):
    from remora_tpu_torch.models import model_io

    model, meta = model_io.load_model(
        args.checkpoint_path, model_path=args.model_path
    )
    from remora_tpu_torch.models.layers import param_count

    print(model_io.repr_model_metadata(meta))
    print(f"  {'num_params': >20} : {param_count(model):,}")


def register_model_export(ssub):
    p = ssub.add_parser(
        "export", help="export a model (dorado or torchscript format)"
    )
    p.add_argument("checkpoint_path")
    p.add_argument("output_path")
    p.add_argument(
        "--format", default="dorado", choices=("dorado", "torchscript")
    )
    p.add_argument(
        "--model-path",
        help="model architecture .py override (default: from checkpoint)",
    )
    p.set_defaults(func=run_model_export)


def run_model_export(args):
    from remora_tpu_torch.models import export as export_mod

    if args.format == "dorado":
        export_mod.export_model_dorado(
            args.checkpoint_path, args.output_path,
            model_path=args.model_path,
        )
    else:
        export_mod.export_model_torchscript(
            args.checkpoint_path, args.output_path,
            model_path=args.model_path,
        )


def register_model_list_pretrained(ssub):
    p = ssub.add_parser("list_pretrained", help="list ONT pretrained models")
    p.add_argument("--pore")
    p.add_argument("--basecall-model-type")
    p.add_argument("--basecall-model-version")
    p.add_argument("--modified-bases", nargs="+")
    p.add_argument("--remora-model-type")
    p.add_argument("--remora-model-version", type=int)
    p.set_defaults(func=run_list_pretrained)


def run_list_pretrained(args):
    from remora_tpu_torch.models.pretrained import get_pretrained_models

    rows, header = get_pretrained_models(
        pore=args.pore,
        basecall_model_type=args.basecall_model_type,
        basecall_model_version=args.basecall_model_version,
        modified_bases=args.modified_bases,
        remora_model_type=args.remora_model_type,
        remora_model_version=args.remora_model_version,
    )
    widths = [
        max(len(str(r[i])) for r in rows + [header]) for i in range(len(header))
    ]
    for row in [header] + rows:
        print("  ".join(str(v).ljust(w) for v, w in zip(row, widths)))


def register_model_download(ssub):
    p = ssub.add_parser("download", help="download ONT pretrained models")
    p.add_argument("--pore")
    p.add_argument("--basecall-model-type")
    p.add_argument("--basecall-model-version")
    p.add_argument("--modified-bases", nargs="+")
    p.add_argument("--remora-model-type")
    p.add_argument("--remora-model-version", type=int)
    p.set_defaults(func=run_download)


def run_download(args):
    from remora_tpu_torch.models.pretrained import download_models

    download_models(
        pore=args.pore,
        basecall_model_type=args.basecall_model_type,
        basecall_model_version=args.basecall_model_version,
        modified_bases=args.modified_bases,
        remora_model_type=args.remora_model_type,
        remora_model_version=args.remora_model_version,
    )


# --------------------------------------------------------------------
# infer
# --------------------------------------------------------------------


def register_infer(subparsers):
    parser = subparsers.add_parser("infer", help="modified-base inference")
    parser.set_defaults(func=lambda args: parser.print_help())
    ssub = parser.add_subparsers(title="infer commands")
    register_infer_from_pod5_and_bam(ssub)
    register_infer_duplex(ssub)


def _add_infer_model_args(p):
    mdl = p.add_argument_group("Model Arguments")
    mdl.add_argument(
        "--model", action="append",
        help="model checkpoint (.npz native or TorchScript .pt); may "
        "repeat for multiple canonical bases",
    )
    mdl.add_argument("--pore")
    mdl.add_argument("--basecall-model-type")
    mdl.add_argument("--basecall-model-version")
    mdl.add_argument("--modified-bases", nargs="+")
    mdl.add_argument("--remora-model-type",
                     help="model motif (sequence context)")
    mdl.add_argument("--remora-model-version", type=int)
    mdl.add_argument("--device", help=DEVICE_HELP)
    mdl.add_argument(
        "--bf16", action="store_true",
        help="bfloat16 model compute (~1.8x device throughput; "
        "default f32 preserves reference-parity tag bytes)",
    )


def register_infer_from_pod5_and_bam(ssub):
    p = ssub.add_parser("from_pod5_and_bam", help="simplex inference")
    p.add_argument("pod5")
    p.add_argument("in_bam")
    _add_infer_model_args(p)
    out = p.add_argument_group("Output Arguments")
    out.add_argument("--out-bam", required=True)
    out.add_argument("--log-filename")
    data = p.add_argument_group("Data Arguments")
    data.add_argument("--num-reads", type=int)
    data.add_argument("--reference-anchored", action="store_true")
    data.add_argument("--include-non-primary", action="store_true")
    comp = p.add_argument_group("Compute Arguments")
    comp.add_argument("--queue-max", type=int, default=1_000)
    comp.add_argument("--num-extract-alignment-workers", type=int, default=1)
    comp.add_argument("--num-prepare-read-workers", type=int, default=1)
    comp.add_argument("--num-prepare-nn-input-workers", type=int, default=1)
    comp.add_argument("--num-post-process-workers", type=int, default=1)
    comp.add_argument(
        "--batch-size", type=int, default=constants.DEFAULT_BATCH_SIZE
    )
    comp.add_argument(
        "--refine-backend", default=None,
        choices=constants.REFINE_BACKENDS,
        help="Override the banded-DP backend of the models' embedded "
        "refiners: auto/native/numpy run on host workers; device "
        "batches reads' DPs into shared K4/K5 launches on the models' "
        "GPU",
    )
    dist = p.add_argument_group("Distributed Arguments")
    dist.add_argument(
        "--coordinator-address",
        help="host:port where the processes meet (multi-process "
        "inference: each rank streams a disjoint read stripe and rank 0 "
        "merges the ranks' BAM parts; --out-bam must be on storage every "
        "rank sees, else the parts are left in place for a manual merge)",
    )
    dist.add_argument("--num-processes", type=int)
    dist.add_argument("--process-id", type=int)
    p.set_defaults(func=run_infer_from_pod5_and_bam)


def load_models_kw_args(args):
    """Load one or more model checkpoints -> [ModelHandle], on the
    device ``--device`` names (the GPU without it)."""
    import torch

    from remora_tpu_torch.cli.util import parse_device
    from remora_tpu_torch.infer.infer import ModelHandle

    device = parse_device(getattr(args, "device", None))

    model_paths = args.model
    if not model_paths:
        from remora_tpu_torch.models.pretrained import resolve_pretrained_model

        model_paths = [
            resolve_pretrained_model(
                pore=args.pore,
                basecall_model_type=args.basecall_model_type,
                basecall_model_version=args.basecall_model_version,
                modified_bases=args.modified_bases,
                remora_model_type=getattr(args, "remora_model_type", None),
                remora_model_version=getattr(
                    args, "remora_model_version", None
                ),
            )
        ]
    compute_dtype = None
    if getattr(args, "bf16", False):
        from remora_tpu_torch import log

        if device.type == "cpu":
            # as the JAX CLI on its CPU backend: f32 on the CPU, so the
            # CPU's tags stay comparable with the JAX package's
            log.get_logger().warning(
                "--bf16 ignored on the CPU backend (emulated bfloat16 "
                "is slower than float32 there)"
            )
        else:
            compute_dtype = torch.bfloat16
    models = [
        ModelHandle.load(path, device=device, compute_dtype=compute_dtype)
        for path in model_paths
    ]
    check_models(models)
    return models


def check_models(models):
    """Multi-model compatibility: one per canonical base, same signal prep."""
    from remora_tpu_torch import RemoraError

    metas = [
        m.metadata if hasattr(m, "metadata") else m[1] for m in models
    ]
    can_bases = [md["can_base"] for md in metas]
    if len(set(can_bases)) != len(can_bases):
        raise RemoraError(
            "Multiple models specified for the same canonical base"
        )
    for attr in ("reverse_signal", "pa_scaling"):
        if len(set(str(md[attr]) for md in metas)) != 1:
            raise RemoraError(f"All models must have the same {attr}")


def run_infer_from_pod5_and_bam(args):
    from remora_tpu_torch import log
    from remora_tpu_torch.cli.util import rank_device, start_distributed
    from remora_tpu_torch.parallel.mesh import teardown

    if args.log_filename:
        log.init_logger(args.log_filename)
    mesh = None
    if args.num_processes:
        device = rank_device(args)
        args.device = str(device)  # the models load onto this rank's device
        mesh = start_distributed(args, device)
    try:
        _infer_from_pod5_and_bam(args, mesh)
    finally:
        if mesh is not None:
            teardown()


def _infer_from_pod5_and_bam(args, mesh):
    from remora_tpu_torch.infer.infer import infer_from_pod5_and_bam

    models = load_models_kw_args(args)
    infer_from_pod5_and_bam(
        pod5_path=args.pod5,
        in_bam_path=args.in_bam,
        models=models,
        out_bam_path=args.out_bam,
        num_reads=args.num_reads,
        queue_max=args.queue_max,
        num_extract_alignment_workers=args.num_extract_alignment_workers,
        num_prep_read_workers=args.num_prepare_read_workers,
        num_prep_nn_input_workers=args.num_prepare_nn_input_workers,
        num_post_process_workers=args.num_post_process_workers,
        batch_size=args.batch_size,
        skip_non_primary=not args.include_non_primary,
        ref_anchored=args.reference_anchored,
        refine_backend=args.refine_backend,
        mesh=mesh,
    )


def register_infer_duplex(ssub):
    p = ssub.add_parser(
        "duplex_from_pod5_and_bam", help="duplex inference"
    )
    p.add_argument("pod5")
    p.add_argument("simplex_bam")
    p.add_argument("duplex_bam")
    p.add_argument("pairs")
    _add_infer_model_args(p)
    out = p.add_argument_group("Output Arguments")
    out.add_argument("--out-bam", required=True)
    out.add_argument("--log-filename")
    data = p.add_argument_group("Data Arguments")
    data.add_argument("--num-reads", type=int)
    data.add_argument("--duplex-delim", default=";")
    comp = p.add_argument_group("Compute Arguments")
    comp.add_argument("--num-extract-alignment-workers", type=int, default=1)
    comp.add_argument("--num-duplex-prep-workers", type=int, default=1)
    comp.add_argument("--num-infer-workers", type=int, default=1)
    p.set_defaults(func=run_infer_duplex)


def run_infer_duplex(args):
    from remora_tpu_torch import log
    from remora_tpu_torch.infer.duplex_infer import infer_duplex

    if args.log_filename:
        log.init_logger(args.log_filename)
    models = load_models_kw_args(args)
    infer_duplex(
        simplex_pod5_path=args.pod5,
        simplex_bam_path=args.simplex_bam,
        duplex_bam_path=args.duplex_bam,
        pairs_path=args.pairs,
        models=models,
        out_bam=args.out_bam,
        num_reads=args.num_reads,
        duplex_deliminator=args.duplex_delim,
        num_extract_alignment_threads=args.num_extract_alignment_workers,
        num_duplex_prep_workers=args.num_duplex_prep_workers,
        num_infer_threads=args.num_infer_workers,
    )


# --------------------------------------------------------------------
# validate
# --------------------------------------------------------------------


def register_validate(subparsers):
    parser = subparsers.add_parser("validate", help="validate models/calls")
    parser.set_defaults(func=lambda args: parser.print_help())
    ssub = parser.add_subparsers(title="validate commands")
    register_validate_from_dataset(ssub)
    register_validate_from_modbams(ssub)


def register_validate_from_dataset(ssub):
    p = ssub.add_parser(
        "from_remora_dataset", help="validate a model on a dataset"
    )
    p.add_argument("remora_dataset_path")
    p.add_argument(
        "--model",
        help="model checkpoint; or select a pretrained model via the "
        "--pore/--basecall-model-*/--modified-bases flags",
    )
    p.add_argument("--pore")
    p.add_argument("--basecall-model-type")
    p.add_argument("--basecall-model-version")
    p.add_argument("--modified-bases", nargs="+")
    p.add_argument("--remora-model-type")
    p.add_argument("--remora-model-version", type=int)
    p.add_argument(
        "--batch-size", type=int, default=constants.DEFAULT_BATCH_SIZE
    )
    p.add_argument("--filt-frac", "--pct-filt", type=float, default=10.0,
                   help="percent of lowest-confidence calls to filter")
    p.add_argument("--out-file")
    p.add_argument("--full-results-filename")
    p.add_argument("--log-filename")
    p.add_argument("--device", help=DEVICE_HELP)
    p.add_argument(
        "--read-batches-from-disk", action="store_true",
        help="accepted for compatibility; single-pass validation always "
        "streams batches from disk",
    )
    p.set_defaults(func=run_validate_from_dataset)


def run_validate_from_dataset(args):
    from remora_tpu_torch import log
    from remora_tpu_torch.cli.util import parse_device
    from remora_tpu_torch.data.dataset import (
        ComposedDataset,
        CoreDataset,
        load_dataset,
    )
    from remora_tpu_torch.infer.infer import make_model_eval_fn
    from remora_tpu_torch.models import model_io
    from remora_tpu_torch.train.validate import ValidationLogger

    if args.log_filename:
        log.init_logger(args.log_filename)
    device = parse_device(args.device)
    model_file = args.model
    if model_file is None:
        from remora_tpu_torch.models.pretrained import (
            resolve_pretrained_model,
        )

        model_file = resolve_pretrained_model(
            pore=args.pore,
            basecall_model_type=args.basecall_model_type,
            basecall_model_version=args.basecall_model_version,
            modified_bases=args.modified_bases,
            remora_model_type=args.remora_model_type,
            remora_model_version=args.remora_model_version,
        )
    model, meta = model_io.load_model(model_file)
    override_metadata = {
        "extra_arrays": {},
        "chunk_context": list(meta["chunk_context"]),
        "kmer_context_bases": list(meta["kmer_context_bases"]),
    }
    paths, props, hashes = load_dataset(args.remora_dataset_path)
    dataset = ComposedDataset(
        [
            CoreDataset(
                p,
                override_metadata=override_metadata.copy(),
                infinite_iter=False,
                do_check_super_batches=True,
            )
            for p in paths
        ],
        props,
        hashes,
        batch_size=args.batch_size,
    )
    out_fp = open(args.out_file, "w") if args.out_file else sys.stdout
    full_fh = (
        open(args.full_results_filename, "w")
        if args.full_results_filename
        else None
    )
    logger_obj = ValidationLogger(out_fp, full_fh)
    # one device, one call a batch (the JAX package pads each batch to its
    # compiled shape and may shard it over local devices; rows are
    # independent in the eval forward, so the logits are the same)
    fwd = make_model_eval_fn(model.to(device))

    def eval_fn(sigs, enc_kmers):
        return fwd(sigs, enc_kmers).cpu().numpy()

    ms = logger_obj.validate_model(
        eval_fn, meta["mod_bases"], dataset, args.filt_frac / 100
    )
    if full_fh is not None:
        full_fh.close()
    if out_fp is not sys.stdout:
        out_fp.close()
        print(
            f"acc={ms.acc:.6f} filt_acc={ms.filt_acc:.6f} "
            f"n={ms.num_calls}"
        )


def register_validate_from_modbams(ssub):
    p = ssub.add_parser(
        "from_modbams", help="validate modBAM calls against ground truth"
    )
    p.add_argument(
        "--bam-and-bed", nargs=2, action="append", required=True,
        metavar=("BAM", "GT_BED"),
    )
    p.add_argument("--full-results-filename")
    p.add_argument("--name", default="sample")
    p.add_argument("--pct-filt", type=float, default=10.0)
    p.add_argument("--allow-unbalanced", action="store_true")
    p.add_argument("--seed", type=int)
    p.add_argument("--extra-bases")
    p.add_argument("--out-file")
    p.add_argument("--max-sites-per-read", type=int)
    p.add_argument(
        "--explicit-mod-tag-used", action="store_true",
        help="acknowledge the MM tags use the explicit (?) specifier "
        "(implicit-style (.) tags yield invalid probabilities)",
    )
    p.add_argument("--log-filename")
    p.set_defaults(func=run_validate_from_modbams)


def run_validate_from_modbams(args):
    from remora_tpu_torch import log
    from remora_tpu_torch.validate_modbam import validate_modbams

    if args.log_filename:
        log.init_logger(args.log_filename)
    validate_modbams(
        bams_and_beds=args.bam_and_bed,
        full_results_path=args.full_results_filename,
        name=args.name,
        pct_filt=args.pct_filt,
        allow_unbalanced=args.allow_unbalanced,
        seed=args.seed,
        max_sites_per_read=args.max_sites_per_read,
        extra_bases=args.extra_bases,
        out_file=args.out_file,
        explicit_mod_tag_used=args.explicit_mod_tag_used,
    )


# --------------------------------------------------------------------
# analyze
# --------------------------------------------------------------------


def register_analyze(subparsers):
    parser = subparsers.add_parser("analyze", help="analysis utilities")
    parser.set_defaults(func=lambda args: parser.print_help())
    ssub = parser.add_subparsers(title="analyze commands")
    register_estimate_kmer_levels(ssub)
    register_plot_ref_region(ssub)
    register_analyze_plot(ssub)


def register_estimate_kmer_levels(ssub):
    p = ssub.add_parser(
        "estimate_kmer_levels", help="estimate k-mer level table from data"
    )
    p.add_argument("--pod5-and-bam", nargs=2, action="append", required=True)
    p.add_argument("--out-path", required=True)
    p.add_argument("--kmer-context-bases", nargs=2, type=int, default=(2, 2))
    p.add_argument("--min-coverage", type=int, default=10)
    p.add_argument("--chunk-len", type=int, default=1_000)
    p.add_argument("--max-chunk-coverage", type=int, default=100)
    p.add_argument("--num-workers", type=int, default=1)
    p.set_defaults(func=run_estimate_kmer_levels)


def run_estimate_kmer_levels(args):
    from remora_tpu_torch.analyze.kmer_levels import estimate_kmer_levels

    estimate_kmer_levels(
        pod5_and_bams=args.pod5_and_bam,
        out_path=args.out_path,
        kmer_context_bases=tuple(args.kmer_context_bases),
        min_coverage=args.min_coverage,
        chunk_len=args.chunk_len,
        max_chunk_coverage=args.max_chunk_coverage,
        num_workers=args.num_workers,
    )



def register_analyze_plot(ssub):
    """Reference-form nested group: ``analyze plot ref_region``
    (multi-page PDF over a BED of regions)."""
    grp = ssub.add_parser("plot", help="plotting commands")
    grp.set_defaults(func=lambda args: grp.print_help())
    sub = grp.add_subparsers(title="plot commands")
    p = sub.add_parser(
        "ref_region", help="plot raw signal at reference regions (PDF)"
    )
    p.add_argument(
        "--pod5-and-bam", nargs=2, action="append", required=True,
        metavar=("POD5", "BAM"),
    )
    p.add_argument(
        "--ref-regions", required=True,
        help="BED of regions; one page per record",
    )
    p.add_argument("--highlight-ranges", help="BED of regions to highlight")
    p.add_argument("--highlight-color", default="orange")
    p.add_argument("--max-reads", type=int, default=50)
    refine = p.add_argument_group("Signal Mapping Refine Arguments")
    refine.add_argument("--refine-kmer-level-table")
    refine.add_argument("--refine-rough-rescale", action="store_true")
    refine.add_argument("--refine-scale-iters", type=int, default=0)
    refine.add_argument(
        "--refine-half-bandwidth", type=int,
        default=constants.DEFAULT_REFINE_HBW,
    )
    refine.add_argument(
        "--refine-algo", default=constants.DEFAULT_REFINE_ALGO,
        choices=constants.REFINE_ALGOS,
    )
    refine.add_argument(
        "--refine-short-dwell-parameters", nargs=3, type=float,
        default=constants.DEFAULT_REFINE_SHORT_DWELL_PARAMS,
        metavar=("TARGET", "LIMIT", "WEIGHT"),
    )
    refine.add_argument(
        "--refine-rough-rescale-method", "--rough-rescale-method",
        default=constants.DEFAULT_ROUGH_RESCALE_METHOD,
        choices=constants.ROUGH_RESCALE_METHODS,
    )
    refine.add_argument(
        "--refine-backend", default=constants.REFINE_BACKEND_AUTO,
        choices=constants.REFINE_BACKENDS,
        help="Banded-DP execution backend: auto (native C++ core when "
        "built, else NumPy), native, numpy, or device (batched K4/K5 "
        "CUDA kernel launches on the GPU). Routing only; results are "
        "identical across backends",
    )
    out = p.add_argument_group("Output Arguments")
    out.add_argument(
        "--plots-filename", default="remora_raw_signal_plot.pdf"
    )
    out.add_argument("--log-filename")
    p.set_defaults(func=run_analyze_plot_ref_regions)


def run_analyze_plot_ref_regions(args):
    from remora_tpu_torch import log
    from remora_tpu_torch.analyze.plot import plot_ref_regions_bed

    if args.log_filename:
        log.init_logger(args.log_filename)
    refiner = None
    if args.refine_kmer_level_table is not None or args.refine_rough_rescale:
        refiner = _build_refiner(args)
    plot_ref_regions_bed(
        pod5_and_bams=args.pod5_and_bam,
        ref_regions_bed=args.ref_regions,
        plots_filename=args.plots_filename,
        sig_map_refiner=refiner,
        max_reads=args.max_reads,
        highlight_ranges=args.highlight_ranges,
        highlight_color=args.highlight_color,
    )


def register_plot_ref_region(ssub):
    p = ssub.add_parser("plot_ref_region", help="plot signal at a ref region")
    p.add_argument("--pod5-and-bam", nargs=2, action="append", required=True)
    p.add_argument("--ref-reg", required=True, help="e.g. chr1:100-200:+")
    p.add_argument("--out-path", required=True, help="output SVG path")
    p.add_argument("--highlight-positions")
    p.set_defaults(func=run_plot_ref_region)


def run_plot_ref_region(args):
    from remora_tpu_torch.analyze.plot import plot_signal_at_ref_region

    plot_signal_at_ref_region(
        pod5_and_bams=args.pod5_and_bam,
        ref_reg_str=args.ref_reg,
        out_path=args.out_path,
        highlight_positions=args.highlight_positions,
    )
