"""Validation metrics + TSV logger.

Copy of ``remora_tpu/train/validate.py`` (pure NumPy; reference
``src/remora/validate.py:42–288``): accuracy, confusion
matrix, quantile-threshold filtered accuracy; unmodeled-label padding so
a model can be validated on datasets carrying extra mod classes. Column
layout of the TSV log matches the reference ``validation.log``.
"""

import json
from collections import namedtuple

import numpy as np

from remora_tpu_torch import RemoraError, constants, log
from remora_tpu_torch.core.tags import softmax

LOGGER = log.get_logger()

VAL_METRICS = namedtuple(
    "VAL_METRICS",
    "loss acc num_calls conf_mat "
    "filt_frac filt_acc filt_conf_mat filt_thresh",
)

# validation.log columns (reference-compatible TSV layout)
_LOG_COLUMNS = (
    "Val_Type Epoch Iteration Accuracy Confusion_Matrix Loss Num_Calls "
    "Filtered_Fraction Filtered_Accuracy Filtered_Confusion_Matrix "
    "Filtered_Threshold"
)


def mat_to_str(mat):
    return json.dumps(np.asarray(mat).tolist(), separators=(",", ":"))


def confusion_matrix(labels, preds, num_classes=None):
    if num_classes is None:
        num_classes = int(max(labels.max(), preds.max())) + 1
    mat = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(mat, (labels, preds), 1)
    # match sklearn: drop classes absent from both labels and preds
    present = np.union1d(np.unique(labels), np.unique(preds))
    return mat[np.ix_(present, present)]


def compute_metrics(probs, labels, filt_frac):
    """VAL_METRICS (loss left NaN) over calls, plus the same metrics
    restricted to the most confident (1 - filt_frac) of calls."""
    called = probs.argmax(axis=1)
    hit = called == labels
    acc = hit.sum() / labels.size
    base = VAL_METRICS(
        loss=np.nan,
        acc=acc,
        num_calls=labels.size,
        conf_mat=confusion_matrix(labels, called),
        filt_frac=1.0,
        filt_acc=np.nan,
        filt_conf_mat=np.array([]),
        filt_thresh=np.nan,
    )
    # confidence of each call = probability of its argmax class
    call_conf = probs[np.arange(labels.size), called]
    thresh = np.quantile(call_conf, filt_frac)
    if thresh == call_conf.max():
        # keep at least the top calls when the quantile hits the max
        thresh *= 0.999999
    confident = call_conf > thresh
    n_kept = int(np.count_nonzero(confident))
    if n_kept == 0:
        return base
    return base._replace(
        filt_frac=1 - n_kept / labels.size,
        filt_acc=hit[confident].sum() / n_kept,
        filt_conf_mat=confusion_matrix(labels[confident], called[confident]),
        filt_thresh=thresh,
    )


def add_unmodeled_labels(output, unmodeled_labels):
    """Insert -1000 logit columns for labels the model does not predict.

    The modeled columns scatter, in order, into the class indices not
    listed in ``unmodeled_labels`` (index 0 — canonical — is always
    modeled)."""
    if not unmodeled_labels.size:
        return output
    nobs, n_modeled = output.shape
    n_total = n_modeled + unmodeled_labels.size
    modeled_cols = np.setdiff1d(np.arange(n_total), unmodeled_labels)
    padded = np.full((nobs, n_total), -1000, dtype=output.dtype)
    padded[:, modeled_cols] = output
    return padded


def cross_entropy(logits, labels):
    shifted = logits - logits.max(axis=1, keepdims=True)
    log_probs = shifted - np.log(np.exp(shifted).sum(axis=1, keepdims=True))
    picked = np.take_along_axis(log_probs, labels[:, None], 1)
    return float(-picked.mean())


def _class_balance(probs, labels):
    """Trim every represented class to the size of the smallest one."""
    n_classes = max(labels.max() + 1, probs.shape[1])
    class_rows = [np.flatnonzero(labels == cls) for cls in range(n_classes)]
    sizes = [rows.size for rows in class_rows]
    if len(sizes) == 1:
        raise RemoraError(
            "Class balancing needs >= 2 labels; "
            "re-run with `--allow-unbalanced` to skip it"
        )
    LOGGER.debug(f"Balancing class sizes {sizes}")
    floor = min(size for size in sizes if size > 0)
    kept_probs, kept_labels = [], []
    for cls, rows in enumerate(class_rows):
        if rows.size == 0:
            # class absent from ground truth: leave it out entirely
            continue
        cls_probs = probs[rows]
        if rows.size > floor:
            np.random.shuffle(cls_probs)
        kept_probs.append(cls_probs[:floor])
        kept_labels.append(np.full(floor, cls, dtype=labels.dtype))
    return np.concatenate(kept_probs), np.concatenate(kept_labels)


def _metrics_tsv_row(ms, val_type, epoch, niter):
    loss_field = "NAN" if np.isnan(ms.loss) else f"{ms.loss:.6f}"
    cells = (
        str(val_type),
        str(epoch),
        str(niter),
        f"{ms.acc:.6f}",
        mat_to_str(ms.conf_mat),
        loss_field,
        str(ms.num_calls),
        f"{ms.filt_frac:.4f}",
        f"{ms.filt_acc:.6f}",
        mat_to_str(ms.filt_conf_mat),
        str(ms.filt_thresh),
    )
    return "\t".join(cells) + "\n"


def process_mods_probs(probs, labels, allow_unbalanced, pct_filt, name,
                       fp=None):
    """Balance classes (optionally) and report metrics for modBAM validation."""
    if not allow_unbalanced:
        probs, labels = _class_balance(probs, labels)
    ms = compute_metrics(probs, labels, pct_filt / 100)
    row = _metrics_tsv_row(ms, name, 0, 0)
    LOGGER.info(f"\n{ValidationLogger.HEADER}\n{row}")
    if fp is not None:
        fp.write(row)
    return ms


class ValidationLogger:
    HEADER = "\t".join(_LOG_COLUMNS.split())
    FULL_HEADER = "label\tclass_pred\tclass_probs"

    def __init__(self, fp, full_results_fh=None):
        self.fp = fp
        self.full_fh = full_results_fh
        fp.write(self.HEADER + "\n")
        if full_results_fh is not None:
            full_results_fh.write(self.FULL_HEADER + "\n")

    def write_full_results(self, output, labels):
        calls = output.argmax(axis=1)
        rows = zip(labels.tolist(), calls, softmax(output))
        for lab, pred, probs in rows:
            probs_field = ",".join(map(str, probs))
            self.full_fh.write(f"{lab}\t{pred}\t{probs_field}\n")

    def run_validation(self, eval_fn, model_mod_bases, dataset,
                       filt_frac=constants.DEFAULT_FILT_FRAC):
        """eval_fn(sigs, enc_kmers) -> logits (numpy)."""
        unmodeled = np.array(
            [
                cls + 1
                for cls, mod in enumerate(dataset.metadata.mod_bases)
                if mod not in model_mod_bases
            ]
        )
        label_batches, logit_batches, losses = [], [], []
        for batch in dataset:
            labels = np.asarray(batch["labels"])
            logits = np.asarray(eval_fn(batch["signal"], batch["enc_kmers"]))
            logits = add_unmodeled_labels(logits, unmodeled)
            label_batches.append(labels)
            logit_batches.append(logits)
            losses.append(cross_entropy(logits, labels))
            if self.full_fh is not None:
                self.write_full_results(logits, labels)
        all_labels = np.concatenate(label_batches)
        all_probs = softmax(np.concatenate(logit_batches, axis=0))
        ms = compute_metrics(all_probs, all_labels, filt_frac)
        return ms._replace(loss=float(np.mean(losses)))

    def validate_model(self, eval_fn, model_mod_bases, dataset,
                       filt_frac=constants.DEFAULT_FILT_FRAC,
                       val_type="val", *, nepoch=0, niter=0):
        ms = self.run_validation(eval_fn, model_mod_bases, dataset, filt_frac)
        self.fp.write(_metrics_tsv_row(ms, val_type, nepoch, niter))
        return ms
