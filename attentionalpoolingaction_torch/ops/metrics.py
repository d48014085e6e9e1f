"""Evaluation metrics: mAP (MPII / HICO) and accuracy with per-video
temporal averaging (HMDB51).  An own copy of the JAX package's
``ops/metrics.py``, kept function for function: the port imports nothing
of the JAX package.

The reference computes mAP as the mean over classes of sklearn-style average
precision on accumulated (logits, labels), and HMDB accuracy after averaging
per-frame logits within each video.  These run on the host at eval time, so
they are NumPy.
"""

from __future__ import annotations

import numpy as np


def average_precision(labels, scores):
    """Average precision for one class, matching
    ``sklearn.metrics.average_precision_score`` (step-wise interpolation:
    AP = sum_k (R_k - R_{k-1}) * P_k over descending-score thresholds).

    labels: (N,) binary; scores: (N,) float.  Returns NaN if no positives.
    """
    labels = np.asarray(labels).astype(np.float64)
    scores = np.asarray(scores).astype(np.float64)
    n_pos = labels.sum()
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    labels = labels[order]
    scores = scores[order]
    tp = np.cumsum(labels)
    fp = np.cumsum(1.0 - labels)
    # collapse ties: only evaluate at distinct score thresholds
    distinct = np.where(np.diff(scores))[0]
    thresh = np.r_[distinct, labels.size - 1]
    tp, fp = tp[thresh], fp[thresh]
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / n_pos
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def mean_average_precision(labels, scores, ignore_empty=True):
    """mAP over classes.

    labels: (N, C) binary multi-hot (HICO) or one-hot (MPII);
    scores: (N, C).  Classes with no positives are skipped when
    ``ignore_empty`` (sklearn returns 0-division warnings there)."""
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    aps = np.array(
        [average_precision(labels[:, c], scores[:, c])
         for c in range(labels.shape[1])]
    )
    valid = ~np.isnan(aps)
    if ignore_empty:
        return float(np.mean(aps[valid])) if valid.any() else 0.0, aps
    return float(np.nanmean(aps)), aps


def mean_average_precision_known(anno, scores):
    """HICO "Known Object" (KO) mAP: per class, AP is computed only over
    images whose annotation for that class is *known* (anno != 0) — the
    {+1, -1, 0/NaN} raw annotation distinguishes positives, negatives, and
    unknown pairs, and the KO protocol drops the unknowns instead of
    treating them as negatives (the default protocol does the latter).

    anno: (N, C) int in {+1, -1, 0}; scores: (N, C).  Returns (mAP, aps)
    where a class with no known positives gets NaN and is skipped."""
    anno = np.asarray(anno)
    scores = np.asarray(scores)
    aps = np.full(anno.shape[1], np.nan)
    for c in range(anno.shape[1]):
        known = anno[:, c] != 0
        if not known.any():
            continue
        aps[c] = average_precision(
            (anno[known, c] > 0).astype(np.float64), scores[known, c])
    valid = ~np.isnan(aps)
    return (float(np.mean(aps[valid])) if valid.any() else 0.0), aps


def accuracy(labels, scores):
    """Top-1 accuracy.  labels: (N,) int class ids; scores: (N, C)."""
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    return float(np.mean(np.argmax(scores, axis=-1) == labels))


def video_average_logits(video_ids, logits, labels=None):
    """Group per-frame logits by video id and average (HMDB51 eval protocol,
    SURVEY.md section 3.2).

    video_ids: (N,) int/str ids; logits: (N, C); labels: optional (N,) — must
    be constant within a video.  Returns (unique_ids, avg_logits[, labels]).
    """
    video_ids = np.asarray(video_ids)
    logits = np.asarray(logits)
    uniq, inverse = np.unique(video_ids, return_inverse=True)
    sums = np.zeros((uniq.size, logits.shape[1]), logits.dtype)
    np.add.at(sums, inverse, logits)
    counts = np.bincount(inverse, minlength=uniq.size).astype(logits.dtype)
    avg = sums / counts[:, None]
    if labels is None:
        return uniq, avg
    vid_labels = np.zeros(uniq.size, dtype=np.asarray(labels).dtype)
    vid_labels[inverse] = np.asarray(labels)
    return uniq, avg, vid_labels
