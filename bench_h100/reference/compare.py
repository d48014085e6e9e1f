"""The numbers that decide ``correct``: each a gap between what the timed
path produced and what the plain reference works out, compared with a
limit set from the readings that ``PERF.md`` lists.
"""

from __future__ import annotations

import numpy as np
import torch


def served_gaps(answers: list[list[dict]], ref_logits: np.ndarray) -> dict:
    """Served top-k answers (``[{"class", "prob"}]`` a request) against the
    reference's float64 logits of the same images (rows in the same
    order):

    * ``top1_logit_gap``: the widest gap by which the reference's logit
      of a served first class lies below the reference's best logit;
    * ``logprob_gap``: the widest gap between a served probability's log
      and the reference's log-softmax of that class;
    * ``logprob_mean_gap``: the mean of those gaps over every served
      class of every answer;
    * ``logprob_rel_gap``: the widest gap over the standard deviation of
      the reference's logits of that image (the gap in units of the
      logits' own spread, which moves with the seed's weights);
    * ``logprob_rel_median_gap``: the median over answers of each
      answer's widest such relative gap.
    """
    top1, gaps, rel = 0.0, [], []
    for ans, ref in zip(answers, ref_logits):
        ref = np.asarray(ref, np.float64)
        lse = ref.max() + np.log(np.exp(ref - ref.max()).sum())
        top1 = max(top1, float(ref.max() - ref[ans[0]["class"]]))
        row = []
        for e in ans:
            p = float(e["prob"])
            got = np.log(p) if p > 0 else -np.inf
            row.append(float(abs(got - (ref[e["class"]] - lse))))
        gaps += row
        rel.append(max(row, default=0.0) / max(float(ref.std()), 1e-30))
    return {"top1_logit_gap": top1, "logprob_gap": max(gaps, default=0.0),
            "logprob_mean_gap": float(np.mean(gaps)) if gaps else 0.0,
            "logprob_rel_gap": max(rel, default=0.0),
            "logprob_rel_median_gap": (float(np.median(rel)) if rel
                                       else 0.0)}


def _log_softmax(logits) -> np.ndarray:
    z = np.asarray(logits, np.float64)
    return z - (z.max() + np.log(np.exp(z - z.max()).sum()))


def bf16_ratio(answers: list[list[dict]], ref_logits: np.ndarray,
               low_logits: np.ndarray) -> dict:
    """The served answers' mean log-probability gap against the
    reference's float32 log-softmax (``served_gaps``'s
    ``logprob_mean_gap``), over the same gap of the reference computed
    with bfloat16 convs and activations (``low_logits``) at the same
    classes of the same images:

    * ``logprob_bf16_ratio``: that share; the bfloat16 reference put in
      the program's place reads 1;
    * ``bf16_logprob_mean_gap``: the bfloat16 reference's mean gap.

    The weights drawn from a seed make a network more or less sensitive
    to rounding, which moves both gaps alike from seed to seed; their
    ratio is the precision's own."""
    got, low = [], []
    for ans, ref, lo in zip(answers, ref_logits, low_logits):
        ref_ls, low_ls = _log_softmax(ref), _log_softmax(lo)
        for e in ans:
            c, p = int(e["class"]), float(e["prob"])
            got.append(abs((np.log(p) if p > 0 else -np.inf) - ref_ls[c]))
            low.append(abs(low_ls[c] - ref_ls[c]))
    if not got:
        return {"logprob_bf16_ratio": float("inf"),
                "bf16_logprob_mean_gap": 0.0}
    yard = float(np.mean(low))
    return {"logprob_bf16_ratio": float(np.mean(got)) / max(yard, 1e-30),
            "bf16_logprob_mean_gap": yard}


def batch_gaps(program: list, reference: list) -> dict:
    """The decoded and augmented batches the program trained on against
    the reference's (``[(uint8 images, labels)]`` each):
    ``batch_pixel_gap``, the mean |difference| in levels over every
    pixel, and ``batch_label_mismatch``, the labels that differ."""
    diff, n, wrong = 0.0, 0, 0
    for (pi, pl), (ri, rl) in zip(program, reference):
        d = np.abs(np.asarray(pi, np.int16) - np.asarray(ri, np.int16))
        diff += float(d.sum())
        n += d.size
        wrong += int((np.asarray(pl) != np.asarray(rl)).sum())
    if len(program) != len(reference):
        wrong += abs(len(program) - len(reference))
    return {"batch_pixel_gap": diff / max(n, 1),
            "batch_label_mismatch": float(wrong)}


def leaf_gap(program: dict, reference: dict, keep=None,
             median: bool = False) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf; and that leaf (with ``median``, the median leaf's
    gap).  ``program`` and ``reference`` map a leaf to its norm (floats);
    ``keep`` limits the leaves compared."""
    names = [k for k in reference if keep is None or k in keep]
    ref = np.array([reference[k] for k in names], np.float64)
    med = float(np.median(ref))
    got = np.array([float(program[k]) for k in names], np.float64)
    g = np.abs(got - ref) / np.maximum(np.maximum(ref, med), 1e-30)
    g[~np.isfinite(got)] = np.inf
    if median:
        return float(np.median(g)), ""
    i = int(np.argmax(g))
    return float(g[i]), names[i]


def update_gap(program: dict, reference: dict) -> float:
    """The median over leaves of ``|program - reference| / |reference|``
    (L2 norms of whole leaves), for updates that no leaf leaves at nought
    (a batch norm's running-mean step); a leaf the program lacks reads
    infinite."""
    gaps = []
    for k, r in reference.items():
        p = program.get(k)
        if p is None:
            gaps.append(float("inf"))
            continue
        r64, p64 = r.double(), p.double()
        gaps.append(float(torch.linalg.vector_norm(p64 - r64)
                          / max(float(torch.linalg.vector_norm(r64)), 1e-30)))
    return float(np.median(gaps)) if gaps else float("inf")


def moved_leaves(first_grads: dict, rule: float = 1e-3) -> set:
    """The leaves whose reference gradient norm is at least ``rule`` of the
    median leaf's: the others (a gradient nought to rounding) move under
    the optimizer by round-off alone and are left out of the change."""
    med = float(np.median(list(first_grads.values())))
    return {k for k, v in first_grads.items() if v >= rule * med}


def norms(tensors: dict) -> dict:
    """Leaf -> float64 L2 norm."""
    return {k: float(torch.linalg.vector_norm(t.detach().double()))
            for k, t in tensors.items()}
