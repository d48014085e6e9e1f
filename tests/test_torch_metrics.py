"""The port's ``ops/metrics.py`` against the JAX package's on the same
inputs: every function, with tied scores, classes without positives and,
for the Known-Object mAP, classes with nothing known.  Both are the same
NumPy arithmetic, so the results must be equal (NaN equal to NaN)."""

import numpy as np
import pytest

from attentionalpoolingaction_torch.ops import metrics as port
from attentionalpoolingaction_tpu.ops import metrics as ref


def scores_with_ties(rng, shape):
    # a coarse grid of scores, so that many are tied
    return np.round(rng.normal(size=shape), 1).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_average_precision(seed):
    rng = np.random.default_rng(seed)
    labels = (rng.uniform(size=30) > 0.6).astype(np.int32)
    scores = scores_with_ties(rng, 30)
    assert port.average_precision(labels, scores) == \
        ref.average_precision(labels, scores)
    assert np.isnan(port.average_precision(np.zeros(30), scores))


@pytest.mark.parametrize("ignore_empty", [True, False])
def test_mean_average_precision(ignore_empty):
    rng = np.random.default_rng(1)
    labels = (rng.uniform(size=(25, 9)) > 0.7).astype(np.float32)
    labels[:, [2, 5]] = 0                     # two classes without positives
    scores = scores_with_ties(rng, (25, 9))
    m, aps = port.mean_average_precision(labels, scores, ignore_empty)
    wm, waps = ref.mean_average_precision(labels, scores, ignore_empty)
    assert m == wm
    np.testing.assert_array_equal(aps, waps)
    assert np.isnan(aps[2]) and np.isnan(aps[5])
    empty = port.mean_average_precision(np.zeros((4, 3)), np.ones((4, 3)))
    assert empty[0] == ref.mean_average_precision(
        np.zeros((4, 3)), np.ones((4, 3)))[0] == 0.0


def test_mean_average_precision_known():
    rng = np.random.default_rng(2)
    anno = rng.choice([-1, 0, 1], size=(20, 7), p=[0.5, 0.3, 0.2])
    anno[:, 3] = 0                            # nothing known
    anno[:, 4] = -1                           # no known positive
    scores = scores_with_ties(rng, (20, 7))
    m, aps = port.mean_average_precision_known(anno, scores)
    wm, waps = ref.mean_average_precision_known(anno, scores)
    assert m == wm
    np.testing.assert_array_equal(aps, waps)
    assert np.isnan(aps[3]) and np.isnan(aps[4])


def test_accuracy():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 6, 40)
    scores = scores_with_ties(rng, (40, 6))
    assert port.accuracy(labels, scores) == ref.accuracy(labels, scores)


@pytest.mark.parametrize("with_labels", [True, False])
def test_video_average_logits(with_labels):
    rng = np.random.default_rng(4)
    vids = rng.integers(0, 5, 23)
    logits = rng.normal(size=(23, 4)).astype(np.float32)
    video_label = rng.integers(0, 4, 5)
    labels = video_label[vids] if with_labels else None
    got = port.video_average_logits(vids, logits, labels)
    want = ref.video_average_logits(vids, logits, labels)
    assert len(got) == len(want) == (3 if with_labels else 2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
