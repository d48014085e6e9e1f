"""The reader of the decode pool's width, ``decode_threads.train``: the
mean ``threads`` id of the traced ``jpeg.decode`` spans; nothing with no
trace, with spans that carry no such id (a port that decodes a call on
one thread), or with a port that keeps no spans.  A shrunk traced run of
the training cell on the CPU, at batch 4 and 2 intra-op threads, reads
2: OpenCV decodes through the same pool as nvJPEG."""

import pathlib

import pytest

from bench_h100 import common
from bench_h100.tests.test_h100bench_spans import traced_small_run

ROOT = pathlib.Path(common.__file__).resolve().parents[1]
WORKLOAD = "mpii224_train_records"
NAME = "decode_threads.train"


def test_a_traced_run_reads_the_pools_width():
    import torch
    from attentionalpoolingaction_torch.data import jpeg
    line = traced_small_run(WORKLOAD)
    assert line["correct"], line["checks"]
    listed = common.metrics_for(common.load_benchmark(ROOT), WORKLOAD,
                                "per_layer")
    (entry,) = [m for m in listed if m["name"] == NAME]
    assert entry["moves"] == "train_images_per_s"
    assert line["metrics"][NAME] == {"value": float(jpeg.pool_width(4)),
                                     "unit": "threads"}
    assert jpeg.pool_width(4) == min(4, torch.get_num_threads()) == 2


@pytest.mark.parametrize("ids, want", [
    ([{"images": 8, "threads": 8}] * 3, 8.0),
    ([{"images": 8, "threads": 8}, {"images": 8, "threads": 4},
      {"images": 1, "threads": 1}, {"images": 8, "threads": 3}], 4.0),
    ([{"images": 1, "threads": 1}], 1.0),
    ([{"images": 8}] * 2, None),
    ([], None)])
def test_the_reader_reads_the_mean_threads_id(ids, want, monkeypatch):
    """Spans given as their ids: the mean of ``threads`` a span; nothing
    where no span carries it (a port that decodes a call on one thread)
    or none was traced."""
    from attentionalpoolingaction_torch.utils import profiling
    tot = {}
    for s in ids:
        t = tot.setdefault("jpeg.decode", {"count": 0, "seconds": 0.0,
                                           "self_seconds": 0.0})
        t["count"] += 1
        for k, v in s.items():
            t[k] = t.get(k, 0) + v
    monkeypatch.setattr(profiling, "span_totals", lambda: tot)
    read = common.load_reader(ROOT, NAME)
    got = read({"trace": object()})
    assert got == pytest.approx(want) if want is not None else got is None
    assert read({}) is None
    monkeypatch.delattr(profiling, "span_totals")
    assert read({"trace": object()}) is None
