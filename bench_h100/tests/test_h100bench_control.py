"""On the card: each cell's control (the plain reference in the program's
place, one precision below the configuration's: bfloat16 where it states
float32 with TF32 convs) is not correct at the cell's own sizes, on three
seeds.  Run on the chip:

    python -m pytest -m cuda bench_h100/tests/test_h100bench_control.py
"""

import argparse
import tempfile

import pytest

from bench_h100 import run as bench_run
from bench_h100.tools import control

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def control_gaps(workload, seed):
    with tempfile.TemporaryDirectory() as d:
        ctx = bench_run.make_context(argparse.Namespace(
            workload=workload, seed=seed, seconds=0, trace=0), tmpdir=d)
        fn = (control.serve_control
              if ctx.traffic["driver"] == "serve_http"
              else control.train_control)
        return fn(ctx), ctx.traffic["check"]["limits"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["mpii224_http_poisson",
                                      "mpii224_train_records"])
def test_control_is_not_correct(card, workload, seed):
    gaps, limits = control_gaps(workload, seed)
    # the decode stage's numbers have no control (the reference decodes
    # both sides); the control has to fail one of the others
    assert any(gaps[k] > v for k, v in limits.items() if k in gaps), (
        gaps, limits)
