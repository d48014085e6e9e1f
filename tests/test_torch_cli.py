"""The port's train and eval CLIs, ``train.train`` fed from records and
the profiling helpers, on the CPU.

resnet_v1_50 at 64 px from 80 px synthetic MPII records, batch 2:

  * ``train_cli`` trains 2 steps with an eval and the keep-best slot, then
    resumes to 3 from the checkpoint and the saved stream position, with
    its scalars in event files;
  * ``eval_cli`` prints its JSON line with the JAX CLI's keys, and both
    CLIs run as ``python -m attentionalpoolingaction_torch.<cli>``;
  * ``data_echo=2`` stopped mid-echo and resumed equals the uninterrupted
    run bitwise, and a resume with the echo toggled off goes on from the
    inner position (the JAX package's ``test_grain_train.py`` cases).

Checkpoints go to temporary directories removed at the end of each test.
"""

import dataclasses
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
from unittest import mock

import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import eval_cli
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch import train_cli
from attentionalpoolingaction_torch.data import png, records
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_torch.tf_checkpoint import _fields
from attentionalpoolingaction_torch.utils import profiling
from torch_spawn import free_port

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--set", "backbone='resnet_v1_50'", "--set", "image_size=64",
         "--set", "batch_size=2", "--set", "resize_min=72",
         "--set", "resize_max=90", "--set", "log_every=1",
         "--set", "eval_batch_size=4", "--device", "cpu"]
JAX_EVAL_KEYS = {"num_examples", "mAP", "num_eval_classes", "accuracy",
                 "step"}


@pytest.fixture
def data():
    with tempfile.TemporaryDirectory() as d:
        spec = get_dataset("mpii")
        records.write_synthetic_dataset(f"{d}/train.tfrecord", spec, 12,
                                        image_size=80, seed=0)
        records.write_synthetic_dataset(f"{d}/val.tfrecord", spec, 5,
                                        image_size=80, seed=1)
        yield d


def summary_values(workdir):
    """(step, {field: value}) of every summary value of the event files
    in ``workdir``, read with the port's record reader and protobuf field
    decoder (TensorBoard's reader is held against the writer in
    test_torch_records.py; it imports TensorFlow, seconds of this file's
    budget)."""
    for name in sorted(os.listdir(workdir)):
        if "tfevents" not in name:
            continue
        for raw in records.read_tfrecord(os.path.join(workdir, name)):
            fields = list(_fields(raw))
            step = next((v for n, _, v in fields if n == 2), 0)
            for value in (v for n, _, s in fields if n == 5
                          for m, _, v in _fields(s) if m == 1):
                yield step, dict((k, v) for k, _, v in _fields(value))


def scalars(workdir):
    """tag -> [(step, value)] of the scalar summaries in ``workdir``."""
    out = {}
    for step, f in summary_values(workdir):
        if 2 in f:
            out.setdefault(bytes(f[1]).decode(), []).append(
                (step, struct.unpack("<f", f[2])[0]))
    return out


def images(workdir):
    """tag -> [(step, decoded RGB image)] of the image summaries in
    ``workdir`` (``Summary.Image``: height 1, width 2, colorspace 3,
    encoded_image_string 4)."""
    out = {}
    for step, f in summary_values(workdir):
        if 4 in f:
            img = dict((k, v) for k, _, v in _fields(f[4]))
            decoded = png.decode(bytes(img[4]))
            assert decoded.shape == (img[1], img[2], 3) and img[3] == 3
            out.setdefault(bytes(f[1]).decode(), []).append((step, decoded))
    return out


def test_train_cli_trains_resumes_and_writes_events(data):
    args = ["--config", "mpii_rank1_224", "--train_pattern",
            f"{data}/train.tfrecord", "--eval_pattern", f"{data}/val.tfrecord",
            "--workdir", f"{data}/run", *SMALL]
    state = train_cli.main(args + ["--num_steps", "2", "--eval_every", "2"])
    assert state.step == 2
    mgr = ckpt_lib.make_manager(f"{data}/run/checkpoints")
    assert mgr.all_steps() == [2]
    assert json.loads((mgr.directory / "grain_iter_2_p0.json").read_text()
                      ) == {"epoch": 0, "position": 4}
    assert ckpt_lib.BestKeeper(f"{data}/run").best()["step"] == 2
    state = train_cli.main(args + ["--num_steps", "3"])
    assert state.step == 3 and mgr.all_steps() == [2, 3]
    assert json.loads((mgr.directory / "grain_iter_3_p0.json").read_text()
                      ) == {"epoch": 0, "position": 6}
    got = scalars(f"{data}/run")
    assert [s for s, _ in got["loss/total"]] == [1, 2, 3]
    assert all(np.isfinite(v) for _, v in got["loss/total"] + got["grad_norm"])
    assert [s for s, _ in got["eval/mAP"]] == [2]
    assert got["eval/num_examples"] == [(2, 5.0)]
    # --multiprocess joins a job of one process over gloo from torchrun's
    # environment and trains as alone (the 2-process job is
    # tests/test_torch_parallel.py); attention overlays of the eval
    # split's first 4 images at step 4
    with mock.patch.dict(os.environ, {
            "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}):
        try:
            state = train_cli.main(args + ["--num_steps", "4",
                                           "--attn_summary_every", "2",
                                           "--multiprocess"])
            assert torch.distributed.get_backend() == "gloo"
            assert torch.distributed.get_world_size() == 1
        finally:
            torch.distributed.destroy_process_group()
    assert state.step == 4 and state.model.training
    got = images(f"{data}/run")
    for kind in ("top_down", "saliency"):
        for i in range(4):
            (step, img), = got[f"attention/{kind}/image/{i}"]
            assert step == 4 and img.shape == (64, 64, 3)
    assert len(got) == 8


def test_eval_cli_prints_its_json_line(data, capsys):
    cfg = config_lib.get_config(
        "mpii_rank1_224", backbone="resnet_v1_50", image_size=64,
        batch_size=2, resize_min=72, resize_max=90, log_every=1,
        train_pattern=f"{data}/train.tfrecord", checkpoint_every=1)
    mgr = ckpt_lib.make_manager(f"{data}/run/checkpoints")
    train.train(cfg, num_steps=1, device="cpu", checkpoint_manager=mgr)
    out_json = f"{data}/out.jsonl"
    printed = eval_cli.main([
        "--config", "mpii_rank1_224", "--workdir", f"{data}/run",
        "--eval_pattern", f"{data}/val.tfrecord", "--out_json", out_json,
        "--per_class_output", f"{data}/pc.jsonl", *SMALL])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == [line] and set(line) == JAX_EVAL_KEYS
    assert line["step"] == 1 and line["num_examples"] == 5
    assert json.loads(open(out_json).read()) == line
    pc = json.loads(open(f"{data}/pc.jsonl").read())
    assert pc["step"] == 1 and len(pc["per_class_ap"]) == 393
    assert scalars(f"{data}/run")["eval/mAP"] == [
        (1, pytest.approx(line["mAP"]))]
    with pytest.raises(SystemExit, match="no checkpoint"):
        eval_cli.main(["--workdir", f"{data}/empty", "--notb",
                       "--eval_pattern", f"{data}/val.tfrecord", *SMALL])


@pytest.mark.parametrize("cli", ["train_cli", "eval_cli"])
def test_clis_run_as_modules(cli):
    proc = subprocess.run(
        [sys.executable, "-m", f"attentionalpoolingaction_torch.{cli}",
         "--help"], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "--device" in proc.stdout and "--workdir" in proc.stdout


def echo_cfg(data, **kw):
    base = dict(dataset="mpii", backbone="resnet_v1_50", pooling="attention",
                image_size=64, batch_size=2, bf16_backbone=False,
                learning_rate=1e-3, grad_clip_norm=10.0,
                lr_schedule="constant", train_pattern=f"{data}/train.tfrecord",
                resize_min=72, resize_max=90, log_every=1, checkpoint_every=3,
                data_echo=2)
    base.update(kw)
    return config_lib.TrainConfig(**base)


def test_data_echo_mid_echo_resume_matches_uninterrupted(data):
    cfg = echo_cfg(data)
    straight, hist_a = train.train(cfg, num_steps=6, device="cpu")
    mgr = ckpt_lib.make_manager(f"{data}/b")
    _, hist_b1 = train.train(cfg, num_steps=3, device="cpu",
                             checkpoint_manager=mgr)
    saved = json.loads((mgr.directory / "grain_iter_3_p0.json").read_text())
    assert saved == {"inner_before": {"epoch": 0, "position": 2},
                     "phase": 1}
    shutil.copytree(f"{data}/b", f"{data}/c")
    resumed, hist_b2 = train.train(cfg, num_steps=6, device="cpu",
                                   checkpoint_manager=mgr)
    assert resumed.step == straight.step == 6
    assert hist_a == hist_b1 + hist_b2
    want = straight.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want[k]), k

    # the echo toggled off at a mid-echo checkpoint: the inner position
    # resumes and the in-flight batch's last echo is dropped
    plain = dataclasses.replace(cfg, data_echo=1, checkpoint_every=100)
    mgr_c = ckpt_lib.make_manager(f"{data}/c")
    state, hist = train.train(plain, num_steps=5, device="cpu",
                              checkpoint_manager=mgr_c)
    assert state.step == 5 and np.isfinite(hist[-1]["loss/total"])
    assert json.loads((mgr_c.directory / "grain_iter_5_p0.json").read_text()
                      ) == {"epoch": 0, "position": 6}


def test_profiling_helpers(tmp_path):
    hook = profiling.make_trace_hook(str(tmp_path / "trace"), start_step=2,
                                     num_steps=5, last_step=3)
    for step in range(1, 5):
        torch.ones(64).sum()
        hook(step, None, {})
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert "traceEvents" in json.loads(
        (tmp_path / "trace" / traces[0]).read_text())
    with profiling.trace(str(tmp_path / "t2")):
        torch.ones(8).sum()
    assert len(os.listdir(tmp_path / "t2")) == 1
    assert profiling.timed(lambda: torch.ones(8).sum(), iters=3) > 0
    timer = profiling.StepTimer(batch_size=4)
    timer.tick()
    timer.tick()
    assert timer.images_per_sec > 0
    with pytest.raises(NotImplementedError):
        profiling.start_server()
