"""The port's multi-process runtime (``parallel/multihost.py``), its
sharded input, sharded eval and collective checkpoints, in a real job of
two processes over gloo on the CPU: the port of the JAX package's
``tests/test_multiprocess.py``, with the resume across topologies of
``tests/test_sharding.py`` and the ZeRO-1 resume of ``tests/test_zero1.py``.

One spawn of two workers (``torch_spawn.py``) checks, inside the workers:

* ``FlagAllReduce`` (one flag raised on one rank is seen on both, at the
  same step), ``allreduce_flag``, ``broadcast_step`` (rank 0's step
  wins, ``None`` too), ``assert_same_across_hosts``, the mesh's size
  error, and the padded gather of uneven host arrays;
* disjoint per-rank train streams over 8 records labelled 0..7 (rank r
  sees ``r::2``), and per-process iterator files ``grain_iter_<step>_p<r>``;
* ``train_cli --multiprocess`` over the records on a ``(2,)`` mesh with
  ZeRO-1: one event file (process 0 writes), both iterator files, and
  ``eval_cli --multiprocess`` printing its line on process 0 only;
* a sharded eval of the 8 records and of 5 (3/2 uneven shards), whose
  metrics the test holds against one process's within 1e-12;
* a checkpoint written by 2 ranks under ZeRO-1 resumes on 1 process, one
  written by 1 process resumes on 2 ranks under ZeRO-1 and on a ``(1, 2)``
  data x model mesh (the HICO head's classes sharded), and the 2-rank
  ZeRO-1 run resumes from its own: each reaches step 4 within 1e-4 of the
  continuous one-process run (the JAX test's bound).

Without a job: the class-sharded head's backward pass over X (given the
whole ``dv`` and ``dssum``) against the fused backward on the CPU, and its
kernel against the plain ops on a card (marked ``cuda``; this file imports
no JAX, so it runs on the card's machine with ``--noconftest``).
"""

import json
import re
import shutil

import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import evaluate as eval_lib
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch.data import records
from attentionalpoolingaction_torch.data.datasets import get_dataset
from torch_spawn import finish, start_workers

torch.set_num_threads(2)

EVAL = dict(dataset="mpii", backbone="resnet_v1_50", pooling="attention",
            image_size=32, resize_min=36, bf16_backbone=False,
            eval_batch_size=2, seed=0)
# freeze_bn, as the fine-tuning presets (BASELINE configs #2-#5): over
# four steps a train-mode batch norm of 2x2 maps and 8 rows amplifies the
# rounding of its statistics chaotically (a data-parallel and a
# one-process run part by 6e-3 in a running variance, 1% in the loss),
# which says nothing of the restore; test_torch_mesh.py holds the
# train-mode step across topologies
RESUME = dict(dataset="hico", backbone="resnet_v1_50", pooling="attention",
              image_size=64, batch_size=8, bf16_backbone=False,
              learning_rate=1e-3, grad_clip_norm=10.0, freeze_bn=True,
              lr_schedule="constant", checkpoint_every=2, seed=1)

WORKER = r"""
import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import shutil
import sys

import numpy as np
import torch

rank, port, tmp, n = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    int(sys.argv[4])
torch.set_num_threads(2)

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import eval_cli
from attentionalpoolingaction_torch import evaluate as eval_lib
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch import train_cli
from attentionalpoolingaction_torch.data import grain_pipeline
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_torch.parallel import mesh as mesh_lib
from attentionalpoolingaction_torch.parallel import multihost

multihost.setup(f"127.0.0.1:{port}", n, rank, device="cpu")
assert multihost.process_count() == 2 and multihost.process_index() == rank
params = json.loads(open(tmp + "/params.json").read())

# --- the multihost helpers ---
multihost.assert_same_across_hosts(7, "smoke")
try:
    multihost.assert_same_across_hosts(rank, "rank")
    raise AssertionError("differing values passed")
except ValueError as e:
    assert "rank differs" in str(e)
r = multihost.FlagAllReduce()
h = r.dispatch(rank == 0)          # one rank raises the flag...
assert r.read(h) is True           # ...and both see it
assert r.read(r.dispatch(False)) is False
assert multihost.allreduce_flag(rank == 1) is True
assert multihost.allreduce_flag(False) is False
assert multihost.broadcast_step(100 + rank) == 100
assert multihost.broadcast_step(None if rank == 0 else 7) is None
try:
    mesh_lib.make_mesh((4,), ("data",))
    raise AssertionError("a mesh of 4 over 2 ranks")
except ValueError as e:
    assert "needs 4 devices, have 2" in str(e)
mesh = mesh_lib.make_mesh((2,), ("data",))
assert mesh_lib.axis_size(mesh, "data") == 2
assert mesh_lib.axis_index(mesh, "data") == rank
got = multihost.allgather_host_arrays({
    "x": np.arange(3 - rank, dtype=np.int32) + 10 * rank,
    "mask": np.ones(3 - rank, np.float32)})
np.testing.assert_array_equal(got["x"], [0, 1, 2, 10, 11, 0])
np.testing.assert_array_equal(got["mask"], [1, 1, 1, 1, 1, 0])

# --- disjoint per-rank streams over records labelled 0..7 ---
spec = get_dataset("mpii")
it = grain_pipeline.make_train_dataset(
    tmp + "/train.tfrecord", spec, batch_size=2, image_size=32,
    resize_min=36, resize_max=40, seed=0, shard_index=rank, shard_count=n,
    device="cpu")
seen = set()
for _ in range(2):
    seen |= set(np.asarray(next(it)["label"]).tolist())
assert seen == set(range(rank, 8, n)), seen


class Mgr:
    directory = pathlib.Path(tmp) / "ck_files"


if rank == 0:
    Mgr.directory.mkdir()
multihost.barrier()
train._grain_state_path(Mgr, 1, rank).write_text(json.dumps({"who": rank}))
multihost.barrier()
files = sorted(Mgr.directory.glob("grain_iter_1_p*.json"))
assert [json.loads(f.read_text())["who"] for f in files] == [0, 1], files

# --- train_cli / eval_cli --multiprocess over the records ---
work = tmp + "/run"
small = ["--set", "backbone='resnet_v1_50'", "--set", "image_size=32",
         "--set", "resize_min=36", "--set", "resize_max=40",
         "--set", "batch_size=4", "--set", "eval_batch_size=2",
         "--set", "mesh_shape=(2,)", "--set", "zero1=True",
         "--set", "log_every=1", "--device", "cpu"]
state = train_cli.main(["--multiprocess", "--config", "mpii_rank1_224",
                        "--train_pattern", tmp + "/train.tfrecord",
                        "--workdir", work, "--num_steps", "2", *small])
assert state.step == 2 and state.mesh is not None
mgr = ckpt_lib.make_manager(work + "/checkpoints")
assert mgr.all_steps() == [2]
for p in (0, 1):
    assert (mgr.directory / f"grain_iter_2_p{p}.json").exists()
assert len([f for f in os.listdir(work) if "tfevents" in f]) == 1
out = io.StringIO()
with contextlib.redirect_stdout(out):
    res = eval_cli.main(["--multiprocess", "--config", "mpii_rank1_224",
                         "--eval_pattern", tmp + "/train.tfrecord",
                         "--workdir", work, "--notb", *small])
lines = [x for x in out.getvalue().splitlines() if x.startswith("{")]
assert len(lines) == (1 if rank == 0 else 0), lines
assert res[0]["num_examples"] == 8 and res[0]["step"] == 2
print(f"CLI mAP={res[0]['mAP']!r}")

# --- sharded eval: this rank's half of the split, gathered ---
ecfg = config_lib.TrainConfig(**params["eval"],
                              eval_pattern=tmp + "/train.tfrecord")
shard = eval_lib.make_eval_input(ecfg, spec, shard_by_process=True,
                                 device="cpu")
assert sum(int(np.sum(b["mask"])) for b in shard) == 4
estate, _ = train.create_state(ecfg, device="cpu")
res = eval_lib.evaluate(ecfg, estate, device="cpu")
assert res["num_examples"] == 8, res
print(f"EVAL mAP={res['mAP']!r} acc={res['accuracy']!r}")
res5 = eval_lib.evaluate(dataclasses.replace(
    ecfg, eval_pattern=tmp + "/val5.tfrecord"), estate, device="cpu")
assert res5["num_examples"] == 5, res5
print(f"EVAL5 mAP={res5['mAP']!r}")

# --- resume across topologies ---
batch = dict(np.load(tmp + "/batch.npz"))
rcfg = config_lib.TrainConfig(**params["resume"])


def rows(cfg):
    if math.prod(cfg.mesh_shape) == n and "model" in cfg.mesh_axes:
        return batch                    # (1, 2): both ranks see every row
    b = len(batch["label"]) // n
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def run(cfg, ck, steps):
    def it():
        while True:
            yield rows(cfg)
    state, _ = train.train(cfg, train_iter=it(), num_steps=steps,
                           device="cpu",
                           checkpoint_manager=ckpt_lib.make_manager(ck))
    return state


def copy(src, dst):
    if rank == 0:
        shutil.copytree(src, dst)
    multihost.barrier()


z1 = dataclasses.replace(rcfg, mesh_shape=(2,), zero1=True)
tp = dataclasses.replace(rcfg, mesh_shape=(1, 2),
                         mesh_axes=("data", "model"))
run(z1, tmp + "/ck_z1", 2)                     # 2 ranks write step 2
copy(tmp + "/ck_z1", tmp + "/ck_z1_own")
copy(tmp + "/ck_1p", tmp + "/ck_1p_z1")
copy(tmp + "/ck_1p", tmp + "/ck_1p_tp")
for name, cfg, ck in (("own", z1, "ck_z1_own"), ("z1_from_1p", z1, "ck_1p_z1"),
                      ("tp_from_1p", tp, "ck_1p_tp")):
    state = run(cfg, tmp + "/" + ck, 4)
    assert state.step == 4
    sd = {k: v.numpy() for k, v in state.full_state_dict().items()
          if not k.endswith("num_batches_tracked")}
    if name == "tp_from_1p":
        assert tuple(state.model.head.attn_w.shape) == (2048, 300, 1)
    if rank == 0:
        np.savez(f"{tmp}/{name}.npz", **sd)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print(f"WORKER{rank} OK")
"""


def write_records(tmp):
    spec = get_dataset("mpii")
    rng = np.random.default_rng(0)
    examples = [records.make_example(
        records._cv2_encode_jpeg(rng.integers(0, 255, (40, 40, 3),
                                              np.uint8)),
        height=40, width=40, label=i,
        keypoints=np.zeros((16, 2), np.float32),
        visibility=np.zeros((16,), np.float32)) for i in range(8)]
    records.write_tfrecord(str(tmp / "train.tfrecord"), examples)
    records.write_tfrecord(str(tmp / "val5.tfrecord"), examples[:5])
    return spec


def resume_batch():
    # test_sharding.py's synth_batch: mean-subtracted float32 images
    rng = np.random.default_rng(2)
    return {"image": rng.normal(size=(8, 64, 64, 3)).astype(np.float32),
            "label": (rng.random((8, 600)) > 0.9).astype(np.float32)}


def run_alone(cfg, steps, ck=None):
    batch = resume_batch()

    def it():
        while True:
            yield batch
    mgr = ckpt_lib.make_manager(ck) if ck is not None else None
    state, _ = train.train(cfg, train_iter=it(), num_steps=steps,
                           device="cpu", checkpoint_manager=mgr)
    return state


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    write_records(tmp)
    np.savez(tmp / "batch.npz", **resume_batch())
    (tmp / "params.json").write_text(json.dumps(
        {"eval": EVAL, "resume": RESUME}))
    rcfg = config_lib.TrainConfig(**RESUME)
    run_alone(rcfg, 2, tmp / "ck_1p")            # 1 process writes step 2
    procs = start_workers(WORKER, tmp)
    # meanwhile, one process: the eval references and the continuous run
    ecfg = config_lib.TrainConfig(**EVAL,
                                  eval_pattern=str(tmp / "train.tfrecord"))
    estate, _ = train.create_state(ecfg, device="cpu")
    expected = eval_lib.evaluate(ecfg, estate, device="cpu")
    expected5 = eval_lib.evaluate(config_lib.TrainConfig(
        **EVAL, eval_pattern=str(tmp / "val5.tfrecord")), estate,
        device="cpu")
    continuous = run_alone(rcfg, 4).model.state_dict()
    outs = finish(procs, timeout=400)
    # the checkpoint the 2 ranks wrote under ZeRO-1, resumed alone
    shutil.copytree(tmp / "ck_z1", tmp / "ck_z1_alone")
    alone = run_alone(rcfg, 4, tmp / "ck_z1_alone")
    yield {"outs": outs, "expected": expected, "expected5": expected5,
           "continuous": continuous, "alone": alone, "tmp": tmp}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_eval_equals_one_process(job, rank):
    out = job["outs"][rank]
    m = re.search(r"EVAL mAP=([\d.e+-]+) acc=([\d.e+-]+)", out)
    assert m, out
    assert abs(float(m.group(1)) - job["expected"]["mAP"]) < 1e-12
    assert abs(float(m.group(2)) - job["expected"]["accuracy"]) < 1e-12
    # the uneven 3/2 shards through the padded gather
    m5 = re.search(r"EVAL5 mAP=([\d.e+-]+)", out)
    assert m5, out
    assert abs(float(m5.group(1)) - job["expected5"]["mAP"]) < 1e-12


def test_eval_cli_results_agree_across_processes(job):
    maps = [re.search(r"CLI mAP=([\d.e+-]+)", o).group(1)
            for o in job["outs"]]
    assert maps[0] == maps[1]


def test_checkpoint_of_two_ranks_resumes_alone(job):
    alone = job["alone"]
    assert alone.step == 4 and alone.mesh is None
    # the step directory holds the whole momentum, as one process saves it
    payload = ckpt_lib.make_manager(job["tmp"] / "ck_z1").load(2, "cpu")
    conv1 = payload["model"]["resnet.conv1.weight"]
    names = train.optimizer_param_names(alone.model)
    buf = payload["optimizer"]["state"][names.index(
        "resnet.conv1.weight")]["momentum_buffer"]
    assert buf.shape == conv1.shape == (64, 3, 7, 7)
    _close(alone.model.state_dict(), job["continuous"])


@pytest.mark.parametrize("name", ["own", "z1_from_1p", "tp_from_1p"])
def test_resume_across_topologies(job, name):
    z = np.load(job["tmp"] / f"{name}.npz")
    _close({k: torch.from_numpy(z[k]) for k in z.files}, job["continuous"])


def _close(got, want):
    worst = max(float((got[k] - want[k]).abs().max()) for k in got
                if not k.endswith("num_batches_tracked"))
    assert worst < 1e-4, worst


def _backward_inputs(b, n, f, c, p, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, n, f, generator=g)
    attn_w = torch.randn(f, c, p, generator=g) * 0.02
    attn_b = torch.randn(c, p, generator=g) * 0.02
    sal_w = torch.randn(f, p, generator=g) * 0.02
    sal_b = torch.randn(p, generator=g) * 0.02
    cot = torch.randn(b, c, generator=g)
    return x, attn_w, attn_b, sal_w, sal_b, cot


def _given_dv(x, attn_w, attn_b, sal_w, sal_b, cot):
    """The class-sharded backward's pass over X, given the whole ``dv``
    and ``dssum`` (as the all-reduce over the model group leaves them),
    and the fused backward of the same classes."""
    from attentionalpoolingaction_torch.ops import attn_pool_cuda as apc

    w_pfc = apc.attn_w_pfc(attn_w)
    v, s = apc.saliency_summary(x, sal_w, sal_b)
    b, p, f = v.shape
    dv = (cot @ w_pfc.reshape(p * f, -1).t()).reshape(b, p, f)
    got = apc._pool_backward_given_dv(x, sal_w, s, dv, cot @ attn_b)
    want = apc.fused_pool_backward(x, w_pfc, attn_b, sal_w, v, s, cot)
    return got, (want[0], want[3], want[4])


def test_sharded_backward_given_dv_equals_the_fused_backward():
    """``sharded_pool_backward``'s pass over X, handed ``dv`` and
    ``dssum``, gives the fused backward's dx, d_sal_w and d_sal_b on the
    CPU (its plain ops)."""
    got, want = _given_dv(*_backward_inputs(4, 225, 2048, 20, 5, 0))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_sharded_backward_kernel_equals_its_plain_version():
    """On the card, the ``pool_backward`` kernel given ``dssum`` as a (B, P)
    cotangent and the (P, P) identity as ``attn_b`` (the class-sharded
    backward) against the CPU's plain ops, at config #5's shape (rank 5,
    N=225) and HICO's 300 classes a shard."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = _backward_inputs(8, 225, 2048, 300, 5, 1)
    got, _ = _given_dv(*[t.cuda() for t in inputs])
    want, _ = _given_dv(*inputs)
    for a, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((a.cpu() - w).abs().max()) <= 1e-5 * scale
