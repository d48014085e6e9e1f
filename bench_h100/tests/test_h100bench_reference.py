"""The plain reference: it imports nothing of the port, of the JAX
package or of JAX, and at a small size on the CPU it agrees with the port
(which this test imports; the reference does not)."""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_h100.generators import images as gen_images
from bench_h100.generators import weights as gen_weights
from bench_h100.reference import compare
from bench_h100.reference import model as ref_model
from bench_h100.reference import preprocess as ref_pre
from bench_h100.reference import train as ref_train

REF_DIR = pathlib.Path(ref_model.__file__).parent
ROOT = REF_DIR.parents[1]
BARRED = {"jax", "jaxlib", "flax", "optax", "orbax",
          "attentionalpoolingaction_tpu", "attentionalpoolingaction_torch"}
SMALL = dict(backbone="resnet_v1_50", image_size=64, resize_min=72,
             resize_max=144)


def imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(REF_DIR.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_source_imports_nothing_barred(path):
    tops = {n.partition(".")[0] for n in imported_names(path)}
    assert not tops & BARRED, path


def test_reference_loads_nothing_barred():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import bench_h100.reference.model, bench_h100.reference.train\n"
            "import bench_h100.reference.preprocess\n"
            "import bench_h100.reference.compare\n"
            "print(json.dumps(sorted({m.partition('.')[0] "
            "for m in sys.modules})))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert not set(json.loads(out.stdout.splitlines()[-1])) & BARRED


def small_config(**kw):
    from attentionalpoolingaction_torch import config as config_lib
    return config_lib.get_config("mpii_rank1_224", **{**SMALL, **kw})


def test_eval_logits_agree_with_the_port():
    from attentionalpoolingaction_torch import serving
    cfg = small_config()
    params, stats = gen_weights.make(cfg.backbone, num_classes=393, rank=1,
                                     image_size=64, seed=5, device="cpu")
    pool = gen_images.make_pool(5, [{"width": 320, "height": 200,
                                     "share": 1.0}], 3, 90)
    crops = np.stack([ref_pre.eval_crop(p["data"], 64, 72) for p in pool])
    pred = serving.Predictor(cfg, gen_weights.to_numpy(params),
                             gen_weights.to_numpy(stats), buckets=(1, 4),
                             device="cpu")
    port_crops = torch.stack([pred.preprocess(p["data"]) for p in pool])
    assert torch.equal(port_crops, torch.from_numpy(crops))
    got = pred.logits(pred._weights, port_crops).double()
    with torch.no_grad():
        want, _ = ref_model.logits(params, stats, torch.from_numpy(crops),
                                   stages=gen_weights.STAGES[cfg.backbone])
    want = want.double()
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_first_train_step_agrees_with_the_port():
    from attentionalpoolingaction_torch import train as train_lib
    cfg = small_config(image_size=128, resize_min=146, resize_max=292,
                       batch_size=4)
    params, stats = gen_weights.make(cfg.backbone, num_classes=393, rank=1,
                                     image_size=128, seed=9, device="cpu")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (4, 128, 128, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 393, 4))
    state, spec = train_lib.create_state(
        cfg, device="cpu", variables=(gen_weights.to_numpy(params),
                                      gen_weights.to_numpy(stats)))
    state, m = train_lib.make_train_step(spec, cfg)(
        state, {"image": images, "label": labels})
    trainer = ref_train.Trainer(params, stats, ref_train.Recipe(
        stages=gen_weights.STAGES[cfg.backbone],
        learning_rate=cfg.learning_rate, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, lr_decay_rate=cfg.lr_decay_rate,
        lr_decay_steps=cfg.lr_decay_steps, grad_clip_norm=cfg.grad_clip_norm,
        ema_decay=cfg.ema_decay, bn_decay=cfg.bn_momentum))
    r = trainer.train_step(images, labels)
    assert abs(float(m["loss/total"]) - r["loss"]) < 1e-5 * abs(r["loss"])
    program = {}
    for name, p in state.model.named_parameters():
        coll, path = gen_weights.port_name_to_path(name)
        program["/".join(path)] = state.optimizer.state[p]["momentum_buffer"]
    gap, leaf = compare.leaf_gap(
        compare.norms(program),
        compare.norms({"/".join(k): v for k, v in r["taken"].items()}))
    assert gap < 1e-2, leaf


def test_train_stream_contract_matches_the_port(tmp_path):
    from attentionalpoolingaction_torch import train as train_lib
    from bench_h100.generators import records as gen_records
    cfg = small_config(batch_size=3, seed=2 ** 31 + 5,
                       train_pattern=str(tmp_path / "t.tfrecord"))
    pool = gen_images.make_pool(3, [{"width": 160, "height": 90,
                                     "share": 1.0}], 4, 90)
    drawn = gen_records.write(cfg.train_pattern, pool, 5, 3, 393)
    datas = [pool[int(i)]["data"] for i in drawn["pool_index"]]
    batches, _, owned = train_lib._train_input(
        cfg, train_lib.get_dataset("mpii"), None, torch.device("cpu"),
        batch_size=3)
    want = ref_pre.train_batches(datas, drawn["label"], seed=cfg.seed,
                                 steps=4, batch=3, out_size=64,
                                 resize_min=72, resize_max=144)
    for images, labels in want:          # across an epoch boundary
        b = next(batches)
        np.testing.assert_array_equal(b["image"].numpy(), images)
        np.testing.assert_array_equal(np.asarray(b["label"]), labels)
    owned.close()


def _top_answers(logits, k=3):
    out = []
    for row in logits:
        p = np.exp(row - row.max())
        p /= p.sum()
        out.append([{"class": int(c), "prob": float(p[c])}
                    for c in np.argsort(-p)[:k]])
    return out


def test_bf16_ratio_reads_nought_when_exact_and_one_for_the_yardstick():
    rng = np.random.default_rng(3)
    ref = rng.normal(size=(4, 10))
    low = ref + rng.normal(scale=1e-2, size=ref.shape)
    exact = compare.bf16_ratio(_top_answers(ref), ref, low)
    assert exact["logprob_bf16_ratio"] < 1e-9
    assert exact["bf16_logprob_mean_gap"] > 1e-4
    yard = compare.bf16_ratio(_top_answers(low), ref, low)
    assert abs(yard["logprob_bf16_ratio"] - 1.0) < 1e-9
    zero = [[{"class": 0, "prob": 0.0}]] + _top_answers(ref)[1:]
    assert compare.bf16_ratio(zero, ref, low)["logprob_bf16_ratio"] == np.inf
