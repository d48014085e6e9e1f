"""The port's attention-map tools (``utils/visualize.py``,
``visualize_cli.py``) and PNG encoder on the CPU: the JAX package's
``tests/test_visualize.py`` mirrored test for test against JAX's functions
on the same weights, and the pieces that replace OpenCV.

resnet_v1_50 at 64 px, 6 classes, one set of seeded Flax-layout weights
(``convert.random_flax_variables``) that both packages load.  Bounds: the
maps within 1e-4 of the largest |map| (float32 through ResNet-50 in
another order of summation, as ``tests/test_torch_serving.py``'s bound);
overlays equal to JAX's on at
least 99% of the pixels, their colormap levels (``uint8(map * 255)``)
within 1 of JAX's everywhere, and so the overlays within 2 (half of one
JET step, at alpha 0.5) where a level flips; the JET table and the PNG
encoder bit for bit against OpenCV; the upsampling within 1e-6 of the
largest |map| of ``cv2.resize(INTER_LINEAR)``.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch import visualize_cli
from attentionalpoolingaction_torch.convert import (
    load_flax_variables,
    random_flax_variables,
)
from attentionalpoolingaction_torch.data import png, records
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_torch.models.action_model import ActionModel
from attentionalpoolingaction_torch.utils import visualize as viz
from attentionalpoolingaction_tpu.models import ActionModel as JaxModel
from attentionalpoolingaction_tpu.utils import visualize as jax_viz

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables, the port's model with the same weights)."""
    jm = JaxModel(num_classes=6, backbone="resnet_v1_50",
                  pooling="attention", rank=1)
    params, stats = random_flax_variables("resnet_v1_50", num_classes=6,
                                          num_positions=4, seed=0)
    variables = {"params": params, "batch_stats": stats}
    model = ActionModel(num_classes=6, backbone="resnet_v1_50",
                        pooling="attention", rank=1, image_size=64)
    load_flax_variables(model, variables["params"],
                        variables["batch_stats"])
    return jm, variables, model.train()


def _levels(attn, h, w, prenormalized=False):
    """The colormap levels of a map's overlay, ``uint8(m * 255)``, by the
    JAX package's numpy."""
    m = jax_viz.upsample_map(attn, h, w)
    m = np.clip(m, 0, 1) if prenormalized else jax_viz.normalize_map(m)
    return (m * 255).astype(np.uint8)


def _close_overlays(got, want, got_levels, want_levels):
    got, want = np.stack(got).astype(int), np.stack(want).astype(int)
    assert got.shape == want.shape and (got >= 0).all()
    assert (got == want).mean() >= 0.99
    assert np.abs(got - want).max() <= 2
    assert np.abs(got_levels.astype(int) - want_levels.astype(int)).max() <= 1


def _assert_maps_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# -- the JAX package's tests/test_visualize.py ----------------------------

def test_overlay_heatmap_shapes(rng):
    img = rng.integers(0, 255, (64, 48, 3)).astype(np.uint8)
    attn = rng.normal(size=(4, 3)).astype(np.float32)
    out = viz.overlay_heatmap(img, attn).numpy()
    assert out.shape == (64, 48, 3) and out.dtype == np.uint8
    # the same map into both: the same pixels
    np.testing.assert_array_equal(out, jax_viz.overlay_heatmap(img, attn))
    pre = np.clip(attn, 0, 1)
    np.testing.assert_array_equal(
        viz.overlay_heatmap(img, pre, prenormalized=True).numpy(),
        jax_viz.overlay_heatmap(img, pre, prenormalized=True))


def test_normalize_map_constant(rng):
    m = viz.normalize_map(np.full((3, 3), 7.0))
    np.testing.assert_array_equal(m.numpy(), np.zeros((3, 3)))
    x = (rng.normal(size=(5, 7)) * 30).astype(np.float32)
    np.testing.assert_array_equal(viz.normalize_map(x).numpy(),
                                  jax_viz.normalize_map(x))


def test_attention_summary_hook(tmp_path):
    """The train-loop image-summary hook: reads its probe batch once,
    draws with the CURRENT weights in eval mode (batch norm's running
    statistics do not move), puts the model back in train mode, and
    writes through the writer's write_images."""
    spec = get_dataset("mpii")
    records.write_synthetic_dataset(str(tmp_path / "val.tfrecord"), spec, 4,
                                    image_size=72, seed=0)
    cfg = config_lib.TrainConfig(
        dataset="mpii", backbone="resnet_v1_50", pooling="attention",
        rank=1, image_size=64, batch_size=4, learning_rate=1e-3,
        grad_clip_norm=10.0, lr_schedule="constant", bf16_backbone=False,
        resize_min=72, eval_pattern=str(tmp_path / "val.tfrecord"),
        eval_batch_size=4)
    state, _ = train.create_state(cfg, device="cpu")
    state.model.train()
    stats = {k: v.clone() for k, v in state.model.state_dict().items()
             if "running" in k}
    written = {}

    class FakeWriter:
        def write_images(self, step, images):
            written[step] = images

    hook = viz.make_attention_summary_hook(cfg, FakeWriter(), every=2,
                                           num_images=2, device="cpu")
    hook(1, state, {})                  # off-cycle: no write
    hook(2, state, {})
    assert list(written) == [2]
    imgs = written[2]["attention/top_down"]
    assert imgs.shape == (2, 64, 64, 3) and imgs.dtype == np.uint8
    assert written[2]["attention/saliency"].shape == (2, 64, 64, 3)
    assert state.model.training
    for k, v in state.model.state_dict().items():
        if k in stats:
            assert torch.equal(v, stats[k]), k
    with pytest.raises(ValueError, match="attention head"):
        viz.make_attention_summary_hook(
            dataclasses.replace(cfg, pooling="avg"), FakeWriter(), every=2)


def test_attention_overlays_end_to_end(models, rng):
    jm, variables, model = models
    images = (rng.normal(size=(2, 64, 64, 3)) * 20).astype(np.float32)
    want = jax_viz.attention_overlays(jm, variables, jnp.asarray(images))
    got = viz.attention_overlays(model, images)
    assert model.training          # back in the mode it was in
    assert len(got["top_down"]) == 2
    assert got["top_down"][0].shape == (64, 64, 3)
    assert got["saliency"][0].dtype == np.uint8
    assert got["attn_maps"].shape == (2, 2, 2, 6)
    for key in ("attn_maps", "saliency_maps", "logits"):
        _assert_maps_close(got[key], np.asarray(want[key]))
    np.testing.assert_array_equal(got["class_idx"], want["class_idx"])
    cls = want["class_idx"]
    for kind, maps, pick in (("top_down", "attn_maps", True),
                             ("saliency", "saliency_maps", False)):
        lv = [_levels(got[maps][i, ..., cls[i]] if pick else got[maps][i],
                      64, 64) for i in range(2)]
        wl = [_levels(np.asarray(want[maps])[i, ..., cls[i]] if pick
                      else np.asarray(want[maps])[i], 64, 64)
              for i in range(2)]
        _close_overlays(got[kind], want[kind], np.stack(lv), np.stack(wl))
    # explicit class selection
    out2 = viz.attention_overlays(model, images, class_idx=3)
    assert (out2["class_idx"] == 3).all()


def test_clip_attention_overlays(models, rng):
    """T per-frame overlays from ONE spatiotemporal forward, a video-level
    predicted class, and a temporal attention that sums to 1."""
    jm, variables, model = models
    clip = np.asarray(rng.normal(0, 60, size=(3, 64, 64, 3)), np.float32)
    want = jax_viz.clip_attention_overlays(jm, variables, clip)
    got = viz.clip_attention_overlays(model, clip)
    assert len(got["top_down"]) == 3 and len(got["saliency"]) == 3
    for img in got["top_down"] + got["saliency"]:
        assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    assert got["class_idx"] == want["class_idx"]
    ta = got["temporal_attention"]
    assert ta.shape == (3,)
    np.testing.assert_allclose(ta.sum(), 1.0, atol=1e-5)
    np.testing.assert_allclose(ta, want["temporal_attention"], atol=1e-5)
    for key in ("attn_maps", "saliency_maps"):
        _assert_maps_close(got[key], np.asarray(want[key]))
    c = want["class_idx"]
    for kind, key in (("top_down", "attn_maps"), ("saliency",
                                                  "saliency_maps")):
        g = got[key][..., c] if kind == "top_down" else got[key]
        w = np.asarray(want[key])
        w = w[..., c] if kind == "top_down" else w
        gn, wn = jax_viz.normalize_map(g), jax_viz.normalize_map(w)
        lv = np.stack([_levels(gn[t], 64, 64, True) for t in range(3)])
        wl = np.stack([_levels(wn[t], 64, 64, True) for t in range(3)])
        _close_overlays(got[kind], want[kind], lv, wl)
    out2 = viz.clip_attention_overlays(model, clip, class_idx=2)
    assert out2["class_idx"] == 2


# -- what takes OpenCV's place ----------------------------------------------

def test_jet_table_is_opencvs():
    levels = np.arange(256, dtype=np.uint8)[:, None]
    bgr = cv2.applyColorMap(levels, cv2.COLORMAP_JET)[:, 0]
    np.testing.assert_array_equal(viz.JET, bgr[:, ::-1])
    m = np.linspace(0, 1, 1001, dtype=np.float32)
    want = cv2.applyColorMap((m * 255).astype(np.uint8)[:, None],
                             cv2.COLORMAP_JET)[:, 0, ::-1]
    np.testing.assert_array_equal(viz.colorize(torch.from_numpy(m)).numpy(),
                                  want)


@pytest.mark.parametrize("src, dst", [((2, 2), (64, 64)), ((4, 3), (64, 48)),
                                      ((7, 7), (224, 224)),
                                      ((14, 7), (448, 224))])
def test_upsample_matches_cv2_resize(src, dst, rng):
    m = (rng.normal(size=src) * 50).astype(np.float32)
    want = cv2.resize(m, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = viz.upsample_map(m, *dst).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(m).max()


@pytest.mark.parametrize("shape", [(17, 23, 3), (1, 1, 3), (64, 64, 3)])
def test_png_encoder_round_trips(shape, rng):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    data = png.encode(img)
    np.testing.assert_array_equal(png.decode(data), img)
    cv = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(cv[..., ::-1], img)


def test_visualize_cli_runs_as_a_module(tmp_path):
    """``python -m ...visualize_cli`` on a checkpoint of the port: a JPEG
    and a PNG in, two PNG overlays an image out, and (in this process)
    with ``--clip`` two a frame; each decodes back to the crop's size."""
    sets = ["--set", "backbone='resnet_v1_50'", "--set", "image_size=64",
            "--set", "bf16_backbone=False"]
    cfg = config_lib.get_config("mpii_rank1_224", backbone="resnet_v1_50",
                                image_size=64, bf16_backbone=False)
    state, _ = train.create_state(cfg, device="cpu")
    ckpt_lib.save(ckpt_lib.make_manager(str(tmp_path / "run/checkpoints")),
                  state)
    rng = np.random.default_rng(0)
    ok, jpg = cv2.imencode(".jpg", rng.integers(0, 255, (90, 120, 3),
                                                np.uint8))
    assert ok
    (tmp_path / "a.jpg").write_bytes(jpg.tobytes())
    (tmp_path / "b.png").write_bytes(png.encode(
        rng.integers(0, 255, (80, 70, 3), np.uint8)))
    images = [str(tmp_path / "a.jpg"), str(tmp_path / "b.png")]
    for extra, names in (
            ([], ["a_top_down", "a_saliency", "b_top_down", "b_saliency"]),
            (["--clip"], ["a_t000_top_down", "a_t000_saliency",
                          "b_t001_top_down", "b_t001_saliency"])):
        out = tmp_path / ("viz" + "".join(extra))
        args = ["--workdir", str(tmp_path / "run"), "--images", *images,
                "--out_dir", str(out), "--device", "cpu", *sets, *extra]
        if extra:
            res = visualize_cli.main(args)
            assert abs(res["temporal_attention"].sum() - 1) < 1e-6
        else:
            proc = subprocess.run(
                [sys.executable, "-m",
                 "attentionalpoolingaction_torch.visualize_cli", *args],
                cwd=ROOT, capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stderr[-3000:]
            assert "wrote 4 overlays" in proc.stdout
        assert sorted(os.listdir(out)) == sorted(f"{n}.png" for n in names)
        for n in names:
            assert png.decode((out / f"{n}.png").read_bytes()).shape == \
                (64, 64, 3)
    shutil.rmtree(tmp_path / "run")     # ~100 MB; pytest keeps tmp_path
