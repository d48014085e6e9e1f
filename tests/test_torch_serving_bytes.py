"""The port's serving byte path against the JAX package's, on the same Flax
weights: ``preprocess`` of the JPEG fixtures (geometry equal, pixels within
the decode gate), ``predict_bytes`` (top-k classes equal; a corrupt blob
errors its own slot only), clips (``predict_clip_bytes``, float and int8),
the int8 ``Predictor`` (and its ``reload``), and ``data/png.py`` against
``cv2.imdecode(IMREAD_COLOR)``.

resnet_v1_50 at 64 px (``resize_min`` 72), MPII, buckets (2, 8), weights
from ``ActionModel.init`` with both head branches shrunk 100x, so that the
probabilities are not all 0 or 1 (as ``tests/test_torch_serving.py``).

Tolerances: the decode gate of the input pipeline's tests (mean |d| <= 1.5
levels, at most 1% of pixels off by more than 8; OpenCV's and torch's
bilinear resize differ by a level at most here); the float forward of one
uint8 clip 1e-4 relative (float32 summed in another order); the int8
clip's logits against JAX's jitted int8 forward 5% in relative L2 (the
fold's ulps move a few activations across the quantizer's rounding
boundaries: ``tests/test_torch_inference.py``); int8 vs float, the JAX
package's own bound (cosine of the logits > 0.9).
"""

import struct
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch.config import TrainConfig
from attentionalpoolingaction_torch.data import png
from attentionalpoolingaction_torch.data import preprocessing as pp
from attentionalpoolingaction_tpu import serving as jax_serving
from attentionalpoolingaction_tpu.config import TrainConfig as JaxConfig
from attentionalpoolingaction_tpu.data import preprocessing_np as ppnp
from attentionalpoolingaction_tpu.models.action_model import ActionModel

torch.set_num_threads(2)
FIXTURES = tuple("tests/fixtures_torch/" + n for n in (
    "mpii_a_1280x720.jpg", "mpii_b_1280x720.jpg", "portrait_480x640.jpg",
    "odd_517x333.jpg", "gray_400x300.jpg", "yuv444_720x540.jpg",
    "yuv422_480x360.jpg"))
CFG = dict(dataset="mpii", backbone="resnet_v1_50", pooling="attention",
           rank=1, image_size=64, batch_size=4, bf16_backbone=False,
           resize_min=72)


@pytest.fixture(scope="module")
def jpegs():
    out = []
    for path in FIXTURES:
        with open(path, "rb") as f:
            out.append(f.read())
    return out


def flax_variables(seed=0):
    model = ActionModel(num_classes=393, backbone="resnet_v1_50",
                        pooling="attention", rank=1)
    v = jax.tree.map(np.asarray, model.init(
        jax.random.key(seed), jnp.zeros((1, 64, 64, 3)), train=False))
    head = v["params"]["head"]
    head["attn_w"] = head["attn_w"] * np.float32(0.01)
    head["sal_w"] = head["sal_w"] * np.float32(0.01)
    return v


@pytest.fixture(scope="module")
def weights():
    return flax_variables()


@pytest.fixture(scope="module")
def predictors(weights):
    port = serving.Predictor(TrainConfig(**CFG), weights["params"],
                             weights["batch_stats"], buckets=(2, 8),
                             device="cpu")
    ref = jax_serving.Predictor(JaxConfig(**CFG), weights["params"],
                                weights["batch_stats"], buckets=(2, 8))
    return port, ref


def decode_gate(got: np.ndarray, want: np.ndarray) -> None:
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.mean() <= 1.5 and (d > 8).mean() <= 0.01, (d.mean(), d.max())


def test_preprocess_matches_jax(predictors, jpegs):
    port, ref = predictors
    for data in jpegs:
        got = port.preprocess(data)
        assert got.dtype == torch.uint8 and got.shape == (64, 64, 3)
        assert got.device.type == "cpu"
        want, transform = ppnp.preprocess_image_np(
            data, out_size=64, is_training=False, resize_min=72,
            keep_uint8=True)
        np.testing.assert_array_equal(ref.preprocess(data), want)
        h, w = ppnp.decode_jpeg(data).shape[:2]
        g = pp.draw_geometry(h, w, out_size=64, is_training=False,
                             resize_min=72)
        np.testing.assert_array_equal(g.transform(), transform)
        decode_gate(got.numpy(), want)


def test_predict_bytes_topk_and_a_corrupt_blob(predictors, jpegs):
    port, ref = predictors
    blobs = jpegs[:3] + [b"\xff\xd8 not a jpeg"] + jpegs[3:] + [b"junk"]
    got = port.predict_bytes(blobs, topk=3)
    want = ref.predict_bytes(blobs, topk=3)
    assert len(got) == len(want) == len(blobs)
    for g, w in zip(got, want):
        if "error" in w:
            assert g["error"].startswith("bad image: ")
            continue
        assert [e["class"] for e in g["topk"]] == \
            [e["class"] for e in w["topk"]]
        np.testing.assert_allclose([e["prob"] for e in g["topk"]],
                                   [e["prob"] for e in w["topk"]],
                                   rtol=0.05)
    # the good blobs alone give the same answers: the bad ones took no
    # slot of their batch
    alone = port.predict_bytes(jpegs, topk=3)
    assert [r for r in got if "error" not in r] == alone


def test_clips_match_jax(weights, predictors, jpegs):
    """``predict_clip_bytes``: frame picks and crops as JAX's; one uint8
    clip through both float forwards; int8 clips within the quantizer's
    measured gap."""
    port, ref = predictors
    frames = [jpegs[i % 3] for i in range(5)]        # 5 frames -> T = 8
    got = port.predict_clip_bytes(frames, topk=3)
    want = ref.predict_clip_bytes(frames, topk=3)
    assert got["clip_frames"] == want["clip_frames"] == 8
    assert got["frames_received"] == want["frames_received"] == 5
    assert [e["class"] for e in got["topk"]] == \
        [e["class"] for e in want["topk"]]
    clip = np.stack([ref.preprocess(f) for f in frames[:2]] * 4)[None]
    want_logits = np.asarray(ref._clip_fwd(ref._weights, clip))
    got_logits = port._fwd(port._weights, clip)
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-4,
                               atol=1e-4 * np.abs(want_logits).max())
    port8 = serving.Predictor(TrainConfig(**CFG), weights["params"],
                              weights["batch_stats"], buckets=(2,),
                              int8=True, device="cpu")
    ref8 = jax_serving.Predictor(JaxConfig(**CFG), weights["params"],
                                 weights["batch_stats"], buckets=(2,),
                                 int8=True)
    a = np.asarray(ref8._clip_fwd(ref8._weights, clip), np.float64)
    b = port8._fwd(port8._weights, clip).astype(np.float64)
    assert np.linalg.norm(a - b) / np.linalg.norm(a) <= 0.05
    res = port8.predict_clip_bytes(frames, topk=2)
    assert len(res["topk"]) == 2 and res["clip_frames"] == 8
    assert "bad video frame" in port8.predict_clip_bytes(
        [b"junk"])["error"]
    assert port8.predict_clip_bytes([]) == {"error": "bad video: no frames"}


def test_int8_predictor_close_to_float_and_reload(weights):
    """JAX's ``test_int8_predictor_close_to_float`` bound, and a reload with
    static calibration equal to a fresh predictor calibrated alike."""
    cfg = TrainConfig(**CFG)
    imgs = np.random.default_rng(1).normal(0, 64.0, (4, 64, 64, 3)).astype(
        np.float32)
    p_f = serving.Predictor(cfg, weights["params"], weights["batch_stats"],
                            buckets=(4,), device="cpu")
    p_q = serving.Predictor(cfg, weights["params"], weights["batch_stats"],
                            buckets=(4,), int8=True,
                            calibration_images=imgs, device="cpu")
    a = p_f._fwd(p_f._weights, imgs).astype(np.float64)
    b = p_q._fwd(p_q._weights, imgs).astype(np.float64)
    assert a.ravel() @ b.ravel() / (np.linalg.norm(a) *
                                    np.linalg.norm(b)) > 0.9
    probs = p_q.predict_arrays(imgs)
    assert probs.shape == (4, 393) and np.allclose(probs.sum(-1), 1,
                                                   atol=1e-3)
    _, _, scales = p_q._weights
    assert len(scales) == 53 and all(
        s.dtype == torch.float32 and s.dim() == 0 for s in scales.values())

    other = flax_variables(seed=3)
    u8 = np.random.default_rng(2).integers(0, 256, (4, 64, 64, 3), np.uint8)
    before = p_q.predict_arrays(u8)
    p_q.reload(other["params"], other["batch_stats"], step=7)
    fresh = serving.Predictor(cfg, other["params"], other["batch_stats"],
                              buckets=(4,), int8=True,
                              calibration_images=imgs, device="cpu")
    np.testing.assert_array_equal(p_q.predict_arrays(u8),
                                  fresh.predict_arrays(u8))
    assert not np.array_equal(before, fresh.predict_arrays(u8))
    assert p_q.step == 7


# ----------------------------------------------------------------- PNG


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body +
            struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_png(samples, ctype, depth, filters, palette=None,
               interlace=0) -> bytes:
    """A PNG of ``samples`` (H, W, channels) with the scanline filter
    ``filters[row % len(filters)]`` on each row: a plain encoder, so that
    every filter type and colour type is written (OpenCV picks its own)."""
    h, w = samples.shape[:2]
    flat = samples.reshape(h, -1)
    raw = (flat.astype(">u2").view(np.uint8).reshape(h, -1) if depth == 16
           else flat.astype(np.uint8)).astype(np.int64)
    bpp = max(1, samples.shape[2] * depth // 8)
    out = bytearray()
    prev = np.zeros(raw.shape[1], np.int64)
    for r in range(h):
        t = filters[r % len(filters)]
        row = raw[r]
        filt = np.zeros_like(row)
        for i in range(len(row)):
            a = row[i - bpp] if i >= bpp else 0
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, prev[i], (a + prev[i]) // 2,
                    _paeth(a, prev[i], c))[t]
            filt[i] = (row[i] - pred) & 0xFF
        out.append(t)
        out += bytes(filt.astype(np.uint8))
        prev = row
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    body = _chunk(b"IHDR", ihdr)
    if palette is not None:
        body += _chunk(b"PLTE", palette.tobytes())
    return (png.SIGNATURE + body + _chunk(b"IDAT", zlib.compress(bytes(out)))
            + _chunk(b"IEND", b""))


def cv2_rgb(data: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("ctype, depth", [(0, 8), (0, 16), (2, 8), (2, 16),
                                          (3, 8), (4, 8), (4, 16), (6, 8),
                                          (6, 16)])
def test_png_equals_opencv_for_every_filter(ctype, depth):
    rng = np.random.default_rng(ctype * 100 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    high = 40 if ctype == 3 else 2 ** depth
    samples = rng.integers(0, high, (11, 13, channels))
    palette = (rng.integers(0, 256, (40, 3), dtype=np.uint8)
               if ctype == 3 else None)
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4], [4, 3, 1]):
        data = encode_png(samples, ctype, depth, filters, palette)
        np.testing.assert_array_equal(png.decode(data), cv2_rgb(data),
                                      err_msg=str(filters))


def test_png_written_by_opencv_and_served(predictors, jpegs):
    """PNGs OpenCV writes (gray, RGB, RGBA, 16-bit) decode as OpenCV reads
    them; a PNG of a fixture predicts like the JPEG it was made from."""
    port, _ = predictors
    img = cv2_rgb(jpegs[3])
    bgr = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    for arr in (bgr, bgr[:, :, 0], np.dstack([bgr, bgr[:, :, :1]]),
                bgr.astype(np.uint16) * 257 + 3):
        ok, buf = cv2.imencode(".png", arr)
        assert ok
        np.testing.assert_array_equal(png.decode(buf.tobytes()),
                                      cv2_rgb(buf.tobytes()))
    ok, buf = cv2.imencode(".png", bgr)
    assert png.is_png(buf.tobytes())
    decode_gate(port.preprocess(buf.tobytes()).numpy(),
                port.preprocess(jpegs[3]).numpy())


def test_png_refuses_what_it_does_not_take():
    samples = np.zeros((4, 4, 3), np.int64)
    with pytest.raises(ValueError, match=r"unsupported PNG \(interlaced\)"):
        png.decode(encode_png(samples, 2, 8, [0], interlace=1))
    with pytest.raises(ValueError, match=r"unsupported PNG \(bit depth 4"):
        png.decode(encode_png(samples[:, :, :1], 0, 4, [0]))
    good = encode_png(samples, 2, 8, [0])
    with pytest.raises(ValueError, match="CRC"):
        png.decode(good[:-5] + b"\x00" + good[-4:])
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"\x89PNG-bad")
    with pytest.raises(ValueError, match="not a JPEG or PNG"):
        serving.decode_image(b"GIF89a", "cpu")
