"""Remake the JPEG fixtures of the port's input-pipeline tests and the JAX
pipeline's golden crops of them.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/fixtures_torch/make_fixtures.py

Needs OpenCV and the JAX package (its ``data/preprocessing_np.py``, which
imports no JAX).  Writes, beside this file:

  * seven JPEGs of seeded synthetic scenes (smooth colour fields, shapes,
    lines, text and mild noise): two at MPII's 1280x720, a portrait, an
    odd size (all 4:2:0), a grayscale one, and one each with 4:4:4 and
    4:2:2 chroma;
  * ``odd_517x333.png``: the odd-size JPEG as OpenCV decodes it, written
    losslessly as an RGB PNG by OpenCV (serving's PNG path);
  * ``golden.npz``: for each JPEG, in ``NAMES`` order, the JAX pipeline's
    output (``cv2.imdecode`` + ``preprocess_decoded_np(keep_uint8=True)``,
    224 px out of ``resize_min`` 256, ``resize_max`` 512) at the eval
    geometry and at one train geometry drawn from
    ``numpy.random.default_rng(TRAIN_SEED + i)``, with both transforms.
    The crops are stored as uint8 differences along the width, which
    deflate well: ``np.cumsum(dx, axis=2, dtype=np.uint8)`` gives them
    back exactly;
  * ``jax_written.array_record``: the MPII-schema examples of
    ``ARRAY_RECORD_EXAMPLES`` (:func:`array_record_examples`, made by the
    port's ``records.make_example``), written by the JAX package's
    ``records.write_array_record`` (Grain's ``array_record``), so that the
    port's codec is held against bytes of the JAX package's writer on the
    card, where ``array_record`` is not installed.  One record (the first
    1280x720 JPEG) spans a 64 KiB block boundary.

``--only array_record`` writes that file alone, from the JPEGs as they are.
"""

from __future__ import annotations

import argparse
import os

import cv2
import numpy as np

from attentionalpoolingaction_torch.data import records as port_records
from attentionalpoolingaction_tpu.data import preprocessing_np as ppnp

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_SIZE, RESIZE_MIN, RESIZE_MAX, TRAIN_SEED = 224, 256, 512, 1000
# name: (height, width, grayscale, chroma sampling unless 4:2:0, quality)
SPECS = {
    "mpii_a_1280x720.jpg": (720, 1280, False, None, 85),
    "mpii_b_1280x720.jpg": (720, 1280, False, None, 75),
    "portrait_480x640.jpg": (640, 480, False, None, 85),
    "odd_517x333.jpg": (333, 517, False, None, 85),
    "gray_400x300.jpg": (300, 400, True, None, 85),
    "yuv444_720x540.jpg": (540, 720, False, "444", 85),
    "yuv422_480x360.jpg": (360, 480, False, "422", 85),
}
NAMES = list(SPECS)
PNG_OF = "odd_517x333.jpg"
ARRAY_RECORD = "jax_written.array_record"
ARRAY_RECORD_EXAMPLES = ("mpii_a_1280x720.jpg", "mpii_b_1280x720.jpg",
                         "gray_400x300.jpg")
MPII_JOINTS = 16


def array_record_examples(read=None) -> list[bytes]:
    """The serialized examples of ``jax_written.array_record``: example i
    holds the JPEG ``ARRAY_RECORD_EXAMPLES[i]`` (``read(name) -> bytes``,
    by default the file beside this one), label ``7 * i + 3`` and
    keypoints ``(i + 1) * arange(32)`` (y, x) with every joint visible."""
    if read is None:
        def read(name):
            with open(os.path.join(HERE, name), "rb") as f:
                return f.read()
    out = []
    for i, name in enumerate(ARRAY_RECORD_EXAMPLES):
        h, w = SPECS[name][:2]
        out.append(port_records.make_example(
            read(name), height=h, width=w, label=7 * i + 3,
            keypoints=(i + 1) * np.arange(2 * MPII_JOINTS, dtype=np.float32),
            visibility=np.ones(MPII_JOINTS, np.float32)))
    return out


def write_array_record_fixture() -> None:
    from attentionalpoolingaction_tpu.data import records as jax_records

    path = os.path.join(HERE, ARRAY_RECORD)
    jax_records.write_array_record(path, array_record_examples())
    print(f"{ARRAY_RECORD}: {os.path.getsize(path)} bytes")


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded RGB uint8 scene with edges at every scale."""
    rng = np.random.default_rng(seed)
    fields = np.zeros((h, w, 3), np.float32)
    for cells in (3, 9, 27):
        field = rng.uniform(0, 255, (cells, cells, 3)).astype(np.float32)
        fields += cv2.resize(field, (w, h), interpolation=cv2.INTER_CUBIC) / 3
    img = np.clip(fields, 0, 255).astype(np.uint8)
    for _ in range(12):
        color = [int(c) for c in rng.integers(0, 256, 3)]
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        r = int(rng.integers(8, max(9, min(h, w) // 4)))
        if rng.random() < 0.5:
            cv2.circle(img, (x, y), r, color, -1, cv2.LINE_AA)
        else:
            cv2.rectangle(img, (x, y), (x + r, y + r // 2), color, -1)
    for _ in range(8):
        color = [int(c) for c in rng.integers(0, 256, 3)]
        p0 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        p1 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        cv2.line(img, p0, p1, color, int(rng.integers(1, 4)), cv2.LINE_AA)
    cv2.putText(img, "attentional pooling", (w // 10, h // 2),
                cv2.FONT_HERSHEY_SIMPLEX, min(h, w) / 300, (250, 250, 250),
                2, cv2.LINE_AA)
    noisy = img + rng.normal(0, 0.5, img.shape)
    return np.clip(np.round(noisy), 0, 255).astype(np.uint8)


def encode(rgb: np.ndarray, gray: bool, sampling: str | None,
           quality: int) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if gray:
        src = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    else:
        src = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
        if sampling is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(
                cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    ok, buf = cv2.imencode(".jpg", src, params)
    assert ok
    return buf.tobytes()


def golden(datas: list[bytes]) -> dict:
    out = {k: [] for k in ("eval_image", "eval_transform", "train_image",
                           "train_transform")}
    for i, data in enumerate(datas):
        decoded = ppnp.decode_jpeg(data)
        for kind, rng in (("eval", None),
                          ("train", np.random.default_rng(TRAIN_SEED + i))):
            img, t = ppnp.preprocess_decoded_np(
                decoded, out_size=OUT_SIZE, is_training=kind == "train",
                resize_min=RESIZE_MIN, resize_max=RESIZE_MAX, rng=rng,
                keep_uint8=True)
            out[f"{kind}_image"].append(img)
            out[f"{kind}_transform"].append(t)
    return {k: np.stack(v) for k, v in out.items()}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", choices=["array_record"],
                   help="write this fixture alone")
    if p.parse_args().only == "array_record":
        write_array_record_fixture()
        return
    datas = []
    for i, (name, (h, w, gray, sampling, quality)) in enumerate(
            SPECS.items()):
        data = encode(scene(h, w, seed=i), gray, sampling, quality)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        datas.append(data)
        print(f"{name}: {len(data)} bytes")
    png_name = PNG_OF.replace(".jpg", ".png")
    ok, buf = cv2.imencode(".png", cv2.imdecode(
        np.frombuffer(datas[NAMES.index(PNG_OF)], np.uint8), cv2.IMREAD_COLOR))
    assert ok
    with open(os.path.join(HERE, png_name), "wb") as f:
        f.write(buf.tobytes())
    print(f"{png_name}: {len(buf)} bytes")
    gold = golden(datas)
    for kind in ("eval", "train"):
        gold[f"{kind}_image_dx"] = np.diff(
            gold.pop(f"{kind}_image"), axis=2, prepend=np.uint8(0))
    np.savez_compressed(os.path.join(HERE, "golden.npz"),
                        names=np.array(NAMES), **gold)
    print("golden.npz:", os.path.getsize(os.path.join(HERE, "golden.npz")),
          "bytes")
    write_array_record_fixture()


if __name__ == "__main__":
    main()
