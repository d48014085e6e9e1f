"""The JPEG decode's colour kernel (``csrc/jpeg_decode.cu``) and its
plain version, and the decode on the card against the JAX pipeline.

  * On the CPU, the plain version (libjpeg's fancy chroma upsampling and
    fixed-point YCbCr -> RGB in torch ops) on libjpeg's own planes equals
    OpenCV's RGB decode bit for bit.
  * On the card (marked ``cuda``; run with ``python -m pytest --noconftest
    -m cuda tests/test_torch_jpeg_kernel.py``, this file imports no JAX):
    the kernel equals its plain version bit for bit at odd sizes and
    padded planes, and nvJPEG + the kernel + the preprocessing hold the
    chip_smoke.py gate against the JAX goldens (mean |d| <= 1.5 levels, at
    most 1% of pixels off by more than 8), also for streams with an EXIF
    orientation of 1-8, and decodes queued behind other work on the
    stream equal decodes on an idle card.
"""

import io
import os

import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch.data import jpeg
from attentionalpoolingaction_torch.data import preprocessing as pp

torch.set_num_threads(2)
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures_torch")
GOLDEN = np.load(os.path.join(FIXTURES, "golden.npz"))
NAMES = [str(n) for n in GOLDEN["names"]]
OUT, RMIN = 224, 256


def fixture(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def with_exif_orientation(data, orientation, order):
    """``data`` with an EXIF APP1 segment right after SOI whose IFD0 holds
    the orientation tag alone, in byte order ``order`` (b"II" or b"MM")."""
    o = "little" if order == b"II" else "big"
    entry = ((0x0112).to_bytes(2, o) + (3).to_bytes(2, o)      # SHORT
             + (1).to_bytes(4, o) + orientation.to_bytes(2, o) + b"\0\0")
    tiff = (order + (42).to_bytes(2, o) + (8).to_bytes(4, o)
            + (1).to_bytes(2, o) + entry + (0).to_bytes(4, o))
    payload = b"Exif\0\0" + tiff
    return (data[:2] + b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big")
            + payload + data[2:])


# the orientation that undoes each one (6 and 8 turn opposite ways)
UNDO = {1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 8, 7: 7, 8: 6}


def opencv_rgb(data):
    import cv2

    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("name", ["mpii_a_1280x720.jpg", "odd_517x333.jpg",
                                  "portrait_480x640.jpg",
                                  "yuv444_720x540.jpg"])
def test_plain_colour_kernel_is_libjpeg_bit_for_bit(name):
    """The plain version of the colour kernel (libjpeg's fancy upsampling
    and fixed-point YCbCr -> RGB) on libjpeg's own planes equals OpenCV's
    RGB decode exactly.  PIL (libjpeg-turbo) gives the planes: Y, and for
    4:4:4 the chroma, from a YCbCr decode; for 4:2:0 the chroma at its own
    resolution from a half-scale decode, where libjpeg runs the chroma's
    full 8x8 IDCT and upsamples nothing."""
    from PIL import Image

    data = fixture(name)
    h, w = jpeg.image_size(data)
    full = Image.open(io.BytesIO(data))
    full.draft("YCbCr", full.size)
    full = np.asarray(full)
    hf = vf = 1 if "444" in name else 2
    planes = full
    if hf == 2:
        half = Image.open(io.BytesIO(data))
        half.draft("YCbCr", (w // 2, h // 2))
        planes = np.asarray(half)
        assert planes.shape[:2] == (-(-h // 2), -(-w // 2))
    got = jpeg.ycc_to_rgb(*(torch.from_numpy(np.ascontiguousarray(p)) for p
                            in (full[..., 0], planes[..., 1],
                                planes[..., 2])), hf, vf)
    np.testing.assert_array_equal(got.numpy(), opencv_rgb(data))


@pytest.mark.cuda
def test_card_decode_against_the_goldens():
    """nvJPEG on the card: grayscale as three equal channels, crops within
    the chip_smoke.py gate of the JAX goldens (mean |d| <= 1.5 levels, at
    most 1% of pixels off by more than 8), a corrupt stream raising with
    its index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    datas = [fixture(n) for n in NAMES]
    images = jpeg.decode(datas, "cuda")
    for i, (name, data, img) in enumerate(zip(NAMES, datas, images)):
        h, w = jpeg.image_size(data)
        assert img.shape == (h, w, 3) and img.device.type == "cuda"
        if name.startswith("gray"):
            assert torch.equal(img[..., 0], img[..., 1])
            assert torch.equal(img[..., 0], img[..., 2])
        g = pp.draw_geometry(h, w, out_size=OUT, is_training=False,
                             resize_min=RMIN)
        crop = pp.apply_geometry(img, g, out_size=OUT, keep_uint8=True)
        golden = np.cumsum(GOLDEN["eval_image_dx"][i], axis=1,
                           dtype=np.uint8)
        diff = np.abs(crop.cpu().numpy().astype(int) - golden.astype(int))
        assert diff.mean() <= 1.5 and (diff > 8).mean() <= 0.01, name
    with pytest.raises(ValueError, match="JPEG 1"):
        jpeg.decode([datas[0], datas[1][:200]], "cuda")


@pytest.mark.cuda
def test_decode_behind_a_busy_stream_equals_a_serialized_decode():
    """nvJPEG's host stage of a decode rewrites its state's buffers while
    the card's stage of the state's last decode may still wait in stream
    order (behind the eval loop's forward, say); each decode must wait for
    the last one, or the images mix.  Decodes queued behind 10 ms of work
    equal decodes made one at a time on an idle card, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    datas = [fixture(n) for n in NAMES]
    want = []
    for data in datas:
        want.append(jpeg.decode([data], "cuda")[0])
        torch.cuda.synchronize()
    for _ in range(5):
        torch.cuda._sleep(20_000_000)
        got = jpeg.decode(datas, "cuda")
        torch.cuda.synchronize()
        for name, a, b in zip(NAMES, got, want):
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("order", [b"II", b"MM"])
def test_card_decode_applies_the_exif_orientation(order):
    """Each fixture with an EXIF orientation of 1-8 decodes on the card to
    the displayed shape (``image_size``); turned back, its eval crop holds
    the gate against the JAX golden of the plain stream.  OpenCV applies
    the orientation by the same flips and transposes, exactly
    (``tests/test_torch_records.py``), so this is the card's decode held
    against OpenCV's of the oriented stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for i, name in enumerate(NAMES):
        data = fixture(name)
        h, w = jpeg.image_size(data)
        g = pp.draw_geometry(h, w, out_size=OUT, is_training=False,
                             resize_min=RMIN)
        golden = np.cumsum(GOLDEN["eval_image_dx"][i], axis=1,
                           dtype=np.uint8)
        for orientation in range(1, 9):
            oriented = with_exif_orientation(data, orientation, order)
            img = jpeg.decode([oriented], "cuda")[0]
            assert img.shape == jpeg.image_size(oriented) + (3,)
            assert img.shape[:2] == ((w, h) if orientation >= 5 else (h, w))
            crop = pp.apply_geometry(jpeg.orient(img, UNDO[orientation]), g,
                                     out_size=OUT, keep_uint8=True)
            diff = np.abs(crop.cpu().numpy().astype(int)
                          - golden.astype(int))
            assert diff.mean() <= 1.5 and (diff > 8).mean() <= 0.01, \
                (name, orientation)


@pytest.mark.cuda
@pytest.mark.parametrize("h, w, hf, vf", [(720, 1280, 2, 2), (333, 517, 2, 2),
                                          (37, 5, 2, 2), (4, 3, 2, 2),
                                          (360, 481, 2, 1), (9, 4, 2, 1),
                                          (540, 720, 1, 1)])
def test_colour_kernel_equals_its_plain_version(h, w, hf, vf):
    """The kernel of csrc/jpeg_decode.cu against ycc_to_rgb_plain on the
    card, bit for bit, at odd sizes and on chroma planes wider than
    libjpeg's (nvJPEG may pad them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(h * w)
    y = torch.randint(0, 256, (h, w), dtype=torch.uint8, generator=g)
    cb, cr = (torch.randint(0, 256, (-(-h // vf) + 1, -(-w // hf) + 3),
                            dtype=torch.uint8, generator=g)
              for _ in range(2))
    want = jpeg.ycc_to_rgb_plain(y, cb, cr, hf, vf)
    jpeg.reset_counts()
    got = jpeg.ycc_to_rgb(y.cuda(), cb.cuda(), cr.cuda(), hf, vf)
    torch.cuda.synchronize()
    assert jpeg.launch_counts == {"ycc_to_rgb": 1}
    assert torch.equal(got.cpu(), want)
