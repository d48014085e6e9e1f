"""The JPEG decode's colour kernel (``csrc/jpeg_decode.cu``) and its
plain version, and the decode on the card against the JAX pipeline.

  * On the CPU, the plain version (libjpeg's fancy chroma upsampling and
    fixed-point YCbCr -> RGB in torch ops) on libjpeg's own planes equals
    OpenCV's RGB decode bit for bit.
  * On the CPU, a batch of mixed sizes and samplings through
    ``ycc_to_rgb_batch`` equals each image's plain version bit for bit,
    and the batch's descriptor and tile table (``ycc_batch_plan``) has the
    layout ``csrc/jpeg_decode.cu`` reads.
  * On the card (marked ``cuda``; run with ``python -m pytest --noconftest
    -m cuda tests/test_torch_jpeg_kernel.py``, this file imports no JAX):
    the kernel equals its plain version bit for bit at odd sizes and
    padded planes, one launch for a mixed batch and one for a ``decode``
    call, and nvJPEG + the kernel + the preprocessing hold the
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


# (h, w, hf, vf): 4:2:0, 4:2:2 and 4:4:4 at MPII's size, odd sizes, widths
# below a 16-pixel group and at the 2-sample chroma that replicates
MIXED = [(720, 1280, 2, 2), (333, 517, 2, 2), (37, 5, 2, 2), (4, 3, 2, 2),
         (360, 481, 2, 1), (9, 4, 2, 1), (540, 720, 1, 1), (17, 33, 1, 1),
         (31, 16, 2, 2)]


def mixed_planes(seed, device="cpu"):
    """Random planes of MIXED, the chroma planes one row and up to four
    columns larger than libjpeg's (nvJPEG may pad them)."""
    g = torch.Generator().manual_seed(seed)
    planes = []
    for h, w, hf, vf in MIXED:
        y = torch.randint(0, 256, (h, w), dtype=torch.uint8, generator=g)
        pad = int(torch.randint(0, 5, (1,), generator=g))
        cb, cr = (torch.randint(0, 256, (-(-h // vf) + 1, -(-w // hf) + pad),
                                dtype=torch.uint8, generator=g)
                  for _ in range(2))
        planes.append((y.to(device), cb.to(device), cr.to(device), (hf, vf)))
    return planes


def test_batch_on_the_cpu_is_each_images_plain_version():
    planes = mixed_planes(0)
    jpeg.reset_counts()
    got = jpeg.ycc_to_rgb_batch(planes)
    assert jpeg.launch_counts == {"ycc_to_rgb": 0} and jpeg.ycc_images == 0
    assert len(got) == len(planes)
    for (y, cb, cr, sampling), rgb in zip(planes, got):
        assert rgb.shape == (*y.shape, 3) and rgb.dtype == torch.uint8
        assert torch.equal(rgb, jpeg.ycc_to_rgb_plain(y, cb, cr, *sampling))
    assert jpeg.ycc_to_rgb_batch([]) == []


@pytest.mark.parametrize("sms", [132, 8, 1])
def test_batch_table_layout(sms):
    """ycc_batch_plan's table: a descriptor of 12 int64 words an image
    (y, cb, cr, out, y_pitch, c_pitch, w, h, hf, vf, cw, ch), then a tile
    of 5 int32 words a block (image, k_lo, k_hi, c_lo, c_rows); the tiles
    cover each image's ceil(h w / 16) pixel groups once, in order, with
    the chroma rows those groups read; shared memory holds the largest
    tile's rows of both planes."""
    images = [(1000 + i, 2000 + i, 3000 + i, 4096 * (i + 1), w + i % 3,
               -(-w // hf) + 2, w, h, hf, vf)
              for i, (h, w, hf, vf) in enumerate(MIXED)]
    plan = jpeg.ycc_batch_plan(images, sms)
    n = len(images)
    assert plan.table.dtype == np.int64 and plan.n_images == n
    desc = plan.table[:12 * n].reshape(n, 12)
    for d, im in zip(desc, images):
        w, h, hf, vf = im[6:10]
        assert tuple(d[:10]) == im
        assert tuple(d[10:]) == (-(-w // hf), -(-h // vf))
    tiles = plan.table[12 * n:].view(np.int32)
    assert tiles.size in (5 * plan.n_tiles, 5 * plan.n_tiles + 1)
    tiles = tiles[:5 * plan.n_tiles].reshape(-1, 5)
    groups = [-(-h * w // 16) for h, w, _, _ in MIXED]
    want_groups = next((t for t in (1024, 512, 256)
                        if sum(-(-k // t) for k in groups) >= 4 * sms), 256)
    assert plan.tile_groups == want_groups
    assert sum(int(t[2] - t[1]) for t in tiles) == sum(groups)
    nxt = {}
    for img, k_lo, k_hi, c_lo, c_rows in tiles.tolist():
        h, w, hf, vf = MIXED[img]
        assert k_lo == nxt.get(img, 0) and img >= max(nxt, default=0)
        assert 0 < k_hi - k_lo <= plan.tile_groups
        nxt[img] = k_hi
        # rows of the tile's pixels, and their chroma rows
        rows = range(16 * k_lo // w, (min(16 * k_hi, h * w) - 1) // w + 1)
        need = set()
        for r in rows:
            i = r // vf
            need.add(i)
            if vf == 2:
                need.add(min(i + 1, -(-h // 2) - 1) if r % 2
                         else max(i - 1, 0))
        assert c_lo <= min(need) and c_lo + c_rows - 1 >= max(need)
        assert c_lo + c_rows <= -(-h // vf)
        assert 2 * c_rows * -(-w // hf) <= plan.smem_bytes
    assert nxt == dict(enumerate(groups))
    assert plan.smem_bytes % 16 == 0 and plan.smem_bytes <= 232_448


def test_batch_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="sampling"):
        jpeg.ycc_batch_plan([(1, 1, 1, 16, 8, 8, 8, 8, 1, 2)])
    # a group across the end of an odd row of a 4:2:0 image 60,001 pixels
    # wide reads 4 chroma rows of 30,001 bytes, in each plane
    with pytest.raises(ValueError, match="shared memory"):
        jpeg.ycc_batch_plan([(1, 1, 1, 16, 60001, 30001, 60001, 9, 2, 2)])
    assert jpeg.ycc_batch_plan(
        [(1, 1, 1, 16, 58112, 29056, 58112, 9, 2, 2)]).smem_bytes <= 232_448
    with pytest.raises(ValueError):
        jpeg.ycc_batch_plan([])


@pytest.mark.cuda
def test_batched_colour_kernel_equals_its_plain_version():
    """One launch converts a batch of mixed sizes and samplings, each image
    equal to its plain version bit for bit; two launches, the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    planes = mixed_planes(1)
    card = [(y.cuda(), cb.cuda(), cr.cuda(), s) for y, cb, cr, s in planes]
    jpeg.reset_counts()
    got = jpeg.ycc_to_rgb_batch(card)
    again = jpeg.ycc_to_rgb_batch(card)
    torch.cuda.synchronize()
    assert jpeg.launch_counts == {"ycc_to_rgb": 2}
    assert jpeg.ycc_images == 2 * len(planes)
    for (y, cb, cr, sampling), a, b in zip(planes, got, again):
        assert a.is_contiguous() and a.shape == (*y.shape, 3)
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), jpeg.ycc_to_rgb_plain(y, cb, cr,
                                                          *sampling))


@pytest.mark.cuda
def test_decode_launches_the_colour_kernel_once_a_call():
    """decode() of every fixture, grayscale among them: one colour launch
    for the call, one image converted for each colour stream, the same
    images as decoded one at a time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    datas = [fixture(n) for n in NAMES]
    one_by_one = [jpeg.decode([d], "cuda")[0] for d in datas]
    jpeg.reset_counts()
    images = jpeg.decode(datas, "cuda")
    torch.cuda.synchronize()
    colour = sum(not n.startswith("gray") for n in NAMES)
    assert jpeg.launch_counts == {"ycc_to_rgb": 1}
    assert jpeg.ycc_images == colour and jpeg.decode_calls == 1
    assert jpeg.decode_count == len(datas)
    for name, a, b in zip(NAMES, images, one_by_one):
        assert torch.equal(a, b), name
