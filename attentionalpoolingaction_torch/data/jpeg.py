"""JPEG decode for the input pipeline: nvJPEG and a hand-written kernel on
a CUDA device (``csrc/jpeg_decode.cu``, built with ``nvcc`` at first use
and linked with the toolkit's ``libnvjpeg``), OpenCV on the CPU.

``decode(datas, device)`` gives one interleaved RGB uint8 (H, W, 3)
tensor a JPEG stream, on ``device``:

  * on a CUDA device nvJPEG decodes each image into planar Y, Cb and Cr
    tensors that torch's allocator owns, on the current stream, with one
    nvJPEG handle and state per host thread, kept for the life of the
    process (so decode on a bounded set of threads;
    :func:`decoder_count`); then :func:`ycc_to_rgb_batch`, the
    kernel, upsamples the chroma and converts to RGB as libjpeg does
    (nvJPEG's own RGB output replicates the chroma of 4:2:0 and 4:2:2
    streams, 1-2% of an MPII image's pixels then lie more than 8 levels
    from OpenCV's), every colour image of the call in one launch.
    4:4:4, 4:2:2, 4:2:0 and grayscale streams are supported; grayscale
    comes out as three equal channels (as ``cv2.IMREAD_COLOR`` gives it);
    any other stream (CMYK, 4:4:0, 4:1:1), or one nvJPEG refuses, raises
    with its index.  A failed build, a
    missing ``libnvjpeg`` or a decode error raises; nothing falls back to
    the CPU.
  * on the CPU, the plain version: ``cv2.imdecode(IMREAD_COLOR)`` and
    ``cvtColor(BGR2RGB)``, the JAX package's ``decode_jpeg``.  OpenCV is
    imported there only.

``cv2.imdecode(IMREAD_COLOR)`` applies a stream's EXIF orientation (a
mirror, a rotation or a transpose); nvJPEG does not, so on the card
:func:`orient` applies it to the decoded (H, W, 3) tensor as OpenCV does,
and both paths give the displayed image.  The geometry is drawn from the
displayed size (``image_size``: the frame header's, height and width
swapped for the orientations 5-8 that transpose).
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Sequence

import numpy as np
import torch

from attentionalpoolingaction_torch.ops import _build

__all__ = ["LIBRARY", "YccBatchPlan", "decode", "decode_calls",
           "decode_count", "decode_planes", "decoder_count", "frame_size",
           "image_size",
           "launch_counts", "orient", "reset_counts", "ycc_batch_plan",
           "ycc_images", "ycc_to_rgb", "ycc_to_rgb_batch",
           "ycc_to_rgb_plain"]

# nvjpegChromaSubsampling_t
_CSS_NAMES = {0: "4:4:4", 1: "4:2:2", 2: "4:2:0", 3: "4:4:0", 4: "4:1:1",
              5: "4:1:0", 6: "gray", 7: "4:1:0V", -1: "unknown"}
_CSS_GRAY = 6
# chroma subsampling (along x, along y) of the colour streams supported
_SAMPLING = {0: (1, 1), 1: (2, 1), 2: (2, 2)}
# start-of-frame markers: SOF0-SOF15 but DHT (C4), JPG (C8) and DAC (CC)
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.apj_image_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ip, ip,
                                   ip, ip, ip, ip]
    lib.apj_image_info.restype = i
    lib.apj_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, i, p, i, p,
                               p, i, p]
    lib.apj_decode.restype = i
    lib.apj_ycc_to_rgb_batch.argtypes = [p, p, i, i, ctypes.c_longlong, p]
    lib.apj_ycc_to_rgb_batch.restype = i
    lib.apj_error_string.argtypes = [i]
    lib.apj_error_string.restype = ctypes.c_char_p
    lib.apj_decoder_count.argtypes = []
    lib.apj_decoder_count.restype = i
    return lib


def _link_flags(compiler: str) -> tuple[str, ...]:
    lib_dir = _build.cuda_home() / "lib64"
    return ("-lnvjpeg", "-Xlinker", f"-rpath,{lib_dir}")


LIBRARY = _build.NativeLibrary(
    "jpeg_decode", _build.CSRC / "jpeg_decode.cu", compiler=_build.nvcc,
    flags=_build.NVCC_FLAGS, bind=_bind, link_flags=_link_flags)

_count_lock = threading.Lock()
decode_count = 0
"""Images decoded on a CUDA device (by nvJPEG) since the last reset."""
decode_calls = 0
"""Calls of :func:`decode` on a CUDA device since the last reset."""
launch_counts = {"ycc_to_rgb": 0}
"""Launches of the colour kernel since the last reset: one a
:func:`ycc_to_rgb_batch` call on the card, so one a :func:`decode` call
that holds a colour image."""
ycc_images = 0
"""Images the colour kernel converted since the last reset."""


def decoder_count() -> int:
    """nvJPEG decoders made in this process: one for each host thread that
    decoded on a card, each kept until the process exits."""
    return LIBRARY.load().apj_decoder_count()


def reset_counts() -> None:
    global decode_count, decode_calls, ycc_images
    with _count_lock:
        decode_count = decode_calls = ycc_images = 0
        launch_counts["ycc_to_rgb"] = 0


def _check(lib, err: int, what: str) -> None:
    if err:
        raise ValueError(f"{what} ({lib.apj_error_string(err).decode()})")


def _exif_orientation(segment: bytes) -> int | None:
    """The orientation tag (0x0112) of IFD0 of an APP1 segment's payload:
    None where the segment is not EXIF, 1 where it has no such tag."""
    tiff = segment[6:]
    if segment[:6] != b"Exif\x00\x00" or tiff[:2] not in (b"II", b"MM"):
        return None
    order = "little" if tiff[:2] == b"II" else "big"
    ifd = int.from_bytes(tiff[4:8], order)
    count = int.from_bytes(tiff[ifd:ifd + 2], order)
    for entry in range(ifd + 2, ifd + 2 + 12 * count, 12):
        if int.from_bytes(tiff[entry:entry + 2], order) == 0x0112:
            return int.from_bytes(tiff[entry + 8:entry + 10], order)
    return 1


def _header(data: bytes) -> tuple[int, int, int]:
    """(height, width, EXIF orientation) from a JPEG stream's markers up
    to the first scan, without decoding: the frame header's size and the
    orientation of the first EXIF APP1 segment (1 without one)."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI marker)")
    pos, n, size, orientation = 2, len(data), None, None
    while pos + 4 <= n:             # the markers up to the first scan
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG stream at byte {pos}")
        while pos < n and data[pos] == 0xFF:        # fill bytes
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:  # no length
            continue
        if marker == 0xDA:          # start of scan
            break
        length = int.from_bytes(data[pos:pos + 2], "big")
        if marker == 0xE1 and orientation is None:     # APP1: EXIF
            orientation = _exif_orientation(data[pos + 2:pos + length])
        if marker in _SOF and size is None and pos + 7 <= n:
            size = (int.from_bytes(data[pos + 3:pos + 5], "big"),
                    int.from_bytes(data[pos + 5:pos + 7], "big"))
        pos += length
    if size is None:
        raise ValueError("JPEG stream has no frame header")
    # OpenCV leaves a stream with a tag outside 1-8 as it is
    return (*size, orientation if orientation in range(1, 9) else 1)


def frame_size(data: bytes) -> tuple[int, int]:
    """(height, width) of a JPEG stream's frame header, without decoding
    and whatever its EXIF orientation: the shape
    ``tf.io.extract_jpeg_shape`` gives, which the dataset converters
    store."""
    return _header(data)[:2]


def image_size(data: bytes) -> tuple[int, int]:
    """(height, width) of a JPEG stream as displayed, without decoding:
    the frame header's size, swapped for an EXIF orientation that
    transposes (5-8), so that it is the shape :func:`decode` gives."""
    h, w, orientation = _header(data)
    return (w, h) if orientation >= 5 else (h, w)


def orient(image: torch.Tensor, orientation: int) -> torch.Tensor:
    """An (H, W, C) image as displayed under its EXIF ``orientation``,
    OpenCV's ``ExifTransform``: 2 mirrors left-right, 3 turns 180
    degrees, 4 mirrors top-bottom; 5-8 transpose first, then 6 mirrors
    left-right, 7 turns 180 degrees and 8 mirrors top-bottom."""
    if orientation >= 5:
        image = image.transpose(0, 1)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    if orientation in flips:
        image = image.flip(flips[orientation])
    return image.contiguous()


def _fancy_upsample(c: torch.Tensor, hf: int, vf: int, h: int,
                    w: int) -> torch.Tensor:
    """libjpeg's ``h2v1``/``h2v2`` fancy upsampling (jdsample.c) of an
    int32 chroma plane to (h, w); replication where it is 2 samples wide
    or less."""
    if hf == vf == 1:
        return c[:h, :w]
    if c.shape[1] <= 2:
        return c.repeat_interleave(vf, 0).repeat_interleave(hf, 1)[:h, :w]
    if vf == 2:     # column sums of the nearer row x3 and the farther one
        rows = (3 * c + torch.cat([c[:1], c[:-1]]),
                3 * c + torch.cat([c[1:], c[-1:]]))
        shift, bias = 4, (8, 7)
    else:
        rows, shift, bias = (c,), 2, (1, 2)
    out = c.new_empty((c.shape[0] * vf, c.shape[1] * 2))
    for v, s in enumerate(rows):
        left = torch.cat([s[:, :1], s[:, :-1]], 1)
        right = torch.cat([s[:, 1:], s[:, -1:]], 1)
        out[v::vf, 0::2] = (3 * s + left + bias[0]) >> shift
        out[v::vf, 1::2] = (3 * s + right + bias[1]) >> shift
    return out[:h, :w]


def ycc_to_rgb_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                     hf: int, vf: int) -> torch.Tensor:
    """The plain version of the colour kernel: libjpeg's fancy upsampling
    of the (ceil(h / vf), ceil(w / hf)) chroma planes and its fixed-point
    YCbCr -> RGB (jdcolor.c) of uint8 planes, on their device.  Returns
    uint8 (h, w, 3)."""
    h, w = y.shape
    cw, ch = -(-w // hf), -(-h // vf)
    luma = y.to(torch.int32)
    cb, cr = (_fancy_upsample(p[:ch, :cw].to(torch.int32), hf, vf, h, w)
              - 128 for p in (cb, cr))
    rgb = torch.stack([luma + ((91881 * cr + 32768) >> 16),
                       luma + ((-22554 * cb + 32768 - 46802 * cr) >> 16),
                       luma + ((116130 * cb + 32768) >> 16)], -1)
    return rgb.clamp_(0, 255).to(torch.uint8)


# The colour kernel's batch table (csrc/jpeg_decode.cu): a descriptor of
# 12 int64 words an image (y, cb, cr, out pointers, y_pitch, c_pitch, w,
# h, hf, vf, cw, ch), then a tile of 5 int32 words a block (image, k_lo,
# k_hi, c_lo, c_rows): the image's 16-pixel groups [k_lo, k_hi) and the
# chroma rows [c_lo, c_lo + c_rows) they read.
_GROUP = 16
_MAX_SMEM_BYTES = 232_448       # shared memory a block may take on an H100
_SMS = 132                      # SMs on an H100 SXM
_TILE_GROUPS = (1024, 512, 256)


@dataclasses.dataclass(frozen=True)
class YccBatchPlan:
    table: np.ndarray     # int64: the descriptors, then the tiles (int32)
    n_images: int
    n_tiles: int          # blocks of the launch
    tile_groups: int      # 16-pixel groups a tile (an image's last tile,
                          # and those of images too wide for it, hold fewer)
    smem_bytes: int       # the largest tile's two planes of chroma rows


def _tiles(w, h, vf, ch, size) -> np.ndarray:
    """The tiles of every image, image by image: image ``i``'s groups in
    runs of ``size[i]`` (its last run shorter), as an int64 (T, 5) array of
    image, k_lo, k_hi, and the chroma rows the run's pixels read (their
    own rows and, at h2v2, one more on each side): first and count.  The
    arguments are int64 arrays, one entry an image."""
    k_all = -(-w * h // _GROUP)
    runs = -(-k_all // size)
    img = np.repeat(np.arange(len(w)), runs)
    j = np.arange(runs.sum()) - np.repeat(np.cumsum(runs) - runs, runs)
    w, h, vf, ch, size, k_all = (a[img] for a in (w, h, vf, ch, size, k_all))
    k_lo = j * size
    k_hi = np.minimum(k_lo + size, k_all)
    ra = _GROUP * k_lo // w
    rb = (np.minimum(_GROUP * k_hi, w * h) - 1) // w
    c_lo = np.where(vf == 2, np.maximum(ra // 2 - 1, 0), ra)
    c_hi = np.where(vf == 2, np.minimum(rb // 2 + 1, ch - 1), rb)
    return np.stack([img, k_lo, k_hi, c_lo, c_hi - c_lo + 1], axis=1)


def ycc_batch_plan(images: Sequence[tuple], sms: int = _SMS) -> YccBatchPlan:
    """The table of one ``ycc_to_rgb`` launch over ``images``, each
    ``(y_ptr, cb_ptr, cr_ptr, out_ptr, y_pitch, c_pitch, w, h, hf, vf)``.

    Each image's ceil(h w / 16) groups are cut into tiles of
    ``tile_groups`` groups (the last of an image shorter), in image order;
    ``tile_groups`` is the largest of 1024, 512, 256 that gives 4 tiles an
    SM, else 256.  An image whose tiles' two planes of chroma rows would
    not fit a block's shared memory gets tiles half as long until they
    do; an image wider than 58,112 pixels, where one group's may not fit,
    raises ``ValueError``.  Plain Python: the CPU tests check it, and the C
    entry point checks it again before the launch."""
    _check_arg(len(images) > 0, "no images")
    desc = np.asarray(images, np.int64).reshape(len(images), 10)
    w, h, hf, vf = desc[:, 6:10].T
    for hw_, vw_ in set(zip(hf.tolist(), vf.tolist())):
        _check_arg((hw_, vw_) in _SAMPLING.values(),
                   f"chroma sampling {hw_}x{vw_} is not 4:4:4, 4:2:2 or "
                   f"4:2:0")
    _check_arg(bool(((w > 0) & (h > 0) & (w * h < 2 ** 31)).all()),
               "an image outside 1 .. 2^31 - 1 pixels")
    cw, ch = -(-w // hf), -(-h // vf)
    k_all = -(-w * h // _GROUP)
    tile_groups = next((t for t in _TILE_GROUPS
                        if int((-(-k_all // t)).sum()) >= 4 * sms),
                       _TILE_GROUPS[-1])
    size = np.full(len(images), tile_groups, np.int64)
    while True:
        tiles = _tiles(w, h, vf, ch, size)
        need = 2 * tiles[:, 4] * cw[tiles[:, 0]]
        over = np.unique(tiles[need > _MAX_SMEM_BYTES, 0])
        if not over.size or (size[over] == 1).all():
            break
        size[over] = np.maximum(size[over] // 2, 1)
    _check_arg(not over.size, "chroma rows of an image wider than 58,112 "
               "pixels exceed a block's shared memory")
    tile_words = tiles.astype(np.int32).reshape(-1)
    if tile_words.size % 2:
        tile_words = np.append(tile_words, np.int32(0))
    table = np.concatenate([np.concatenate([desc, cw[:, None], ch[:, None]],
                                           axis=1).reshape(-1),
                            tile_words.view(np.int64)])
    return YccBatchPlan(table=table, n_images=len(images),
                        n_tiles=len(tiles), tile_groups=tile_groups,
                        smem_bytes=max(16, -(-int(need.max()) // 16) * 16))


def _check_arg(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def ycc_to_rgb_batch(planes: Sequence[tuple]) -> list[torch.Tensor]:
    """uint8 (h, w, 3) RGB of decoded colour JPEGs' planes, each ``(y,
    cb, cr, (hf, vf))`` as :func:`decode_planes` gives it: luma (h, w) and
    chroma of at least (ceil(h / vf), ceil(w / hf)), subsampled by hf along
    x and vf along y (4:4:4, 4:2:2 or 4:2:0).  On CUDA tensors one launch
    of the kernel of ``csrc/jpeg_decode.cu`` converts them all; on CPU
    tensors the plain version converts each."""
    if not planes:
        return []
    device = planes[0][0].device
    if device.type != "cuda":
        return [ycc_to_rgb_plain(y, cb, cr, *sampling)
                for y, cb, cr, sampling in planes]
    outs, images = [], []
    for i, (y, cb, cr, (hf, vf)) in enumerate(planes):
        for name, t in (("y", y), ("cb", cb), ("cr", cr)):
            if t.dtype != torch.uint8 or t.dim() != 2 or \
                    t.device != device or t.stride(1) != 1:
                raise ValueError(
                    f"image {i} {name}: want a uint8 plane with unit column "
                    f"stride on {device}, got {t.dtype} {tuple(t.shape)} "
                    f"{t.stride()} on {t.device}")
        h, w = y.shape
        if cb.shape != cr.shape or cb.stride() != cr.stride() or \
                cb.shape[0] < -(-h // vf) or cb.shape[1] < -(-w // hf):
            raise ValueError(f"image {i}: chroma planes {tuple(cb.shape)} "
                             f"{tuple(cr.shape)} too small for ({h}, {w}) "
                             f"at {hf}x{vf}")
        out = torch.empty((h, w, 3), dtype=torch.uint8, device=device)
        outs.append(out)
        images.append((y.data_ptr(), cb.data_ptr(), cr.data_ptr(),
                       out.data_ptr(), y.stride(0), cb.stride(0), w, h, hf,
                       vf))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = ycc_batch_plan(images, sms)
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        # the host copy is checked by the entry point; the device copy,
        # made in stream order, is the kernel's
        host = torch.from_numpy(plan.table).pin_memory()
        table = host.to(device, non_blocking=True)
        stream = torch.cuda.current_stream().cuda_stream
        _check(lib, lib.apj_ycc_to_rgb_batch(
            host.data_ptr(), table.data_ptr(), plan.n_images, plan.n_tiles,
            plan.smem_bytes, stream), "ycc_to_rgb launch")
    global ycc_images
    with _count_lock:
        launch_counts["ycc_to_rgb"] += 1
        ycc_images += len(outs)
    return outs


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
               hf: int, vf: int) -> torch.Tensor:
    """:func:`ycc_to_rgb_batch` of one image."""
    return ycc_to_rgb_batch([(y, cb, cr, (hf, vf))])[0]


def _decode_cpu(data: bytes, index: int) -> torch.Tensor:
    import cv2

    arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if arr is None:
        raise ValueError(f"JPEG {index}: decode failed")
    return torch.from_numpy(cv2.cvtColor(arr, cv2.COLOR_BGR2RGB))


def decode_planes(datas: Sequence[bytes], device) -> list[tuple]:
    """nvJPEG's decode of each stream on a CUDA ``device``, before the
    colour kernel: ``(y, cb, cr, (hf, vf))`` of uint8 planes for a colour
    stream, ``(y, None, None, None)`` for a grayscale one."""
    device = torch.device(device)
    lib = LIBRARY.load()
    out = []
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for i, data in enumerate(datas):
            data = bytes(data)
            info = [ctypes.c_int() for _ in range(6)]
            _check(lib, lib.apj_image_info(data, len(data),
                                           *map(ctypes.byref, info)),
                   f"JPEG {i}: nvJPEG cannot read it")
            comps, css, w, h, cw, ch = (v.value for v in info)
            gray = comps == 1 or css == _CSS_GRAY
            if not gray and (comps != 3 or css not in _SAMPLING):
                raise ValueError(
                    f"JPEG {i}: unsupported stream, {comps} components, "
                    f"{_CSS_NAMES.get(css, css)} chroma")
            y = torch.empty((h, w), dtype=torch.uint8, device=device)
            if gray:
                _check(lib, lib.apj_decode(data, len(data), 1, y.data_ptr(),
                                           w, None, None, 0, stream),
                       f"JPEG {i}: nvJPEG decode failed")
                out.append((y, None, None, None))
                continue
            cb, cr = (torch.empty((ch, cw), dtype=torch.uint8, device=device)
                      for _ in range(2))
            _check(lib, lib.apj_decode(data, len(data), 0, y.data_ptr(), w,
                                       cb.data_ptr(), cr.data_ptr(), cw,
                                       stream),
                   f"JPEG {i}: nvJPEG decode failed")
            out.append((y, cb, cr, _SAMPLING[css]))
    return out


def _decode_cuda(datas: Sequence[bytes], device: torch.device,
                 orientations: Sequence[int]) -> list[torch.Tensor]:
    """nvJPEG's planes of every stream, then one colour-kernel launch for
    all the colour ones; grayscale streams as three equal channels."""
    global decode_count, decode_calls
    planes = decode_planes(datas, device)
    colour = iter(ycc_to_rgb_batch([p for p in planes if p[3] is not None]))
    out = []
    for (y, _, _, sampling), orientation in zip(planes, orientations):
        if sampling is None:
            h, w = y.shape
            rgb = y[:, :, None].expand(h, w, 3)
        else:
            rgb = next(colour)
        out.append(orient(rgb, orientation))
    with _count_lock:
        decode_count += len(out)
        decode_calls += 1
    return out


def decode(datas: Sequence[bytes], device) -> list[torch.Tensor]:
    """RGB uint8 (H, W, 3) tensors of the JPEG streams ``datas`` on
    ``device``: nvJPEG on a CUDA device, OpenCV on the CPU, each with
    the stream's EXIF orientation applied."""
    device = torch.device(device)
    orientations = []
    for i, data in enumerate(datas):
        try:
            orientations.append(_header(data)[2])
        except ValueError as e:
            raise ValueError(f"JPEG {i}: {e}") from None
    if device.type == "cpu":
        return [_decode_cpu(d, i) for i, d in enumerate(datas)]
    if device.type != "cuda":
        raise ValueError(f"JPEG decode runs on cuda or cpu, not {device}")
    return _decode_cuda(datas, device, orientations)
