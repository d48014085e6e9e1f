"""JPEG decode for the input pipeline: nvJPEG and a hand-written kernel on
a CUDA device (``csrc/jpeg_decode.cu``, built with ``nvcc`` at first use
and linked with the toolkit's ``libnvjpeg``), OpenCV on the CPU.

``decode(datas, device)`` gives one interleaved RGB uint8 (H, W, 3)
tensor a JPEG stream, on ``device``:

  * on a CUDA device nvJPEG decodes each image into planar Y, Cb and Cr
    tensors that torch's allocator owns, on the current stream, with one
    nvJPEG handle and state per host thread, kept for the life of the
    process (so decode on a bounded set of threads;
    :func:`decoder_count`); then :func:`ycc_to_rgb`, the
    kernel, upsamples the chroma and converts to RGB as libjpeg does
    (nvJPEG's own RGB output replicates the chroma of 4:2:0 and 4:2:2
    streams, 1-2% of an MPII image's pixels then lie more than 8 levels
    from OpenCV's).  4:4:4, 4:2:2, 4:2:0 and grayscale streams are
    supported; grayscale comes out as three equal channels (as
    ``cv2.IMREAD_COLOR`` gives it); any other stream (CMYK, 4:4:0, 4:1:1),
    or one nvJPEG refuses, raises with its index.  A failed build, a
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
import threading
from typing import Sequence

import numpy as np
import torch

from attentionalpoolingaction_torch.ops import _build

__all__ = ["LIBRARY", "decode", "decode_count", "decode_planes",
           "decoder_count", "image_size", "launch_counts", "orient",
           "reset_counts", "ycc_to_rgb", "ycc_to_rgb_plain"]

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
    lib.apj_ycc_to_rgb.argtypes = [p, i, p, p, i, i, i, i, i, p, p]
    lib.apj_ycc_to_rgb.restype = i
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
launch_counts = {"ycc_to_rgb": 0}
"""Launches of the colour kernel since the last reset."""


def decoder_count() -> int:
    """nvJPEG decoders made in this process: one for each host thread that
    decoded on a card, each kept until the process exits."""
    return LIBRARY.load().apj_decoder_count()


def reset_counts() -> None:
    global decode_count
    with _count_lock:
        decode_count = 0
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


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
               hf: int, vf: int) -> torch.Tensor:
    """uint8 (h, w, 3) RGB of a decoded colour JPEG's planes: luma (h, w)
    and chroma of at least (ceil(h / vf), ceil(w / hf)), subsampled by hf
    along x and vf along y (1 or 2).  On a CUDA tensor the kernel of
    ``csrc/jpeg_decode.cu``; on a CPU tensor the plain version."""
    if y.device.type != "cuda":
        return ycc_to_rgb_plain(y, cb, cr, hf, vf)
    h, w = y.shape
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if t.dtype != torch.uint8 or t.dim() != 2 or t.device != y.device \
                or t.stride(1) != 1:
            raise ValueError(f"{name}: want a uint8 plane with unit column "
                             f"stride on {y.device}, got {t.dtype} "
                             f"{tuple(t.shape)} {t.stride()}")
    if cb.shape != cr.shape or cb.stride() != cr.stride() or \
            cb.shape[0] < -(-h // vf) or cb.shape[1] < -(-w // hf):
        raise ValueError(f"chroma planes {tuple(cb.shape)} "
                         f"{tuple(cr.shape)} too small for ({h}, {w}) at "
                         f"{hf}x{vf}")
    lib = LIBRARY.load()
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(lib, lib.apj_ycc_to_rgb(
            y.data_ptr(), y.stride(0), cb.data_ptr(), cr.data_ptr(),
            cb.stride(0), hf, vf, w, h, out.data_ptr(), stream),
            "ycc_to_rgb launch")
    with _count_lock:
        launch_counts["ycc_to_rgb"] += 1
    return out


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
    global decode_count
    out = []
    for (y, cb, cr, sampling), orientation in zip(
            decode_planes(datas, device), orientations):
        if sampling is None:        # grayscale: three equal channels
            h, w = y.shape
            rgb = y[:, :, None].expand(h, w, 3)
        else:
            rgb = ycc_to_rgb(y, cb, cr, *sampling)
        out.append(orient(rgb, orientation))
    with _count_lock:
        decode_count += len(out)
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
