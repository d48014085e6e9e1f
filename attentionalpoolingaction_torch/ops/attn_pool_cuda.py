"""Fused attentional pooling on Hopper: wrappers around the CUDA kernels of
``csrc/attn_pool.cu``, their plain PyTorch versions and launch counters.

Port of the JAX package's ``ops/attn_pool_pallas.py``:

    saliency_summary(x, sal_w, sal_b) -> (v, s)
        s = X sal_w + sal_b  (B, P, N);  v = s^T X  (B, P, F)
    fused_pool_logits(x, attn_w, attn_b, sal_w, sal_b) -> (logits, v, s)
        saliency_summary, then the class projection
        logits = sum_p v_p A_p + (sum_n s_pn) alpha_p^T  (B, C)

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version beside it.  There is no fallback from
the kernel to the plain version.  The JAX package picks between its two
Pallas kernels by a VMEM budget on ``attn_w``; on Hopper the projection
is its own kernel whatever the size of ``attn_w``.

The kernels are forward only: a CUDA call that would need a gradient
raises (the backward is a later port).
"""

from __future__ import annotations

import threading

import torch

from attentionalpoolingaction_torch.ops import _build

MAX_RANK = 8
# shared memory a block may take on an H100 (227 KB)
_MAX_SMEM_BYTES = 232_448
_PROJ_IMAGES_PER_BLOCK = 4      # APA_PROJ_BT in csrc/attn_pool.cu
_PROJ_WARPS = 32                # APA_PROJ_WARPS in csrc/attn_pool.cu

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
launch_counts = {"saliency_summary": 0, "project_logits": 0}


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


# -- plain versions ----------------------------------------------------------

def saliency_summary_plain(x, sal_w, sal_b):
    """(v, s) by two einsums in float32: the arithmetic of the kernel.
    Contiguous, as the kernel's outputs are."""
    xf = x.to(torch.float32)
    s = torch.einsum("bnf,fp->bpn", xf, sal_w) + sal_b[None, :, None]
    v = torch.einsum("bpn,bnf->bpf", s, xf)
    return v.contiguous(), s.contiguous()


def project_logits_plain(v, s, attn_w_pfc, attn_b):
    """Class projection from (v, s) with ``attn_w`` laid out (P, F, C)."""
    return (torch.einsum("bpf,pfc->bc", v, attn_w_pfc)
            + s.sum(dim=2) @ attn_b.t())


# -- validation --------------------------------------------------------------

def _check(cond: bool, msg: str, exc=ValueError) -> None:
    if not cond:
        raise exc(msg)


def _check_f32(name: str, t: torch.Tensor, shape: tuple) -> None:
    _check(t.dtype == torch.float32,
           f"{name} must be float32, got {t.dtype}", TypeError)
    _check(tuple(t.shape) == shape,
           f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _check_cuda_operands(x: torch.Tensor, *others: torch.Tensor) -> None:
    for t in (x, *others):
        _check(t.device == x.device,
               f"operands on different devices: {t.device} and {x.device}")
        _check(t.is_contiguous(), "the kernels take contiguous tensors")
    _check(x.data_ptr() % 16 == 0,
           "x must be 16-byte aligned for the kernel's vector loads")


def _raise_if(err: int, what: str) -> None:
    if err != 0:
        msg = _build.load().apa_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")


def _check_no_grad(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the CUDA attentional pooling kernels are forward only; run "
            "under torch.no_grad() or torch.inference_mode()")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# -- wrappers ----------------------------------------------------------------

def saliency_summary(x, sal_w, sal_b):
    """x (B, N, F) float32 or bfloat16 -> v (B, P, F), s (B, P, N), f32."""
    _check(x.ndim == 3, f"x must be (B, N, F), got {tuple(x.shape)}")
    _check(x.dtype in _X_DTYPES,
           f"x must be float32 or bfloat16, got {x.dtype}", TypeError)
    b, n, f = x.shape
    _check(sal_w.ndim == 2, f"sal_w must be (F, P), got {tuple(sal_w.shape)}")
    p = sal_w.shape[1]
    _check(1 <= p <= MAX_RANK, f"rank {p} outside 1..{MAX_RANK}")
    _check_f32("sal_w", sal_w, (f, p))
    _check_f32("sal_b", sal_b, (p,))
    if x.device.type == "cpu":
        return saliency_summary_plain(x, sal_w, sal_b)
    _check(x.is_cuda, f"no kernel for device {x.device}")
    _check_cuda_operands(x, sal_w, sal_b)
    _check_no_grad(x, sal_w, sal_b)
    _check(f % 8 == 0, f"F={f} must be a multiple of 8 (16-byte loads)")
    _check((f * p + p * n) * 4 <= _MAX_SMEM_BYTES,
           f"sal_w and s ({f}x{p}, {p}x{n}) exceed a block's shared memory")
    v = torch.empty((b, p, f), dtype=torch.float32, device=x.device)
    s = torch.empty((b, p, n), dtype=torch.float32, device=x.device)
    if b == 0:
        return v, s
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.apa_saliency_summary(
            x.data_ptr(), _X_DTYPES[x.dtype], sal_w.data_ptr(),
            sal_b.data_ptr(), v.data_ptr(), s.data_ptr(), b, n, f, p,
            _stream())
    _raise_if(err, "saliency_summary")
    _count("saliency_summary")
    return v, s


def attn_w_pfc(attn_w):
    """The (P, F, C) copy of ``attn_w (F, C, P)`` that the projection
    kernel reads, coalesced over classes.  Made once per set of weights."""
    return attn_w.to(torch.float32).permute(2, 0, 1).contiguous()


def project_logits(v, s, w_pfc, attn_b):
    """v (B, P, F), s (B, P, N), w_pfc (P, F, C), attn_b (C, P) -> (B, C)."""
    _check(v.ndim == 3 and s.ndim == 3 and w_pfc.ndim == 3,
           "v, s and w_pfc must be 3-D")
    b, p, f = v.shape
    n = s.shape[2]
    c = w_pfc.shape[2]
    _check(1 <= p <= MAX_RANK, f"rank {p} outside 1..{MAX_RANK}")
    _check_f32("v", v, (b, p, f))
    _check_f32("s", s, (b, p, n))
    _check_f32("w_pfc", w_pfc, (p, f, c))
    _check_f32("attn_b", attn_b, (c, p))
    if v.device.type == "cpu":
        return project_logits_plain(v, s, w_pfc, attn_b)
    _check(v.is_cuda, f"no kernel for device {v.device}")
    _check_cuda_operands(v, s, w_pfc, attn_b)
    _check_no_grad(v, s, w_pfc, attn_b)
    tile = max(_PROJ_IMAGES_PER_BLOCK * f,
               _PROJ_WARPS * _PROJ_IMAGES_PER_BLOCK * 32)
    _check((_PROJ_IMAGES_PER_BLOCK * MAX_RANK + tile) * 4 <= _MAX_SMEM_BYTES,
           f"F={f} exceeds the projection kernel's shared memory")
    _check(b <= 65535 * _PROJ_IMAGES_PER_BLOCK,
           f"B={b} exceeds the projection kernel's grid")
    logits = torch.empty((b, c), dtype=torch.float32, device=v.device)
    if b == 0:
        return logits
    lib = _build.load()
    with torch.cuda.device(v.device):
        err = lib.apa_project_logits(
            v.data_ptr(), s.data_ptr(), w_pfc.data_ptr(), attn_b.data_ptr(),
            logits.data_ptr(), b, n, f, c, p, _stream())
    _raise_if(err, "project_logits")
    _count("project_logits")
    return logits


def fused_pool_logits(x, attn_w, attn_b, sal_w, sal_b, *, w_pfc=None):
    """(logits (B, C), v (B, P, F), s (B, P, N)), all float32.

    ``w_pfc`` is :func:`attn_w_pfc` of ``attn_w``, made once by a caller
    that serves the same weights many times; it is made here otherwise."""
    f, c, p = attn_w.shape
    _check_f32("attn_w", attn_w, (f, c, p))
    v, s = saliency_summary(x, sal_w, sal_b)
    if w_pfc is None:
        w_pfc = attn_w_pfc(attn_w)
    return project_logits(v, s, w_pfc, attn_b), v, s


def attentional_pool_fused(x, attn_w, attn_b, sal_w, sal_b, *, w_pfc=None):
    """Drop-in for ``ops.attn_pool.attentional_pool``: (B, C) float32."""
    return fused_pool_logits(x, attn_w, attn_b, sal_w, sal_b,
                             w_pfc=w_pfc)[0]
