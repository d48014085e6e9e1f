"""Fused attentional pooling on Hopper: wrappers around the CUDA kernels of
``csrc/attn_pool.cu`` and ``csrc/attn_pool_backward.cu``, and their plain
PyTorch versions.

Port of the JAX package's ``ops/attn_pool_pallas.py``:

    saliency_summary(x, sal_w, sal_b) -> (v, s)
        s = X sal_w + sal_b  (B, P, N);  v = s^T X  (B, P, F)
    fused_pool_logits(x, attn_w, attn_b, sal_w, sal_b) -> (logits, v, s)
        saliency_summary, then the class projection
        logits = sum_p v_p A_p + (sum_n s_pn) alpha_p^T  (B, C)

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version beside it.  There is no fallback from
the kernel to the plain version.  The two forward kernels are the custom
ops ``apa::saliency_summary`` and ``apa::project_logits``
(``torch.library``), which ``torch.export`` keeps as nodes of a program
(``export.py``); the backward's ``pool_backward`` is a plain ctypes
call, since nothing exported runs a backward.  The JAX package picks
between its two Pallas kernels by a VMEM budget on ``attn_w``; on Hopper
the projection is its own kernel whatever the size of ``attn_w``.

Gradients: :class:`AttentionalPoolFn` runs both kernels in its forward
and saves ``x, attn_b, sal_w, v, s`` as the JAX package's custom VJP does
(``_fused_fwd``), with the kernel's (P, F, C) copy of ``attn_w`` in place
of ``attn_w``.  Its backward, :func:`fused_pool_backward`, computes
``_fused_bwd``: two products that are no pass over X (``dv = g A`` and
``d_attn_w``) as cuBLAS calls, as the JAX package leaves them to XLA, and
the pass over X (``ds = X dv``, ``d_sal_w = X^T ds``, ``dx``) with the
small ``g alpha`` and ``d_attn_b`` as the hand-written ``pool_backward``
kernel, which reads X once; :func:`fused_pool_backward_plain` is its plain
version, einsums in float32 line for line as ``_fused_bwd``.
The wrappers themselves take no gradient: called directly under grad on
CUDA tensors that need one, they raise.
"""

from __future__ import annotations

import dataclasses

import torch

from attentionalpoolingaction_torch.ops import _build

MAX_RANK = 8
# shared memory a block may take on an H100 (227 KB)
_MAX_SMEM_BYTES = 232_448
# what a CTA of a saliency cluster may take to keep X's slice resident: half
# an SM with its 1 KB system reservation, so two CTAs share an SM.  Above
# it each CTA of a 16-CTA cluster needs an SM of its own, fewer clusters fit
# the card at once (cudaOccupancyMaxActiveClusters), and 8 images take two
# waves.
_RESIDENT_SMEM_BYTES = 232_448 // 2 - 1024
_SMS = 132                      # SMs on an H100 SXM
_CLUSTERS = (1, 2, 4, 8, 16)    # cluster sizes; 16 is non-portable
# constants of csrc/attn_pool.cu
_SAL_THREADS = 256              # APA_SAL_THREADS
_SAL_MIN_R2 = 4                 # phase-2 row classes a resident CTA holds
_PROJ_WARPS = 8                 # APA_PROJ_WARPS
_PROJ_COLS = 32                 # APA_PROJ_COLS
_PROJ_STAGE = 32                # APA_PROJ_STAGE
_PROJ_AROW = 36                 # APA_PROJ_AROW
_PROJ_MAX_BT = 32               # the longest image tile the kernel takes
_BWD_STATIC_SMEM = 4 * MAX_RANK  # csrc/attn_pool_backward.cu: dssum[P]

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
           "operands must be 16-byte aligned for the kernels' 16-byte "
           "accesses")


def _raise_if(err: int, what: str, error_string) -> None:
    """Raise where a C entry point returned a cudaError; ``error_string``
    is its library's ``ap*_error_string``."""
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")


def _check_no_grad(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the CUDA attentional pooling kernels take no gradient "
            "themselves; call attentional_pool_fused (AttentionalPoolFn) "
            "to train, or run under torch.no_grad()")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# -- launch plans --------------------------------------------------------------
#
# Plain functions of the shapes, so that the CPU tests reach them; the C
# entry points check each plan against the kernel's own layout.

def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _align16(nbytes: int) -> int:
    return _ceil(nbytes, 16) * 16


def _fill_ctas(sms: int) -> int:
    """CTAs that count as filling the card: one on every other SM.  More,
    smaller CTAs bought nothing on the H100: each adds its share of the
    cluster's barriers and exchange (PERF.md, PR 2)."""
    return sms // 2


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """The launch plan of a kernel that takes one image over a cluster of
    CTAs along F: ``saliency_summary`` and ``pool_backward``."""
    cluster: int      # CTAs an image, each owning f_slice columns of F
    f_slice: int
    path: str         # "resident": X read from HBM once; "l2_reread"
    r2: int           # row classes of phase 2, met in shared memory
    smem_bytes: int
    grid: int         # CTAs: B * cluster


def _lane_groups(p: int, vec: int) -> int:
    """16-byte column groups a lane owns in phase 1 (``lane_groups`` in
    csrc/attn_pool_common.cuh): the most of 4, 2, 1 whose sal_w (or dv)
    fits 64 registers."""
    return next(j for j in (4, 2, 1) if 64 // (p * vec) >= j or j == 1)


def _cluster_smem(n, fs, p, itemsize, resident, r2, pn_buffers) -> int:
    """``saliency_smem_bytes`` of csrc/attn_pool_common.cuh: X's slice where
    resident, ``pn_buffers`` (P, N) float buffers (the saliency kernel's
    partial and summed s; the backward's partial and summed ds and s), the
    phase-2 row classes."""
    return ((_align16(n * fs * itemsize) if resident else 0)
            + _align16(pn_buffers * p * n * 4)
            + (r2 * p * fs * 4 if r2 > 1 else 0))


def _cluster_r2(n, fs, p, itemsize, resident, vec, pn_buffers,
                static_bytes) -> int:
    """Most row classes phase 2 can use in the CTA's shared memory; 0 if
    the CTA does not fit.  Where X's slice is resident the CTA takes at
    most half an SM and must hold _SAL_MIN_R2 classes (or all the threads
    give): phase 2 with fewer is slower than the L2 re-read path.  The
    kernel's static shared memory, ``static_bytes``, comes off either
    budget."""
    most = _SAL_THREADS // (fs // vec)
    if resident:
        budget, least = _RESIDENT_SMEM_BYTES, min(_SAL_MIN_R2, most)
    else:
        budget, least = _MAX_SMEM_BYTES, 1
    budget -= static_bytes
    base = _cluster_smem(n, fs, p, itemsize, resident, 1, pn_buffers)
    r2 = min(most, (budget - base) // (p * fs * 4)) if base <= budget else 0
    if r2 < least:
        return 1 if least == 1 and base <= budget else 0
    return r2


def _cluster_plan(b, n, f, p, x_dtype, sms, pn_buffers,
                  static_bytes=0) -> ClusterPlan:
    itemsize = x_dtype.itemsize
    vec = 16 // itemsize
    max_slice = 32 * _lane_groups(p, vec) * vec
    sizes = [s for s in _CLUSTERS if f % (8 * s) == 0 and f // s <= max_slice]
    _check(bool(sizes), f"F={f} needs a slice of at most {max_slice} columns "
           f"at rank {p} and a multiple of 8 in each of at most 16 CTAs")
    filled = [s for s in sizes if b * s >= _fill_ctas(sms)]
    want = filled[0] if filled else sizes[-1]
    for resident in (True, False):
        for s in sizes:
            if s < want:
                continue
            fs = f // s
            r2 = _cluster_r2(n, fs, p, itemsize, resident, vec, pn_buffers,
                             static_bytes)
            if r2:
                return ClusterPlan(
                    cluster=s, f_slice=fs,
                    path="resident" if resident else "l2_reread",
                    r2=r2,
                    smem_bytes=_cluster_smem(n, fs, p, itemsize, resident,
                                             r2, pn_buffers),
                    grid=b * s)
    raise ValueError(f"{pn_buffers} (P, N) buffers of {p}x{n} exceed a "
                     f"CTA's shared memory")


def saliency_plan(b: int, n: int, f: int, p: int, x_dtype: torch.dtype,
                  sms: int = _SMS) -> ClusterPlan:
    """Cluster size, F slice, path, row chunks, phase-2 row classes and
    shared memory of a ``saliency_summary`` launch.

    The cluster is the smallest whose B * S CTAs fill the card (or the
    largest); a larger one where the X slice, with room for phase 2, would
    not fit in half an SM's shared memory.  Only where no cluster fits it
    does the plan take the path whose phase 2 reads X again from L2."""
    return _cluster_plan(b, n, f, p, x_dtype, sms, 2)


def backward_plan(b: int, n: int, f: int, p: int, x_dtype: torch.dtype,
                  sms: int = _SMS) -> ClusterPlan:
    """The plan of a ``pool_backward`` launch, by :func:`saliency_plan`'s
    rules: the kernel has the saliency kernel's cluster, slices, registers
    and phase-2 row classes (for d_sal_w), and holds a third (P, N) buffer
    (s beside the partial and summed ds) and, in static shared memory, the
    image's dssum (P floats)."""
    return _cluster_plan(b, n, f, p, x_dtype, sms, 3, _BWD_STATIC_SMEM)


@dataclasses.dataclass(frozen=True)
class ProjectPlan:
    k_split: int      # CTAs a cluster, along K = P * F
    k_rows: int       # rows of K a CTA owns, a multiple of 32 (the last
                      # CTA may own fewer)
    b_tile: int       # images a pass over A: 1, 2, 4, ..., 32
    a_resident: bool  # the CTA's slab of A stays in shared memory (B
                      # spans several tiles); else A streams to registers
    smem_bytes: int
    grid: tuple       # (k_split, class tiles of 32)


def _project_smem(kr: int, bt: int, p: int, a_resident: bool) -> int:
    return ((kr * _PROJ_AROW if a_resident else 0) + bt * kr
            + _PROJ_WARPS * bt * _PROJ_COLS + bt * _PROJ_COLS + bt * p
            + _PROJ_COLS * p) * 4


def project_plan(b: int, n: int, f: int, c: int, p: int) -> ProjectPlan:
    """K split, rows a CTA, image tile, residence of A and shared memory of a
    ``project_logits`` launch.  The split is the largest (up to 16) that
    leaves every CTA rows of K.  The image tile is the power of two
    that covers B, up to 32, halved until shared memory holds it.  Where B
    fits one tile A streams from HBM into registers; where it needs more
    the CTA keeps its whole slab of A in shared memory, so A is read once
    whatever B."""
    k = p * f
    tiles = _ceil(c, _PROJ_COLS)
    _check(tiles <= 65535, f"C={c} exceeds the projection kernel's grid")
    plans = []
    for ks in _CLUSTERS:
        kr = _ceil(_ceil(k, ks), _PROJ_STAGE) * _PROJ_STAGE
        if (ks - 1) * kr >= k:      # a CTA without rows
            break
        bt = min(_PROJ_MAX_BT, 1 << max(0, b - 1).bit_length())
        while True:
            smem = _project_smem(kr, bt, p, b > bt)
            if smem <= _MAX_SMEM_BYTES or bt == 1:
                break
            bt //= 2
        if smem <= _MAX_SMEM_BYTES:
            plans.append(ProjectPlan(ks, kr, bt, b > bt, smem, (ks, tiles)))
    _check(bool(plans), f"K={k} exceeds the projection kernel's shared memory")
    # the fewest passes over the images, then the largest split: every CTA
    # more has more of A in flight (PERF.md, PR 2)
    return min(plans, key=lambda pl: (_ceil(b, pl.b_tile), -pl.k_split))


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# -- wrappers ----------------------------------------------------------------
#
# Each forward kernel is a ``torch.library`` custom op in the ``apa``
# namespace, opaque to tracing: ``torch.export`` keeps the op as one node
# of the graph (its fake implementation gives the output shapes) and the
# loaded program calls the implementation below, so the launch counters
# count on the eager path and inside an exported program alike.  The
# public functions check their operands (on fake tensors too) and call the
# op.

def _check_saliency(x, sal_w, sal_b) -> None:
    _check(x.ndim == 3, f"x must be (B, N, F), got {tuple(x.shape)}")
    _check(x.dtype in _X_DTYPES,
           f"x must be float32 or bfloat16, got {x.dtype}", TypeError)
    f = x.shape[2]
    _check(sal_w.ndim == 2, f"sal_w must be (F, P), got {tuple(sal_w.shape)}")
    p = sal_w.shape[1]
    _check(1 <= p <= MAX_RANK, f"rank {p} outside 1..{MAX_RANK}")
    _check_f32("sal_w", sal_w, (f, p))
    _check_f32("sal_b", sal_b, (p,))


@torch.library.custom_op("apa::saliency_summary", mutates_args=())
def _saliency_summary_op(x: torch.Tensor, sal_w: torch.Tensor,
                         sal_b: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return saliency_summary_plain(x, sal_w, sal_b)
    b, n, f = x.shape
    p = sal_w.shape[1]
    _check(x.is_cuda, f"no kernel for device {x.device}")
    _check_cuda_operands(x, sal_w, sal_b)
    _check(f % 8 == 0, f"F={f} must be a multiple of 8 (16-byte loads)")
    _check(n >= 1, "x has no positions")
    plan = saliency_plan(b, n, f, p, x.dtype, _sms(x.device))
    v = torch.empty((b, p, f), dtype=torch.float32, device=x.device)
    s = torch.empty((b, p, n), dtype=torch.float32, device=x.device)
    if b == 0:
        return v, s
    lib = _build.ATTN_POOL.load()
    with torch.cuda.device(x.device):
        err = lib.apa_saliency_summary(
            x.data_ptr(), _X_DTYPES[x.dtype], sal_w.data_ptr(),
            sal_b.data_ptr(), v.data_ptr(), s.data_ptr(), b, n, f, p,
            plan.cluster, plan.r2, plan.path == "resident",
            plan.smem_bytes, _stream())
    _raise_if(err, "saliency_summary", lib.apa_error_string)
    return v, s


@_saliency_summary_op.register_fake
def _(x, sal_w, sal_b):
    b, n, f = x.shape
    p = sal_w.shape[1]
    return (x.new_empty((b, p, f), dtype=torch.float32),
            x.new_empty((b, p, n), dtype=torch.float32))


def saliency_summary(x, sal_w, sal_b):
    """x (B, N, F) float32 or bfloat16 -> v (B, P, F), s (B, P, N), f32:
    the op ``apa::saliency_summary``."""
    _check_saliency(x, sal_w, sal_b)
    if x.is_cuda:
        _check_no_grad(x, sal_w, sal_b)
    return _saliency_summary_op(x, sal_w, sal_b)


def attn_w_pfc(attn_w):
    """The (P, F, C) copy of ``attn_w (F, C, P)`` that the projection
    kernel reads, coalesced over classes.  Made once per set of weights."""
    return attn_w.to(torch.float32).permute(2, 0, 1).contiguous()


def _check_project(v, s, w_pfc, attn_b) -> None:
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


@torch.library.custom_op("apa::project_logits", mutates_args=())
def _project_logits_op(v: torch.Tensor, s: torch.Tensor, w_pfc: torch.Tensor,
                       attn_b: torch.Tensor) -> torch.Tensor:
    if v.device.type == "cpu":
        return project_logits_plain(v, s, w_pfc, attn_b)
    b, p, f = v.shape
    n = s.shape[2]
    c = w_pfc.shape[2]
    _check(v.is_cuda, f"no kernel for device {v.device}")
    _check_cuda_operands(v, s, w_pfc, attn_b)
    _check(w_pfc.data_ptr() % 16 == 0,
           "w_pfc must be 16-byte aligned for the kernel's 16-byte copies")
    _check(n >= 1, "s has no positions")
    plan = project_plan(b, n, f, c, p)
    logits = torch.empty((b, c), dtype=torch.float32, device=v.device)
    if b == 0:
        return logits
    lib = _build.ATTN_POOL.load()
    with torch.cuda.device(v.device):
        err = lib.apa_project_logits(
            v.data_ptr(), s.data_ptr(), w_pfc.data_ptr(), attn_b.data_ptr(),
            logits.data_ptr(), b, n, f, c, p, plan.k_split, plan.k_rows,
            plan.b_tile, plan.a_resident, plan.smem_bytes, _stream())
    _raise_if(err, "project_logits", lib.apa_error_string)
    return logits


@_project_logits_op.register_fake
def _(v, s, w_pfc, attn_b):
    return v.new_empty((v.shape[0], w_pfc.shape[2]), dtype=torch.float32)


def project_logits(v, s, w_pfc, attn_b):
    """v (B, P, F), s (B, P, N), w_pfc (P, F, C), attn_b (C, P) -> (B, C):
    the op ``apa::project_logits``."""
    _check_project(v, s, w_pfc, attn_b)
    if v.is_cuda:
        _check_no_grad(v, s, w_pfc, attn_b)
    return _project_logits_op(v, s, w_pfc, attn_b)


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


def fused_pool_backward_plain(x, w_pfc, attn_b, sal_w, v, s, g):
    """Gradients of the logits for their cotangent ``g`` (B, C):
    ``(dx, d_attn_w, d_attn_b, d_sal_w, d_sal_b)`` from the saved summary
    ``v`` and saliency ``s``.  The JAX package's ``_fused_bwd`` line for
    line, in float32; ``dx`` comes back in ``x``'s dtype.  ``attn_w``
    enters only through ``dv = g A``, which reads the kernel's (P, F, C)
    copy ``w_pfc`` as one (B, C) @ (C, P F) product."""
    xf = x.to(torch.float32)
    ab = attn_b.to(torch.float32)
    sw = sal_w.to(torch.float32)
    g = g.to(torch.float32)
    b, p, f = v.shape
    ssum = s.sum(dim=2)                                     # (B, P)

    d_attn_w = torch.einsum("bpf,bc->fcp", v, g)
    d_attn_b = torch.einsum("bp,bc->cp", ssum, g)
    dv = (g @ w_pfc.reshape(p * f, -1).t()).reshape(b, p, f)
    dssum = g @ ab                                          # (B, P)

    # v = sum_n x_n s_n  =>  dx += s dv ; ds = X dv
    ds = torch.einsum("bnf,bpf->bpn", xf, dv) + dssum[:, :, None]
    dx = torch.einsum("bpn,bpf->bnf", s, dv)
    # s = X sal_w + beta  =>  dx += ds sal_w^T ; dsal_w = X^T ds
    dx = dx + torch.einsum("bpn,fp->bnf", ds, sw)
    d_sal_w = torch.einsum("bnf,bpn->fp", xf, ds)
    d_sal_b = ds.sum(dim=(0, 2))
    return dx.to(x.dtype), d_attn_w, d_attn_b, d_sal_w, d_sal_b


def fused_pool_backward(x, w_pfc, attn_b, sal_w, v, s, g):
    """:func:`fused_pool_backward_plain`'s gradients; on CUDA tensors
    ``dv = g A`` and ``d_attn_w`` are cuBLAS products and the rest (the
    pass over X, ``g alpha``, ``d_attn_b``) is the ``pool_backward``
    kernel, whose per-image partials one ``sum(0)`` adds up: 4 launches.
    x (B, N, F) float32 or bfloat16; w_pfc (P, F, C), attn_b (C, P), sal_w
    (F, P), v (B, P, F), s (B, P, N) and g (B, C) float32.  ``dx`` comes
    back in x's dtype, the rest in float32."""
    _check_backward(x, w_pfc, attn_b, sal_w, v, s, g)
    if x.device.type == "cpu":
        return fused_pool_backward_plain(x, w_pfc, attn_b, sal_w, v, s, g)
    _check(x.is_cuda, f"no kernel for device {x.device}")
    # autograd may hand over an expanded cotangent (the gradient of a sum)
    g = g.contiguous()
    _check_cuda_operands(x, w_pfc, attn_b, sal_w, v, s, g)
    b, p, f = v.shape
    c = w_pfc.shape[2]
    dv = (g @ w_pfc.reshape(p * f, c).t()).reshape(b, p, f)
    d_attn_w = torch.einsum("bpf,bc->fcp", v, g)
    dx, d_sal_w, d_sal_b, d_attn_b = _pool_backward_kernel(
        x, dv, s, g, attn_b, sal_w)
    return dx, d_attn_w, d_attn_b, d_sal_w, d_sal_b


def _check_backward(x, w_pfc, attn_b, sal_w, v, s, g) -> None:
    _check(x.ndim == 3, f"x must be (B, N, F), got {tuple(x.shape)}")
    _check(x.dtype in _X_DTYPES,
           f"x must be float32 or bfloat16, got {x.dtype}", TypeError)
    b, n, f = x.shape
    _check(w_pfc.ndim == 3, f"w_pfc must be (P, F, C), got "
           f"{tuple(w_pfc.shape)}")
    p, c = w_pfc.shape[0], w_pfc.shape[2]
    _check(1 <= p <= MAX_RANK, f"rank {p} outside 1..{MAX_RANK}")
    _check_f32("w_pfc", w_pfc, (p, f, c))
    _check_f32("attn_b", attn_b, (c, p))
    _check_f32("sal_w", sal_w, (f, p))
    _check_f32("v", v, (b, p, f))
    _check_f32("s", s, (b, p, n))
    _check_f32("g", g, (b, c))


def _pool_backward_kernel(x, dv, s, g, attn_b, sal_w):
    """The ``pool_backward`` kernel's pass over X and its ``sum(0)``:
    ``(dx, d_sal_w, d_sal_b, d_attn_b)`` from ``dv`` and the cotangent
    ``g`` (B, C) with ``attn_b`` (C, P), of which the kernel makes
    ``dssum = g alpha`` and ``d_attn_b``."""
    b, n, f = x.shape
    p, c = dv.shape[1], g.shape[1]
    _check(f % 8 == 0, f"F={f} must be a multiple of 8 (16-byte loads)")
    _check(n >= 1, "x has no positions")
    plan = backward_plan(b, n, f, p, x.dtype, _sms(x.device))
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    # each image's d_sal_w (F, P), d_sal_b (P) and d_attn_b (C, P), summed
    # over B below
    fp = f * p
    red = torch.empty((b, fp + p + c * p), dtype=torch.float32,
                      device=x.device)
    if b > 0:
        lib = _build.ATTN_POOL_BACKWARD.load()
        with torch.cuda.device(x.device):
            err = lib.apb_pool_backward(
                x.data_ptr(), _X_DTYPES[x.dtype], dv.data_ptr(),
                s.data_ptr(), g.data_ptr(), attn_b.data_ptr(),
                sal_w.data_ptr(), dx.data_ptr(), red.data_ptr(), b, n, f, c,
                p, plan.cluster, plan.r2, plan.path == "resident",
                plan.smem_bytes, _stream())
        _raise_if(err, "pool_backward", lib.apb_error_string)
    total = red.sum(dim=0)
    return (dx, total[:fp].view(f, p), total[fp:fp + p],
            total[fp + p:].view(c, p))


def _pool_backward_given_dv(x, sal_w, s, dv, dssum):
    """``(dx, d_sal_w, d_sal_b)`` of the saliency and the summary for the
    cotangents ``dv`` (B, P, F) and ``dssum`` (B, P) of ``v`` and of
    ``s`` summed over the positions.  On a card the ``pool_backward``
    kernel, given ``dssum`` as a (B, P) cotangent and the (P, P) identity
    as ``attn_b`` (its ``g alpha`` is then ``dssum``, and the identity's
    gradient is dropped); on the CPU the plain ops."""
    if x.device.type == "cpu":
        xf = x.to(torch.float32)
        sw = sal_w.to(torch.float32)
        ds = torch.einsum("bnf,bpf->bpn", xf, dv) + dssum[:, :, None]
        dx = torch.einsum("bpn,bpf->bnf", s, dv)
        dx = dx + torch.einsum("bpn,fp->bnf", ds, sw)
        return (dx.to(x.dtype), torch.einsum("bnf,bpn->fp", xf, ds),
                ds.sum(dim=(0, 2)))
    _check(x.is_cuda, f"no kernel for device {x.device}")
    dv, dssum = dv.contiguous(), dssum.contiguous()
    _check_cuda_operands(x, sal_w, s, dv, dssum)
    eye = torch.eye(dv.shape[1], dtype=torch.float32, device=x.device)
    dx, d_sal_w, d_sal_b, _ = _pool_backward_kernel(
        x, dv, s, dssum, eye, sal_w)
    return dx, d_sal_w, d_sal_b


def sharded_pool_backward(x, w_pfc, attn_b, sal_w, v, s, g, group):
    """The backward of one class shard under tensor parallelism:
    ``w_pfc``, ``attn_b`` and ``g`` hold this rank's classes.  Their
    ``dv = g A`` and ``dssum = g alpha`` cover those classes only, so one
    all-reduce over ``group`` sums them before the pass over X; ``dx``,
    ``d_sal_w`` and ``d_sal_b`` are then whole and equal on every rank of
    the group, ``d_attn_w`` and ``d_attn_b`` this rank's shard."""
    import torch.distributed as dist

    _check_backward(x, w_pfc, attn_b, sal_w, v, s, g)
    g = g.contiguous()
    b, p, f = v.shape
    c = w_pfc.shape[2]
    dvs = torch.cat([(g @ w_pfc.reshape(p * f, c).t()), g @ attn_b], dim=1)
    dist.all_reduce(dvs, group=group)
    dv, dssum = dvs[:, :p * f].reshape(b, p, f), dvs[:, p * f:]
    d_attn_w = torch.einsum("bpf,bc->fcp", v, g)
    d_attn_b = torch.einsum("bp,bc->cp", s.sum(dim=2), g)
    dx, d_sal_w, d_sal_b = _pool_backward_given_dv(x, sal_w, s, dv, dssum)
    return dx, d_attn_w, d_attn_b, d_sal_w, d_sal_b


class AttentionalPoolFn(torch.autograd.Function):
    """Logits (B, C) of the fused pooling, differentiable in ``x`` and the
    four weights: the forward is :func:`saliency_summary` then
    :func:`project_logits`, the backward :func:`fused_pool_backward` (the
    kernels on CUDA tensors).  ``w_pfc``, :func:`attn_w_pfc` of
    ``attn_w``, takes no gradient; both passes read ``attn_w`` through it,
    so ``attn_w`` is an input only to receive its gradient."""

    @staticmethod
    def forward(ctx, x, attn_w, attn_b, sal_w, sal_b, w_pfc,
                class_group=None):
        v, s = saliency_summary(x, sal_w, sal_b)
        logits = project_logits(v, s, w_pfc, attn_b)
        ctx.save_for_backward(x, w_pfc, attn_b, sal_w, v, s)
        ctx.class_group = class_group
        return logits

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if ctx.class_group is None:
            grads = fused_pool_backward(*ctx.saved_tensors, g)
        else:
            grads = sharded_pool_backward(*ctx.saved_tensors, g,
                                          ctx.class_group)
        return (*grads, None, None)


def attentional_pool_fused(x, attn_w, attn_b, sal_w, sal_b, *, w_pfc=None,
                           class_group=None):
    """Drop-in for ``ops.attn_pool.attentional_pool``: (B, C) float32,
    through :class:`AttentionalPoolFn` on every device.  ``w_pfc`` is as
    for :func:`fused_pool_logits`.  With ``class_group`` the weights are
    one class shard of a tensor-parallel head, and the logits are the
    shard's (:func:`sharded_pool_backward`)."""
    f, c, p = attn_w.shape
    _check_f32("attn_w", attn_w, (f, c, p))
    if w_pfc is None:
        w_pfc = attn_w_pfc(attn_w.detach())
    return AttentionalPoolFn.apply(x, attn_w, attn_b, sal_w, sal_b, w_pfc,
                                   class_group)
