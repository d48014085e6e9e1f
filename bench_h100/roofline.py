"""Operations and bytes, counted from shapes, and the chip's peaks.

FLOPs count 2 per multiply-add, as ``torch.utils.flop_counter`` counts a
convolution or a matrix product (bias adds, batch norm, ReLU and pooling
are not counted).  A head kernel's bytes count each input read once and
each output written once, whatever the kernel reads again.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s
bf16, 495 TFLOP/s TF32, 67 TFLOP/s float32 outside the tensor cores, HBM
3.35 TB/s.  They assume the card's full 700 W.
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12

STAGES = {"resnet_v1_50": (3, 4, 6, 3), "resnet_v1_101": (3, 4, 23, 3),
          "resnet_v1_152": (3, 8, 36, 3)}
NUM_FEATURES = 2048


def _down(s: int) -> int:
    return -(-s // 2)


def feature_size(image_size: int) -> int:
    s = image_size
    for _ in range(5):
        s = _down(s)
    return s


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
    return 2 * h * w * cin * cout * k * k


def backbone_flops(backbone: str, image_size: int) -> int:
    """Forward FLOPs of one image through the slim ResNet-v1's convs."""
    s = _down(image_size)                        # root conv, stride 2
    flops = _conv(s, s, 3, 64, 7)
    s = _down(s)                                 # root max-pool
    depth_in = 64
    stages = STAGES[backbone]
    for b, units in enumerate(stages, start=1):
        base = 64 * 2 ** (b - 1)
        for u in range(1, units + 1):
            stride = 2 if (u == units and b < len(stages)) else 1
            out = _down(s) if stride == 2 else s
            if depth_in != base * 4:
                flops += _conv(out, out, depth_in, base * 4, 1)
            flops += _conv(s, s, depth_in, base, 1)
            flops += _conv(out, out, base, base, 3)
            flops += _conv(out, out, base, base * 4, 1)
            s, depth_in = out, base * 4
    return flops


def head_flops(n: int, f: int, c: int, p: int) -> int:
    """Forward FLOPs of one image through the factored attentional head:
    ``s = X b`` and ``v = X^T s`` (2 n f p each), ``<v, a_c>`` (2 f p c)
    and the bias term (2 p c)."""
    return 4 * n * f * p + 2 * f * p * c + 2 * p * c


def forward_flops(backbone: str, image_size: int, num_classes: int,
                  rank: int) -> int:
    n = feature_size(image_size) ** 2
    return (backbone_flops(backbone, image_size)
            + head_flops(n, NUM_FEATURES, num_classes, rank))


def train_flops(backbone: str, image_size: int, num_classes: int,
                rank: int) -> int:
    """A trained image: the forward and a backward of twice its FLOPs;
    recomputed work is not counted."""
    return 3 * forward_flops(backbone, image_size, num_classes, rank)


# -- the head's kernels (csrc/attn_pool.cu, csrc/attn_pool_backward.cu) ------

def saliency_summary_cost(b, n, f, p, x_bytes=4) -> tuple[int, int]:
    """(bytes, FLOPs): reads X, ``sal_w``, ``sal_b``; writes s (B, N, P)
    and v (B, F, P)."""
    nbytes = b * n * f * x_bytes + 4 * (f * p + p + b * p * (f + n))
    return nbytes, 4 * b * n * f * p


def project_logits_cost(b, n, f, c, p) -> tuple[int, int]:
    """(bytes, FLOPs): reads v, s, the (P, F, C) copy of ``attn_w`` and
    ``attn_b``; writes the (B, C) logits."""
    nbytes = 4 * (b * p * (f + n) + p * f * c + c * p + b * c)
    return nbytes, 2 * b * p * f * c + b * p * n + 2 * b * c * p


def pool_backward_cost(b, n, f, c, p, x_bytes=4) -> tuple[int, int]:
    """(bytes, FLOPs) of the ``pool_backward`` kernel alone: reads X, dv,
    s, the logits' cotangent, ``attn_b`` and ``sal_w``; writes dX and its
    (B, F P + P + C P) partials."""
    nbytes = 2 * b * n * f * x_bytes + 4 * (
        b * p * f + b * p * n + b * c + c * p + f * p
        + b * (f * p + p + c * p))
    return nbytes, 8 * b * n * f * p


def least_seconds(nbytes: int, flops: int,
                  peak_flops: float = PEAK_FLOPS["fp32"]) -> float:
    """The least time the chip could take: the larger of the bytes over
    HBM's rate and the FLOPs over ``peak_flops`` (the head's kernels
    compute in float32 on the CUDA cores)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


HEAD_KERNELS = {
    # kernel name in the trace -> cost function of (b, n, f, c, p, x_bytes)
    "saliency_summary_kernel":
        lambda b, n, f, c, p, xb: saliency_summary_cost(b, n, f, p, xb),
    "project_logits_kernel":
        lambda b, n, f, c, p, xb: project_logits_cost(b, n, f, c, p),
    "pool_backward_kernel":
        lambda b, n, f, c, p, xb: pool_backward_cost(b, n, f, c, p, xb),
}
