"""Pose keypoints -> Gaussian heatmap targets, crop/flip-consistent keypoint
transforms and the pose head's L2 loss.  Port of the JAX package's
``ops/heatmap.py``, batched over leading dimensions where the JAX package
vmaps a per-example function.
"""

from __future__ import annotations

import numpy as np
import torch

# MPII joint pairs swapped under horizontal flip, in the standard MPII order
# 0 r-ankle 1 r-knee 2 r-hip 3 l-hip 4 l-knee 5 l-ankle 6 pelvis 7 thorax
# 8 upper-neck 9 head-top 10 r-wrist 11 r-elbow 12 r-shoulder 13 l-shoulder
# 14 l-elbow 15 l-wrist
MPII_NUM_JOINTS = 16
MPII_FLIP_PERM = np.array(
    [5, 4, 3, 2, 1, 0, 6, 7, 8, 9, 15, 14, 13, 12, 11, 10], dtype=np.int64)


def render_gaussian_heatmaps(keypoints, visibility, height: int, width: int,
                             sigma: float = 1.0) -> torch.Tensor:
    """(..., K, 2) (y, x) map-pixel keypoints -> (..., height, width, K)
    un-normalized Gaussians (peak 1).  Invisible and off-map joints render
    all-zero maps."""
    keypoints = torch.as_tensor(keypoints, dtype=torch.float32)
    vis = torch.as_tensor(visibility, device=keypoints.device).to(
        torch.float32)
    dev = keypoints.device
    yy = torch.arange(height, dtype=torch.float32, device=dev)[:, None, None]
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :, None]
    ky = keypoints[..., 0][..., None, None, :]               # (..., 1, 1, K)
    kx = keypoints[..., 1][..., None, None, :]
    d2 = (yy - ky) ** 2 + (xx - kx) ** 2                     # (..., H, W, K)
    heat = torch.exp(-d2 / (2.0 * sigma ** 2))
    on_map = ((keypoints[..., 0] >= 0) & (keypoints[..., 0] <= height - 1)
              & (keypoints[..., 1] >= 0) & (keypoints[..., 1] <= width - 1))
    mask = (vis * on_map.to(torch.float32))[..., None, None, :]
    return heat * mask


def transform_keypoints(keypoints, visibility, *, scale_y, scale_x,
                        offset_y, offset_x, flip, width: int,
                        flip_perm=MPII_FLIP_PERM):
    """The resize -> crop -> (maybe) horizontal flip of the image
    preprocessing, applied to (..., K, 2) (y, x) keypoints.  ``scale_*``,
    ``offset_*`` and ``flip`` are scalars or tensors of the leading shape
    (one per example).  Under flip, left and right joints swap by
    ``flip_perm``.  Returns (keypoints, visibility)."""
    keypoints = torch.as_tensor(keypoints, dtype=torch.float32)
    visibility = torch.as_tensor(visibility, device=keypoints.device)
    dev = keypoints.device

    def per_example(a):
        return torch.as_tensor(a, device=dev)[..., None]

    y = keypoints[..., 0] * per_example(scale_y) - per_example(offset_y)
    x = keypoints[..., 1] * per_example(scale_x) - per_example(offset_x)
    flip = per_example(flip).to(torch.bool)                  # (..., 1)
    x = torch.where(flip, (width - 1) - x, x)
    kps = torch.stack([y, x], dim=-1)
    perm = torch.as_tensor(flip_perm, dtype=torch.long, device=dev)
    kps = torch.where(flip[..., None], kps[..., perm, :], kps)
    vis = torch.where(flip, visibility[..., perm], visibility)
    return kps, vis


def pose_l2_loss(pred, target, visibility=None, *,
                 count=None) -> torch.Tensor:
    """Mean squared error of (B, H, W, K) heatmaps; with ``visibility``
    (B, K) the mean over visible joints only.  ``count`` replaces the
    denominator's count (the visible joints, or without ``visibility`` the
    elements) by one taken over more rows than these: a data-parallel
    rank's loss is then its share of the global mean."""
    sq = (pred.to(torch.float32) - target.to(torch.float32)) ** 2
    if visibility is None:
        return sq.mean() if count is None else sq.sum() / count
    vis = torch.as_tensor(visibility, device=sq.device).to(
        torch.float32)[:, None, None, :]
    n = vis.sum() if count is None else count
    denom = torch.clamp(n * sq.shape[1] * sq.shape[2], min=1.0)
    return (sq * vis).sum() / denom
