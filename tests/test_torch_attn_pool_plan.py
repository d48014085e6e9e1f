"""Launch plans of the Hopper pooling kernels (ops/attn_pool_cuda.py), on
the CPU: every shape the presets produce gets a plan that fits an H100's
shared memory, a cluster the card allows, F slices and K splits that cover
their axis exactly, and the L2 re-read path only where X's slice cannot
stay in shared memory."""

import math

import pytest
import torch

from attentionalpoolingaction_torch.ops import attn_pool_cuda as apc

SMEM = 232_448          # shared memory a block may take on an H100
F = 2048                # ResNet-v1 feature width
BATCHES = (1, 8, 32, 33, 100)
RANKS = range(1, 9)


def resident_fits(n, fs, p, itemsize):
    """A resident CTA (X slice, partial and summed s, and 4 phase-2 row
    classes, or as many as 256 threads give) within half an SM, so that
    two share one."""
    r2 = min(4, 256 // (fs * itemsize // 16))
    return (math.ceil(n * fs * itemsize / 16) * 16
            + math.ceil(2 * p * n * 4 / 16) * 16
            + (r2 * p * fs * 4 if r2 > 1 else 0)) <= SMEM // 2 - 1024


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [49, 196, 225, 392])
def test_saliency_plan_fits_and_covers_f(n, x_dtype):
    itemsize = x_dtype.itemsize
    for p in RANKS:
        for b in BATCHES:
            plan = apc.saliency_plan(b, n, F, p, x_dtype)
            assert plan.smem_bytes <= SMEM
            if plan.path == "resident":
                assert plan.smem_bytes <= SMEM // 2 - 1024
            assert plan.cluster in (1, 2, 4, 8, 16)
            assert plan.cluster * plan.f_slice == F
            assert plan.f_slice * itemsize % 16 == 0
            assert plan.grid == b * plan.cluster
            assert 1 <= plan.r2 <= 256
            fits = [s for s in (1, 2, 4, 8, 16)
                    if resident_fits(n, F // s, p, itemsize)]
            assert (plan.path == "l2_reread") == (not fits)
            if plan.path == "resident":
                assert n * plan.f_slice * itemsize < plan.smem_bytes
            # B * S fills every other SM, or S is at its largest
            assert plan.grid >= 66 or plan.cluster == 16


def test_saliency_plan_keeps_the_serving_and_clip_slices_resident():
    for b in BATCHES:
        assert apc.saliency_plan(b, 49, F, 1, torch.float32).path \
            == "resident"
        assert apc.saliency_plan(b, 392, F, 1, torch.bfloat16).path \
            == "resident"
    # f32 clips and rank 5 at 196 positions are past half an SM even at
    # 16 CTAs an image
    assert apc.saliency_plan(8, 392, F, 1, torch.float32).path == "l2_reread"
    assert apc.saliency_plan(8, 196, F, 5, torch.float32).path == "l2_reread"


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [800, 1568, 3000])
def test_saliency_plan_rereads_from_l2_only_where_no_slice_fits(n, x_dtype):
    itemsize = x_dtype.itemsize
    for p in (1, 5, 8):
        for b in (1, 32):
            plan = apc.saliency_plan(b, n, F, p, x_dtype)
            fits = [s for s in (1, 2, 4, 8, 16)
                    if resident_fits(n, F // s, p, itemsize)]
            assert (plan.path == "l2_reread") == (not fits)
            assert plan.smem_bytes <= SMEM
            assert plan.cluster * plan.f_slice == F


def test_saliency_plan_small_f_takes_the_largest_cluster():
    plan = apc.saliency_plan(1, 49, 256, 1, torch.float32)
    assert (plan.cluster, plan.f_slice, plan.path) == (16, 16, "resident")
    # F = 8 leaves one CTA of 8 columns
    assert apc.saliency_plan(4, 49, 8, 1, torch.float32).cluster == 1


def test_saliency_plan_rejects_what_no_cluster_takes():
    with pytest.raises(ValueError):
        apc.saliency_plan(1, 49, 8192, 8, torch.float32)
    with pytest.raises(ValueError):
        apc.saliency_plan(1, 20_000, F, 8, torch.float32)


@pytest.mark.parametrize("c", [51, 393, 600])
def test_project_plan_fits_and_covers_k(c):
    for p in RANKS:
        k = p * F
        for b in BATCHES:
            plan = apc.project_plan(b, 49, F, c, p)
            assert plan.smem_bytes <= SMEM
            assert plan.k_split in (1, 2, 4, 8, 16)
            # [r kr, (r + 1) kr) for r < KS covers [0, K), every CTA has rows
            assert plan.k_split * plan.k_rows >= k
            assert (plan.k_split - 1) * plan.k_rows < k
            assert plan.b_tile in (1, 2, 4, 8, 16, 32)
            assert plan.k_rows % 32 == 0
            # A streams where one tile holds B, else its slab stays
            assert plan.a_resident == (b > plan.b_tile)
            assert plan.grid == (plan.k_split, math.ceil(c / 32))


def test_project_plan_takes_the_largest_split_at_the_serving_shape():
    for b in (1, 8, 32):
        plan = apc.project_plan(b, 49, F, 393, 1)
        assert plan.k_split == 16
        assert plan.k_split * plan.grid[1] >= 132    # fills the card
        assert plan.b_tile >= b and not plan.a_resident  # one pass


def test_project_plan_holds_the_slab_where_b_needs_several_tiles():
    for b, c, p in ((33, 393, 1), (100, 600, 5), (100, 393, 8)):
        plan = apc.project_plan(b, 49, F, c, p)
        assert b > plan.b_tile
        assert plan.a_resident                    # A stays in shared memory


def test_project_plan_rejects_a_k_no_split_holds():
    with pytest.raises(ValueError):
        apc.project_plan(1, 49, 2 ** 18, 393, 8)


# chip_smoke.py's phase-2 cases (B, N, P) and small test shapes (B, N, F,
# P), for the backward's plan
PHASE2 = [(b, 49, 1) for b in (1, 8, 16, 32, 48)] + [
    (8, 196, 5), (8, 225, 5), (8, 392, 1), (64, 49, 1), (32, 196, 1)]
SMALL = [(2, 49, 256, 1), (2, 49, 256, 3), (1, 4, 64, 2), (3, 5, 16, 2),
         (1, 49, 256, 1)]


def backward_resident_fits(n, fs, p, itemsize):
    """As resident_fits, with the backward's third (P, N) buffer and its
    32 bytes of static shared memory (dssum)."""
    r2 = min(4, 256 // (fs * itemsize // 16))
    return (math.ceil(n * fs * itemsize / 16) * 16
            + math.ceil(3 * p * n * 4 / 16) * 16
            + (r2 * p * fs * 4 if r2 > 1 else 0)) <= SMEM // 2 - 1024 - 32


def check_backward_plan(b, n, f, p, x_dtype):
    itemsize = x_dtype.itemsize
    plan = apc.backward_plan(b, n, f, p, x_dtype)
    fwd = apc.saliency_plan(b, n, f, p, x_dtype)
    assert plan.smem_bytes <= SMEM - 32
    if plan.path == "resident":
        assert plan.smem_bytes <= SMEM // 2 - 1024 - 32
        assert n * plan.f_slice * itemsize < plan.smem_bytes
    assert plan.cluster in (1, 2, 4, 8, 16)
    assert plan.cluster * plan.f_slice == f
    assert plan.f_slice * itemsize % 16 == 0
    assert plan.grid == b * plan.cluster
    assert 1 <= plan.r2 <= 256
    fits = [s for s in (1, 2, 4, 8, 16)
            if s * 8 <= f and f % (8 * s) == 0
            and backward_resident_fits(n, f // s, p, itemsize)]
    assert (plan.path == "l2_reread") == (not fits)
    # the forward's rules: the same cluster wherever the third (P, N)
    # buffer leaves the forward's path as it is
    if plan.path == fwd.path:
        assert plan.cluster >= fwd.cluster
    # the layout the C entry point checks: X's slice where resident, three
    # (P, N) buffers, the phase-2 row classes
    assert plan.smem_bytes == (
        (math.ceil(n * plan.f_slice * itemsize / 16) * 16
         if plan.path == "resident" else 0)
        + math.ceil(3 * p * n * 4 / 16) * 16
        + (plan.r2 * p * plan.f_slice * 4 if plan.r2 > 1 else 0))
    return plan


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, n, p", PHASE2)
def test_backward_plan_at_the_phase2_shapes(b, n, p, x_dtype):
    plan = check_backward_plan(b, n, F, p, x_dtype)
    # B * S fills every other SM, or S is at its largest
    assert plan.grid >= 66 or plan.cluster == 16
    # the serving and training batches of mpii_rank1_224 keep X resident
    if n == 49:
        assert plan.path == "resident"


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, n, f, p", SMALL)
def test_backward_plan_at_small_shapes(b, n, f, p, x_dtype):
    check_backward_plan(b, n, f, p, x_dtype)


def test_backward_plan_holds_one_more_pn_buffer_than_the_forward():
    for b, n, p in PHASE2:
        fwd = apc.saliency_plan(b, n, F, p, torch.float32)
        bwd = apc.backward_plan(b, n, F, p, torch.float32)
        if (fwd.cluster, fwd.path, fwd.r2) == (bwd.cluster, bwd.path, bwd.r2):
            assert bwd.smem_bytes - fwd.smem_bytes == (
                math.ceil(3 * p * n * 4 / 16) - math.ceil(2 * p * n * 4 / 16)
            ) * 16


def test_backward_plan_rejects_what_no_cluster_takes():
    with pytest.raises(ValueError):
        apc.backward_plan(1, 49, 8192, 8, torch.float32)
    with pytest.raises(ValueError):
        apc.backward_plan(1, 20_000, F, 8, torch.float32)
