"""The FLOP and byte arithmetic of ``roofline.py``: the forward's FLOPs
against ``torch.utils.flop_counter`` on the plain reference (on the meta
device: shapes only, no arithmetic), and the head kernels' bytes against
the bounds of PERF.md's kernel table."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_h100 import roofline
from bench_h100.generators import weights as gen_weights
from bench_h100.reference import model as ref_model


def meta_tree(backbone, num_classes, rank, image_size):
    kernels, norms = gen_weights.layout(backbone, num_classes=num_classes,
                                        rank=rank, image_size=image_size)
    params, stats = {}, {}
    for path, shape, _ in kernels:
        gen_weights._put(params, path, torch.empty(shape, device="meta"))
    for path, c in norms:
        for coll, leaf in ((params, "scale"), (params, "bias"),
                           (stats, "mean"), (stats, "var")):
            gen_weights._put(coll, path + (leaf,),
                             torch.empty(c, device="meta"))
    return params, stats


@pytest.mark.parametrize("backbone,image_size,classes,rank", [
    ("resnet_v1_101", 224, 393, 1),
    ("resnet_v1_101", 450, 393, 5),
    ("resnet_v1_50", 64, 393, 1),
])
def test_forward_flops_match_the_flop_counter(backbone, image_size, classes,
                                              rank):
    params, stats = meta_tree(backbone, classes, rank, image_size)
    x = torch.empty((1, image_size, image_size, 3), dtype=torch.uint8,
                    device="meta")
    with FlopCounterMode(display=False) as counter:
        ref_model.logits(params, stats, x,
                         stages=gen_weights.STAGES[backbone])
    assert counter.get_total_flops() == roofline.forward_flops(
        backbone, image_size, classes, rank)


def test_slim_resnet101_at_224_is_14_4_gflops():
    # slim's v1 strides the last unit of a block, so block 1-3's last
    # units run at the lower resolution: 14.38 GFLOPs, where the
    # torchvision layout (stride on a block's first unit) counts ~15.6
    gflops = roofline.backbone_flops("resnet_v1_101", 224) / 1e9
    assert 14.3 < gflops < 14.5


@pytest.mark.parametrize("b,sal_ms,proj_ms,bwd_ms", [
    (8, 0.0010, 0.0010, 0.0020), (32, 0.0039, 0.0011, 0.0079)])
def test_head_kernel_bytes_match_the_kernel_table(b, sal_ms, proj_ms,
                                                  bwd_ms):
    n, f, c, p = 49, 2048, 393, 1
    for (nbytes, flops), want in (
            (roofline.saliency_summary_cost(b, n, f, p), sal_ms),
            (roofline.project_logits_cost(b, n, f, c, p), proj_ms),
            (roofline.pool_backward_cost(b, n, f, c, p), bwd_ms)):
        ms = roofline.least_seconds(nbytes, flops) * 1e3
        assert round(ms, 4) == want
        assert nbytes / roofline.HBM_BYTES_PER_S >= flops / (
            roofline.PEAK_FLOPS["fp32"])        # bound by bytes


def test_train_flops_are_three_forwards():
    fwd = roofline.forward_flops("resnet_v1_101", 224, 393, 1)
    assert roofline.train_flops("resnet_v1_101", 224, 393, 1) == 3 * fwd
