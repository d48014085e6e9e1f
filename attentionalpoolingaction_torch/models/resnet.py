"""ResNet-v1 backbones, faithful to the TF-slim variant: port of the JAX
package's ``models/resnet.py``.

Slim semantics reproduced here; each one breaks parity silently if lost:

  * ``conv2d_same``: a strided conv pads explicitly and symmetrically
    (pad_total = kernel - 1, split floor/ceil), then runs VALID.
  * The root max-pool is 3x3 stride 2 with TF "SAME" padding, computed per
    input size and padded with -inf: (0, 1) at 112 px, (1, 1) at 225 px.
    ``MaxPool2d(3, 2, padding=1)`` gives the same shape but shifts every
    window.
  * Down-sampling sits on the *last* unit of each block, on its 3x3 conv
    and on the projection shortcut.  An identity shortcut subsamples with
    ``x[:, :, ::s, ::s]``.
  * Batch norm (:class:`BatchNorm`): eps 1e-5, decay 0.997 (torch
    momentum 0.003).  In train mode it normalizes with the batch mean and
    the biased variance, and moves the running variance toward the biased
    one too (``nn.BatchNorm2d`` moves it toward the unbiased one).  In
    eval mode it uses the running statistics only.  Convs carry no bias.
  * Init as Flax's: convs ``lecun_normal`` (:func:`lecun_normal_`), BN
    scale 1, offset 0, running mean 0, variance 1.
  * v1 = post-activation: out = relu(shortcut + residual).
  * ``remat_units`` (Flax's ``nn.remat`` of each bottleneck): each unit
    runs under ``torch.utils.checkpoint``, which keeps only its input and
    runs its forward again in the backward.  The recompute normalizes
    with the same batch statistics (the same input gives them) but must
    not move the running statistics a second time, as the JAX package's
    functional recompute does not: :func:`_recomputing` marks the unit's
    batch norms for the recompute alone.  With ``sync_group`` the
    recompute all-reduces again, on every rank in the same order.
  * Compute ``dtype`` (Flax's ``dtype=bfloat16, param_dtype=float32``):
    parameters and BN statistics stay float32.  The input is rounded to
    ``dtype`` after the VGG mean subtraction; each conv casts its float32
    weight to ``dtype`` at the call (so autograd hands float32 gradients
    to float32 parameters) and its output is ``dtype``, as are the ReLUs,
    the residual add, the max pool and the subsample.  Batch norm takes a
    ``dtype`` input and reduces and normalizes in float32 against its
    float32 scale, offset and statistics, rounding to ``dtype`` at the end
    (Flax 0.12's ``_compute_stats`` and ``_normalize`` with
    ``force_float32_reductions``): torch's own batch norm does exactly
    that for a bfloat16 input with float32 parameters, on the CPU and on
    CUDA (``tests/test_torch_bf16.py``, ``chip_smoke.py``).

Modules compute in NCHW; the input is the NHWC batch permuted, which is
already channels-last in memory.  Unit modules are named after slim and
Flax (``block1/unit_1``) so the weight bridge (``convert.py``) is a name
map.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

BN_EPS = 1e-5
# the std of a standard normal truncated to (-2, 2): Flax's variance_scaling
# divides by it so that the truncated draw has the variance asked for
_TRUNC_STD = 0.87962566103423978


def feature_size(image_size: int) -> int:
    """Output spatial size of the stride-32 tail (five ceil-div-2 stages:
    conv1, pool, block1, block2, block3; block4 has stride 1)."""
    s = image_size
    for _ in range(5):
        s = -(-s // 2)
    return s


def truncated_normal(shape, std: float,
                     generator: torch.Generator | None = None,
                     device=None) -> torch.Tensor:
    """A float32 normal of ``std`` truncated at two standard deviations
    (Flax's ``truncated_normal(stddev)``), by redrawing what falls outside;
    on the generator's device unless ``device`` is given."""
    if device is None and generator is not None:
        device = generator.device
    t = torch.randn(shape, generator=generator, device=device)
    # a model built under torch.device("meta") (to count its parameters)
    # has no values to redraw
    while not t.is_meta:
        out = t.abs() >= 2.0
        n = int(out.sum())
        if not n:
            break
        t[out] = torch.randn(n, generator=generator, device=device)
    return t.mul_(std)


def lecun_normal_(weight: torch.Tensor,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax's default kernel init for ``nn.Conv`` and ``nn.Dense``
    (``lecun_normal``): variance 1/fan_in, truncated at two standard
    deviations.  Drawn on the generator's device and copied in, so that one
    seed gives the same weights on every device."""
    std = weight[0].numel() ** -0.5 / _TRUNC_STD    # fan_in = I * kh * kw
    t = truncated_normal(weight.shape, std, generator,
                         None if generator is not None else weight.device)
    with torch.no_grad():
        return weight.copy_(t)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` run in the compute dtype of its input: the float32
    weight is cast to it at the call (Flax's ``promote_dtype``)."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with Flax's train-mode update: the running
    statistics move toward the batch mean and the *biased* batch variance,
    the two the batch was normalized with.  It computes in its input's
    dtype: given bfloat16 and its float32 parameters and statistics, the
    reductions and the normalization run in float32 and the output is
    bfloat16.

    With ``sync_group`` (a process group: the mesh's data axis,
    ``train.make_train_step``) the train-mode statistics are those of the
    rows of every rank of the group, as Flax's batch norm reduces over the
    global batch under pjit: the per-rank sums are all-reduced through a
    differentiable all-reduce (``parallel.mesh.all_reduce_sum``), the mean
    first and then the sum of squared deviations from it (the biased
    variance, as the one-process path computes it).  Eval mode and
    ``freeze_bn`` do not reduce."""

    sync_group = None
    # set while torch.utils.checkpoint runs the forward again in the
    # backward (:func:`_recomputing`): the running statistics moved in the
    # first forward and stay where they are
    recomputing = False

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.sync_group is not None:
            return self._synced(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if self.recomputing:
            return y
        with torch.no_grad():
            # invstd = (var + eps)^-1/2 of the biased variance
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(invstd.pow(-2).sub_(self.eps),
                                   self.momentum)
        return y

    def _synced(self, x):
        # imported here: parallel/ imports the weight bridge, which
        # imports this module
        from attentionalpoolingaction_torch.parallel.mesh import (
            all_reduce_sum,
        )

        xf = x.to(torch.float32)
        c = xf.shape[1]
        count = xf.new_full((1,), float(xf.numel() // c))
        sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)), count]),
                              self.sync_group)
        n = sums[c].detach()
        mean = sums[:c] / n
        dev = xf - mean[None, :, None, None]
        var = all_reduce_sum(dev.square().sum(dim=(0, 2, 3)),
                             self.sync_group) / n
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = dev * scale[None, :, None, None] + self.bias[None, :, None, None]
        if self.recomputing:
            return y.to(x.dtype)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
        return y.to(x.dtype)


@contextlib.contextmanager
def _recomputing(unit: nn.Module):
    """Mark ``unit``'s batch norms as recomputing for the duration."""
    norms = [m for m in unit.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


def _remat_contexts(unit: nn.Module):
    """``checkpoint``'s ``context_fn``: nothing around the first forward,
    :func:`_recomputing` around the recompute."""
    return contextlib.nullcontext(), _recomputing(unit)


def _bn(channels: int, bn_momentum: float) -> BatchNorm:
    return BatchNorm(channels, eps=BN_EPS, momentum=1.0 - bn_momentum)


def conv2d_same(x, conv: nn.Conv2d, kernel_size: int, stride: int):
    """Apply ``conv`` with slim conv2d_same padding."""
    if stride == 1:
        return conv(x)          # conv built with symmetric "same" padding
    pad_total = kernel_size - 1
    pad_beg = pad_total // 2
    pad_end = pad_total - pad_beg
    return conv(F.pad(x, (pad_beg, pad_end, pad_beg, pad_end)))


def max_pool_same(x, kernel_size: int = 3, stride: int = 2):
    """TF "SAME" max-pool: pad (-inf) so that out = ceil(in / stride), with
    the odd cell of padding at the end."""
    pads = []
    for size in (x.shape[3], x.shape[2]):        # F.pad wants W first
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel_size - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, kernel_size, stride)


class Bottleneck(nn.Module):
    """Slim bottleneck_v1: 1x1 -> 3x3(stride) -> 1x1, projection shortcut."""

    def __init__(self, depth_in: int, depth: int, depth_bottleneck: int,
                 stride: int, bn_momentum: float = 0.997):
        super().__init__()
        self.stride = stride
        self.identity = depth_in == depth
        if not self.identity:
            self.shortcut = Conv2d(depth_in, depth, 1, stride=stride,
                                   bias=False)
            self.shortcut_bn = _bn(depth, bn_momentum)
        self.conv1 = Conv2d(depth_in, depth_bottleneck, 1, bias=False)
        self.conv1_bn = _bn(depth_bottleneck, bn_momentum)
        self.conv2 = Conv2d(depth_bottleneck, depth_bottleneck, 3,
                            stride=stride, bias=False,
                            padding=1 if stride == 1 else 0)
        self.conv2_bn = _bn(depth_bottleneck, bn_momentum)
        self.conv3 = Conv2d(depth_bottleneck, depth, 1, bias=False)
        self.conv3_bn = _bn(depth, bn_momentum)

    def forward(self, x):
        if self.identity:
            shortcut = x if self.stride == 1 else x[:, :, ::self.stride,
                                                    ::self.stride]
        else:
            shortcut = self.shortcut_bn(self.shortcut(x))
        r = F.relu(self.conv1_bn(self.conv1(x)))
        r = F.relu(self.conv2_bn(conv2d_same(r, self.conv2, 3, self.stride)))
        r = self.conv3_bn(self.conv3(r))
        return F.relu(shortcut + r)


class ResNetV1(nn.Module):
    """Slim resnet_v1_{50,101,152}: root conv+pool, 4 bottleneck blocks.

    ``forward`` takes NCHW and returns the pre-pool NCHW feature map
    (B, 2048, h, w) in ``dtype`` when ``global_pool=False``, else
    (B, 2048).  The convs are drawn from ``generator`` as Flax draws
    them; the parameters are float32 whatever ``dtype``.  With
    ``remat_units`` each bottleneck is rematerialized in the backward
    (when gradients are on).
    """

    def __init__(self, stage_sizes: Sequence[int],
                 stage_strides: Sequence[int] = (2, 2, 2, 1),
                 bn_momentum: float = 0.997,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32,
                 remat_units: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat_units = remat_units
        self.conv1 = Conv2d(3, 64, 7, stride=2, bias=False)
        self.conv1_bn = _bn(64, bn_momentum)
        self.unit_names = []
        depth_in = 64
        for b, (num_units, block_stride) in enumerate(
                zip(stage_sizes, stage_strides), start=1):
            base_depth = 64 * (2 ** (b - 1))
            for u in range(1, num_units + 1):
                # slim: the stride applies to the LAST unit of the block
                unit_stride = block_stride if u == num_units else 1
                name = f"block{b}/unit_{u}"
                self.add_module(name, Bottleneck(
                    depth_in, base_depth * 4, base_depth, unit_stride,
                    bn_momentum))
                self.unit_names.append(name)
                depth_in = base_depth * 4
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)

    def forward(self, x, global_pool: bool = True):
        x = x.to(self.dtype)
        x = conv2d_same(x, self.conv1, 7, 2)
        x = F.relu(self.conv1_bn(x))
        x = max_pool_same(x)
        remat = self.remat_units and torch.is_grad_enabled()
        for name in self.unit_names:
            unit = self._modules[name]
            if remat:
                # no RNG in a unit, and its recompute's shapes are its
                # forward's: checkpoint's two checks would only add host
                # time to a host-bound step
                x = torch.utils.checkpoint.checkpoint(
                    unit, x, use_reentrant=False, preserve_rng_state=False,
                    determinism_check="none",
                    context_fn=functools.partial(_remat_contexts, unit))
            else:
                x = unit(x)
        if global_pool:
            x = x.mean(dim=(2, 3))
        return x


resnet_v1_50 = functools.partial(ResNetV1, stage_sizes=(3, 4, 6, 3))
resnet_v1_101 = functools.partial(ResNetV1, stage_sizes=(3, 4, 23, 3))
resnet_v1_152 = functools.partial(ResNetV1, stage_sizes=(3, 8, 36, 3))

BACKBONES = {
    "resnet_v1_50": resnet_v1_50,
    "resnet_v1_101": resnet_v1_101,
    "resnet_v1_152": resnet_v1_152,
}
