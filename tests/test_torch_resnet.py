"""The port's slim ResNet-v1 vs the Flax one, eval mode, with the Flax
weights carried across by convert.py.  Batch-norm statistics and affine
terms are randomized so that every BN does work.  Sizes: 64 and 96 px
(root max-pool padding (0, 1)) and 97 px (padding (1, 1)).  Tolerance:
1e-4 of the features' largest magnitude (float32 convolutions summed in
other orders across 16 units)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentionalpoolingaction_tpu.models import resnet as jax_resnet
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch.models import resnet as torch_resnet

torch.set_num_threads(2)


def randomize_bn(variables, seed=0):
    """Random BN scale/bias/mean/var (numpy), Flax kernels kept."""
    rng = np.random.default_rng(seed)

    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
                continue
            v = np.asarray(v)
            if k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return (walk(variables["params"], "params"),
            walk(variables["batch_stats"], "batch_stats"))


class _Wrap(torch.nn.Module):
    """Holds the backbone under the ``resnet.`` prefix the bridge emits."""

    def __init__(self):
        super().__init__()
        self.resnet = torch_resnet.resnet_v1_50().eval()


@pytest.fixture(scope="module")
def backbones():
    model = jax_resnet.resnet_v1_50()
    variables = model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    params, stats = randomize_bn(variables)
    wrap = _Wrap()
    convert.load_flax_variables(wrap, {"resnet": params},
                                {"resnet": stats})
    return model, {"params": params, "batch_stats": stats}, wrap.resnet


@pytest.mark.parametrize("size", [64, 96, 97])
def test_features_match_flax(backbones, size):
    jmodel, variables, tmodel = backbones
    x = np.random.default_rng(size).normal(
        0, 50, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                   global_pool=False))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2),
                     global_pool=False).permute(0, 2, 3, 1).numpy()
    hw = torch_resnet.feature_size(size)
    assert got.shape == want.shape == (2, hw, hw, 2048)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-4, f"relative error {err:.2e}"


@pytest.mark.parametrize("size, pads", [(112, [0, 1, 0, 1]),
                                        (225, [1, 1, 1, 1])])
def test_max_pool_same_padding(size, pads):
    """TF SAME pads (0, 1) at 112 px and (1, 1) at 225 px; the max-pool
    equals an explicit -inf pad then a VALID pool."""
    x = torch.randn(1, 2, size, size)
    want = torch.nn.functional.max_pool2d(
        torch.nn.functional.pad(x, pads, value=float("-inf")), 3, 2)
    got = torch_resnet.max_pool_same(x)
    assert got.shape[-1] == -(-size // 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_param_counts_match_slim():
    """Slim resnet_v1_50 / 101 backbones: 23,508,032 / 42,500,160 params
    (BN running statistics excluded)."""
    for fn, want in ((torch_resnet.resnet_v1_50, 23_508_032),
                     (torch_resnet.resnet_v1_101, 42_500_160)):
        with torch.device("meta"):
            model = fn()
        assert sum(p.numel() for p in model.parameters()) == want
