"""The port's attentional pooling ops vs the JAX package's, on the same
numpy inputs at the shapes of tests/test_attn_pool.py.  Tolerance: 1e-5
of the output's largest magnitude (both sides sum in float32, in
different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentionalpoolingaction_tpu.ops import attn_pool as jax_ops
from attentionalpoolingaction_torch.ops import attn_pool as torch_ops

torch.set_num_threads(2)

RTOL = 1e-5


def make_inputs(seed, b=2, n=49, f=64, c=11, p=1):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(b, n, f)).astype(np.float32),
        "attn_w": (rng.normal(size=(f, c, p)) * 0.1).astype(np.float32),
        "attn_b": rng.normal(size=(c, p)).astype(np.float32),
        "sal_w": (rng.normal(size=(f, p)) * 0.1).astype(np.float32),
        "sal_b": rng.normal(size=(p,)).astype(np.float32),
    }


def both(fn_name, inputs, **kw):
    want = getattr(jax_ops, fn_name)(
        **{k: jnp.asarray(v) for k, v in inputs.items()}, **kw)
    got = getattr(torch_ops, fn_name)(
        **{k: torch.from_numpy(v) for k, v in inputs.items()}, **kw)
    return got, want


def assert_close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max() / scale
    assert err < rtol, f"relative error {err:.2e}"


@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("fn", ["attentional_pool_oracle",
                                "attentional_pool"])
def test_pool_matches_jax(fn, rank):
    got, want = both(fn, make_inputs(rank, p=rank))
    assert got.dtype == torch.float32
    assert_close(got, want)


def test_bf16_input_accumulates_f32():
    inputs = make_inputs(5)
    x16 = torch.from_numpy(inputs["x"]).to(torch.bfloat16)
    params = {k: torch.from_numpy(v) for k, v in inputs.items() if k != "x"}
    got = torch_ops.attentional_pool(x16, **params)
    assert got.dtype == torch.float32
    want = jax_ops.attentional_pool(
        jnp.asarray(inputs["x"]).astype(jnp.bfloat16),
        **{k: jnp.asarray(v) for k, v in inputs.items() if k != "x"})
    assert_close(got, want)     # same bf16 X, both upcast before summing


@pytest.mark.parametrize("rank", [1, 3])
def test_attention_maps_match_jax(rank):
    (top, bot), (jtop, jbot) = both("attention_maps",
                                    make_inputs(10 + rank, p=rank))
    assert_close(top, jtop)
    assert_close(bot, jbot)


@pytest.mark.parametrize("class_idx", [3, [4, 0]])
def test_attention_maps_class_idx_match_jax(class_idx):
    """A scalar class, and one class per example (lines 106-114)."""
    (top, bot), (jtop, jbot) = both("attention_maps", make_inputs(20, p=2),
                                    class_idx=class_idx)
    assert top.shape == (2, 49)
    assert_close(top, jtop)
    assert_close(bot, jbot)


def test_init_attn_pool_params_shapes():
    g = torch.Generator().manual_seed(0)
    params = torch_ops.init_attn_pool_params(g, 64, 11, rank=3, stddev=0.5)
    assert params["attn_w"].shape == (64, 11, 3)
    assert params["attn_b"].shape == (11, 3)
    assert params["sal_w"].shape == (64, 3)
    assert params["sal_b"].shape == (3,)
    assert float(params["attn_w"].abs().max()) <= 2 * 0.5
    assert not params["attn_b"].any() and not params["sal_b"].any()
