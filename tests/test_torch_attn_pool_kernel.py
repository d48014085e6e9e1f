"""The port's fused pooling wrappers (ops/attn_pool_cuda.py) vs the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.

On the CPU the wrappers run their plain versions; the CUDA kernels are
held against those plain versions by the test marked ``cuda`` (skipped
without a card) and by chip_smoke.py.  Tolerances: 1e-5 of the output's
largest magnitude in float32 (sums in another order); 2e-2 for bf16 X,
the bound of the JAX package's own test_fused_bf16_input (its kernel
rounds s to bf16 before the second contraction, the port keeps f32).
"""

import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch.ops import _build
from attentionalpoolingaction_torch.ops import attn_pool_cuda as apc

from kernel_trace import traced

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pallas():
    """The JAX package's Pallas module.  Imported here, not at the top, so
    that the ``cuda`` test of this file also runs where JAX is absent (run
    it with ``python -m pytest --noconftest -m cuda`` on such a machine)."""
    return pytest.importorskip(
        "attentionalpoolingaction_tpu.ops.attn_pool_pallas")


def make_inputs(seed, b=2, n=49, f=256, c=11, p=1):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(b, n, f)).astype(np.float32),
        "attn_w": (rng.normal(size=(f, c, p)) * 0.05).astype(np.float32),
        "attn_b": rng.normal(size=(c, p)).astype(np.float32),
        "sal_w": (rng.normal(size=(f, p)) * 0.05).astype(np.float32),
        "sal_b": rng.normal(size=(p,)).astype(np.float32),
    }


def rel_err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def torch_args(inputs, x_dtype=torch.float32):
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    t["x"] = t["x"].to(x_dtype)
    return t


def jax_args(inputs, x_dtype="float32"):
    import jax.numpy as jnp

    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    j["x"] = j["x"].astype(x_dtype)
    return j


@pytest.mark.parametrize("rank", [1, 4])
def test_fused_pool_logits_matches_pallas(pallas, rank):
    inputs = make_inputs(rank, p=rank)
    logits, v, s = apc.fused_pool_logits(**torch_args(inputs))
    jl, jv, js = pallas.fused_pool_logits(**jax_args(inputs), interpret=True)
    assert logits.dtype == v.dtype == s.dtype == torch.float32
    for got, want in ((logits, jl), (v, jv), (s, js)):
        assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("rank", [1, 4])
def test_saliency_summary_matches_pallas(pallas, rank):
    inputs = make_inputs(10 + rank, b=4, p=rank)
    t, j = torch_args(inputs), jax_args(inputs)
    v, s = apc.saliency_summary(t["x"], t["sal_w"], t["sal_b"])
    jv, js = pallas.saliency_summary(j["x"], j["sal_w"], j["sal_b"],
                                     interpret=True)
    assert v.shape == (4, rank, 256) and s.shape == (4, rank, 49)
    assert rel_err(v, jv) < 1e-5
    assert rel_err(s, js) < 1e-5


def test_fused_bf16_input(pallas):
    inputs = make_inputs(7)
    logits, _, _ = apc.fused_pool_logits(**torch_args(inputs, torch.bfloat16))
    assert logits.dtype == torch.float32
    jl, _, _ = pallas.fused_pool_logits(**jax_args(inputs, "bfloat16"),
                                        interpret=True)
    assert rel_err(logits, jl) < 2e-2


def test_attentional_pool_fused_is_the_projection_of_the_summary():
    """fused = saliency_summary, then project_logits on the (P, F, C)
    copy of attn_w; the long way round gives the same logits."""
    t = torch_args(make_inputs(3, p=2))
    v, s = apc.saliency_summary(t["x"], t["sal_w"], t["sal_b"])
    want = apc.project_logits(v, s, apc.attn_w_pfc(t["attn_w"]), t["attn_b"])
    got = apc.attentional_pool_fused(**t)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad, exc", [
    ({"x": torch.zeros(2, 49, 256, dtype=torch.float16)}, TypeError),
    ({"x": torch.zeros(2, 49, 256, dtype=torch.int32)}, TypeError),
    ({"x": torch.zeros(49, 256)}, ValueError),
    ({"sal_w": torch.zeros(128, 1)}, ValueError),
    ({"sal_w": torch.zeros(256, 9), "sal_b": torch.zeros(9)}, ValueError),
    ({"sal_b": torch.zeros(2)}, ValueError),
    ({"sal_w": torch.zeros(256, 1, dtype=torch.float64)}, TypeError),
])
def test_saliency_summary_rejects_bad_operands(bad, exc):
    t = torch_args(make_inputs(0))
    args = {"x": t["x"], "sal_w": t["sal_w"], "sal_b": t["sal_b"], **bad}
    with pytest.raises(exc):
        apc.saliency_summary(**args)


@pytest.mark.parametrize("bad, exc", [
    ({"attn_b": torch.zeros(12, 1)}, ValueError),
    ({"w_pfc": torch.zeros(1, 128, 11)}, ValueError),
    ({"v": torch.zeros(2, 1, 256, dtype=torch.bfloat16)}, TypeError),
])
def test_project_logits_rejects_bad_operands(bad, exc):
    t = torch_args(make_inputs(0))
    v, s = apc.saliency_summary(t["x"], t["sal_w"], t["sal_b"])
    args = {"v": v, "s": s, "w_pfc": apc.attn_w_pfc(t["attn_w"]),
            "attn_b": t["attn_b"], **bad}
    with pytest.raises(exc):
        apc.project_logits(**args)


def test_cpu_path_neither_builds_nor_counts():
    """Importing and running on CPU tensors compiles nothing from csrc/,
    so no kernel can run."""
    apc.fused_pool_logits(**torch_args(make_inputs(1)))
    assert not _build.ATTN_POOL.loaded()
    assert not _build.ATTN_POOL_BACKWARD.loaded()


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, n, f, c, p", [
    (1, 49, 2048, 393, 1), (32, 49, 2048, 393, 1), (3, 196, 2048, 600, 5),
    # ragged and edge shapes: B=5, C=600, N=225 at P=8, the hmdb51_clip8
    # clip (N=392), N=1000 (the L2 re-read path), F=256 at a 16-CTA cluster,
    # B=33 (two image tiles on a slab of A kept in shared memory)
    (5, 225, 2048, 600, 8), (8, 392, 2048, 51, 1), (2, 1000, 2048, 51, 1),
    (1, 49, 256, 11, 1), (33, 49, 2048, 393, 1)])
def test_kernels_match_plain_on_card(x_dtype, b, n, f, c, p):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    t = torch_args(make_inputs(b + p, b=b, n=n, f=f, c=c, p=p), x_dtype)
    t = {k: v.cuda() for k, v in t.items()}
    if n == 1000:
        assert apc.saliency_plan(b, n, f, p, x_dtype).path == "l2_reread"
    if f == 256:
        assert apc.saliency_plan(b, n, f, p, x_dtype).cluster == 16
    if b == 33:
        assert apc.project_plan(b, n, f, c, p).a_resident
    with torch.no_grad():
        ((logits, v, s), again), trace = traced(
            lambda: (apc.fused_pool_logits(**t), apc.fused_pool_logits(**t)))
    assert trace.launches == {"saliency_summary": 2, "project_logits": 2,
                              "pool_backward": 0, "ycc_to_rgb": 0}
    for first, second in zip((logits, v, s), again):
        assert torch.equal(first, second)      # the same bits, run to run
    pv, ps = apc.saliency_summary_plain(t["x"], t["sal_w"], t["sal_b"])
    pl = apc.project_logits_plain(pv, ps, apc.attn_w_pfc(t["attn_w"]),
                                  t["attn_b"])
    for got, want in ((logits, pl), (v, pv), (s, ps)):
        assert rel_err(got.cpu(), want.cpu()) < 1e-5
