"""Gradients of the port's fused attentional pooling
(``AttentionalPoolFn``: the kernels' forward, ``fused_pool_backward``,
whose plain version is the JAX package's ``_fused_bwd`` in torch ops) vs
``jax.vjp`` of the JAX package's
``attentional_pool_fused`` (Pallas, interpret mode) and of its factorized
``ops/attn_pool.py::attentional_pool``, on the same numpy inputs and
cotangent, on the CPU; the head's cached (P, F, C) copy of ``attn_w``.

Tolerances, of each gradient's largest magnitude: 1e-5 in float32 (sums
in other orders); 2e-2 with bf16 X, the bound of the JAX package's own
bf16 test (its kernel rounds s to bf16 before the second contraction, the
port keeps float32, and dx is rounded to bf16 at the end on both sides).
The tests marked ``cuda`` hold the Function on the card, through the
kernels, against torch autograd through the plain forward, and the
backward kernel (``pool_backward``) against ``fused_pool_backward_plain``
on the same saved tensors: 1e-5, and 1e-2 for a bf16 dx (one bf16
rounding, 2^-8, of sums taken in another order); two launches of the
backward give the same bits.
"""

import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch.models.heads import AttentionalPoolingHead
from attentionalpoolingaction_torch.ops import attn_pool_cuda as apc

torch.set_num_threads(2)

NAMES = ("x", "attn_w", "attn_b", "sal_w", "sal_b")


def make_inputs(seed, b=2, n=49, f=256, c=11, p=1):
    rng = np.random.default_rng(seed)
    inputs = {
        "x": np.maximum(rng.normal(size=(b, n, f)), 0).astype(np.float32),
        "attn_w": (rng.normal(size=(f, c, p)) * 0.05).astype(np.float32),
        "attn_b": rng.normal(size=(c, p)).astype(np.float32),
        "sal_w": (rng.normal(size=(f, p)) * 0.05).astype(np.float32),
        "sal_b": rng.normal(size=(p,)).astype(np.float32),
    }
    return inputs, rng.normal(size=(b, c)).astype(np.float32)


def rel_err(got, want):
    got, want = (t.float().numpy() if isinstance(t, torch.Tensor) else t
                 for t in (got, want))
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def port_grads(inputs, g, x_dtype, device="cpu"):
    t = {k: torch.from_numpy(v).to(device).requires_grad_()
         for k, v in inputs.items()}
    t["x"] = t["x"].detach().to(x_dtype).requires_grad_()
    logits = apc.attentional_pool_fused(*(t[k] for k in NAMES))
    logits.backward(torch.from_numpy(g).to(device))
    return logits.detach(), [t[k].grad for k in NAMES]


def jax_grads(fn, inputs, g, x_dtype):
    import jax
    import jax.numpy as jnp

    args = [jnp.asarray(inputs[k]) for k in NAMES]
    args[0] = args[0].astype(x_dtype)
    logits, vjp = jax.vjp(fn, *args)
    return logits, vjp(jnp.asarray(g))


@pytest.fixture(scope="module")
def jax_fns():
    """The JAX package's fused (Pallas, interpret mode) and factorized
    pooling.  Imported here, not at the top, so that the ``cuda`` test of
    this file also runs where JAX is absent."""
    pallas = pytest.importorskip(
        "attentionalpoolingaction_tpu.ops.attn_pool_pallas")
    from attentionalpoolingaction_tpu.ops import attn_pool

    return {"pallas": lambda *a: pallas.attentional_pool_fused(*a, True),
            "factorized": attn_pool.attentional_pool}


@pytest.mark.parametrize("ref", ["pallas", "factorized"])
@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grads_match_jax_vjp(jax_fns, ref, rank, dtype):
    inputs, g = make_inputs(rank + (dtype == "bfloat16"), p=rank)
    x_dtype = getattr(torch, dtype)
    logits, grads = port_grads(inputs, g, x_dtype)
    want_logits, want = jax_grads(jax_fns[ref], inputs, g, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert rel_err(logits, want_logits) < tol
    assert grads[0].dtype == x_dtype
    for name, got, w in zip(NAMES, grads, want):
        assert got.shape == w.shape, name
        assert rel_err(got, w) < tol, name


def test_backward_is_the_plain_autograd():
    """The hand-written backward, which reads attn_w through its (P, F, C)
    copy, equals torch autograd through the plain forward."""
    inputs, g = make_inputs(9, p=2)
    _, grads = port_grads(inputs, g, torch.float32)
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in inputs.items()}
    v, s = apc.saliency_summary_plain(t["x"], t["sal_w"], t["sal_b"])
    logits = apc.project_logits_plain(
        v, s, t["attn_w"].permute(2, 0, 1), t["attn_b"])
    logits.backward(torch.from_numpy(g))
    for name, got in zip(NAMES, grads):
        assert rel_err(got, t[name].grad) < 1e-5, name


def test_backward_is_once_differentiable():
    inputs, _ = make_inputs(4)
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in inputs.items()}
    out = apc.attentional_pool_fused(*(t[k] for k in NAMES)).sum()
    (gx,) = torch.autograd.grad(out, t["x"], create_graph=True)
    with pytest.raises(RuntimeError):
        gx.sum().backward()


def test_head_remakes_w_pfc_once_a_step():
    """The head's (P, F, C) copy of attn_w is cached across forwards and
    remade after the optimizer's in-place update (attn_w's version
    counter), once a step; attn_w still gets its gradient."""
    head = AttentionalPoolingHead(64, 7, rank=2, num_positions=4,
                                  generator=torch.Generator().manual_seed(0))
    opt = torch.optim.SGD(head.parameters(), lr=0.1)
    feats = torch.randn(3, 2, 2, 64).relu()
    copies = []
    for _ in range(2):
        for _ in range(2):              # two forwards a step
            head(feats).sum().backward()
            copies.append(head.w_pfc())
        opt.step()
        opt.zero_grad()
    assert copies[0] is copies[1] and copies[2] is copies[3]
    assert copies[1] is not copies[2]
    latest = head.w_pfc()               # after the last step's update
    assert latest is not copies[3] and not latest.requires_grad
    torch.testing.assert_close(
        latest, head.attn_w.detach().permute(2, 0, 1), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, n, f, c, p", [
    (8, 49, 2048, 393, 1), (2, 49, 2048, 393, 2), (3, 196, 2048, 600, 5)])
def test_grads_on_card_match_plain_autograd(x_dtype, b, n, f, c, p):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs, g = make_inputs(b + p, b=b, n=n, f=f, c=c, p=p)
    apc.reset_launch_counts()
    _, grads = port_grads(inputs, g, x_dtype, device="cuda")
    torch.cuda.synchronize()
    assert apc.launch_counts == {"saliency_summary": 1, "project_logits": 1,
                                 "pool_backward": 1}
    t = {k: torch.from_numpy(v).cuda().requires_grad_()
         for k, v in inputs.items()}
    t["x"] = t["x"].detach().to(x_dtype).requires_grad_()
    v, s = apc.saliency_summary_plain(t["x"], t["sal_w"], t["sal_b"])
    logits = apc.project_logits_plain(
        v, s, t["attn_w"].permute(2, 0, 1), t["attn_b"])
    logits.backward(torch.from_numpy(g).cuda())
    for name, got in zip(NAMES, grads):
        tol = 1e-2 if name == "x" and x_dtype == torch.bfloat16 else 1e-5
        assert rel_err(got.cpu(), t[name].grad.cpu()) < tol, name


def test_cpu_backward_is_its_plain_version():
    """On CPU tensors fused_pool_backward is fused_pool_backward_plain,
    bit for bit, and launches nothing."""
    inputs, g = make_inputs(5, p=3)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    v, s = apc.saliency_summary_plain(t["x"], t["sal_w"], t["sal_b"])
    w_pfc = apc.attn_w_pfc(t["attn_w"])
    args = (t["x"], w_pfc, t["attn_b"], t["sal_w"], v, s,
            torch.from_numpy(g))
    apc.reset_launch_counts()
    got = apc.fused_pool_backward(*args)
    want = apc.fused_pool_backward_plain(*args)
    assert apc.launch_counts["pool_backward"] == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad, exc", [
    ("g_shape", ValueError), ("s_dtype", TypeError), ("x_ndim", ValueError)])
def test_backward_rejects_bad_operands(bad, exc):
    inputs, g = make_inputs(6)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    v, s = apc.saliency_summary_plain(t["x"], t["sal_w"], t["sal_b"])
    args = {"x": t["x"], "w_pfc": apc.attn_w_pfc(t["attn_w"]),
            "attn_b": t["attn_b"], "sal_w": t["sal_w"], "v": v, "s": s,
            "g": torch.from_numpy(g)}
    if bad == "g_shape":
        args["g"] = args["g"][:, :-1]
    elif bad == "s_dtype":
        args["s"] = args["s"].double()
    else:
        args["x"] = args["x"][0]
    with pytest.raises(exc):
        apc.fused_pool_backward(**args)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, n, f, c, p", [
    (8, 49, 2048, 393, 1), (32, 196, 2048, 600, 1), (3, 196, 2048, 600, 5),
    # the L2 re-read path, rank 8, a 16-CTA cluster of 16-column slices,
    # an hmdb51_rgb batch
    (2, 1000, 2048, 51, 1), (5, 225, 2048, 600, 8), (1, 49, 256, 11, 1),
    (64, 49, 2048, 51, 1)])
def test_backward_kernel_matches_its_plain_version(x_dtype, b, n, f, c, p):
    """pool_backward on the card against fused_pool_backward_plain on the
    same saved tensors and cotangent; two launches, the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs, g = make_inputs(b + n + p, b=b, n=n, f=f, c=c, p=p)
    t = {k: torch.from_numpy(v).cuda() for k, v in inputs.items()}
    x = t["x"].to(x_dtype)
    if n == 1000:
        assert apc.backward_plan(b, n, f, p, x_dtype).path == "l2_reread"
    v, s = apc.saliency_summary_plain(x, t["sal_w"], t["sal_b"])
    args = (x, apc.attn_w_pfc(t["attn_w"]), t["attn_b"], t["sal_w"], v, s,
            torch.from_numpy(g).cuda())
    apc.reset_launch_counts()
    got = apc.fused_pool_backward(*args)
    again = apc.fused_pool_backward(*args)
    torch.cuda.synchronize()
    assert apc.launch_counts["pool_backward"] == 2
    want = apc.fused_pool_backward_plain(*args)
    assert got[0].dtype == x_dtype and got[0].is_contiguous()
    for name, a, a2, w in zip(NAMES, got, again, want):
        assert torch.equal(a, a2), name
        tol = 1e-2 if name == "x" and x_dtype == torch.bfloat16 else 1e-5
        assert rel_err(a.cpu(), w.cpu()) < tol, name
