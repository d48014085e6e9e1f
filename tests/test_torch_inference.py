"""The port's BN-folded float and int8 forward (``models/inference.py``)
against the JAX package's ``models/inference.py`` on the same weights.

resnet_v1_50 at 64 px, 11 classes, rank 2, weights from ``ActionModel.init``
(seed 0) with batch statistics from one train-mode apply, so that the fold
has a mean and a variance to fold (as ``tests/test_inference.py``).

Tolerances, each with its reason:

  * Folded float forward: rtol 1e-4 and atol 1e-4 of the largest |logit|,
    against the port's ``ActionModel`` and against JAX's
    ``folded_forward`` (float32 convolutions summed in another order).
  * Quantized weights: ``kernel_q`` bit for bit (one float32 division and
    a round half to even).  The BN fold's scale within one float32 ulp
    (XLA's float32 rsqrt on the CPU is not correctly rounded; the port
    takes ``1/sqrt(var + eps)`` in float64 and rounds once), so the
    dequantization scale within two and the bias within 2.4e-7 of its
    largest magnitude.
  * int32 accumulators: bit for bit, against JAX's int32
    ``conv_general_dilated`` and a float64 ``F.conv2d`` of the same int8
    values (exact: every partial sum is below 2^53).
  * The int8 forward against JAX's eager one, measured here, per-example
    and static scales, float32 and bfloat16 activations.  Given JAX's
    folded weights and static scales, the port's int8 arithmetic gives the
    same quantized activations at every conv and the same features bit
    for bit; the logits within 7e-7 in relative L2 (the head's float32
    sums).  Bounds: features equal, no activation off, logits 1e-5.  With
    the port's own fold and calibration, the fold's ulps (and the float
    calibration pass's sums in another order) move activations across
    rounding boundaries of the quantizer, and each move spreads through
    the later layers and their per-example scales: features 0.4-2.4% and
    logits 0.5-1.6% in relative L2, 0.06-7.3% of the quantized
    activations off (by up to 6 levels).  Bounds: 5%, 4%, 15%.
  * int8 vs float on the port alone: the JAX package's own cosine checks
    (features > 0.98, logits > 0.9).

The card test (marked ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_inference.py`` on the card's machine, which has no JAX:
this file imports JAX inside the tests that compare with it) holds the
int8 conv through CUDA's ``torch._int_mm`` against the CPU's float64
accumulator at every conv shape of ResNet-101 at 224 px.
"""

import dataclasses
import importlib
import tempfile

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import evaluate as eval_lib
from attentionalpoolingaction_torch import train as train_lib
from attentionalpoolingaction_torch.data import records
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_torch.models import inference as inf
from attentionalpoolingaction_torch.models.action_model import (
    ActionModel as TorchModel,
)

torch.set_num_threads(2)
BACKBONE = "resnet_v1_50"
SIZE = 64
_VARIABLES: dict = {}


def jax_modules():
    """(jax, jax.numpy, jax.lax, the JAX package's inference module)."""
    return tuple(importlib.import_module(m) for m in (
        "jax", "jax.numpy", "jax.lax",
        "attentionalpoolingaction_tpu.models.inference"))


def variables(pooling="attention"):
    """Flax-layout numpy weights with non-trivial batch statistics."""
    if pooling not in _VARIABLES:
        jax, jnp, _, _ = jax_modules()
        from attentionalpoolingaction_tpu.models.action_model import (
            ActionModel)

        model = ActionModel(num_classes=11, backbone=BACKBONE,
                            pooling=pooling, rank=2)
        v = model.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)),
                       train=False)
        warm = jax.random.normal(jax.random.key(1), (2, SIZE, SIZE, 3))
        _, upd = model.apply(v, warm, train=True, mutable=["batch_stats"])
        _VARIABLES[pooling] = jax.tree.map(
            np.asarray, {"params": v["params"],
                         "batch_stats": upd["batch_stats"]})
    return _VARIABLES[pooling]


def images(seed, shape=(2, SIZE, SIZE, 3)):
    return np.random.default_rng(seed).normal(0, 30, shape).astype(
        np.float32)


def port_forward(v, x, **kw):
    folded = inf.fold_backbone(v, BACKBONE, device="cpu")
    heads = inf.head_weights(v["params"], "cpu")
    with torch.inference_mode():
        return inf.folded_forward(folded, heads["head"], torch.from_numpy(x),
                                  backbone=BACKBONE, **kw)


def close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("variant", ["attention", "avg", "pose", "clip",
                                     "dot_1x1"])
def test_folded_float_matches_model_and_jax(variant):
    pooling = {"pose": "pose_attention", "clip": "attention",
               "dot_1x1": "attention"}.get(variant, variant)
    _, jnp, _, jinf = jax_modules()
    v = variables(pooling)
    shape = (1, 3, SIZE, SIZE, 3) if variant == "clip" else (
        2, SIZE, SIZE, 3)
    x = images(2, shape)
    kw = dict(pooling="avg" if variant == "avg" else "attention",
              dtype=torch.float32)
    jkw = dict(pooling=kw["pooling"], dtype=jnp.float32)
    if variant == "dot_1x1":          # 1x1 stride-1 convs as matmuls
        kw["dot_1x1"] = jkw["dot_1x1"] = True
    if variant == "pose":
        kw["pose_head"] = inf.head_weights(v["params"], "cpu")["pose_head"]
        jkw["pose_head"] = v["params"]["pose_head"]
    got = port_forward(v, x, **kw)
    want = jinf.folded_forward(jinf.fold_backbone(v, BACKBONE),
                               v["params"]["head"], x, backbone=BACKBONE,
                               **jkw)
    model = TorchModel(11, BACKBONE, pooling, rank=2, image_size=SIZE)
    convert.load_flax_variables(model, v["params"], v["batch_stats"])
    with torch.inference_mode():
        ref = model.eval()(torch.from_numpy(x))
    keys = ("logits", "pose_heatmaps") if variant == "pose" else ("logits",)
    for k in keys + ("features",):
        close(got[k].numpy(), ref[k].numpy())
        close(got[k].numpy(), want[k])


def test_quantized_weights_match_jax():
    _, _, _, jinf = jax_modules()
    v = variables()
    jfolded = jinf.fold_backbone(v, BACKBONE)
    folded = inf.fold_backbone(v, BACKBONE, device="cpu")
    np.testing.assert_array_max_ulp(folded["conv1"]["scale"].numpy(),
                                    np.asarray(jfolded["conv1"]["scale"]), 1)
    want = jinf.quantize_folded(jfolded)
    got = inf.quantize_folded(folded)

    def layers(tree, prefix=""):
        for k, layer in tree.items():
            if "kernel_q" in layer:
                yield prefix + k, layer
            else:
                yield from layers(layer, prefix + k + "/")

    jl = dict(layers(want))
    n = 0
    for name, layer in layers(got):
        jlayer = jl[name]
        # OIHW -> HWIO
        np.testing.assert_array_equal(
            layer["kernel_q"].permute(2, 3, 1, 0).numpy(),
            np.asarray(jlayer["kernel_q"]), err_msg=name)
        # wscale (equal) times the fold's scale (one ulp): two ulps
        np.testing.assert_array_max_ulp(layer["scale"].numpy(),
                                        np.asarray(jlayer["scale"]), 2)
        bias = np.asarray(jlayer["bias"])
        np.testing.assert_allclose(layer["bias"].numpy(), bias, rtol=0,
                                   atol=2.4e-7 * np.abs(bias).max(),
                                   err_msg=name)
        n += 1
    assert n == len(jl) == 53


# (name, in channels, kernel, stride, out channels, input size): the root
# conv (K = 147, padded to 152), a 3x3 at stride 1 and 2, a strided 1x1
ACC_CASES = {"conv1": (3, 7, 2, 64, SIZE), "3x3": (64, 3, 1, 64, 16),
             "3x3-s2": (128, 3, 2, 128, 8), "1x1-s2": (256, 1, 2, 512, 8)}


@pytest.mark.parametrize("case", ACC_CASES)
def test_int8_accumulator_is_bit_equal(case):
    _, jnp, lax, _ = jax_modules()
    cin, k, stride, cout, size = ACC_CASES[case]
    rng = np.random.default_rng(3)
    if case == "conv1":
        # the first int8 conv of the forward: the input quantized per
        # example against its absmax, the root conv's quantized weights
        x = torch.from_numpy(images(4))
        xq = torch.round(x / inf._act_scale(x, "conv1", None)).clamp_(
            -127, 127).to(torch.int8)
        wq = inf.quantize_folded(inf.fold_backbone(
            variables(), BACKBONE, device="cpu"))["conv1"]["kernel_q"]
    else:
        xq = torch.from_numpy(rng.integers(-127, 128, (2, size, size, cin),
                                           dtype=np.int8))
        wq = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k),
                                           dtype=np.int8))
    got = inf._int8_conv(xq, wq, k, stride)
    assert got.dtype == torch.int32
    beg, end = inf._same_pads(k)
    xp = F.pad(xq.permute(0, 3, 1, 2).double(), (beg, end, beg, end)) \
        if stride != 1 else xq.permute(0, 3, 1, 2).double()
    want64 = F.conv2d(xp, wq.double(), stride=stride,
                      padding=beg if stride == 1 else 0)
    np.testing.assert_array_equal(got.numpy(),
                                  want64.permute(0, 2, 3, 1).numpy())
    jx = jnp.asarray(xq.numpy())
    if stride != 1:
        jx = jnp.pad(jx, [(0, 0), (beg, end), (beg, end), (0, 0)])
    jacc = lax.conv_general_dilated(
        jx, jnp.asarray(wq.permute(2, 3, 1, 0).numpy()), (stride, stride),
        "SAME" if stride == 1 else "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jacc))


def _quantized_inputs(monkeypatch):
    """Record every int8 conv input, the port's and JAX's, in call order."""
    _, jnp, lax, jinf = jax_modules()
    seen = {"port": [], "jax": []}
    port_conv = inf._int8_conv

    def record_port(xq, kernel_q, k, stride):
        x = xq.numpy()
        if stride != 1:                   # JAX pads a strided conv's input
            beg, end = inf._same_pads(k)
            x = np.pad(x, [(0, 0), (beg, end), (beg, end), (0, 0)])
        seen["port"].append(x)
        return port_conv(xq, kernel_q, k, stride)

    class Lax:
        def __getattr__(self, name):
            return getattr(lax, name)

        @staticmethod
        def conv_general_dilated(x, *a, **kw):
            if x.dtype == jnp.int8:
                seen["jax"].append(np.asarray(x))
            return lax.conv_general_dilated(x, *a, **kw)

    monkeypatch.setattr(inf, "_int8_conv", record_port)
    monkeypatch.setattr(jinf, "lax", Lax())
    return seen


def port_layout(jfolded):
    """JAX's folded backbone in the port's layout (OIHW tensors)."""
    def conv(layer):
        if "kernel" not in layer:
            return {k: conv(v) for k, v in layer.items()}
        return {"kernel": torch.from_numpy(np.array(
                    layer["kernel"])).permute(3, 2, 0, 1).contiguous(),
                "scale": torch.from_numpy(np.array(layer["scale"])),
                "bias": torch.from_numpy(np.array(layer["bias"]))}
    return {k: conv(v) for k, v in jfolded.items()}


def int8_gap(got, want, seen) -> dict:
    return {"features": rel_l2(got["features"], want["features"]),
            "logits": rel_l2(got["logits"], want["logits"]),
            "off": sum(int((a != b).sum()) for a, b in zip(
                seen["port"], seen["jax"])) / sum(
                    a.size for a in seen["jax"]),
            "levels": max(int(np.abs(a.astype(int) - b).max())
                          for a, b in zip(seen["port"], seen["jax"]))}


# bounds on (features, logits in relative L2, the share of quantized
# activations off, by how many levels): with JAX's fold and scales in the
# port too (its int8 arithmetic alone), and with the port's own fold and
# calibration (measured: module docstring)
SAME_FOLD = (0.0, 1e-5, 0.0, 0)
OWN_FOLD = (0.05, 0.04, 0.15, 127)
INT8_CASES = [("dynamic", "float32"), ("dynamic", "bfloat16"),
              ("static", "float32"), ("static", "bfloat16")]


@pytest.mark.parametrize("scales, dtype", INT8_CASES)
def test_int8_forward_matches_jax(scales, dtype, monkeypatch):
    _, jnp, _, jinf = jax_modules()
    v = variables()
    head = v["params"]["head"]
    heads = inf.head_weights(v["params"], "cpu")
    x = images(5)
    jfolded = jinf.fold_backbone(v, BACKBONE)
    folded = inf.fold_backbone(v, BACKBONE, device="cpu")
    jscales = tscales = None
    if scales == "static":
        jscales = jinf.calibrate_act_scales(jfolded, head, [x],
                                            backbone=BACKBONE)
        tscales = inf.calibrate_act_scales(folded, heads["head"], [x],
                                           backbone=BACKBONE)
        assert tscales.keys() == jscales.keys()
        for cid in jscales:
            assert tscales[cid] == pytest.approx(jscales[cid], rel=1e-5)
    seen = _quantized_inputs(monkeypatch)
    want = jinf.folded_forward(jinf.quantize_folded(jfolded), head, x,
                               backbone=BACKBONE, act_scales=jscales,
                               dtype=getattr(jnp, dtype))
    gaps = []
    for f, sc in ((port_layout(jfolded), jscales), (folded, tscales)):
        port_seen = seen["port"] = []
        with torch.inference_mode():
            got = inf.folded_forward(inf.quantize_folded(f), heads["head"],
                                     torch.from_numpy(x), backbone=BACKBONE,
                                     act_scales=sc,
                                     dtype=getattr(torch, dtype))
        assert len(port_seen) == len(seen["jax"]) == 53
        gaps.append(int8_gap(got, want, seen))
    for gap, bound in zip(gaps, (SAME_FOLD, OWN_FOLD)):
        assert all(g <= b for g, b in zip(gap.values(), bound)), gaps


@pytest.mark.parametrize("scales", ["dynamic", "static"])
def test_int8_close_to_float(scales):
    v = variables()
    x = images(6)
    folded = inf.fold_backbone(v, BACKBONE, device="cpu")
    head = inf.head_weights(v["params"], "cpu")["head"]
    act_scales = (inf.calibrate_act_scales(folded, head, [x],
                                           backbone=BACKBONE)
                  if scales == "static" else None)
    with torch.inference_mode():
        ref = inf.folded_forward(folded, head, torch.from_numpy(x),
                                 backbone=BACKBONE, dtype=torch.float32)
        got = inf.folded_forward(inf.quantize_folded(folded), head,
                                 torch.from_numpy(x), backbone=BACKBONE,
                                 act_scales=act_scales, dtype=torch.float32)
    assert cosine(got["features"], ref["features"]) > 0.98
    assert cosine(got["logits"], ref["logits"]) > 0.9
    # the convenience wrapper folds, calibrates and quantizes alike
    fwd = inf.make_int8_forward(
        v, backbone=BACKBONE, dtype=torch.float32, device="cpu",
        calibration_batches=[x] if scales == "static" else None)
    assert torch.equal(fwd(torch.from_numpy(x))["logits"], got["logits"])


def test_int8_eval_step_and_evaluate(monkeypatch):
    """``eval_int8`` routes ``evaluate`` through the quantized path (an mAP
    over 6 records); the step folds and quantizes again only for another
    params object, and gives JAX's int8 eval logits."""
    from attentionalpoolingaction_tpu import evaluate as jax_eval
    from attentionalpoolingaction_tpu.config import TrainConfig as JaxConfig

    spec = get_dataset("mpii")
    kw = dict(dataset="mpii", backbone=BACKBONE, pooling="attention",
              rank=1, image_size=SIZE, batch_size=4, bf16_backbone=False,
              resize_min=72, eval_batch_size=4, eval_int8=True)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/val.tfrecord"
        records.write_synthetic_dataset(path, spec, 6, image_size=72,
                                        seed=1)
        cfg = config_lib.TrainConfig(eval_pattern=path, **kw)
        state, _ = train_lib.create_state(cfg, device="cpu")
        res = eval_lib.evaluate(cfg, state, device="cpu")
    assert res["num_examples"] == 6 and np.isfinite(res["mAP"])

    quantized = []
    quantize = inf.quantize_folded
    monkeypatch.setattr(inf, "quantize_folded",
                        lambda f: quantized.append(1) or quantize(f))
    params, stats = convert.state_dict_to_flax(state.model.state_dict())
    step = eval_lib.make_int8_eval_step(cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (2, SIZE, SIZE, 3), np.uint8))
    a = step(params, stats, x)
    b = step(params, stats, x)
    assert len(quantized) == 1 and torch.equal(a, b)
    again = convert.state_dict_to_flax(state.model.state_dict())
    assert torch.equal(step(*again, x), a) and len(quantized) == 2
    assert a.shape == (2, 393)
    # JAX's step is jitted: XLA fuses the quantizer's arithmetic, which
    # moves a few activations across a rounding boundary (measured 2.0%)
    want = jax_eval.make_int8_eval_step(JaxConfig(**kw))(params, stats,
                                                         x.numpy())
    assert rel_l2(a.numpy(), want) <= 0.05


def _resnet101_convs():
    """(in channels, kernel, stride, out channels, input size) of every
    conv of ResNet-101 at 224 px, as the folded forward walks them."""
    convs = {(3, 7, 2, 64, 224)}
    size, depth_in = 56, 64               # after the root conv and pool
    for b, (units, stride) in enumerate(zip((3, 4, 23, 3), (2, 2, 2, 1))):
        base = 64 * 2 ** b
        for u in range(units):
            s = stride if u == units - 1 else 1
            if depth_in != base * 4:      # a projection shortcut
                convs.add((depth_in, 1, s, base * 4, size))
            out = -(-size // s)
            convs |= {(depth_in, 1, 1, base, size), (base, 3, s, base, size),
                      (base, 1, 1, base * 4, out)}
            size, depth_in = out, base * 4
    return sorted(convs)


@pytest.mark.cuda
def test_int8_conv_on_the_card_equals_the_cpu_accumulator():
    """Every int8 conv shape of ResNet-101 at 224 px, at buckets 1 and 32
    (stage 4 at bucket 1: 49 rows), through ``torch._int_mm`` on the card:
    bit for bit the float64 accumulator of the same int8 values on the
    CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    for batch in (1, 32):
        for cin, k, stride, cout, size in _resnet101_convs():
            xq = torch.from_numpy(rng.integers(
                -127, 128, (batch, size, size, cin), dtype=np.int8))
            wq = torch.from_numpy(rng.integers(
                -127, 128, (cout, cin, k, k), dtype=np.int8))
            got = inf._int8_conv(xq.cuda(), wq.cuda(), k, stride).cpu()
            beg, end = inf._same_pads(k)
            x64 = xq.permute(0, 3, 1, 2).double()
            if stride != 1:
                x64 = F.pad(x64, (beg, end, beg, end))
            want = F.conv2d(x64, wq.double(), stride=stride,
                            padding=beg if stride == 1 else 0)
            assert torch.equal(got, want.permute(0, 2, 3, 1).to(
                torch.int32)), (batch, cin, k, stride, cout, size)
