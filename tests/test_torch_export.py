"""The port's exported serving artifacts (``export.py``, ``torch.export``)
on the CPU: the JAX package's ``tests/test_export.py`` mirrored test for
test, and the port's own properties.

resnet_v1_50 at 64 px, MPII (393 classes), buckets (2, 4), seeded
Flax-layout weights from ``convert.random_flax_variables`` (the same numpy
arrays go to the JAX package where a test holds the port against it).
Four module-scoped artifacts: float (uint8 + float32), int8 with static
scales (uint8), int8 with per-example scales (float32 only) and a 2-frame
clip config (uint8).

Bounds: a loaded artifact reproduces its live predictor bit for bit on
the same device (the programs run the live forward's ops); against JAX's
artifact the probabilities agree within 1e-4, the bound of
``tests/test_torch_serving.py`` (float32 through ResNet-50 in another
order of summation).  The int8 artifact is held to the port's live int8
predictor; the int8 forward's parity with JAX stays with
``tests/test_torch_inference.py``.  On the CPU the pooling ops run their
plain versions; the kernels are checked on the card by ``chip_smoke.py``.
"""

import functools
import http.client
import json
import os
import shutil
import threading
import types

import cv2
import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch import export as export_lib
from attentionalpoolingaction_torch import serve_cli
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch.config import TrainConfig
from attentionalpoolingaction_torch.convert import random_flax_variables
from attentionalpoolingaction_torch.data.preprocessing import (
    B_MEAN,
    G_MEAN,
    R_MEAN,
)
from attentionalpoolingaction_torch.models import inference as inf
from attentionalpoolingaction_torch.ops import attn_pool_cuda as apc
from attentionalpoolingaction_torch.train import normalize_images

torch.set_num_threads(2)

CFG = dict(dataset="mpii", backbone="resnet_v1_50", pooling="attention",
           rank=1, image_size=64, batch_size=4, bf16_backbone=False,
           resize_min=72)
APA_OPS = {torch.ops.apa.saliency_summary.default,
           torch.ops.apa.project_logits.default}


def _cfg(**kw):
    return TrainConfig(**CFG, **kw)


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables("resnet_v1_50", num_classes=393,
                                 num_positions=4, seed=0)


def _exported(tmp_path_factory, name, live, **kw):
    """(live, artifact dir, manifest), the artifact removed at the end of
    the module (~100 MB each: pytest keeps its temporary directories)."""
    out = tmp_path_factory.mktemp(name)
    try:
        yield live, str(out), export_lib.export_predictor(live, str(out),
                                                          **kw)
    finally:
        shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def artifact(variables, tmp_path_factory):
    live = serving.Predictor(_cfg(), *variables, buckets=(2, 4),
                             device="cpu")
    yield from _exported(tmp_path_factory, "float", live)


@pytest.fixture(scope="module")
def int8_static(variables, tmp_path_factory):
    calib = np.random.default_rng(7).normal(
        size=(2, 64, 64, 3)).astype(np.float32) * 30
    live = serving.Predictor(_cfg(), *variables, int8=True, buckets=(2,),
                             calibration_images=calib, device="cpu")
    yield from _exported(tmp_path_factory, "int8_static", live,
                         input_dtypes=(np.uint8,))


@pytest.fixture(scope="module")
def int8_float32_only(variables, tmp_path_factory):
    live = serving.Predictor(_cfg(), *variables, int8=True, buckets=(2,),
                             device="cpu")
    yield from _exported(tmp_path_factory, "int8_f32", live,
                         input_dtypes=(np.float32,))


@pytest.fixture(scope="module")
def clip_artifact(variables, tmp_path_factory):
    live = serving.Predictor(_cfg(clip_frames=2), *variables, buckets=(2,),
                             device="cpu")
    yield from _exported(tmp_path_factory, "clip", live,
                         input_dtypes=(np.uint8,))


@functools.cache
def _load(out):
    """The artifact loaded once (a load takes seconds here); tests that
    count dispatches reset its stats."""
    return export_lib.load_exported(out, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _release_loaded():
    """Drop the loaded artifacts (~100 MB each) with the module."""
    yield
    _load.cache_clear()


def _programs(out):
    """The artifact's ExportedPrograms by file name."""
    kind = {4: "fwd", 5: "clip"}
    return {f"{kind[ndim]}_{name}.pt2": ep
            for (ndim, name), ep in _load(out).programs.items()}


def _jpeg(rng, size=80) -> bytes:
    ok, buf = cv2.imencode(".jpg",
                           rng.integers(0, 255, (size, size, 3), np.uint8))
    assert ok
    return bytes(buf.tobytes())


# -- the JAX package's tests/test_export.py --------------------------------

def test_manifest_and_files(artifact):
    _, out, manifest = artifact
    assert manifest["format_version"] == export_lib.FORMAT_VERSION
    assert manifest["config"]["image_size"] == 64
    assert manifest["buckets"] == [2, 4]
    assert set(manifest["input_dtypes"]) == {"uint8", "float32"}
    # the device traced on; the programs serve on any (see
    # test_programs_hold_nothing_bound_to_a_device)
    assert manifest["platforms"] == ["cpu"]
    assert manifest["torch_version"] == torch.__version__
    assert manifest["clip_frames"] is None
    assert set(os.listdir(out)) == {"manifest.json", "weights.npz",
                                    "fwd_uint8.pt2", "fwd_float32.pt2"}
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == manifest


def test_roundtrip_matches_live_predictor(artifact):
    """The artifact reproduces the live predictor bit for bit on uint8 and
    float32 inputs, padded odd batches included (the symbolic batch does
    not perturb numerics), and its programs take a batch of 1, which they
    were not traced at."""
    live, out, _ = artifact
    loaded = _load(out)
    loaded.stats = serving.ServingStats()
    assert loaded.buckets == live.buckets
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 255, (5, 64, 64, 3), np.uint8)   # 5 -> 4 + 1
    np.testing.assert_array_equal(loaded.predict_arrays(u8),
                                  live.predict_arrays(u8))
    f32 = rng.normal(size=(3, 64, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(loaded.predict_arrays(f32),
                                  live.predict_arrays(f32))
    snap = loaded.stats.snapshot()
    assert snap["serving_device_dispatches_total"] == 3
    assert snap["serving_padded_items_total"] == 2   # 5 -> 4 + (1->2); 3->4
    np.testing.assert_array_equal(loaded._fwd(loaded._weights, u8[:1]),
                                  live._fwd(live._weights, u8[:1]))


def test_predict_bytes_parity(artifact):
    live, out, _ = artifact
    blob = _jpeg(np.random.default_rng(2))
    assert _load(out).predict_bytes([blob]) == live.predict_bytes([blob])


def test_unexported_dtype_raises(clip_artifact):
    _, out, _ = clip_artifact
    with pytest.raises(TypeError, match="uint8"):
        _load(out).predict_arrays(np.zeros((1, 64, 64, 3), np.float32))


def test_float32_only_artifact_warmup(int8_float32_only):
    """warmup defaults to the manifest's dtypes: a float32-only artifact
    warms up instead of failing on the base class's uint8 default."""
    _, out, _ = int8_float32_only
    loaded = _load(out)
    loaded.warmup()
    with pytest.raises(TypeError, match="float32"):
        loaded.predict_arrays(np.zeros((1, 64, 64, 3), np.uint8))


@pytest.mark.parametrize("flags, name", [
    (["--ema"], "--ema"), (["--step", "7"], "--step"),
    (["--set", "ema_decay=0.9"], "--set"), (["--int8"], "--int8"),
    (["--noint8"], "--int8"), (["--workdir", "/tmp/x"], "--workdir"),
    (["--buckets", "1"], "--buckets"),
    (["--calibration_images", "a.jpg"], "--calibration_images"),
    # even at its default value: the manifest's config wins, so an
    # explicit --config is a loud error, not a silently ignored selection
    (["--config", "mpii_rank1_224"], "--config")])
def test_serve_cli_rejects_checkpoint_flags_with_exported_dir(flags, name):
    with pytest.raises(SystemExit, match=name):
        serve_cli.main(["--exported_dir", "/nonexistent", *flags])


def test_int8_artifact_roundtrip(int8_float32_only):
    """The per-example int8 path exports too (int8 weight leaves ship as
    raw bytes) and matches its live predictor exactly."""
    live, out, manifest = int8_float32_only
    assert manifest["int8"] is True
    assert any(leaf["dtype"] == "int8" for leaf in manifest["leaves"])
    loaded = _load(out)
    assert loaded.int8
    f32 = np.random.default_rng(3).normal(
        size=(2, 64, 64, 3)).astype(np.float32) * 40
    np.testing.assert_array_equal(loaded.predict_arrays(f32),
                                  live.predict_arrays(f32))


def test_data_parallel_predictor_refuses_export(variables, tmp_path):
    # one replica a device over two (CPU) devices: export refuses, as the
    # JAX package's does; on one device data_parallel is single-device
    two = serving.Predictor(_cfg(), *variables, buckets=(3,),
                            data_parallel=True, devices=["cpu", "cpu"],
                            device="cpu")
    assert len(two.replicas) == 2 and two.buckets == (4,)
    with pytest.raises(ValueError, match="data_parallel"):
        export_lib.export_predictor(two, str(tmp_path / "x"))
    one = serving.Predictor(_cfg(), *variables, buckets=(3,),
                            data_parallel=True, device="cpu")
    assert one.replicas == () and one.buckets == (3,)
    assert not (tmp_path / "x").exists()


def test_exported_data_parallel_load(artifact):
    """An artifact served with one replica a device (two CPU devices)
    gives the one-device artifact's probabilities; its buckets round up
    to multiples of two."""
    _, out, manifest = artifact
    two = export_lib.load_exported(out, data_parallel=True,
                                   devices=["cpu", "cpu"], device="cpu")
    assert len(two.replicas) == 2
    assert two.buckets == tuple(sorted({-(-b // 2) * 2
                                        for b in manifest["buckets"]}))
    images = np.random.default_rng(5).integers(
        0, 256, (3, 64, 64, 3), dtype=np.uint8)
    np.testing.assert_allclose(two.predict_arrays(images),
                               _load(out).predict_arrays(images),
                               rtol=1e-5, atol=1e-7)
    assert export_lib.load_exported(
        out, data_parallel=True, device="cpu").replicas == ()


def test_exported_http_serving(artifact):
    """serve_cli.make_server runs unchanged over an ExportedPredictor."""
    _, out, _ = artifact
    server = serve_cli.make_server(_load(out), "127.0.0.1", 0, topk=3,
                                   max_batch=4, max_wait_ms=1.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=30)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["status"] == "ok" and health["dataset"] == "mpii"
        conn.request("POST", "/predict",
                     body=_jpeg(np.random.default_rng(4), 70))
        assert len(json.loads(conn.getresponse().read())["topk"]) == 3
        conn.close()
    finally:
        serve_cli.stop_server(server)
        thread.join(timeout=10)


def test_exported_predictor_rejects_clips(artifact):
    """An image artifact exported without clip programs answers a video
    request with an error, not a shape failure."""
    _, out, _ = artifact
    loaded = _load(out)
    assert not loaded.supports_clips
    res = loaded.predict_clip_bytes([b"x"])
    assert "error" in res and "per-image" in res["error"]


def test_clip_artifact_roundtrip(clip_artifact):
    """A clip config exports the clip forward too: the loaded artifact
    serves predict_clip_bytes as the live predictor does (the same TSN
    picks, the clip length from the manifest)."""
    live, out, manifest = clip_artifact
    assert manifest["clip_frames"] == 2
    assert {"fwd_uint8.pt2", "clip_uint8.pt2"} <= set(os.listdir(out))
    loaded = _load(out)
    assert loaded.supports_clips and loaded.clip_t == 2
    rng = np.random.default_rng(0)
    blobs = [_jpeg(rng) for _ in range(5)]
    assert loaded.predict_clip_bytes(blobs, topk=3) == \
        live.predict_clip_bytes(blobs, topk=3)


def test_int8_static_calibration_artifact_roundtrip(int8_static):
    """Static activation scales are weight leaves (0-d float32): they ship
    through the npz and reproduce the statically calibrated predictor."""
    live, out, manifest = int8_static
    assert live._weights[2], "static scales expected"
    assert any(leaf["dtype"] == "float32" and leaf["shape"] == []
               for leaf in manifest["leaves"])
    u8 = np.random.default_rng(7).integers(0, 255, (3, 64, 64, 3), np.uint8)
    np.testing.assert_array_equal(_load(out).predict_arrays(u8),
                                  live.predict_arrays(u8))


def test_serve_cli_follow_flag_validation(tmp_path):
    """--follow composes with --step best but is a usage error with an
    immutable artifact or a pinned numeric step."""
    empty = str(tmp_path / "empty_workdir")
    with pytest.raises(SystemExit, match="immutable"):
        serve_cli.main(["--follow", "--exported_dir", empty])
    with pytest.raises(SystemExit, match="pinned"):
        serve_cli.main(["--follow", "--workdir", empty, "--step", "7"])
    with pytest.raises(FileNotFoundError):
        serve_cli.main(["--follow", "--workdir", empty, "--step", "best",
                        "--device", "cpu"])


# -- the port's own properties ---------------------------------------------

def test_artifact_matches_the_jax_artifact(variables, artifact, tmp_path):
    """The port's loaded artifact against the JAX package's loaded
    artifact (lowered for the CPU only) on the same weights and images."""
    import jax

    from attentionalpoolingaction_tpu import export as jax_export
    from attentionalpoolingaction_tpu import serving as jax_serving
    from attentionalpoolingaction_tpu.config import TrainConfig as JaxConfig

    params, stats = jax.tree.map(np.asarray, variables)
    ref = jax_serving.Predictor(JaxConfig(**CFG), params, stats,
                                buckets=(4,))
    jax_export.export_predictor(ref, str(tmp_path), platforms=("cpu",),
                                input_dtypes=(np.uint8,))
    want = jax_export.load_exported(str(tmp_path))
    shutil.rmtree(tmp_path)
    _, out, _ = artifact
    u8 = np.random.default_rng(5).integers(0, 256, (4, 64, 64, 3), np.uint8)
    got = _load(out).predict_arrays(u8)
    np.testing.assert_allclose(got, want.predict_arrays(u8), atol=1e-4)
    assert got.max() < 0.5, "a saturated softmax would hide a difference"


def test_exported_graph_calls_the_two_ops(artifact, clip_artifact):
    """Each program holds the two pooling ops as nodes, once each, and no
    inlined head einsum or matrix product (the backbone has none)."""
    for out, name in ((artifact[1], "fwd_uint8.pt2"),
                      (artifact[1], "fwd_float32.pt2"),
                      (clip_artifact[1], "clip_uint8.pt2")):
        targets = [n.target for n in _programs(out)[name].graph.nodes
                   if n.op == "call_function"]
        assert sorted(map(str, set(targets) & APA_OPS)) == [
            "apa.project_logits.default", "apa.saliency_summary.default"]
        assert all(targets.count(op) == 1 for op in APA_OPS)
        products = {torch.ops.aten.einsum.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.mm.default, torch.ops.aten.matmul.default}
        assert not set(targets) & products, name


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_ops_pass_opcheck(x_dtype):
    """torch.library.opcheck: schema, fake (meta) shapes against the real
    outputs, and tracing through the fake implementations."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 16), generator=g).to(x_dtype)
    sal_w = torch.randn((16, 2), generator=g)
    sal_b = torch.randn((2,), generator=g)
    torch.library.opcheck(torch.ops.apa.saliency_summary.default,
                          (x, sal_w, sal_b))
    v, s = apc.saliency_summary(x, sal_w, sal_b)
    w_pfc = torch.randn((2, 16, 7), generator=g)
    attn_b = torch.randn((7, 2), generator=g)
    torch.library.opcheck(torch.ops.apa.project_logits.default,
                          (v, s, w_pfc, attn_b))


def test_artifact_bytes_near_weight_bytes(artifact, int8_static):
    """The programs carry no weights: an artifact is at most 1.05x the
    bytes of its weight leaves."""
    for _, out, manifest in (artifact, int8_static):
        total = sum(os.path.getsize(os.path.join(out, f))
                    for f in os.listdir(out))
        assert total <= 1.05 * export_lib.weight_bytes(manifest), out


def test_programs_hold_nothing_bound_to_a_device(artifact, int8_static):
    """No constant, no device argument: a program traced on the CPU runs
    on a card, and the other way round."""
    for out in (artifact[1], int8_static[1]):
        for ep in _programs(out).values():
            assert not ep.constants and not ep.state_dict
            for node in ep.graph.nodes:
                assert not any(isinstance(a, torch.device) for a in
                               torch.utils._pytree.tree_leaves(
                                   (node.args, node.kwargs))), node


def test_export_refuses_a_device_bound_program():
    class Bound(torch.nn.Module):
        def forward(self, leaves, images):
            return images + torch.tensor([1.0, 2.0, 3.0])

    ep = torch.export.export(Bound(), ([], torch.zeros((2, 3))))
    with pytest.raises(ValueError, match="constants"):
        export_lib._device_free(ep, "bound")


def test_int8_artifact_exported_on_the_cpu_pads_for_the_card(int8_static):
    """The int8 program traced on the CPU keeps the zero rows that CUDA's
    _int_mm needs (M > 16): every product takes a padded matrix or one of
    at least 17 rows at a batch of 1.  At 64 px the convs at 4 x 4 and 2 x 2
    have M = 16 B and 4 B.  No branch on the device is left in the
    program."""
    _, out, _ = int8_static
    ep = _programs(out)["fwd_uint8.pt2"]
    padded = 0
    for node in ep.graph.nodes:
        if node.target is not torch.ops.aten._int_mm.default:
            continue
        a = node.args[0]
        if a.target is torch.ops.aten.pad.default:
            padded += 1
            continue
        rows = a.meta["val"].shape[0]
        if isinstance(rows, torch.SymInt):    # linear in the batch: at 1
            expr = rows.node.expr
            rows = int(expr.subs({s: 1 for s in expr.free_symbols}))
        assert rows >= inf._MIN_ROWS, node
    assert padded >= 10


def test_traceable_forward_keeps_its_bits():
    """The device-free rewrites change no eager result: the VGG mean
    subtraction equals the float32 mean vector's, and int8_matmul's zero
    rows (now on every device) leave the accumulator's rows as they are."""
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 9, 7, 3), np.uint8))
    want = u8.to(torch.float32) - torch.tensor([R_MEAN, G_MEAN, B_MEAN])
    assert torch.equal(normalize_images(u8), want)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 24), np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (16, 24), np.int8))
    want = a.to(torch.int64) @ w.to(torch.int64).t()
    assert torch.equal(inf.int8_matmul(a, w).to(torch.int64), want)
