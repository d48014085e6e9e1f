"""The port's TF-slim conversion and its plain-Python reader of TF
checkpoints, against the JAX package's ``convert_slim_checkpoint`` (which
reads through TensorFlow) on fixtures TensorFlow wrote: a V2 bundle from
the JAX package's ``export_slim_checkpoint`` and a V1 single file from
``tf.compat.v1.train.Saver(write_version=V1)``, each with the classifier,
``mean_rgb`` and an int64 ``global_step`` beside the backbone, as a real
slim ImageNet checkpoint has them.

The conversion must be bitwise equal leaf for leaf.  A port model started
from the file (``init_checkpoint``) must give the JAX model's logits
within 1e-4 relative, the tolerance of ``tests/test_torch_resnet.py``
(float32 through ResNet-50 in another order of summation).  ``convert_cli``
(report, merge, ``--parity_check``) runs as a module on these fixtures."""

import dataclasses
import os
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import tensorflow as tf
import torch
from tensorflow.core.protobuf import saver_pb2

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert_cli
from attentionalpoolingaction_torch import tf_checkpoint
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch.convert import (
    flax_to_state_dict,
    random_flax_variables,
)
from attentionalpoolingaction_tpu import checkpoint as jax_ckpt
from attentionalpoolingaction_tpu.models import ActionModel

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
tf1 = tf.compat.v1
SCOPE = "resnet_v1_50"
EXTRA = {
    f"{SCOPE}/logits/weights": np.full((1, 1, 2048, 3), 0.5, np.float32),
    f"{SCOPE}/logits/biases": np.zeros((3,), np.float32),
    f"{SCOPE}/mean_rgb": np.array([1.0, 2.0, 3.0], np.float32),
    "global_step": np.int64(123456),
}


def write_with_saver(named, path, version):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    graph = tf1.Graph()
    with graph.as_default():
        tf_vars = {n: tf1.get_variable(n, initializer=tf1.constant(v))
                   for n, v in named.items()}
        saver = tf1.train.Saver(
            var_list=tf_vars,
            write_version=getattr(saver_pb2.SaverDef, version))
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, path, write_meta_graph=False)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    params, stats = random_flax_variables(
        SCOPE, num_classes=393, rank=1, num_positions=4, seed=42)
    # non-trivial BN leaves, so that each of gamma, beta, mean and var
    # must land in its own place
    rng = np.random.default_rng(1)

    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict) else
                (v * rng.uniform(0.5, 1.5, v.shape) + rng.normal(
                    scale=0.1, size=v.shape)).astype(np.float32)
                if v.ndim == 1 else v for k, v in tree.items()}

    variables = {"params": perturb(params), "batch_stats": perturb(stats)}
    variables["batch_stats"] = jax.tree.map(np.abs, variables["batch_stats"])
    model = ActionModel(num_classes=393, backbone=SCOPE, pooling="attention")
    x = np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    logits = np.asarray(jax.jit(model.apply)(variables, x)["logits"])
    tmp = tmp_path_factory.mktemp("slim")
    v2 = str(tmp / "v2" / "model.ckpt")
    assert jax_ckpt.export_slim_checkpoint(variables, v2,
                                           model_scope=SCOPE) == 265
    reader = tf.train.load_checkpoint(v2)
    named = {n: reader.get_tensor(n)
             for n in reader.get_variable_to_shape_map()}
    write_with_saver({**named, **EXTRA}, v2, "V2")
    v1 = str(tmp / "v1" / "model.ckpt")
    write_with_saver({**named, **EXTRA}, v1, "V1")
    return {"variables": variables, "x": x, "logits": logits, "v2": v2,
            "v1": v1}


@pytest.mark.parametrize("layout", ["v2", "v1"])
def test_reader_matches_tensorflow(fixtures, layout):
    path = fixtures[layout]
    ref = tf.train.load_checkpoint(path)
    got = tf_checkpoint.CheckpointReader(path)
    shapes = got.get_variable_to_shape_map()
    assert shapes == ref.get_variable_to_shape_map()
    assert len(shapes) == 265 + len(EXTRA)
    for name in shapes:
        a, b = got.get_tensor(name), ref.get_tensor(name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.get_tensor("global_step").dtype == np.int64


@pytest.mark.parametrize("layout", ["v2", "v1"])
def test_convert_matches_jax_bitwise(fixtures, layout):
    want = jax_ckpt.convert_slim_checkpoint(fixtures[layout],
                                            model_scope=SCOPE)
    got = ckpt_lib.convert_slim_checkpoint(fixtures[layout],
                                           model_scope=SCOPE)
    for coll in ("params", "batch_stats"):
        fw = jax_ckpt._flatten(want[coll])
        fg = ckpt_lib._flatten(got[coll])
        assert fg.keys() == fw.keys() and fg
        for k in fw:
            assert fg[k].dtype == fw[k].dtype == np.float32, k
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=str(k))
    # no classifier, mean_rgb or global_step got through
    flat = ckpt_lib._flatten(got["params"])
    assert not any("logits" in p or "mean_rgb" in p for p in flat)


def test_name_map_examples(fixtures):
    cases = {
        "resnet_v1_101/conv1/weights":
            ("params", ("resnet", "conv1", "kernel")),
        "resnet_v1_101/conv1/BatchNorm/gamma":
            ("params", ("resnet", "conv1_bn", "scale")),
        "resnet_v1_101/conv1/BatchNorm/moving_variance":
            ("batch_stats", ("resnet", "conv1_bn", "var")),
        "resnet_v1_101/block3/unit_23/bottleneck_v1/conv2/weights":
            ("params", ("resnet", "block3/unit_23", "conv2", "kernel")),
        "resnet_v1_101/block1/unit_1/bottleneck_v1/shortcut/BatchNorm/beta":
            ("params", ("resnet", "block1/unit_1", "shortcut_bn", "bias")),
    }
    for slim, want in cases.items():
        assert ckpt_lib._map_slim_name(slim, "resnet_v1_101") == want
        assert ckpt_lib._map_flax_path(want[0], want[1],
                                       "resnet_v1_101") == slim
    # and every name of a real file maps as the JAX package maps it
    names = tf_checkpoint.CheckpointReader(fixtures["v1"]) \
        .get_variable_to_shape_map()
    for name in names:
        assert ckpt_lib._map_slim_name(name, SCOPE) == \
            jax_ckpt._map_slim_name(name, SCOPE), name


def _both(fn_name, *args, **kw):
    """The port's and the JAX package's results, or their exceptions."""
    out = []
    for mod in (ckpt_lib, jax_ckpt):
        try:
            out.append(getattr(mod, fn_name)(*args, **kw))
        except (KeyError, ValueError) as e:
            out.append(e)
    return out


def test_merge_pretrained_errors_match_jax(fixtures):
    variables = fixtures["variables"]
    bad_shape = {"params": {"resnet": {"conv1": {
        "kernel": np.zeros((3, 3, 3, 64), np.float32)}}}}
    got, want = _both("merge_pretrained", variables, bad_shape)
    assert type(got) is type(want) is ValueError
    assert str(got) == str(want) and "shape mismatch" in str(got)
    unknown = {"params": {"resnet": {"conv9": {
        "kernel": np.zeros((1, 1, 3, 4), np.float32)}}}}
    got, want = _both("merge_pretrained", variables, unknown)
    assert type(got) is type(want) is KeyError
    assert str(got) == str(want) and "conv9" in str(got)


@pytest.mark.parametrize("exclude", [(), ("resnet/conv1",), ("head",),
                                     ("resnet/block1",)])
def test_merge_pretrained_exclude_matches_jax(fixtures, exclude):
    variables = fixtures["variables"]
    rng = np.random.default_rng(0)
    converted = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        {"params": {"resnet": variables["params"]["resnet"],
                    "head": variables["params"]["head"]},
         "batch_stats": variables["batch_stats"]})
    got, want = _both("merge_pretrained", variables, converted,
                      exclude=exclude)
    for coll in ("params", "batch_stats"):
        fg, fw = ckpt_lib._flatten(got[coll]), jax_ckpt._flatten(
            jax.tree.map(np.asarray, want[coll]))
        assert fg.keys() == fw.keys()
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=str(k))
    # the input tree is not modified
    assert variables["params"]["resnet"]["conv1"]["kernel"] is \
        fixtures["variables"]["params"]["resnet"]["conv1"]["kernel"]


@pytest.mark.parametrize("layout", ["v2", "v1"])
def test_model_from_slim_file_gives_jax_logits(fixtures, layout):
    """create_state(init_checkpoint=file): the backbone from the file, the
    head fresh; with the JAX model's head copied in, the port's logits
    match the JAX model's."""
    cfg = config_lib.TrainConfig(
        dataset="mpii", backbone=SCOPE, pooling="attention", image_size=64,
        bf16_backbone=False, init_checkpoint=fixtures[layout], seed=3)
    state, _ = train.create_state(cfg, device="cpu")
    model = state.model
    fresh, _ = train.create_state(
        dataclasses.replace(cfg, init_checkpoint=None), device="cpu")
    assert torch.equal(model.head.attn_w, fresh.model.head.attn_w)
    variables = fixtures["variables"]
    head = flax_to_state_dict({"head": variables["params"]["head"]})
    with torch.no_grad():
        for k, v in head.items():
            model.get_parameter(k).copy_(v)
    x, want = fixtures["x"], fixtures["logits"]
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))["logits"].numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-4, err


def test_reader_rejects_what_it_does_not_handle(fixtures, tmp_path):
    # partitioned variables, in both layouts
    for version in ("V2", "V1"):
        path = str(tmp_path / version / "model.ckpt")
        os.makedirs(os.path.dirname(path))
        graph = tf1.Graph()
        with graph.as_default():
            v = tf1.get_variable(
                "w", shape=(6, 4), initializer=tf1.ones_initializer(),
                partitioner=tf1.fixed_size_partitioner(2))
            d = tf1.get_variable("d", initializer=tf1.constant(
                np.ones(3, np.float64)))
            saver = tf1.train.Saver(
                var_list={"w": v, "d": d},
                write_version=getattr(saver_pb2.SaverDef, version))
            with tf1.Session(graph=graph) as sess:
                sess.run(tf1.global_variables_initializer())
                saver.save(sess, path, write_meta_graph=False)
        reader = tf_checkpoint.CheckpointReader(path)
        assert reader.get_variable_to_shape_map()["w"] == [6, 4]
        with pytest.raises(NotImplementedError, match="partitioned"):
            reader.get_tensor("w")
        with pytest.raises(NotImplementedError, match="float64"):
            reader.get_tensor("d")
    # a compressed block: flip the compression byte of the first data block
    index = open(fixtures["v2"] + ".index", "rb").read()
    footer = index[-48:]
    _, pos = tf_checkpoint._varint(footer, 0)
    _, pos = tf_checkpoint._varint(footer, pos)
    idx_off, p = tf_checkpoint._varint(footer, pos)
    idx_size, _ = tf_checkpoint._varint(footer, p)
    entries = tf_checkpoint._block_entries(
        memoryview(index), footer[pos:])
    _, handle = next(entries)
    off, p = tf_checkpoint._varint(handle, 0)
    size, _ = tf_checkpoint._varint(handle, p)
    bad = bytearray(index)
    bad[off + size] = 1                       # snappy
    prefix = str(tmp_path / "compressed" / "model.ckpt")
    (tmp_path / "compressed").mkdir()
    open(prefix + ".index", "wb").write(bytes(bad))
    with pytest.raises(NotImplementedError, match="compressed"):
        tf_checkpoint.CheckpointReader(prefix)
    (tmp_path / "compressed" / "model.ckpt.index").write_bytes(
        index[:-8] + struct.pack("<Q", 1))
    with pytest.raises(ValueError, match="magic"):
        tf_checkpoint.CheckpointReader(prefix)
    with pytest.raises(FileNotFoundError):
        tf_checkpoint.CheckpointReader(str(tmp_path / "missing"))


def test_convert_cli_runs_as_a_module(fixtures):
    """``python -m ...convert_cli --parity_check`` on the V2 bundle: the
    report, the merge onto the backbone and a finite feature map at 224 px;
    in this process on the V1 file, the counts of the conversion."""
    proc = subprocess.run(
        [sys.executable, "-m", "attentionalpoolingaction_torch.convert_cli",
         "--slim_checkpoint", fixtures["v2"], "--backbone", SCOPE,
         "--parity_check", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"merge onto {SCOPE} OK" in proc.stdout
    assert "feature map (2, 2048, 7, 7)" in proc.stdout
    assert "PARITY-READY" in proc.stdout
    report = convert_cli.main(["--slim_checkpoint", fixtures["v1"],
                               "--backbone", SCOPE])
    converted = ckpt_lib.convert_slim_checkpoint(fixtures["v1"],
                                                 model_scope=SCOPE)
    assert report == {
        "params": len(ckpt_lib._flatten(converted["params"])),
        "batch_stats": len(ckpt_lib._flatten(converted["batch_stats"]))}
    assert f"converted {report['params']} params" in proc.stdout
