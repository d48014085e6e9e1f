"""The port's ``checkpoint.export_slim_checkpoint`` (its own writer of TF
V2 bundles, ``tf_checkpoint.write_v2``) against the JAX package's, which
saves through TensorFlow: the port's files are read back by
``tf.train.load_checkpoint``, by the JAX package's
``convert_slim_checkpoint`` and by the port's own reader, equal to the
JAX package's export (the same variable count, names and values, and the
same bytes), for the backbones of a resnet_v1_50 and of the committed
config #1 fixture (ResNet-101, restored from its Orbax step).  A bundle
of many small variables spans several table blocks, and TF reads it too.
"""

import pathlib
import tempfile

import numpy as np
import pytest
import tensorflow as tf

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import tf_checkpoint
from attentionalpoolingaction_tpu import checkpoint as jax_ckpt

FULL = pathlib.Path(__file__).resolve().parent / "fixtures_torch" / \
    "jax_orbax" / "mpii_rank1_224"


@pytest.fixture
def tmp_path():
    """Removed at teardown: a ResNet-101 bundle is ~170 MB."""
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


def variables_of(case):
    if case == "resnet_v1_50":
        params, stats = convert.random_flax_variables(
            "resnet_v1_50", num_classes=10, seed=4)
        return {"params": params, "batch_stats": stats}, "resnet_v1_50"
    restored = ckpt_lib.restore_for_eval(ckpt_lib.make_manager(FULL))
    return ({"params": restored.params,
             "batch_stats": restored.batch_stats}, "resnet_v1_101")


@pytest.mark.parametrize("case", ["resnet_v1_50", "fixture_resnet_v1_101"])
def test_export_equals_the_jax_package(tmp_path, case):
    variables, scope = variables_of(case)
    port_prefix = str(tmp_path / "port" / "model.ckpt")
    jax_prefix = str(tmp_path / "jax" / "model.ckpt")
    n = ckpt_lib.export_slim_checkpoint(variables, port_prefix,
                                        model_scope=scope)
    assert n == jax_ckpt.export_slim_checkpoint(variables, jax_prefix,
                                                model_scope=scope)
    tf_port = tf.train.load_checkpoint(port_prefix)
    tf_jax = tf.train.load_checkpoint(jax_prefix)
    names = tf_port.get_variable_to_shape_map()
    assert names == tf_jax.get_variable_to_shape_map() and len(names) == n
    ours = tf_checkpoint.CheckpointReader(port_prefix)
    for name in names:
        want = tf_jax.get_tensor(name)
        assert np.array_equal(tf_port.get_tensor(name), want), name
        assert np.array_equal(ours.get_tensor(name), want), name
    for suffix in (".index", ".data-00000-of-00001"):
        assert (pathlib.Path(port_prefix + suffix).read_bytes()
                == pathlib.Path(jax_prefix + suffix).read_bytes()), suffix
    # the converter takes the backbone back, the heads left out
    back = jax_ckpt.convert_slim_checkpoint(port_prefix, model_scope=scope)
    for coll in ("params", "batch_stats"):
        want = {p: v for p, v in convert._leaves(variables[coll])
                if p[0] == "resnet"}
        got = dict(convert._leaves(back[coll]))
        assert set(got) == set(want)
        assert all(np.array_equal(got[p], want[p]) for p in want)


def test_many_variables_span_several_blocks(tmp_path):
    """8,000 small variables: the index holds more than one 256 KiB
    block, whose separators and restart points TF reads."""
    rng = np.random.default_rng(0)
    tensors = {
        f"resnet_v1_101/block{i % 4}/unit_{i:05d}/bottleneck_v1/conv{i % 3}"
        "/BatchNorm/moving_variance":
            rng.standard_normal(i % 5 + 1).astype(np.float32)
        for i in range(8000)}
    tensors["global_step"] = np.asarray(7, np.int64)
    prefix = str(tmp_path / "many")
    assert tf_checkpoint.write_v2(prefix, tensors) == len(tensors)
    index = pathlib.Path(prefix + ".index").read_bytes()
    assert len(index) > 2 * tf_checkpoint._BLOCK_BYTES
    reader = tf.train.load_checkpoint(prefix)
    assert reader.get_variable_to_shape_map() == {
        k: list(v.shape) for k, v in tensors.items()}
    for k in list(tensors)[::997] + ["global_step"]:
        assert np.array_equal(reader.get_tensor(k), tensors[k]), k
    ours = tf_checkpoint.CheckpointReader(prefix)
    assert all(np.array_equal(ours.get_tensor(k), v)
               for k, v in tensors.items())


def test_unsupported_dtype_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="float16"):
        tf_checkpoint.write_v2(str(tmp_path / "x"),
                               {"a": np.zeros(3, np.float16)})
