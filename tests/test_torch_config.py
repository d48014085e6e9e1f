"""The port's own copies of the JAX package's jax-free host modules
(``config.py``, ``data/datasets.py``) and of ``train.normalize_images``
stay equal to the originals: every preset field for field, every dataset
descriptor, the feature sizes, and the VGG mean subtraction."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentionalpoolingaction_tpu import config as jax_config
from attentionalpoolingaction_tpu import train as jax_train
from attentionalpoolingaction_tpu.data import datasets as jax_datasets
from attentionalpoolingaction_torch import config, train
from attentionalpoolingaction_torch.data import datasets

torch.set_num_threads(2)


def test_config_fields_match():
    want = [(f.name, f.default) for f in
            dataclasses.fields(jax_config.TrainConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(config.TrainConfig)]
    assert got == want


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_presets_match(name):
    got = config.get_config(name)
    want = jax_config.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.resize_min_resolved == want.resize_min_resolved
    assert got.resize_max_resolved == want.resize_max_resolved


def test_get_config_overrides_and_errors():
    cfg = config.get_config("mpii_rank1_224", rank=3)
    assert cfg.rank == 3 and config.PRESETS["mpii_rank1_224"].rank == 1
    with pytest.raises(ValueError, match="unknown config preset"):
        config.get_config("nope")
    assert (config.parse_overrides(["rank=2", "dataset=hico"])
            == jax_config.parse_overrides(["rank=2", "dataset=hico"]))


@pytest.mark.parametrize("cli", ["train_cli", "eval_cli", "serve_cli",
                                 "export_cli", "visualize_cli"])
def test_set_true_and_false_are_booleans(cli):
    """``--set name=false`` (any case) is ``False`` on every CLI, where
    the JAX package keeps the truthy string ``"false"``; other values
    parse as before."""
    mod = importlib.import_module(f"attentionalpoolingaction_torch.{cli}")
    args = mod.parse_args(
        ["--workdir", "w", "--out_dir", "o", "--images", "a.jpg"][
            :{"export_cli": 4, "visualize_cli": 6}.get(cli, 0)]
        + ["--set", "freeze_bn=false", "--set", "remat_units=TRUE",
           "--set", "eval_int8=False", "--set", "rank=2",
           "--set", "dataset=hico", "--set", "mesh_shape=(2,)"])
    got = config.parse_overrides(args.set)
    assert got == {"freeze_bn": False, "remat_units": True,
                   "eval_int8": False, "rank": 2, "dataset": "hico",
                   "mesh_shape": (2,)}
    assert all(type(got[k]) is bool
               for k in ("freeze_bn", "remat_units", "eval_int8"))
    cfg = config.get_config("mpii_rank1_224", **got)
    assert cfg.freeze_bn is False and cfg.remat_units is True
    assert jax_config.parse_overrides(["freeze_bn=false"]) == {
        "freeze_bn": "false"}


@pytest.mark.parametrize("name", sorted(jax_datasets.DATASETS))
def test_datasets_match(name):
    got, want = datasets.get_dataset(name), jax_datasets.get_dataset(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.labels_shape() == want.labels_shape()


@pytest.mark.parametrize("size", [64, 97, 224, 448, 450])
def test_feature_size_matches(size):
    assert train.feature_size(size) == jax_train.feature_size(size)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_normalize_images_matches(dtype):
    imgs = np.random.default_rng(0).integers(0, 256, (2, 5, 5, 3)).astype(
        dtype)
    got = train.normalize_images(torch.from_numpy(imgs))
    want = np.asarray(jax_train.normalize_images(jnp.asarray(imgs)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
