"""``remat_units`` in the port: each bottleneck of the backbone runs under
``torch.utils.checkpoint`` and its forward runs again in the backward
(the JAX package's ``nn.remat`` of each unit, ``models/resnet.py``).

* A remat step against the same step without remat, from the same state
  and batch: the losses, ``grad_norm`` and parameters within the bounds of
  ``tests/test_torch_train_step.py``, and the BN running statistics equal
  bit for bit, so they moved once; the recompute normalizes with the
  first forward's batch statistics (its batch norm outputs equal).
* The port's remat step against the JAX package's ``remat_units=True``
  step from the same state, within the same bounds.
* Two gloo ranks of a data-parallel mesh (batch norm over the global
  batch, all-reduced again in the recompute): the remat step against the
  no-remat step on every rank, running statistics bit for bit.
* Eval and ``freeze_bn`` are untouched.
"""

import dataclasses

import numpy as np
import pytest
import torch

from attentionalpoolingaction_tpu import config as jax_config
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch.models.resnet import BatchNorm

from test_torch_train_step import (
    MPII_DEFAULTS,
    assert_changes_close,
    make_batch,
    run_both,
)
from torch_spawn import finish, start_workers

torch.set_num_threads(2)

SMALL = dict(backbone="resnet_v1_50", image_size=64, batch_size=4)


def seeded_state(cfg, seed=3):
    variables = convert.random_flax_variables(
        cfg.backbone, num_classes=393, num_positions=4, seed=seed)
    return train.create_state(cfg, device="cpu", variables=variables)


def stats_of(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def params_of(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def one_step(cfg, batch):
    state, spec = seeded_state(cfg)
    before = {"params": params_of(state.model),
              "stats": stats_of(state.model)}
    state, metrics = train.make_train_step(spec, cfg)(
        state, train.batch_to_device(batch, "cpu"))
    return state, before, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def pair():
    cfg = config_lib.get_config("mpii_rank1_224", **SMALL)
    batch = make_batch(np.random.default_rng(7), cfg)
    plain = one_step(cfg, batch)
    remat_cfg = dataclasses.replace(cfg, remat_units=True)
    remat = one_step(remat_cfg, batch)
    return plain, remat, remat_cfg, batch


def test_remat_step_equals_the_plain_step(pair):
    (plain, before, pm), (remat, before_r, rm), _, _ = pair
    assert remat.model.resnet.remat_units and \
        not plain.model.resnet.remat_units
    for k, w in pm.items():
        tol = 1e-2 if k == "grad_norm" else 1e-4
        assert abs(rm[k] - w) <= tol * abs(w), (k, rm[k], w)
    step = {"before": before, "jax": {"params": params_of(plain.model)},
            "port": {"params": params_of(remat.model)}}
    assert_changes_close(step, "params", 0.5, 0.1)


def test_running_statistics_move_once(pair):
    (plain, before, _), (remat, _, _), _, _ = pair
    got, want = stats_of(remat.model), stats_of(plain.model)
    assert set(got) == set(want) and len(got) == 2 * 53
    for k, w in want.items():
        assert not torch.equal(w, before["stats"][k]), k   # BN moved
        assert torch.equal(got[k], w), k


def test_recompute_normalizes_with_the_same_statistics(pair):
    """Each batch norm of a unit runs twice in a remat step, the second
    time (the recompute) with the same output bit for bit; the root batch
    norm (outside the units) runs once."""
    _, _, cfg, batch = pair
    state, spec = seeded_state(cfg)
    outs = {}
    hooks = []
    for name, m in state.model.resnet.named_modules():
        if isinstance(m, BatchNorm):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: outs.setdefault(
                    name, []).append((mod.recomputing, out.detach()))))
    train.make_train_step(spec, cfg)(state,
                                     train.batch_to_device(batch, "cpu"))
    for h in hooks:
        h.remove()
    assert [r for r, _ in outs.pop("conv1_bn")] == [False]
    assert len(outs) == 52
    for name, calls in outs.items():
        assert [r for r, _ in calls] == [False, True], name
        assert torch.equal(calls[0][1], calls[1][1]), name
    assert not any(m.recomputing for m in state.model.modules()
                   if isinstance(m, BatchNorm))


def test_eval_and_freeze_bn_untouched(pair):
    (plain, _, _), (remat, _, _), cfg, batch = pair
    remat.model.load_state_dict(plain.model.state_dict())
    images = train.normalize_images(torch.from_numpy(batch["image"]))
    with torch.no_grad():
        want = plain.model.eval()(images)["logits"]
        got = remat.model.eval()(images)["logits"]
    assert torch.equal(got, want)
    frozen = dataclasses.replace(cfg, freeze_bn=True)
    state, before, m = one_step(frozen, batch)
    assert np.isfinite(m["loss/total"])
    for k, v in stats_of(state.model).items():
        assert torch.equal(v, before["stats"][k]), k


@pytest.fixture(scope="module")
def jax_remat_run():
    kw = dict(MPII_DEFAULTS, remat_units=True)
    return run_both(jax_config.get_config("mpii_rank1_224", **kw),
                    config_lib.get_config("mpii_rank1_224", **kw), 1)


def test_remat_step_matches_jax_remat(jax_remat_run):
    (step,) = jax_remat_run
    got, want = step["port_metrics"], step["jax_metrics"]
    assert set(got) == set(want)
    for k, w in want.items():
        tol = 1e-2 if k == "grad_norm" else 1e-4
        assert abs(got[k] - w) <= tol * abs(w), (k, got[k], w)
    assert_changes_close(step, "params", 0.5, 0.1)
    for k, w in step["jax"]["stats"].items():
        d_got = step["port"]["stats"][k] - step["before"]["stats"][k]
        d_want = w - step["before"]["stats"][k]
        assert float(d_want.abs().max()) > 0, k
        assert float((d_got - d_want).abs().max()
                     / d_want.abs().max()) < 1e-2, k


WORKER = r'''
import sys
import numpy as np
import torch
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert, train
from attentionalpoolingaction_torch.parallel import mesh as mesh_lib
from attentionalpoolingaction_torch.parallel import multihost

rank, port, tmp, n = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    int(sys.argv[4])
torch.set_num_threads(2)
multihost.setup(f"127.0.0.1:{port}", n, rank, device="cpu")
mesh = mesh_lib.make_mesh((n,), ("data",))
variables = convert.random_flax_variables(
    "resnet_v1_50", num_classes=393, num_positions=1, seed=5)
rng = np.random.default_rng(11)
batch = {"image": rng.integers(0, 256, (4, 32, 32, 3), np.uint8),
         "label": rng.integers(0, 393, 4).astype(np.int32)}
mine = {k: v[2 * rank:2 * rank + 2] for k, v in batch.items()}
out = {}
for remat in (False, True):
    cfg = config_lib.get_config(
        "mpii_rank1_224", backbone="resnet_v1_50", image_size=32,
        batch_size=4, mesh_shape=(n,), remat_units=remat)
    state, spec = train.create_state(cfg, device="cpu", variables=variables,
                                     mesh=mesh)
    state, m = train.make_train_step(spec, cfg, mesh)(
        state, train.batch_to_device(mine, "cpu"))
    out[remat] = (state.model.state_dict(), float(m["loss/total"]))
plain, remat = out[False][0], out[True][0]
for k, v in plain.items():
    if k.endswith(("running_mean", "running_var")):
        assert torch.equal(remat[k], v), k
    elif v.is_floating_point():
        assert float((remat[k] - v).abs().max()) <= 1e-6, k
assert abs(out[True][1] - out[False][1]) <= 1e-6 * abs(out[False][1])
print(f"WORKER{rank} OK")
'''


def test_remat_over_a_data_parallel_mesh(tmp_path):
    finish(start_workers(WORKER, tmp_path), timeout=240)
