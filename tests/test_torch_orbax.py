"""The port's reader of the JAX package's Orbax checkpoints
(``orbax_checkpoint.py``) and what stands on it: steps that the JAX
package's ``checkpoint.save`` writes are read bit for bit against Orbax's
own restore of the same step (f32, bf16, int32 and scalar leaves, empty
optax states, with and without an EMA, the committed full-width config #1
fixture, the sharded step of the JAX package's 8-device mesh, whose
arrays are in several chunks, and a step that two JAX processes saved);
OCDBT trees of several levels that tensorstore writes; every leaf of
config #1's and config #5's state maps to one entry of the port's
payload and back; the port's eval and one train step from a restored JAX
state against the JAX package's (momentum with the clip, and AdamW); a
workdir of JAX steps that the port resumes, follows and prunes;
keep-best; ``init_checkpoint``; the CLIs; the Grain iterator state; and
the failures (a flipped byte, an uncommitted step, zarr3, another
compressor).

resnet_v1_50 at 64 px.  Tolerances are those of the tests the checks
come from: logits 1e-4 relative (``tests/test_torch_evaluate.py``), the
train step's (``tests/test_torch_train_step.py``, whose docstring gives
the reasons)."""

import json
import os
import pathlib
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import eval_cli
from attentionalpoolingaction_torch import export_cli
from attentionalpoolingaction_torch import evaluate as eval_lib
from attentionalpoolingaction_torch import orbax_checkpoint as oc
from attentionalpoolingaction_torch import predict_cli
from attentionalpoolingaction_torch import serve_cli
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch import visualize_cli
from attentionalpoolingaction_torch.data import grain_pipeline
from attentionalpoolingaction_torch.data import records as port_records
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_tpu import checkpoint as jax_ckpt
from attentionalpoolingaction_tpu import config as jax_config
from attentionalpoolingaction_tpu import evaluate as jax_eval
from attentionalpoolingaction_tpu import train as jax_train
from attentionalpoolingaction_tpu.data import grain_pipeline as jax_grain
from attentionalpoolingaction_tpu.train import TrainState as JaxTrainState
from test_torch_train_step import assert_changes_close, l2_rel, make_batch

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures_torch" / \
    "jax_orbax"
FULL_STEP = FIXTURES / "mpii_rank1_224" / "1200"
SHARDED_STEP = FIXTURES / "hico_sharded" / "7"
SMALL = dict(backbone="resnet_v1_50", image_size=64, resize_min=72,
             resize_max=90, eval_batch_size=4)
SETS = ["--set", "backbone='resnet_v1_50'", "--set", "image_size=64",
        "--set", "resize_min=72", "--set", "resize_max=90",
        "--set", "eval_batch_size=4", "--set", "batch_size=2",
        "--device", "cpu"]


@pytest.fixture
def tmp_path():
    """A temporary directory removed at teardown (pytest keeps its own
    ``tmp_path``s, and these hold checkpoints of a few hundred MB)."""
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def jax_restore(step_dir):
    """Orbax's own restore of a step, every array on one device (as the
    JAX package's ``restore_for_eval`` restores)."""
    path = os.path.join(step_dir, "default")
    ckptr = ocp.PyTreeCheckpointer()
    meta = ckptr.metadata(path).item_metadata.tree
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    args = jax.tree_util.tree_map(
        lambda m: ocp.ArrayRestoreArgs(sharding=one, dtype=m.dtype), meta)
    return ckptr.restore(path, args=ocp.args.PyTreeRestore(
        restore_args=args))


def assert_same_tree(got_tree, want_tree):
    """Every leaf of Orbax's restore, bit for bit (dtype, shape, bytes),
    in the port's tree, and no other leaf there."""
    flat = jax.tree_util.tree_flatten_with_path(
        want_tree, is_leaf=lambda x: x is None)[0]
    for path, want in flat:
        got = got_tree
        for k in path:
            got = got[_key(k)]
        where = "/".join(str(_key(k)) for k in path)
        if want is None:
            assert got is None, where
            continue
        want = np.asarray(want)
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.bfloat16 and \
                want.dtype == jnp.bfloat16, where
            got = got.view(torch.int16).numpy()
            want = want.view(np.int16)
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        return 1
    assert count(got_tree) == len(flat)


def jax_state(cfg, step=0):
    """The JAX package's initial state of ``cfg``, its step and the
    optimizer's counts set to ``step`` (as ``step`` updates leave them)."""
    state = jax_train.create_state(cfg)[0]
    return state.replace(
        step=jnp.asarray(step, jnp.int32),
        opt_state=jax.tree_util.tree_map_with_path(
            lambda path, x: jnp.full_like(x, step)
            if _key(path[-1]) == "count" else x, state.opt_state))


def save_jax(state, directory):
    mgr = jax_ckpt.make_manager(str(directory))
    jax_ckpt.save(mgr, state)
    mgr.wait_until_finished()


# -- reading, bit for bit -----------------------------------------------------

def test_mixed_dtypes_and_empty_states(tmp_path):
    """f32, bf16, int32 and scalar leaves, empty optax states, no EMA."""
    rng = np.random.default_rng(0)
    state = JaxTrainState(
        step=jnp.asarray(5, jnp.int32),
        params={"w": jnp.asarray(rng.standard_normal((3, 70, 5)),
                                 jnp.float32),
                "h": jnp.asarray(rng.standard_normal(300), jnp.bfloat16),
                "i": jnp.arange(7, dtype=jnp.int32),
                "s": jnp.asarray(2.5, jnp.float32)},
        batch_stats={"m": jnp.zeros((4,))},
        opt_state=(optax.EmptyState(),
                   optax.MaskedState(inner_state=optax.EmptyState()),
                   {"mu": jnp.ones((3,))}))
    save_jax(state, tmp_path / "c")
    step = tmp_path / "c" / "5"
    tree = oc.read_tree(step)
    assert_same_tree(tree, jax_restore(step))
    assert tree["ema_params"] is None and tree["opt_state"][0] is None
    assert tree["params"]["h"].dtype == torch.bfloat16
    assert oc.payload_keys(step) == {"step", "model", "optimizer"}


def test_committed_full_width_fixture_every_leaf():
    """The committed config #1 step (ResNet-101, momentum, EMA), every
    leaf against Orbax's restore."""
    tree = oc.read_tree(FULL_STEP)
    want = jax_restore(FULL_STEP)
    assert_same_tree(tree, want)
    assert int(tree["step"]) == 1200
    assert int(tree["opt_state"][1][1][1]["count"]) == 1200


def test_sharded_multi_chunk_step():
    """The step of the JAX package's (4, 2) mesh with ZeRO-1 and the head
    over ``model``: its arrays are written in several chunks."""
    store = oc.OcdbtStore(SHARDED_STEP / "default")
    chunks = {k.decode().rsplit("/", 1)[0] for k in store.keys()
              if not k.endswith(b"/.zarray")
              and k.rsplit(b"/", 1)[1] not in (b"0", b"0.0", b"0.0.0",
                                                b"0.0.0.0")}
    assert "params.head.attn_w" in chunks           # over model
    assert any(c.startswith("opt_state.") for c in chunks)   # ZeRO-1
    tree = oc.read_tree(SHARDED_STEP)
    assert_same_tree(tree, jax_restore(SHARDED_STEP))
    payload = oc.read_payload(SHARDED_STEP)
    buf = payload["optimizer"]["state"]["head.attn_w"]
    assert set(buf) == {"step", "exp_avg", "exp_avg_sq"}
    assert float(buf["step"]) == 7.0


def test_two_process_step():
    """A step that two JAX processes saved, its arrays sharded across
    them: the root store holds values by reference in both processes'
    data files."""
    step = FIXTURES / "two_process" / "3"
    store = oc.OcdbtStore(step / "default")
    held = {v[0].split("/")[0] for v in store._values.values()
            if not isinstance(v, bytes)}
    assert held == {"ocdbt.process_0", "ocdbt.process_1"}
    assert_same_tree(oc.read_tree(step), jax_restore(step))


@pytest.mark.parametrize("node_bytes,inline", [(300, 8), (2000, 0),
                                               (100000, 100)])
def test_ocdbt_trees_of_several_levels(tmp_path, node_bytes, inline):
    """Stores that tensorstore writes with small nodes (interior nodes,
    keys split across levels with common prefixes), values inline and by
    reference, read against tensorstore's own listing and reads."""
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": {"max_decoded_node_bytes": node_bytes,
                       "max_inline_value_bytes": inline}}
    kv = ts.KvStore.open(spec).result()
    want = {}
    with ts.Transaction() as txn:
        for i in range(300):
            key = (f"opt_state.1.{i % 3}.params.layer{i:03d}/"
                   f"{i % 4}.0").encode()
            want[key] = bytes([i % 256]) * (1 + i * 7 % 97)
            kv.with_transaction(txn)[key] = want[key]
    kv = ts.KvStore.open(spec).result()
    assert sorted(kv.list().result()) == sorted(want)
    store = oc.OcdbtStore(tmp_path)
    assert dict(zip(store.keys(), store.read_many(list(store.keys())))) \
        == want


# -- the mapping --------------------------------------------------------------

@pytest.mark.parametrize("preset", ["mpii_rank1_224", "mpii_rank5_450_mesh"])
def test_every_leaf_maps_to_one_payload_entry(preset):
    """Each leaf of the JAX state (``jax.eval_shape`` of ``create_state``,
    with the EMA on) filled with its own number: each number lands in
    exactly one payload entry, and every entry of the payload that the
    port's own state saves holds one (the schedule's count is the step)."""
    cfg = jax_config.get_config(preset, ema_decay=0.999)
    abstract = jax.eval_shape(lambda: jax_train.create_state(cfg)[0])
    leaves = jax.tree_util.tree_flatten_with_path(abstract)[0]
    tree, step_ids = {}, set()
    for i, (path, sds) in enumerate(leaves, start=1):
        keys = [_key(k) for k in path]
        if keys[0] == "step" or keys[-1] == "count":
            value = np.int32(7)
            step_ids.add(i)
        else:
            value = np.broadcast_to(np.float32(i), sds.shape)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    payload = oc.payload_of(tree)
    assert payload["step"] == 7
    seen = []

    def ids(t):
        v = torch.unique(t)
        assert v.numel() == 1
        seen.append(int(v))
        return int(v)

    port = train.build_model(config_lib.get_config(preset), device="meta")
    names = [n for n, _ in port.named_parameters()]
    model = {k: v for k, v in payload["model"].items()
             if not k.endswith("num_batches_tracked")}
    assert set(model) == {k for k in port.state_dict()
                          if not k.endswith("num_batches_tracked")}
    for k, t in model.items():
        assert t.shape == port.state_dict()[k].shape, k
        ids(t)
    opt = payload["optimizer"]["state"]
    assert set(opt) == set(names)
    for n in names:
        assert set(opt[n]) == {"momentum_buffer"}
        ids(opt[n]["momentum_buffer"])
    assert set(payload["ema_params"]) == set(names)
    for n in names:
        ids(payload["ema_params"][n])
    assert sorted(seen) == sorted(set(range(1, len(leaves) + 1)) - step_ids)


# -- eval and train parity ----------------------------------------------------

MOMENTUM = dict(dataset="mpii", pooling="attention", rank=1,
                batch_size=4, bf16_backbone=False, ema_decay=0.999,
                **SMALL)
ADAMW = dict(MOMENTUM, optimizer="adamw", grad_clip_norm=None,
             learning_rate=1e-3, ema_decay=None)


def jax_stepped(kw, d):
    """A JAX state after one train step on a seeded batch (momentum and
    BN statistics moved), saved under ``d``; the next batch and JAX's
    step from the saved state on it."""
    jcfg = jax_config.TrainConfig(**kw)
    state, spec, model, tx = jax_train.create_state(jcfg)
    step = jax_train.make_train_step(model, spec, jcfg, tx)
    rng = np.random.default_rng(0)
    batches = [make_batch(rng, config_lib.TrainConfig(**kw))
               for _ in range(2)]
    state, _ = step(state, {k: jnp.asarray(v) for k, v in
                            batches[0].items()})
    save_jax(state, d)
    before = jax.tree.map(np.asarray, state)
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in
                                  batches[1].items()})
    return {"cfg": jcfg, "model": model, "before": before,
            "after": jax.tree.map(np.asarray, state),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "batch": batches[1]}


@pytest.fixture(scope="module")
def momentum_run():
    with tempfile.TemporaryDirectory() as root:
        d = pathlib.Path(root) / "checkpoints"
        yield {**jax_stepped(MOMENTUM, d), "dir": d}


def test_eval_from_a_jax_step(momentum_run):
    """``restore_for_eval`` then the port's forward, against the JAX
    package's restore and forward."""
    d = momentum_run["dir"]
    images = np.random.default_rng(1).integers(0, 256, (4, 64, 64, 3),
                                               np.uint8)
    jr = jax_ckpt.restore_for_eval(jax_ckpt.make_manager(str(d)))
    want = np.asarray(jax_eval.make_eval_step(momentum_run["model"])(
        jr.params, jr.batch_stats, images))
    restored = ckpt_lib.restore_for_eval(ckpt_lib.make_manager(d))
    assert restored.step == 1
    cfg = config_lib.TrainConfig(**MOMENTUM)
    got = eval_lib.Evaluator(cfg, device="cpu").logits(
        restored, [{"image": images, "label": np.zeros(4, np.int32),
                    "mask": np.ones(4, np.float32)}])["logits"]
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    for coll in ("params", "batch_stats"):
        for path, w in convert._leaves(getattr(jr, coll)):
            g = restored.params if coll == "params" else \
                restored.batch_stats
            for k in path:
                g = g[k]
            assert np.array_equal(g, np.asarray(w)), path
    ema = convert._leaves(jr.ema_params)
    assert all(np.array_equal(_at(restored.ema_params, p), np.asarray(w))
               for p, w in ema)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def port_step_from(run, kw):
    """The port's state restored from the saved JAX step (checked bit for
    bit), then one port step on JAX's next batch."""
    cfg = config_lib.TrainConfig(**kw)
    state, spec = train.create_state(cfg, device="cpu")
    ckpt_lib.restore(ckpt_lib.make_manager(run["dir"]), state)
    before = run["before"]
    assert state.step == 1
    sd = state.model.state_dict()
    for k, t in convert.flax_to_state_dict(
            before.params, before.batch_stats).items():
        assert torch.equal(sd[k], t), k
    named = dict(state.model.named_parameters())
    step = train.make_train_step(spec, cfg)
    snap_before = {n: p.detach().clone() for n, p in named.items()}
    state, metrics = step(state, train.batch_to_device(run["batch"], "cpu"))
    return state, {k: float(v) for k, v in metrics.items()}, snap_before


def assert_metrics(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        tol = 1e-2 if k == "grad_norm" else 1e-3
        assert np.isfinite(got[k]) and abs(got[k] - w) <= tol * abs(w), k


def test_momentum_step_from_a_jax_state(momentum_run):
    """SGD momentum with the clip and the EMA: the port's step from the
    restored state against JAX's next step."""
    run = momentum_run
    trace = convert.flax_to_state_dict(_trace(run["before"].opt_state))
    state, metrics, before = port_step_from(run, MOMENTUM)
    assert_metrics(metrics, run["metrics"])
    after = run["after"]
    want_params = convert.flax_to_state_dict(after.params)
    named = dict(state.model.named_parameters())
    step = {"port": {"params": named}, "jax": {"params": want_params},
            "before": {"params": before}}
    assert_changes_close(step, "params", 0.5, 0.1)
    want_mom = convert.flax_to_state_dict(_trace(after.opt_state))
    for n, p in named.items():
        got = state.optimizer.state[p]["momentum_buffer"]
        assert l2_rel(got, want_mom[n]) < 0.2, n
    assert set(trace) == set(named)
    ema = {"port": {"ema": state.ema_params},
           "jax": {"ema": convert.flax_to_state_dict(after.ema_params)},
           "before": {"ema": convert.flax_to_state_dict(
               run["before"].ema_params)}}
    assert_changes_close(ema, "ema", 0.5, 0.1)


def _trace(opt_state):
    found = [s.trace for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    assert len(found) == 1
    return found[0]


def test_adamw_step_from_a_jax_state(tmp_path):
    """AdamW without the clip (the chain's indices shift): moments and
    count restored by name, then the port's step against JAX's."""
    run = {**jax_stepped(ADAMW, tmp_path / "checkpoints"),
           "dir": tmp_path / "checkpoints"}
    adam = [s for s in jax.tree.leaves(
        run["after"].opt_state,
        is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    state, metrics, before = port_step_from(run, ADAMW)
    assert_metrics(metrics, run["metrics"])
    named = dict(state.model.named_parameters())
    step = {"port": {"params": named},
            "jax": {"params": convert.flax_to_state_dict(
                run["after"].params)},
            "before": {"params": before}}
    assert_changes_close(step, "params", 0.5, 0.1)
    mu = convert.flax_to_state_dict(adam.mu)
    nu = convert.flax_to_state_dict(adam.nu)
    for n, p in named.items():
        buf = state.optimizer.state[p]
        assert float(buf["step"]) == int(adam.count) == 2
        assert l2_rel(buf["exp_avg"], mu[n]) < 0.2, n
        assert l2_rel(buf["exp_avg_sq"], nu[n]) < 0.2, n


# -- workdirs -----------------------------------------------------------------

def test_mixed_workdir_resume_follow_prune(tmp_path):
    """A workdir whose ``checkpoints/`` holds a JAX step (2), an Orbax tmp
    directory and an uncommitted Orbax step, and Grain's iterator state:
    the port lists the committed step, serves it, resumes from it at the
    same count of records, saves its own steps beside it, prunes the JAX
    step with its window, and a follower swaps in the port's newer step."""
    spec = get_dataset("mpii")
    port_records.write_synthetic_dataset(str(tmp_path / "train.tfrecord"),
                                         spec, 10, image_size=80)
    cfg = config_lib.TrainConfig(**{**MOMENTUM, "batch_size": 2},
                                 train_pattern=str(tmp_path /
                                                   "train.tfrecord"),
                                 workdir=str(tmp_path),
                                 checkpoint_every=1)
    jcfg = jax_config.TrainConfig(**{**MOMENTUM, "batch_size": 2})
    ckdir = tmp_path / "checkpoints"
    save_jax(jax_state(jcfg, step=2), ckdir)
    # Grain's state after 2 batches of 2 (one process, no workers)
    (ckdir / "grain_iter_2_p0.json").write_text(
        json.dumps({"next_index": 2}))
    (ckdir / "3.orbax-checkpoint-tmp-1792266098").mkdir()
    shutil.copytree(ckdir / "2", ckdir / "9")
    (ckdir / "9" / oc.COMMIT_FILE).unlink()
    mgr = ckpt_lib.make_manager(ckdir, max_to_keep=2)
    assert mgr.all_steps() == [2]
    with pytest.raises(ValueError, match="not committed"):
        mgr.load(9, "cpu")
    pred = serving.load_predictor(cfg, buckets=(1,), device="cpu")
    assert pred.step == 2
    state, _ = train.train(cfg, num_steps=3, device="cpu",
                           checkpoint_manager=mgr)
    assert state.step == 3 and mgr.all_steps() == [2, 3]
    assert json.loads((ckdir / "grain_iter_3_p0.json").read_text()) == {
        "epoch": 0, "position": 6}     # 2 batches of 2, then one more
    follower = serving.CheckpointFollower(pred, mgr)
    assert follower.poll_once() and pred.step == 3
    train.train(cfg, num_steps=4, device="cpu", checkpoint_manager=mgr)
    assert mgr.all_steps() == [3, 4] and not (ckdir / "2").exists()
    assert (ckdir / "9").exists()           # never listed, never pruned


def test_keep_best_over_a_jax_slot(tmp_path):
    """The JAX package's ``checkpoints_best`` (an Orbax step and
    ``best.json``): the port reads the best, restores it for
    ``--step best``, and replaces it with a better step of its own."""
    jcfg = jax_config.TrainConfig(**MOMENTUM)
    jax_ckpt.BestKeeper(str(tmp_path)).update(
        4, {"mAP": 0.5}, jax_state(jcfg, step=4))
    keeper = ckpt_lib.BestKeeper(tmp_path)
    assert keeper.best() == {"step": 4, "metric": "mAP", "value": 0.5}
    mgr, step = ckpt_lib.manager_for_step(tmp_path, "best")
    assert ckpt_lib.restore_for_eval(mgr, step).step == 4
    state, _ = train.create_state(config_lib.TrainConfig(**MOMENTUM),
                                  device="cpu")
    assert not keeper.update(6, {"mAP": 0.4}, state)
    assert keeper.update(8, {"mAP": 0.6}, state)
    assert mgr.all_steps() == [8] and keeper.best()["step"] == 8


def test_init_checkpoint_from_a_jax_workdir(momentum_run):
    """``init_checkpoint`` naming the JAX package's checkpoints: the
    backbone and its statistics come from its latest step, the heads
    stay the port's own draw."""
    cfg = config_lib.TrainConfig(**MOMENTUM,
                                 init_checkpoint=str(momentum_run["dir"]))
    state, _ = train.create_state(cfg, device="cpu")
    fresh, _ = train.create_state(config_lib.TrainConfig(**MOMENTUM),
                                  device="cpu")
    want = convert.flax_to_state_dict(momentum_run["before"].params,
                                      momentum_run["before"].batch_stats)
    sd, fresh_sd = state.model.state_dict(), fresh.model.state_dict()
    for k, t in want.items():
        if k.startswith("resnet."):
            assert torch.equal(sd[k], t), k
        else:
            assert torch.equal(sd[k], fresh_sd[k]), k


def test_clis_on_a_jax_workdir(momentum_run, tmp_path, capsys):
    """eval_cli, predict_cli, serve_cli, export_cli, visualize_cli and
    train_cli on a workdir whose only step the JAX package wrote."""
    work = tmp_path / "run"
    shutil.copytree(momentum_run["dir"], work / "checkpoints")
    spec = get_dataset("mpii")
    val = str(tmp_path / "val.tfrecord")
    port_records.write_synthetic_dataset(val, spec, 6, image_size=80)
    printed = eval_cli.main(["--workdir", str(work), "--eval_pattern", val,
                             "--notb", *SETS])
    assert printed[-1]["step"] == 1 and printed[-1]["num_examples"] == 6
    jpg = tmp_path / "a.jpg"
    jpg.write_bytes(port_records._cv2_encode_jpeg(
        np.random.default_rng(3).integers(0, 256, (70, 90, 3), np.uint8)))
    capsys.readouterr()
    predict_cli.main(["--workdir", str(work), "--images", str(jpg), *SETS])
    line = json.loads(capsys.readouterr().out.strip())
    assert line["image"] == str(jpg) and len(line["topk"]) == 5
    served = serve_cli.load_served(serve_cli.parse_args(
        ["--workdir", str(work), *SETS]))
    assert served.step == 1
    art = str(tmp_path / "artifact")
    manifest = export_cli.main(["--workdir", str(work), "--out_dir", art,
                                "--buckets", "1", "--input_dtypes",
                                "uint8", *SETS])
    assert max(manifest["export_cli"]["parity"].values()) <= 1e-6
    shutil.rmtree(art)
    res = visualize_cli.main(["--workdir", str(work), "--images", str(jpg),
                              "--out_dir", str(tmp_path / "viz"), *SETS])
    assert os.listdir(tmp_path / "viz")
    del res
    train_pattern = str(tmp_path / "train.tfrecord")
    port_records.write_synthetic_dataset(train_pattern, spec, 8,
                                         image_size=80)
    from attentionalpoolingaction_torch import train_cli
    state = train_cli.main(["--workdir", str(work), "--train_pattern",
                            train_pattern, "--num_steps", "2",
                            "--set", "ema_decay=0.999", *SETS])
    assert state.step == 2
    assert ckpt_lib.make_manager(work / "checkpoints").all_steps() == [1, 2]


# -- the iterator state -------------------------------------------------------

def test_grain_state_resumes_at_the_same_count(tmp_path):
    """The JAX package's Grain train iterator after k batches: the port's
    iterator set to its state hands out the batch after k * batch_size
    records of its own order; a state of Grain's worker pool counts its
    workers' batches and the ones to skip."""
    spec = get_dataset("mpii")
    path = str(tmp_path / "t.tfrecord")
    port_records.write_synthetic_dataset(path, spec, 10, image_size=80)
    kw = dict(batch_size=4, image_size=64, resize_min=72, resize_max=90,
              seed=3)
    it = jax_grain.make_train_iterator(path, spec, **kw)
    for _ in range(3):
        next(it)
    state = json.loads(json.dumps(it.get_state()))
    port = grain_pipeline.make_train_iterator(path, spec, device="cpu", **kw)
    port.set_state(state)
    assert port.get_state() == {"epoch": 1, "position": 2}
    ref = grain_pipeline.make_train_iterator(path, spec, device="cpu", **kw)
    ref.set_state({"epoch": 1, "position": 2})
    a, b = next(port), next(ref)
    assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
               for k in a)
    pool = {"workers_state": {"0": {"next_index": 4},
                              "1": {"next_index": 4}},
            "iterations_to_skip": {"0": 3, "1": 2},
            "last_worker_index": 0}
    assert grain_pipeline.grain_batches(pool) == 13
    port.set_state(pool)
    assert port.get_state() == {"epoch": 5, "position": 2}
    with pytest.raises(ValueError, match="tfdata_ckpt"):
        port.set_state({"tfdata_ckpt": {}})


# -- failures -----------------------------------------------------------------

def _small_step(d):
    jcfg = jax_config.TrainConfig(**MOMENTUM)
    save_jax(jax_state(jcfg, step=3), d)
    return d / "3"


def test_a_flipped_byte_raises_naming_the_file(tmp_path):
    step = _small_step(tmp_path / "c")
    nodes = sorted((step / "default" / "d").iterdir())
    data = bytearray(nodes[0].read_bytes())
    data[len(data) // 2] ^= 0x10
    nodes[0].write_bytes(bytes(data))
    with pytest.raises(ValueError, match=f"{nodes[0].name}.*CRC-32C"):
        oc.read_tree(step)
    manifest = step / "default" / "manifest.ocdbt"
    manifest.write_bytes(manifest.read_bytes()[:-1])
    with pytest.raises(ValueError, match="manifest.ocdbt.*header says"):
        oc.read_tree(step)


def test_an_uncommitted_step_raises(tmp_path):
    step = _small_step(tmp_path / "c")
    (step / oc.COMMIT_FILE).unlink()
    with pytest.raises(ValueError, match="not committed"):
        oc.read_payload(step)
    assert ckpt_lib.make_manager(tmp_path / "c").all_steps() == []
    empty = tmp_path / "c" / "5"
    empty.mkdir()
    with pytest.raises(ValueError, match="not a checkpoint of the port"):
        ckpt_lib.make_manager(tmp_path / "c").load(5, "cpu")


def test_zarr3_and_other_compressors_raise(tmp_path):
    tree = {"a": jnp.arange(4, dtype=jnp.float32)}
    path = tmp_path / "z3"
    ocp.PyTreeCheckpointer(use_zarr3=True).save(
        path / "default", tree)
    (path / oc.COMMIT_FILE).write_text("{}")
    with pytest.raises(ValueError, match="zarr3"):
        oc.read_tree(path)
    root = tmp_path / "blosc"
    arr = ts.open({"driver": "zarr", "kvstore": {
        "driver": "ocdbt", "base": f"file://{root}/", "path": "a/"},
        "metadata": {"shape": [4], "chunks": [4], "dtype": "<f4",
                     "compressor": {"id": "blosc"}}},
        create=True).result()
    arr[...] = np.arange(4, dtype=np.float32)
    with pytest.raises(ValueError, match="blosc"):
        oc.read_array(oc.OcdbtStore(root), "a")
