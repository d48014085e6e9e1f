"""Remake the JPEG fixtures of the port's input-pipeline tests and the JAX
pipeline's golden crops of them.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/fixtures_torch/make_fixtures.py

Needs OpenCV and the JAX package (its ``data/preprocessing_np.py``, which
imports no JAX).  Writes, beside this file:

  * seven JPEGs of seeded synthetic scenes (smooth colour fields, shapes,
    lines, text and mild noise): two at MPII's 1280x720, a portrait, an
    odd size (all 4:2:0), a grayscale one, and one each with 4:4:4 and
    4:2:2 chroma;
  * ``odd_517x333.png``: the odd-size JPEG as OpenCV decodes it, written
    losslessly as an RGB PNG by OpenCV (serving's PNG path);
  * ``golden.npz``: for each JPEG, in ``NAMES`` order, the JAX pipeline's
    output (``cv2.imdecode`` + ``preprocess_decoded_np(keep_uint8=True)``,
    224 px out of ``resize_min`` 256, ``resize_max`` 512) at the eval
    geometry and at one train geometry drawn from
    ``numpy.random.default_rng(TRAIN_SEED + i)``, with both transforms.
    The crops are stored as uint8 differences along the width, which
    deflate well: ``np.cumsum(dx, axis=2, dtype=np.uint8)`` gives them
    back exactly;
  * ``jax_written.array_record``: the MPII-schema examples of
    ``ARRAY_RECORD_EXAMPLES`` (:func:`array_record_examples`, made by the
    port's ``records.make_example``), written by the JAX package's
    ``records.write_array_record`` (Grain's ``array_record``), so that the
    port's codec is held against bytes of the JAX package's writer on the
    card, where ``array_record`` is not installed.  One record (the first
    1280x720 JPEG) spans a 64 KiB block boundary.

  * ``jax_orbax/``: steps written by the JAX package's
    ``checkpoint.save`` (Orbax: OCDBT and zarr v2), for the port's reader
    (``orbax_checkpoint.py``) on the card, where Orbax is not installed:
    ``mpii_rank1_224/<ORBAX_STEP>/``, a whole ``TrainState`` of BASELINE
    config #1 (ResNet-101, 393 classes, rank 1, SGD momentum with the
    clip, ``ema_decay`` on) at full width, with
    ``mpii_rank1_224_logits.npz`` (the JAX package's CPU logits of the
    seven JPEGs' eval crops of ``golden.npz``), and ``hico_sharded/<step>/``,
    a small state (resnet_v1_50, HICO's 600 classes, rank 2, AdamW, no
    clip, no EMA) saved from the JAX package's 8-device CPU mesh of
    ``(4, 2)`` data x model with ZeRO-1, so that its head and optimizer
    arrays are written in several chunks.  Every leaf is a seeded pattern
    of period ``PERIOD`` (:func:`periodic`; ``SHARDED_PERIOD`` in the
    sharded step) scaled as the port's ``convert.random_flax_variables``
    draws it: the steps compress to a few MB, and the logits stay finite
    and distinct (a period of 61 makes every image's logits alike).

    ``two_process/<step>/`` is a small tree saved by two JAX processes
    (``jax.distributed`` over a local coordinator, one CPU device each),
    its arrays sharded across them: the root store refers into both
    ``ocdbt.process_0`` and ``ocdbt.process_1``.

``--only array_record`` writes that file alone, from the JPEGs as they
are; ``--only orbax`` writes ``jax_orbax/`` alone (JAX on the CPU with 8
host devices; about 2 minutes, most of it XLA compiling ResNet-101's
forward at batch 7).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import socket
import subprocess
import sys

import cv2
import numpy as np

from attentionalpoolingaction_torch import convert as port_convert
from attentionalpoolingaction_torch.data import records as port_records
from attentionalpoolingaction_tpu.data import preprocessing_np as ppnp

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_SIZE, RESIZE_MIN, RESIZE_MAX, TRAIN_SEED = 224, 256, 512, 1000
# name: (height, width, grayscale, chroma sampling unless 4:2:0, quality)
SPECS = {
    "mpii_a_1280x720.jpg": (720, 1280, False, None, 85),
    "mpii_b_1280x720.jpg": (720, 1280, False, None, 75),
    "portrait_480x640.jpg": (640, 480, False, None, 85),
    "odd_517x333.jpg": (333, 517, False, None, 85),
    "gray_400x300.jpg": (300, 400, True, None, 85),
    "yuv444_720x540.jpg": (540, 720, False, "444", 85),
    "yuv422_480x360.jpg": (360, 480, False, "422", 85),
}
NAMES = list(SPECS)
PNG_OF = "odd_517x333.jpg"
ARRAY_RECORD = "jax_written.array_record"
ARRAY_RECORD_EXAMPLES = ("mpii_a_1280x720.jpg", "mpii_b_1280x720.jpg",
                         "gray_400x300.jpg")
MPII_JOINTS = 16


def array_record_examples(read=None) -> list[bytes]:
    """The serialized examples of ``jax_written.array_record``: example i
    holds the JPEG ``ARRAY_RECORD_EXAMPLES[i]`` (``read(name) -> bytes``,
    by default the file beside this one), label ``7 * i + 3`` and
    keypoints ``(i + 1) * arange(32)`` (y, x) with every joint visible."""
    if read is None:
        def read(name):
            with open(os.path.join(HERE, name), "rb") as f:
                return f.read()
    out = []
    for i, name in enumerate(ARRAY_RECORD_EXAMPLES):
        h, w = SPECS[name][:2]
        out.append(port_records.make_example(
            read(name), height=h, width=w, label=7 * i + 3,
            keypoints=(i + 1) * np.arange(2 * MPII_JOINTS, dtype=np.float32),
            visibility=np.ones(MPII_JOINTS, np.float32)))
    return out


def write_array_record_fixture() -> None:
    from attentionalpoolingaction_tpu.data import records as jax_records

    path = os.path.join(HERE, ARRAY_RECORD)
    jax_records.write_array_record(path, array_record_examples())
    print(f"{ARRAY_RECORD}: {os.path.getsize(path)} bytes")


ORBAX_DIR = "jax_orbax"
ORBAX_STEP = 1200
ORBAX_FULL = "mpii_rank1_224"
ORBAX_SHARDED = "hico_sharded"
ORBAX_SHARDED_STEP = 7
PERIOD = 251
# the sharded step's logits are not used: a shorter period keeps it small
SHARDED_PERIOD = 31


def periodic(a: np.ndarray, shift: int = 0, period: int = PERIOD
             ) -> np.ndarray:
    """``a``'s first ``period`` values, rotated by ``shift``, repeated over
    its shape (``a`` itself when it is not longer than that)."""
    flat = np.asarray(a).ravel()
    if flat.size <= period:
        return np.array(a)
    return np.resize(np.roll(flat[:period], shift), np.shape(a))


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _lookup(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def patterned_state(cfg, step: int, seed: int, period: int = PERIOD):
    """A JAX ``TrainState`` of ``cfg``'s shapes (``jax.eval_shape`` of the
    JAX package's ``create_state``), its leaves patterns of the port's
    seeded random variables: parameters, batch statistics, momentum or
    AdamW's moments, the EMA, and ``step`` in every count."""
    import functools

    import jax
    import jax.numpy as jnp

    from attentionalpoolingaction_tpu import train as jax_train
    from attentionalpoolingaction_tpu.data import get_dataset

    periodic_ = functools.partial(periodic, period=period)

    spec = get_dataset(cfg.dataset)
    abstract = jax.eval_shape(lambda: jax_train.create_state(cfg)[0])
    feat = -(-cfg.image_size // 32)
    params, stats = port_convert.random_flax_variables(
        cfg.backbone, num_classes=spec.num_classes, rank=cfg.rank,
        num_positions=feat * feat, pooling=cfg.pooling, seed=seed)
    rng = np.random.default_rng(seed)

    def small(shape):
        # batch norm's perturbations: a period of 13 (most leaves are
        # these short vectors, and each would otherwise hold a whole period)
        return periodic(rng.standard_normal(shape).astype(np.float32) * 0.05,
                        period=13)

    def param(path, sds):
        keys = [_key(k) for k in path]
        base = _lookup(params, keys)
        assert base.shape == sds.shape, (keys, base.shape, sds.shape)
        if keys[-2].endswith("_bn"):
            return jnp.asarray(base + small(sds.shape), sds.dtype)
        return jnp.asarray(periodic_(base), sds.dtype)

    def stat(path, sds):
        keys = [_key(k) for k in path]
        v = small(sds.shape)
        return jnp.asarray(1 + np.abs(v) if keys[-1] == "var" else v,
                           sds.dtype)

    p = jax.tree_util.tree_map_with_path(param, abstract.params)
    scales = {"trace": 1e-2, "mu": 1e-3, "nu": 1e-6}

    def opt(path, sds):
        keys = [_key(k) for k in path]
        if keys[-1] == "count":
            return jnp.asarray(step, sds.dtype)
        i = next(i for i, k in enumerate(keys) if k in scales)
        v = periodic_(np.asarray(_lookup(p, keys[i + 1:])), shift=7)
        v = v * scales[keys[i]]
        return jnp.asarray(np.abs(v) if keys[i] == "nu" else v, sds.dtype)

    return abstract.replace(
        step=jnp.asarray(step, jnp.int32), params=p,
        batch_stats=jax.tree_util.tree_map_with_path(
            stat, abstract.batch_stats),
        opt_state=jax.tree_util.tree_map_with_path(opt, abstract.opt_state),
        ema_params=None if abstract.ema_params is None else jax.tree.map(
            lambda x: x + jnp.asarray(periodic_(np.asarray(x), shift=3)
                                      * 1e-3), p))


def _save(state, directory: str, shardings=None) -> None:
    import jax

    from attentionalpoolingaction_tpu import checkpoint as jax_ckpt

    shutil.rmtree(directory, ignore_errors=True)
    if shardings is not None:
        state = jax.device_put(state, shardings)
    mgr = jax_ckpt.make_manager(directory)
    jax_ckpt.save(mgr, state)
    mgr.wait_until_finished()


def _du(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def write_orbax_fixtures() -> None:
    # the sharded step's mesh: 8 host devices, set before JAX's backend
    # starts
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8")
    import jax

    from attentionalpoolingaction_tpu import config as jax_config
    from attentionalpoolingaction_tpu import evaluate as jax_evaluate
    from attentionalpoolingaction_tpu import train as jax_train
    from attentionalpoolingaction_tpu.parallel import mesh as jax_mesh

    root = os.path.join(HERE, ORBAX_DIR)
    os.makedirs(root, exist_ok=True)
    # BASELINE config #1 with the EMA on; SGD momentum and the clip are
    # its defaults
    cfg = dataclasses.replace(jax_config.get_config(ORBAX_FULL),
                              ema_decay=0.999)
    state = patterned_state(cfg, ORBAX_STEP, seed=11)
    full = os.path.join(root, ORBAX_FULL)
    _save(state, full)
    print(f"{ORBAX_DIR}/{ORBAX_FULL}: {_du(full)} bytes")
    with np.load(os.path.join(HERE, "golden.npz")) as z:
        crops = np.cumsum(z["eval_image_dx"], axis=2, dtype=np.uint8)
    step = jax_evaluate.make_eval_step(jax_train.build_model(cfg))
    logits = np.asarray(step(state.params, state.batch_stats, crops))
    assert np.isfinite(logits).all() and len(np.unique(
        logits.argmax(-1))) > 1, logits
    out = os.path.join(root, f"{ORBAX_FULL}_logits.npz")
    np.savez_compressed(out, names=np.array(NAMES), logits=logits)
    print(f"{ORBAX_DIR}/{ORBAX_FULL}_logits.npz: {os.path.getsize(out)} "
          "bytes")

    small = jax_config.TrainConfig(
        dataset="hico", backbone="resnet_v1_50", pooling="attention",
        rank=2, image_size=64, batch_size=8, bf16_backbone=False,
        optimizer="adamw", grad_clip_norm=None, mesh_shape=(4, 2),
        mesh_axes=("data", "model"), zero1=True)
    state = patterned_state(small, ORBAX_SHARDED_STEP, seed=12,
                            period=SHARDED_PERIOD)
    mesh = jax_mesh.make_mesh(small.mesh_shape, small.mesh_axes)
    shardings = jax_train._train_state_shardings(small, mesh, state)
    sharded = os.path.join(root, ORBAX_SHARDED)
    _save(state, sharded, shardings)
    assert len(jax.devices()) == 8
    print(f"{ORBAX_DIR}/{ORBAX_SHARDED}: {_du(sharded)} bytes")
    two = os.path.join(root, ORBAX_TWO_PROCESS)
    shutil.rmtree(two, ignore_errors=True)
    write_two_process_fixture(two)
    print(f"{ORBAX_DIR}/{ORBAX_TWO_PROCESS}: {_du(two)} bytes")


ORBAX_TWO_PROCESS = "two_process"
ORBAX_TWO_PROCESS_STEP = 3


def two_process_worker(proc_id: int, port: int, directory: str) -> None:
    """One of the two processes of the ``two_process`` step: a global
    2-device mesh, arrays sharded across the processes, one collective
    save."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from attentionalpoolingaction_tpu.parallel import multihost
    from attentionalpoolingaction_tpu.train import TrainState

    jax.config.update("jax_platforms", "cpu")
    multihost.setup(coordinator_address=f"127.0.0.1:{port}",
                    num_processes=2, process_id=proc_id)
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
    rng = np.random.default_rng(5)

    def put(a, spec):
        return jax.make_array_from_callback(
            a.shape, NamedSharding(mesh, spec), lambda idx: a[idx])

    # large enough that each shard is held by reference in its process's
    # data files, not inline in the root node
    w = rng.standard_normal((128, 16, 1)).astype(np.float32)
    state = TrainState(
        step=put(np.asarray(ORBAX_TWO_PROCESS_STEP, np.int32), P()),
        params={"head": {"attn_w": put(w, P(None, "data")),
                         "attn_b": put(np.arange(16, dtype=np.float32),
                                       P())}},
        batch_stats={"m": put(np.ones(4, np.float32), P())},
        opt_state=(optax.EmptyState(),
                   {"trace": {"head": {
                       "attn_w": put(w * 0.5, P("data")),
                       "attn_b": put(np.zeros(16, np.float32), P())}}}))
    _save(state, directory)
    jnp.zeros(()).block_until_ready()


def write_two_process_fixture(directory: str) -> None:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(HERE)),
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--two_process_worker",
         str(i), str(port), directory], env=env) for i in range(2)]
    if any(p.wait(timeout=300) for p in procs):
        raise SystemExit("a two-process worker failed")


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded RGB uint8 scene with edges at every scale."""
    rng = np.random.default_rng(seed)
    fields = np.zeros((h, w, 3), np.float32)
    for cells in (3, 9, 27):
        field = rng.uniform(0, 255, (cells, cells, 3)).astype(np.float32)
        fields += cv2.resize(field, (w, h), interpolation=cv2.INTER_CUBIC) / 3
    img = np.clip(fields, 0, 255).astype(np.uint8)
    for _ in range(12):
        color = [int(c) for c in rng.integers(0, 256, 3)]
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        r = int(rng.integers(8, max(9, min(h, w) // 4)))
        if rng.random() < 0.5:
            cv2.circle(img, (x, y), r, color, -1, cv2.LINE_AA)
        else:
            cv2.rectangle(img, (x, y), (x + r, y + r // 2), color, -1)
    for _ in range(8):
        color = [int(c) for c in rng.integers(0, 256, 3)]
        p0 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        p1 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        cv2.line(img, p0, p1, color, int(rng.integers(1, 4)), cv2.LINE_AA)
    cv2.putText(img, "attentional pooling", (w // 10, h // 2),
                cv2.FONT_HERSHEY_SIMPLEX, min(h, w) / 300, (250, 250, 250),
                2, cv2.LINE_AA)
    noisy = img + rng.normal(0, 0.5, img.shape)
    return np.clip(np.round(noisy), 0, 255).astype(np.uint8)


def encode(rgb: np.ndarray, gray: bool, sampling: str | None,
           quality: int) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if gray:
        src = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    else:
        src = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
        if sampling is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(
                cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    ok, buf = cv2.imencode(".jpg", src, params)
    assert ok
    return buf.tobytes()


def golden(datas: list[bytes]) -> dict:
    out = {k: [] for k in ("eval_image", "eval_transform", "train_image",
                           "train_transform")}
    for i, data in enumerate(datas):
        decoded = ppnp.decode_jpeg(data)
        for kind, rng in (("eval", None),
                          ("train", np.random.default_rng(TRAIN_SEED + i))):
            img, t = ppnp.preprocess_decoded_np(
                decoded, out_size=OUT_SIZE, is_training=kind == "train",
                resize_min=RESIZE_MIN, resize_max=RESIZE_MAX, rng=rng,
                keep_uint8=True)
            out[f"{kind}_image"].append(img)
            out[f"{kind}_transform"].append(t)
    return {k: np.stack(v) for k, v in out.items()}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", choices=["array_record", "orbax"],
                   help="write this fixture alone")
    p.add_argument("--two_process_worker", nargs=3,
                   metavar=("ID", "PORT", "DIR"), help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.two_process_worker:
        proc_id, port, directory = args.two_process_worker
        two_process_worker(int(proc_id), int(port), directory)
        return
    only = args.only
    if only == "array_record":
        write_array_record_fixture()
        return
    if only == "orbax":
        write_orbax_fixtures()
        return
    datas = []
    for i, (name, (h, w, gray, sampling, quality)) in enumerate(
            SPECS.items()):
        data = encode(scene(h, w, seed=i), gray, sampling, quality)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        datas.append(data)
        print(f"{name}: {len(data)} bytes")
    png_name = PNG_OF.replace(".jpg", ".png")
    ok, buf = cv2.imencode(".png", cv2.imdecode(
        np.frombuffer(datas[NAMES.index(PNG_OF)], np.uint8), cv2.IMREAD_COLOR))
    assert ok
    with open(os.path.join(HERE, png_name), "wb") as f:
        f.write(buf.tobytes())
    print(f"{png_name}: {len(buf)} bytes")
    gold = golden(datas)
    for kind in ("eval", "train"):
        gold[f"{kind}_image_dx"] = np.diff(
            gold.pop(f"{kind}_image"), axis=2, prepend=np.uint8(0))
    np.savez_compressed(os.path.join(HERE, "golden.npz"),
                        names=np.array(NAMES), **gold)
    print("golden.npz:", os.path.getsize(os.path.join(HERE, "golden.npz")),
          "bytes")
    write_array_record_fixture()
    write_orbax_fixtures()


if __name__ == "__main__":
    main()
