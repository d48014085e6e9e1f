"""Experiment configs: an own copy of the JAX package's ``config.py``
(``TrainConfig``, ``PRESETS``, ``get_config``), kept field for field so
that a preset names the same experiment in both packages.  The port
imports nothing of the JAX package, so it keeps this copy.

``use_pallas`` is kept for parity; the port ignores it: on a CUDA tensor
the attentional pooling head always runs the hand-written kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class TrainConfig:
    # data
    dataset: str = "mpii"
    train_pattern: str = ""
    eval_pattern: str = ""
    image_size: int = 224
    resize_min: int | None = None       # default: image_size * 256/224
    resize_max: int | None = None
    # model
    backbone: str = "resnet_v1_101"
    pooling: str = "attention"          # avg | attention | pose_attention
    rank: int = 1
    use_pallas: bool = False
    bf16_backbone: bool = True
    # losses
    pose_loss_weight: float = 0.1
    label_smoothing: float = 0.0
    weight_decay: float = 1e-4
    freeze_bn: bool = False             # fine-tune with frozen BN stats
    # rematerialize bottleneck units in the backward pass (saves stored-
    # activation HBM traffic at +33% conv FLOPs; measured per-config on
    # v5e -- see ARCHITECTURE.md roofline)
    remat_units: bool = False
    bn_momentum: float = 0.997          # slim batch_norm_decay
    # optimization (slim-era SGD+momentum defaults, SURVEY.md section 2.1)
    optimizer: str = "momentum"         # momentum | adamw
    learning_rate: float = 0.001
    momentum: float = 0.9
    lr_schedule: str = "exponential"    # exponential | cosine | constant
    lr_decay_steps: int = 10_000
    lr_decay_rate: float = 0.94
    warmup_steps: int = 0
    # second-order pooling gradients spike early (quadratic in features);
    # clipping is load-bearing at slim-era LRs (verified by divergence
    # probes on v5e) and harmless otherwise
    grad_clip_norm: float | None = 10.0
    # gradient accumulation: split each global batch into this many
    # microbatches and lax.scan value_and_grad over them inside the ONE
    # fused train step (activation memory scales with batch/accum, grads
    # average to the full-batch gradient).  With freeze_bn the update is
    # numerically the full-batch update; with BN training, per-micro
    # batch statistics apply (the standard microbatching caveat).
    grad_accum_steps: int = 1
    # parameter EMA — the slim train template's moving_average_decay
    # (tf.train.ExponentialMovingAverage(decay, num_updates=global_step),
    # SURVEY.md section 2.1).  None disables; typical
    # 0.999-0.9999.  TF's num_updates warmup applies: effective decay is
    # min(decay, (1+step)/(10+step)), so early steps track params closely
    ema_decay: float | None = None
    # evaluate/serve with the EMA weights instead of the raw params
    # (requires a checkpoint trained with ema_decay set)
    eval_ema: bool = False
    # input pipeline
    input_pipeline: str = "tfdata"      # tfdata | grain
    grain_workers: int = 0              # grain multiprocess prefetch workers
    transfer_uint8: bool = True         # ship uint8, normalize on device
    # tfdata only: checkpoint the iterator's exact stream position with the
    # model (symbolic tf.data checkpoint) so resume continues mid-epoch.
    # Trades away prefetch_to_device H2D overlap (the saved state must
    # match the last CONSUMED batch, so batches can't be queued on device);
    # grain checkpoints its iterator natively without this tradeoff.
    tfdata_checkpoint: bool = False
    # batch-level data echoing (Choi et al. 2019): each pipeline batch
    # feeds this many consecutive optimizer steps, reusing the same
    # ON-DEVICE batch (zero extra host work / H2D).  The classic lever
    # when the input pipeline or host link, not the chip, bounds step
    # rate.  >1 changes training semantics (repeated batches) — opt-in.
    # Composes with exact resume: the echo phase is checkpointed and a
    # mid-echo restore re-pulls the in-flight batch deterministically.
    data_echo: int = 1
    # video datasets (HMDB51): per-epoch random-frame sampling at the
    # video level (each epoch = one fresh frame per video — the
    # reference-era protocol).  Both pipelines implement it (grain via
    # the random-access video index; tfdata via group_by_window); False
    # iterates the pre-extracted frames directly (a protocol change)
    video_frame_sampling: bool = True
    # stored frames per video in the converted records (convert_hmdb
    # --frames_per_video).  The tfdata sampling path uses it as the
    # group_by_window size: a video's window flushes as soon as its
    # frames have streamed past, bounding host RAM to the interleave
    # span (an oversized window would buffer every video until epoch
    # end — the whole split's JPEGs resident at once)
    frames_per_video: int = 25
    # clip-level spatiotemporal pooling (video datasets, beyond the
    # reference's per-frame protocol): each example is a temporally
    # ordered clip of this many frames (TSN-style one-frame-per-segment
    # sampling, one shared geometric augmentation) and the attentional
    # pooling head attends over all T*h*w spatiotemporal positions in one
    # second-order form — per-video logits directly, no post-hoc frame
    # averaging.  1 = the reference per-frame protocol.  Grain-only
    # (needs the random-access video index); requires
    # video_frame_sampling and pooling in ("attention", "avg")
    clip_frames: int = 1
    # clip eval only: number of deterministic temporal clips per video
    # (clip k samples each segment at fraction (k+0.5)/eval_clips); their
    # logits combine through the standard per-video averaging — the
    # classic multi-clip video protocol, temporal analog of multicrop.
    # Composes with eval_multicrop=N ("K clips x N crops"): each clip
    # also yields N spatially offset rows, same averaging
    eval_clips: int = 1
    # persistent XLA compilation cache (jax_compilation_cache_dir): a
    # preemption restart re-jits the train step from the on-disk cache in
    # seconds instead of recompiling (~30-40s per program on TPU) — set
    # this for production runs; None leaves JAX's default behavior
    compilation_cache_dir: str | None = None
    # run
    batch_size: int = 8                 # global batch
    num_steps: int = 100_000
    seed: int = 0
    log_every: int = 100
    checkpoint_every: int = 1000
    max_checkpoints: int = 3            # Orbax max_to_keep
    workdir: str = "/tmp/attnpool_run"
    # fine-tune init: a TF-slim .ckpt path (converted on the fly) or an
    # Orbax CheckpointManager dir from a previous run (warm start)
    init_checkpoint: str | None = None
    # mesh
    mesh_shape: Sequence[int] = (1,)
    mesh_axes: Sequence[str] = ("data",)
    # ZeRO-1: shard optimizer state (momentum) over the data axis; params
    # replicated, GSPMD all-gathers the update (parallel/mesh.py)
    zero1: bool = False
    # eval
    eval_batch_size: int = 8
    eval_multicrop: int = 0             # 0 = single central crop
    # evaluate over the quantized serving path (BN-folded + per-channel
    # int8 weights, dynamic activation scales — models/inference.py);
    # measures the PTQ mAP/accuracy delta on the real eval protocol
    eval_int8: bool = False

    @property
    def resize_min_resolved(self) -> int:
        return self.resize_min or round(self.image_size * 256 / 224)

    @property
    def resize_max_resolved(self) -> int:
        return self.resize_max or round(self.resize_min_resolved * 512 / 256)


# one preset per BASELINE.json "configs" entry
PRESETS: dict[str, TrainConfig] = {
    # 1: "MPII single-frame action cls: ResNet-101 + rank-1 attentional
    #     pooling, 224px, batch 8 (CPU-runnable ref)"
    "mpii_rank1_224": TrainConfig(
        dataset="mpii", pooling="attention", rank=1, image_size=224,
        batch_size=8, bf16_backbone=False),
    # 2: "HICO multi-label human-object interaction cls"
    # freeze_bn: the paper's runs FINE-TUNE from ImageNet; slim-era
    # fine-tuning normalizes with the pretrained running stats (gradients
    # still reach BN scale/bias).  Also +17% step rate measured on v5e
    # (no BN stat reduction traffic — ARCHITECTURE.md roofline).
    "hico_multilabel": TrainConfig(
        dataset="hico", pooling="attention", rank=1, image_size=448,
        batch_size=32, learning_rate=0.01, freeze_bn=True),
    # 3: "MPII pose-regularized variant"
    "mpii_pose_attention": TrainConfig(
        dataset="mpii", pooling="pose_attention", rank=1, image_size=448,
        batch_size=32, pose_loss_weight=0.1, learning_rate=0.01,
        freeze_bn=True),
    # 4: "HMDB51 video: per-frame attn-pooled logits + temporal averaging"
    # (grain pipeline => per-epoch random-frame sampling per video)
    "hmdb51_rgb": TrainConfig(
        dataset="hmdb51", pooling="attention", rank=1, image_size=224,
        batch_size=64, learning_rate=0.01, input_pipeline="grain",
        freeze_bn=True),
    # 4b: clip-level spatiotemporal pooling (TPU-native extension, not a
    # reference config): 8-frame TSN-sampled clips, attention over all
    # T*h*w positions, per-video logits directly.  Effective backbone
    # batch is batch_size * clip_frames = 64 frames/step.
    "hmdb51_clip8": TrainConfig(
        dataset="hmdb51", pooling="attention", rank=1, image_size=224,
        batch_size=8, clip_frames=8, learning_rate=0.01,
        input_pipeline="grain", freeze_bn=True),
    # 5: "High-res multi-rank: rank-k bilinear pooling at 450px, multi-crop
    #     eval on TPU mesh"
    # (use_pallas left off: the einsum head measured faster — see
    # ops/attn_pool_pallas.py PERF STATUS)
    "mpii_rank5_450_mesh": TrainConfig(
        dataset="mpii", pooling="attention", rank=5, image_size=450,
        batch_size=64, mesh_shape=(8,), eval_multicrop=3,
        learning_rate=0.01, freeze_bn=True),
}


def get_config(name: str, **overrides) -> TrainConfig:
    if name not in PRESETS:
        raise ValueError(
            f"unknown config preset {name!r}; available: "
            f"{sorted(PRESETS)}")
    cfg = dataclasses.replace(PRESETS[name], **overrides)
    return cfg


def parse_overrides(pairs):
    """Parse CLI --set field=value overrides: ``true`` and ``false``, in
    any case, are booleans; other values are python literals when
    possible, else strings.  (The JAX package keeps ``false`` a string,
    which is truthy, so ``--set freeze_bn=false`` froze BN there.)"""
    import ast

    out = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        if value.lower() in ("true", "false"):
            out[key] = value.lower() == "true"
            continue
        try:
            out[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            out[key] = value
    return out
