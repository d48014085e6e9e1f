#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases; any failure raises and the process exits non-zero:

1. Device: a CUDA card must be present; prints its name and power limit.
2. Kernels: builds csrc/attn_pool.cu with nvcc (sm_90a), prints its
   registers and spills, and holds each kernel against its plain PyTorch
   version at the serving and eval shapes (B in {1, 8, 16, 32, 48}: the
   serving buckets, an eval batch and a 3-crop eval batch; N=49, F=2048,
   C=393, P=1), at rank 5 (B=8; N=196, C=600 and N=225, C=393) and at the
   hmdb51_clip8 clip (B=8, N=392, C=51, P=1), an hmdb51_rgb batch (B=64,
   N=49, C=51, P=1) and mpii_pose_attention's 448 px batch (B=32, N=196,
   C=393, P=1), each with float32 and bfloat16 X.  Checks that two
   launches give the same bits.  Prints, per case, each kernel's launch
   plan, and for each kernel and for the fused_pool_logits pair the
   error, the kernel's, the plain version's and the library
   composition's times, the bound and the share of it, beside the
   timer's own floor.
3. Serving: the ``mpii_rank1_224`` Predictor (ResNet-101, 393 classes,
   rank 1, 224 px, float32, buckets 1/8/32) with seeded random weights in
   the Flax layout, carried across by the weight bridge.  12 concurrent
   single-image requests through the DynamicBatcher and one 40-image
   predict_arrays call; checks the probabilities, that both kernels ran
   once per dispatch, and the logits of 2 images against the CPU plain
   path; prints images/s and the median and p90 time of a call at each
   bucket.
   Phase 2 also holds the head's backward (``fused_pool_backward``, whose
   pass over X is the ``pool_backward`` kernel of
   csrc/attn_pool_backward.cu) against its plain version (torch ops) and
   the gradients of ``AttentionalPoolFn`` against torch autograd through
   the plain forward at every case, checks that two backwards give the
   same bits, and times the backward, the kernel alone, the plain version
   and autograd.
4. Training: the ``mpii_rank1_224`` preset at full width (ResNet-101,
   224 px, batch 8, float32, BN in train mode, staircase exponential
   schedule, SGD momentum, clip 10) from seeded random weights in the Flax
   layout.  One step on the card and on the CPU from the same weights and
   batch, TF32 off, compared; 10 timed steps with cuDNN's default TF32
   (median step ms, images/s); then ``train.train`` for 8 steps, counted:
   each kernel launches once a forward, loss and parameters stay finite.
   A second, small case: the ``__graft_entry__.py`` config without its
   mesh (resnet_v1_50, 64 px, pose attention, rank 2, EMA 0.999, two
   microbatches a step), 2 steps card vs CPU, each kernel twice a step.
5. The checkpointed run: ``mpii_rank1_224`` at full width in a temporary
   workdir, deleted at the end.  The seeded Flax-layout weights are saved
   as a port checkpoint and the run warm-starts from it
   (``init_checkpoint``).  ``train.train`` with a ``CheckpointManager``
   (every 2 steps, 2 kept) gets a real SIGTERM from a hook at step 3: it
   must stop there with steps {2, 3} on disk, and step 3 restored into a
   fresh state must equal the live one bitwise; a second call resumes at
   3 and runs to 6, keeping {4, 6}.  Prints the time of a save and of a
   restore and the bytes of a step.  Then ``evaluate`` of step 6 over a
   seeded 40-image uint8 MPII eval set (batches of 16, the last padded
   with mask 0) on the card, against the same weights on the CPU (TF32
   off), a 3-crop multicrop pass card vs CPU in the same way, and the
   eval loop's images/s pipelined and serialized; ``BestKeeper`` twice (the second lower),
   ``load_predictor(step="best")`` against the evaluator's softmax, and a
   ``CheckpointFollower`` that swaps in a newer step (one more
   ``train.train`` step) once.  Each kernel launches once a train step,
   an eval batch and a dispatch.
6. Train and evaluate from records: ``mpii_rank1_224`` fed from
   MPII-schema TFRecords through the port's input pipeline, with JPEG
   decode on the card (nvJPEG, ``csrc/jpeg_decode.cu``).  The JPEG
   fixtures of ``tests/fixtures_torch/`` are decoded on the card and
   cropped at the eval geometry and at one seeded train geometry, and each
   crop is held against the JAX pipeline's golden crop (OpenCV decode +
   ``preprocess_decoded_np``, made on a host with OpenCV): mean |d| <= 1.5
   levels, at most 1% of pixels off by more than 8, the transform equal.
   The colour kernel converts every colour fixture in one launch, each
   image bit for bit against its plain version, and is timed over batches
   of 1, 8 and 16 of the 1280x720 4:2:0 fixtures beside its bound.
   512 train and 48 eval records are written from the fixtures (seeded
   labels and keypoints) and indexed; ``train_cli`` trains 12 steps
   (checkpoints every 4, an eval every 6, the best kept) and ``eval_cli``
   evaluates the last step; the event file holds the scalars.  A run with
   a real SIGTERM at step 5, resumed to 10, equals an uninterrupted run
   bit for bit (losses and a hash of every batch on the card), plainly and
   with ``data_echo=2`` stopped mid-echo.  The logits of the eval records
   are held against those of the golden crops injected as arrays.  Rates:
   the pipeline alone (train batch 8, eval batch 16) over the records of
   every fixture and over those of the two 1280x720 fixtures alone
   (MPII's size; the train side with 0 and 2 reader threads); from the
   1280x720 records, the train step fed from records against a resident
   batch and the eval loop from records against injected arrays.
7. BASELINE configs #2-#4 at full width (ResNet-101) with the bfloat16
   backbone, from seeded records of ``records.write_synthetic_dataset``
   whose JPEGs are the fixtures (the card's machine has no JPEG
   encoder).  First, torch's batch norm on a bfloat16 tensor with
   float32 parameters against Flax's float32 formula rounded once.
   ``hico_multilabel`` (448 px, batch 32, ``freeze_bn``, sigmoid loss):
   the bfloat16 step against the float32 one on the card (the gap of
   ``precision.py --mode bf16``), a bfloat16 step at batch 2 card vs
   CPU, the bfloat16 and float32 steps timed in turns, 4 ``train.train``
   steps from records, 3-crop multicrop eval of 16 records with
   ``mAP_ko`` of the seeded weights (its first batch's logits card vs
   CPU, at least 2x closer than the card's float32-backbone logits, a
   control) and
   serving at buckets 1/8/32 from the run's checkpoint.  ``mpii_pose_attention`` (448 px,
   batch 32, pose loss 0.1): a step at batch 2 card vs CPU (the pose
   loss among the losses) and 3 steps from records with keypoints.
   ``hmdb51_rgb`` (224 px, batch 64) from records of 80 videos x 8
   frames (frame k under EXIF orientation 1 + k % 4): ``train_cli`` for 3 steps across an epoch boundary (one frame
   a video an epoch), a SIGTERM at step 1 (mid-epoch) resumed to 3 bit
   for bit, and ``eval_cli`` of 8 videos with per-video accuracy.
   ``hmdb51_clip8`` (8 clips of 8 frames): 3 steps from the same
   records and clip eval of the seeded weights at 2 clips x 3 crops a
   video (its first batch card vs CPU, with the same control).  Each
   kernel launches once a step, an eval batch and a serving call.
8. Serving ``mpii_rank1_224`` (ResNet-101, 224 px, float32 with TF32
   convs) from a checkpoint the port writes from seeded weights.  First
   the int8 conv (``torch._int_mm`` over an im2col matrix) at every conv
   shape of ResNet-101, buckets 1 and 32, against the CPU's float64
   accumulator, bit for bit.  ``serve_cli.make_server`` in-process on
   127.0.0.1: ``/healthz``, ``/metrics``, ``/predict`` of the 7 JPEG
   fixtures and a PNG, ``/predict_batch`` with a corrupt item,
   ``/predict_video`` as 8 frames and as a ``video/mp4`` upload (a 400
   "bad video" where OpenCV is missing), 12 concurrent keep-alive clients,
   counted; the logits of the server's crops against those of the JAX
   pipeline's golden crops within phase 6's bound, the PNG's crop against
   its JPEG's within the decode gate, 200 short connections after which
   at most ``DECODE_THREADS`` nvJPEG decoders were made; an overload
   (the worker held) answering 429 with a Retry-After; the connection
   cap's 503.  Times: ``/predict`` p50/p90 at 1 and 12 clients over the
   two 1280x720 fixtures, ``/predict_batch`` images/s.  int8: the folded
   float forward against the model (TF32 off), int8 against folded float
   (cosines), int8 on the card against the CPU at batch 2,
   ``load_predictor(int8=True)`` with and without calibration files
   (counted), float vs int8 ``predict_arrays`` ms a call at buckets
   1/8/32 in turns, ``eval_cli`` float and ``--set eval_int8=true`` over
   48 records (mAP, counted), ``predict_cli`` over the fixtures (float
   in a subprocess, ``--int8`` in this process), and an ``hmdb51_clip8``
   int8 clip through ``predict_clip_bytes``.
9. The exported artifact and the attention-map tools, from seeded
   checkpoints of ``mpii_rank1_224`` (phase 8's weights) and
   ``hmdb51_clip8``.  ``export_cli`` exports ``mpii_rank1_224`` float
   (uint8 and float32 programs), int8 with static scales calibrated on the
   7 JPEG fixtures, the float program traced on the CPU, and
   ``hmdb51_clip8`` with its clip programs (those three with the uint8
   program only, to keep this script's clock); each export's load-back
   gate (max |dprob| of every program against the live predictor <= 1e-6), its
   seconds, its bytes against its weights' (<= 1.05x) and its load seconds
   printed.  Each loaded artifact serves buckets 1/8/32 from one program,
   each pooling kernel once a dispatch (counted); the CPU-traced artifact
   on the card lies within ``CPU_RTOL`` of the card-traced one (TF32 off).
   ``serve_cli --exported_dir`` in-process: /predict of the JPEG fixtures
   and the PNG, a batch with a corrupt item, counted, the served crops'
   logits against the golden crops' within phase 6's bound;
   ``predict_cli --exported_dir`` in this process.  Times, artifact and
   live predictor in turns: ``predict_arrays`` median/p90 at buckets
   1/8/32, float and int8, and /predict p50/p90 at 1 client.  Visualize:
   ``attention_overlays`` on the card (TF32 off) against the CPU (maps
   within ``CPU_RTOL``, overlays equal on 99% of pixels, levels within 1),
   ``visualize_cli`` on the JPEG fixtures (2 PNGs an image, decoded back,
   counted) and with ``--clip`` on 8 frames (the temporal attention sums
   to 1), and ``train_cli --attn_summary_every 2`` for 4 steps from records
   (attention/* images at steps 2 and 4 in the event file).
10. The mesh (``parallel/``) and BASELINE config #5,
   ``mpii_rank5_450_mesh`` (ResNet-101, rank 5, 450 px, batch 64, bf16
   backbone, ``freeze_bn``, 3-crop eval), at full width.  (a) One rank
   over a real NCCL communicator, in a worker process of this script
   joined from torchrun's environment (``RANK=0 WORLD_SIZE=1``): the step
   on a ``(1,)`` mesh against the same step with no process group, from
   the same seeded state and batch, within the gap of two no-group steps
   measured beside it; the mesh step's median ms, images/s and
   ``torch.cuda.max_memory_allocated`` (if batch 64 does not fit, it
   says so and trains with ``grad_accum_steps=2``, the same update under
   ``freeze_bn``); ``train_cli --multiprocess`` for 3 steps from 128
   records, ``eval_cli --multiprocess`` of 16 records with 3 crops, and
   the eval loop on injected 3-crop batches (images/s), each counted.
   Then ``serve_cli --data_parallel`` over the run's checkpoint in this
   process: on one card single-device dispatch (``/healthz`` says
   ``data_parallel`` false), 4 ``/predict`` calls, counted.  (b) Two
   ranks on the one card over gloo (NCCL refuses two ranks on one
   device), resnet_v1_50 at 96 px, TF32 off: which collectives gloo takes
   for CUDA tensors (each tried), the data-parallel step against one
   process (loss and parameters 1e-4), ZeRO-1 against it (1e-5), the
   ``(1, 2)`` data x model step of ``hico`` (its 600 classes 300 a rank)
   against one process (1e-4), a stop raised on rank 1 after step 1 seen
   by both at step 2, the gathered eval of 5 records (3 and 2 rows)
   against this process's mAP (1e-12), every kernel counted on every
   rank, and the data-parallel step's ms (gloo through the host, not
   NCCL: it says nothing of NCCL's speed).
11. From raw data.  (a) The dataset converters (``python -m
   attentionalpoolingaction_torch.data.convert_mpii`` in a subprocess,
   ``convert_hico`` and ``convert_hmdb``'s ``main`` in this process):
   an MPII release in small (64 images naming copies of the JPEG
   fixtures, fixture 0 under EXIF orientation 6, and a ``.mat`` written
   by ``scipy.io.savemat`` with ``annolist``, ``act.act_id`` with gaps
   and ``img_train``), a HICO
   ``anno.mat`` (600 x N of +1/-1/0/NaN) and, where OpenCV is installed
   (``cv2_installed`` is printed), MJPG videos of fixture frames: record
   counts, the label map, labels, keypoints and heights and widths
   against the frame headers, each split read back through the input
   pipeline on the card; without OpenCV the HMDB converter must fail with
   JAX's ``ModuleNotFoundError``.  (b) ``train_cli --config
   mpii_rank1_224 --set remat_units=true`` at full width from the
   converted MPII records, saving every 2 steps, with a real SIGTERM as
   step 3 starts (step 2's save in flight), resumed to step 4: losses and
   batches equal ``train.train``'s straight run bit for bit (cuDNN
   deterministic); ``eval_cli`` of the converted val split; each counted.
   The remat step against the plain one from one state within the gap
   of two plain steps (parameters, running statistics, loss), and the
   step with and without remat in turns: median ms and
   ``torch.cuda.max_memory_allocated``.  (c) The same timing and memory
   at ``mpii_rank5_450_mesh``'s width (450 px, bf16, batch 64).  (d)
   Async saves of config #1's 347 MB state: the part that blocks the
   step thread against the whole write, steps while a write runs against
   steps without, the step restored after ``wait_until_finished`` bitwise
   equal to the state at its save.  (e) Data-parallel serving through
   CUDA graphs with two replicas on one card: ``mpii_rank1_224``'s
   probabilities within 1e-6 of the eager one-device path (TF32 off),
   launches by the replay rule, a reload captured again, int8 with
   per-example scales and an ``hmdb51_clip8`` clip against eager
   dispatch, and bucket 32 against one device in turns.
12. From ArrayRecord (``data/array_record.py``, ``csrc/array_record.cc``
   built with the host compiler, zstd through ``libzstd.so.1``, whose path
   and version are printed first).  The fixture that the JAX package's
   writer made (``tests/fixtures_torch/jax_written.array_record``, three
   MPII-schema examples carrying the two 1280x720 JPEGs and the gray one)
   read with every hash verified, equal to the expected examples byte for
   byte, its JPEGs decoded on the card.  ``python -m
   attentionalpoolingaction_torch.data.reformat``'s ``main`` over
   phase 6's fixture-mix records (512 train, 48 eval): TFRecord to
   ArrayRecord and back, byte-equal to the originals; the codec's MB/s on
   the host beside TFRecord's.  ``train_cli`` of config #1 at full width,
   4 steps, from the ArrayRecord files and from the TFRecord originals
   (same seed, cuDNN deterministic): losses and batch digests bit for
   bit; ``eval_cli`` of each: equal results; each counted.  The pipeline
   alone from the two 1280x720 fixtures' records, TFRecord and ArrayRecord
   in turns (train batch 8, eval batch 16, images/s).  ``hmdb51_rgb``'s
   video index from an ArrayRecord source equals the TFRecord source's.
13. Config #1 trained by the JAX package: the committed full-width Orbax
   step (``tests/fixtures_torch/jax_orbax/mpii_rank1_224/1200``, a
   ``TrainState`` that the JAX package's ``checkpoint.save`` wrote:
   ResNet-101, SGD momentum with the clip, the EMA) copied into a workdir
   with a Grain iterator state of the JAX package's (150 batches).
   ``restore_for_eval`` and a whole restore into a card state are timed
   beside the same restores of that state saved in the port's format
   (the fixture's leaves are periodic, so its zstd chunks decode faster
   than trained weights would: the Orbax read time is not
   representative).  ``load_predictor`` (``predict_arrays`` of the 7
   golden eval crops, counted) and ``evaluate`` of the crops injected:
   logits (TF32 off) against the JAX package's CPU logits stored with the
   fixture, within ``CPU_RTOL``; ``eval_cli`` over phase 6's records of
   the fixtures, counted.  ``train_cli`` resumes the JAX step for 4 steps
   from those records (cuDNN deterministic, counted), and again from the
   port-format copy: the losses and the final state (model, momentum, EMA)
   equal bit for bit, and the stream resumed at 1,200 records.
   ``export_slim_checkpoint`` of the restored backbone, its seconds and
   bytes, read back by ``tf_checkpoint.CheckpointReader`` bit for bit.
14. A ``kernels`` JSON line (``launches`` from phase 3's serving run for
   the forward pooling kernels, from phase 4's ``train`` for
   ``pool_backward`` and from phase 6's ``train_cli`` for the colour
   kernel; ``train_launches`` from phase 4's ``train``, ``eval_launches``
   from phase 5's evaluation, ``pipeline_train_launches`` and
   ``pipeline_eval_launches`` from phase 6's CLIs, one column each for
   phase 7's runs, and ``http_launches`` (the colour kernel's too),
   ``int8_serve_launches``, ``int8_eval_launches`` and
   ``clip8_int8_serve_launches`` from phase 8's, ``export_serve_launches``
   (serving from the artifact over HTTP) and ``visualize_launches``
   (``visualize_cli``) from phase 9's, ``mesh5_step_launches``,
   ``mesh5_train_launches``, ``mesh5_eval_launches`` and
   ``mesh5_serve_launches`` from phase 10's config #5 runs and
   ``gloo2_dp_launches``, ``gloo2_zero1_launches`` and ``gloo2_tp_launches``
   (one count a rank) from its two gloo ranks, ``raw_train_launches``
   and ``raw_eval_launches`` from phase 11's ``train_cli`` (both calls)
   and ``eval_cli``, ``array_record_train_launches`` and
   ``array_record_eval_launches`` from phase 12's ``train_cli`` and
   ``eval_cli`` from ArrayRecord, ``orbax_serve_launches``,
   ``orbax_eval_launches`` and ``orbax_train_launches`` from phase 13's
   ``predict_arrays``, ``eval_cli`` and ``train_cli`` on the JAX step,
   each kernel counted over each run), then the last line
   ``{"ok": true, "device": {...}}``.

The kernels (``csrc/attn_pool.cu``, ``csrc/attn_pool_backward.cu``,
``csrc/jpeg_decode.cu`` with ``nvcc``, ``csrc/tfrecord_index.cc`` and
``csrc/array_record.cc`` with the host compiler) build at once, each in
its own thread, before phase 2.

``--cards N`` runs, instead of the phases, the mesh across N cards (one
process a card over NCCL, rank r on card r): resnet_v1_50 at 96 px with
TF32 off, the data-parallel step against one process, ZeRO-1 against it,
the ``(N/2, 2)`` data x model step of ``hico`` against one process, the
stop raised on the last rank, the gathered eval of 5 records against one
process; config #5 over the ``(N,)`` mesh at 64/N rows a card against one
card with the whole batch, timed in the same call; and data-parallel
serving over the N cards in one process (one replica a card, each
replaying its CUDA graphs): ``mpii_rank1_224``'s probabilities against
one card's, config #5 at bucket 32 against one card in turns (it fails
if the replicas are slower), counted.

``--profile`` adds a torch.profiler breakdown of a call at each bucket, of
one training step, of a pipelined pass of phase 5's eval loop, in phase
6 of the decode alone and of train steps fed from records, and in phase
8 of an int8 call at each bucket.
"""

from __future__ import annotations

import argparse
import base64
import collections
import contextlib
import copy
import dataclasses
import functools
import glob
import hashlib
import http.client
import importlib.util
import io
import itertools
import json
import os
import pathlib
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from attentionalpoolingaction_torch import checkpoint
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import eval_cli
from attentionalpoolingaction_torch import evaluate
from attentionalpoolingaction_torch import export
from attentionalpoolingaction_torch import export_cli
from attentionalpoolingaction_torch import precision
from attentionalpoolingaction_torch import predict_cli
from attentionalpoolingaction_torch import serve_cli
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch import tf_checkpoint
from attentionalpoolingaction_torch import train_cli
from attentionalpoolingaction_torch import visualize_cli
from attentionalpoolingaction_torch.data import array_record
from attentionalpoolingaction_torch.data import convert_hico, convert_hmdb
from attentionalpoolingaction_torch.data import grain_pipeline, jpeg
from attentionalpoolingaction_torch.data import native_io, pipeline, png
from attentionalpoolingaction_torch.data import records, reformat, zstd
from attentionalpoolingaction_torch.data import preprocessing as pp
from attentionalpoolingaction_torch.models import inference as inf
from attentionalpoolingaction_torch.ops import _build
from attentionalpoolingaction_torch.ops import attn_pool_cuda as apc
from attentionalpoolingaction_torch.tf_checkpoint import _fields
from attentionalpoolingaction_torch.train import build_model, normalize_images
from attentionalpoolingaction_torch.utils import visualize as viz

# H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 outside the tensor
# cores (the kernels' FMAs are float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
KERNEL_RTOL = 1e-5      # kernel vs plain, of the largest |output|
# bf16 X: dx is rounded to bf16 (2^-8) after sums taken in another order
BF16_DX_RTOL = 1e-2
CPU_RTOL = 5e-4         # card vs CPU logits through ResNet-101, no TF32
# One train step, card vs CPU, TF32 off.  Float32 rounding grows with depth
# through train-mode batch norm and moves ReLU inputs near zero across the
# kink, so two correct float32 steps differ well beyond float32's epsilon
# in the gradients.  ``python -m attentionalpoolingaction_torch.precision``
# measures a float32 step against a float64 one; at full width, seeds 0-2,
# on an H100 and on its host's CPU, the largest gaps were: grad_norm
# 9.8e-4, each BN statistic's change 3.3e-4 of its largest change, the
# momentum buffers (the clipped gradient plus the decay: the first update
# over -lr) 7.7% in L2 in the worst leaf and 6.0% over all leaves, the
# pooling head's 1.2e-3.  Each tolerance is about 3x that reading; the
# loss's is 1e-3.  conv1 carries 99.997% of grad_norm's square, so
# grad_norm and the overall L2 read conv1; the per-leaf limits cover the
# rest.  Parameter changes themselves are not compared: those of BN
# scales near 1 are a few ulps.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_NORM_RTOL = 3e-3
TRAIN_STAT_RTOL = 1e-3
TRAIN_LEAF_L2 = 0.2
TRAIN_TOTAL_L2 = 0.15
TRAIN_HEAD_L2 = 4e-3
# Phase 7, the bfloat16 backbone.  ``python -m
# attentionalpoolingaction_torch.precision --mode bf16`` measures the
# bfloat16 step against the float32 one from the same weights and batch,
# TF32 off.  At full width on an H100 (hico_multilabel and
# mpii_pose_attention at 448 px, batch 32 and 2; hmdb51_rgb, batch 64;
# hmdb51_clip8, batch 8) the largest gaps were: features 0.94% in L2,
# logits 0.44%, the momentum buffers 2.6% (batch 2; 0.8% at 32), the
# loss 2.9e-3 relative (the clip), the pose loss 1.8e-3, grad_norm 3.5e-3;
# on the card's host CPU the same (loss 3.5e-4 and grad_norm 3.0e-3 at
# hico's batch 2).  Each limit is about 3x the largest reading.  The gap
# must also be there: features and logits at least a third of the
# smallest reading (0.93% and 0.31%), so that a backbone that stayed in
# float32 (a gap of 0) fails.
BF16_GAP = {"loss/total_rel": 1e-2, "grad_norm_rel": 1e-2,
            "logits_l2": 1.5e-2, "features_l2": 3e-2,
            "momentum_total_l2": 0.08}
BF16_GAP_MIN = {"logits_l2": 1e-3, "features_l2": 3e-3}
# card vs CPU, both bfloat16, at a cut batch: two bfloat16 roundings of
# one float32 step differ by up to ~sqrt(2) times either's gap, ~3e-3 at
# the most for a loss or grad_norm (pose loss included)
BF16_CPU_RTOL = 1e-2
# Eval logits, card vs CPU, both bfloat16, against a control: the card's
# logits of the same rows with the backbone in float32, which are off the
# CPU's by the bfloat16 gap itself.  The two devices round mostly alike,
# so the card's bfloat16 logits lie well closer to the CPU's than the
# control does: 4.2x (hico_multilabel multicrop, 6.3e-4 vs 2.6e-3 in L2)
# and 3.3x (hmdb51_clip8 clips, 1.9e-3 vs 6.1e-3) on an H100.  A card
# that stayed in float32 reads ~1x; the limit is 2x.  No one absolute
# limit lies between both pairs with room: the clips' own rounding gap
# is twice the images'.
BF16_EVAL_CONTROL_RATIO = 2.0
# Phase 5: metrics of the card's and the CPU's logits.  The logits agree
# within CPU_RTOL of the largest; a metric moves only where that flips the
# order of two scores.  One swap moves one class's AP from 1/r to
# 1/(r + 1) at most (0.5 at r = 1), over the >= 25 classes that have a
# positive among 40 images: 0.02 of the mAP; accuracy moves by one image
# in 40.
EVAL_MAP_ATOL = 0.02
EVAL_ACC_ATOL = 1 / 40 + 1e-9
# load_predictor's probabilities against the softmax of the evaluator's
# logits, both on the card, TF32 off: two float32 forwards (batch 8 and
# batch 16) that differ in the order of summation; the CPU tests hold the
# same pair to 1e-4.
SERVE_PROB_ATOL = 1e-4
GRAD_NAMES = ("x", "attn_w", "attn_b", "sal_w", "sal_b")
SOURCE = "attentionalpoolingaction_torch/csrc/attn_pool.cu"
BACKWARD_SOURCE = "attentionalpoolingaction_torch/csrc/attn_pool_backward.cu"
# no TPU kernel: the JAX package's backward is jnp einsums (_fused_bwd)
BACKWARD_REPLACES = "attentionalpoolingaction_tpu/ops/attn_pool_pallas.py:316"
JPEG_SOURCE = "attentionalpoolingaction_torch/csrc/jpeg_decode.cu"
# no TPU kernel: the JAX package decodes on the host (cv2.imdecode)
JPEG_REPLACES = "attentionalpoolingaction_tpu/data/preprocessing_np.py:17"
REPLACES = {
    "saliency_summary":
        "attentionalpoolingaction_tpu/ops/attn_pool_pallas.py:100",
    "project_logits":
        "attentionalpoolingaction_tpu/ops/attn_pool_pallas.py:137",
}


def log(*args):
    print(*args, flush=True)


# -- timing ------------------------------------------------------------------

class ColdTimer:
    """Device time of one call, median of ``iters``, with L2 flushed
    before each by a 256 MB write.  A ~1 ms device sleep after the flush
    keeps the card busy while the host enqueues the call, so that the
    events see the call's device time and not the host's launch latency."""

    def __init__(self):
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, iters=20, warm=3):
        for _ in range(warm):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            times.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in times]))


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want):
    scale = want.abs().max().clamp_min(1e-30)
    return float((got - want).abs().max() / scale), \
        float((got - want).abs().max())


# -- phase 1 -----------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; the port "
                 "runs on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return card


# -- phase 2 -----------------------------------------------------------------

def make_case(b, n, c, p, x_dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    f = 2048

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    x = randn(b, n, f).relu().to(x_dtype)     # post-ReLU features
    return {"x": x, "attn_w": randn(f, c, p, std=0.02),
            "attn_b": randn(c, p, std=0.1), "sal_w": randn(f, p, std=0.02),
            "sal_b": randn(p, std=0.1)}


def library_saliency(x, sal_w, sal_b):
    """cuBLAS in the input dtype: the einsum composition as a yardstick."""
    s = torch.einsum("bnf,fp->bpn", x, sal_w.to(x.dtype)) + sal_b[:, None]
    return torch.einsum("bpn,bnf->bpf", s.to(x.dtype), x), s


def library_project(v, s, w_pfc, attn_b):
    b, c = v.shape[0], w_pfc.shape[2]
    return torch.addmm(s.sum(2) @ attn_b.t(), v.reshape(b, -1),
                       w_pfc.reshape(-1, c))


def library_fused(x, sal_w, sal_b, w_pfc, attn_b):
    """The whole of fused_pool_logits by the library calls above; v goes
    to float32 for the projection, as the kernels keep it."""
    v, s = library_saliency(x, sal_w, sal_b)
    return library_project(v.float(), s, w_pfc, attn_b)


def build_libraries():
    """Build every native library of the port at once, one thread each (a
    compiler process each), and raise the first failure."""
    libs = [_build.ATTN_POOL, _build.ATTN_POOL_BACKWARD, jpeg.LIBRARY,
            native_io.LIBRARY, array_record.LIBRARY]
    times, errors = {}, []

    def build(lib):
        t0 = time.monotonic()
        try:
            lib.build()
        except Exception as e:          # re-raised below, after the joins
            errors.append(e)
        times[lib.name] = time.monotonic() - t0

    t0 = time.monotonic()
    threads = [threading.Thread(target=build, args=(lib,)) for lib in libs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    built = ", ".join(f"{lib.library_path().name} ({times[lib.name]:.1f} s)"
                      for lib in libs)
    log(f"built {built} in {time.monotonic() - t0:.1f} s, at once")


def phase_kernels(timer):
    pool_lib = _build.ATTN_POOL.load()
    for lib in (_build.ATTN_POOL, _build.ATTN_POOL_BACKWARD):
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {lib.name}:", line.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    log("torch.backends.cuda.matmul.allow_tf32 = False (plain and library "
        "versions in full float32)")

    log(f"ColdTimer floor (an empty kernel between its events): "
        f"{timer(lambda: torch.cuda._sleep(1)):.4f} ms")
    # B: the serving buckets 1/8/32, an eval batch of 16 and phase 5's
    # 3-crop multicrop forward of 48
    cases = [(b, 49, 393, 1, dt) for dt in (torch.float32, torch.bfloat16)
             for b in (1, 8, 16, 32, 48)]
    cases += [(8, n, c, 5, dt) for n, c in ((196, 600), (225, 393))
              for dt in (torch.float32, torch.bfloat16)]
    # the hmdb51_clip8 clip: 8 frames of 7x7 positions folded into N; an
    # hmdb51_rgb batch of 64 frames; the 448 px batches of
    # mpii_pose_attention and hico_multilabel
    cases += [(b, n, c, 1, dt) for b, n, c in ((8, 392, 51), (64, 49, 51),
                                               (32, 196, 393), (32, 196, 600))
              for dt in (torch.float32, torch.bfloat16)]
    rows = []
    log("case                        kernel            rel_err   "
        "ms       plain_ms  lib_ms    bound_ms  share")
    for i, (b, n, c, p, dt) in enumerate(cases):
        a = make_case(b, n, c, p, dt, seed=i)
        w_pfc = apc.attn_w_pfc(a["attn_w"])
        x, sw, sb, ab = a["x"], a["sal_w"], a["sal_b"], a["attn_b"]
        f = x.shape[2]
        sp = apc.saliency_plan(b, n, f, p, dt)
        pp = apc.project_plan(b, n, f, c, p)
        with torch.no_grad():
            v, s = apc.saliency_summary(x, sw, sb)
            sal_clusters = pool_lib.apa_last_active_clusters()
            pv, ps = apc.saliency_summary_plain(x, sw, sb)
            plog = apc.project_logits_plain(pv, ps, w_pfc, ab)
            # the projection runs on the plain summary, so that its error
            # is its own
            logits = apc.project_logits(pv, ps, w_pfc, ab)
            proj_clusters = pool_lib.apa_last_active_clusters()
        log(f"plans: saliency cluster {sp.cluster} x {sp.f_slice} columns, "
            f"{sp.path}, r2 {sp.r2}, {sp.smem_bytes} B, {sp.grid} CTAs, "
            f"{sal_clusters} clusters at once; projection K split "
            f"{pp.k_split} x {pp.k_rows} rows, image tile {pp.b_tile}, "
            f"A {'resident' if pp.a_resident else 'streamed'}, "
            f"{pp.smem_bytes} B, grid {pp.grid}, {proj_clusters} clusters "
            f"at once")
        with torch.no_grad():
            fused = apc.fused_pool_logits(x, a["attn_w"], ab, sw, sb,
                                          w_pfc=w_pfc)
            again = apc.fused_pool_logits(x, a["attn_w"], ab, sw, sb,
                                          w_pfc=w_pfc)
            torch.cuda.synchronize()
            if not all(torch.equal(u, w) for u, w in zip(fused, again)):
                raise AssertionError(
                    f"two launches at B{b} N{n} C{c} P{p} {dt} gave "
                    f"different bits")
            errs = {"saliency_summary": max(rel_err(v, pv), rel_err(s, ps)),
                    "project_logits": rel_err(logits, plog),
                    "fused_pool_logits": max(
                        rel_err(fused[0], plog), rel_err(fused[1], pv),
                        rel_err(fused[2], ps))}
            xbytes = x.numel() * x.element_size()
            sal_bytes = xbytes + 4 * (f * p + p + b * p * (f + n))
            sal_flops = 4 * b * n * f * p
            proj_bytes = 4 * (b * p * (f + n) + p * f * c + c * p + b * c)
            proj_flops = 2 * b * p * f * c + b * p * n + 2 * b * c * p
            timings = {
                "saliency_summary": (
                    lambda: apc.saliency_summary(x, sw, sb),
                    lambda: apc.saliency_summary_plain(x, sw, sb),
                    lambda: library_saliency(x, sw, sb),
                    bound_ms(sal_bytes, sal_flops)),
                "project_logits": (
                    lambda: apc.project_logits(v, s, w_pfc, ab),
                    lambda: apc.project_logits_plain(v, s, w_pfc, ab),
                    lambda: library_project(v, s, w_pfc, ab),
                    bound_ms(proj_bytes, proj_flops)),
                # the pair as the head calls it; v and s count once, as
                # outputs, and A once
                "fused_pool_logits": (
                    lambda: apc.fused_pool_logits(x, a["attn_w"], ab, sw, sb,
                                                  w_pfc=w_pfc),
                    lambda: apc.project_logits_plain(
                        *apc.saliency_summary_plain(x, sw, sb), w_pfc, ab),
                    lambda: library_fused(x, sw, sb, w_pfc, ab),
                    bound_ms(sal_bytes + 4 * (p * f * c + c * p + b * c),
                             sal_flops + proj_flops)),
            }
            for name, (kern, plain, lib, (bms, by)) in timings.items():
                rel, absd = errs[name]
                row = {"case": {"B": b, "N": n, "F": f, "C": c, "P": p,
                                "x": str(dt).removeprefix("torch.")},
                       "name": name, "rel_err": rel, "max_abs_err": absd,
                       "ms": timer(kern), "plain_ms": timer(plain),
                       "library_ms": timer(lib), "bound_ms": bms,
                       "bound_by": by}
                row["bound_share"] = bms / row["ms"]
                rows.append(row)
                log(f"B{b:<3} N{n:<4} C{c:<4} P{p} {row['case']['x']:<9}"
                    f"{name:<18}{rel:<10.2e}{row['ms']:<9.4f}"
                    f"{row['plain_ms']:<10.4f}{row['library_ms']:<10.4f}"
                    f"{bms:<10.4f}{row['bound_share']:.1%}")
                if not rel < KERNEL_RTOL:
                    raise AssertionError(
                        f"{name} disagrees with its plain version at "
                        f"{row['case']}: relative error {rel:.2e} >= "
                        f"{KERNEL_RTOL}")
        rows.append(check_backward(timer, a, w_pfc, (b, n, f, c, p, dt), i))
    return rows


def check_backward(timer, a, w_pfc, case, seed):
    """The head's backward at one phase-2 case.  AttentionalPoolFn's
    gradients (the kernels' forward, then fused_pool_backward) against
    torch autograd through the plain forward, on the same inputs and
    cotangent; fused_pool_backward (the pool_backward kernel and its
    cuBLAS products) against fused_pool_backward_plain (torch ops) on the
    same saved tensors, and two backwards bit for bit.  Times the backward,
    the kernel alone, the plain version and plain autograd, beside the
    bound; returns the row."""
    b, n, f, c, p, dt = case
    g = torch.randn(b, c, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    fn_in = {k: a[k].detach().clone().requires_grad_() for k in GRAD_NAMES}
    apc.reset_launch_counts()
    logits = apc.attentional_pool_fused(*(fn_in[k] for k in GRAD_NAMES),
                                        w_pfc=w_pfc)
    logits.backward(g)
    torch.cuda.synchronize()
    if apc.launch_counts != {"saliency_summary": 1, "project_logits": 1,
                             "pool_backward": 1}:
        raise AssertionError(f"AttentionalPoolFn forward and backward at "
                             f"B{b} N{n}: launches {apc.launch_counts}")
    plain_in = {k: a[k].detach().clone().requires_grad_()
                for k in GRAD_NAMES}
    pv, ps = apc.saliency_summary_plain(plain_in["x"], plain_in["sal_w"],
                                        plain_in["sal_b"])
    plain_logits = apc.project_logits_plain(
        pv, ps, plain_in["attn_w"].permute(2, 0, 1), plain_in["attn_b"])
    plain_logits.backward(g, retain_graph=True)

    def tol_of(k):
        return BF16_DX_RTOL if k == "x" and dt == torch.bfloat16 \
            else KERNEL_RTOL

    worst = 0.0
    for k in GRAD_NAMES:
        rel, _ = rel_err(fn_in[k].grad.float(), plain_in[k].grad.float())
        if not rel < tol_of(k):
            raise AssertionError(
                f"d{k} of AttentionalPoolFn disagrees with autograd at B{b} "
                f"N{n} C{c} P{p} {dt}: relative error {rel:.2e} >= "
                f"{tol_of(k)}")
        worst = max(worst, rel)
    x, sw, ab = a["x"], a["sal_w"], a["attn_b"]
    with torch.no_grad():
        v, s = apc.saliency_summary(x, sw, a["sal_b"])
    args = (x, w_pfc, ab, sw, v, s, g)
    got = apc.fused_pool_backward(*args)
    again = apc.fused_pool_backward(*args)
    want = apc.fused_pool_backward_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(u, w) for u, w in zip(got, again)):
        raise AssertionError(f"two backwards at B{b} N{n} C{c} P{p} {dt} "
                             f"gave different bits")
    kern_rel, kern_abs = 0.0, 0.0
    for k, u, w in zip(GRAD_NAMES, got, want):
        rel, absd = rel_err(u.float(), w.float())
        if not rel < tol_of(k):
            raise AssertionError(
                f"d{k} of pool_backward disagrees with its plain version "
                f"at B{b} N{n} C{c} P{p} {dt}: relative error {rel:.2e} >= "
                f"{tol_of(k)}")
        kern_rel, kern_abs = max(kern_rel, rel), max(kern_abs, absd)

    # the kernel alone, on dv = g A
    plan = apc.backward_plan(b, n, f, p, dt)
    dv = (g @ w_pfc.reshape(p * f, c).t()).reshape(b, p, f)
    dx = torch.empty_like(x)
    red = torch.empty((b, f * p + p + c * p), device="cuda")
    blib = _build.ATTN_POOL_BACKWARD.load()

    def kernel():
        err = blib.apb_pool_backward(
            x.data_ptr(), apc._X_DTYPES[dt], dv.data_ptr(), s.data_ptr(),
            g.data_ptr(), ab.data_ptr(), sw.data_ptr(), dx.data_ptr(),
            red.data_ptr(), b, n, f, c, p, plan.cluster, plan.r2,
            plan.path == "resident", plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pool_backward: cudaError {err}")

    kernel()
    active = blib.apb_last_active_clusters()
    ms = timer(lambda: apc.fused_pool_backward(*args))
    kernel_ms = timer(kernel)
    plain_ms = timer(lambda: apc.fused_pool_backward_plain(*args))
    leaves = [plain_in[k] for k in GRAD_NAMES]
    autograd_ms = timer(lambda: torch.autograd.grad(
        plain_logits, leaves, g, retain_graph=True))
    # the backward reads x, v, s, g, A (P, F, C), attn_b and sal_w once and
    # writes dx (in x's dtype) and the four weight gradients once
    xs = x.element_size()
    nbytes = 2 * b * n * f * xs + 4 * (b * p * f + b * p * n + b * c
                                       + 2 * p * f * c + 2 * c * p
                                       + 2 * f * p + p)
    flops = 4 * b * p * f * c + 8 * b * n * f * p + 4 * b * c * p
    bms, by = bound_ms(nbytes, flops)
    # the kernel reads x, dv, s, g, attn_b and sal_w and writes dx and its
    # (B, F P + P + C P) partials
    kbms, _ = bound_ms(2 * b * n * f * xs + 4 * (
        b * p * f + b * p * n + b * c + c * p + f * p
        + b * (f * p + p + c * p)), 8 * b * n * f * p)
    row = {"case": {"B": b, "N": n, "F": f, "C": c, "P": p,
                    "x": str(dt).removeprefix("torch.")},
           "name": "pool_backward", "rel_err": kern_rel,
           "max_abs_err": kern_abs, "autograd_rel_err": worst, "ms": ms,
           "plain_ms": plain_ms, "autograd_ms": autograd_ms,
           "library_ms": None, "bound_ms": bms, "bound_by": by,
           "bound_share": bms / ms, "kernel_ms": kernel_ms,
           "kernel_bound_ms": kbms, "kernel_bound_share": kbms / kernel_ms}
    log(f"B{b:<3} N{n:<4} C{c:<4} P{p} {row['case']['x']:<9}"
        f"{'backward':<18}{kern_rel:<10.2e}{ms:<9.4f}{plain_ms:<10.4f}"
        f"{'-':<10}{bms:<10.4f}{bms / ms:.1%} (plain = torch ops; autograd "
        f"of the plain forward {autograd_ms:.4f} ms, error {worst:.2e}; "
        f"bound by {by}); kernel alone {kernel_ms:.4f} ms, bound "
        f"{kbms:.4f} ({kbms / kernel_ms:.1%}); plan cluster {plan.cluster} "
        f"x {plan.f_slice} columns, {plan.path}, r2 {plan.r2}, "
        f"{plan.smem_bytes} B, {active} clusters at once")
    return row


# -- phase 3 -----------------------------------------------------------------

def phase_serving(card):
    cfg = config_lib.get_config("mpii_rank1_224")
    params, stats = convert.random_flax_variables(
        cfg.backbone, num_classes=393, rank=cfg.rank, num_positions=49,
        seed=0)
    t0 = time.monotonic()
    pred = serving.Predictor(cfg, params, stats, buckets=(1, 8, 32))
    pred.warmup()
    log(f"predictor {cfg.backbone} {cfg.image_size}px rank {cfg.rank} "
        f"built and warmed in {time.monotonic() - t0:.1f} s "
        f"(cudnn.allow_tf32={torch.backends.cudnn.allow_tf32})")
    rng = np.random.default_rng(0)
    singles = rng.integers(0, 256, (12, 224, 224, 3), dtype=np.uint8)
    batch = rng.integers(0, 256, (40, 224, 224, 3), dtype=np.uint8)

    # -- the main path, counted ---------------------------------------------
    batcher = serving.DynamicBatcher(pred.predict_preprocessed, max_batch=32,
                                     max_wait_ms=20.0)
    d0 = pred.stats.snapshot().get("serving_device_dispatches_total", 0)
    apc.reset_launch_counts()
    results = [None] * len(singles)

    def client(i):
        results[i] = batcher.submit(singles[i]).result(timeout=120)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(singles))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    probs = pred.predict_arrays(batch)
    torch.cuda.synchronize()
    launches = dict(apc.launch_counts)
    dispatches = int(pred.stats.snapshot()["serving_device_dispatches_total"]
                     - d0)
    batcher.stop()

    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError("a batcher request did not complete")
    for r in results:
        p_top = [e["prob"] for e in r["topk"]]
        if not (len(p_top) == 5 and np.isfinite(p_top).all()):
            raise AssertionError(f"bad batcher result {r}")
    if probs.shape != (40, 393) or not np.isfinite(probs).all():
        raise AssertionError(f"bad probabilities, shape {probs.shape}")
    if not np.allclose(probs.sum(-1), 1.0, atol=1e-4):
        raise AssertionError("probabilities do not sum to 1")
    log(f"batcher: 12 requests in "
        f"{int(batcher.stats.snapshot()['serving_coalesced_batches_total'])}"
        f" coalesced batches; predict_arrays(40): 2 chunks; "
        f"{dispatches} dispatches; launches {launches}")
    if launches != {"saliency_summary": dispatches,
                    "project_logits": dispatches,
                    "pool_backward": 0} or dispatches < 3:
        raise AssertionError(
            f"kernel launches {launches} != forward dispatches {dispatches}")

    # -- card vs the CPU plain path, no TF32 --------------------------------
    torch.backends.cudnn.allow_tf32 = False
    two = batch[:2]
    card_logits = pred._fwd(pred._weights, two)
    cpu_model = build_model(cfg, device="cpu")
    convert.load_flax_variables(cpu_model, params, stats)
    with torch.no_grad():
        cpu_logits = cpu_model(
            normalize_images(torch.from_numpy(two)))["logits"].numpy()
    err = np.abs(card_logits - cpu_logits).max() / np.abs(cpu_logits).max()
    log(f"card vs CPU logits (2 images, no TF32): relative error {err:.2e} "
        f"(tolerance {CPU_RTOL:g}), max |logit| "
        f"{np.abs(cpu_logits).max():.3f}")
    if not err < CPU_RTOL:
        raise AssertionError(f"card logits disagree with CPU: {err:.2e}")
    torch.backends.cudnn.allow_tf32 = True

    # -- latency and throughput by bucket (cuDNN's default TF32) -----------
    for size in pred.buckets:
        imgs = batch[:size]
        for _ in range(3):
            pred.predict_arrays(imgs)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            pred.predict_arrays(imgs)
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        log(f"serving bucket {size}: {size / med:.1f} images/s, median "
            f"{med * 1e3:.3f} ms a call (p90 {np.percentile(times, 90) * 1e3:.3f}"
            f" ms; uint8 in, probabilities out, cudnn TF32 on) on {card}")
    return pred, launches


def phase_profile(pred):
    """Device time of a predict_arrays call at each bucket, by kernel, and
    the device's busy share of the host's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reps = 5
    for size in pred.buckets:
        imgs = np.zeros((size, 224, 224, 3), np.uint8)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                pred.predict_arrays(imgs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        # only the device's own events: an aten op's device time is its
        # kernels' time again
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in events) / 1e3 / reps
        log(f"profile: bucket-{size} predict_arrays, {wall_ms:.3f} ms wall, "
            f"{total:.3f} ms device time a call (device busy "
            f"{total / wall_ms:.1%}), "
            f"{sum(e.count for e in events) // reps} device events")
        if total == 0:
            raise AssertionError("the profiler saw no device time")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            ms = e.self_device_time_total / 1e3 / reps
            log(f"  {ms / total:6.1%} {ms:8.3f} ms  {e.count // reps:4d}x  "
                f"{e.key[:80]}")


# -- phase 4 -----------------------------------------------------------------

GRAFT = dict(dataset="mpii", backbone="resnet_v1_50", pooling="pose_attention",
             rank=2, image_size=64, batch_size=4, bf16_backbone=False,
             learning_rate=1e-3, grad_clip_norm=10.0, lr_schedule="constant",
             ema_decay=0.999, grad_accum_steps=2)


def train_batch(rng, cfg):
    """A seeded numpy batch: uint8 images, labels and, for pose attention,
    the crop/flip transform, keypoints and visibility."""
    b, size = cfg.batch_size, cfg.image_size
    batch = {"image": rng.integers(0, 256, (b, size, size, 3), np.uint8),
             "label": rng.integers(0, 393, b).astype(np.int32)}
    if cfg.pooling == "pose_attention":
        batch["transform"] = np.stack(
            [rng.uniform(0.8, 1.2, b), rng.uniform(0.8, 1.2, b),
             rng.uniform(0, 8, b), rng.uniform(0, 8, b),
             (np.arange(b) % 2).astype(np.float64)], 1).astype(np.float32)
        batch["keypoints"] = rng.uniform(0, size, (b, 16, 2)).astype(
            np.float32)
        batch["visibility"] = (rng.uniform(size=(b, 16)) > 0.2).astype(
            np.float32)
    return batch


def train_snapshot(state):
    """CPU copies of what a step changes, by name."""
    opt = state.optimizer
    return {
        "stats": {k: v.detach().cpu().clone()
                  for k, v in state.model.state_dict().items()
                  if k.endswith(("running_mean", "running_var"))},
        "momentum": {n: opt.state[p]["momentum_buffer"].cpu().clone()
                     for n, p in state.model.named_parameters()
                     if p in opt.state},
        "params": {n: p.detach().cpu().clone()
                   for n, p in state.model.named_parameters()},
        "ema": ({n: t.cpu().clone() for n, t in state.ema_params.items()}
                if state.ema_params is not None else None),
    }


def sync_state(dst, src):
    """Set ``dst`` to ``src``: weights, statistics, momentum, EMA, step."""
    dst.model.load_state_dict(src.model.state_dict())
    named = dict(dst.model.named_parameters())
    for n, p in src.model.named_parameters():
        if p in src.optimizer.state:
            dst.optimizer.state[named[n]]["momentum_buffer"] = \
                src.optimizer.state[p]["momentum_buffer"].to(
                    named[n].device, copy=True)
    if src.ema_params is not None:
        for n, t in src.ema_params.items():
            dst.ema_params[n].copy_(t)
    dst.step = src.step


def l2_rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def compare_step(what, before, card, cpu, card_m, cpu_m):
    """Raise unless one step on the card agrees with the same step on the
    CPU within the TRAIN_* tolerances; return the worst errors."""
    errs = {}
    for k, want in cpu_m.items():
        got = card_m[k]
        tol = TRAIN_NORM_RTOL if k == "grad_norm" else TRAIN_LOSS_RTOL
        errs[k] = abs(got - want) / abs(want)
        if not (np.isfinite(got) and errs[k] < tol):
            raise AssertionError(f"{what}: {k} {got} on the card, {want} on "
                                 f"the CPU (tolerance {tol})")
    errs["bn_stat_change"] = 0.0
    for k, want in cpu["stats"].items():
        d_card, d_cpu = card["stats"][k] - before["stats"][k], \
            want - before["stats"][k]
        err = float((d_card - d_cpu).abs().max() / d_cpu.abs().max())
        errs["bn_stat_change"] = max(errs["bn_stat_change"], err)
        if not err < TRAIN_STAT_RTOL:
            raise AssertionError(f"{what}: the change of {k} differs by "
                                 f"{err:.2e} of its largest")
    sq_err = sq_ref = errs["momentum_leaf_l2"] = errs["head_l2"] = 0.0
    for k, want in cpu["momentum"].items():
        got = card["momentum"][k]
        err = l2_rel(got, want)
        head = k.startswith("head.")
        tol = TRAIN_HEAD_L2 if head else TRAIN_LEAF_L2
        key = "head_l2" if head else "momentum_leaf_l2"
        errs[key] = max(errs[key], err)
        if not err < tol:
            raise AssertionError(f"{what}: momentum of {k} differs by "
                                 f"{err:.2e} in L2 (tolerance {tol})")
        sq_err += float(((got - want) ** 2).sum())
        sq_ref += float((want ** 2).sum())
    errs["momentum_total_l2"] = (sq_err / sq_ref) ** 0.5
    if not errs["momentum_total_l2"] < TRAIN_TOTAL_L2:
        raise AssertionError(f"{what}: momentum buffers differ by "
                             f"{errs['momentum_total_l2']:.2e} in L2")
    for name, tree in (("params", card["params"]), ("ema", card["ema"])):
        if tree is not None and not all(torch.isfinite(t).all()
                                        for t in tree.values()):
            raise AssertionError(f"{what}: non-finite {name} on the card")
    log(f"{what}: card vs CPU, TF32 off: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    return errs


def phase_training(card):
    """mpii_rank1_224 at full width: card vs CPU, timed steps, and the
    counted main path through train.train."""
    cfg = config_lib.get_config("mpii_rank1_224")
    variables = convert.random_flax_variables(
        cfg.backbone, num_classes=393, rank=cfg.rank, num_positions=49,
        seed=0)
    rng = np.random.default_rng(1)
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    card_state, spec = train.create_state(cfg, device="cuda",
                                          variables=variables)
    cpu_state, _ = train.create_state(cfg, device="cpu", variables=variables)
    step = train.make_train_step(spec, cfg)
    log(f"train states ({cfg.backbone} {cfg.image_size}px batch "
        f"{cfg.batch_size}, card and CPU) built in "
        f"{time.monotonic() - t0:.1f} s")
    batch = train_batch(rng, cfg)
    before = train_snapshot(cpu_state)
    _, card_m = step(card_state, train.batch_to_device(batch, "cuda"))
    t0 = time.monotonic()
    _, cpu_m = step(cpu_state, train.batch_to_device(batch, "cpu"))
    log(f"one CPU step took {time.monotonic() - t0:.1f} s "
        f"({torch.get_num_threads()} threads)")
    errs = compare_step(
        "mpii_rank1_224 step", before, train_snapshot(card_state),
        train_snapshot(cpu_state), {k: float(v) for k, v in card_m.items()},
        {k: float(v) for k, v in cpu_m.items()})
    del cpu_state

    # -- step time, cuDNN's default TF32 -------------------------------------
    torch.backends.cudnn.allow_tf32 = True
    dev_batch = train.batch_to_device(train_batch(rng, cfg), "cuda")
    for _ in range(3):
        step(card_state, dev_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        step(card_state, dev_batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"train step {cfg.backbone} {cfg.image_size}px batch "
        f"{cfg.batch_size}: median {med * 1e3:.3f} ms over 10 steps (min "
        f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
        f"{cfg.batch_size / med:.1f} images/s, peak {peak_gb:.2f} GB "
        f"(batch on the card, cudnn TF32 on) on {card}")

    # -- the main path, counted: train.train over 8 numpy batches ------------
    run_cfg = dataclasses.replace(cfg, log_every=4)
    batches = [train_batch(rng, cfg) for _ in range(8)]
    t0 = time.perf_counter()
    (state, history), launches = counted(lambda: train.train(
        run_cfg, train_iter=iter(batches), num_steps=8, device="cuda"))
    wall = time.perf_counter() - t0
    log(f"train.train: 8 steps from the seed-{cfg.seed} init in {wall:.1f} s "
        f"(state built included); history {history}; launches {launches}")
    # numpy batches handed to the step: nothing is decoded
    expect_launches("train.train over 8 steps", launches, 8, ycc=0,
                    backward=8)
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"non-finite metrics {history}")
    if not all(torch.isfinite(p).all() for p in state.model.parameters()):
        raise AssertionError("non-finite parameters after train.train")
    return {"launches": launches, "step_ms": med * 1e3,
            "images_per_s": cfg.batch_size / med, "errs": errs,
            "state": card_state, "step": step, "batch": dev_batch}


def phase_training_small():
    """The __graft_entry__ config without its mesh: 2 steps card vs CPU,
    each from the same state; each kernel launches twice a step."""
    cfg = config_lib.TrainConfig(**GRAFT)
    variables = convert.random_flax_variables(
        cfg.backbone, num_classes=393, rank=cfg.rank, num_positions=4,
        pooling=cfg.pooling, seed=2)
    rng = np.random.default_rng(2)
    torch.backends.cudnn.allow_tf32 = False
    card_state, spec = train.create_state(cfg, device="cuda",
                                          variables=variables)
    cpu_state, _ = train.create_state(cfg, device="cpu", variables=variables)
    step = train.make_train_step(spec, cfg)
    for i in range(2):
        batch = train_batch(rng, cfg)
        sync_state(card_state, cpu_state)
        before = train_snapshot(cpu_state)
        apc.reset_launch_counts()
        _, card_m = step(card_state, train.batch_to_device(batch, "cuda"))
        torch.cuda.synchronize()
        launches = dict(apc.launch_counts)
        if launches != {"saliency_summary": 2, "project_logits": 2,
                        "pool_backward": 2}:
            raise AssertionError(f"graft step {i + 1}: launches {launches}, "
                                 "want 2 of each (two microbatches)")
        _, cpu_m = step(cpu_state, train.batch_to_device(batch, "cpu"))
        compare_step(f"graft config step {i + 1}", before,
                     train_snapshot(card_state), train_snapshot(cpu_state),
                     {k: float(v) for k, v in card_m.items()},
                     {k: float(v) for k, v in cpu_m.items()})
    torch.backends.cudnn.allow_tf32 = True


def phase_train_profile(run):
    """Device time of one mpii_rank1_224 train step: the top kernels, the
    backward (autograd's nodes), the optimizer, the pooling head's forward
    kernels and backward, and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, step, batch = run["state"], run["step"], run["batch"]
    step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # the device's own events; a record_function range (the optimizer's
    # "Optimizer.step#SGD.step") shows on the device's track too, and
    # would count its kernels twice
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if total == 0:
        raise AssertionError("the profiler saw no device time")

    def inclusive(pred):
        return sum(e.device_time_total for e in averages
                   if e.device_type != DeviceType.CUDA and pred(e.key)) / 1e3

    backward = inclusive(
        lambda k: k.startswith("autograd::engine::evaluate_function"))
    head_bwd = inclusive(lambda k: k.startswith(
        "autograd::engine::evaluate_function") and "AttentionalPoolFn" in k)
    optimizer = inclusive(lambda k: k.startswith("Optimizer.step"))
    head_fwd = sum(e.self_device_time_total for e in kernels
                   if "saliency_summary_kernel" in e.key
                   or "project_logits_kernel" in e.key) / 1e3
    bn = sum(e.self_device_time_total for e in kernels
             if "batch_norm" in e.key) / 1e3
    log(f"profile: one train step, {wall_ms:.3f} ms wall, {total:.3f} ms "
        f"device time (device busy {total / wall_ms:.1%}), "
        f"{sum(e.count for e in kernels)} device events")
    log(f"  backward (autograd nodes) {backward:.3f} ms "
        f"({backward / total:.1%}); optimizer.step {optimizer:.3f} ms; "
        f"the rest (forward, losses, clip, EMA) "
        f"{total - backward - optimizer:.3f} ms; BN kernels (forward and "
        f"backward) {bn:.3f} ms ({bn / total:.1%})")
    log(f"  pooling head: forward kernels {head_fwd:.3f} ms, backward "
        f"(AttentionalPoolFn) {head_bwd:.3f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"  {ms / total:6.1%} {ms:8.3f} ms  {e.count:4d}x  {e.key[:80]}")


# -- phase 5 -----------------------------------------------------------------

def eval_set(rng, n=40, batch=16, crops=0):
    """A seeded uint8 MPII eval set in batches of ``batch``; the last
    batch is padded with rows of mask 0."""
    shape = (n, crops, 224, 224, 3) if crops else (n, 224, 224, 3)
    images = rng.integers(0, 256, shape, np.uint8)
    labels = rng.integers(0, 393, n).astype(np.int32)
    out = []
    for lo in range(0, n, batch):
        b = {"image": images[lo:lo + batch], "label": labels[lo:lo + batch],
             "mask": np.ones(min(batch, n - lo), np.float32)}
        pad = batch - len(b["label"])
        if pad:
            b = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:],
                                                v.dtype)])
                 for k, v in b.items()}
        out.append(b)
    return out


def state_tensors(state):
    """Every tensor a TrainState holds, by name, and its step."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    named = dict(state.model.named_parameters())
    for n, p in named.items():
        if p in state.optimizer.state:
            out[f"momentum.{n}"] = state.optimizer.state[p]["momentum_buffer"]
    return out, state.step


def counted(fn):
    """``fn()``'s result and the kernel launches it made, the pooling
    kernels' and the colour kernel's (counts set to 0 just before, read
    after a synchronize).  ``jpeg.decode_count``, ``jpeg.decode_calls``
    and ``jpeg.ycc_images`` are reset with them."""
    apc.reset_launch_counts()
    jpeg.reset_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, {**apc.launch_counts, **jpeg.launch_counts}


def expect_launches(what, launches, n, ycc=None, backward=0):
    """Each forward pooling kernel launched ``n`` times, the backward
    ``backward`` times (once a train step), and the colour kernel ``ycc``
    times unless that is None."""
    pooling = {k: launches[k] for k in ("saliency_summary", "project_logits",
                                        "pool_backward")}
    if pooling != {"saliency_summary": n, "project_logits": n,
                   "pool_backward": backward} or (
            ycc is not None and launches["ycc_to_rgb"] != ycc):
        raise AssertionError(f"{what}: kernel launches {launches}, want {n} "
                             f"of each forward pooling kernel, {backward} "
                             f"backward"
                             + ("" if ycc is None else f", {ycc} colour"))


def eval_serialized(step_fn, batches):
    """The eval loop without its pipeline: each batch's logits are
    fetched, by a blocking copy, before the next batch is dispatched."""
    return [step_fn(train.batch_to_device({"image": b["image"]}, "cuda")
                    ["image"]).to(torch.float32).cpu().numpy()
            for b in batches]


def eval_rate(step_fn, batches, pipelined, reps):
    """Images/s of ``eval_logits`` (pipelined) or of ``eval_serialized``
    over ``reps`` passes of ``batches``, counting the unpadded images."""
    images = reps * sum(int(b["mask"].sum()) for b in batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if pipelined:
        evaluate.eval_logits(step_fn, batches * reps, device="cuda")
    else:
        eval_serialized(step_fn, batches * reps)
    return images / (time.perf_counter() - t0)


def profile_eval(step_fn, batches):
    """Device time of one pipelined pass of ``batches`` through the eval
    loop, and the device's busy share of the host's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate.eval_logits(step_fn, batches, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    if total == 0:
        raise AssertionError("the profiler saw no device time")
    log(f"profile: eval loop, {len(batches)} batches of 16 pipelined, "
        f"{wall_ms:.3f} ms wall, {total:.3f} ms device time (device busy "
        f"{total / wall_ms:.1%}), {sum(e.count for e in events)} device "
        f"events")


def check_eval_against_cpu(what, err, results, cpu_results):
    """The card's eval against the CPU's on the same weights and images:
    logits within CPU_RTOL, 40 examples, metrics within their tolerance."""
    if not err < CPU_RTOL:
        raise AssertionError(f"{what} logits, card vs CPU: {err:.2e}")
    if results["num_examples"] != 40 or cpu_results["num_examples"] != 40:
        raise AssertionError(f"{what}: num_examples is not 40")
    for k, tol in (("mAP", EVAL_MAP_ATOL), ("accuracy", EVAL_ACC_ATOL)):
        if not abs(results[k] - cpu_results[k]) <= tol:
            raise AssertionError(f"{what} {k}: card {results[k]} vs CPU "
                                 f"{cpu_results[k]} (tolerance {tol})")


def phase_checkpointed_run(card, profile=False):
    """mpii_rank1_224 at full width: stop by SIGTERM, resume, evaluate
    (card vs CPU), keep the best, serve it and follow a newer step."""
    t_phase = time.monotonic()
    cfg = config_lib.get_config("mpii_rank1_224")
    rng = np.random.default_rng(5)
    out = {"config": "mpii_rank1_224", "card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        # the seeded Flax-layout weights as step 0 of a port run, from
        # which the run warm-starts (heads fresh, from cfg.seed)
        init, _ = train.create_state(
            cfg, device="cuda", variables=convert.random_flax_variables(
                cfg.backbone, num_classes=393, rank=cfg.rank,
                num_positions=49, seed=0))
        init_mgr = checkpoint.make_manager(f"{workdir}/init")
        checkpoint.save(init_mgr, init)
        init_mgr.wait_until_finished()
        del init, init_mgr
        run_cfg = dataclasses.replace(
            cfg, workdir=workdir, init_checkpoint=f"{workdir}/init",
            checkpoint_every=2, max_checkpoints=2, log_every=1,
            eval_batch_size=16)
        mgr = checkpoint.make_manager(f"{workdir}/checkpoints",
                                      max_to_keep=2)
        batches = [train_batch(rng, cfg) for _ in range(7)]

        # -- stop by SIGTERM at step 3, then resume to 6 --------------------
        def terminate_at_3(step, state, metrics):
            if step == 3:
                os.kill(os.getpid(), signal.SIGTERM)

        (live, hist1), launches = counted(lambda: train.train(
            run_cfg, train_iter=iter(batches), num_steps=6, device="cuda",
            checkpoint_manager=mgr, hooks=[terminate_at_3]))
        if live.step != 3 or mgr.all_steps() != [2, 3]:
            raise AssertionError(f"SIGTERM at step 3: stopped at "
                                 f"{live.step}, steps {mgr.all_steps()}")
        expect_launches("train.train to the SIGTERM", launches, 3,
                        backward=3)
        fresh, _ = train.create_state(cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.restore(mgr, fresh, step=3)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        want, want_step = state_tensors(live)
        got, got_step = state_tensors(fresh)
        if got.keys() != want.keys() or got_step != want_step or not all(
                torch.equal(got[k], want[k]) for k in want):
            bad = [k for k in want if k not in got
                   or not torch.equal(got[k], want[k])]
            raise AssertionError(f"restored step 3 differs from the live "
                                 f"state: step {got_step}, {bad[:5]}")
        timing = checkpoint.make_manager(f"{workdir}/timing")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(timing, live)
        torch.cuda.synchronize()
        out["save_blocking_s"] = time.perf_counter() - t0
        timing.wait_until_finished()
        out["save_s"] = time.perf_counter() - t0
        out["step_bytes"] = os.path.getsize(
            timing.step_dir(3) / checkpoint.CHECKPOINT_FILE)
        log(f"checkpoint: save {out['save_s']:.3f} s to the commit (the "
            f"step thread blocked {out['save_blocking_s']:.3f} s of it, the "
            f"first save of its manager), restore onto the card "
            f"{out['restore_s']:.3f} s, {out['step_bytes']} bytes a step "
            f"({len(want)} tensors, bitwise equal after restore) on {card}")
        del fresh, live, timing

        (state, hist2), launches = counted(lambda: train.train(
            run_cfg, train_iter=iter(batches[3:6]), num_steps=6,
            device="cuda", checkpoint_manager=mgr))
        if state.step != 6 or mgr.all_steps() != [4, 6]:
            raise AssertionError(f"resume: at step {state.step}, steps "
                                 f"{mgr.all_steps()}, want 6 and [4, 6]")
        expect_launches("train.train resumed 3 -> 6", launches, 3,
                        backward=3)
        history = hist1 + hist2
        if [h["step"] for h in history] != list(range(1, 7)) or not all(
                np.isfinite(v) for h in history for v in h.values()):
            raise AssertionError(f"train history {history}")
        log("train: SIGTERM at 3, resumed to 6, losses " + ", ".join(
            f"{h['loss/total']:.4f}" for h in history))

        # -- evaluate step 6, card vs CPU -------------------------------------
        torch.backends.cudnn.allow_tf32 = False
        restored = checkpoint.restore_for_eval(mgr, 6)
        ev_set = eval_set(rng)
        evaluator = evaluate.Evaluator(run_cfg, device="cuda")
        results, launches = counted(
            lambda: evaluator(restored, eval_iter=iter(ev_set)))
        # uint8 arrays injected: nothing is decoded
        expect_launches("evaluate (3 batches)", launches, len(ev_set), ycc=0)
        out["eval_launches"] = launches
        card_host = evaluator.logits(restored, iter(ev_set))
        cpu_host = evaluate.Evaluator(run_cfg, device="cpu").logits(
            restored, iter(ev_set))
        real = card_host["mask"].astype(bool)
        err = float(np.abs(card_host["logits"] - cpu_host["logits"])[real]
                    .max() / np.abs(cpu_host["logits"][real]).max())
        cpu_results = evaluate.compute_metrics(run_cfg, cpu_host)
        out.update(eval=results, eval_cpu=cpu_results, eval_logits_err=err)
        log(f"evaluate step 6 (40 images, batches of 16): card {results}; "
            f"CPU {cpu_results}; logits relative error {err:.2e} (tolerance "
            f"{CPU_RTOL:g}, TF32 off)")
        check_eval_against_cpu("evaluate", err, results, cpu_results)

        # -- 3-crop multicrop, card vs CPU (TF32 off) -------------------------
        # 48 crops a forward: the kernels at B=48 (phase 2 holds them
        # against their plain versions there too)
        mc_cfg = dataclasses.replace(run_cfg, eval_multicrop=3)
        mc_set = eval_set(rng, crops=3)
        mc_eval = evaluate.Evaluator(mc_cfg, device="cuda")
        mc_eval.logits(restored, iter(mc_set))                 # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mc_host, launches = counted(
            lambda: mc_eval.logits(restored, iter(mc_set)))
        mc_s = time.perf_counter() - t0
        expect_launches("3-crop multicrop eval (3 batches)", launches,
                        len(mc_set))
        mc_cpu = evaluate.Evaluator(mc_cfg, device="cpu").logits(
            restored, iter(mc_set))
        real = mc_host["mask"].astype(bool)
        mc_err = float(np.abs(mc_host["logits"] - mc_cpu["logits"])[real]
                       .max() / np.abs(mc_cpu["logits"][real]).max())
        mc_results = evaluate.compute_metrics(mc_cfg, mc_host)
        mc_cpu_results = evaluate.compute_metrics(mc_cfg, mc_cpu)
        out["multicrop3"] = dict(mc_results, images_per_s=40 / mc_s,
                                 logits_err=mc_err)
        log(f"3-crop multicrop eval (batches of 16 images, 48 crops a "
            f"forward): card {mc_results}; CPU {mc_cpu_results}; logits "
            f"relative error {mc_err:.2e} (tolerance {CPU_RTOL:g}, TF32 "
            f"off); {40 / mc_s:.1f} images/s ({120 / mc_s:.1f} crops/s, "
            f"TF32 off)")
        check_eval_against_cpu("multicrop", mc_err, mc_results,
                               mc_cpu_results)
        del mc_eval

        # -- the eval loop's rate, pipelined and serialized (TF32 on) --------
        torch.backends.cudnn.allow_tf32 = True
        reps = 5
        eval_rate(evaluator.step_fn, ev_set, True, 1)          # warm
        rates = {True: [], False: []}
        for order in ((True, False), (False, True)) * 3:
            for pipelined in order:
                rates[pipelined].append(
                    eval_rate(evaluator.step_fn, ev_set, pipelined, reps))
        piped, serial = (float(np.median(rates[k])) for k in (True, False))
        out.update(eval_images_per_s_pipelined=piped,
                   eval_images_per_s_serialized=serial,
                   eval_pipeline_ratio=piped / serial)
        log(f"eval loop, {reps} passes of the 40 images (15 batches of 16) "
            f"a timing, 6 timings each, in turns: pipelined {piped:.1f} "
            f"images/s (runs {', '.join(f'{r:.1f}' for r in rates[True])}), "
            f"serialized {serial:.1f} (runs "
            f"{', '.join(f'{r:.1f}' for r in rates[False])}), ratio "
            f"{piped / serial:.3f} (cudnn TF32 on) on {card}")
        if profile:
            profile_eval(evaluator.step_fn, ev_set * reps)

        # -- keep-best, serve it, follow a newer step (TF32 off) -------------
        torch.backends.cudnn.allow_tf32 = False
        keeper = checkpoint.BestKeeper(workdir)
        lower = dict(results, mAP=results["mAP"] - 0.1)
        if not keeper.update(6, results, state) or \
                keeper.update(7, lower, state) or \
                keeper.best()["step"] != 6:
            raise AssertionError(f"BestKeeper: best {keeper.best()}")
        pred = serving.load_predictor(run_cfg, step="best", buckets=(8,),
                                      device="cuda")
        if pred.step != keeper.best()["step"]:
            raise AssertionError(f"load_predictor(step='best') serves step "
                                 f"{pred.step}")
        images = np.concatenate([b["image"] for b in ev_set])[:8]
        probs, launches = counted(lambda: pred.predict_arrays(images))
        expect_launches("load_predictor dispatch", launches, 1)
        logits = card_host["logits"][:8].astype(np.float64)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        perr = float(np.abs(probs - e / e.sum(-1, keepdims=True)).max())
        log(f"load_predictor(step='best') serves step {pred.step}; "
            f"probabilities vs the evaluator's softmax, 8 images: max abs "
            f"difference {perr:.2e} (tolerance {SERVE_PROB_ATOL:g})")
        if not perr < SERVE_PROB_ATOL:
            raise AssertionError(f"served probabilities differ by {perr}")

        follower = serving.CheckpointFollower(pred, mgr)
        if follower.poll_once():
            raise AssertionError("the follower swapped with no newer step")
        (state, _), launches = counted(lambda: train.train(
            run_cfg, train_iter=iter(batches[6:]), num_steps=7,
            device="cuda", checkpoint_manager=mgr))
        expect_launches("train.train resumed 6 -> 7", launches, 1,
                        backward=1)
        swapped, again = follower.poll_once(), follower.poll_once()
        if not swapped or again or pred.step != 7:
            raise AssertionError(f"follower: swapped {swapped}, again "
                                 f"{again}, serving step {pred.step}")
        probs7 = pred.predict_arrays(images)
        if not (np.isfinite(probs7).all() and np.allclose(
                probs7.sum(-1), 1.0, atol=1e-4)):
            raise AssertionError("bad probabilities after the swap")
        log(f"CheckpointFollower: swapped to step {pred.step} once, not on "
            f"the second poll")
        torch.backends.cudnn.allow_tf32 = True
        del pred, evaluator, state
    out["phase_s"] = time.monotonic() - t_phase
    log(f"phase 5 took {out['phase_s']:.1f} s (workdir removed)")
    return out


# -- phase 6 -----------------------------------------------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tests", "fixtures_torch")
FIXTURE_TRAIN_SEED = 1000   # a fixture's train geometry: default_rng(1000 + i)
# The gate of nvJPEG + the torch preprocessing against the JAX goldens
# (libjpeg-turbo's decode and cv2.resize): the decoders differ in their
# IDCT, chroma upsampling and colour conversion by a level or two.
DECODE_MEAN_LEVELS = 1.5
DECODE_FAR_LEVELS, DECODE_FAR_SHARE = 8, 0.01
N_TRAIN_RECORDS, N_EVAL_RECORDS = 512, 48
# The eval logits of the records (decoded on the card) against those of the
# golden crops, bounded by two controls on the golden crops with the same
# root-mean-square as the largest eval decode gap (to first order the
# logits move with the perturbation's L2 norm): white noise, and a
# constant shift of each image's channels.  The gap's spatial structure
# lies between the two (a ResNet's first 7x7 convolution averages white
# noise away and passes a shift whole); 3x the larger leaves room for the
# first-order estimate.  A channel swap or a flip moves the logits by O(1).
RECORD_LOGITS_CONTROL_FACTOR = 3.0
EVAL_KEYS = {"num_examples", "mAP", "num_eval_classes", "accuracy", "step"}


def load_fixtures():
    """The JPEG fixtures, and the JAX pipeline's crops and transforms of
    them (tests/fixtures_torch/make_fixtures.py)."""
    golden = np.load(os.path.join(FIXTURES, "golden.npz"))
    names = [str(n) for n in golden["names"]]
    datas = []
    for n in names:
        with open(os.path.join(FIXTURES, n), "rb") as f:
            datas.append(f.read())
    crops = {k: np.cumsum(golden[f"{k}_image_dx"], axis=2, dtype=np.uint8)
             for k in ("eval", "train")}
    transforms = {k: golden[f"{k}_transform"] for k in ("eval", "train")}
    return names, datas, crops, transforms


def fixture_geometry(kind, i, data):
    h, w = jpeg.image_size(data)
    return pp.draw_geometry(
        h, w, out_size=224, is_training=kind == "train", resize_min=256,
        resize_max=512, rng=(np.random.default_rng(FIXTURE_TRAIN_SEED + i)
                             if kind == "train" else None))


def check_colour_kernel(timer, names, datas):
    """The colour kernel (libjpeg's chroma upsampling and YCbCr -> RGB) in
    one launch over nvJPEG's planes of every colour fixture, each image
    bit for bit against its plain version; timed over batches of 1, 8 and
    16 of the 1280x720 4:2:0 fixtures (MPII's size), beside the bound."""
    colour = [(name, pl) for name, pl in zip(
        names, jpeg.decode_planes(datas, "cuda")) if pl[3] is not None]
    planes = [pl for _, pl in colour]
    got, launches = counted(lambda: jpeg.ycc_to_rgb_batch(planes))
    if launches["ycc_to_rgb"] != 1 or jpeg.ycc_images != len(planes):
        raise AssertionError(f"ycc_to_rgb_batch of {len(planes)} images: "
                             f"launches {launches}, {jpeg.ycc_images} "
                             f"converted")
    err = 0
    for (name, (y, cb, cr, sampling)), rgb in zip(colour, got):
        want = jpeg.ycc_to_rgb_plain(y, cb, cr, *sampling)
        d = int((rgb.int() - want.int()).abs().max())
        log(f"ycc_to_rgb vs plain, {name} {tuple(y.shape)} chroma "
            f"{tuple(cb.shape)} at {sampling[0]}x{sampling[1]}: max |d| {d}"
            f" (tolerance 0)")
        if d:
            raise AssertionError(f"ycc_to_rgb disagrees with its plain "
                                 f"version on {name}: {d}")
        err = max(err, d)
    mpii = [pl for _, pl in colour
            if pl[0].shape == (720, 1280) and pl[3] == (2, 2)]
    if not mpii:
        raise AssertionError("no 1280x720 4:2:0 fixture")
    lib = jpeg.LIBRARY.load()
    batches = {}
    for n in (1, 8, 16):
        batch = [mpii[i % len(mpii)] for i in range(n)]
        nbytes = ops = 0
        for y, cb, cr, (hf, vf) in batch:
            h, w = y.shape
            cw, ch = -(-w // hf), -(-h // vf)
            # reads Y and both chroma planes once, writes RGB once; ~30
            # integer operations a pixel on the CUDA cores
            nbytes += h * w + 2 * cw * ch + 3 * h * w
            ops += 30 * h * w
        bms, by = bound_ms(nbytes, ops)
        # the launch alone, on a table made once; the wrapper packs and
        # copies the table on every call
        outs = [torch.empty((*y.shape, 3), dtype=torch.uint8, device="cuda")
                for y, _, _, _ in batch]
        plan = jpeg.ycc_batch_plan(
            [(y.data_ptr(), cb.data_ptr(), cr.data_ptr(), o.data_ptr(),
              y.stride(0), cb.stride(0), y.shape[1], y.shape[0], *sampling)
             for (y, cb, cr, sampling), o in zip(batch, outs)])
        host = torch.from_numpy(plan.table).pin_memory()
        table = host.cuda()

        def launch():
            err = lib.apj_ycc_to_rgb_batch(
                host.data_ptr(), table.data_ptr(), plan.n_images,
                plan.n_tiles, plan.smem_bytes,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"ycc_to_rgb launch: error {err}")

        launch()
        if not all(torch.equal(o, r) for o, r in
                   zip(outs, jpeg.ycc_to_rgb_batch(batch))):
            raise AssertionError("the launch alone and ycc_to_rgb_batch "
                                 "differ")
        host_s = []
        for _ in range(20):
            t0 = time.perf_counter()
            jpeg.ycc_to_rgb_batch(batch)
            host_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        row = {"images": n, "shape": [720, 1280], "sampling": [2, 2],
               "ms": timer(launch),
               "call_ms": timer(lambda: jpeg.ycc_to_rgb_batch(batch)),
               "host_ms": float(np.median(host_s)) * 1e3,
               "plain_ms": timer(lambda: [jpeg.ycc_to_rgb_plain(
                   y, cb, cr, *sm) for y, cb, cr, sm in batch]),
               "bound_ms": bms, "bound_by": by, "tiles": plan.n_tiles,
               "tile_groups": plan.tile_groups}
        row["bound_share"] = bms / row["ms"]
        batches[n] = row
        log(f"ycc_to_rgb, a batch of {n} 1280x720 4:2:0: the launch "
            f"{row['ms']:.4f} ms ({row['ms'] / n:.4f} an image), bound "
            f"{bms:.4f} ms ({by}), {row['bound_share']:.1%} of it; "
            f"{plan.n_tiles} tiles of {plan.tile_groups} groups; "
            f"ycc_to_rgb_batch {row['call_ms']:.4f} ms on the card (the "
            f"table's copy included), {row['host_ms']:.4f} ms on the host a "
            f"call; plain {row['plain_ms']:.4f} ms")
    main_row = batches[16]
    return {"max_abs_err": err, "ms": main_row["ms"],
            "call_ms": main_row["call_ms"], "host_ms": main_row["host_ms"],
            "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
            "bound_share": main_row["bound_share"], "images": 16,
            "batches": batches}


def check_decode(names, datas, crops, transforms):
    """Decode every fixture on the card and crop it at the eval and the
    seeded train geometry; hold each crop against the JAX pipeline's."""
    images = jpeg.decode(datas, "cuda")
    again = jpeg.decode(datas, "cuda")
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(images, again)):
        raise AssertionError("two nvJPEG decodes gave different bits")
    out = {}
    for kind in ("eval", "train"):
        for i, (name, data) in enumerate(zip(names, datas)):
            g = fixture_geometry(kind, i, data)
            if not np.array_equal(g.transform(), transforms[kind][i]):
                raise AssertionError(f"{kind} transform of {name}: "
                                     f"{g.transform()} vs JAX "
                                     f"{transforms[kind][i]}")
            crop = pp.apply_geometry(images[i], g, out_size=224,
                                     keep_uint8=True).cpu().numpy()
            d = np.abs(crop.astype(np.int16) - crops[kind][i])
            row = {"mean": float(d.mean()), "max": int(d.max()),
                   "rms": float(np.sqrt((d.astype(np.float64) ** 2).mean())),
                   "p99_9": float(np.percentile(d, 99.9)),
                   "far_share": float((d > DECODE_FAR_LEVELS).mean())}
            out[f"{kind}/{name}"] = row
            log(f"decode+crop vs JAX, {kind:<5} {name:<22} "
                f"{tuple(images[i].shape)}: mean |d| {row['mean']:.3f}, rms "
                f"{row['rms']:.3f}, max "
                f"{row['max']}, p99.9 {row['p99_9']:.1f}, > "
                f"{DECODE_FAR_LEVELS}: {row['far_share']:.2%}")
            if not (row["mean"] <= DECODE_MEAN_LEVELS
                    and row["far_share"] <= DECODE_FAR_SHARE):
                raise AssertionError(
                    f"{kind} crop of {name} off the JAX golden: {row} (gate"
                    f" mean <= {DECODE_MEAN_LEVELS}, > {DECODE_FAR_LEVELS} "
                    f"on <= {DECODE_FAR_SHARE:.0%})")
    return out


def write_records(workdir, datas, prefix=""):
    """512 train and 48 eval MPII-schema records (record i holds the JPEG
    ``datas[i % len(datas)]``) with seeded labels, keypoints and
    visibility, indexed."""
    rng = np.random.default_rng(6)
    dims = [jpeg.image_size(d) for d in datas]

    def examples(n):
        for i in range(n):
            k = i % len(datas)
            h, w = dims[k]
            yield records.make_example(
                datas[k], height=h, width=w, label=int(rng.integers(393)),
                keypoints=(rng.uniform(size=(16, 2)) * [h, w]).astype(
                    np.float32),
                visibility=(rng.uniform(size=16) > 0.2).astype(np.float32))

    paths = {}
    t0 = time.perf_counter()
    for split, n in (("train", N_TRAIN_RECORDS), ("val", N_EVAL_RECORDS)):
        paths[split] = os.path.join(workdir, f"{prefix}{split}.tfrecord")
        records.write_tfrecord(paths[split], examples(n))
        if native_io.build_index(paths[split]) != n:
            raise AssertionError(f"{paths[split]} does not hold {n} records")
    log(f"records: {N_TRAIN_RECORDS} train "
        f"({os.path.getsize(paths['train'])} bytes) and {N_EVAL_RECORDS} "
        f"eval of {len(datas)} JPEGs written and indexed in "
        f"{time.perf_counter() - t0:.2f} s")
    return paths


def read_scalars(workdir):
    """tag -> [(step, value)] of the event files of ``workdir``."""
    out = {}
    for name in sorted(os.listdir(workdir)):
        if "tfevents" not in name:
            continue
        for raw in records.read_tfrecord(os.path.join(workdir, name)):
            fields = list(_fields(raw))
            step = next((v for n, _, v in fields if n == 2), 0)
            for value in (v for n, _, s in fields if n == 5
                          for m, _, v in _fields(s) if m == 1):
                f = {k: v for k, _, v in _fields(value)}
                if 2 in f:                   # a scalar, not an image
                    out.setdefault(bytes(f[1]).decode(), []).append(
                        (step, struct.unpack("<f", f[2])[0]))
    return out


def check_colour_launches(what, launches, decoded, calls, converted, least):
    """The colour kernel launched once a ``decode()`` call that held a
    colour image: at least once, at most once a call, and fewer times than
    it converted images (a call hands over a batch); ``least`` images
    decoded at least, each colour one converted once."""
    ycc = launches["ycc_to_rgb"]
    if decoded < least or not 0 < ycc <= calls or not ycc < converted or \
            converted > decoded:
        raise AssertionError(
            f"{what}: {decoded} images decoded on the card in {calls} "
            f"decode() calls (want >= {least} images); the colour kernel "
            f"launched {ycc} times for {converted} colour images")


def run_clis(paths, run_dir):
    """train_cli for 12 steps (checkpoints every 4, an eval every 6), then
    eval_cli of the last step; launches counted over each."""
    out = {}
    args = ["--config", "mpii_rank1_224", "--train_pattern", paths["train"],
            "--eval_pattern", paths["val"], "--workdir", run_dir,
            "--num_steps", "12", "--eval_every", "6",
            "--set", "checkpoint_every=4", "--set", "log_every=1"]
    t0 = time.perf_counter()
    state, launches = counted(lambda: train_cli.main(args))
    out["train_cli_s"] = time.perf_counter() - t0
    out["train_cli_decoded"] = jpeg.decode_count
    decode_calls, converted = jpeg.decode_calls, jpeg.ycc_images
    # 12 steps, and two evaluations of the 48 eval records in 6 batches
    expect_launches("train_cli: 12 steps, 2 evals of 6 batches", launches,
                    12 + 2 * 6, backward=12)
    out["pipeline_train_launches"] = launches
    mgr = checkpoint.make_manager(os.path.join(run_dir, "checkpoints"))
    iter_state = json.loads(
        (mgr.directory / "grain_iter_12_p0.json").read_text())
    best = checkpoint.BestKeeper(run_dir).best()
    if state.step != 12 or mgr.all_steps() != [4, 8, 12] or \
            iter_state != dict(zip(("epoch", "position"),
                                   divmod(96, N_TRAIN_RECORDS))) or \
            best is None:
        raise AssertionError(f"train_cli: step {state.step}, steps "
                             f"{mgr.all_steps()}, stream {iter_state}, best "
                             f"{best}")
    # 96 train images and 96 eval images at least (the prefetch reads on);
    # the colour kernel once a decode() call (a batch handed out: 8 train
    # or 16 eval records, one grayscale fixture in 7)
    check_colour_launches("train_cli", launches, out["train_cli_decoded"],
                          decode_calls, converted, least=192)
    del state
    t0 = time.perf_counter()
    printed, launches = counted(lambda: eval_cli.main([
        "--config", "mpii_rank1_224", "--workdir", run_dir,
        "--eval_pattern", paths["val"]]))
    out["eval_cli_s"] = time.perf_counter() - t0
    expect_launches("eval_cli: 6 batches", launches, 6)
    out["pipeline_eval_launches"] = launches
    check_colour_launches("eval_cli", launches, jpeg.decode_count,
                          jpeg.decode_calls, jpeg.ycc_images,
                          least=N_EVAL_RECORDS)
    line = printed[-1]
    if set(line) != EVAL_KEYS or line["step"] != 12 or \
            line["num_examples"] != 48:
        raise AssertionError(f"eval_cli printed {line}")
    out["eval_cli"] = line
    scalars = read_scalars(run_dir)
    steps = [s for s, _ in scalars.get("loss/total", [])]
    losses = [v for _, v in scalars.get("loss/total", [])]
    evals = [s for s, _ in scalars.get("eval/mAP", [])]
    if steps != list(range(1, 13)) or sorted(evals) != [6, 12, 12] or \
            not np.isfinite(losses).all():
        raise AssertionError(f"event files: loss/total at {steps}, "
                             f"eval/mAP at {evals}")
    out["losses"] = losses
    log(f"train_cli: 12 steps from records in {out['train_cli_s']:.1f} s "
        f"(state, 3 saves, 2 evals and the best slot included; "
        f"{out['train_cli_decoded']} images decoded on the card), losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; launches {out['pipeline_train_launches']}")
    log(f"eval_cli: {line} in {out['eval_cli_s']:.1f} s; launches {launches}"
        f"; event files hold loss/total at steps 1-12 and eval/mAP at "
        f"{sorted(evals)}")
    return out


def batch_digest(batch):
    h = hashlib.sha256()
    for k in sorted(batch):
        t = batch[k]
        h.update(f"{k} {tuple(t.shape)} {t.dtype}".encode())
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def digesting(digests):
    """``train.train``'s steps append a digest of each batch they get (on
    the card, after the pipeline, prefetch and echo) to ``digests``."""
    make = train.make_train_step

    def make_digesting(spec, cfg, mesh=None):
        step = make(spec, cfg, mesh)

        def step_fn(state, batch):
            digests.append(batch_digest(batch))
            return step(state, batch)
        return step_fn

    train.make_train_step = make_digesting
    try:
        yield
    finally:
        train.make_train_step = make


def check_resume(paths, workdir, echo, preset="mpii_rank1_224", stop=5,
                 steps=10, **overrides):
    """``steps`` steps of ``preset`` from records straight, against a real
    SIGTERM at step ``stop`` and a resumed run to ``steps``: losses and
    batch digests equal bit for bit.  cuDNN is held to deterministic
    algorithms for it (some of its weight-gradient convolutions sum in a
    varying order)."""
    cfg = config_lib.get_config(
        preset, train_pattern=paths["train"], log_every=1,
        checkpoint_every=1000, data_echo=echo, **overrides)
    torch.backends.cudnn.deterministic = True
    try:
        straight_d, cut_d = [], []
        with digesting(straight_d):
            state, hist = train.train(cfg, num_steps=steps, device="cuda")
        del state
        mgr = checkpoint.make_manager(
            os.path.join(workdir, f"resume_{preset}_echo{echo}"))

        def terminate(step, state, metrics):
            if step == stop:
                os.kill(os.getpid(), signal.SIGTERM)

        with digesting(cut_d):
            state, hist1 = train.train(cfg, num_steps=steps, device="cuda",
                                       checkpoint_manager=mgr,
                                       hooks=[terminate])
            stopped, kept = state.step, mgr.all_steps()
            del state
            saved = json.loads(
                (mgr.directory / f"grain_iter_{stop}_p0.json").read_text())
            state, hist2 = train.train(cfg, num_steps=steps, device="cuda",
                                       checkpoint_manager=mgr)
            del state
    finally:
        torch.backends.cudnn.deterministic = False
    want = [h["loss/total"] for h in hist]
    got = [h["loss/total"] for h in hist1 + hist2]
    mid_echo = echo == 1 or saved.get("phase") == 1
    if stopped != stop or kept != [stop] or got != want or \
            cut_d != straight_d or len(want) != steps or not mid_echo:
        raise AssertionError(
            f"{preset} resume from records, data_echo={echo}: stopped at "
            f"{stopped}, steps {kept}, saved stream {saved}; losses {got} "
            f"vs {want}; batches equal {cut_d == straight_d}")
    log(f"{preset} resume from records, data_echo={echo}: SIGTERM at "
        f"{stop} (stream {saved}), resumed to {steps}: losses and the "
        f"{len(cut_d)} batch digests equal the uninterrupted run's bit for "
        f"bit; losses " + ", ".join(f"{v:.4f}" for v in want))
    return {"losses": want, "saved_stream": saved}


def golden_batches(images, labels, batch):
    """The 48 eval records' golden crops (record i holds fixture i % 7) as
    injected batches."""
    return [{"image": images[lo:lo + batch], "label": labels[lo:lo + batch],
             "mask": np.ones(len(labels[lo:lo + batch]), np.float32)}
            for lo in range(0, len(labels), batch)]


def check_record_logits(paths, run_dir, crops, decode):
    """The eval records' logits (decoded on the card) against the logits of
    the golden crops injected as arrays, on the same weights (step 12 of
    the CLI run), TF32 off; bounded by the controls above."""
    spec = train.get_dataset("mpii")
    cfg = config_lib.get_config("mpii_rank1_224", eval_pattern=paths["val"],
                                eval_batch_size=16)
    labels = np.array([records.parse_example(r, spec)["label"]
                       for r in records.read_tfrecord(paths["val"])])
    restored = checkpoint.restore_for_eval(
        checkpoint.make_manager(os.path.join(run_dir, "checkpoints")))
    evaluator = evaluate.Evaluator(cfg, device="cuda")
    golden_u8 = crops["eval"][np.arange(len(labels)) % len(crops["eval"])]
    # float32 minus the means: what normalize_images makes of the uint8
    golden = golden_u8.astype(np.float32) - np.array(
        [pp.R_MEAN, pp.G_MEAN, pp.B_MEAN], np.float32)
    gap = max(r["rms"] for k, r in decode.items() if k.startswith("eval/"))
    rng = np.random.default_rng(7)
    half = gap * 3 ** 0.5           # uniform on [-half, half]: rms = gap
    controls = {
        "white": golden + rng.uniform(-half, half, golden.shape
                                      ).astype(np.float32),
        "shift": golden + (gap * rng.choice([-1.0, 1.0], (len(labels), 1, 1,
                                                          3))
                           ).astype(np.float32)}
    torch.backends.cudnn.allow_tf32 = False
    try:
        from_records = evaluator.logits(restored)
        ref = evaluator.logits(restored,
                               iter(golden_batches(golden, labels, 16)))
        moved = {k: evaluator.logits(restored,
                                     iter(golden_batches(v, labels, 16)))
                 for k, v in controls.items()}
    finally:
        torch.backends.cudnn.allow_tf32 = True
    if not np.array_equal(from_records["label"], ref["label"]):
        raise AssertionError("eval records and injected labels differ")
    scale = np.abs(ref["logits"]).max()

    def rel(h):
        return float(np.abs(h["logits"] - ref["logits"]).max() / scale)

    res = {"logits_rel": rel(from_records),
           "control_rel": {k: rel(v) for k, v in moved.items()},
           "gap_rms_levels": gap,
           "metrics_records": evaluate.compute_metrics(cfg, from_records),
           "metrics_golden": evaluate.compute_metrics(cfg, ref)}
    res["bound"] = RECORD_LOGITS_CONTROL_FACTOR * max(
        res["control_rel"].values())
    log(f"eval logits, records decoded on the card vs the golden crops "
        f"injected (48 images, TF32 off): relative difference "
        f"{res['logits_rel']:.3e}; controls at the gap's rms {gap:.4f}: white "
        f"{res['control_rel']['white']:.3e}, shift "
        f"{res['control_rel']['shift']:.3e}; bound "
        f"{RECORD_LOGITS_CONTROL_FACTOR:g} x the larger = "
        f"{res['bound']:.3e}; mAP {res['metrics_records']['mAP']:.6f} vs "
        f"{res['metrics_golden']['mAP']:.6f}")
    if not res["logits_rel"] <= res["bound"]:
        raise AssertionError(f"logits from records differ from the golden "
                             f"crops' by {res['logits_rel']:.3e} > "
                             f"{res['bound']:.3e}")
    return res, evaluator, golden_batches(golden_u8, labels, 16)


def train_pipeline_rate(pattern, num_workers=0):
    """Images/s of the train pipeline alone at batch 8: read, parse and
    geometry (in ``num_workers`` threads, or inline), decode and crop on
    the card, and the copy of the labels to the card."""
    spec = train.get_dataset("mpii")
    dev = torch.device("cuda")
    it = grain_pipeline.make_train_iterator(
        pattern, spec, batch_size=8, image_size=224, resize_min=256,
        resize_max=512, seed=0, transfer_uint8=True, num_workers=num_workers,
        device=dev)
    try:
        for _ in range(2):
            pipeline.to_device(next(it), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            pipeline.to_device(next(it), dev)
        torch.cuda.synchronize()
        return 160 / (time.perf_counter() - t0)
    finally:
        it.close()


def eval_pipeline_rate(pattern):
    """Images/s of the eval pipeline alone (batch 16, 5 passes over the
    48 eval records)."""
    dev = torch.device("cuda")
    ds = grain_pipeline.make_eval_dataset(
        pattern, train.get_dataset("mpii"), batch_size=16, image_size=224,
        resize_min=256, transfer_uint8=True, device=dev)
    for b in ds:
        pipeline.to_device(b, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        for b in ds:
            pipeline.to_device(b, dev)
    torch.cuda.synchronize()
    return 5 * N_EVAL_RECORDS / (time.perf_counter() - t0)


def pipeline_rates(paths, mpii_paths):
    """The pipeline alone over the records of every fixture and over those
    of the two 1280x720 (MPII's size) fixtures alone, which cost the most
    to decode; at 1280x720 with 0 and 2 reader threads."""
    return {"pipeline_train_images_per_s": train_pipeline_rate(paths["train"]),
            "pipeline_eval_images_per_s": eval_pipeline_rate(paths["val"]),
            "pipeline_train_images_per_s_mpii":
                train_pipeline_rate(mpii_paths["train"]),
            "pipeline_train_images_per_s_mpii_2_workers":
                train_pipeline_rate(mpii_paths["train"], num_workers=2),
            "pipeline_eval_images_per_s_mpii":
                eval_pipeline_rate(mpii_paths["val"])}


def step_rates(paths):
    """Median train step of mpii_rank1_224 (TF32 on) fed from records
    (through the prefetch, the pull included) against a resident batch, in
    turns; and the state and step for the profile."""
    cfg = config_lib.get_config("mpii_rank1_224", train_pattern=paths["train"])
    state, spec = train.create_state(cfg, device="cuda")
    step = train.make_train_step(spec, cfg)
    source = grain_pipeline.make_train_iterator(
        paths["train"], spec, batch_size=8, image_size=224, resize_min=256,
        resize_max=512, seed=0, transfer_uint8=True, device="cuda")
    batches = pipeline.StatefulPrefetchIterator(source, device="cuda")
    resident = next(batches)
    for _ in range(3):
        step(state, next(batches))
        step(state, resident)
    times = {"records": [], "resident": []}
    for order in (("resident", "records"), ("records", "resident")) * 2:
        for kind in order:
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, next(batches) if kind == "records" else resident)
                torch.cuda.synchronize()
                times[kind].append(time.perf_counter() - t0)
    return ({f"step_ms_{k}": float(np.median(v)) * 1e3
             for k, v in times.items()}, state, step, batches, source)


def eval_rates(evaluator, injected, pattern):
    """Images/s of the eval loop (batches of 16) over the 48 eval records
    of ``pattern`` from the pipeline against the golden crops injected as
    arrays, 5 passes a timing, 4 timings each in turns."""
    cfg = dataclasses.replace(evaluator.cfg, eval_pattern=pattern)
    spec = train.get_dataset("mpii")
    rates = {"records": [], "injected": []}

    def one(kind):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            src = (evaluate.make_eval_input(cfg, spec, device="cuda")
                   if kind == "records" else iter(injected))
            evaluate.eval_logits(evaluator.step_fn, src, device="cuda")
        rates[kind].append(5 * N_EVAL_RECORDS / (time.perf_counter() - t0))

    one("records")
    one("injected")
    rates = {"records": [], "injected": []}
    for order in (("records", "injected"), ("injected", "records")) * 2:
        for kind in order:
            one(kind)
    return {f"eval_images_per_s_{k}": float(np.median(v))
            for k, v in rates.items()}


def profile_records(datas, state, step, batches):
    """Device time of the decode alone (the fixtures, 4 passes) and the
    device's busy share over 5 train steps fed from records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_ms(prof):
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("Optimizer.")) / 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            jpeg.decode(datas, "cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dec = device_ms(prof)
    n = 4 * len(datas)
    log(f"profile: decode of the {len(datas)} fixtures x 4 (nvJPEG and the "
        f"colour kernel): {wall:.3f} ms wall, {dec:.3f} ms device time "
        f"({dec / n:.3f} ms an image, device busy {dec / wall:.1%})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step(state, next(batches))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = device_ms(prof)
    if busy == 0 or dec == 0:
        raise AssertionError("the profiler saw no device time")
    log(f"profile: 5 train steps fed from records, {wall:.3f} ms wall, "
        f"{busy:.3f} ms device time (device busy {busy / wall:.1%})")
    return {"decode_device_ms_per_image": dec / n,
            "records_step_device_busy": busy / wall}


def phase_records(card, timer, profile=False):
    """mpii_rank1_224 trained and evaluated from records, decoded on the
    card; see the module docstring, phase 6."""
    t_phase = time.monotonic()
    out = {"config": "mpii_rank1_224", "card": card}
    names, datas, crops, transforms = load_fixtures()
    out["ycc_kernel"] = check_colour_kernel(timer, names, datas)
    out["decode"] = check_decode(names, datas, crops, transforms)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_records_") as d:
        paths = write_records(d, datas)
        # MPII's own size: the records of the two 1280x720 fixtures alone
        mpii_paths = write_records(
            d, [x for n, x in zip(names, datas) if n.startswith("mpii_")],
            prefix="mpii_")
        run_dir = os.path.join(d, "run")
        out["clis"] = run_clis(paths, run_dir)
        out["resume"] = {echo: check_resume(paths, d, echo)
                         for echo in (1, 2)}
        logits, evaluator, injected = check_record_logits(
            paths, run_dir, crops, out["decode"])
        out["record_logits"] = logits
        out.update(pipeline_rates(paths, mpii_paths))
        out.update(eval_rates(evaluator, injected, mpii_paths["val"]))
        del evaluator
        rates, state, step, batches, source = step_rates(mpii_paths)
        out.update(rates)
        if profile:
            out.update(profile_records(datas, state, step, batches))
        source.close()
        del state, batches
    log(f"phase 6 rates on {card}: pipeline alone, records of all 7 "
        f"fixtures: {out['pipeline_train_images_per_s']:.1f} images/s "
        f"(train, batch 8) and {out['pipeline_eval_images_per_s']:.1f} "
        f"(eval, batch 16); records of the two 1280x720 fixtures: "
        f"{out['pipeline_train_images_per_s_mpii']:.1f} (train), "
        f"{out['pipeline_train_images_per_s_mpii_2_workers']:.1f} (train, 2 "
        f"reader threads), {out['pipeline_eval_images_per_s_mpii']:.1f} "
        f"(eval).  From the 1280x720 records: "
        f"train step {out['step_ms_records']:.3f} ms from records vs "
        f"{out['step_ms_resident']:.3f} ms on a resident batch (median, "
        f"TF32 on); eval loop {out['eval_images_per_s_records']:.1f} "
        f"images/s from records vs {out['eval_images_per_s_injected']:.1f} "
        f"injected (batches of 16, TF32 on)")
    out["phase_s"] = time.monotonic() - t_phase
    log(f"phase 6 took {out['phase_s']:.1f} s (workdir removed)")
    return out


# -- phase 7 -----------------------------------------------------------------

# The small fixtures, HMDB51's frame size class (320x240): the frames of a
# video record are one of them, frame k under EXIF orientation 1 + k % 4
# (those that keep the size), so that each frame of a video decodes to
# other pixels and the frame picks and their order show in the batches.
FRAME_FIXTURES = ("odd_517x333.jpg", "gray_400x300.jpg", "yuv422_480x360.jpg")
N_VIDEOS, N_EVAL_VIDEOS, FRAMES_PER_VIDEO = 80, 8, 8
CONFIG_EVAL_KEYS = {
    "hmdb51_rgb": {"num_examples", "accuracy", "per_frame_accuracy",
                   "num_videos", "step"}}


def with_orientation(data, orientation):
    """``data`` with an EXIF APP1 segment right after SOI whose IFD0 holds
    the orientation tag alone (little-endian)."""
    entry = ((0x0112).to_bytes(2, "little") + (3).to_bytes(2, "little")
             + (1).to_bytes(4, "little") + orientation.to_bytes(2, "little")
             + b"\0\0")
    tiff = (b"II" + (42).to_bytes(2, "little") + (8).to_bytes(4, "little")
            + (1).to_bytes(2, "little") + entry + bytes(4))
    payload = b"Exif\0\0" + tiff
    return (data[:2] + b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big")
            + payload + data[2:])


def fixture_encoder(datas, per=1):
    """An ``encode_jpeg`` for ``records.write_synthetic_dataset`` that
    hands out the JPEG fixtures in turn, ``per`` records each, whatever
    image it is given: the card's machine has no JPEG encoder.  With
    ``per`` > 1 (the frames of a video) record k of a run is under EXIF
    orientation 1 + k % 4.  The records' labels, keypoints and video ids
    are the writer's."""
    count = itertools.count()

    def encode(image):
        i = next(count)
        data = datas[i // per % len(datas)]
        return data if per == 1 else with_orientation(data, 1 + i % per % 4)
    return encode


def config_records(workdir, name, datas, n_train, n_eval, image_size,
                   per=1):
    """Seeded train and eval records of ``name``'s dataset schema from
    ``records.write_synthetic_dataset``, the JPEGs from ``datas``,
    indexed; video records hold FRAMES_PER_VIDEO frames a video."""
    spec = train.get_dataset(config_lib.get_config(name).dataset)
    paths = {}
    for split, n, seed in (("train", n_train, 11), ("val", n_eval, 12)):
        paths[split] = os.path.join(workdir, f"{name}_{split}.tfrecord")
        records.write_synthetic_dataset(
            paths[split], spec, n, image_size=image_size, seed=seed,
            frames_per_video=FRAMES_PER_VIDEO,
            encode_jpeg=fixture_encoder(datas, per))
        if native_io.build_index(paths[split]) != n:
            raise AssertionError(f"{paths[split]} does not hold {n} records")
    return paths


def check_bn_bf16():
    """Torch's batch norm on a bfloat16 CUDA tensor with float32 scale,
    offset and statistics (``models/resnet.BatchNorm``), train and eval
    mode, against Flax's float32 formula rounded once to bfloat16: the
    share of outputs that differ, and the same share for the formula
    computed in bfloat16 (what a kernel that did not upcast would give)."""
    from attentionalpoolingaction_torch.models.resnet import BatchNorm
    g = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for mode in ("train", "eval"):
        bn = BatchNorm(256, eps=1e-5, momentum=0.003).cuda().train(
            mode == "train")
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.normal_(generator=g)
            bn.running_mean.normal_(generator=g)
            bn.running_var.uniform_(0.5, 1.5, generator=g)
        x = (torch.randn(32, 256, 56, 56, device="cuda", generator=g) * 3
             + 1).to(torch.bfloat16).contiguous(
                 memory_format=torch.channels_last)
        mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
        y = bn(x)
        xf = x.float()
        if mode == "train":
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp(min=0)
            moved = float((bn.running_mean - mean0.lerp(mean, 0.003)
                           ).abs().max())
        else:
            mean, var, moved = mean0, var0, None
        mul = torch.rsqrt(var + 1e-5) * bn.weight

        def per_channel(t):
            return t[None, :, None, None]

        want = ((xf - per_channel(mean)) * per_channel(mul)
                + per_channel(bn.bias)).to(torch.bfloat16)
        low = ((x - per_channel(mean).bfloat16()) * per_channel(mul).bfloat16()
               + per_channel(bn.bias).bfloat16())
        out[mode] = {"dtype": str(y.dtype).removeprefix("torch."),
                     "differ": float((y != want).float().mean()),
                     "bf16_math_differs": float((low != want).float().mean()),
                     "running_mean_vs_f32": moved}
        # float32 statistics summed in another order move a few outputs
        # across a bfloat16 rounding boundary (~1e-3 of them on the CPU);
        # bfloat16 arithmetic would move ~half of them
        if y.dtype != torch.bfloat16 or out[mode]["differ"] > 1e-2 or (
                moved is not None and moved > 1e-6):
            raise AssertionError(f"batch norm on bfloat16, {mode}: {out}")
    log(f"batch norm, bfloat16 input and float32 parameters on the card "
        f"(32x256x56x56): share of outputs off Flax's float32 formula "
        f"rounded once: train {out['train']['differ']:.2e}, eval "
        f"{out['eval']['differ']:.2e} (the formula in bfloat16 would be off "
        f"on {out['train']['bf16_math_differs']:.1%}); running mean vs "
        f"float32 {out['train']['running_mean_vs_f32']:.1e}")
    return out


def check_bf16_gap(cfg, variables, batch):
    """The bfloat16 step against the float32 one on the card, the same
    weights and batch, TF32 off (``precision.bf16_gap``), within the
    BF16_GAP limits and above the BF16_GAP_MIN ones."""
    torch.backends.cudnn.allow_tf32 = False
    try:
        gap = precision.bf16_gap(cfg, variables, batch, "cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    for k, tol in BF16_GAP.items():
        if gap.get(k) is not None and not gap[k] < tol:
            raise AssertionError(f"{cfg.dataset} bf16 vs f32 gap: {k} "
                                 f"{gap[k]:.3e} >= {tol}")
    for k, least in BF16_GAP_MIN.items():
        if not gap[k] > least:
            raise AssertionError(f"{cfg.dataset} bf16 vs f32 gap: {k} "
                                 f"{gap[k]:.3e} <= {least}: is the backbone "
                                 f"in bfloat16?")
    log(f"bf16 vs f32 on the card, batch {cfg.batch_size}, TF32 off: "
        + ", ".join(f"{k} {v:.3e}" for k, v in gap.items()
                    if isinstance(v, float)))
    return gap


def check_bf16_cpu(cfg, variables, rng, batch_size=2):
    """One bfloat16 step at a cut batch on the card and on the CPU, the
    same weights and batch (TF32 off): each loss and ``grad_norm`` within
    BF16_CPU_RTOL."""
    cfg = dataclasses.replace(cfg, batch_size=batch_size)
    spec = train.get_dataset(cfg.dataset)
    batch = precision.synthetic_batch(rng, cfg, spec)
    metrics = {}
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            t0 = time.monotonic()
            state, _ = train.create_state(cfg, device=dev,
                                          variables=variables)
            _, m = train.make_train_step(spec, cfg)(
                state, train.batch_to_device(batch, dev))
            metrics[dev] = {k: float(v) for k, v in m.items()}
            metrics[f"{dev}_s"] = time.monotonic() - t0
            del state
    finally:
        torch.backends.cudnn.allow_tf32 = True
    errs = {}
    for k, want in metrics["cpu"].items():
        errs[k] = abs(metrics["cuda"][k] - want) / abs(want)
        if not (np.isfinite(metrics["cuda"][k])
                and errs[k] < BF16_CPU_RTOL):
            raise AssertionError(f"{cfg.dataset} bf16 step at batch "
                                 f"{batch_size}, card vs CPU: {k} "
                                 f"{metrics['cuda'][k]} vs {want}")
    log(f"bf16 step, batch {batch_size}, card vs CPU (TF32 off; the CPU "
        f"step {metrics['cpu_s']:.1f} s): " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items()))
    return errs


def step_times_in_turns(cfg, variables, batch, rounds=6):
    """Median wall time of the bfloat16 and the float32 train step (TF32
    on), the same weights and resident batch, in turns."""
    spec = train.get_dataset(cfg.dataset)
    steps, times = {}, {"bf16": [], "f32": []}
    dev_batch = train.batch_to_device(batch, "cuda")
    for kind in times:
        c = dataclasses.replace(cfg, bf16_backbone=kind == "bf16")
        state, _ = train.create_state(c, device="cuda", variables=variables)
        step = train.make_train_step(spec, c)
        steps[kind] = (state, step)
        for _ in range(2):
            step(state, dev_batch)
    for r in range(rounds):
        for kind in (("bf16", "f32") if r % 2 else ("f32", "bf16")):
            state, step = steps[kind]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, dev_batch)
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
    out = {f"step_ms_{k}": float(np.median(v)) * 1e3 for k, v in times.items()}
    out["images_per_s_bf16"] = cfg.batch_size / out["step_ms_bf16"] * 1e3
    log(f"{cfg.dataset} train step, batch {cfg.batch_size}, "
        f"{cfg.image_size} px, TF32 on: bf16 {out['step_ms_bf16']:.3f} ms, "
        f"f32 {out['step_ms_f32']:.3f} ms (medians of {rounds}, in turns); "
        f"{out['images_per_s_bf16']:.1f} images/s in bf16")
    return out


def host_batches(batches):
    """Eval batches with their images brought to the host."""
    return [{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
             for k, v in b.items()} for b in batches]


def eval_card_vs_cpu(what, cfg, restored, batches, cpu_batches=1):
    """The eval logits of ``batches`` (decoded on the card) on the card,
    counted and timed (after a warm-up pass), and of the first
    ``cpu_batches`` of them on the CPU (TF32 off), and the control: the
    card's logits of the same batches with the backbone in float32.  The
    card's relative L2 difference from the CPU's must be under the
    control's by BF16_EVAL_CONTROL_RATIO.  Also the card's eval rows a
    second."""
    torch.backends.cudnn.allow_tf32 = False
    try:
        evaluator = evaluate.Evaluator(cfg, device="cuda")
        evaluator.logits(restored, iter(batches))
        t0 = time.perf_counter()
        card, launches = counted(
            lambda: evaluator.logits(restored, iter(batches)))
        rate = sum(int(b["mask"].sum()) for b in batches) / (
            time.perf_counter() - t0)
        cpu = evaluate.Evaluator(cfg, device="cpu").logits(
            restored, iter(host_batches(batches[:cpu_batches])))
        f32 = evaluate.Evaluator(
            dataclasses.replace(cfg, bf16_backbone=False), device="cuda"
        ).logits(restored, iter(batches[:cpu_batches]))
    finally:
        torch.backends.cudnn.allow_tf32 = True
    expect_launches(f"{what} eval: {len(batches)} batches", launches,
                    len(batches))
    n = len(cpu["logits"])

    def off(logits):
        return float(np.linalg.norm(logits[:n] - cpu["logits"])
                     / np.linalg.norm(cpu["logits"]))

    err, control = off(card["logits"]), off(f32["logits"])
    if not err * BF16_EVAL_CONTROL_RATIO < control:
        raise AssertionError(
            f"{what} eval logits vs the CPU's in bfloat16: the card's "
            f"{err:.3e}, the card's with a float32 backbone {control:.3e}, "
            f"not {BF16_EVAL_CONTROL_RATIO}x apart")
    log(f"{what} eval of {len(batches)} batches of injected crops on the "
        f"card (TF32 off): {rate:.1f} rows/s; logits vs the CPU's "
        f"{err:.3e} in L2 (the card with a float32 backbone {control:.3e})")
    return card, cpu, err, control, launches, rate


def serve_buckets(cfg, what, reps=5):
    """``load_predictor`` of the latest step of ``cfg.workdir``, warmed up
    with uint8 at buckets 1/8/32; each bucket's call counted (one launch
    of each pooling kernel) and timed."""
    pred = serving.load_predictor(cfg, buckets=(1, 8, 32), device="cuda")
    pred.warmup()
    rng = np.random.default_rng(9)
    size, out, total = cfg.image_size, {}, collections.Counter()
    for b in (1, 8, 32):
        images = rng.integers(0, 256, (b, size, size, 3), np.uint8)
        probs, launches = counted(lambda: pred.predict_arrays(images))
        expect_launches(f"{what} serving at bucket {b}", launches, 1, ycc=0)
        total.update(launches)
        if probs.shape != (b, pred.spec.num_classes) or not (
                np.isfinite(probs).all() and (probs >= 0).all()
                and (probs <= 1).all()):
            raise AssertionError(f"{what} serving at {b}: {probs.shape}")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            pred.predict_arrays(images)
            times.append(time.perf_counter() - t0)
        out[b] = float(np.median(times)) * 1e3
    log(f"{what} serving from step {pred.step} (bf16, uint8): median ms a "
        f"call at buckets 1/8/32: "
        + " / ".join(f"{v:.3f}" for v in out.values()))
    return out, dict(total)


def seeded_init(name, workdir, seed):
    """A port checkpoint of ``name``'s model with ``precision``'s seeded
    Flax-layout weights, to warm-start a run from (its heads fresh, as a
    fine-tune from ImageNet weights starts); its directory."""
    cfg = config_lib.get_config(name)
    path = os.path.join(workdir, f"{name}_init")
    state, _ = train.create_state(
        cfg, device="cuda", variables=precision.seeded_variables(cfg, seed))
    mgr = checkpoint.make_manager(path)
    checkpoint.save(mgr, state)
    mgr.wait_until_finished()       # other processes read it
    return path


def train_from_records(name, paths, run_dir, steps, **overrides):
    """``train.train`` of preset ``name`` for ``steps`` steps from its
    records, with a checkpoint at the end; counted: one launch of each
    pooling kernel a step."""
    cfg = config_lib.get_config(
        name, train_pattern=paths["train"], eval_pattern=paths["val"],
        workdir=run_dir, log_every=1, checkpoint_every=steps, **overrides)
    mgr = checkpoint.make_manager(os.path.join(run_dir, "checkpoints"))
    t0 = time.perf_counter()
    (state, hist), launches = counted(lambda: train.train(
        cfg, num_steps=steps, device="cuda", checkpoint_manager=mgr))
    wall = time.perf_counter() - t0
    expect_launches(f"{name} train.train, {steps} steps", launches, steps,
                    backward=steps)
    losses = [h["loss/total"] for h in hist]
    if state.step != steps or len(losses) != steps or \
            not np.isfinite(losses).all():
        raise AssertionError(f"{name} from records: {hist}")
    log(f"{name} train.train from records: {steps} steps in {wall:.1f} s "
        f"(state and a save included), losses "
        + ", ".join(f"{v:.4f}" for v in losses) + f"; launches {launches}")
    return cfg, state, mgr, {"losses": losses, "launches": launches,
                             "history": hist}


def phase_hico(card, datas, workdir):
    """hico_multilabel (BASELINE config #2) at full width: the bf16 gap,
    card vs CPU, bf16 vs f32 step times, train.train from records, 3-crop
    multicrop eval with mAP_ko card vs CPU, serving from the checkpoint."""
    name = "hico_multilabel"
    cfg = config_lib.get_config(name)
    spec = train.get_dataset(cfg.dataset)
    out = {"config": name, "card": card}
    variables = precision.seeded_variables(cfg, 0)
    rng = np.random.default_rng(21)
    batch = precision.synthetic_batch(rng, cfg, spec)
    out["gap"] = check_bf16_gap(cfg, variables, batch)
    out["cpu"] = check_bf16_cpu(cfg, variables, rng)
    out.update(step_times_in_turns(cfg, variables, batch))
    del batch
    paths = config_records(workdir, name, datas, 4 * cfg.batch_size, 16,
                           cfg.image_size)
    run_dir = os.path.join(workdir, name)
    init = seeded_init(name, workdir, 0)
    run_cfg, state, mgr, out["train"] = train_from_records(
        name, paths, run_dir, 4, init_checkpoint=init)
    del state
    eval_cfg = dataclasses.replace(run_cfg, eval_multicrop=3,
                                   eval_batch_size=8)
    # the seeded weights, not the trained step: 4 steps at the preset's
    # learning rate from random weights blow the losses up
    restored = checkpoint.restore_for_eval(checkpoint.make_manager(init))
    batches = list(evaluate.make_eval_input(eval_cfg, spec, device="cuda"))
    card_l, cpu_l, err, control, out["eval_launches"], \
        out["eval_rows_per_s"] = eval_card_vs_cpu(name, eval_cfg, restored,
                                                  batches)
    card_m = evaluate.compute_metrics(eval_cfg, card_l)
    if not {"mAP", "mAP_ko"} <= set(card_m) or not all(
            np.isfinite(card_m[k]) for k in ("mAP", "mAP_ko")):
        raise AssertionError(f"{name} multicrop eval: {card_m}")
    # The metrics are not compared card vs CPU: with seeded random weights
    # a class's scores over the images differ by less than the two
    # devices' bfloat16 rounding, so almost every class (599-600 of 600 on
    # an H100) ranks its images otherwise on the two, and AP follows
    # the ranking alone.  The logits' L2 above binds; compute_metrics is
    # held to the JAX package's on the CPU
    # (tests/test_torch_metrics.py, test_torch_evaluate.py).
    n = len(cpu_l["logits"])
    cut = evaluate.compute_metrics(
        eval_cfg, {k: v[:n] for k, v in card_l.items()})
    cpu_m = evaluate.compute_metrics(eval_cfg, cpu_l)
    out["eval"] = {"metrics": card_m, "logits_l2_vs_cpu": err,
                   "logits_l2_f32_control": control,
                   "card_metrics_first_batch": cut,
                   "cpu_metrics_first_batch": cpu_m}
    log(f"{name} 3-crop multicrop eval of 16 records on the card: "
        f"{card_m}; first batch: mAP {cut['mAP']:.4f} (card) vs "
        f"{cpu_m['mAP']:.4f} (CPU), mAP_ko {cut['mAP_ko']:.4f} vs "
        f"{cpu_m['mAP_ko']:.4f}")
    out["serve_ms"], out["serve_launches"] = serve_buckets(run_cfg, name)
    return out


def phase_pose(card, datas, workdir):
    """mpii_pose_attention (BASELINE config #3) at full width: train.train
    from records with keypoints, and the pose loss card vs CPU."""
    name = "mpii_pose_attention"
    cfg = config_lib.get_config(name)
    out = {"config": name, "card": card}
    variables = precision.seeded_variables(cfg, 1)
    out["cpu"] = check_bf16_cpu(cfg, variables, np.random.default_rng(22))
    if "loss/pose" not in out["cpu"]:
        raise AssertionError(f"{name}: no pose loss in {out['cpu']}")
    paths = config_records(workdir, name, datas, 3 * cfg.batch_size, 8,
                           cfg.image_size)
    _, state, _, out["train"] = train_from_records(
        name, paths, os.path.join(workdir, name), 3,
        init_checkpoint=seeded_init(name, workdir, 1))
    if not all("loss/pose" in h for h in out["train"]["history"]):
        raise AssertionError(f"{name}: no pose loss while training")
    del state
    return out


def phase_hmdb(card, datas, workdir):
    """hmdb51_rgb (BASELINE config #4) and hmdb51_clip8 at full width from
    video records: train_cli across an epoch boundary, a mid-epoch resume
    bit for bit, eval_cli's per-video accuracy; clips: train.train and
    clip eval (2 clips x 3 crops) card vs CPU."""
    out = {"card": card}
    frames = [d for n, d in zip(*datas) if n in FRAME_FIXTURES]
    paths = config_records(workdir, "hmdb51_rgb", frames,
                           N_VIDEOS * FRAMES_PER_VIDEO,
                           N_EVAL_VIDEOS * FRAMES_PER_VIDEO, 64,
                           per=FRAMES_PER_VIDEO)
    # -- hmdb51_rgb: 3 steps of 64 videos, 80 a epoch -----------------------
    name = "hmdb51_rgb"
    run_dir = os.path.join(workdir, name)
    init = seeded_init(name, workdir, 2)
    t0 = time.perf_counter()
    state, launches = counted(lambda: train_cli.main([
        "--config", name, "--train_pattern", paths["train"],
        "--workdir", run_dir, "--num_steps", "3", "--set",
        "checkpoint_every=3", "--set", "log_every=1", "--set",
        f"init_checkpoint={init!r}"]))
    wall = time.perf_counter() - t0
    expect_launches(f"{name} train_cli: 3 steps", launches, 3, backward=3)
    stream = json.loads((pathlib.Path(run_dir) / "checkpoints"
                         / "grain_iter_3_p0.json").read_text())
    if state.step != 3 or stream != {"epoch": 2, "position": 32}:
        raise AssertionError(f"{name} train_cli: step {state.step}, stream "
                             f"{stream}")
    del state
    out[name] = {"train_launches": launches, "train_cli_s": wall,
                 "stream": stream}
    log(f"{name} train_cli: 3 steps of 64 frames from {N_VIDEOS} videos "
        f"(one frame each an epoch) in {wall:.1f} s; stream at {stream}; "
        f"launches {launches}")
    out[name]["resume"] = check_resume(paths, workdir, 1, preset=name,
                                       stop=1, steps=3, init_checkpoint=init)
    t0 = time.perf_counter()
    printed, launches = counted(lambda: eval_cli.main([
        "--config", name, "--workdir", run_dir, "--eval_pattern",
        paths["val"], "--notb"]))
    eval_s = time.perf_counter() - t0
    line = printed[-1]
    n_eval = N_EVAL_VIDEOS * FRAMES_PER_VIDEO
    expect_launches(f"{name} eval_cli", launches, n_eval // 8)
    if set(line) != CONFIG_EVAL_KEYS[name] or \
            line["num_videos"] != N_EVAL_VIDEOS or \
            line["num_examples"] != n_eval:
        raise AssertionError(f"{name} eval_cli printed {line}")
    out[name].update(eval_cli=line, eval_launches=launches,
                     eval_cli_s=eval_s)
    log(f"{name} eval_cli: {line} in {eval_s:.2f} s (model built, the "
        f"step restored, {n_eval} frames decoded and evaluated); launches "
        f"{launches}")

    # -- hmdb51_clip8: clips of 8 frames -------------------------------------
    name = "hmdb51_clip8"
    init = seeded_init(name, workdir, 3)
    run_cfg, state, mgr, out[name] = train_from_records(
        name, paths, os.path.join(workdir, name), 3, init_checkpoint=init)
    del state
    eval_cfg = dataclasses.replace(run_cfg, eval_clips=2, eval_multicrop=3)
    restored = checkpoint.restore_for_eval(checkpoint.make_manager(init))
    batches = list(evaluate.make_eval_input(
        eval_cfg, train.get_dataset("hmdb51"), device="cuda"))
    if batches[0]["image"].shape != (8, 8, 224, 224, 3):
        raise AssertionError(f"clip batch {batches[0]['image'].shape}")
    card_l, cpu_l, err, control, launches, rate = eval_card_vs_cpu(
        name, eval_cfg, restored, batches)
    metrics = evaluate.compute_metrics(eval_cfg, card_l)
    if metrics["num_videos"] != N_EVAL_VIDEOS or \
            metrics["num_examples"] != N_EVAL_VIDEOS * 6 or \
            "per_clip_accuracy" not in metrics:
        raise AssertionError(f"{name} clip eval: {metrics}")
    out[name].update(eval_launches=launches, eval=metrics,
                     eval_logits_l2_vs_cpu=err,
                     eval_logits_l2_f32_control=control,
                     eval_rows_per_s=rate)
    log(f"{name} clip eval (2 clips x 3 crops a video, {len(batches)} "
        f"batches of 8 clips): {metrics}; first batch card vs CPU: logits "
        f"{err:.3e} in L2; launches {launches}")
    return out


def phase_configs(card):
    """BASELINE configs #2-#4 at full width with the bfloat16 backbone;
    see the module docstring, phase 7."""
    t_phase = time.monotonic()
    out = {"bn": check_bn_bf16()}
    names, datas, _, _ = load_fixtures()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_configs_") as d:
        out["hico_multilabel"] = phase_hico(card, datas, d)
        out["mpii_pose_attention"] = phase_pose(card, datas, d)
        out.update(phase_hmdb(card, (names, datas), d))
    out["phase_s"] = time.monotonic() - t_phase
    log(f"phase 7 took {out['phase_s']:.1f} s (workdir removed)")
    return out


# -- phase 8 -----------------------------------------------------------------

DECODE_THREADS = 4
HTTP_CLIENTS = 12
HTTP_CONNECTIONS = 200
PNG_FIXTURE = "odd_517x333.png"
MPII_FIXTURES = ("mpii_a_1280x720.jpg", "mpii_b_1280x720.jpg")
# The folded float forward against the model's, TF32 off: float32 summed in
# another order, the CPU tests' bound (tests/test_torch_inference.py).
FOLD_RTOL = 1e-4
# int8 against the folded float forward: the JAX package's own cosines.
INT8_COSINE = {"features": 0.98, "logits": 0.9}
# int8 on the card against int8 on the CPU from the same weights (folded on
# the host, so the same quantized weights), relative L2: the CPU tests'
# bound of the port's int8 forward against JAX's with their own folds (the
# ulp-level gaps of two float32 paths move activations across the
# quantizer's rounding boundaries; measured 0.4-2.4% and 0.5-1.6%).  The
# int32 accumulators and the quantizer's arithmetic are exact or IEEE on
# both devices, so the features are expected to agree bit for bit; the
# line prints whether they do.
INT8_CPU_L2 = {"features": 0.05, "logits": 0.04}
# HTTP's top-k against predict_cli's: two TF32 forwards at other batch
# sizes (cuDNN picks other algorithms), probabilities of a class in both
# within 2% of each other.
CLI_PROB_RTOL = 2e-2


def http_call(conn, method, path, body=None, headers=None):
    """(status, headers, body) of one request on ``conn``."""
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, dict(resp.getheaders()), resp.read()


def http_conn(port):
    return http.client.HTTPConnection("127.0.0.1", port, timeout=120)


def b64(data):
    return base64.b64encode(data).decode()


class HttpServer:
    """``serve_cli.make_server`` on 127.0.0.1 and a free port, served from
    a thread; stopped (batcher and decode pool too) on exit."""

    def __init__(self, pred, **kw):
        kw = {"topk": 5, "max_batch": 32, "max_wait_ms": 5.0,
              "decode_threads": DECODE_THREADS, **kw}
        self.server = serve_cli.make_server(pred, "127.0.0.1", 0, **kw)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        serve_cli.stop_server(self.server)
        self.thread.join(timeout=10)


class GatedPredictor:
    """A predictor whose dispatches wait for ``gate``: holds the batcher's
    worker so that the queue fills (a real overload, made deterministic)."""

    def __init__(self, pred):
        self._pred = pred
        self.gate = threading.Event()

    def __getattr__(self, name):
        return getattr(self._pred, name)

    def predict_preprocessed(self, images, topk=5):
        self.gate.wait(timeout=60)
        return self._pred.predict_preprocessed(images, topk)


def dispatches(pred):
    return pred.stats.snapshot().get("serving_device_dispatches_total", 0)


def softmax(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def decode_gap(got, want):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return {"mean": float(d.mean()), "max": int(d.max()),
            "far_share": float((d > DECODE_FAR_LEVELS).mean())}


def check_decode_gap(what, gap):
    if not (gap["mean"] <= DECODE_MEAN_LEVELS
            and gap["far_share"] <= DECODE_FAR_SHARE):
        raise AssertionError(f"{what} off by {gap} (gate mean <= "
                             f"{DECODE_MEAN_LEVELS}, > {DECODE_FAR_LEVELS} "
                             f"on <= {DECODE_FAR_SHARE:.0%})")


def http_traffic(port, names, datas, png_data):
    """The main path's requests: /healthz, /metrics, /predict of each JPEG
    fixture and the PNG, /predict_batch with a corrupt item, /predict_video
    with 8 frames and as a video/mp4 upload, and 12 concurrent keep-alive
    clients; each answer checked."""
    conn = http_conn(port)
    st, _, body = http_call(conn, "GET", "/healthz")
    health = json.loads(body)
    if st != 200 or health["status"] != "ok" or health["int8"]:
        raise AssertionError(f"/healthz: {st} {health}")
    out = {"predict": {}}
    for name, data in list(zip(names, datas)) + [(PNG_FIXTURE, png_data)]:
        st, _, body = http_call(conn, "POST", "/predict", data)
        res = json.loads(body)
        if st != 200 or len(res["topk"]) != 5:
            raise AssertionError(f"/predict {name}: {st} {res}")
        out["predict"][name] = res["topk"]
    st, _, body = http_call(conn, "POST", "/predict_batch", json.dumps(
        {"images": [b64(datas[0]), b64(b"\xff\xd8corrupt"), b64(png_data)]}))
    res = json.loads(body)["results"]
    if st != 200 or len(res) != 3 or \
            not res[1].get("error", "").startswith("bad image: ") or \
            "topk" not in res[0] or "topk" not in res[2]:
        raise AssertionError(f"/predict_batch: {st} {res}")
    frames = [datas[i % len(datas)] for i in range(8)]
    st, _, body = http_call(conn, "POST", "/predict_video", json.dumps(
        {"frames": [b64(f) for f in frames]}))
    res = json.loads(body)
    if st != 200 or res.get("clip_frames") != 8 or \
            res.get("frames_received") != 8:
        raise AssertionError(f"/predict_video frames: {st} {res}")
    st, _, body = http_call(conn, "POST", "/predict_video", b"\x00" * 1024,
                            {"Content-Type": "video/mp4"})
    res = json.loads(body)
    if st != 400 or not res.get("error", "").startswith("bad video: "):
        raise AssertionError(f"/predict_video video/mp4: {st} {res}")
    out["video_upload"] = res["error"]
    out["cv2_installed"] = importlib.util.find_spec("cv2") is not None
    errors = []

    def client(i):
        try:
            c = http_conn(port)
            for k in range(3):
                st, _, body = http_call(c, "POST", "/predict",
                                        datas[(i + k) % len(datas)])
                if st != 200:
                    errors.append((i, st, body))
            c.close()
        except Exception as exc:        # reported below
            errors.append((i, repr(exc)))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(HTTP_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"keep-alive clients: {errors}")
    st, _, body = http_call(conn, "GET", "/metrics")
    text = body.decode()
    for key in ("serving_requests_total", "serving_request_errors_total",
                "serving_latency_seconds_bucket", "serving_queue_depth"):
        if key not in text:
            raise AssertionError(f"/metrics lacks {key}")
    conn.close()
    return out


def check_http(pred, names, datas, crops, png_data, bound):
    """The HTTP server on the card: the main path counted, its answers
    against the golden crops' logits, the PNG against its JPEG, and the
    nvJPEG decoders over HTTP_CONNECTIONS short connections."""
    decoders0 = jpeg.decoder_count()
    d0 = dispatches(pred)
    torch.backends.cudnn.allow_tf32 = False
    try:
        with HttpServer(pred) as srv:
            t0 = time.perf_counter()
            res, launches = counted(
                lambda: http_traffic(srv.port, names, datas, png_data))
            wall = time.perf_counter() - t0
            n_disp = int(dispatches(pred) - d0)
            decoded = jpeg.decode_count
            decode_calls, converted = jpeg.decode_calls, jpeg.ycc_images

            def short(i):
                c = http_conn(srv.port)
                st, _, body = http_call(c, "POST", "/predict",
                                        datas[i % len(datas)])
                c.close()
                return st, body

            statuses = collections.Counter()
            # the answers other than 200, which say what failed
            refused = []
            for lo in range(0, HTTP_CONNECTIONS, 20):
                group = [None] * 20

                def run(k, lo=lo, group=group):
                    group[k] = short(lo + k)

                threads = [threading.Thread(target=run, args=(k,))
                           for k in range(20)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
                statuses.update(g and g[0] for g in group)
                refused += [(names[(lo + k) % len(datas)], g[1][:300])
                            for k, g in enumerate(group) if g and g[0] != 200]
            made = jpeg.decoder_count() - decoders0
        # the golden comparison: the crops the server makes, and the JAX
        # pipeline's, through one forward each
        served = torch.stack([pred.preprocess(d) for d in datas])
        png_crop = pred.preprocess(png_data)
        logits = pred.logits(pred._weights, served).cpu().numpy()
        golden = pred.logits(pred._weights, torch.from_numpy(
            crops["eval"]).cuda()).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    expect_launches("HTTP serving", launches, n_disp)
    # a request's image is decoded alone: one launch a colour JPEG
    if not 0 < launches["ycc_to_rgb"] == converted <= decode_calls <= \
            decoded:
        raise AssertionError(f"HTTP: colour kernel launched "
                             f"{launches['ycc_to_rgb']} times for "
                             f"{converted} colour images of {decoded} "
                             f"decodes in {decode_calls} decode() calls")
    rel = float(np.abs(logits - golden).max() / np.abs(golden).max())
    for i, name in enumerate(names):
        got = res["predict"][name]
        want = softmax(logits[i])
        top = [e["class"] for e in got]
        if top[0] != int(np.argmax(want)) or not np.allclose(
                [e["prob"] for e in got], want[top], rtol=1e-3, atol=1e-7):
            raise AssertionError(f"/predict {name}: {got} vs the served "
                                 f"crop's {want[top]}")
    k = names.index(PNG_FIXTURE.replace(".png", ".jpg"))
    png_gap = decode_gap(png_crop.cpu().numpy(), served[k].cpu().numpy())
    check_decode_gap("the PNG's crop against its JPEG's", png_gap)
    out = {"requests_s": wall, "dispatches": n_disp, "launches": launches,
           "decoded_on_card": decoded, "logits_rel_vs_golden": rel,
           "bound": bound, "png_vs_jpeg": png_gap,
           "video_upload_error": res["video_upload"],
           "cv2_installed": res["cv2_installed"],
           "connections": dict(statuses), "decoders_made": made,
           "topk": res["predict"]}
    log(f"HTTP on the card (TF32 off): 7 JPEGs, a PNG, a batch with a "
        f"corrupt item, a video as frames and as video/mp4 ('"
        f"{res['video_upload'][:60]}...'; OpenCV installed: "
        f"{res['cv2_installed']}), {HTTP_CLIENTS} keep-alive "
        f"clients x 3 in {wall:.2f} s; {n_disp} dispatches; {decoded} "
        f"images decoded on the card; launches {launches}")
    log(f"HTTP crops vs the JAX golden crops, logits: relative {rel:.3e} "
        f"(bound {bound:.3e}, phase 6's); PNG crop vs its JPEG's: mean |d| "
        f"{png_gap['mean']:.3f}, max {png_gap['max']}")
    log(f"{HTTP_CONNECTIONS} short connections: statuses {dict(statuses)}; "
        f"nvJPEG decoders made over the HTTP run: {made} (decode threads "
        f"{DECODE_THREADS})")
    if not rel <= bound:
        raise AssertionError(f"HTTP logits off the golden crops' by "
                             f"{rel:.3e} > {bound:.3e}")
    if statuses != {200: HTTP_CONNECTIONS} or not 0 < made <= DECODE_THREADS:
        raise AssertionError(f"short connections {dict(statuses)}, "
                             f"{made} nvJPEG decoders made; answers other "
                             f"than 200: {refused[:3]}")
    return out


def http_times(pred, names, datas, card):
    """/predict latency at 1 and HTTP_CLIENTS clients over the two 1280x720
    fixtures, and /predict_batch images/s (cuDNN's default TF32)."""
    mpii = [d for n, d in zip(names, datas) if n in MPII_FIXTURES]
    out = {}
    with HttpServer(pred) as srv:
        def latencies(n, offset=0, conn=None):
            c = conn or http_conn(srv.port)
            lat = []
            for i in range(n):
                t0 = time.perf_counter()
                st, _, _ = http_call(c, "POST", "/predict",
                                     mpii[(offset + i) % 2])
                lat.append(time.perf_counter() - t0)
                if st != 200:
                    raise AssertionError(f"/predict: {st}")
            return lat

        c = http_conn(srv.port)
        latencies(5, conn=c)                     # warm
        one = latencies(40, conn=c)
        many = [None] * HTTP_CLIENTS
        threads = [threading.Thread(
            target=lambda i=i: many.__setitem__(i, latencies(10, i)))
            for i in range(HTTP_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall_many = time.perf_counter() - t0
        many = [x for lat in many for x in lat]
        body = json.dumps({"images": [b64(mpii[i % 2]) for i in range(32)]})
        http_call(c, "POST", "/predict_batch", body)      # warm
        t0 = time.perf_counter()
        for _ in range(4):
            st, _, _ = http_call(c, "POST", "/predict_batch", body)
            if st != 200:
                raise AssertionError(f"/predict_batch: {st}")
        batch_rate = 4 * 32 / (time.perf_counter() - t0)
    for key, lat in (("1", one), (str(HTTP_CLIENTS), many)):
        out[f"predict_ms_p50_{key}_clients"] = float(
            np.percentile(lat, 50) * 1e3)
        out[f"predict_ms_p90_{key}_clients"] = float(
            np.percentile(lat, 90) * 1e3)
    out[f"requests_per_s_{HTTP_CLIENTS}_clients"] = len(many) / wall_many
    out["predict_batch_images_per_s"] = batch_rate
    log(f"HTTP /predict over the two 1280x720 fixtures on {card}: 1 client "
        f"p50 {out['predict_ms_p50_1_clients']:.3f} ms, p90 "
        f"{out['predict_ms_p90_1_clients']:.3f} ms; {HTTP_CLIENTS} clients "
        f"p50 {out[f'predict_ms_p50_{HTTP_CLIENTS}_clients']:.3f} ms, p90 "
        f"{out[f'predict_ms_p90_{HTTP_CLIENTS}_clients']:.3f} ms, "
        f"{out[f'requests_per_s_{HTTP_CLIENTS}_clients']:.1f} requests/s; "
        f"/predict_batch of 32: {batch_rate:.1f} images/s (TF32 on)")
    return out


def check_http_limits(pred, datas):
    """A real overload (the worker held, a queue of 2) answers 429 with a
    Retry-After; a connection over the cap answers 503."""
    gated = GatedPredictor(pred)
    statuses = []
    with HttpServer(gated, max_batch=1, max_queue=2, decode_threads=1) as srv:
        def fire(i):
            st, hdrs, _ = http_call(http_conn(srv.port), "POST", "/predict",
                                    datas[i % len(datas)])
            statuses.append((st, hdrs.get("Retry-After")))

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(6)]
        try:
            for t in threads:
                t.start()
                time.sleep(0.1)
            time.sleep(0.5)
            rejected = list(statuses)
        finally:
            gated.gate.set()
        for t in threads:
            t.join(timeout=120)
    if not rejected or any(st != 429 or not ra or int(ra) < 1
                           for st, ra in rejected) or \
            sorted(st for st, _ in statuses) != \
            [200] * (6 - len(rejected)) + [429] * len(rejected):
        raise AssertionError(f"overload: {statuses}")
    with HttpServer(pred, max_connections=2, decode_threads=1) as srv:
        socks = [socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=30) for _ in range(2)]
        for s in socks:
            s.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
            if not s.recv(4096).startswith(b"HTTP/1.1 200"):
                raise AssertionError("a capped connection was refused")
        third = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
        third.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
        answer = third.recv(4096)
        for s in socks + [third]:
            s.close()
    if not answer.startswith(b"HTTP/1.1 503"):
        raise AssertionError(f"over the cap: {answer[:80]!r}")
    first_line = answer.split(b"\r\n")[0].decode()
    log(f"overload (worker held, queue 2): statuses {statuses}; over the "
        f"connection cap: {first_line}")
    return {"overload": statuses, "over_cap": first_line}


def _conv_shapes(image_size=224):
    """(in channels, kernel, stride, out channels, input size) of every
    conv of ResNet-101 at ``image_size``, as the folded forward runs them."""
    size = -(-image_size // 4)
    convs, depth_in = {(3, 7, 2, 64, image_size)}, 64
    for b, (units, stride) in enumerate(zip((3, 4, 23, 3), (2, 2, 2, 1))):
        base = 64 * 2 ** b
        for u in range(units):
            s = stride if u == units - 1 else 1
            if depth_in != base * 4:
                convs.add((depth_in, 1, s, base * 4, size))
            out = -(-size // s)
            convs |= {(depth_in, 1, 1, base, size), (base, 3, s, base, size),
                      (base, 1, 1, base * 4, out)}
            size, depth_in = out, base * 4
    return sorted(convs)


def check_int8_conv():
    """Every int8 conv of ResNet-101 at 224 px at buckets 1 and 32 through
    ``torch._int_mm`` on the card, against the float64 accumulator of the
    same int8 values on the CPU: bit for bit."""
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    n = 0
    t0 = time.perf_counter()
    for batch in (1, 32):
        for cin, k, stride, cout, size in _conv_shapes():
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
            if not torch.equal(got, want.permute(0, 2, 3, 1).to(torch.int32)):
                case = (batch, cin, k, stride, cout, size)
                raise AssertionError(f"int8 conv on the card differs from "
                                     f"the CPU accumulator at {case}")
            n += 1
    log(f"int8 conv (torch._int_mm, im2col) on the card vs the CPU's "
        f"float64 accumulator: {n} cases ({n // 2} conv shapes of "
        f"ResNet-101 at 224 px, buckets 1 and 32) bit for bit in "
        f"{time.perf_counter() - t0:.1f} s")
    return n


def l2(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm())


def cosine(a, b):
    a, b = a.double().cpu().flatten(), b.double().cpu().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def check_int8_forward(pred, variables, crops):
    """The folded float forward against the model's, int8 against folded
    float, and int8 on the card against int8 on the CPU (batch 2), TF32
    off."""
    params, stats = variables
    cfg = pred.cfg
    x = normalize_images(torch.from_numpy(crops["eval"][:2]).cuda())
    torch.backends.cudnn.allow_tf32 = False
    try:
        folded = inf.fold_backbone({"params": params, "batch_stats": stats},
                                   cfg.backbone, device="cuda")
        head = inf.head_weights(params, "cuda")["head"]
        q = inf.quantize_folded(folded)
        fwd = functools.partial(inf.folded_forward, backbone=cfg.backbone)
        with torch.inference_mode():
            model = pred._weights(x)
            fold = fwd(folded, head, x, dtype=torch.float32)
            int8 = fwd(q, head, x, dtype=torch.float32)
            int8_bf16 = fwd(q, head, x)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    cpu_folded = inf.fold_backbone({"params": params, "batch_stats": stats},
                                   cfg.backbone, device="cpu")
    cpu_head = inf.head_weights(params, "cpu")["head"]
    with torch.inference_mode():
        cpu = fwd(inf.quantize_folded(cpu_folded), cpu_head, x.cpu())
    out = {"fold_rel": {k: float((fold[k] - model[k]).abs().max()
                                 / model[k].abs().max())
                        for k in ("features", "logits")},
           "int8_cosine": {k: cosine(int8[k], fold[k])
                           for k in INT8_COSINE},
           "card_vs_cpu_l2": {k: l2(int8_bf16[k], cpu[k])
                              for k in INT8_CPU_L2},
           "features_bit_equal": bool(torch.equal(
               int8_bf16["features"].cpu(), cpu["features"]))}
    log(f"folded float forward vs the model (2 golden crops, TF32 off): "
        f"features {out['fold_rel']['features']:.3e}, logits "
        f"{out['fold_rel']['logits']:.3e} relative (tolerance {FOLD_RTOL:g}); "
        f"int8 vs folded float cosines {out['int8_cosine']}; int8 (bf16) "
        f"card vs CPU, relative L2 {out['card_vs_cpu_l2']} (bounds "
        f"{INT8_CPU_L2}), features bit for bit: "
        f"{out['features_bit_equal']}")
    if max(out["fold_rel"].values()) > FOLD_RTOL:
        raise AssertionError(f"folded forward off the model: {out}")
    if any(out["int8_cosine"][k] <= v for k, v in INT8_COSINE.items()):
        raise AssertionError(f"int8 off the float forward: {out}")
    if any(out["card_vs_cpu_l2"][k] > v for k, v in INT8_CPU_L2.items()):
        raise AssertionError(f"int8 card off the CPU: {out}")
    return out


def _turn_times(preds, crops_u8, rounds=4, reps=5):
    """Seconds of each predict_arrays call of each predictor at buckets
    1/8/32, the predictors in turns (a, b, b, a, ...)."""
    times = {name: {b: [] for b in (1, 8, 32)} for name in preds}
    names = list(preds)
    for b in (1, 8, 32):
        images = crops_u8[np.arange(b) % len(crops_u8)]
        for name in names:                        # warm
            preds[name].predict_arrays(images)
        for r in range(rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                for _ in range(reps):
                    t0 = time.perf_counter()
                    preds[name].predict_arrays(images)
                    times[name][b].append(time.perf_counter() - t0)
    return times


def serve_in_turns(preds, crops_u8, rounds=4, reps=5):
    """Median ms of a predict_arrays call of each predictor at buckets
    1/8/32, the predictors in turns (a, b, b, a, ...)."""
    return {name: {b: float(np.median(v) * 1e3) for b, v in t.items()}
            for name, t in _turn_times(preds, crops_u8, rounds,
                                       reps).items()}


def int8_serving(cfg, pred, crops, names, card, profile):
    """load_predictor(int8=True) with and without calibration files, each
    call counted; int8 against float logits; float vs int8 ms a call in
    turns."""
    t0 = time.perf_counter()
    pred8 = serving.load_predictor(cfg, int8=True, buckets=(1, 8, 32),
                                   device="cuda")
    calib = [os.path.join(FIXTURES, n) for n in names]
    pred8c = serving.load_predictor(cfg, int8=True, buckets=(1, 8, 32),
                                    calibration_files=calib, device="cuda")
    build_s = time.perf_counter() - t0
    u8 = crops["eval"]
    out = {"build_s": build_s}
    total = collections.Counter()
    ref = pred.logits(pred._weights, torch.from_numpy(u8).cuda())
    for what, p in (("dynamic", pred8), ("static", pred8c)):
        probs, launches = counted(lambda p=p: p.predict_arrays(u8))
        expect_launches(f"int8 serving ({what} scales), 7 images", launches,
                        1, ycc=0)
        total.update(launches)
        if not (np.isfinite(probs).all() and np.allclose(probs.sum(-1), 1,
                                                         atol=1e-3)):
            raise AssertionError(f"int8 serving ({what}): bad probabilities")
        cos = cosine(p.logits(p._weights, torch.from_numpy(u8).cuda()), ref)
        out[f"{what}_logits_cosine_vs_float"] = cos
        if cos <= INT8_COSINE["logits"]:
            raise AssertionError(f"int8 serving ({what}) logits cosine "
                                 f"{cos:.4f} vs float")
    out["launches"] = dict(total)
    out["ms"] = serve_in_turns({"float": pred, "int8": pred8}, u8)
    log(f"int8 serving, built (fold, calibrate on 7 fixtures, quantize) in "
        f"{build_s:.1f} s for both; logits cosine vs float: dynamic "
        f"{out['dynamic_logits_cosine_vs_float']:.4f}, static "
        f"{out['static_logits_cosine_vs_float']:.4f}; launches "
        f"{out['launches']}")
    log(f"predict_arrays ms a call, in turns, on {card}: float (TF32) "
        + " / ".join(f"{v:.3f}" for v in out["ms"]["float"].values())
        + ", int8 (bf16 activations) "
        + " / ".join(f"{v:.3f}" for v in out["ms"]["int8"].values())
        + " at buckets 1/8/32")
    if profile:
        log("profile of the int8 predictor:")
        phase_profile(pred8)
    return out


def int8_eval(cfg, workdir, datas):
    """eval_cli of the seeded checkpoint over 48 MPII eval records (the
    fixtures'), float and with --set eval_int8=true; counted."""
    paths = write_records(workdir, datas)
    out = {}
    for what, extra in (("float", []), ("int8", ["--set", "eval_int8=True"])):
        t0 = time.perf_counter()
        printed, launches = counted(lambda extra=extra: eval_cli.main([
            "--config", "mpii_rank1_224", "--workdir", cfg.workdir,
            "--eval_pattern", paths["val"], "--notb", *extra]))
        line = printed[-1]
        expect_launches(f"eval_cli ({what}): 6 batches", launches, 6)
        if set(line) != EVAL_KEYS or line["num_examples"] != 48 or \
                not np.isfinite(line["mAP"]):
            raise AssertionError(f"eval_cli ({what}) printed {line}")
        out[what] = {"line": line, "launches": launches,
                     "s": time.perf_counter() - t0}
    log(f"eval_cli over 48 records: float mAP "
        f"{out['float']['line']['mAP']:.6f} ({out['float']['s']:.1f} s), "
        f"int8 mAP {out['int8']['line']['mAP']:.6f} "
        f"({out['int8']['s']:.1f} s); int8 launches "
        f"{out['int8']['launches']}")
    return out


def run_module(module, args):
    """``python -m attentionalpoolingaction_torch.<module> args`` in a
    fresh process, as a user starts it; its standard output.  An exit
    code other than 0 raises."""
    proc = subprocess.run(
        [sys.executable, "-m", f"attentionalpoolingaction_torch.{module}",
         *args], capture_output=True, text=True, timeout=600, cwd=HERE)
    if proc.returncode:
        raise AssertionError(f"python -m {module} exited {proc.returncode}:"
                             f" {proc.stderr[-3000:]}")
    return proc.stdout


def printed_by(main, args):
    """What ``main(args)`` prints, run in this process."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        main(args)
    return printed.getvalue()


def run_predict_cli(workdir, names, http_topk):
    """predict_cli over the fixtures, float in a subprocess and --int8 in
    this process: a JSON line an image; the float classes against
    HTTP's."""
    paths = [os.path.join(FIXTURES, n) for n in names] + [
        os.path.join(FIXTURES, PNG_FIXTURE)]
    args = ["--workdir", workdir, "--images", *paths]
    out = {}
    for what in ("float", "int8"):
        t0 = time.perf_counter()
        if what == "float":
            stdout = run_module("predict_cli", args)
        else:
            stdout = printed_by(predict_cli.main, [*args, "--int8"])
        lines = [json.loads(x) for x in stdout.strip().splitlines()]
        if [x["image"] for x in lines] != paths or \
                any(len(x["topk"]) != 5 for x in lines):
            raise AssertionError(f"predict_cli {what}: {lines}")
        out[what] = {"s": time.perf_counter() - t0, "lines": lines}
    for line in out["float"]["lines"]:
        want = {e["class"]: e["prob"]
                for e in http_topk[os.path.basename(line["image"])]}
        got = {e["class"]: e["prob"] for e in line["topk"]}
        shared = set(got) & set(want)
        if line["topk"][0]["class"] not in want or not all(
                abs(got[c] - want[c]) <= CLI_PROB_RTOL * want[c]
                for c in shared):
            raise AssertionError(f"predict_cli vs HTTP on {line['image']}: "
                                 f"{got} vs {want}")
    log(f"predict_cli over 8 images: float in a subprocess "
        f"{out['float']['s']:.1f} s (process start included), --int8 in "
        f"this process {out['int8']['s']:.1f} s (model build and restore "
        f"included in both); float top-1 within HTTP's top-5 for every "
        f"image")
    return {k: v["s"] for k, v in out.items()}


def int8_clip(names, datas):
    """hmdb51_clip8 (seeded weights) serving an int8 clip of 8 frames
    through predict_clip_bytes, counted; its logits against the float
    clip's."""
    cfg = config_lib.get_config("hmdb51_clip8")
    params, stats = precision.seeded_variables(cfg, 3)
    pred = serving.Predictor(cfg, params, stats, buckets=(1,), device="cuda")
    pred8 = serving.Predictor(cfg, params, stats, buckets=(1,), int8=True,
                              device="cuda")
    frames = [d for n, d in zip(names, datas) if n in FRAME_FIXTURES] * 3
    res, launches = counted(lambda: pred8.predict_clip_bytes(frames, topk=3))
    expect_launches("hmdb51_clip8 int8 clip", launches, 1)
    if res.get("clip_frames") != 8 or res.get("frames_received") != 9 or \
            len(res.get("topk", ())) != 3:
        raise AssertionError(f"hmdb51_clip8 int8 clip: {res}")
    clip = torch.stack([pred.preprocess(frames[p]) for p in
                        grain_pipeline._segment_picks(len(frames), 8)])[None]
    cos = cosine(pred8.logits(pred8._weights, clip),
                 pred.logits(pred._weights, clip))
    log(f"hmdb51_clip8 int8 clip of 9 frames (8 picked): {res['topk'][:2]};"
        f" logits cosine vs float {cos:.4f}; launches {launches}")
    if cos <= INT8_COSINE["logits"]:
        raise AssertionError(f"hmdb51_clip8 int8 clip cosine {cos:.4f}")
    return {"launches": launches, "cosine_vs_float": cos}


def with_bn_statistics(variables, seed):
    """``variables`` with seeded BN scales, offsets, means and variances
    (the seeded weights have 1, 0, 0 and 1), so that folding BN into the
    convs has something to fold."""
    params, stats = copy.deepcopy(variables)
    rng = np.random.default_rng(seed)

    def walk(p, s):
        for k in p:
            if k.endswith("_bn"):
                c = p[k]["scale"].shape[0]
                p[k]["scale"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
                p[k]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif k in s:
                walk(p[k], s[k])

    walk(params["resnet"], stats["resnet"])
    return params, stats


def phase_http_serving(card, golden_bound, profile=False):
    """Serving mpii_rank1_224 on the card from a checkpoint: the HTTP
    server, int8, int8 eval, predict_cli; see the module docstring,
    phase 8."""
    t_phase = time.monotonic()
    names, datas, crops, _ = load_fixtures()
    with open(os.path.join(FIXTURES, PNG_FIXTURE), "rb") as f:
        png_data = f.read()
    out = {"config": "mpii_rank1_224", "card": card,
           "int8_conv_cases": check_int8_conv()}
    base = config_lib.get_config("mpii_rank1_224")
    variables = with_bn_statistics(precision.seeded_variables(base, 8), 8)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as d:
        cfg = dataclasses.replace(base, workdir=d)
        state, _ = train.create_state(cfg, device="cuda", variables=variables)
        mgr = checkpoint.make_manager(os.path.join(d, "checkpoints"))
        checkpoint.save(mgr, state)
        mgr.wait_until_finished()   # predict_cli reads it in a subprocess
        del state, mgr
        pred = serving.load_predictor(cfg, buckets=(1, 8, 32), device="cuda")
        pred.warmup()
        out["http"] = check_http(pred, names, datas, crops, png_data,
                                 golden_bound)
        out["http_times"] = http_times(pred, names, datas, card)
        out["http_limits"] = check_http_limits(pred, datas)
        out["int8_forward"] = check_int8_forward(pred, variables, crops)
        out["int8_serving"] = int8_serving(cfg, pred, crops, names, card,
                                           profile)
        del pred
        out["int8_eval"] = int8_eval(cfg, d, datas)
        out["predict_cli_s"] = run_predict_cli(d, names, out["http"]["topk"])
    out["clip8_int8"] = int8_clip(names, datas)
    out["phase_s"] = time.monotonic() - t_phase
    log(f"phase 8 took {out['phase_s']:.1f} s (workdir removed)")
    return out


# -- phase 9: the exported artifact and the attention-map tools --------------

# export_cli's load-back gate (the JAX CLI's): max |dprob| between the
# loaded artifact and the live predictor on the same device
EXPORT_PARITY = 1e-6
# the programs carry no weights: an artifact within 5% of its weights' bytes
EXPORT_BYTES_RATIO = 1.05
# overlays on the card against the CPU: equal on this share of the pixels,
# their colormap levels within 1, so the pixels within 2 (half a JET step
# at alpha 0.5) where a level flips; the maps within CPU_RTOL
VIZ_EQUAL_SHARE = 0.99
VIZ_LEVELS = 1
VIZ_PIXELS = 2


def export_artifact(args, what):
    """export_cli.main(args): the export, the load back and its gate; the
    times, the sizes and the gate's values printed and checked."""
    ec = export_cli.main(args)["export_cli"]
    ratio = ec["artifact_bytes"] / ec["weight_bytes"]
    log(f"export {what}: {ec['export_seconds']:.1f} s; artifact "
        f"{ec['artifact_bytes'] / 1e6:.2f} MB against weights "
        f"{ec['weight_bytes'] / 1e6:.2f} MB ({ratio:.4f}x); load "
        f"{ec['load_seconds']:.1f} s; load-back max|dprob| "
        + ", ".join(f"{k} {v:.3g}" for k, v in ec["parity"].items()))
    if max(ec["parity"].values()) > EXPORT_PARITY or \
            ratio > EXPORT_BYTES_RATIO:
        raise AssertionError(f"export {what}: parity {ec['parity']}, "
                             f"bytes {ratio:.4f}x the weights'")
    return {**ec, "bytes_ratio": ratio}


def seeded_checkpoint(cfg, variables):
    """A port checkpoint of ``variables`` under ``cfg.workdir``."""
    state, _ = train.create_state(cfg, device="cuda", variables=variables)
    mgr = checkpoint.make_manager(os.path.join(cfg.workdir, "checkpoints"))
    checkpoint.save(mgr, state)
    mgr.wait_until_finished()       # other processes read it


def artifact_buckets(arts, crops_u8):
    """Each loaded artifact at buckets 1/8/32 (the clip artifact: one clip
    of 8 frames), counted: each pooling kernel once a dispatch."""
    out = {}
    for what, art in arts.items():
        if art.clip_t:
            clip = torch.from_numpy(crops_u8[np.arange(art.clip_t) % len(
                crops_u8)][None]).cuda()
            probs, launches = counted(lambda: art._fwd(art._weights, clip))
            expect_launches(f"{what} artifact, a clip", launches, 1, ycc=0)
            out[what] = {"clip": launches}
            continue
        out[what] = {}
        for b in art.buckets:
            images = crops_u8[np.arange(b) % len(crops_u8)]
            probs, launches = counted(lambda: art.predict_arrays(images))
            expect_launches(f"{what} artifact at bucket {b}", launches, 1,
                            ycc=0)
            if probs.shape != (b, art.spec.num_classes) or \
                    not np.isfinite(probs).all():
                raise AssertionError(f"{what} artifact at {b}: "
                                     f"{probs.shape}")
            out[what][b] = launches
    log("one program serves each bucket, each pooling kernel once a "
        "dispatch: " + "; ".join(f"{k} {list(v)}" for k, v in out.items()))
    return out


def check_portable(card_art, cpu_art, crops_u8):
    """The artifact traced on the CPU, loaded on the card, against the one
    traced on the card: the logits of the 7 golden crops (TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = card_art.logits(card_art._weights, crops_u8).cpu().numpy()
        got = cpu_art.logits(cpu_art._weights, crops_u8).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    log(f"an artifact traced on {cpu_art.manifest['platforms']} serving on "
        f"the card against one traced there: logits relative {rel:.3e} "
        f"(bound {CPU_RTOL:.0e}; bit for bit: {bool((got == want).all())})")
    if cpu_art.manifest["platforms"] != ["cpu"] or not rel <= CPU_RTOL:
        raise AssertionError(f"CPU-traced artifact off by {rel:.3e}")
    return {"logits_rel": rel, "bitwise": bool((got == want).all())}


def export_http(pred, names, datas, crops, png_data, bound):
    """serve_cli's server over the artifact (serve_cli.load_served of
    --exported_dir), TF32 off: /healthz, /predict of the 7 JPEG fixtures
    and the PNG, /predict_batch with a corrupt item, counted; the answers
    against the served crops' logits and those against the golden crops'
    within phase 6's bound."""
    torch.backends.cudnn.allow_tf32 = False
    d0 = dispatches(pred)
    try:
        with HttpServer(pred) as srv:
            def traffic():
                conn = http_conn(srv.port)
                st, _, body = http_call(conn, "GET", "/healthz")
                if st != 200 or json.loads(body)["status"] != "ok":
                    raise AssertionError(f"/healthz: {st} {body}")
                topk = {}
                for name, data in list(zip(names, datas)) + [
                        (PNG_FIXTURE, png_data)]:
                    st, _, body = http_call(conn, "POST", "/predict", data)
                    if st != 200:
                        raise AssertionError(f"/predict {name}: {st}")
                    topk[name] = json.loads(body)["topk"]
                st, _, body = http_call(conn, "POST", "/predict_batch",
                                        json.dumps({"images": [
                                            b64(datas[0]),
                                            b64(b"\xff\xd8corrupt")]}))
                res = json.loads(body)["results"]
                if st != 200 or "topk" not in res[0] or \
                        not res[1].get("error", "").startswith("bad image"):
                    raise AssertionError(f"/predict_batch: {st} {res}")
                conn.close()
                return topk

            topk, launches = counted(traffic)
            n_disp = int(dispatches(pred) - d0)
            converted = jpeg.ycc_images
        served = torch.stack([pred.preprocess(d) for d in datas])
        logits = pred.logits(pred._weights, served).cpu().numpy()
        golden = pred.logits(pred._weights, torch.from_numpy(
            crops["eval"]).cuda()).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    expect_launches("HTTP from the artifact", launches, n_disp)
    if not 0 < launches["ycc_to_rgb"] == converted:
        raise AssertionError(f"HTTP from the artifact: {launches} for "
                             f"{converted} colour images")
    for i, name in enumerate(names):
        want = softmax(logits[i])
        top = [e["class"] for e in topk[name]]
        if top[0] != int(np.argmax(want)) or not np.allclose(
                [e["prob"] for e in topk[name]], want[top], rtol=1e-3,
                atol=1e-7):
            raise AssertionError(f"/predict {name} from the artifact: "
                                 f"{topk[name]} vs {want[top]}")
    rel = float(np.abs(logits - golden).max() / np.abs(golden).max())
    log(f"serve_cli --exported_dir on the card (TF32 off): 7 JPEGs and a "
        f"PNG through /predict, a batch with a corrupt item; {n_disp} "
        f"dispatches, launches {launches}; served crops vs the JAX golden "
        f"crops, logits relative {rel:.3e} (bound {bound:.3e})")
    if not rel <= bound:
        raise AssertionError(f"artifact logits off the golden crops' by "
                             f"{rel:.3e} > {bound:.3e}")
    return {"launches": launches, "dispatches": n_disp,
            "logits_rel_vs_golden": rel, "bound": bound}


def export_predict_cli(art, names):
    """predict_cli --exported_dir over the fixtures, in this process."""
    paths = [os.path.join(FIXTURES, n) for n in names]
    t0 = time.perf_counter()
    lines = [json.loads(x) for x in printed_by(
        predict_cli.main, ["--exported_dir", art, "--images", *paths]
    ).strip().splitlines()]
    if [x["image"] for x in lines] != paths or \
            any(len(x["topk"]) != 5 for x in lines):
        raise AssertionError(f"predict_cli --exported_dir: {lines}")
    s = time.perf_counter() - t0
    log(f"predict_cli --exported_dir over 7 images: {s:.1f} s (artifact "
        "load included)")
    return s


def predict_latencies(pred, datas, n=30):
    """/predict seconds at 1 client over the two 1280x720 fixtures."""
    with HttpServer(pred) as srv:
        c = http_conn(srv.port)
        lat = []
        for i in range(n + 5):
            t0 = time.perf_counter()
            st, _, _ = http_call(c, "POST", "/predict", datas[i % 2])
            if st != 200:
                raise AssertionError(f"/predict: {st}")
            lat.append(time.perf_counter() - t0)
        c.close()
    return lat[5:]


def export_times(pairs, crops_u8, mpii, card):
    """The artifact against the live predictor, in turns: predict_arrays
    median and p90 ms at buckets 1/8/32 (float and int8), and /predict
    p50 and p90 at 1 client (float), cuDNN's default TF32."""
    out = {}
    for kind, (live, art) in pairs.items():
        times = _turn_times({"live": live, "artifact": art}, crops_u8)
        out[kind] = {name: {b: {"median_ms": float(np.median(v) * 1e3),
                                "p90_ms": float(np.percentile(v, 90) * 1e3)}
                            for b, v in t.items()}
                     for name, t in times.items()}
        log(f"predict_arrays ms a call on {card}, {kind}, in turns: "
            + "; ".join(f"{name} " + " / ".join(
                f"{m['median_ms']:.3f} (p90 {m['p90_ms']:.3f})"
                for m in per.values())
                for name, per in out[kind].items()) + " at buckets 1/8/32")
    live, art = pairs["float"]
    lat = {"live": [], "artifact": []}
    for name in ("live", "artifact", "artifact", "live"):
        lat[name] += predict_latencies(live if name == "live" else art,
                                       mpii)
    out["predict_1_client"] = {
        name: {"p50_ms": float(np.percentile(v, 50) * 1e3),
               "p90_ms": float(np.percentile(v, 90) * 1e3)}
        for name, v in lat.items()}
    log(f"/predict at 1 client over the 1280x720 fixtures on {card}, in "
        f"turns: " + "; ".join(
            f"{k} p50 {v['p50_ms']:.3f} ms, p90 {v['p90_ms']:.3f} ms"
            for k, v in out["predict_1_client"].items()))
    return out


def overlay_levels(maps, size):
    """The colormap levels ``uint8(map * 255)`` of overlays of ``maps``
    (..., h, w), each normalized over itself, on the CPU."""
    m = viz.normalize_map(viz.upsample_map(torch.as_tensor(maps), size,
                                           size), (-2, -1))
    return (m * 255).to(torch.uint8).numpy()


def check_overlays(what, got, want, got_maps, want_maps, size):
    g, w = np.stack(got).astype(int), np.stack(want).astype(int)
    share = float((g == w).mean())
    gap = int(np.abs(g - w).max())
    lv = int(np.abs(overlay_levels(got_maps, size).astype(int)
                    - overlay_levels(want_maps, size).astype(int)).max())
    if share < VIZ_EQUAL_SHARE or gap > VIZ_PIXELS or lv > VIZ_LEVELS:
        raise AssertionError(f"{what} overlays card vs CPU: equal on "
                             f"{share:.4%}, max gap {gap}, levels {lv}")
    return {"equal_share": share, "max_gap": gap, "max_level_gap": lv}


def check_visualize(cfg, variables, crops_u8, names, workdir, hmdb_dir):
    """attention_overlays on the card (TF32 off) against the CPU on two
    golden crops, counted; visualize_cli on the JPEG fixtures (2 PNGs an
    image, decoded back; its launches the kernels line's
    visualize_launches) and with --clip on 8 frames of hmdb51_clip8."""
    card_model = convert.load_flax_variables(
        build_model(cfg, device="cuda"), *variables)
    cpu_model = convert.load_flax_variables(
        build_model(cfg, device="cpu"), *variables)
    x = normalize_images(torch.from_numpy(crops_u8[:2]))
    torch.backends.cudnn.allow_tf32 = False
    try:
        got, launches = counted(
            lambda: viz.attention_overlays(card_model, x.cuda()))
    finally:
        torch.backends.cudnn.allow_tf32 = True
    expect_launches("attention_overlays of 2 images", launches, 1, ycc=0)
    want = viz.attention_overlays(cpu_model, x)
    del card_model, cpu_model
    rel = {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
           for k in ("attn_maps", "saliency_maps", "logits")}
    if max(rel.values()) > CPU_RTOL or \
            not (got["class_idx"] == want["class_idx"]).all():
        raise AssertionError(f"visualize maps card vs CPU: {rel}")
    cls = want["class_idx"]
    pick = np.arange(2)
    out = {"maps_rel": rel, "overlays": {
        "top_down": check_overlays(
            "top_down", got["top_down"], want["top_down"],
            got["attn_maps"][pick, ..., cls],
            want["attn_maps"][pick, ..., cls], cfg.image_size),
        "saliency": check_overlays(
            "saliency", got["saliency"], want["saliency"],
            got["saliency_maps"], want["saliency_maps"], cfg.image_size)}}
    log(f"attention_overlays card (TF32 off) vs CPU: maps relative {rel} "
        f"(bound {CPU_RTOL:.0e}); overlays {out['overlays']}")

    paths = [os.path.join(FIXTURES, n) for n in names]
    out_dir = os.path.join(workdir, "viz")
    t0 = time.perf_counter()
    res, launches = counted(lambda: visualize_cli.main(
        ["--workdir", workdir, "--images", *paths, "--out_dir", out_dir]))
    out["visualize_cli_s"] = time.perf_counter() - t0
    expect_launches("visualize_cli over 7 JPEGs", launches, 1)
    if not 0 < launches["ycc_to_rgb"] <= len(paths):
        raise AssertionError(f"visualize_cli: colour launches {launches}")
    if len(res["paths"]) != 2 * len(paths) or any(
            png.decode(pathlib.Path(p).read_bytes()).shape != (224, 224, 3)
            for p in res["paths"]):
        raise AssertionError(f"visualize_cli wrote {res['paths']}")
    out["launches"] = launches
    frames = [os.path.join(FIXTURES, FRAME_FIXTURES[i % 3])
              for i in range(8)]
    clip = visualize_cli.main(
        ["--config", "hmdb51_clip8", "--workdir", hmdb_dir, "--clip",
         "--images", *frames, "--out_dir", os.path.join(workdir, "viz8")])
    ta = clip["temporal_attention"]
    if len(clip["paths"]) != 16 or ta.shape != (8,) or \
            abs(float(ta.sum()) - 1) > 1e-5:
        raise AssertionError(f"visualize_cli --clip: {len(clip['paths'])} "
                             f"overlays, temporal attention {ta}")
    out["clip_temporal_attention"] = ta.tolist()
    log(f"visualize_cli: 14 overlays of 7 JPEGs in "
        f"{out['visualize_cli_s']:.1f} s (restore and model build "
        f"included), decoded back; launches {launches}; --clip of 8 "
        f"frames (hmdb51_clip8): class {clip['class_idx']}, temporal "
        f"attention " + ", ".join(f"{v:.3f}" for v in ta))
    return out


def read_images(workdir):
    """tag -> [(step, decoded RGB)] of the image summaries of the event
    files of ``workdir``."""
    out = {}
    for name in sorted(os.listdir(workdir)):
        if "tfevents" not in name:
            continue
        for raw in records.read_tfrecord(os.path.join(workdir, name)):
            fields = list(_fields(raw))
            step = next((v for n, _, v in fields if n == 2), 0)
            for value in (v for n, _, s in fields if n == 5
                          for m, _, v in _fields(s) if m == 1):
                f = {k: v for k, _, v in _fields(value)}
                if 4 in f:
                    img = {k: v for k, _, v in _fields(f[4])}
                    out.setdefault(bytes(f[1]).decode(), []).append(
                        (step, png.decode(bytes(img[4]))))
    return out


def check_attn_summary(workdir, datas):
    """train_cli --attn_summary_every 2 for 4 steps from records: the
    event file holds attention/* overlays of 4 eval images at steps 2
    and 4."""
    paths = write_records(workdir, datas, prefix="summary_")
    run_dir = os.path.join(workdir, "summary_run")
    t0 = time.perf_counter()
    train_cli.main(["--config", "mpii_rank1_224", "--train_pattern",
                    paths["train"], "--eval_pattern", paths["val"],
                    "--workdir", run_dir, "--num_steps", "4",
                    "--attn_summary_every", "2"])
    s = time.perf_counter() - t0
    images = read_images(run_dir)
    want = {f"attention/{k}/image/{i}" for k in ("top_down", "saliency")
            for i in range(4)}
    if set(images) != want or any(
            [st for st, _ in v] != [2, 4]
            or any(im.shape != (224, 224, 3) for _, im in v)
            for v in images.values()):
        raise AssertionError(f"attention summaries: {sorted(images)}")
    log(f"train_cli --attn_summary_every 2: 4 steps in {s:.1f} s; the event "
        f"file holds {len(images)} attention/* tags at steps 2 and 4")
    return {"train_cli_s": s, "tags": sorted(images)}


def phase_export(card, golden_bound):
    """The exported artifact and the attention-map tools on the card; see
    the module docstring, phase 9."""
    t_phase = time.monotonic()
    names, datas, crops, _ = load_fixtures()
    with open(os.path.join(FIXTURES, PNG_FIXTURE), "rb") as f:
        png_data = f.read()
    crops_u8 = crops["eval"]
    base = config_lib.get_config("mpii_rank1_224")
    variables = with_bn_statistics(precision.seeded_variables(base, 8), 8)
    out = {"config": "mpii_rank1_224", "card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as d:
        cfg = dataclasses.replace(base, workdir=d)
        seeded_checkpoint(cfg, variables)
        hmdb = os.path.join(d, "hmdb")
        hcfg = config_lib.get_config("hmdb51_clip8", workdir=hmdb)
        seeded_checkpoint(hcfg, precision.seeded_variables(hcfg, 3))
        calib = [os.path.join(FIXTURES, n) for n in names]
        art = {k: os.path.join(d, f"artifact_{k}")
               for k in ("float", "int8", "cpu", "clip8")}
        # the float artifact carries both input dtypes; the others only
        # the uint8 program that serving feeds
        out["exports"] = {
            "float": export_artifact(
                ["--workdir", d, "--out_dir", art["float"]],
                "mpii_rank1_224 float (uint8, float32)"),
            "int8": export_artifact(
                ["--workdir", d, "--out_dir", art["int8"], "--int8",
                 "--input_dtypes", "uint8",
                 *itertools.chain.from_iterable(
                     ("--calibration_images", p) for p in calib)],
                "mpii_rank1_224 int8, static scales (uint8)"),
            "cpu": export_artifact(
                ["--workdir", d, "--out_dir", art["cpu"], "--device",
                 "cpu", "--input_dtypes", "uint8"],
                "mpii_rank1_224 float traced on the CPU (uint8)"),
            "clip8": export_artifact(
                ["--config", "hmdb51_clip8", "--workdir", hmdb, "--out_dir",
                 art["clip8"], "--input_dtypes", "uint8"],
                "hmdb51_clip8 (uint8; images and clips)")}
        loaded = {k: export.load_exported(v) for k, v in art.items()}
        for a in loaded.values():
            a.warmup()
        out["buckets"] = artifact_buckets(loaded, crops_u8)
        out["portable"] = check_portable(loaded["float"], loaded["cpu"],
                                         crops_u8)
        served = serve_cli.load_served(serve_cli.parse_args(
            ["--exported_dir", art["float"]]))
        served.warmup()
        out["http"] = export_http(served, names, datas, crops, png_data,
                                  golden_bound)
        del served
        out["predict_cli_s"] = export_predict_cli(art["float"], names)
        live = serving.load_predictor(cfg, buckets=(1, 8, 32),
                                      device="cuda")
        live8 = serving.load_predictor(cfg, int8=True, buckets=(1, 8, 32),
                                       calibration_files=calib,
                                       device="cuda")
        live.warmup()
        live8.warmup()
        mpii = [x for n, x in zip(names, datas) if n in MPII_FIXTURES]
        out["times"] = export_times(
            {"float": (live, loaded["float"]), "int8": (live8,
                                                        loaded["int8"])},
            crops_u8, mpii, card)
        del live, live8, loaded
        out["visualize"] = check_visualize(cfg, variables, crops_u8, names,
                                           d, hmdb)
        out["attn_summary"] = check_attn_summary(d, datas)
    out["phase_s"] = time.monotonic() - t_phase
    log(f"phase 9 took {out['phase_s']:.1f} s (workdir removed)")
    return out


# -- phase 10 ----------------------------------------------------------------

MESH_CONFIG = "mpii_rank5_450_mesh"
MESH_TRAIN_STEPS = 3
MESH_TIMED_STEPS = 5
MESH_EVAL_BATCHES = 8        # injected eval batches of 8 images x 3 crops
GLOO_SIZE = 96
GLOO_TIMED_STEPS = 5
GLOO_DP_RTOL = 1e-4          # DP vs one process: loss relative, params abs
GLOO_ZERO1_ATOL = 1e-5       # ZeRO-1 vs DP (tests/test_zero1.py)
GLOO_TP_ATOL = 1e-4          # TP vs one process
GLOO_MAP_ATOL = 1e-12        # the gathered eval's mAP vs one process's
GLOO_CONFIG = dict(backbone="resnet_v1_50", image_size=GLOO_SIZE,
                   resize_min=110, resize_max=130, rank=2, batch_size=8,
                   bf16_backbone=False, freeze_bn=False, learning_rate=1e-3,
                   grad_clip_norm=10.0, lr_schedule="constant",
                   eval_batch_size=2)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_mesh_workers(kind, world, workdir, timeout, one_card_each=False):
    """``world`` processes of this script in ``--mesh-worker kind`` mode,
    joined through torchrun's environment (all on card 0, or with
    ``one_card_each`` rank r on card r); each writes
    ``result_<kind>_<rank>.json``.  Raises with the worker's output when
    one fails or outlives ``timeout``; every process is stopped."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank if one_card_each else 0),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-worker",
             kind, "--workdir", workdir], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{kind} worker {rank} exited "
                                 f"{p.returncode}:\n{out[-6000:]}")
        for line in out.splitlines():
            if line.startswith(MESH_LOG_PREFIX):
                log(f"[{kind} rank {rank}] {line[len(MESH_LOG_PREFIX):]}")
    results = []
    for rank in range(world):
        path = os.path.join(workdir, f"result_{kind}_{rank}.json")
        with open(path) as f:
            results.append(json.load(f))
    return results, outs


MESH_LOG_PREFIX = "mesh| "


def mesh_log(*args):
    """A worker's line, which :func:`run_mesh_workers` prints again."""
    log(MESH_LOG_PREFIX + " ".join(str(a) for a in args))


def _flat_params(state):
    return torch.cat([t.detach().float().reshape(-1)
                      for t in state.full_state_dict().values()
                      if t.is_floating_point()])


def _mesh_step(cfg, spec, variables, batch, mesh, dev, rows=None):
    """One train step of ``cfg`` from ``variables`` on ``batch`` (this
    rank's ``rows`` of it on a mesh), counted; the state, its parameters
    and statistics as one flat vector, and the metrics."""
    state, _ = train.create_state(cfg, device=dev, variables=variables,
                                  mesh=mesh)
    step = train.make_train_step(spec, cfg, mesh)
    part = batch if rows is None else {k: v[rows] for k, v in batch.items()}
    (state, metrics), launches = counted(
        lambda: step(state, train.batch_to_device(part, dev)))
    return state, _flat_params(state), {
        k: float(v) for k, v in metrics.items()}, launches


def _timed_steps(state, step, batch, dev, n):
    """Median ms of ``n`` steps after one warm-up."""
    dev_batch = train.batch_to_device(batch, dev)
    step(state, dev_batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        step(state, dev_batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def mesh5_worker(workdir):
    """Config #5 in one rank over NCCL: the mesh step against the step
    with no process group (and the gap of two such steps), its time and
    memory; then ``train_cli --multiprocess`` from records and ``eval_cli
    --multiprocess`` with 3 crops, and the eval loop on injected crops,
    each counted."""
    from attentionalpoolingaction_torch.parallel import mesh as mesh_lib
    from attentionalpoolingaction_torch.parallel import multihost

    with open(os.path.join(workdir, "mesh5.json")) as f:
        params = json.load(f)
    dev = multihost.setup()
    out = {"backend": torch.distributed.get_backend(),
           "world": torch.distributed.get_world_size(), "device": str(dev)}
    cfg = config_lib.get_config(MESH_CONFIG)
    spec = train.get_dataset(cfg.dataset)
    variables = precision.seeded_variables(cfg, 0)
    batch = precision.synthetic_batch(np.random.default_rng(50), cfg, spec)
    accum = 1
    try:
        _, ref, ref_m, _ = _mesh_step(cfg, spec, variables, batch, None, dev)
    except torch.cuda.OutOfMemoryError as e:
        mesh_log(f"{MESH_CONFIG} at batch 64: out of memory ({e}); with "
                 "freeze_bn two microbatches make the same update: "
                 "grad_accum_steps=2")
        torch.cuda.empty_cache()
        accum = 2
        cfg = dataclasses.replace(cfg, grad_accum_steps=2)
        _, ref, ref_m, _ = _mesh_step(cfg, spec, variables, batch, None, dev)
    out["grad_accum_steps"] = accum
    _, again, again_m, _ = _mesh_step(cfg, spec, variables, batch, None, dev)
    gap = float((again - ref).abs().max())
    loss_gap = abs(again_m["loss/total"] - ref_m["loss/total"])
    mesh = mesh_lib.make_mesh((1,), ("data",))
    state, got, got_m, launches = _mesh_step(cfg, spec, variables, batch,
                                             mesh, dev)
    err = float((got - ref).abs().max())
    loss_err = abs(got_m["loss/total"] - ref_m["loss/total"])
    del ref, again, got
    if err > gap or loss_err > loss_gap:
        raise AssertionError(
            f"{MESH_CONFIG}: the NCCL mesh step is {err:.3e} (loss "
            f"{loss_err:.3e}) from the step with no process group, beyond "
            f"the gap of two such steps {gap:.3e} (loss {loss_gap:.3e})")
    expect_launches(f"{MESH_CONFIG} mesh step", launches, accum,
                    backward=accum)
    out.update(step_err=err, step_gap=gap, loss_err=loss_err,
               loss_gap=loss_gap, step_launches=launches,
               metrics=got_m)
    torch.cuda.reset_peak_memory_stats(dev)
    step = train.make_train_step(spec, cfg, mesh)
    out["step_ms"] = _timed_steps(state, step, batch, dev, MESH_TIMED_STEPS)
    out["images_per_s"] = cfg.batch_size / out["step_ms"] * 1e3
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    del state, step
    torch.cuda.empty_cache()
    mesh_log(f"{MESH_CONFIG} one rank over NCCL ({params['card']}): the "
             f"mesh step {err:.3e} from the step with no group (gap of two "
             f"such steps {gap:.3e}; loss {loss_err:.3e} vs "
             f"{loss_gap:.3e}); {out['step_ms']:.1f} ms a step (median of "
             f"{MESH_TIMED_STEPS}), {out['images_per_s']:.1f} images/s, max "
             f"allocated {out['max_memory_allocated'] / 2**30:.2f} GiB; "
             f"launches {launches}")

    sets = ["--set", "log_every=1", "--set", f"grad_accum_steps={accum}"]
    t0 = time.perf_counter()
    state, launches = counted(lambda: train_cli.main([
        "--multiprocess", "--config", MESH_CONFIG,
        "--train_pattern", params["train"], "--workdir", params["run"],
        "--init_checkpoint", params["init"],
        "--num_steps", str(MESH_TRAIN_STEPS), *sets]))
    out["train_cli_s"] = time.perf_counter() - t0
    n = MESH_TRAIN_STEPS * accum
    expect_launches(f"{MESH_CONFIG} train_cli --multiprocess", launches, n,
                    backward=n)
    if state.step != MESH_TRAIN_STEPS or not all(
            torch.isfinite(p).all() for p in state.model.parameters()):
        raise AssertionError(f"{MESH_CONFIG} train_cli: step {state.step}")
    out["train_launches"] = launches
    del state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    printed, launches = counted(lambda: eval_cli.main([
        "--multiprocess", "--config", MESH_CONFIG,
        "--eval_pattern", params["val"], "--workdir", params["run"],
        "--notb"]))
    out["eval_cli_s"] = time.perf_counter() - t0
    res = printed[0]
    n_eval = params["n_eval"]
    batches = -(-n_eval // cfg.eval_batch_size)
    expect_launches(f"{MESH_CONFIG} eval_cli --multiprocess, 3 crops",
                    launches, batches, ycc=None)
    if res["num_examples"] != n_eval or res["step"] != MESH_TRAIN_STEPS \
            or not np.isfinite(res["mAP"]):
        raise AssertionError(f"{MESH_CONFIG} eval_cli: {res}")
    out["eval"] = res
    out["eval_launches"] = launches

    # the eval loop on injected 3-crop batches of the seeded weights
    rng = np.random.default_rng(51)
    size, b = cfg.image_size, cfg.eval_batch_size
    injected = [{"image": rng.integers(0, 256, (b, cfg.eval_multicrop, size,
                                                size, 3), np.uint8),
                 "label": rng.integers(0, spec.num_classes, b).astype(
                     np.int32),
                 "mask": np.ones(b, np.float32)}
                for _ in range(MESH_EVAL_BATCHES)]
    weights = (variables[0], variables[1])
    restored = checkpoint.EvalState(step=0, params=weights[0],
                                    batch_stats=weights[1])
    evaluator = evaluate.Evaluator(cfg, device=dev)
    evaluator.logits(restored, iter(injected))      # loads the weights
    t0 = time.perf_counter()
    host, launches = counted(lambda: evaluate.eval_logits(
        evaluator.step_fn, iter(injected), device=dev))
    wall = time.perf_counter() - t0
    expect_launches(f"{MESH_CONFIG} eval loop, 3 crops", launches,
                    MESH_EVAL_BATCHES)
    if not np.isfinite(host["logits"]).all():
        raise AssertionError(f"{MESH_CONFIG} eval logits not finite")
    out["eval_images_per_s"] = MESH_EVAL_BATCHES * b / wall
    out["eval_loop_launches"] = launches
    mesh_log(f"{MESH_CONFIG}: train_cli --multiprocess {MESH_TRAIN_STEPS} "
             f"steps in {out['train_cli_s']:.1f} s, eval_cli --multiprocess "
             f"(3 crops, {n_eval} records) {res} in "
             f"{out['eval_cli_s']:.1f} s; eval loop on injected crops "
             f"{out['eval_images_per_s']:.1f} images/s "
             f"({3 * out['eval_images_per_s']:.1f} crops/s)")
    torch.distributed.destroy_process_group()
    return out


def _probe_gloo_cuda(dev):
    """Which collectives gloo takes for CUDA tensors, by trying each."""
    import torch.distributed as dist

    world = dist.get_world_size()
    t = torch.ones(4, device=dev)
    ops = {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "all_reduce_async": lambda: dist.all_reduce(
            t.clone(), async_op=True).wait(),
        "broadcast": lambda: dist.broadcast(t.clone(), src=0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(world)], t),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=dev), t),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4 // world, device=dev), t),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(t), t),
    }
    out = {}
    for name, fn in ops.items():
        try:
            fn()
            torch.cuda.synchronize(dev)
            out[name] = "ok"
        except Exception as e:   # the answer is the probe's result
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        dist.barrier()
    return out


def gloo2_worker(workdir):
    """Two ranks on one card over gloo (NCCL refuses two ranks on one
    device), resnet_v1_50 at 96 px: DP vs one process, ZeRO-1 vs DP, TP
    of the HICO head vs one process, the one-step-late stop, the gathered
    eval of uneven shards, launches on every rank, and the DP step's time
    (gloo through the host, not NCCL)."""
    from attentionalpoolingaction_torch.parallel import mesh as mesh_lib
    from attentionalpoolingaction_torch.parallel import multihost

    with open(os.path.join(workdir, "gloo2.json")) as f:
        params = json.load(f)
    dev = multihost.setup(backend="gloo")
    rank, world = multihost.process_index(), multihost.process_count()
    out = {"rank": rank, "device": str(dev),
           "gloo_cuda": _probe_gloo_cuda(dev)}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    half = slice(rank * 4, rank * 4 + 4)
    for dataset in ("mpii", "hico"):
        cfg = config_lib.TrainConfig(dataset=dataset, **GLOO_CONFIG)
        spec = train.get_dataset(dataset)
        variables = precision.seeded_variables(cfg, 3)
        batch = precision.synthetic_batch(np.random.default_rng(52), cfg,
                                          spec)
        _, one, one_m, _ = _mesh_step(cfg, spec, variables, batch, None, dev)
        if dataset == "mpii":
            dp_mesh = mesh_lib.make_mesh((2,), ("data",))
            _, dp, dp_m, dp_l = _mesh_step(cfg, spec, variables, batch,
                                           dp_mesh, dev, half)
            z_cfg = dataclasses.replace(cfg, zero1=True)
            _, z1, z1_m, z1_l = _mesh_step(z_cfg, spec, variables, batch,
                                           dp_mesh, dev, half)
            out["dp"] = {"params": float((dp - one).abs().max()),
                         "loss": abs(dp_m["loss/total"]
                                     - one_m["loss/total"])
                         / abs(one_m["loss/total"]), "launches": dp_l}
            out["zero1"] = {"params": float((z1 - dp).abs().max()),
                            "launches": z1_l}
            expect_launches(f"rank {rank} DP step", dp_l, 1, backward=1)
            expect_launches(f"rank {rank} ZeRO-1 step", z1_l, 1, backward=1)
            if out["dp"]["params"] > GLOO_DP_RTOL or \
                    out["dp"]["loss"] > GLOO_DP_RTOL:
                raise AssertionError(f"rank {rank}: DP vs one process "
                                     f"{out['dp']}")
            if out["zero1"]["params"] > GLOO_ZERO1_ATOL:
                raise AssertionError(f"rank {rank}: ZeRO-1 vs DP "
                                     f"{out['zero1']}")
            state, _ = train.create_state(cfg, device=dev,
                                          variables=variables, mesh=dp_mesh)
            out["dp_step_ms"] = _timed_steps(
                state, train.make_train_step(spec, cfg, dp_mesh),
                {k: v[half] for k, v in batch.items()}, dev,
                GLOO_TIMED_STEPS)
            del state
        else:
            tp_cfg = dataclasses.replace(cfg, mesh_shape=(1, 2),
                                         mesh_axes=("data", "model"))
            tp_mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
            state, tp, tp_m, tp_l = _mesh_step(tp_cfg, spec, variables,
                                               batch, tp_mesh, dev)
            shard = tuple(state.model.head.attn_w.shape)
            del state
            out["tp"] = {"params": float((tp - one).abs().max()),
                         "loss": abs(tp_m["loss/total"]
                                     - one_m["loss/total"])
                         / abs(one_m["loss/total"]),
                         "attn_w_shard": shard, "launches": tp_l}
            expect_launches(f"rank {rank} TP step", tp_l, 1, backward=1)
            if shard != (2048, 300, 2) or out["tp"]["params"] > \
                    GLOO_TP_ATOL or out["tp"]["loss"] > GLOO_DP_RTOL:
                raise AssertionError(f"rank {rank}: TP vs one process "
                                     f"{out['tp']}")
    # the stop: rank 1 raises its flag after step 1; both stop at step 2
    cfg = config_lib.TrainConfig(dataset="mpii", mesh_shape=(2,),
                                 **GLOO_CONFIG)
    stop = threading.Event()

    def raise_flag(step, state, metrics):
        if rank == 1 and step == 1:
            stop.set()

    mpii = precision.synthetic_batch(np.random.default_rng(53), cfg,
                                     train.get_dataset("mpii"))
    state, _ = train.train(
        cfg, train_iter=itertools.repeat(
            {k: v[half] for k, v in mpii.items()}),
        num_steps=4, device=dev, hooks=[raise_flag], stop_event=stop)
    out["stopped_at"] = state.step
    del state
    # the gathered eval of 5 records (3 and 2 rows)
    ecfg = config_lib.TrainConfig(dataset="mpii", eval_pattern=params["val"],
                                  seed=4, **GLOO_CONFIG)
    estate, _ = train.create_state(ecfg, device=dev)
    res, launches = counted(lambda: evaluate.evaluate(ecfg, estate,
                                                      device=dev))
    out["eval"] = {"mAP": res["mAP"], "num_examples": res["num_examples"],
                   "launches": launches}
    torch.distributed.destroy_process_group()
    return out


def mesh_serving(cfg, run_dir, datas, card):
    """``serve_cli --data_parallel`` over the run's checkpoint: one card is
    single-device dispatch (JAX's rule), ``/healthz`` says so; a few
    ``/predict`` calls, counted."""
    args = serve_cli.parse_args(["--config", MESH_CONFIG, "--workdir",
                                 run_dir, "--data_parallel"])
    pred = serve_cli.load_served(args)
    n_cards = torch.cuda.device_count()
    if (len(pred.replicas) > 1) != (n_cards > 1):
        raise AssertionError(f"--data_parallel on {n_cards} card(s): "
                             f"replicas {pred.replicas}")
    pred.warmup()
    out = {"replicas": len(pred.replicas), "buckets": list(pred.buckets)}
    with HttpServer(pred) as srv:
        conn = http_conn(srv.port)
        status, _, body = http_call(conn, "GET", "/healthz")
        health = json.loads(body)
        if status != 200 or health["data_parallel"] != bool(pred.replicas):
            raise AssertionError(f"/healthz: {status} {health}")

        def predict():
            answers = []
            for data in datas[:4]:
                status, _, body = http_call(conn, "POST", "/predict", data)
                answers.append((status, json.loads(body)))
            return answers

        t0 = time.perf_counter()
        answers, launches = counted(predict)
        wall = time.perf_counter() - t0
    if any(s != 200 or len(a["topk"]) != 5 for s, a in answers):
        raise AssertionError(f"serve_cli --data_parallel: {answers}")
    expect_launches(f"{MESH_CONFIG} /predict x4", launches, 4, ycc=None)
    out.update(health=health, launches=launches,
               predict_ms=wall / len(answers) * 1e3)
    log(f"{MESH_CONFIG} serve_cli --data_parallel on {n_cards} card(s) "
        f"({card}): {len(pred.replicas)} replicas, /healthz data_parallel "
        f"{health['data_parallel']}, 4 /predict calls at "
        f"{out['predict_ms']:.1f} ms each (one client); launches {launches}")
    return out


def phase_mesh(card):
    """Config #5 through the mesh entry points on one card, and the mesh
    paths over two gloo ranks; see the module docstring, phase 10."""
    t_phase = time.monotonic()
    names, datas, _, _ = load_fixtures()
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        cfg = config_lib.get_config(MESH_CONFIG)
        n_eval = 16
        paths = config_records(d, MESH_CONFIG, datas, 2 * cfg.batch_size,
                               n_eval, cfg.image_size)
        run_dir = os.path.join(d, "run5")
        params = {"train": paths["train"], "val": paths["val"],
                  "run": run_dir, "n_eval": n_eval, "card": card,
                  "init": seeded_init(MESH_CONFIG, d, 0)}
        torch.cuda.empty_cache()
        with open(os.path.join(d, "mesh5.json"), "w") as f:
            json.dump(params, f)
        (res5,), _ = run_mesh_workers("mesh5", 1, d, timeout=420)
        if res5["backend"] != "nccl" or res5["world"] != 1:
            raise AssertionError(f"mesh5 worker: {res5}")
        out["config5"] = {"card": card, **res5}
        out["config5"]["serve"] = mesh_serving(cfg, run_dir, datas, card)

        spec = train.get_dataset("mpii")
        val = os.path.join(d, "gloo_val.tfrecord")
        records.write_synthetic_dataset(
            val, spec, 5, image_size=GLOO_SIZE, seed=12,
            encode_jpeg=fixture_encoder(datas))
        native_io.build_index(val)
        with open(os.path.join(d, "gloo2.json"), "w") as f:
            json.dump({"val": val}, f)
        ranks, _ = run_mesh_workers("gloo2", 2, d, timeout=300)
        torch.backends.cudnn.allow_tf32 = False
        try:
            ecfg = config_lib.TrainConfig(dataset="mpii", eval_pattern=val,
                                          seed=4, **GLOO_CONFIG)
            estate, _ = train.create_state(ecfg, device="cuda")
            alone = evaluate.evaluate(ecfg, estate, device="cuda")
        finally:
            torch.backends.cudnn.allow_tf32 = True
    for r in ranks:
        if r["stopped_at"] != 2:
            raise AssertionError(f"rank {r['rank']} stopped at step "
                                 f"{r['stopped_at']}, not 2")
        if r["eval"]["num_examples"] != 5 or abs(
                r["eval"]["mAP"] - alone["mAP"]) > GLOO_MAP_ATOL:
            raise AssertionError(f"rank {r['rank']}: gathered eval "
                                 f"{r['eval']} vs one process {alone}")
        expect_launches(f"rank {r['rank']} gathered eval",
                        r["eval"]["launches"], 2 - r["rank"])
    out["gloo2"] = {"card": card, "times": "gloo through the host, not NCCL",
                    "ranks": ranks, "one_process_mAP": alone["mAP"]}
    out["phase_s"] = time.monotonic() - t_phase
    for r in ranks:
        log(f"gloo rank {r['rank']} of 2 on one card: collectives on CUDA "
            f"tensors {r['gloo_cuda']}; DP vs one process "
            f"{r['dp']['params']:.3e} "
            f"(loss {r['dp']['loss']:.3e}), ZeRO-1 vs DP "
            f"{r['zero1']['params']:.3e}, TP (1, 2) vs one process "
            f"{r['tp']['params']:.3e}, stop at step {r['stopped_at']}, "
            f"gathered mAP {r['eval']['mAP']!r} (one process "
            f"{alone['mAP']!r}); DP step {r['dp_step_ms']:.1f} ms (gloo "
            "through the host, not NCCL)")
    log(f"phase 10 took {out['phase_s']:.1f} s (workdir removed)")
    return out


# -- phase 11: from raw data --------------------------------------------------

RAW_MPII_IMAGES = 64
RAW_ACT_IDS = (1, 2, 5, 9, 40, 77, 397)   # sparse, with gaps, as MPII's
RAW_HICO_IMAGES = 12                      # a split
RAW_SHARDS = 2
RAW_STEPS = 4
RAW_STOP = 3             # SIGTERM as step 3 starts: step 2's save in flight
REMAT_ROUNDS = 3
REPLICA_PROB_ATOL = 1e-6


def struct_array(fields, rows):
    """A MATLAB struct array of ``rows`` (dicts) for ``scipy.io.savemat``."""
    a = np.zeros((1, len(rows)), dtype=[(f, "O") for f in fields])
    for i, row in enumerate(rows):
        for f in fields:
            a[0, i][f] = row[f]
    return a


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def write_raw_mpii(d, datas):
    """An MPII release in small: ``RAW_MPII_IMAGES`` images named after
    copies of the JPEG fixtures (fixture 0 under EXIF orientation 6, whose
    frame header is not its displayed size) and an annotation ``.mat``
    with ``annolist`` (``image.name``, ``annorect.annopoints.point`` with
    ``id/x/y/is_visible``; some images without a person), ``act.act_id``
    (sparse ids, some -1) and ``img_train``."""
    import scipy.io

    rng = np.random.default_rng(110)
    images = os.path.join(d, "mpii_images")
    os.makedirs(images)
    annolist, acts, flags = [], [], []
    for i in range(RAW_MPII_IMAGES):
        k = i % len(datas)
        data = with_orientation(datas[k], 6) if k == 0 else datas[k]
        name = f"{i:09d}.jpg"
        with open(os.path.join(images, name), "wb") as f:
            f.write(data)
        h, w = jpeg.frame_size(data)
        joints = sorted(rng.choice(16, int(rng.integers(4, 17)), False))
        points = struct_array(("id", "x", "y", "is_visible"), [
            {"id": int(j), "x": float(rng.uniform(0, w)),
             "y": float(rng.uniform(0, h)), "is_visible": int(j % 3 != 0)}
            for j in joints])
        rect = (np.zeros((0, 0)) if i % 9 == 4 else struct_array(
            ("annopoints",), [{"annopoints": {"point": points}}]))
        annolist.append({"image": {"name": name}, "annorect": rect})
        acts.append({"act_id": -1 if i % 11 == 3
                     else int(RAW_ACT_IDS[int(rng.integers(len(RAW_ACT_IDS)))])})
        flags.append(0 if i % 13 == 5 else 1)
    mat = os.path.join(d, "mpii_release.mat")
    scipy.io.savemat(mat, {"RELEASE": {
        "annolist": struct_array(("image", "annorect"), annolist),
        "act": struct_array(("act_id",), acts),
        "img_train": np.asarray(flags, np.float64)[None]}})
    return mat, images


def write_raw_hico(d, datas):
    """HICO in small: ``RAW_HICO_IMAGES`` images a split under
    ``train2015/`` and ``test2015/`` (copies of the fixtures, fixture 0
    under EXIF orientation 6) and an ``anno.mat`` whose 600 x N matrices
    hold +1, -1, 0 and NaN."""
    import scipy.io

    rng = np.random.default_rng(111)
    root = os.path.join(d, "hico_images")
    mat, annos = {}, {}
    for split, sub in (("train", "train2015"), ("test", "test2015")):
        os.makedirs(os.path.join(root, sub))
        names = []
        for i in range(RAW_HICO_IMAGES):
            k = (i + (split == "test")) % len(datas)
            data = with_orientation(datas[k], 6) if k == 0 else datas[k]
            names.append(f"HICO_{split}2015_{i:08d}.jpg")
            with open(os.path.join(root, sub, names[-1]), "wb") as f:
                f.write(data)
        anno = rng.choice([1.0, -1.0, 0.0, np.nan], (600, RAW_HICO_IMAGES),
                          p=[0.02, 0.08, 0.85, 0.05])
        mat[f"list_{split}"] = np.array(names, dtype=object)[:, None]
        mat[f"anno_{split}"] = anno
        annos[split] = anno
    path = os.path.join(d, "hico_anno.mat")
    scipy.io.savemat(path, mat)
    return path, root, annos


def shard_records(out, split):
    """The records of ``split`` in the converter's shards, in file order."""
    paths = sorted(glob.glob(os.path.join(out, f"{split}-*.tfrecord")))
    if len(paths) != RAW_SHARDS:
        raise AssertionError(f"{split} shards: {paths}")
    return [r for p in paths for r in records.read_tfrecord(p)]


def check_frame_sizes(what, recs):
    """Each record's height and width are its JPEG's frame header's, as
    ``tf.io.extract_jpeg_shape`` gives them; returns how many differ from
    the displayed size (the oriented fixture)."""
    swapped = 0
    for raw in recs:
        feats = records.decode_example(raw)
        data = feats["image/encoded"][0]
        hw = (int(feats["image/height"][0]), int(feats["image/width"][0]))
        if hw != jpeg.frame_size(data):
            raise AssertionError(f"{what}: record size {hw}, frame header "
                                 f"{jpeg.frame_size(data)}")
        swapped += hw != jpeg.image_size(data)
    return swapped


def convert_mpii_raw(d, datas):
    """``convert_mpii`` over the raw release; its records against the
    annotation parsed here: counts a split, labels by the label map,
    keypoints, frame sizes."""
    import scipy.io

    from attentionalpoolingaction_torch.data import convert_mpii

    mat, images = write_raw_mpii(d, datas)
    out = os.path.join(d, "mpii_records")
    t0 = time.perf_counter()
    run_module("data.convert_mpii", [
        "--mat", mat, "--images_dir", images, "--out_dir", out,
        "--shards", str(RAW_SHARDS)])
    wall = time.perf_counter() - t0
    entries = convert_mpii.parse_mpii_mat(scipy.io.loadmat(
        mat, squeeze_me=True, struct_as_record=False)["RELEASE"])
    label_map = convert_mpii.build_label_map(entries)
    if sorted(label_map) != sorted(set(RAW_ACT_IDS)) or \
            list(label_map.values()) != list(range(len(RAW_ACT_IDS))):
        raise AssertionError(f"label map {label_map}")
    spec = train.get_dataset("mpii")
    out_counts = {}
    swapped = 0
    for split in ("train", "val"):
        want = [e for e in entries if e["is_train"] and e["act_id"] >= 0
                and convert_mpii.assign_split(e["image_name"], 0.315)
                == split]
        recs = shard_records(out, split)
        got = sorted((int(p["label"]), p["keypoints"].tobytes())
                     for p in (records.parse_example(r, spec) for r in recs))
        exp = sorted((label_map[e["act_id"]],
                      (e["keypoints"] if e["keypoints"] is not None else
                       np.full((16, 2), -1.0, np.float32)).tobytes())
                     for e in want)
        if got != exp:
            raise AssertionError(f"convert_mpii {split}: {len(got)} records "
                                 f"vs {len(exp)} labeled images")
        swapped += check_frame_sizes(f"convert_mpii {split}", recs)
        out_counts[split] = len(recs)
    if not swapped:
        raise AssertionError("no record of the oriented fixture")
    log(f"convert_mpii (a subprocess, {wall:.1f} s): {RAW_MPII_IMAGES} "
        f"images -> {out_counts} records of {len(label_map)} classes (act "
        f"ids {sorted(label_map)}), labels and keypoints as parsed, every "
        f"height and width the frame header's ({swapped} oriented records "
        "whose displayed size differs)")
    return {"records": out_counts, "classes": len(label_map),
            "oriented_records": swapped, "convert_s": wall,
            "train": os.path.join(out, "train-*.tfrecord"),
            "val": os.path.join(out, "val-*.tfrecord")}


def convert_hico_raw(d, datas):
    """``convert_hico`` over the raw ``anno.mat``: counts, multi-hot and
    known labels, frame sizes; the test split through the eval pipeline on
    the card."""
    mat, root, annos = write_raw_hico(d, datas)
    out = os.path.join(d, "hico_records")
    t0 = time.perf_counter()
    convert_hico.main(["--mat", mat, "--images_dir", root, "--out_dir", out,
                       "--shards", str(RAW_SHARDS)])
    wall = time.perf_counter() - t0
    spec = train.get_dataset("hico")
    # round-robin shards read in file order: even items, then odd ones
    order = [i for s in range(RAW_SHARDS)
             for i in range(s, RAW_HICO_IMAGES, RAW_SHARDS)]
    for split, anno in annos.items():
        recs = shard_records(out, split)
        clean = np.nan_to_num(anno[:, order])
        got = [records.parse_example(r, spec, include_anno=True)
               for r in recs]
        if len(got) != RAW_HICO_IMAGES or not all(
                np.array_equal(g["label"], clean[:, j] > 0)
                and np.array_equal(g["anno"], np.sign(clean[:, j]))
                for j, g in enumerate(got)):
            raise AssertionError(f"convert_hico {split}: labels differ")
        check_frame_sizes(f"convert_hico {split}", recs)
    batches = list(grain_pipeline.make_eval_dataset(
        os.path.join(out, "test-*.tfrecord"), spec, batch_size=8,
        image_size=224, device="cuda"))
    labels = np.concatenate([host(b["label"])[host(b["mask"]) > 0]
                             for b in batches])
    if not np.array_equal(labels, np.nan_to_num(annos["test"][:, order]).T
                          > 0) or batches[0]["image"].device.type != "cuda":
        raise AssertionError("convert_hico: the eval pipeline's labels")
    log(f"convert_hico ({wall:.1f} s): {RAW_HICO_IMAGES} "
        f"train and {RAW_HICO_IMAGES} test images of 600 classes, multi-hot "
        "and known labels as the .mat, frame sizes; the test split read "
        "back through the eval pipeline on the card")
    return {"records": RAW_HICO_IMAGES * 2, "convert_s": wall}


def convert_hmdb_raw(d, datas):
    """``convert_hmdb`` where OpenCV is installed: MJPG videos of fixture
    frames, converted, read back through the eval pipeline on the card,
    each frame's card decode within the decode gate of OpenCV's.  Where
    it is not, the converter fails as the JAX package's does."""
    cv2_installed = importlib.util.find_spec("cv2") is not None
    log(f"cv2_installed {cv2_installed}")
    root = os.path.join(d, "hmdb_videos")
    splits = os.path.join(d, "hmdb_splits")
    out = os.path.join(d, "hmdb_records")
    os.makedirs(splits)
    with open(os.path.join(splits, "run_test_split1.txt"), "w") as f:
        f.write("v0.avi 1\nv1.avi 2\n")
    with open(os.path.join(splits, "walk_test_split1.txt"), "w") as f:
        f.write("v2.avi 1\nv3.avi 0\n")
    args = ["--videos_dir", root, "--splits_dir", splits, "--out_dir", out,
            "--frames_per_video", "4", "--shards", str(RAW_SHARDS)]
    if not cv2_installed:
        try:
            convert_hmdb.main(args)
        except ModuleNotFoundError as e:
            if e.name != "cv2":
                raise
        else:
            raise AssertionError("convert_hmdb without OpenCV succeeded")
        log("convert_hmdb without OpenCV: fails with the JAX package's "
            "ModuleNotFoundError (No module named 'cv2')")
        return {"cv2_installed": False}
    import cv2

    frames = [cv2.resize(cv2.imdecode(np.frombuffer(x, np.uint8),
                                      cv2.IMREAD_COLOR), (320, 240))
              for x in datas]
    for v, cls in enumerate(("run", "run", "walk", "walk")):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        w = cv2.VideoWriter(os.path.join(root, cls, f"v{v}.avi"),
                            cv2.VideoWriter_fourcc(*"MJPG"), 10, (320, 240))
        for i in range(10):
            w.write(frames[(v + i) % len(frames)])
        w.release()
    t0 = time.perf_counter()
    convert_hmdb.main(args)
    wall = time.perf_counter() - t0
    spec = train.get_dataset("hmdb51")
    gaps = []
    for split, want in (("train", [(0, 0), (1, 1)]), ("test", [(0, 0)])):
        recs = shard_records(out, split)
        batches = list(grain_pipeline.make_eval_dataset(
            os.path.join(out, f"{split}-*.tfrecord"), spec, batch_size=16,
            image_size=224, device="cuda"))
        mask = np.concatenate([host(b["mask"]) for b in batches])
        ids = np.concatenate([host(b["video_id"]) for b in batches])[mask > 0]
        labels = np.concatenate([host(b["label"]) for b in batches])[mask > 0]
        got = sorted(set(zip(ids.tolist(), labels.tolist())))
        if len(recs) != 4 * len(want) or got != want or \
                sorted(ids.tolist()) != sorted([v for v, _ in want] * 4):
            raise AssertionError(f"convert_hmdb {split}: {len(recs)} records,"
                                 f" videos/labels {got}")
        for raw in recs:
            data = records.decode_example(raw)["image/encoded"][0]
            card = jpeg.decode([data], "cuda")[0].cpu().numpy()
            opencv = cv2.cvtColor(cv2.imdecode(
                np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                cv2.COLOR_BGR2RGB)
            gaps.append(float(np.abs(card.astype(np.int16) - opencv).mean()))
    if max(gaps) > DECODE_MEAN_LEVELS:
        raise AssertionError(f"convert_hmdb frames: decode gaps {gaps}")
    log(f"convert_hmdb ({wall:.1f} s): 4 videos of 10 MJPG "
        "frames, 4 frames each -> 8 train and 4 test records (the unused "
        "video skipped), read back through the eval pipeline on the card; "
        f"card decode vs OpenCV mean |d| <= {max(gaps):.3f} levels")
    return {"cv2_installed": True, "convert_s": wall,
            "max_decode_gap": max(gaps)}


@contextlib.contextmanager
def sigterm_as_step_starts(step_no, digests):
    """``train.train``'s steps digest their batches into ``digests``; a
    real SIGTERM is sent once, as step ``step_no`` starts (the step
    finishes, is saved and the run returns)."""
    make = train.make_train_step
    fired = []

    def make_stopping(spec, cfg, mesh=None):
        step = make(spec, cfg, mesh)

        def step_fn(state, batch):
            if state.step == step_no - 1 and not fired:
                fired.append(step_no)
                os.kill(os.getpid(), signal.SIGTERM)
            digests.append(batch_digest(batch))
            return step(state, batch)
        return step_fn

    train.make_train_step = make_stopping
    try:
        yield
    finally:
        train.make_train_step = make


def raw_train_and_eval(paths, run_dir, n_val):
    """``train_cli --config mpii_rank1_224 --set remat_units=true`` from
    the converted records, saving every 2 steps, with a real SIGTERM
    right after step 2's save; resumed to ``RAW_STEPS``; against
    ``train.train`` of the same config straight (losses and batches bit
    for bit, cuDNN deterministic); then ``eval_cli`` of the converted val
    split.  Each CLI counted."""
    cfg = config_lib.get_config(
        "mpii_rank1_224", train_pattern=paths["train"], log_every=1,
        checkpoint_every=1000, remat_units=True)
    args = ["--config", "mpii_rank1_224", "--set", "remat_units=true",
            "--train_pattern", paths["train"], "--workdir", run_dir,
            "--num_steps", str(RAW_STEPS), "--set", "checkpoint_every=2",
            "--set", "log_every=1"]
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        straight_d, cut_d = [], []
        with digesting(straight_d):
            state, hist = train.train(cfg, num_steps=RAW_STEPS,
                                      device="cuda")
        del state
        mgr = checkpoint.make_manager(os.path.join(run_dir, "checkpoints"))
        t0 = time.perf_counter()
        with sigterm_as_step_starts(RAW_STOP, cut_d):
            (first, kept), launches = counted(lambda: (
                train_cli.main(args).step, mgr.all_steps()))
            (second, launches2) = counted(lambda: train_cli.main(args).step)
        out["train_cli_s"] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    launches = {k: launches[k] + launches2[k] for k in launches}
    want = [np.float32(h["loss/total"]) for h in hist]
    got = [np.float32(v) for _, v in read_scalars(run_dir)["loss/total"]]
    if first != RAW_STOP or kept != [2, RAW_STOP] or second != RAW_STEPS \
            or mgr.all_steps() != [2, RAW_STOP, RAW_STEPS] or \
            got != want or cut_d != straight_d:
        raise AssertionError(
            f"train_cli from converted records: stopped at {first} with "
            f"steps {kept}, resumed to {second} with {mgr.all_steps()}; "
            f"losses {got} vs {want}; batches equal {cut_d == straight_d}")
    expect_launches("train_cli from converted records", launches, RAW_STEPS,
                    backward=RAW_STEPS)
    if launches["ycc_to_rgb"] < 1:
        raise AssertionError(f"train_cli decoded no colour image: {launches}")
    out["train_launches"] = launches
    out["losses"] = [float(v) for v in want]
    t0 = time.perf_counter()
    printed, launches = counted(lambda: eval_cli.main([
        "--config", "mpii_rank1_224", "--workdir", run_dir,
        "--eval_pattern", paths["val"]]))
    out["eval_cli_s"] = time.perf_counter() - t0
    batches = -(-n_val // config_lib.get_config("mpii_rank1_224")
                .eval_batch_size)
    expect_launches(f"eval_cli: {batches} batches", launches, batches)
    line = printed[-1]
    if line["step"] != RAW_STEPS or line["num_examples"] != n_val:
        raise AssertionError(f"eval_cli printed {line}")
    out["eval_launches"] = launches
    out["eval_cli"] = line
    log(f"train_cli --set remat_units=true from the converted records: "
        f"SIGTERM as step {RAW_STOP} started (step 2's save in flight), "
        f"stopped at {first} with steps {kept}, resumed to {second}: losses "
        "and batch digests equal train.train's straight run bit for bit; "
        + ", ".join(f"{v:.4f}" for v in out["losses"])
        + f"; {out['train_cli_s']:.1f} s; launches {out['train_launches']}")
    log(f"eval_cli of the converted val split: {line}; launches "
        f"{launches}")
    return out


def remat_against_plain(name, rounds, compare):
    """``name``'s train step with and without ``remat_units`` at full
    width from seeded weights and batch.  With ``compare``: the remat
    step against the plain one from the same state (cuDNN deterministic),
    within the gap of two plain steps measured beside it, parameters and
    running statistics.  Then, with cuDNN's defaults, one state stepped
    in turns with remat off and on: median ms and
    ``torch.cuda.max_memory_allocated`` of each."""
    cfg = config_lib.get_config(name)
    spec = train.get_dataset(cfg.dataset)
    variables = precision.seeded_variables(cfg, 11)
    batch = train.batch_to_device(precision.synthetic_batch(
        np.random.default_rng(112), cfg, spec), "cuda")
    out = {"config": name}
    if compare:
        torch.backends.cudnn.deterministic = True
        try:
            runs = []
            for remat in (False, False, True):
                c = dataclasses.replace(cfg, remat_units=remat)
                state, _ = train.create_state(c, device="cuda",
                                              variables=variables)
                _, m = train.make_train_step(spec, c)(state, batch)
                sd = state.model.state_dict()
                stats = torch.cat([v.reshape(-1) for k, v in sd.items()
                                   if k.endswith(("running_mean",
                                                  "running_var"))])
                runs.append((_flat_params(state), stats,
                             float(m["loss/total"])))
                del state
        finally:
            torch.backends.cudnn.deterministic = False
        (a, sa, la), (b, sb, lb), (r, sr, lr) = runs
        out.update(
            gap_params=float((a - b).abs().max()),
            gap_stats=float((sa - sb).abs().max()), gap_loss=abs(la - lb),
            remat_params=float((r - a).abs().max()),
            remat_stats=float((sr - sa).abs().max()),
            remat_loss=abs(lr - la))
        if out["remat_params"] > out["gap_params"] or \
                out["remat_stats"] > out["gap_stats"] or \
                out["remat_loss"] > out["gap_loss"]:
            raise AssertionError(f"{name}: remat step vs plain {out}")
    state, _ = train.create_state(cfg, device="cuda", variables=variables)
    step = train.make_train_step(spec, cfg)
    times = {False: [], True: []}
    memory = {False: 0, True: 0}
    for r in range(rounds + 1):
        for remat in ((False, True) if r % 2 else (True, False)):
            state.model.resnet.remat_units = remat
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            if r:                              # round 0 warms both up
                times[remat].append(time.perf_counter() - t0)
                memory[remat] = max(memory[remat],
                                    torch.cuda.max_memory_allocated())
    del state
    torch.cuda.empty_cache()
    for remat, key in ((False, "plain"), (True, "remat")):
        out[f"{key}_ms"] = float(np.median(times[remat])) * 1e3
        out[f"{key}_max_allocated"] = memory[remat]
    log(f"{name} (batch {cfg.batch_size}, {cfg.image_size} px"
        f"{', bf16' if cfg.bf16_backbone else ''}) step with remat_units: "
        f"{out['remat_ms']:.1f} ms and {out['remat_max_allocated'] / 2**30:.2f}"
        f" GiB max allocated, without: {out['plain_ms']:.1f} ms and "
        f"{out['plain_max_allocated'] / 2**30:.2f} GiB (medians of "
        f"{rounds}, in turns)"
        + (f"; remat vs plain from one state (cuDNN deterministic): "
           f"params {out['remat_params']:.3e}, running statistics "
           f"{out['remat_stats']:.3e}, loss {out['remat_loss']:.3e}; the gap "
           f"of two plain steps {out['gap_params']:.3e} / "
           f"{out['gap_stats']:.3e} / {out['gap_loss']:.3e}"
           if compare else ""))
    return out


def async_saves(workdir, card):
    """The 347 MB state of config #1 (after a step: momentum) saved by the
    asynchronous manager: what blocks the step thread (the call, then
    the card's copy into pinned memory) against the whole write; steps
    taken while a write is in flight against steps without one; the step
    restored after ``wait_until_finished`` bitwise equal to the state at
    the save, though the live state stepped on."""
    cfg = config_lib.get_config("mpii_rank1_224")
    spec = train.get_dataset(cfg.dataset)
    state, _ = train.create_state(cfg, device="cuda",
                                  variables=precision.seeded_variables(cfg, 12))
    step = train.make_train_step(spec, cfg)
    batch = train.batch_to_device(precision.synthetic_batch(
        np.random.default_rng(113), cfg, spec), "cuda")
    step(state, batch)
    mgr = checkpoint.make_manager(os.path.join(workdir, "async"),
                                  max_to_keep=2)
    reps = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(mgr, state)
        t_call = time.perf_counter()
        torch.cuda.synchronize()
        t_copy = time.perf_counter()
        if i == 2:
            want = {k: v.clone() for k, v in state_tensors(state)[0].items()}
            saved_step = state.step
            during = []
            for _ in range(3):
                s0 = time.perf_counter()
                step(state, batch)
                torch.cuda.synchronize()
                during.append(time.perf_counter() - s0)
        mgr.wait_until_finished()
        t_done = time.perf_counter()
        reps.append({"call_s": t_call - t0, "blocking_s": t_copy - t0,
                     "whole_s": t_done - t0})
        if i < 2:
            step(state, batch)
    alone = []
    for _ in range(3):
        s0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        alone.append(time.perf_counter() - s0)
    fresh, _ = train.create_state(cfg, device="cuda")
    checkpoint.restore(mgr, fresh, step=saved_step)
    got, got_step = state_tensors(fresh)
    if got_step != saved_step or got.keys() != want.keys() or not all(
            torch.equal(got[k], want[k]) for k in want):
        raise AssertionError("async save: the restored step differs from "
                             "the state at its save")
    nbytes = os.path.getsize(mgr.step_dir(saved_step)
                             / checkpoint.CHECKPOINT_FILE)
    out = {"bytes": nbytes, "saves": reps,
           "step_ms_during_write": float(np.median(during)) * 1e3,
           "step_ms_alone": float(np.median(alone)) * 1e3, "card": card}
    del state, fresh
    log(f"async saves of {nbytes} bytes ({card}): the step thread blocked "
        + ", ".join(f"{r['blocking_s'] * 1e3:.1f} ms (call "
                    f"{r['call_s'] * 1e3:.1f})" for r in reps)
        + " against whole writes of "
        + ", ".join(f"{r['whole_s']:.3f} s" for r in reps)
        + " (the first save allocates the pinned buffers); steps while the "
        f"write runs {out['step_ms_during_write']:.1f} ms, without "
        f"{out['step_ms_alone']:.1f} ms; restored after the wait bitwise "
        "equal to the state at the save")
    return out


def replica_graphs(card):
    """R2 on one card: two replicas on ``cuda:0`` through CUDA graphs.
    ``mpii_rank1_224`` float (TF32 off): probabilities against the eager
    one-device path within ``REPLICA_PROB_ATOL``, launches by the replay
    rule, a reload captured again; int8 with per-example scales and an
    ``hmdb51_clip8`` clip against eager dispatch of the same split; bucket
    32 on one device eager against the two replicas, in turns."""
    devices = ["cuda:0", "cuda:0"]
    out = {"card": card}
    cfg = config_lib.get_config("mpii_rank1_224")
    variables = precision.seeded_variables(cfg, 0)
    images = np.random.default_rng(114).integers(
        0, 256, (40, cfg.image_size, cfg.image_size, 3), np.uint8)
    torch.backends.cudnn.allow_tf32 = False
    try:
        one = serving.Predictor(cfg, *variables, buckets=(1, 8, 32))
        two = serving.Predictor(cfg, *variables, buckets=(1, 8, 32),
                                data_parallel=True, devices=devices)
        if two._replica_graphs != {}:
            raise AssertionError("replicas on a card dispatch eagerly")
        t0 = time.perf_counter()
        two.warmup()
        out["capture_s"] = time.perf_counter() - t0
        out["graphs"] = len(two._replica_graphs)
        want = one.predict_arrays(images)
        got, launches = counted(lambda: two.predict_arrays(images))
        out["max_abs_dprob"] = float(np.abs(got - want).max())
        # 40 images: buckets 32 and 8, each split over the two replicas
        expect_launches("two graphed replicas, 40 images", launches, 4,
                        ycc=0)
        out["launches"] = launches
        other = precision.seeded_variables(cfg, 1)
        one.reload(*other)
        two.reload(*other)
        out["reload_max_abs_dprob"] = float(np.abs(
            two.predict_arrays(images) - one.predict_arrays(images)).max())
        if max(out["max_abs_dprob"], out["reload_max_abs_dprob"]) > \
                REPLICA_PROB_ATOL or out["graphs"] != 6:
            raise AssertionError(f"graphed replicas: {out}")
        # timed with serving's TF32 convs (captured again under them)
        torch.backends.cudnn.allow_tf32 = True
        two.reload(*other)
        times = ([], [])
        batch = images[:32]
        for p in (one, two):
            p.predict_arrays(batch)
        for _ in range(4):
            for i in (0, 1, 1, 0):
                t0 = time.perf_counter()
                (one, two)[i].predict_arrays(batch)
                times[i].append(time.perf_counter() - t0)
        out["one_device_ms"] = float(np.median(times[0])) * 1e3
        out["replicas_ms"] = float(np.median(times[1])) * 1e3
        torch.backends.cudnn.allow_tf32 = False
        del one, two
        # int8 (per-example scales) and a clip: graphs vs eager dispatch
        for what, c, kw in (("int8", cfg, {"int8": True}),
                            ("clip", config_lib.get_config("hmdb51_clip8"),
                             {})):
            v = precision.seeded_variables(c, 2)
            graphed, eager = (serving.Predictor(
                c, *v, buckets=(8,), data_parallel=True, devices=devices,
                **kw) for _ in range(2))
            eager._replica_graphs = None
            if what == "int8":
                x = images[:8]
                a, b = graphed.predict_arrays(x), eager.predict_arrays(x)
            else:
                frames = np.random.default_rng(115).integers(
                    0, 256, (1, c.clip_frames, c.image_size, c.image_size, 3),
                    np.uint8)
                graphed._fwd(graphed._weights, frames)      # captures
                a, n2 = counted(lambda: graphed._probs(graphed._fwd(
                    graphed._weights, frames)))
                expect_launches("a graphed clip", n2, 1, ycc=0)
                b = eager._probs(eager._fwd(eager._weights, frames))
            out[f"{what}_max_abs_dprob"] = float(np.abs(a - b).max())
            if out[f"{what}_max_abs_dprob"] > REPLICA_PROB_ATOL:
                raise AssertionError(f"graphed {what} vs eager: {out}")
            del graphed, eager
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.cuda.empty_cache()
    log(f"data-parallel serving through CUDA graphs, two replicas on one "
        f"card ({card}, TF32 off): {out['graphs']} graphs captured in "
        f"{out['capture_s']:.1f} s; probabilities {out['max_abs_dprob']:.3e} "
        f"from the eager one-device path (after a reload "
        f"{out['reload_max_abs_dprob']:.3e}); int8 {out['int8_max_abs_dprob']:.3e}"
        f" and a clip {out['clip_max_abs_dprob']:.3e} from eager dispatch; "
        f"launches {out['launches']} (each replay adds its capture's); "
        f"bucket 32 (TF32 convs): {out['replicas_ms']:.1f} ms a call vs "
        f"{out['one_device_ms']:.1f} ms eager on one device (median of 8, "
        "in turns)")
    return out


def phase_raw(card):
    """From raw data to a trained, checkpointed, evaluated model; see the
    module docstring, phase 11."""
    t_phase = time.monotonic()
    _, datas, _, _ = load_fixtures()
    out = {"card": card}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_raw_") as d:
        mpii = convert_mpii_raw(d, datas)
        out["convert"] = {"mpii": {k: v for k, v in mpii.items()
                                   if k not in ("train", "val")},
                          "hico": convert_hico_raw(d, datas),
                          "hmdb": convert_hmdb_raw(d, datas)}
        out["clis"] = raw_train_and_eval(mpii, os.path.join(d, "run"),
                                         mpii["records"]["val"])
        out["remat1"] = remat_against_plain("mpii_rank1_224", REMAT_ROUNDS,
                                            compare=True)
        out["remat5"] = remat_against_plain(MESH_CONFIG, REMAT_ROUNDS,
                                            compare=False)
        out["async_save"] = async_saves(d, card)
    out["replicas"] = replica_graphs(card)
    out["phase_s"] = time.monotonic() - t_phase
    log(f"phase 11 took {out['phase_s']:.1f} s (workdir removed)")
    return out


# -- phase 12 ----------------------------------------------------------------

AR_FIXTURE = os.path.join(FIXTURES, "jax_written.array_record")
# tests/fixtures_torch/make_fixtures.py's ARRAY_RECORD_EXAMPLES
AR_FIXTURE_EXAMPLES = ("mpii_a_1280x720.jpg", "mpii_b_1280x720.jpg",
                       "gray_400x300.jpg")
AR_STEPS = 4
AR_VIDEOS, AR_FRAMES = 6, 4


def ar_fixture_examples():
    """The examples that make_fixtures.py's ``array_record_examples``
    writes: JPEG i of ``AR_FIXTURE_EXAMPLES``, label ``7 i + 3``, keypoints
    ``(i + 1) * arange(32)``, every joint visible."""
    out = []
    for i, name in enumerate(AR_FIXTURE_EXAMPLES):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        h, w = jpeg.image_size(data)
        out.append(records.make_example(
            data, height=h, width=w, label=7 * i + 3,
            keypoints=(i + 1) * np.arange(32, dtype=np.float32),
            visibility=np.ones(16, np.float32)))
    return out


def check_array_record_fixture():
    """The file that the JAX package's writer made, read by the port's
    codec with every hash verified: the expected examples, byte for byte;
    their JPEGs decoded on the card, equal to a decode of the fixture
    files."""
    t0 = time.perf_counter()
    f = array_record.ArrayRecordFile(AR_FIXTURE, verify_hash=True)
    got = [f[i] for i in range(len(f))]
    read_s = time.perf_counter() - t0
    want = ar_fixture_examples()
    if got != want or f.writer_options != array_record.writer_options(1):
        raise AssertionError(
            f"{AR_FIXTURE}: {len(got)} records of {[len(r) for r in got]} "
            f"bytes, options {f.writer_options!r}; want "
            f"{[len(r) for r in want]} bytes, equal: "
            f"{[g == w for g, w in zip(got, want)]}")
    if len(got[0]) <= array_record.BLOCK_SIZE:
        raise AssertionError("no record of the fixture spans a block")
    spec = train.get_dataset("mpii")
    images = [records.parse_example(r, spec)["image_bytes"] for r in got]
    dev = torch.device("cuda")
    decoded, launches = counted(lambda: jpeg.decode(images, dev))
    direct = jpeg.decode([open(os.path.join(FIXTURES, n), "rb").read()
                          for n in AR_FIXTURE_EXAMPLES], dev)
    shapes = [tuple(t.shape) for t in decoded]
    if shapes != [(720, 1280, 3), (720, 1280, 3), (300, 400, 3)] or \
            any(not torch.equal(a, b) for a, b in zip(decoded, direct)) or \
            launches["ycc_to_rgb"] != 1:
        raise AssertionError(f"the fixture's JPEGs decoded to {shapes}, "
                             f"launches {launches}")
    log(f"{os.path.relpath(AR_FIXTURE, HERE)} "
        f"({os.path.getsize(AR_FIXTURE)} bytes, written by the JAX "
        f"package's write_array_record): {len(got)} records of "
        f"{[len(r) for r in got]} bytes read with every hash verified in "
        f"{1e3 * read_s:.1f} ms, equal to the expected examples; their "
        f"JPEGs decoded on the card to {shapes} (one colour launch), equal "
        f"to the fixture files' decode")
    return {"records": len(got), "bytes": [len(r) for r in got],
            "read_ms": 1e3 * read_s, "decode_launches": launches}


def codec_rates(tfr_path, d):
    """MB/s of record bytes on the host: the port's ArrayRecord writer and
    reader (hashes verified and not) beside the TFRecord writer (with its
    ``.idx``) and the indexed TFRecord reader, over the records of
    ``tfr_path``; one pass each."""
    recs = list(records.read_tfrecord(tfr_path))
    mb = sum(len(r) for r in recs) / 1e6
    out = {"records": len(recs), "mb": mb}
    ar_path, tfr_copy = os.path.join(d, "rate.array_record"), \
        os.path.join(d, "rate.tfrecord")
    for name, fn in (
            ("array_record_write", lambda: records.write_array_record(
                ar_path, recs)),
            # its index, as ArrayRecord's footer
            ("tfrecord_write", lambda: (records.write_tfrecord(tfr_copy,
                                                               recs),
                                        native_io.build_index(tfr_copy))),
            ("array_record_read", lambda: [
                r for f in [array_record.ArrayRecordFile(ar_path)]
                for r in (f[i] for i in range(len(f)))]),
            ("array_record_read_verified", lambda: [
                r for f in [array_record.ArrayRecordFile(
                    ar_path, verify_hash=True)]
                for r in (f[i] for i in range(len(f)))]),
            ("tfrecord_read", lambda: [
                r for f in [native_io.IndexedTFRecordFile(tfr_copy)]
                for r in (f[i] for i in range(len(f)))])):
        t0 = time.perf_counter()
        result = fn()
        out[f"{name}_mb_per_s"] = mb / (time.perf_counter() - t0)
        if name.endswith("read") or name.endswith("verified"):
            if result != recs:
                raise AssertionError(f"{name}: the records differ")
    return out


def reformat_round_trip(paths, d):
    """``attentionalpoolingaction_torch.data.reformat``'s entry point over
    the TFRecord files of ``paths``: to ArrayRecord, then back to TFRecord,
    each file equal to its original byte for byte.  The ArrayRecord
    paths."""
    src_dir = os.path.dirname(paths["train"])
    ar_dir, back_dir = os.path.join(d, "ar"), os.path.join(d, "back")
    out = {}
    for what, src, dst in (
            ("to_array_record", os.path.join(src_dir, "*.tfrecord"), ar_dir),
            ("to_tfrecord", os.path.join(ar_dir, "*.array_record"),
             back_dir)):
        t0 = time.perf_counter()
        reformat.main(["--src", src, "--dst_dir", dst])
        out[f"{what}_s"] = time.perf_counter() - t0
    ar_paths = {}
    for split, path in paths.items():
        base = os.path.splitext(os.path.basename(path))[0]
        ar_paths[split] = os.path.join(ar_dir, base + ".array_record")
        back = os.path.join(back_dir, base + ".tfrecord")
        with open(path, "rb") as a, open(back, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"reformat round trip of {path} is not "
                                     "byte-equal")
    out["bytes"] = {k: [os.path.getsize(paths[k]),
                        os.path.getsize(ar_paths[k])] for k in paths}
    log(f"reformat: TFRecord -> ArrayRecord "
        f"{out['to_array_record_s']:.2f} s, back {out['to_tfrecord_s']:.2f} "
        f"s, byte-equal to the originals; bytes (TFRecord, ArrayRecord) "
        f"{out['bytes']}")
    return ar_paths, out


def array_record_clis(tfr_paths, ar_paths, d):
    """``train_cli`` of config #1 at full width for ``AR_STEPS`` steps from
    the ArrayRecord files and from the TFRecord originals, seeded alike
    (cuDNN deterministic): losses and batch digests equal bit for bit;
    ``eval_cli`` of each: results equal.  Each counted."""
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for kind, paths in (("tfrecord", tfr_paths),
                            ("array_record", ar_paths)):
            run_dir = os.path.join(d, f"run_{kind}")
            digests = []
            t0 = time.perf_counter()
            with digesting(digests):
                state, launches = counted(lambda: train_cli.main([
                    "--config", "mpii_rank1_224",
                    "--train_pattern", paths["train"], "--workdir", run_dir,
                    "--num_steps", str(AR_STEPS),
                    "--set", f"checkpoint_every={AR_STEPS}",
                    "--set", "log_every=1"]))
            train_s = time.perf_counter() - t0
            what = f"train_cli from {kind}"
            if state.step != AR_STEPS:
                raise AssertionError(f"{what}: step {state.step}")
            del state
            expect_launches(what, launches, AR_STEPS, backward=AR_STEPS)
            check_colour_launches(what, launches, jpeg.decode_count,
                                  jpeg.decode_calls, jpeg.ycc_images,
                                  least=8 * AR_STEPS)
            losses = [v for _, v in read_scalars(run_dir)["loss/total"]]
            t0 = time.perf_counter()
            printed, eval_launches = counted(lambda: eval_cli.main([
                "--config", "mpii_rank1_224", "--workdir", run_dir,
                "--eval_pattern", paths["val"], "--notb"]))
            eval_s = time.perf_counter() - t0
            batches = -(-N_EVAL_RECORDS // config_lib.get_config(
                "mpii_rank1_224").eval_batch_size)
            expect_launches(f"eval_cli from {kind}: {batches} batches",
                            eval_launches, batches)
            check_colour_launches(f"eval_cli from {kind}", eval_launches,
                                  jpeg.decode_count, jpeg.decode_calls,
                                  jpeg.ycc_images, least=N_EVAL_RECORDS)
            runs[kind] = {"losses": losses, "digests": digests,
                          "eval": printed[-1], "train_launches": launches,
                          "eval_launches": eval_launches,
                          "train_cli_s": train_s, "eval_cli_s": eval_s}
    finally:
        torch.backends.cudnn.deterministic = False
    t, a = runs["tfrecord"], runs["array_record"]
    if len(a["losses"]) != AR_STEPS or a["losses"] != t["losses"] or \
            a["digests"] != t["digests"] or len(a["digests"]) != AR_STEPS \
            or a["eval"] != t["eval"] or \
            a["eval"]["num_examples"] != N_EVAL_RECORDS or \
            not np.isfinite(a["losses"]).all():
        raise AssertionError(
            f"config #1 from ArrayRecord vs TFRecord: losses {a['losses']} "
            f"vs {t['losses']}, batches equal {a['digests'] == t['digests']}"
            f", eval {a['eval']} vs {t['eval']}")
    log(f"train_cli, config #1 at full width, {AR_STEPS} steps from "
        f"ArrayRecord and from TFRecord: losses and batch digests equal bit "
        f"for bit (" + ", ".join(f"{v:.4f}" for v in a["losses"])
        + f"); {a['train_cli_s']:.1f} vs {t['train_cli_s']:.1f} s; launches "
        f"{a['train_launches']}; eval_cli equal: {a['eval']}; launches "
        f"{a['eval_launches']}")
    return {"losses": a["losses"], "eval_cli": a["eval"],
            "train_launches": a["train_launches"],
            "eval_launches": a["eval_launches"],
            "tfrecord_train_launches": t["train_launches"],
            "seconds": {k: {"train_cli_s": runs[k]["train_cli_s"],
                            "eval_cli_s": runs[k]["eval_cli_s"]}
                        for k in runs}}


def array_record_rates(tfr_paths, ar_paths):
    """The pipeline alone from the records of the two 1280x720 fixtures,
    TFRecord and ArrayRecord in turns (TFRecord, ArrayRecord, ArrayRecord,
    TFRecord): train at batch 8, eval at batch 16, images/s; the mean of
    each kind's two turns."""
    rates = {k: {"train": [], "eval": []} for k in ("tfrecord",
                                                    "array_record")}
    for kind in ("tfrecord", "array_record", "array_record", "tfrecord"):
        paths = tfr_paths if kind == "tfrecord" else ar_paths
        rates[kind]["train"].append(train_pipeline_rate(paths["train"]))
        rates[kind]["eval"].append(eval_pipeline_rate(paths["val"]))
    return {f"pipeline_{side}_images_per_s_mpii_{kind}":
            float(np.mean(rates[kind][side]))
            for kind in rates for side in ("train", "eval")} | {
            "turns": rates}


def check_video_index(d, datas):
    """``hmdb51_rgb``'s video index from an ArrayRecord source equals the
    TFRecord source's: ``AR_VIDEOS`` videos of ``AR_FRAMES`` frames."""
    spec = train.get_dataset("hmdb51")
    small = [x for x in datas if jpeg.image_size(x)[0] < 720]

    def examples():
        for v in range(AR_VIDEOS):
            for k in range(AR_FRAMES):
                data = small[(v + k) % len(small)]
                h, w = jpeg.image_size(data)
                yield records.make_example(data, height=h, width=w,
                                           label=v % 51, video_id=v,
                                           frame=k)

    tfr = os.path.join(d, "hmdb.tfrecord")
    records.write_tfrecord(tfr, examples())
    ar = os.path.join(d, "hmdb.array_record")
    records.write_array_record(ar, records.read_tfrecord(tfr))
    from_ar = grain_pipeline.build_video_index(native_io.make_source(ar),
                                               spec)
    from_tfr = grain_pipeline.build_video_index(native_io.make_source(tfr),
                                                spec)
    want = {v: list(range(v * AR_FRAMES, (v + 1) * AR_FRAMES))
            for v in range(AR_VIDEOS)}
    if from_ar != from_tfr or from_ar != want:
        raise AssertionError(f"video index from ArrayRecord {from_ar}, from "
                             f"TFRecord {from_tfr}")
    log(f"hmdb51_rgb video index from ArrayRecord ({AR_VIDEOS} videos x "
        f"{AR_FRAMES} frames) equals the TFRecord source's")
    return {"videos": AR_VIDEOS, "frames": AR_FRAMES}


def phase_array_record(card):
    """Config #1 from ArrayRecord files; see the module docstring, phase
    12."""
    t_phase = time.monotonic()
    out = {"card": card, "libzstd": zstd.library_path(),
           "libzstd_version": zstd.version()}
    log(f"phase 12: {zstd.LIBRARY_NAME} is {out['libzstd']} (version "
        f"{out['libzstd_version']})")
    out["fixture"] = check_array_record_fixture()
    names, datas, _, _ = load_fixtures()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ar_") as d:
        mix = os.path.join(d, "mix")
        os.makedirs(mix)
        tfr_paths = write_records(mix, datas)
        ar_paths, out["reformat"] = reformat_round_trip(tfr_paths, d)
        out["codec"] = codec_rates(tfr_paths["train"], d)
        out["clis"] = array_record_clis(tfr_paths, ar_paths, d)
        mpii_dir = os.path.join(d, "mpii")
        os.makedirs(mpii_dir)
        mpii_tfr = write_records(
            mpii_dir, [x for n, x in zip(names, datas)
                       if n.startswith("mpii_")], prefix="mpii_")
        mpii_ar = {k: reformat.reformat_file(p, d)
                   for k, p in mpii_tfr.items()}
        out["rates"] = array_record_rates(mpii_tfr, mpii_ar)
        out["video_index"] = check_video_index(d, datas)
    c, r = out["codec"], out["rates"]
    log(f"phase 12 rates on {card}: the codec on the host over "
        f"{c['records']} records ({c['mb']:.1f} MB): ArrayRecord write "
        f"{c['array_record_write_mb_per_s']:.1f} MB/s, read "
        f"{c['array_record_read_mb_per_s']:.1f} MB/s "
        f"({c['array_record_read_verified_mb_per_s']:.1f} with hashes "
        f"verified); TFRecord write {c['tfrecord_write_mb_per_s']:.1f} MB/s, "
        f"indexed read {c['tfrecord_read_mb_per_s']:.1f} MB/s.  Pipeline "
        f"alone from the 1280x720 records, in turns: train "
        f"{r['pipeline_train_images_per_s_mpii_array_record']:.1f} images/s "
        f"from ArrayRecord vs "
        f"{r['pipeline_train_images_per_s_mpii_tfrecord']:.1f} from "
        f"TFRecord (batch 8), eval "
        f"{r['pipeline_eval_images_per_s_mpii_array_record']:.1f} vs "
        f"{r['pipeline_eval_images_per_s_mpii_tfrecord']:.1f} (batch 16)")
    out["phase_s"] = time.monotonic() - t_phase
    log(f"phase 12 took {out['phase_s']:.1f} s (workdir removed)")
    return out


# -- phase 13 ----------------------------------------------------------------

ORBAX_FIXTURE = os.path.join(FIXTURES, "jax_orbax")
ORBAX_STEP = 1200
ORBAX_RESUME_STEPS = 4
ORBAX_GRAIN_BATCHES = 150   # the JAX package's Grain state: 1,200 records


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def orbax_logits(cfg, restored, crops_u8, want):
    """``load_predictor`` over the JAX step: ``predict_arrays`` of the 7
    golden crops counted, then the predictor's and ``evaluate``'s logits
    (TF32 off) against the JAX package's CPU logits."""
    pred = serving.load_predictor(cfg, buckets=(1, 8, 32), device="cuda")
    pred.warmup()
    if pred.step != ORBAX_STEP:
        raise AssertionError(f"load_predictor serves step {pred.step}")
    probs, launches = counted(lambda: pred.predict_arrays(crops_u8))
    expect_launches("load_predictor of the JAX step, 7 crops", launches, 1,
                    ycc=0)
    torch.backends.cudnn.allow_tf32 = False
    try:
        served = pred._fwd(pred._weights, crops_u8)
        evaluated = evaluate.Evaluator(cfg, device="cuda").logits(
            restored, [{"image": crops_u8,
                        "label": np.zeros(len(crops_u8), np.int32),
                        "mask": np.ones(len(crops_u8), np.float32)}]
        )["logits"]
    finally:
        torch.backends.cudnn.allow_tf32 = True
    scale = float(np.abs(want).max())
    errs = {"predict_arrays": float(np.abs(served - want).max()) / scale,
            "evaluate": float(np.abs(evaluated - want).max()) / scale}
    log(f"the JAX step served and evaluated on the card (TF32 off) against "
        f"the JAX package's CPU logits of the 7 golden crops: relative "
        f"{errs['predict_arrays']:.3e} (predict_arrays), "
        f"{errs['evaluate']:.3e} (evaluate), bound {CPU_RTOL:g}, max "
        f"|logit| {scale:.1f}; probabilities {probs.shape}, launches "
        f"{launches}")
    if not (max(errs.values()) < CPU_RTOL and np.isfinite(probs).all()):
        raise AssertionError(f"the JAX step's logits on the card: {errs}")
    return {"logits_rel": errs, "launches": launches}


def orbax_resume(paths, jax_dir, port_dir):
    """train_cli resuming ``ORBAX_RESUME_STEPS`` steps from the JAX step
    (counted) and from its port-format copy, cuDNN deterministic: the
    losses and the final states equal bit for bit."""
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, d in (("orbax", jax_dir), ("port", port_dir)):
            args = ["--config", "mpii_rank1_224", "--train_pattern",
                    paths["train"], "--workdir", d, "--num_steps",
                    str(ORBAX_STEP + ORBAX_RESUME_STEPS), "--set",
                    "ema_decay=0.999", "--set", "log_every=1", "--set",
                    "checkpoint_every=1000"]
            (state, launches), s = timed(
                lambda: counted(lambda: train_cli.main(args)))
            runs[name] = {"seconds": s, "launches": launches,
                          "payload": state.payload(), "step": state.step}
            del state
    finally:
        torch.backends.cudnn.deterministic = False
    expect_launches("train_cli resuming the JAX step", runs["orbax"][
        "launches"], ORBAX_RESUME_STEPS, backward=ORBAX_RESUME_STEPS)

    a, b = runs["orbax"]["payload"], runs["port"]["payload"]
    same = {k: all(torch.equal(x, y) for x, y in zip(
        payload_tensors(a[k]), payload_tensors(b[k]))) for k in a}
    losses = [[v for _, v in read_scalars(d).get("loss/total", [])]
              for d in (jax_dir, port_dir)]
    same["losses"] = losses[0] == losses[1] and \
        len(losses[0]) == ORBAX_RESUME_STEPS
    mgr = checkpoint.make_manager(os.path.join(jax_dir, "checkpoints"))
    stream = json.loads((mgr.directory / f"grain_iter_{ORBAX_STEP + 4}_p0"
                         ".json").read_text())
    want_stream = dict(zip(("epoch", "position"), divmod(
        (ORBAX_GRAIN_BATCHES + ORBAX_RESUME_STEPS) * 8, N_TRAIN_RECORDS)))
    log(f"train_cli resumed the JAX step {ORBAX_STEP} for "
        f"{ORBAX_RESUME_STEPS} steps in {runs['orbax']['seconds']:.1f} s "
        f"({runs['port']['seconds']:.1f} s from the port-format copy): "
        f"losses {losses[0]}; final states and losses equal bit for bit "
        f"{same}; steps on disk "
        f"{mgr.all_steps()}; stream {stream}; launches "
        f"{runs['orbax']['launches']}")
    if not all(same.values()) or set(a) != set(b) or \
            runs["orbax"]["step"] != ORBAX_STEP + ORBAX_RESUME_STEPS or \
            mgr.all_steps() != [ORBAX_STEP, ORBAX_STEP + 4] or \
            stream != want_stream:
        raise AssertionError(f"resume of the JAX step: equal {same}, steps "
                             f"{mgr.all_steps()}, stream {stream}")
    return {k: runs[k]["seconds"] for k in runs} | {
        "launches": runs["orbax"]["launches"], "bitwise": same,
        "stream": stream, "losses": losses[0]}


def payload_tensors(tree):
    """The tensors (and numbers) of a payload's part, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in
                payload_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in payload_tensors(v)]
    return [torch.tensor(float(tree))] if isinstance(tree, (int, float)) \
        else []


def orbax_slim_export(restored, d):
    """export_slim_checkpoint of the restored backbone, read back by the
    port's reader bit for bit."""
    variables = {"params": restored.params,
                 "batch_stats": restored.batch_stats}
    prefix = os.path.join(d, "slim", "model.ckpt")
    n, s = timed(lambda: checkpoint.export_slim_checkpoint(
        variables, prefix, model_scope="resnet_v1_101"))
    nbytes = sum(os.path.getsize(prefix + x)
                 for x in (".index", ".data-00000-of-00001"))
    back = checkpoint.convert_slim_checkpoint(prefix,
                                              model_scope="resnet_v1_101")
    reader = tf_checkpoint.CheckpointReader(prefix)
    checked = 0
    for coll in ("params", "batch_stats"):
        want = {p: v for p, v in convert._leaves(variables[coll])
                if p[0] == "resnet"}
        got = dict(convert._leaves(back[coll]))
        if set(got) != set(want) or not all(
                np.array_equal(got[p], want[p]) for p in want):
            raise AssertionError(f"slim export: {coll} read back differs")
        checked += len(want)
    if checked != n or len(reader.get_variable_to_shape_map()) != n:
        raise AssertionError(f"slim export: {n} written, {checked} read")
    log(f"export_slim_checkpoint of the JAX step's backbone: {n} variables, "
        f"{nbytes / 1e6:.1f} MB in {s:.2f} s, read back bit for bit")
    return {"variables": n, "bytes": nbytes, "seconds": s}


def phase_orbax(card):
    """Config #1 trained by the JAX package; see the module docstring,
    phase 13."""
    t_phase = time.monotonic()
    names, datas, crops, _ = load_fixtures()
    with np.load(os.path.join(ORBAX_FIXTURE, "mpii_rank1_224_logits.npz")) \
            as z:
        if list(z["names"]) != list(names):
            raise AssertionError(f"stored logits of {list(z['names'])}")
        want = z["logits"]
    out = {"card": card}
    cfg = config_lib.get_config("mpii_rank1_224", ema_decay=0.999)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_orbax_") as d:
        jax_dir, port_dir = os.path.join(d, "jax"), os.path.join(d, "port")
        shutil.copytree(os.path.join(ORBAX_FIXTURE, "mpii_rank1_224",
                                     str(ORBAX_STEP)),
                        os.path.join(jax_dir, "checkpoints", str(ORBAX_STEP)))
        mgr = checkpoint.make_manager(os.path.join(jax_dir, "checkpoints"))
        (mgr.directory / f"grain_iter_{ORBAX_STEP}_p0.json").write_text(
            json.dumps({"next_index": ORBAX_GRAIN_BATCHES}))
        restored, eval_s = timed(lambda: checkpoint.restore_for_eval(mgr))
        state, _ = train.create_state(cfg, device="cuda")
        _, restore_s = timed(lambda: checkpoint.restore(mgr, state))
        torch.cuda.synchronize()
        port_mgr = checkpoint.make_manager(os.path.join(port_dir,
                                                        "checkpoints"))
        checkpoint.save(port_mgr, state)
        port_mgr.wait_until_finished()
        del state
        (port_mgr.directory / f"grain_iter_{ORBAX_STEP}_p0.json").write_text(
            json.dumps(dict(zip(("epoch", "position"), divmod(
                ORBAX_GRAIN_BATCHES * 8, N_TRAIN_RECORDS)))))
        _, port_eval_s = timed(lambda: checkpoint.restore_for_eval(port_mgr))
        state, _ = train.create_state(cfg, device="cuda")
        _, port_restore_s = timed(lambda: checkpoint.restore(port_mgr,
                                                             state))
        torch.cuda.synchronize()
        del state
        out["restore_s"] = {"orbax_eval": eval_s, "orbax_state": restore_s,
                            "port_eval": port_eval_s,
                            "port_state": port_restore_s}
        log(f"the JAX step {ORBAX_STEP} on {card}: restore_for_eval "
            f"{eval_s:.2f} s, restore into a card state {restore_s:.2f} s "
            f"(Orbax, read by the port); the same state in the port's "
            f"format {port_eval_s:.2f} s and {port_restore_s:.2f} s (the "
            f"fixture's periodic leaves decode faster than trained ones: "
            f"the Orbax times are not representative)")
        if restored.step != ORBAX_STEP or restored.ema_params is None:
            raise AssertionError(f"restore_for_eval: step {restored.step}")
        out["serving"] = orbax_logits(dataclasses.replace(
            cfg, workdir=jax_dir), restored, crops["eval"], want)
        rec = os.path.join(d, "records")
        os.makedirs(rec)
        paths = write_records(rec, datas)
        printed, launches = counted(lambda: eval_cli.main([
            "--config", "mpii_rank1_224", "--workdir", jax_dir,
            "--eval_pattern", paths["val"], "--notb"]))
        line = printed[-1]
        batches = -(-N_EVAL_RECORDS // cfg.eval_batch_size)
        expect_launches("eval_cli of the JAX step", launches, batches)
        if line["step"] != ORBAX_STEP or \
                line["num_examples"] != N_EVAL_RECORDS:
            raise AssertionError(f"eval_cli of the JAX step: {line}")
        log(f"eval_cli of the JAX step: {line}; launches {launches}")
        out["eval_cli"] = {"result": line, "launches": launches}
        out["resume"] = orbax_resume(paths, jax_dir, port_dir)
        out["slim_export"] = orbax_slim_export(restored, d)
    out["phase_s"] = time.monotonic() - t_phase
    log(f"phase 13 took {out['phase_s']:.1f} s (workdir removed)")
    return out


def cards_worker(workdir):
    """One rank a card over NCCL, world = the cards: DP vs one process,
    ZeRO-1 vs DP and the ``(n/2, 2)`` data x model step of ``hico``
    against one process (resnet_v1_50 at 96 px, TF32 off), the stop
    across ranks, the gathered eval, and config #5's step over the
    ``(n,)`` mesh against one card's, timed in this call."""
    from attentionalpoolingaction_torch.parallel import mesh as mesh_lib
    from attentionalpoolingaction_torch.parallel import multihost

    with open(os.path.join(workdir, "cards.json")) as f:
        params = json.load(f)
    dev = multihost.setup()
    rank, world = multihost.process_index(), multihost.process_count()
    out = {"rank": rank, "device": str(dev),
           "backend": torch.distributed.get_backend()}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = 4 * world
    rows = slice(rank * 4, rank * 4 + 4)
    for dataset in ("mpii", "hico"):
        cfg = config_lib.TrainConfig(dataset=dataset, **{
            **GLOO_CONFIG, "batch_size": b})
        spec = train.get_dataset(dataset)
        variables = precision.seeded_variables(cfg, 3)
        batch = precision.synthetic_batch(np.random.default_rng(52), cfg,
                                          spec)
        _, one, one_m, _ = _mesh_step(cfg, spec, variables, batch, None, dev)
        if dataset == "mpii":
            mesh = mesh_lib.make_mesh((world,), ("data",))
            _, dp, dp_m, dp_l = _mesh_step(cfg, spec, variables, batch,
                                           mesh, dev, rows)
            _, z1, _, z1_l = _mesh_step(dataclasses.replace(cfg, zero1=True),
                                        spec, variables, batch, mesh, dev,
                                        rows)
            out["dp"] = {"params": float((dp - one).abs().max()),
                         "loss": abs(dp_m["loss/total"]
                                     - one_m["loss/total"])
                         / abs(one_m["loss/total"]), "launches": dp_l}
            out["zero1"] = {"params": float((z1 - dp).abs().max()),
                            "launches": z1_l}
            if out["dp"]["params"] > GLOO_DP_RTOL or \
                    out["dp"]["loss"] > GLOO_DP_RTOL or \
                    out["zero1"]["params"] > GLOO_ZERO1_ATOL:
                raise AssertionError(f"rank {rank}: {out}")
        else:
            shape = (world // 2, 2)
            tp_cfg = dataclasses.replace(cfg, mesh_shape=shape,
                                         mesh_axes=("data", "model"))
            mesh = mesh_lib.make_mesh(shape, ("data", "model"))
            d = mesh_lib.axis_index(mesh, "data")
            tp_rows = slice(d * 2 * b // world, (d + 1) * 2 * b // world)
            _, tp, tp_m, tp_l = _mesh_step(tp_cfg, spec, variables, batch,
                                           mesh, dev, tp_rows)
            out["tp"] = {"params": float((tp - one).abs().max()),
                         "loss": abs(tp_m["loss/total"]
                                     - one_m["loss/total"])
                         / abs(one_m["loss/total"]), "launches": tp_l}
            if out["tp"]["params"] > GLOO_TP_ATOL or \
                    out["tp"]["loss"] > GLOO_DP_RTOL:
                raise AssertionError(f"rank {rank}: TP {out['tp']}")
        for k in ("dp", "zero1") if dataset == "mpii" else ("tp",):
            expect_launches(f"rank {rank} {k} step", out[k]["launches"], 1,
                            backward=1)
    cfg = config_lib.TrainConfig(dataset="mpii", mesh_shape=(world,),
                                 **{**GLOO_CONFIG, "batch_size": b})
    stop = threading.Event()

    def raise_flag(step, state, metrics):
        if rank == world - 1 and step == 1:
            stop.set()

    mpii = precision.synthetic_batch(np.random.default_rng(53), cfg,
                                     train.get_dataset("mpii"))
    state, _ = train.train(
        cfg, train_iter=itertools.repeat(
            {k: v[rows] for k, v in mpii.items()}),
        num_steps=4, device=dev, hooks=[raise_flag], stop_event=stop)
    out["stopped_at"] = state.step
    del state
    ecfg = config_lib.TrainConfig(dataset="mpii", eval_pattern=params["val"],
                                  seed=4, **GLOO_CONFIG)
    estate, _ = train.create_state(ecfg, device=dev)
    res = evaluate.evaluate(ecfg, estate, device=dev)
    out["eval"] = {"mAP": res["mAP"], "num_examples": res["num_examples"]}
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

    # config #5 over the (n,) mesh, 64 / n rows a card, against one card
    # with the whole batch (rank 0, the others waiting), in this call
    cfg = config_lib.get_config(MESH_CONFIG)
    spec = train.get_dataset(cfg.dataset)
    variables = precision.seeded_variables(cfg, 0)
    batch = precision.synthetic_batch(np.random.default_rng(50), cfg, spec)
    share = cfg.batch_size // world
    mesh = mesh_lib.make_mesh((world,), ("data",))
    state, _ = train.create_state(cfg, device=dev, variables=variables,
                                  mesh=mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    out["mesh_step_ms"] = _timed_steps(
        state, train.make_train_step(spec, cfg, mesh),
        {k: v[rank * share:(rank + 1) * share] for k, v in batch.items()},
        dev, MESH_TIMED_STEPS)
    out["mesh_max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    del state
    torch.cuda.empty_cache()
    multihost.barrier()
    if rank == 0:
        state, _ = train.create_state(cfg, device=dev, variables=variables)
        out["one_card_step_ms"] = _timed_steps(
            state, train.make_train_step(spec, cfg), batch, dev,
            MESH_TIMED_STEPS)
        del state
    multihost.barrier()
    mesh_log(f"rank {rank} of {world} over NCCL ({params['card']}): DP vs "
             f"one process {out['dp']['params']:.3e}, ZeRO-1 vs DP "
             f"{out['zero1']['params']:.3e}, TP {shape} vs one process "
             f"{out['tp']['params']:.3e}, stop at step {out['stopped_at']}, "
             f"gathered mAP {out['eval']['mAP']!r}; {MESH_CONFIG} over "
             f"({world},): {out['mesh_step_ms']:.1f} ms a step, "
             f"{cfg.batch_size / out['mesh_step_ms'] * 1e3:.1f} images/s, "
             f"max allocated "
             f"{out['mesh_max_memory_allocated'] / 2**30:.2f} GiB"
             + (f"; one card with the whole batch "
                f"{out['one_card_step_ms']:.1f} ms" if rank == 0 else ""))
    torch.distributed.destroy_process_group()
    return out


def cards_serving(n, card):
    """Data-parallel serving over ``n`` cards in this process, one replica
    a card through CUDA graphs: ``mpii_rank1_224`` (float32, TF32 off)
    against one card's probabilities, and config #5 at bucket 32 against
    one card, timed in turns and no slower; counted."""
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = config_lib.get_config("mpii_rank1_224")
        variables = precision.seeded_variables(cfg, 0)
        one = serving.Predictor(cfg, *variables, buckets=(1, 8, 32))
        many = serving.Predictor(cfg, *variables, buckets=(1, 8, 32),
                                 data_parallel=True)
        many.warmup()               # captures each replica's graphs
        images = np.random.default_rng(60).integers(
            0, 256, (40, cfg.image_size, cfg.image_size, 3), np.uint8)
        want = one.predict_arrays(images)
        got, launches = counted(lambda: many.predict_arrays(images))
    finally:
        torch.backends.cudnn.allow_tf32 = True
    err = float(np.abs(got - want).max())
    # 40 images: a bucket of 32, then 8, each split over the replicas
    expect_launches(f"data-parallel serving over {n} cards", launches,
                    2 * n, ycc=0)
    if len(many.replicas) != n or err > SERVE_PROB_ATOL:
        raise AssertionError(f"data-parallel serving: {many.replicas}, "
                             f"max |dprob| {err:.3e}")
    cfg = config_lib.get_config(MESH_CONFIG)
    variables = precision.seeded_variables(cfg, 0)
    preds = [serving.Predictor(cfg, *variables, buckets=(32,),
                               data_parallel=dp) for dp in (False, True)]
    batch = np.random.default_rng(61).integers(
        0, 256, (32, cfg.image_size, cfg.image_size, 3), np.uint8)
    times = ([], [])
    for p in preds:
        p.predict_arrays(batch)
    for _ in range(4):
        for i in (0, 1, 1, 0):
            t0 = time.perf_counter()
            preds[i].predict_arrays(batch)
            times[i].append(time.perf_counter() - t0)
    out = {"replicas": n, "max_abs_dprob": err, "launches": launches,
           "graphs": len(preds[1]._replica_graphs),
           "one_card_ms": float(np.median(times[0])) * 1e3,
           "replicas_ms": float(np.median(times[1])) * 1e3}
    if out["replicas_ms"] > out["one_card_ms"]:
        raise AssertionError(
            f"data-parallel serving over {n} cards: {MESH_CONFIG} at bucket "
            f"32 {out['replicas_ms']:.1f} ms a call, slower than one card's "
            f"{out['one_card_ms']:.1f} ms")
    log(f"data-parallel serving over {n} cards ({card}): {n} replicas, "
        f"mpii_rank1_224 probabilities {err:.3e} from one card's (TF32 "
        f"off); {MESH_CONFIG} at bucket 32: {out['replicas_ms']:.1f} ms a "
        f"call over {n} replicas vs {out['one_card_ms']:.1f} ms on one "
        f"card (median of 8 in turns); launches {launches}")
    return out


def phase_cards(card, n):
    """``--cards N``: the mesh across N cards over NCCL, and
    data-parallel serving over them; see the module docstring."""
    if torch.cuda.device_count() < n:
        raise AssertionError(f"--cards {n}: {torch.cuda.device_count()} "
                             "card(s) visible")
    t_phase = time.monotonic()
    _, datas, _, _ = load_fixtures()
    out = {"card": card, "cards": n}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cards_") as d:
        val = os.path.join(d, "val.tfrecord")
        records.write_synthetic_dataset(
            val, train.get_dataset("mpii"), 5, image_size=GLOO_SIZE,
            seed=12, encode_jpeg=fixture_encoder(datas))
        native_io.build_index(val)
        with open(os.path.join(d, "cards.json"), "w") as f:
            json.dump({"val": val, "card": card}, f)
        ranks, _ = run_mesh_workers("cards", n, d, timeout=600,
                                    one_card_each=True)
        torch.backends.cudnn.allow_tf32 = False
        try:
            ecfg = config_lib.TrainConfig(dataset="mpii", eval_pattern=val,
                                          seed=4, **GLOO_CONFIG)
            estate, _ = train.create_state(ecfg, device="cuda")
            alone = evaluate.evaluate(ecfg, estate, device="cuda")
        finally:
            torch.backends.cudnn.allow_tf32 = True
    for r in ranks:
        if r["backend"] != "nccl" or r["stopped_at"] != 2 or \
                r["eval"]["num_examples"] != 5 or \
                abs(r["eval"]["mAP"] - alone["mAP"]) > GLOO_MAP_ATOL:
            raise AssertionError(f"rank {r['rank']}: {r} vs one process "
                                 f"{alone}")
    out["ranks"] = ranks
    out["serving"] = cards_serving(n, card)
    out["phase_s"] = time.monotonic() - t_phase
    log(f"--cards {n} took {out['phase_s']:.1f} s (workdir removed)")
    log(json.dumps({"cards_run": out}, default=str))
    return out

MESH_WORKERS = {"mesh5": mesh5_worker, "gloo2": gloo2_worker,
                "cards": cards_worker}


def mesh_worker_main(kind, workdir):
    """A worker of :func:`run_mesh_workers`: its result as JSON."""
    out = MESH_WORKERS[kind](workdir)
    path = os.path.join(workdir, f"result_{kind}_{os.environ['RANK']}.json")
    with open(path, "w") as f:
        json.dump(out, f, default=str)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="add a profiler breakdown of a call at "
                        "each bucket, of one train step and of the eval "
                        "loop")
    parser.add_argument("--mesh-worker", choices=sorted(MESH_WORKERS),
                        help=argparse.SUPPRESS)
    parser.add_argument("--workdir", help=argparse.SUPPRESS)
    parser.add_argument("--cards", type=int, default=0,
                        help="instead of the phases, the mesh across this "
                        "many cards over NCCL and data-parallel serving "
                        "over them (needs that many cards)")
    args = parser.parse_args()
    if args.mesh_worker:
        mesh_worker_main(args.mesh_worker, args.workdir)
        return
    if args.cards:
        card = phase_device()
        build_libraries()
        phase_cards(card, args.cards)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return

    card = phase_device()
    build_libraries()
    timer = ColdTimer()
    rows = phase_kernels(timer)
    pred, launches = phase_serving(card)
    if args.profile:
        phase_profile(pred)
    del pred
    run = phase_training(card)
    phase_training_small()
    if args.profile:
        phase_train_profile(run)
    del run["state"], run["batch"]
    ckpt_run = phase_checkpointed_run(card, profile=args.profile)
    rec_run = phase_records(card, timer, profile=args.profile)
    configs = phase_configs(card)
    hico, hmdb, clip8 = (configs[k] for k in (
        "hico_multilabel", "hmdb51_rgb", "hmdb51_clip8"))
    served = phase_http_serving(card, rec_run["record_logits"]["bound"],
                                profile=args.profile)
    exported = phase_export(card, rec_run["record_logits"]["bound"])
    meshed = phase_mesh(card)
    config5, gloo2 = meshed["config5"], meshed["gloo2"]["ranks"]
    raw = phase_raw(card)
    from_ar = phase_array_record(card)
    from_orbax = phase_orbax(card)

    def path_launches(name):
        """The launches of ``name`` on each main path, each counted over
        its own run."""
        return {"train_launches": run["launches"][name],
                "eval_launches": ckpt_run["eval_launches"][name],
                "pipeline_train_launches":
                    rec_run["clis"]["pipeline_train_launches"][name],
                "pipeline_eval_launches":
                    rec_run["clis"]["pipeline_eval_launches"][name],
                "hico_train_launches": hico["train"]["launches"][name],
                "hico_eval_launches": hico["eval_launches"][name],
                "hico_serve_launches": hico["serve_launches"][name],
                "pose_train_launches":
                    configs["mpii_pose_attention"]["train"]["launches"][name],
                "hmdb_rgb_train_launches": hmdb["train_launches"][name],
                "hmdb_rgb_eval_launches": hmdb["eval_launches"][name],
                "clip8_train_launches": clip8["launches"][name],
                "clip8_eval_launches": clip8["eval_launches"][name],
                "http_launches": served["http"]["launches"][name],
                "int8_serve_launches":
                    served["int8_serving"]["launches"][name],
                "int8_eval_launches":
                    served["int8_eval"]["int8"]["launches"][name],
                "clip8_int8_serve_launches":
                    served["clip8_int8"]["launches"][name],
                "export_serve_launches":
                    exported["http"]["launches"][name],
                "visualize_launches":
                    exported["visualize"]["launches"][name],
                "mesh5_step_launches": config5["step_launches"][name],
                "mesh5_train_launches": config5["train_launches"][name],
                "mesh5_eval_launches": config5["eval_launches"][name],
                "mesh5_serve_launches": config5["serve"]["launches"][name],
                "gloo2_dp_launches": [r["dp"]["launches"][name]
                                      for r in gloo2],
                "gloo2_zero1_launches": [r["zero1"]["launches"][name]
                                         for r in gloo2],
                "gloo2_tp_launches": [r["tp"]["launches"][name]
                                      for r in gloo2],
                "raw_train_launches": raw["clis"]["train_launches"][name],
                "raw_eval_launches": raw["clis"]["eval_launches"][name],
                "array_record_train_launches":
                    from_ar["clis"]["train_launches"][name],
                "array_record_eval_launches":
                    from_ar["clis"]["eval_launches"][name],
                "orbax_serve_launches":
                    from_orbax["serving"]["launches"][name],
                "orbax_eval_launches":
                    from_orbax["eval_cli"]["launches"][name],
                "orbax_train_launches":
                    from_orbax["resume"]["launches"][name]}

    kernels = []
    for name in ("saliency_summary", "project_logits", "pool_backward"):
        mine = [r for r in rows if r["name"] == name]
        main_row = next(r for r in mine if r["case"]["B"] == 32
                        and r["case"]["x"] == "float32")
        slice_rows = [r for r in mine if r["case"]["N"] == 49]
        backward = name == "pool_backward"
        kernels.append({
            "name": name, "route": "cuda",
            "source": BACKWARD_SOURCE if backward else SOURCE,
            "replaces": BACKWARD_REPLACES if backward else REPLACES[name],
            # the backward's main path is training: phase 4's train.train
            "launches": run["launches"][name] if backward
            else launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in slice_rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "bound_share": main_row["bound_share"],
            **({k: main_row[k] for k in ("autograd_ms", "kernel_ms",
                                         "kernel_bound_ms")}
               if backward else {}),
            **path_launches(name)})
    log(json.dumps({"training": {
        "config": "mpii_rank1_224", "card": card,
        "step_ms": run["step_ms"], "images_per_s": run["images_per_s"],
        "card_vs_cpu": run["errs"], "launches": run["launches"]}}))
    log(json.dumps({"checkpointed_run": {
        k: v for k, v in ckpt_run.items() if k != "eval_launches"}}))
    ycc = rec_run["ycc_kernel"]
    kernels.append({
        "name": "ycc_to_rgb", "route": "cuda", "source": JPEG_SOURCE,
        "replaces": JPEG_REPLACES,
        "launches": rec_run["clis"]["pipeline_train_launches"]["ycc_to_rgb"],
        **{k: ycc[k] for k in ("max_abs_err", "ms", "call_ms", "host_ms",
                               "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "bound_share", "images")},
        **path_launches("ycc_to_rgb")})
    log(json.dumps({"records_run": {
        k: v for k, v in rec_run.items() if k not in ("clis", "resume")}}))
    log(json.dumps({"configs_run": configs}, default=str))
    log(json.dumps({"serving_run": {
        k: v for k, v in served.items() if k != "http"}}, default=str))
    log(json.dumps({"export_run": exported}, default=str))
    log(json.dumps({"mesh_run": meshed}, default=str))
    log(json.dumps({"raw_run": raw}, default=str))
    log(json.dumps({"array_record_run": {
        k: v for k, v in from_ar.items() if k != "clis"} | {
        "clis": {k: v for k, v in from_ar["clis"].items()
                 if not k.endswith("launches")}}}, default=str))
    log(json.dumps({"orbax_run": {
        k: v for k, v in from_orbax.items() if k not in ("serving",
                                                          "eval_cli")} | {
        "serving": from_orbax["serving"]["logits_rel"],
        "eval_cli": from_orbax["eval_cli"]["result"]}}, default=str))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
