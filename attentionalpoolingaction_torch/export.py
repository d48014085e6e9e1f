"""Exported serving artifacts: the serving forward as ``torch.export``
programs, the port of the JAX package's ``export.py`` (``jax.export``).

An artifact is a directory that serves without the model code, a
checkpoint or the config's model build:

    manifest.json      config snapshot, buckets, input dtypes, clip length,
                       per-leaf dtype/shape, the torch version and the
                       device traced on
    weights.npz        the weight leaves as raw little-endian bytes, so
                       that bfloat16 and int8 ship as they are
    fwd_<dtype>.pt2    one ``torch.export`` program per input dtype: uint8
                       raw RGB or float32 mean-subtracted (B, S, S, 3)
                       images -> float32 logits, normalization included
    clip_<dtype>.pt2   the same for (B, T, S, S, 3) clips, where exported

Design, as the JAX package's:

  * **Symbolic batch.**  Each program is traced at a batch of 2 with a
    symbolic batch dimension (``torch.export.Dim.AUTO``), so one program
    serves every bucket.  The trace may prove a narrower range than the
    batches served: on a card it records ``2 <= batch <= 65535`` (a
    batch of 1 and one above 65,535 take other conv backends at run time,
    which the graph's ``aten.conv2d`` nodes leave to the call).  So the
    loaded graph is called directly, without the range check of
    ``ExportedProgram.module()``, and ``export_cli``'s load-back gate
    holds a batch of 1 against the live predictor as well.
  * **Weights as inputs, not constants.**  A program takes the flat leaf
    list and the images; the leaves ship once in ``weights.npz``, and the
    ``.pt2`` files carry no weights (export refuses a program that holds a
    constant).
  * **Portable between devices.**  A program holds nothing bound to the
    device it was traced on: no constant, no device argument (export
    refuses one and drops the device from the dtype assertions that
    tracing adds).  So an artifact exported on the CPU serves on a card,
    and the other way round: the loader moves the weights to its device.
  * **The kernels stay kernels.**  The pooling head's two kernels are the
    custom ops ``apa::saliency_summary`` and ``apa::project_logits``
    (``ops/attn_pool_cuda.py``): each is one node of the graph, and the
    loaded program calls the kernel on a card (counting its launches) and
    the plain version on the CPU.  Importing that module, which registers
    the ops, is the only model code that loading needs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import zipfile
from typing import Sequence

import numpy as np
import torch
from torch.func import functional_call
from torch.utils import _pytree as pytree

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_torch.device import resolve_device
# registers the apa:: ops that the programs call
from attentionalpoolingaction_torch.ops import attn_pool_cuda  # noqa: F401

MANIFEST = "manifest.json"
WEIGHTS = "weights.npz"
FORMAT_VERSION = 1
# the batch a program is traced at: at 1 the trace would specialize the
# batch to 1
TRACE_BATCH = 2



def _dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest's dtype name (``"bfloat16"``)."""
    return getattr(torch, name)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def reject_checkpoint_flags(args, names: Sequence[str]) -> None:
    """Usage error (``SystemExit``) if any checkpoint-only flag was set
    with ``--exported_dir``.  The artifact fixed its weights, precision,
    buckets and config when it was exported, so these flags would have no
    effect; dropping ``--ema`` silently would serve the wrong weights.
    The CLIs give these flags a default of None, so a flag counts as set
    when it was given at all, even at the value that is the default (as
    absl's ``using_default_value`` tells it): an explicit ``--config
    mpii_rank1_224`` is refused too.  Shared by serve_cli and
    predict_cli."""
    present = [f"--{n}" for n in names if getattr(args, n, None) is not None]
    if present:
        raise SystemExit(
            f"{', '.join(present)} have no effect with --exported_dir (the "
            "artifact fixes weights, precision, buckets and config at "
            "export time — re-run export_cli with these flags instead)")


def _leaf_key(i: int) -> str:
    return f"leaf_{i:05d}"


def _program_name(kind: str, dtype) -> str:
    return f"{kind}_{np.dtype(dtype).name}.pt2"


def _weight_leaves(predictor: serving.Predictor):
    """(leaves, rebuild): the predictor's weights as a flat tensor list, and
    the function that rebuilds what ``Predictor.forward`` takes from such a
    list.  The float model's leaves are its state dict and, for an
    attention head, the kernels' (P, F, C) copy of ``attn_w``, which the
    rebuilt forward hands to the head (``given_w_pfc``); the int8 weights
    are a tree of tensors already."""
    weights = predictor._weights
    if predictor.int8:
        # no static scales (None) are no scales ({}): per-example ones
        q, head, act_scales = weights
        leaves, spec = pytree.tree_flatten((q, head, act_scales or {}))
        return leaves, lambda flat: pytree.tree_unflatten(list(flat), spec)
    model = weights
    state = model.state_dict()
    names = list(state)
    head = model.head if hasattr(model.head, "given_w_pfc") else None
    leaves = [state[k] for k in names]
    if head is not None:
        leaves.append(head.w_pfc())

    def rebuild(flat):
        def fwd(x):
            tensors = dict(zip(names, flat))
            given = (head.given_w_pfc(flat[len(names)]) if head is not None
                     else contextlib.nullcontext())
            with given:
                return functional_call(model, tensors, (x,))
        return fwd

    return leaves, rebuild


class _Program(torch.nn.Module):
    """The traced function: (leaves, images) -> logits."""

    def __init__(self, predictor, rebuild):
        super().__init__()
        self._predictor = predictor
        self._rebuild = rebuild

    def forward(self, leaves, images):
        return self._predictor.forward(self._rebuild(leaves), images)


def _device_free(ep: torch.export.ExportedProgram, name: str) -> None:
    """Make ``ep`` hold nothing bound to the device it was traced on, or
    raise: no constant or state, no device argument.  The dtype assertions
    that tracing puts before a ``.to(dtype)`` keep their dtype and lose
    their device."""
    held = list(ep.constants) + list(ep.state_dict)
    if held:
        raise ValueError(f"{name} holds constants {held[:5]}: the weights "
                         "must be program inputs")
    bound = []
    for node in ep.graph.nodes:
        if node.op != "call_function":
            continue
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            node.kwargs = {k: v for k, v in node.kwargs.items()
                           if k != "device"}
        elif any(isinstance(a, torch.device)
                 for a in pytree.tree_leaves((node.args, node.kwargs))):
            bound.append(str(node.target))
    if bound:
        raise ValueError(f"{name} is bound to a device by {bound[:5]}")
    ep.graph_module.recompile()


def _export(predictor, rebuild, leaves, example, out_path: str) -> None:
    with torch.no_grad():
        ep = torch.export.export(
            _Program(predictor, rebuild), (leaves, example),
            dynamic_shapes=([None] * len(leaves),
                            {0: torch.export.Dim.AUTO}))
    name = os.path.basename(out_path)
    images = [n for n in ep.graph.nodes if n.op == "placeholder"][-1]
    if not isinstance(images.meta["val"].shape[0], torch.SymInt):
        raise ValueError(f"{name}: the trace specialized the batch to "
                         f"{images.meta['val'].shape[0]}")
    _device_free(ep, name)
    # torch.export.save would store the example inputs: the weights
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    # the archive is stored uncompressed; deflated, its graph (JSON with
    # the source lines of every node) shrinks ~30x, and torch.export.load
    # reads it as it is
    with zipfile.ZipFile(buf) as src, \
            zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as dst:
        for info in src.infolist():
            dst.writestr(info.filename, src.read(info.filename))


def export_predictor(predictor: serving.Predictor, out_dir: str, *,
                     input_dtypes: Sequence = (np.uint8, np.float32),
                     include_clip: bool | None = None) -> dict:
    """Write a live Predictor's forward and weights into ``out_dir``,
    traced on the predictor's device; returns the manifest.

    One ``fwd_<dtype>.pt2`` per entry of ``input_dtypes``.
    ``include_clip`` also exports the clip forward (``clip_<dtype>.pt2``:
    a symbolic batch of ``clip_length`` frames), so that a loaded artifact
    serves /predict_video; it defaults to True for clip configs
    (``cfg.clip_frames > 1``)."""
    if getattr(predictor, "replicas", ()):
        raise ValueError(
            "data_parallel predictors would pin the artifact to this "
            "host's topology; export a single-device predictor and enable "
            "data_parallel at serve time instead")
    if include_clip is None:
        include_clip = (predictor.supports_clips
                        and predictor.cfg.clip_frames > 1)
    if include_clip and not predictor.supports_clips:
        raise ValueError("include_clip=True needs a live predictor with "
                         "a clip forward")
    os.makedirs(out_dir, exist_ok=True)
    leaves, rebuild = _weight_leaves(predictor)
    leaves = [t.detach().contiguous() for t in leaves]
    size = predictor.cfg.image_size
    device = predictor.device
    kinds = [("fwd", (TRACE_BATCH, size, size, 3))]
    clip_t = None
    if include_clip:
        clip_t = int(predictor.clip_length)
        kinds.append(("clip", (TRACE_BATCH, clip_t, size, size, 3)))
    dtype_names = [np.dtype(dt).name for dt in input_dtypes]
    for kind, shape in kinds:
        for name in dtype_names:
            example = torch.zeros(shape, dtype=_dtype(name), device=device)
            _export(predictor, rebuild, leaves, example,
                    os.path.join(out_dir, _program_name(kind, name)))

    np_leaves = [t.cpu() for t in leaves]
    np.savez(os.path.join(out_dir, WEIGHTS),
             **{_leaf_key(i): t.reshape(-1).view(torch.uint8).numpy()
                for i, t in enumerate(np_leaves)})
    manifest = {
        "format_version": FORMAT_VERSION,
        "config": dataclasses.asdict(predictor.cfg),
        "int8": bool(predictor.int8),
        "buckets": list(predictor.buckets),
        # the device the programs were traced on; they serve on any
        "platforms": [device.type],
        "input_dtypes": dtype_names,
        # non-null: clip_<dtype>.pt2 exist and the artifact serves clips
        # of this length
        "clip_frames": clip_t,
        "leaves": [{"dtype": _dtype_name(t.dtype), "shape": list(t.shape)}
                   for t in np_leaves],
        "torch_version": torch.__version__,
    }
    # JSON-normalized (tuples -> lists), as a loader reads it back
    manifest = json.loads(json.dumps(manifest))
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def weight_bytes(manifest: dict) -> int:
    """Bytes of the artifact's weight leaves."""
    return sum(math.prod(leaf["shape"]) * _dtype(leaf["dtype"]).itemsize
               for leaf in manifest["leaves"])


def load_weights(artifact_dir: str, manifest: dict, device=None
                 ) -> list[torch.Tensor]:
    """``weights.npz``'s raw bytes -> the typed leaf list (export order) on
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    out = []
    with np.load(os.path.join(artifact_dir, WEIGHTS)) as z:
        for i, meta in enumerate(manifest["leaves"]):
            raw = torch.from_numpy(z[_leaf_key(i)].copy())
            out.append(raw.view(_dtype(meta["dtype"]))
                       .reshape(meta["shape"]).to(device))
    return out


class ExportedPredictor(serving.BucketedPredictor):
    """Serve an exported artifact with the live Predictor's interface
    (predict_arrays, predict_bytes, clips, warmup, the DynamicBatcher and
    HTTP server), built from ``manifest.json``, ``weights.npz`` and the
    programs alone, on ``device`` (default ``cuda``).  ``data_parallel``
    serves one replica of the weights a local card (``devices``), as the
    live Predictor does: artifacts are exported single-device and stay
    portable across topologies."""

    def __init__(self, artifact_dir: str, *,
                 stats: serving.ServingStats | None = None,
                 data_parallel: bool = False, devices=None, device=None):
        with open(os.path.join(artifact_dir, MANIFEST)) as f:
            manifest = json.load(f)
        if manifest["format_version"] != FORMAT_VERSION:
            raise ValueError(
                f"artifact format {manifest['format_version']} != "
                f"supported {FORMAT_VERSION}")
        self.manifest = manifest
        self.cfg = config_lib.TrainConfig(**manifest["config"])
        self.spec = get_dataset(self.cfg.dataset)
        self.int8 = bool(manifest["int8"])
        self.device = resolve_device(device)
        self.stats = stats or serving.ServingStats()
        self.buckets = self._init_data_parallel(
            data_parallel, manifest["buckets"], devices)
        self._weights = (
            tuple(load_weights(artifact_dir, manifest, d)
                  for d in self.replicas) if self.replicas
            else load_weights(artifact_dir, manifest, self.device))

        # the ExportedPrograms by (input rank, dtype name), and their
        # callable modules
        kinds = {4: "fwd"}
        self.clip_t = manifest.get("clip_frames")
        if self.clip_t:
            kinds[5] = "clip"
            self.supports_clips = True
        self.programs = {
            (ndim, name): torch.export.load(os.path.join(
                artifact_dir, _program_name(kind, name)))
            for ndim, kind in kinds.items()
            for name in manifest["input_dtypes"]}
        # the graphs, called on the flat (leaves..., images): see the
        # module docstring on the batch range
        self._graphs = {key: ep.graph_module
                        for key, ep in self.programs.items()}

    @torch.inference_mode()
    def logits(self, weights, images, device=None) -> torch.Tensor:
        """float32 logits on ``device`` (default the predictor's; the
        weights' own) of (B, S, S, 3) images or, where the artifact has
        clip programs, (B, T, S, S, 3) clips."""
        images = serving.as_device_tensor(images, device or self.device)
        size = self.cfg.image_size
        frames = (self.clip_t,) if images.ndim == 5 else ()
        if images.ndim not in (4, 5) or (images.ndim == 5
                                         and not self.supports_clips):
            raise ValueError(f"no program for {images.ndim}-D input")
        want = frames + (size, size, 3)
        if tuple(images.shape[1:]) != want:
            raise ValueError(f"the programs take (B, *{want}) inputs, got "
                             f"{tuple(images.shape)}")
        name = _dtype_name(images.dtype)
        graph = self._graphs.get((images.ndim, name))
        if graph is None:
            raise TypeError(
                f"artifact exports input dtypes "
                f"{self.manifest['input_dtypes']}; got {name} (re-export "
                f"with export_predictor(input_dtypes=...))")
        (logits,) = graph(*weights, images)
        return logits

    def warmup(self, dtypes=None):
        """The manifest's exported dtypes by default: the base class's
        uint8 would fail on an artifact exported for float32 only."""
        if dtypes is None:
            dtypes = [np.dtype(n) for n in self.manifest["input_dtypes"]]
        super().warmup(dtypes)


def load_exported(artifact_dir: str, *,
                  stats: serving.ServingStats | None = None,
                  data_parallel: bool = False, devices=None,
                  device=None) -> ExportedPredictor:
    return ExportedPredictor(artifact_dir, stats=stats,
                             data_parallel=data_parallel, devices=devices,
                             device=device)
