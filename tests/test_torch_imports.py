"""The port imports nothing of JAX or of the JAX package, nor TensorFlow,
Orbax, tensorstore, Grain, absl, CLU, TensorBoard, ArrayRecord or PIL (the card's
machine has none of them): a static scan of every module of
attentionalpoolingaction_torch/ and of chip_smoke.py.  Static, because an
interpreter may have JAX loaded already.  OpenCV is imported in five
places only: ``data/jpeg.py``'s CPU decoder, the default JPEG encoder
of ``data/records.py`` (``write_synthetic_dataset``, and HMDB51's
converter), serving's video-container decoder
(``serving.decode_video_frames``) and the HMDB51 converter's frame reader
(``data/convert_hmdb.extract_frames``); and ``chip_smoke.py`` writes its
test videos with OpenCV where it is installed (``convert_hmdb_raw``).
The modules of the card's path, and the dataset converters, import with
cv2, tensorflow and grain unavailable."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "attentionalpoolingaction_tpu",
             "tensorflow", "orbax", "tensorstore", "grain", "absl", "clu",
             "tensorboard", "array_record", "PIL"}
# (module, function) pairs that may import cv2, and nothing else may
CV2_ALLOWED = {("attentionalpoolingaction_torch/data/jpeg.py", "_decode_cpu"),
               ("attentionalpoolingaction_torch/data/records.py",
                "_cv2_encode_jpeg"),
               ("attentionalpoolingaction_torch/serving.py",
                "decode_video_frames"),
               ("attentionalpoolingaction_torch/data/convert_hmdb.py",
                "extract_frames"),
               ("chip_smoke.py", "convert_hmdb_raw")}
FILES = sorted((ROOT / "attentionalpoolingaction_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _import_roots(node):
    if isinstance(node, ast.Import):
        for alias in node.names:
            yield alias.name.split(".")[0]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        yield node.module.split(".")[0]
    elif (isinstance(node, ast.Call)
          and getattr(node.func, "id", None) == "__import__"
          and node.args and isinstance(node.args[0], ast.Constant)):
        yield str(node.args[0].value).split(".")[0]


def imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        yield from _import_roots(node)


def cv2_importers(path):
    """The names of the functions of ``path`` that import cv2 (``None`` for
    an import outside any function)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []

    def visit(node, func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        if "cv2" in set(_import_roots(node)):
            found.append(func)
        for child in ast.iter_child_nodes(node):
            visit(child, func)

    visit(tree, None)
    return found


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_imports(path):
    assert path.exists(), path
    bad = sorted(set(imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    rel = path.relative_to(ROOT).as_posix()
    for func in cv2_importers(path):
        assert (rel, func) in CV2_ALLOWED, \
            f"{rel} imports cv2 in {func or 'the module'}"


def test_scan_sees_every_module():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for mod in ("config", "convert", "serving", "train", "precision",
                "checkpoint", "tf_checkpoint", "orbax_checkpoint",
                "evaluate", "ops/metrics",
                "ops/attn_pool", "ops/_build",
                "ops/attn_pool_cuda", "ops/heatmap", "models/resnet",
                "models/heads", "models/action_model", "models/factory",
                "train_cli", "eval_cli", "data/records", "data/native_io",
                "data/preprocessing", "data/jpeg", "data/grain_pipeline",
                "data/pipeline", "utils/metrics_writer", "utils/profiling",
                "models/inference", "data/png", "serve_cli", "predict_cli",
                "export", "export_cli", "utils/visualize", "visualize_cli",
                "convert_cli", "data/convert_mpii", "data/convert_hico",
                "data/convert_hmdb"):
        assert f"attentionalpoolingaction_torch/{mod}.py" in names
    assert set(cv2_importers(
        ROOT / "attentionalpoolingaction_torch/data/jpeg.py")) == {
        "_decode_cpu"}


def test_scan_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom jax import numpy\n"
                 "import attentionalpoolingaction_tpu.config\n"
                 "import tensorflow as tf\nfrom orbax import checkpoint\n"
                 "import grain\nfrom absl import app\nimport PIL.Image\n"
                 "import cv2\n\ndef f():\n    import cv2\n")
    assert set(imported_roots(p)) & FORBIDDEN == {
        "jax", "attentionalpoolingaction_tpu", "tensorflow", "orbax",
        "grain", "absl", "PIL"}
    assert cv2_importers(p) == [None, "f"]


def test_card_path_imports_without_host_libraries():
    """The card's path imports with cv2, tensorflow and grain set to None
    in sys.modules (an import of any of them would raise)."""
    code = (
        "import sys\n"
        "for m in ('cv2', 'tensorflow', 'grain', 'jax', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import attentionalpoolingaction_torch.train_cli\n"
        "import attentionalpoolingaction_torch.orbax_checkpoint\n"
        "import attentionalpoolingaction_torch.eval_cli\n"
        "import attentionalpoolingaction_torch.data.grain_pipeline\n"
        "import attentionalpoolingaction_torch.data.pipeline\n"
        "import attentionalpoolingaction_torch.data.jpeg\n"
        "import attentionalpoolingaction_torch.utils.profiling\n"
        "import attentionalpoolingaction_torch.serving\n"
        "import attentionalpoolingaction_torch.serve_cli\n"
        "import attentionalpoolingaction_torch.predict_cli\n"
        "import attentionalpoolingaction_torch.models.inference\n"
        "import attentionalpoolingaction_torch.data.png\n"
        "import attentionalpoolingaction_torch.export\n"
        "import attentionalpoolingaction_torch.export_cli\n"
        "import attentionalpoolingaction_torch.utils.visualize\n"
        "import attentionalpoolingaction_torch.visualize_cli\n"
        "import attentionalpoolingaction_torch.convert_cli\n"
        "import attentionalpoolingaction_torch.data.convert_mpii\n"
        "import attentionalpoolingaction_torch.data.convert_hico\n"
        "import attentionalpoolingaction_torch.data.convert_hmdb\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stderr[-3000:]
