"""The port imports nothing of JAX or of the JAX package, nor TensorFlow
or Orbax (the card's machine has neither): a static scan of every module
of attentionalpoolingaction_torch/ and of chip_smoke.py.  Static, because
an interpreter may have JAX loaded already."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "attentionalpoolingaction_tpu",
             "tensorflow", "orbax"}
FILES = sorted((ROOT / "attentionalpoolingaction_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_imports(path):
    assert path.exists(), path
    bad = sorted(set(imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_every_module():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for mod in ("config", "convert", "serving", "train", "precision",
                "checkpoint", "tf_checkpoint", "evaluate", "ops/metrics",
                "ops/attn_pool",
                "ops/attn_pool_cuda", "ops/heatmap", "models/resnet",
                "models/heads", "models/action_model", "models/factory"):
        assert f"attentionalpoolingaction_torch/{mod}.py" in names


def test_scan_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom jax import numpy\n"
                 "import attentionalpoolingaction_tpu.config\n"
                 "import tensorflow as tf\nfrom orbax import checkpoint\n")
    assert set(imported_roots(p)) & FORBIDDEN == {
        "jax", "attentionalpoolingaction_tpu", "tensorflow", "orbax"}
