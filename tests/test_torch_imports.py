"""The port stands alone: no module of ann3depth_tpu_torch, and none of
chip_smoke.py, probe_preprocess.py and probe_train_step.py, imports JAX,
its libraries or the JAX package, and none imports triton at module level
(it exists only on the machine with the card, so an import at module level
would break every CPU import)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ann3depth_tpu")
PORT_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "ann3depth_tpu_torch").rglob("*.py")) + [
        "chip_smoke.py", "probe_preprocess.py", "probe_train_step.py"]


def _imports(tree):
    """(top-level package, module-level?) of every import in the file."""
    module_level = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            yield name.split(".")[0], id(node) in module_level


def test_port_files_found():
    assert "ann3depth_tpu_torch/ops/fused_preprocess.py" in PORT_FILES
    for module in ("pipeline/feed.py", "pipeline/device_cache.py",
                   "pipeline/streaming_pool.py", "pipeline/grain_loader.py",
                   "train/dispatch.py", "ops/quant.py", "serving.py",
                   "parallel/multihost.py", "parallel/mesh.py",
                   "parallel/shard_step.py", "parallel/zero1.py",
                   "parallel/sharding_rules.py"):
        assert f"ann3depth_tpu_torch/{module}" in PORT_FILES
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_forbidden_imports(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for top, module_level in _imports(tree):
        assert top not in FORBIDDEN, f"{path} imports {top}"
        assert not (top == "triton" and module_level), \
            f"{path} imports triton at module level"


def test_import_checker_catches_forbidden_imports():
    bad = ast.parse("import jax.numpy\nfrom ann3depth_tpu.ops import resize\n"
                    "import triton\ndef f():\n    import triton\n")
    assert list(_imports(bad)) == [("jax", True), ("ann3depth_tpu", True),
                                   ("triton", True), ("triton", False)]


def test_chip_smoke_without_a_card_fails_and_prints_no_result():
    env = {k: v for k, v in os.environ.items()}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    it cannot import the port and must fail without a result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
