"""The port stands alone: ray_tpu_torch and chip_smoke.py import neither
JAX nor any module of the JAX package (the machine with the card has no
JAX), and chip_smoke.py refuses to run without a card."""

import ast
import json
import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_EVERY_MODULE = r"""
import importlib, json, pkgutil, sys
import ray_tpu_torch
names = ["ray_tpu_torch"]
for info in pkgutil.walk_packages(ray_tpu_torch.__path__, "ray_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ray_tpu"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def test_port_imports_no_jax_and_no_ray_tpu():
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_EVERY_MODULE],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == [], out["bad"]
    for mod in ("ray_tpu_torch.ops.flash_attention", "ray_tpu_torch.models.convert",
                "ray_tpu_torch.models.common", "ray_tpu_torch.serve.llm.engine",
                "ray_tpu_torch.ops._build", "ray_tpu_torch.models.llama",
                "ray_tpu_torch.models.resnet", "ray_tpu_torch.models.vit",
                "ray_tpu_torch.models.mlp", "ray_tpu_torch.models.moe"):
        assert mod in out["imported"]


def test_chip_smoke_imports_no_jax_and_no_ray_tpu():
    path = os.path.join(REPO_ROOT, "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported.append(node.module or "")
    assert "torch" in imported
    assert any(m.startswith("ray_tpu_torch") for m in imported)
    assert [m for m in imported if _forbidden(m)] == []


def test_chip_smoke_fails_without_a_card():
    """On a machine without CUDA it exits non-zero and prints no result."""
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
