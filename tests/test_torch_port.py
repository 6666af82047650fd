"""Boundaries of the PyTorch port: it never imports jax or the JAX
package, and an entry point asked for ``cuda`` on a host without a card
raises instead of running on the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "cpd_tpu"):
    sys.modules[name] = None          # any import of these now raises
import cpd_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(cpd_tpu_torch.__path__,
                                              "cpd_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
for helper in ("kv_case", "bound_ms", "time_ms", "kernel_phase",
               "serve_phase", "card_line", "quantize_phase", "train_phase",
               "sr_quantize_phase", "sr_train_phase", "qgemm_phase",
               "flash_phase", "lm_phase", "mha_phase", "bench_lm_phase",
               "main"):
    assert callable(getattr(chip_smoke, helper)), helper
leaked = sorted(k for k, v in sys.modules.items() if v is not None and (
    k.split(".")[0] in ("jax", "jaxlib", "flax", "cpd_tpu")))
assert not leaked, leaked
print("modules", len(mods))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split()[-1])
    assert n >= 40, out.stdout


def test_sources_name_no_jax_import():
    """No module of the port, and not chip_smoke.py, names jax, flax or
    cpd_tpu in an import statement (lazy imports included)."""
    banned = {"jax", "jaxlib", "flax", "optax", "cpd_tpu"}
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO, "cpd_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    bad = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}:{node.lineno}: {n}" for n in names
                    if n.split(".")[0] in banned]
    assert len(paths) >= 42 and bad == []


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    from cpd_tpu_torch import resolve_device
    from cpd_tpu_torch.models import transformer_lm
    from cpd_tpu_torch.serve import ServeEngine

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        transformer_lm(vocab_size=64, d_model=32, n_layers=1, n_heads=4)
    cpu_model = transformer_lm(vocab_size=64, d_model=32, n_layers=1,
                               n_heads=4, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cpu_model, n_slots=2, max_seq=16, page_size=8)
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the smoke run would really run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
