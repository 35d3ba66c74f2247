"""The port stands alone: neither ``repro_torch`` nor ``chip_smoke.py``
imports JAX or the JAX package, and an entry point asked for CUDA on a
machine without it raises instead of running on the CPU."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")


def _py_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(_py_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import_statement(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def _clean_env():
    # Without src on PYTHONPATH: src/sitecustomize.py (the JAX package's
    # compatibility shims) would import jax into every interpreter.
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_importing_every_module_loads_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages([PKG],
                                                        "repro_torch."))
    assert "repro_torch.serve.engine" in mods and len(mods) > 15
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {os.path.abspath(SRC)!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "rc = chip_smoke.main() if not __import__('torch').cuda"
        ".is_available() else 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('CLEAN', rc)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("CLEAN")
    if not torch.cuda.is_available():
        assert line != "CLEAN 0"        # chip_smoke fails without a card


def test_chip_smoke_fails_without_card_or_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the no-card failure needs a machine without CUDA")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_cuda_requested_without_cuda_raises(monkeypatch):
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_lm, make_cache
    from repro_torch.serve import Engine
    from repro_torch.weights import params_from_jax

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["tinyllama-1.1b"].smoke()
    params = init_lm(cfg, device="cpu")
    for call in (lambda: Engine(cfg, params),              # default: cuda
                 lambda: Engine(cfg, params, device="cuda"),
                 lambda: init_lm(cfg, device="cuda"),
                 lambda: make_cache(cfg, 1, 8, device="cuda"),
                 lambda: params_from_jax({}, cfg, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
