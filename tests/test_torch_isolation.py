"""The port stands alone: neither ``repro_torch`` (its training
subpackages ``train``, ``data``, ``ft`` and ``launch`` included) nor
``chip_smoke.py`` imports JAX or the JAX package, and an entry point asked
for CUDA on a machine without it (the training CLI by default) raises
instead of running on the CPU."""
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
    for m in ("repro_torch.serve.engine", "repro_torch.models.mamba2",
              "repro_torch.kernels.mamba2_ssd", "repro_torch.core.lifeline",
              "repro_torch.core.stats", "repro_torch.configs.mamba2_130m",
              "repro_torch.core.scheduler", "repro_torch.core.taskbag",
              "repro_torch.problems.uts", "repro_torch.kernels.uts_expand",
              "repro_torch.models.moe", "repro_torch.models.glb_moe",
              "repro_torch.kernels.moe_gmm",
              "repro_torch.configs.moonshot_v1_16b_a3b",
              "repro_torch.serve.cost", "repro_torch.obs.slo",
              "repro_torch.obs.flight", "repro_torch.obs.analyze",
              "repro_torch.configs.registry",
              "repro_torch.configs.zamba2_7b",
              "repro_torch.configs.qwen2_vl_2b",
              "repro_torch.configs.musicgen_medium",
              "repro_torch.configs.mistral_nemo_12b",
              "repro_torch.configs.qwen1_5_110b",
              "repro_torch.kernels.autograd",
              "repro_torch.train.optimizer", "repro_torch.train.trainer",
              "repro_torch.data.pipeline", "repro_torch.ft.checkpoint",
              "repro_torch.launch.train", "repro_torch.launch.mesh",
              "repro_torch.launch.ranks", "repro_torch.core.executor",
              "repro_torch.dist.collectives", "repro_torch.dist.sharding",
              "repro_torch.dist.compress", "repro_torch.dist.pipeline"):
        assert m in mods, m
    assert len(mods) > 20
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
    from repro_torch.core import GLB, run_sim
    from repro_torch.launch.train import train
    from repro_torch.train.trainer import init_train_state
    from repro_torch.problems.fib import fib_problem
    from repro_torch.models import init_lm, make_cache
    from repro_torch.serve import Engine, GLBReplicaBalancer
    from repro_torch.weights import params_from_jax

    class Mesh:                       # shape and names, as a DeviceMesh
        shape = (2,)
        mesh_dim_names = ("place",)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["tinyllama-1.1b"].smoke()
    params = init_lm(cfg, device="cpu")
    scfg = ARCHS["mamba2-130m"].smoke()
    sparams = init_lm(scfg, device="cpu")
    mcfg = ARCHS["moonshot-v1-16b-a3b"].smoke()
    mparams = init_lm(mcfg, device="cpu")
    hcfg = ARCHS["zamba2-7b"].smoke()
    hparams = init_lm(hcfg, device="cpu")
    for call in (lambda: Engine(cfg, params),              # default: cuda
                 lambda: Engine(cfg, params, device="cuda"),
                 lambda: init_lm(cfg, device="cuda"),
                 lambda: make_cache(cfg, 1, 8, device="cuda"),
                 lambda: params_from_jax({}, cfg, device="cuda"),
                 lambda: Engine(scfg, sparams),
                 lambda: GLBReplicaBalancer([Engine(scfg, sparams)
                                             for _ in range(2)]),
                 lambda: init_lm(scfg),
                 lambda: make_cache(scfg, 1, 8),
                 lambda: Engine(mcfg, mparams),
                 lambda: init_lm(mcfg),
                 lambda: Engine(hcfg, hparams),
                 lambda: init_lm(hcfg),
                 lambda: make_cache(hcfg, 1, 8),
                 lambda: init_lm(ARCHS["qwen2-vl-2b"].smoke()),
                 lambda: init_lm(ARCHS["musicgen-medium"].smoke()),
                 lambda: run_sim(fib_problem(8), 2),        # default: cuda
                 lambda: run_sim(fib_problem(8), 2, device="cuda"),
                 lambda: GLB(fib_problem(8), P=2).run(),
                 lambda: GLB(fib_problem(8), mesh=Mesh(),
                             mode="shard_map").run(),     # default: cuda
                 lambda: init_train_state(cfg),             # default: cuda
                 lambda: train(["--arch", "tinyllama-1.1b", "--steps",
                                "1"]),                      # default: cuda
                 lambda: train(["--arch", "mamba2-130m", "--steps", "1",
                                "--device", "cuda"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
