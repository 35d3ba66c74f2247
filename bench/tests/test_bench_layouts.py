"""The layout seam: the dense layout gives, bit for bit, the counts and
weights that the harness gave before the seam at both configurations'
sizes; a layout written as new files runs a cell with no harness file
edited; a configuration without a layout is refused."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchtiny import TINY
from harness import weights as W
from harness.spec import load_cell
from layouts import layout_of, load_layout

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = {n: json.loads((ROOT / "bench" / "configs" / f"{n}.json")
                         .read_text())
           for n in ("mistral-nemo-12b", "qwen2-1.5b")}
dense = load_layout("dense")

# What the harness's own arithmetic (harness/flops.py before the layout
# seam) gave at each configuration's sizes.
FROZEN = {
    "mistral-nemo-12b": {
        "layer_weights": 272629760,
        "prompt_flops": (70096215080960.0, 445308920135680.0),
        "decode_flops": 200972697600.0,
        "prefill_attention": (3093383086080.0, 2516582400.0),
        "decode_attention": (7418019840.0, 1875595200.0)},
    "qwen2-1.5b": {
        "layer_weights": 46792704,
        "prompt_flops": (8862322262016.0, 66024113307648.0),
        "decode_flops": 28832071680.0,
        "prefill_attention": (812013060096.0, 616562688.0),
        "decode_attention": (1947230208.0, 330126496.0)},
}
# sha256 of layer 3's tensors at seed 2**31 + 977 on the CPU, and of the
# tiny configuration's layer 1 and of its embedding, head and final norm,
# as harness/weights.py made them before the seam.
FROZEN_LAYER = {
    "mistral-nemo-12b":
        "ca764bacdcbf51d1e151dfde2500ea816b491af8e257f22d26cb2726801f4af8",
    "qwen2-1.5b":
        "5e39e7a933eb2cb30c26dc361533d20f712a1dc9cc5bfc9b3a04243730529691",
}
FROZEN_TINY = {
    True: (
        "3755850620e0720d39ad40f9d07d6568f7a9ba76d480a887308babdfc0f5174b",
        "d6bfdf0ede120dc7183804dc9262bb5e9989727362c60e6e475e150e0f6d8845"),
    False: (
        "e6f7ef8a3fc73eece8e33f2057bf051bd73a98b601d153c6aa5b8fb8ef37e9e8",
        "dd85df0d257e0f6d2dcf8fb9fdb9d418ccc63ecfa06da047723fd4a07d6a21c8"),
}


def _digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].contiguous()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else \
            t.view(torch.int32)
        h.update(k.encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dense_counts_are_the_harness_s_own(name):
    d, want = dense.dims(CONFIGS[name]), FROZEN[name]
    assert dense.layer_weights(d) == want["layer_weights"]
    assert (dense.prompt_flops(d, 3072),
            dense.prompt_flops(d, 16384)) == want["prompt_flops"]
    assert dense.decode_flops(d, 3000, 8) == want["decode_flops"]
    assert dense.prefill_attention(d, 3072) == want["prefill_attention"]
    assert dense.decode_attention(d, [1, 17, 3001, 8300], 32, 16) == \
        want["decode_attention"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dense_weights_are_the_harness_s_own(name):
    layer = W.layer(CONFIGS[name], 2**31 + 977, 3, "cpu")
    assert _digest(layer) == FROZEN_LAYER[name]


@pytest.mark.parametrize("bias", [True, False])
def test_dense_tiny_weights_are_the_harness_s_own(bias):
    cfg = dict(TINY, attention_bias=bias, torch_dtype="bfloat16",
               tie_word_embeddings=not bias)
    ends = {"e": W.embed(cfg, 5, "cpu"), "h": W.head(cfg, 5, "cpu"),
            "f": W.final_norm(cfg, 5, "cpu")}
    assert (_digest(W.layer(cfg, 2**33 + 1, 1, "cpu")), _digest(ends)) == \
        FROZEN_TINY[bias]


def test_a_configuration_without_a_layout_is_refused(tmp_path):
    with pytest.raises(ValueError, match="names no layout"):
        layout_of({k: v for k, v in TINY.items() if k != "layout"})
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.pop("layout")
        (tmp_path / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        with pytest.raises(ValueError, match="names no layout"):
            load_cell(w["name"], root=tmp_path)


@pytest.mark.parametrize("name", ["../dense", "no_such_layout", "", None])
def test_a_layout_that_is_not_a_module_here_is_refused(name):
    with pytest.raises(ValueError):
        load_layout(name)


def test_a_layout_without_the_interface_is_refused(tmp_path):
    (tmp_path / "half.py").write_text("def dims(cfg):\n    return {}\n")
    with pytest.raises(ValueError, match="lacks layer_leaves"):
        load_layout("half", tmp_path)


# A layout of its own: the dense block with its leaves drawn in another
# order, so that its weights are not the dense layout's.
NEW_LAYOUT = '''
from layouts import load_layout

_dense = load_layout("dense")
dims, layer_norms = _dense.dims, _dense.layer_norms
model_config, make_params = _dense.model_config, _dense.make_params
prompt_flops, decode_flops = _dense.prompt_flops, _dense.decode_flops
prefill_attention = _dense.prefill_attention
decode_attention = _dense.decode_attention


def layer_leaves(d, li):
    return _dense.layer_leaves(d, li)[::-1]
'''
NEW_REFERENCE = "from reference.dense import served_gaps  # noqa: F401\n"
NEW_RUN = r"""
import json, sys
sys.path[:0] = [sys.argv[1] + "/bench/tests", sys.argv[1] + "/bench",
                sys.argv[2] + "/src"]
from benchtiny import TINY, tiny_cell
from harness import runner, weights as W
from layouts import layout_of
cfg = dict(TINY, layout="shuffled")
lay = layout_of(cfg)
a, b = W.layer(cfg, 3, 0, "cpu"), W.layer(TINY, 3, 0, "cpu")
out = runner.run(tiny_cell(layout="shuffled"), 3, 1.0, False, "cpu", 0.0,
                 log=lambda s: None)
print(json.dumps({"file": lay.__file__, "correct": out["correct"],
                  "gap": out["checks"]["logit_gap"]["value"],
                  "same": all(bool((a[k] == b[k]).all()) for k in a)}))
"""


def test_a_new_layout_runs_as_new_files_alone(tmp_path):
    """A copy of the benchmark, with a layout and its reference added as
    new files and nothing else changed, serves a tiny cell of that layout
    correctly, its weights drawn in the layout's own order."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    (tmp_path / "bench/layouts/shuffled.py").write_text(NEW_LAYOUT)
    (tmp_path / "bench/reference/shuffled.py").write_text(NEW_REFERENCE)
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "bench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        Path("bench/layouts/shuffled.py"), Path("bench/reference/shuffled.py")}
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", NEW_RUN, str(tmp_path),
                        str(ROOT)], capture_output=True, text=True, env=env,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert Path(res["file"]) == tmp_path / "bench/layouts/shuffled.py"
    assert res["correct"] is True and res["gap"] <= 1e-3
    assert res["same"] is False
