"""A tiny dense configuration and cell for the benchmark's CPU tests (the
backlog cell's metric lists are those of ``nemo-docqa-batch`` in
``BENCHMARK.json``; the open loop, which no cell there runs yet, reports
the metrics its readers under ``bench/metrics/`` give)."""
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent

TINY = {
    "name": "tiny-dense", "family": "dense", "layout": "dense",
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "vocab_size": 500, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "attention_bias": True,
    "torch_dtype": "float32",
    "engine": {"max_slots": 4, "max_seq": 96, "pad_len": 64,
               "block_size": 16, "steps_per_sync": 4},
}
LENGTHS = {
    "prompt": {"dist": "lognormal", "median": 32, "sigma": 0.6, "min": 8,
               "max": 64, "block": 8},
    "output": {"dist": "lognormal", "median": 6, "sigma": 0.8, "min": 2,
               "max": 16, "block": 8},
}
OPEN_LOOP = {
    "end_to_end": [{"name": "ttft_p90_ms", "unit": "ms"},
                   {"name": "tpot_p90_ms", "unit": "ms"}],
    "per_layer": [{"name": "queue_wait_p90_ms.poisson", "unit": "ms"},
                  {"name": "device_idle.poisson", "unit": "%"}],
}


def tiny_cell(kind: str = "backlog", limit: float = 0.05, **config):
    """The tiny configuration under the docqa lengths cut down, as a
    backlog or an open-loop cell."""
    from harness.spec import Cell

    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cfg = dict(TINY, **config)
    name = "nemo-docqa-batch"
    apply = lambda m: "workloads" not in m or name in m["workloads"]
    end_to_end = [m for m in spec["end_to_end"] if apply(m)]
    per_layer = [m for m in spec["per_layer"] if apply(m)]
    if kind == "backlog":
        load = {"kind": "backlog", "warm_steps": 1}
    else:
        load = {"kind": "poisson", "rate_per_s": 20.0, "warmup_s": 0.3}
        name = "tiny-docqa-poisson"
        end_to_end = OPEN_LOOP["end_to_end"] + [
            m for m in end_to_end if m["name"] == "setup_s"]
        per_layer = OPEN_LOOP["per_layer"]
    return Cell(name=name, config=cfg, traffic=dict(LENGTHS, load=load),
                engine=dict(cfg["engine"]),
                limits={"logit_gap": {"limit": limit, "sample": 4}},
                chips=1, end_to_end=end_to_end, per_layer=per_layer)
