"""The ``mla_moe`` layout (Moonlight-16B-A3B): its counts by hand at the
published sizes, its weights regenerated bit for bit, its reference
against the float8 control at a tiny size, the two readers it brings
(``mla_decode_roofline.batch``, ``moe_gmm_roofline.batch``) by hand and
silent without what they read, and a tiny cell of the layout served end
to end through the harness."""
import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchtiny import LENGTHS
from harness import flops, runner
from harness import weights as W
from harness.serve import Step
from harness.spec import Cell, load_cell, reader
from layouts import load_layout

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "bench/configs/moonlight-16b-a3b.json")
                    .read_text())
lay = load_layout("mla_moe")
CELL = "moonlight-docqa-batch"
SEED = 2**31 + 4099

TINY = dict(CONFIG, name="tiny-mla", hidden_size=64, intermediate_size=96,
            num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
            num_experts_per_tok=2, n_shared_experts=1,
            moe_intermediate_size=24, vocab_size=500)
# sha256 of the tiny configuration's layers 0 (dense) and 2 (routed) at
# seed 2**33 + 1 on the CPU, as harness/weights.py draws them in this
# layout's order
FROZEN_TINY = (
    "1a4f6dddadfe15221599eede7d23365320f1ce2e6c33e9c405e2ebdb02cf6d7b",
    "ce77775c47a2acec78135e73a4c4eff7a32d289ce9c348ed77e51eea7b826260")


def _digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].contiguous()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else \
            t.view(torch.int32)
        h.update(k.encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def test_the_published_widths_and_only_max_slots_cut():
    d = lay.dims(CONFIG)
    assert (d["L"], d["D"], d["V"], d["H"], d["r"], d["dn"], d["dr"],
            d["dv"]) == (27, 2048, 163840, 16, 512, 128, 64, 128)
    assert (d["E"], d["Fe"], d["K"], d["Es"], d["F"], d["dense"]) == \
        (64, 1408, 6, 2, 11264, 1)
    assert CONFIG["reduced"] == ["max_slots"] and "max_slots_why" in CONFIG
    with pytest.raises(ValueError, match="q_lora_rank"):
        lay.dims(dict(CONFIG, q_lora_rank=1536))
    with pytest.raises(ValueError, match="scoring_func"):
        lay.dims(dict(CONFIG, scoring_func="softmax"))


def test_counts_by_hand_at_moonlight_s_sizes():
    d = lay.dims(CONFIG)
    attn = (2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256
            + 16 * 128 * 2048)                              # 13,762,560
    assert lay.attention_weights(d) == attn == 13_762_560
    dense = 3 * 2048 * 11264
    routed_active = 3 * 2048 * 1408 * (6 + 2) + 2048 * 64
    active = 27 * attn + dense + 26 * routed_active
    assert lay.active_weights(d) == active == 2_243_559_424     # 2.24e9
    every = (2 * 163840 * 2048 + 27 * (attn + 2 * 2048 + 512) + dense
             + 26 * (3 * 2048 * 1408 * 66 + 2048 * 64 + 64) + 2048)
    assert lay.param_count(d) == every
    assert round(every / 1e9, 2) == 15.96
    # a prompt token: 4.49 GFLOP of products; a pair: 10,240 FLOPs a layer
    pair = 2 * 16 * (192 + 128)
    assert lay.prompt_flops(d, 1) == 2 * active + pair * 27 + 2 * 2048 * \
        163840
    assert lay.decode_flops(d, 9, 2) == (
        2 * (2 * active + 2 * 2048 * 163840) + pair * 27 * (10 + 11))
    f, b = lay.prefill_attention(d, 100)
    assert f == pair * 100 * 101 / 2 * 27
    assert b == 2 * 100 * 16 * (2 * 192 + 2 * 128) * 27
    # decode: the absorbed form, one 576-wide row a key (31,104 B a token
    # over 27 layers)
    f, b = lay.decode_attention(d, [1, 17], slots=3, block_size=16)
    assert f == 2 * 16 * (576 + 512) * 18 * 27
    assert b == (2 * 3 * 16 * (576 + 512) + 4 * 3
                 + 2 * 576 * 18 + 4 * (1 + 2)) * 27
    assert 2 * 576 * 27 == 31_104
    f, b = lay.gmm_work(d, 10, 3)
    assert f == 3 * 2 * 10 * 2048 * 1408
    assert b == 2 * (3 * 3 * 2048 * 1408 + 10 * 3 * (2048 + 1408))


def test_weights_are_regenerated_bit_for_bit():
    a = W.layer(TINY, 2**33 + 1, 0, "cpu")
    b = W.layer(TINY, 2**33 + 1, 2, "cpu")
    assert (_digest(a), _digest(b)) == FROZEN_TINY
    assert "gate" in a and "router" not in a
    assert b["wg"].shape == (8, 64, 24) and b["router_bias"].shape == (8,)
    again = W.layer(TINY, 2**33 + 1, 2, "cpu")
    assert all(torch.equal(again[k], b[k]) for k in b)
    other = W.layer(TINY, 2**33 + 2, 2, "cpu")
    assert not torch.equal(other["wg"], b["wg"])


def test_reference_against_its_float8_control():
    """The reference's own greedy tokens read gap 0 at every position;
    the float8 network moves the logits, and its first choices are read
    against the float32 best as the control's gaps."""
    from reference import mla_moe as ref

    cfg = dict(TINY, torch_dtype="float32")
    prompt = list(range(3, 40))
    lg = ref.logits_at(cfg, SEED, [(prompt, 0)], "cpu", ("f32", "fp8"))
    z, c = lg["f32"][0], lg["fp8"][0]
    assert z.shape == c.shape == (37, 500)
    assert (c - z).abs().max() > 1e-3
    out = _greedy(ref, cfg, prompt, 6)
    res = ref.served_gaps(cfg, SEED, [(prompt, out)], "cpu", control=True)
    assert res["gap"] == [[0.0] * 6]
    assert len(res["control"][0]) == 6 and min(res["control"][0]) >= 0.0



def test_routing_is_held_to_the_program_s_choice_at_a_tie():
    """The program's experts are taken where each scores within ``TIE``
    of the reference's k-th best; past it, or where they are not k
    distinct experts, the reference routes on its own. The weights are
    the reference's scores of the experts taken."""
    from reference import mla_moe as ref

    d = {"E": 8, "K": 2, "scale": 2.0}
    s = torch.tensor([0.9, 0.8, 0.8 - ref.TIE / 2, 0.5, 0.4, 0.2, 0.1,
                      0.05])
    h = torch.logit(s).repeat(6, 1)
    held = torch.tensor([[0, 2], [2, 0], [0, 5], [0, 0], [-1, -1],
                         [0, 9]])
    stats = {"held": 0, "departed": 0, "max_deficit": 0.0}
    w, idx = ref.route(h, torch.eye(8), torch.zeros(8), d, held, stats)
    own = torch.tensor([0, 1])
    assert idx[0].tolist() == [0, 2] and idx[1].tolist() == [2, 0]
    for i in range(2, 6):
        assert idx[i].sort().values.tolist() == own.tolist()
    assert stats["held"] == 2 and stats["departed"] == 1
    assert abs(stats["max_deficit"] - 0.6) < 1e-5
    torch.testing.assert_close(w[0], 2.0 * s[[0, 2]] / s[[0, 2]].sum())
    w2, idx2 = ref.route(h, torch.eye(8), torch.zeros(8), d)
    assert (idx2.sort(-1).values == own).all()

def _greedy(ref, cfg, prompt, n):
    seq = list(prompt)
    for _ in range(n):
        z = ref.logits_at(cfg, SEED, [(seq, len(seq) - 1)], "cpu")["f32"][0]
        seq.append(int(z[-1].argmax()))
    return seq[len(prompt):]


# -------------------------------------------------------------- readers
ENGINE = {"max_slots": 4, "block_size": 16, "steps_per_sync": 2}
D = lay.dims(dict(TINY, num_hidden_layers=2))


def _span(events, name, tid, t0, t1, args=None, end=None):
    events.append({"name": name, "ph": "B", "ts": t0 * 1e6, "pid": 0,
                   "tid": tid, **({"args": args} if args else {})})
    events.append({"ph": "E", "ts": t1 * 1e6, "pid": 0, "tid": tid,
                   **({"args": end} if end else {})})


def _run(by_name, counters=True):
    """Two profiled steps: the first prefills a prompt of 5 tokens and
    decodes two slots, the second decodes one slot; MoE load on each
    phase span."""
    ev = []
    load = (lambda r, h: {"moe_rows": r, "moe_experts_hit": h,
                          "moe_max_rows": 1}) if counters else \
        (lambda r, h: {})
    _span(ev, "prefill", 1, 0.1, 0.2, {"rid": 0, "tokens": 5},
          {"tokens": 5, "rows": 16, **load(64, 8)})
    _span(ev, "decode_loop", 0, 0.25, 0.45, None,
          {"iters": 2, "active": 2, **load(32, 7)})
    _span(ev, "decode_loop", 0, 0.65, 0.85, None,
          {"iters": 2, "active": 1, **load(32, 6)})
    steps = [Step(0.0, 0.5, [5], [(5, 2), (30, 1)], 5, 3, True, True),
             Step(0.6, 0.9, [], [(31, 1)], 0, 1, True, True)]
    return SimpleNamespace(spans=ev, steps=steps, layout=lay, d=D,
                           engine=ENGINE,
                           trace=SimpleNamespace(by_name=by_name))


def test_latent_decode_roofline_by_hand():
    """Each decode iteration of the profiled steps at the absorbed form's
    bound, over the time of the kernels named mla_paged_decode."""
    def it(wins):
        f = sum(2 * 4 * (40 + 32) * w for w in wins) * 2
        b = (2 * 4 * 4 * (40 + 32) + 4 * 4
             + sum(2 * 40 * w + 4 * -(-w // 16) for w in wins)) * 2
        return max(f / 989e12, b / 3.35e12)

    want = it([6, 31]) + it([7]) + it([32]) + it([])
    run = _run({"void (anonymous namespace)::mla_paged_decode_kernel(...)":
                1e-6, "flash_attention_tc_kernel": 5.0})
    got = reader("mla_decode_roofline.batch")(run)
    assert got == pytest.approx(100.0 * want / 1e-6)


def test_gmm_roofline_by_hand():
    spent = 2e-6
    want = sum(flops.bound_s(*lay.gmm_work(D, r, h))
               for r, h in ((64, 8), (32, 7), (32, 6)))
    run = _run({"void (anonymous namespace)::gmm_tc_kernel<32, 128>(...)":
                spent / 2, "gmm_tc_kernel<16, 64>": spent / 2,
                "nvjet_gemm": 1.0})
    got = reader("moe_gmm_roofline.batch")(run)
    assert got == pytest.approx(100.0 * want / spent)
    # by hand: the prefill's 64 rows, 8 experts of 3 (64 x 24) matrices
    f, b = lay.gmm_work(D, 64, 8)
    assert (f, b) == (3 * 2 * 64 * 64 * 24,
                      2 * (8 * 3 * 64 * 24 + 64 * 3 * (64 + 24)))


@pytest.mark.parametrize("name", ["mla_decode_roofline.batch",
                                  "moe_gmm_roofline.batch"])
def test_the_new_readers_without_what_they_read_give_none(name):
    read = reader(name)
    kernels = {"mla_paged_decode_kernel": 1e-6, "gmm_tc_kernel": 1e-6}
    no_trace = _run(kernels)
    no_trace.trace = None
    assert read(no_trace) is None
    # the parent's program: no latent kernel, no gmm, no counters
    assert read(_run({"flash_attention_tc_kernel": 1e-3},
                     counters=False)) is None
    if name == "moe_gmm_roofline.batch":
        assert read(_run(kernels, counters=False)) is None
        spanless = _run(kernels)
        spanless.spans = None
        assert read(spanless) is None


# ------------------------------------------------------------- the cell
def test_the_cell_and_its_metrics():
    cell = load_cell(CELL)
    assert cell.config["layout"] == "mla_moe" and cell.chips == 1
    assert cell.engine == {"max_slots": 64, "max_seq": 8192,
                           "pad_len": 8064, "block_size": 16,
                           "steps_per_sync": 8}
    assert [m["name"] for m in cell.end_to_end] == ["tokens_per_s",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "engine_step_ms.batch", "mfu.batch", "attn_roofline.batch",
        "device_idle.batch", "prefill_ms.batch", "decode_iter_ms.batch",
        "step_host_ms.batch", "prefill_pad_share.batch",
        "mla_decode_roofline.batch", "moe_gmm_roofline.batch"]
    for other in ("nemo-docqa-batch", "qwen2-longdoc-batch"):
        names = [m["name"] for m in load_cell(other).per_layer]
        assert "mla_decode_roofline.batch" not in names


def test_a_tiny_cell_is_served_end_to_end():
    """The tiny configuration under the docqa lengths cut down, through
    the harness on the CPU: correct under a tight limit, the control not,
    and the span readers report (no profiler on the CPU, so the device
    readers give nothing)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = dict(TINY, torch_dtype="float32",
               engine={"max_slots": 4, "max_seq": 96, "pad_len": 64,
                       "block_size": 16, "steps_per_sync": 4})
    apply = lambda m: "workloads" not in m or CELL in m["workloads"]
    cell = Cell(name=CELL, config=cfg,
                traffic=dict(LENGTHS, load={"kind": "backlog",
                                            "warm_steps": 1}),
                engine=dict(cfg["engine"]),
                limits={"logit_gap": {"limit": 0.05, "sample": 4}},
                chips=1,
                end_to_end=[m for m in spec["end_to_end"] if apply(m)],
                per_layer=[m for m in spec["per_layer"] if apply(m)])
    out = runner.run(cell, SEED, 1.0, False, "cpu", 0.0, log=lambda s: None,
                     control=True)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["logit_gap"]["value"] <= 1e-3
    assert out["control"]["correct"] is False
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
    traced = runner.run(cell, SEED, 1.0, True, "cpu", 0.0,
                        log=lambda s: None)
    m = traced["metrics"]
    assert traced["correct"] is True
    assert 0 <= m["prefill_pad_share.batch"]["value"] < 50
    assert "mla_decode_roofline.batch" not in m
    assert "moe_gmm_roofline.batch" not in m
