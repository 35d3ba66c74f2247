"""Latent attention (MLA) and the shared-expert dropless MoE against the
plain float32 reference of the benchmark's ``mla_moe`` layout
(``bench/reference/mla_moe.py``, loaded by path with the benchmark's
weights), on the CPU at a tiny size: d 64, 4 heads, ``kv_lora_rank`` 32,
nope / rope / v 16 / 8 / 16, 8 experts top-2 with one shared, layer 0
dense, 3 layers, float32, seeded random weights.

What is held: prefill logits; prefill and then decode through
``Engine(paged=True)``'s latent cache against the reference's full
forward at every decoded position; the absorbed decode form against the
expanded one; the sigmoid router (the bias in the choice and not in the
weight, renormalised, times 2.446) and that no (token, k) row is dropped;
pad rows that leave real rows unchanged; the existing ``moe`` capacity
path untouched; the engine's latent leaf, block padding, MoE load
counters and the paths it refuses. No JAX: the JAX package has no MLA.

Tolerances: float32 on both sides, in other summation orders (the
engine's paged decode, the reference's blocked attention): 1e-4
absolute on logits of magnitude ~1.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models import forward, init_lm, make_paged_cache
from repro_torch.models import mla as mla_mod
from repro_torch.models.config import MLAConfig, ModelConfig
from repro_torch.models.moe import moe_fwd, moe_init, route_sigmoid
from repro_torch.obs import Tracer
from repro_torch.serve.engine import Engine, Request, pads_to_block

BENCH = Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import weights as W  # noqa: E402
from layouts import load_layout  # noqa: E402
from reference import mla_moe as ref  # noqa: E402

lay = load_layout("mla_moe")
TOL = dict(atol=1e-4, rtol=0)
SEED = 2**31 + 77

TINY = json.loads((BENCH / "configs" / "moonlight-16b-a3b.json").read_text())
TINY.update(name="tiny-mla", hidden_size=64, intermediate_size=96,
            num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
            num_experts_per_tok=2, n_shared_experts=1,
            moe_intermediate_size=24, vocab_size=500,
            torch_dtype="float32")


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    cfg = lay.model_config(TINY)
    return cfg, lay.make_params(TINY, cfg, SEED, "cpu")


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, 500, n).tolist()


def _ref_logits(seq, first=0):
    return ref.logits_at(TINY, SEED, [(seq, first)], "cpu")["f32"][0]


def test_the_configuration_is_the_published_one():
    cfg = lay.model_config(json.loads(
        (BENCH / "configs" / "moonlight-16b-a3b.json").read_text()))
    assert isinstance(cfg, MLAConfig) and cfg.is_mla and cfg.deepseek_moe
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.latent_dim) == (512, 128, 64, 128, 576)
    assert round(cfg.param_count() / 1e9, 2) == 15.96
    # a plain ModelConfig has no new fields: asdict stays the JAX one's
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    assert not names & {"kv_lora_rank", "routed_scale", "router"}
    assert ModelConfig("x", "dense", 1, 8).is_mla is False


def test_prefill_logits_match_the_reference(model):
    cfg, params = model
    seq = _tokens(37)
    got, _, aux = forward(params, cfg, torch.tensor([seq]), mode="prefill")
    want = _ref_logits(seq)
    np.testing.assert_allclose(got[0, :, :cfg.vocab].numpy(),
                               want.numpy(), **TOL)
    # every (token, k) row of the two MoE layers went through gmm
    assert aux["moe_load"][0].item() == 37 * 2 * 2


class _Recorder:
    """Wraps the engine's ``forward``: the logits of every active slot's
    position, keyed by (request id, position)."""

    def __init__(self, monkeypatch, eng):
        import repro_torch.serve.engine as E
        self.eng, self.got, real = eng, {}, E.forward

        def fwd(params, cfg, tokens, **kw):
            logits, cache, aux = real(params, cfg, tokens, **kw)
            if kw["mode"] == "decode":
                for b, L in enumerate(kw["cache_len"].tolist()):
                    req = self.eng.slots[b]
                    if L >= 0 and req is not None:
                        self.got[req.rid, L] = logits[b, 0].clone()
            else:
                req = self.pending
                n = len(req.prompt) + max(len(req.out) - 1, 0)
                self.got[req.rid, n - 1] = logits[0, n - 1].clone()
            return logits, cache, aux

        monkeypatch.setattr(E, "forward", fwd)
        real_admit = eng._admit_paged

        def admit(slot, req):
            self.pending = req
            return real_admit(slot, req)

        monkeypatch.setattr(eng, "_admit_paged", admit)


@pytest.mark.parametrize("slots", [1, 3])
def test_engine_prefill_then_decode_match_the_reference(model, monkeypatch,
                                                        slots):
    """Prefill into the reused row, the block copy into the latent pool,
    then paged decode: every position's logits equal the reference's full
    forward over the prompt and the served tokens."""
    cfg, params = model
    eng = Engine(cfg, params, max_slots=slots, max_seq=96, pad_len=64,
                 steps_per_sync=4, paged=True, block_size=16, device="cpu")
    assert set(eng.cache) == {"kv"}
    assert tuple(eng.cache["kv"].shape) == (3, slots * 6 + 1, 16, 40)
    rec = _Recorder(monkeypatch, eng)
    reqs = [Request(rid=i, prompt=_tokens(13 + 9 * i, i), max_new=7)
            for i in range(4)]
    for r in reqs:
        eng.submit(r)
    while not all(r.done for r in reqs):
        eng.step()
    for r in reqs:
        seq = r.prompt + r.out[:-1]
        want = _ref_logits(seq)
        for pos in range(len(r.prompt) - 1, len(seq)):
            got = rec.got[r.rid, pos][:cfg.vocab]
            np.testing.assert_allclose(got.numpy(), want[pos].numpy(),
                                       **TOL)
        # greedy: each served token is the reference's best there
        assert r.out == want[len(r.prompt) - 1:].argmax(-1).tolist()


def test_absorbed_decode_is_the_expanded_attention(model):
    """The absorbed form (queries through W_UK, one latent row a key,
    outputs through W_UV) over the paged pool equals the expanded form's
    last row."""
    cfg, params = model
    p = params["blocks"][1]["attn"]
    g = torch.Generator().manual_seed(3)
    S = 23
    x = torch.randn(1, S, cfg.d_model, generator=g)
    pos = torch.arange(S)[None]
    q_nope, q_pe = mla_mod._queries(p, x, pos, cfg)
    lat = mla_mod.latent_rows(p, x, pos, cfg)
    full = mla_mod.expanded_attention(p, q_nope, q_pe, lat, cfg)
    pool = torch.zeros(4, 8, cfg.latent_dim)
    table = torch.tensor([[2, 0, 3, 1]], dtype=torch.int32)
    for t in range(S):
        pool[table[0, t // 8], t % 8] = lat[0, t]
    o_lat = ops.latent_attention(
        mla_mod.absorb_queries(p, q_nope[:, -1:], q_pe[:, -1:], cfg), pool,
        table, torch.tensor([S], dtype=torch.int32),
        v_dim=cfg.kv_lora_rank, scale=mla_mod.softmax_scale(cfg))
    got = mla_mod.expand_values(p, o_lat, cfg)
    np.testing.assert_allclose(got[0].numpy(), full[0, -1].numpy(),
                               atol=1e-5, rtol=0)


def _router(E=8, K=2, D=16):
    cfg = lay.model_config(dict(TINY, num_experts_per_tok=K))
    g = torch.Generator().manual_seed(5)
    p = {"router": torch.randn(D, E, generator=g) / 4,
         "router_bias": torch.zeros(E)}
    return dataclasses.replace(cfg, d_model=D), p, torch.randn(
        11, D, generator=g)


def test_sigmoid_routing_bias_chooses_and_does_not_weigh():
    cfg, p, x = _router()
    w0, idx0 = route_sigmoid(p, x, cfg)
    s = torch.sigmoid(x @ p["router"])
    assert torch.equal(idx0, s.topk(2).indices)
    # weights: the chosen scores over their sum, times 2.446
    want = s.gather(1, idx0)
    want = want / want.sum(-1, keepdim=True) * 2.446
    torch.testing.assert_close(w0, want)
    torch.testing.assert_close(w0.sum(-1), torch.full((11,), 2.446))
    # a bias large enough puts expert 5 in every token's choice, and its
    # weight is still its unbiased score renormalised
    p["router_bias"][5] = 10.0
    w1, idx1 = route_sigmoid(p, x, cfg)
    assert (idx1 == 5).any(-1).all()
    want = s.gather(1, idx1)
    torch.testing.assert_close(w1, want / want.sum(-1, keepdim=True)
                               * 2.446)


def test_dropless_moe_computes_every_row(model):
    """The dropless layer against a per-token loop over its chosen
    experts and the shared one: nothing dropped, whatever the routing's
    skew (a bias sends every token to expert 3)."""
    cfg, params = model
    p = dict(params["blocks"][2]["moe"])
    p["router_bias"] = p["router_bias"].clone()
    p["router_bias"][3] = 10.0
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 9, cfg.d_model, generator=g)
    y, aux = moe_fwd(p, x, cfg)
    xt = x.reshape(18, -1)
    w, idx = route_sigmoid(p, xt, cfg)
    silu = torch.nn.functional.silu
    want = torch.zeros_like(xt)
    for t in range(18):
        for k in range(cfg.top_k):
            e = idx[t, k]
            h = silu(xt[t] @ p["wg"][e]) * (xt[t] @ p["wi"][e])
            want[t] += w[t, k] * (h @ p["wo"][e])
    sp = p["shared"]
    want += (silu(xt @ sp["wg"]) * (xt @ sp["wi"])) @ sp["wo"]
    torch.testing.assert_close(y.reshape(18, -1), want, atol=1e-5, rtol=0)
    rows, hit, most = aux["moe_load"].tolist()
    assert (rows, most) == (18 * 2, 18) and aux["dropped"] == 0
    assert hit == len(set(idx.flatten().tolist()))


def test_pad_rows_leave_real_rows_unchanged(model):
    cfg, params = model
    seq = _tokens(21, 4)
    real, _, _ = forward(params, cfg, torch.tensor([seq]), mode="prefill")
    padded, _, _ = forward(params, cfg, torch.tensor([seq + [0] * 11]),
                           mode="prefill")
    np.testing.assert_allclose(padded[0, :21].numpy(), real[0].numpy(),
                               atol=1e-5, rtol=0)


def test_the_capacity_moe_path_is_unchanged():
    """A softmax-routed moe config keeps its capacity dispatch (drops at
    capacity 1.25), its parameters' leaves and pads to ``pad_len``."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS["moonshot-v1-16b-a3b"].smoke()
    assert not cfg.deepseek_moe and not pads_to_block(cfg)
    g = torch.Generator().manual_seed(0)
    p = moe_init(cfg, g, "cpu", torch.float32)
    assert set(p) == {"router", "wg", "wi", "wo"}
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    _, aux = moe_fwd(p, x, cfg)
    assert "moe_load" not in aux and aux["capacity"] < 2 * 16 * cfg.top_k


def test_engine_pads_to_the_block_and_counts_the_moe_load(model):
    """A dropless config pads its admissions to the block (16 rows), and
    the MoE load of every prefill and decode loop lands on its span's end
    args and in ``stats()``, read at the drains."""
    cfg, params = model
    assert pads_to_block(cfg)
    tracer = Tracer()
    eng = Engine(cfg, params, max_slots=2, max_seq=96, pad_len=64,
                 steps_per_sync=4, paged=True, block_size=16,
                 tracer=tracer, device="cpu")
    reqs = [Request(rid=i, prompt=_tokens(n, i), max_new=5)
            for i, n in enumerate((5, 17, 33))]
    for r in reqs:
        eng.submit(r)
    while not all(r.done for r in reqs):
        eng.step()
    st = eng.stats()
    assert st["prefill_rows"] == 16 + 32 + 48
    ends = [e for e in tracer.events if e.get("ph") == "E"
            and "moe_rows" in e.get("args", {})]
    assert len(ends) >= 3 + 1
    for key in ("moe_rows", "moe_experts_hit", "moe_max_rows"):
        assert st[key] == sum(e["args"][key] for e in ends) > 0
    prefill = [e["args"] for e in ends if "rows" in e["args"]]
    assert [a["moe_rows"] for a in prefill] == [16 * 2 * 2, 32 * 4, 48 * 4]
    loops = [e["args"] for e in ends if "iters" in e["args"]]
    assert all(a["moe_rows"] == 4 * 2 * 2 * 2 for a in loops)


def test_engine_refuses_what_latent_rows_do_not_build(model):
    cfg, params = model
    kw = dict(max_slots=2, max_seq=64, pad_len=32, block_size=16,
              device="cpu")
    with pytest.raises(ValueError, match="MLA"):
        Engine(cfg, params, paged=False, **kw)
    with pytest.raises(ValueError, match="MLA"):
        Engine(cfg, params, paged=True, prefix_cache=True, **kw)
    with pytest.raises(ValueError, match="MLA"):
        Engine(cfg, params, paged=True, prefill_chunk=16, **kw)
    eng = Engine(cfg, params, paged=True, **kw)
    eng.submit(Request(rid=0, prompt=_tokens(9), max_new=20))
    eng.step()
    with pytest.raises(NotImplementedError, match="latent"):
        eng.migrate_out(0)
    cache = make_paged_cache(cfg, 4, 16, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="latent blocks"):
        forward(params, cfg, torch.tensor([_tokens(4)]), cache=cache,
                cache_len=0, mode="prefill",
                block_tables=torch.zeros((1, 4), dtype=torch.int32))


def test_init_lm_builds_the_mla_layout():
    """The port's own random init for an MLA config: layer 0 dense, the
    rest routed with a correction bias and shared experts; its forward
    runs and its parameter count is ``param_count``."""
    cfg = MLAConfig(name="m", family="moe", n_layers=3, d_model=32,
                    n_heads=2, n_kv_heads=2, d_ff=48, vocab=100,
                    n_experts=4, top_k=2, kv_lora_rank=16,
                    qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
                    moe_d_ff=12, n_shared_experts=2, first_k_dense=1,
                    routed_scale=2.446,
                    dtype="float32")
    params = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert "mlp" in params["blocks"][0] and "moe" in params["blocks"][1]
    assert params["blocks"][2]["moe"]["router_bias"].dtype == torch.float32
    n = sum(t.numel() for t in _leaves(params)) - 256 * 32 * 2 - 32
    assert n == cfg.param_count() - cfg.padded_vocab * 32 * 2
    logits, _, _ = forward(params, cfg, torch.tensor([[1, 2, 3]]),
                           mode="train")
    assert torch.isfinite(logits).all()


def _leaves(tree):
    for v in tree.values() if isinstance(tree, dict) else tree:
        if isinstance(v, (dict, list)):
            yield from _leaves(v)
        else:
            yield v


def test_the_weights_come_from_the_benchmark_s_streams(model):
    """The engine's parameters are the harness's draws, laid out: W_kvb
    and the experts as drawn, norm weights as the port's w - 1."""
    _, params = model
    w = W.layer(TINY, SEED, 2, "cpu")
    blk = params["blocks"][2]
    assert torch.equal(blk["attn"]["wkv_b"], w["kv_b"])
    assert torch.equal(blk["moe"]["wo"], w["wo"])
    assert torch.equal(blk["attn"]["kv_norm"], w["kv_norm"] - 1.0)


def _serve(cfg, params, n=4, slots=2):
    eng = Engine(cfg, params, max_slots=slots, max_seq=96, pad_len=64,
                 steps_per_sync=4, paged=True, block_size=16, device="cpu")
    reqs = [Request(rid=i, prompt=_tokens(13 + 9 * i, 10 + i), max_new=7)
            for i in range(n)]
    for r in reqs:
        eng.submit(r)
    while not all(r.done for r in reqs):
        eng.step()
    return [(r.prompt, list(r.out)) for r in reqs]


def test_engine_logs_every_position_s_experts(model):
    """With ``route_log``, each request's record covers its prompt and
    every decoded token but the last, one row a position (admissions in
    later steps included), and holds the experts the reference chooses
    there: float32 on both sides, so no choice is held or departs."""
    cfg, params = model
    assert cfg.route_log is lay.ROUTES
    lay.ROUTES.clear()
    served = _serve(cfg, params)
    assert len(lay.ROUTES) == 4
    for p, o in served:
        r = lay.program_routes(p, len(p) + len(o) - 1)
        assert r is not None and tuple(r.shape) == (len(p) + len(o) - 1,
                                                   2, 2)
        assert lay.program_routes(p, len(p) + len(o)) is None
    res = ref.served_gaps(TINY, SEED, served, "cpu")
    st = res["routing"]["f32"]
    assert st["unlogged"] == 0 and st["departed"] == 0
    assert st["max_deficit"] < 1e-4
    assert max(max(g) for g in res["gap"]) == 0.0
    # only the DeepSeek router's choices are logged
    with pytest.raises(ValueError, match="route_log"):
        Engine(MLAConfig("x", "dense", 1, 8, route_log={}), None,
               paged=True, device="cpu")


def test_a_routed_fault_shows_through_the_held_routing(model):
    """One routed expert's down projection zeroed in the program only:
    the reference, held to the program's choices where they tie, still
    reads the served tokens below its best."""
    cfg, params = model
    bad = dict(params, blocks=[dict(b) for b in params["blocks"]])
    for b in bad["blocks"][1:]:
        b["moe"] = dict(b["moe"], wo=b["moe"]["wo"].clone())
        b["moe"]["wo"][3] = 0.0
    served = _serve(cfg, bad)
    res = ref.served_gaps(TINY, SEED, served, "cpu")
    assert res["routing"]["f32"]["unlogged"] == 0
    assert max(max(g) for g in res["gap"]) > 1e-2
