"""The dry run's analysis against the JAX package's and against hand
counts, on the CPU.

  * ``configs.input_specs`` against ``repro.configs.input_specs`` for all
    ten archs x the four production shapes: the same keys and shapes and
    the same dtypes (the decode cache's dtype is the config's compute
    dtype in the port and bf16 in JAX; every arch computes in bf16, so
    they agree, which the test asserts);
  * ``roofline.model_flops`` equal to JAX's for all 40 pairs, and the
    ``Roofline`` terms and bottleneck on hand numbers with the H100's
    constants;
  * ``cost.trace_cost``: a matrix product and a relu against their closed
    forms (FLOPs, bytes, peak), a tinyllama smoke forward's FLOPs against
    the closed form written out below, and FLOPs and bytes linear in
    depth at 1, 2 and 4 layers;
  * ``comm.collective_bytes``' mapping on hand counts, and the reckoned
    expert-parallel bytes (``comm.moe_ep_bytes``) equal to what
    ``_moe_fwd_ep`` hands to the collectives on a 4-rank gloo world.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_dist_ranks as R
from repro.analysis import roofline as jrl
from repro.configs import ARCHS as JARCHS
from repro.configs import input_specs as j_input_specs
from repro.models.config import SHAPES as JSHAPES
from repro_torch.analysis import comm, roofline as rl
from repro_torch.analysis.cost import trace, trace_cost
from repro_torch.configs import ARCHS, SHAPES, input_specs
from repro_torch.models import forward, init_lm
from repro_torch.models.moe import moe_init

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
PAIRS = [(a, s) for a in sorted(ARCHS) for s in SHAPE_NAMES]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_jax(arch):
    for name in SHAPE_NAMES:
        got = _flat(input_specs(ARCHS[arch], SHAPES[name]))
        want = _flat(j_input_specs(JARCHS[arch], JSHAPES[name]))
        assert set(got) == set(want), (arch, name)
        for k, w in want.items():
            g = got[k]
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), (arch, name, k)
            gd = str(g.dtype).split(".")[-1]
            wd = str(np.dtype(w.dtype)) if w.dtype != jax.numpy.bfloat16 \
                else "bfloat16"
            if name.startswith(("decode", "long")) and k in (
                    "cache/k", "cache/v", "cache/conv_x", "cache/conv_B",
                    "cache/conv_C"):
                # the port's cache takes the compute dtype, JAX's bf16
                assert gd == ARCHS[arch].dtype == "bfloat16", (arch, k)
            assert gd == wd, (arch, name, k, gd, wd)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_model_flops_match_jax(arch, shape):
    assert rl.model_flops(ARCHS[arch], SHAPES[shape]) == jrl.model_flops(
        JARCHS[arch], JSHAPES[shape])


def test_roofline_terms_on_hand_numbers():
    # per device: 989 TFLOP, 6.7 TB, 0.9 GB of collectives, 4 chips
    r = rl.Roofline(flops=989e12, bytes_accessed=6.7e12,
                    collective={"all-reduce": 9e8, "total": 9e8}, chips=4,
                    model_flops=2 * 989e12).finalize()
    assert (r.t_compute, r.t_memory, r.t_collective) == pytest.approx(
        (1.0, 2.0, 0.002))
    assert r.bottleneck == "memory"
    assert r.useful_ratio == pytest.approx(0.5)
    assert r.roofline_frac == pytest.approx(0.25)      # (2/4 s) / 2 s
    row = rl.build({"flops": 989e12, "bytes": 1.0}, {"total": 0}, 1,
                   989e12).row()
    assert row["bottleneck"] == "compute" and row["roofline_frac"] == 1.0
    assert set(row) == {"t_compute_s", "t_memory_s", "t_collective_s",
                        "bottleneck", "useful_ratio", "roofline_frac",
                        "hlo_gflops_per_dev", "hlo_gbytes_per_dev",
                        "coll_mbytes_per_dev"}
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    assert not hasattr(rl, "ICI_LINK_BW")


def test_trace_cost_closed_form_matmul_relu():
    M, K, N = 64, 32, 48
    x = torch.empty(M, K, device="meta")
    w = torch.empty(K, N, device="meta")
    c = trace_cost(lambda: torch.relu(x @ w).t())
    assert c["flops"] == 2 * M * K * N
    # mm reads x and w and writes y; relu reads y and writes z; t is a view
    assert c["bytes"] == 4 * (M * K + K * N + M * N + 2 * M * N)
    assert c["peak_bytes"] == 4 * 2 * M * N      # y and z alive together
    out, c2 = trace(lambda: (x @ w).sum())
    # y, and the sum's scalar made while y is alive
    assert tuple(out.shape) == () and c2["peak_bytes"] == 4 * M * N + 4


def _smoke(n_layers):
    return dataclasses.replace(ARCHS["tinyllama-1.1b"].smoke(),
                               n_layers=n_layers, attn_impl="ref",
                               dtype="float32")


def _forward_cost(cfg, B=2, S=16):
    params = init_lm(cfg, device="meta")
    toks = torch.empty((B, S), dtype=torch.int32, device="meta")
    with torch.no_grad():
        return trace_cost(lambda: forward(params, cfg, toks, mode="train"))


def test_trace_cost_tinyllama_forward_closed_form():
    """Per layer: the q, k, v and o products, QK^T and PV over the full
    S x S (the plain attention masks, it does not skip), and the MLP's
    three products; then the head over the padded vocab."""
    cfg = _smoke(2)
    B, S = 2, 16
    T, D, F = B * S, cfg.d_model, cfg.d_ff
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    layer = (2 * T * D * Hq * hd + 2 * 2 * T * D * Hkv * hd
             + 2 * T * Hq * hd * D
             + 2 * 2 * B * Hq * S * S * hd
             + 3 * 2 * T * D * F)
    head = 2 * T * D * cfg.padded_vocab
    assert _forward_cost(cfg, B, S)["flops"] == cfg.n_layers * layer + head


def test_trace_cost_linear_in_depth():
    c1, c2, c4 = (_forward_cost(_smoke(n)) for n in (1, 2, 4))
    for k in ("flops", "bytes"):
        assert c4[k] - c2[k] == 2 * (c2[k] - c1[k]) > 0, k


def test_collective_bytes_mapping():
    wire = {"all_gather": 8, "all_to_all": 5152, "ppermute": 1932,
            "all_reduce": 0}
    calls = {"all_gather": 1, "all_to_all": 2, "ppermute": 6,
             "all_reduce": 0}
    assert comm.collective_bytes(wire, calls) == {
        "all-gather": 8, "all-to-all": 5152, "collective-permute": 1932,
        "total": 7092, "count": 9}
    assert comm.collective_bytes({"all_reduce": 4}) == {
        "all-reduce": 4, "total": 4, "count": 0}


class _Mesh:
    def __init__(self, **shape):
        self.shape = shape


def test_reckoned_ep_bytes_equal_the_wire():
    """``_moe_fwd_ep`` on (2 data x 2 model) gloo ranks, the moonshot
    smoke config in float32: each rank hands the collectives exactly the
    reckoned bytes, in 1 + 3 calls (the output over model; aux loss,
    counts and drops over data)."""
    arch = "moonshot-v1-16b-a3b"
    cfg = dataclasses.replace(ARCHS[arch].smoke(), dtype="float32")
    p = moe_init(cfg, torch.Generator().manual_seed(0), "cpu",
                 torch.float32)
    rng = np.random.default_rng(0)
    B, S = 4, 8
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    ranks = R.spawn(R.moe_ep_wire, 4, dict(
        arch=arch, x=x, p={k: v.numpy() for k, v in p.items()}))
    mesh = _Mesh(data=2, model=2)
    want = comm.moe_ep_bytes(cfg, B // 2 * S, mesh, torch.float32)
    assert comm.ep_applies(cfg, mesh)
    for r in ranks:
        assert r["wire"] == {"all_gather": 0, "all_to_all": 0,
                             "ppermute": 0, "all_reduce": want}
        assert r["calls"]["all_reduce"] == 1 + 3
        assert comm.collective_bytes(r["wire"], r["calls"]) == {
            "all-reduce": want, "total": want, "count": 4}


def test_reckon_lm_counts_each_rule():
    """Hand counts of (a), (b) and (c) on a (2 data x 2 model) mesh."""
    mesh = _Mesh(data=2, model=2)
    cfg = ARCHS["tinyllama-1.1b"].smoke()
    es = getattr(torch, cfg.dtype).itemsize
    # decode: (b) only, one token a row, 2 products a layer
    got = comm.reckon_lm(cfg, "decode", 4, 64, mesh)
    rows = 4 // 2
    want = cfg.n_layers * 2 * rows * cfg.d_model * es
    assert got == {"all-reduce": want, "total": want,
                   "count": cfg.n_layers * 2}
    # train under remat: (b) x 3 passes (forward, its dual, the
    # recompute) at attention's wo, x 2 at the MLP's wo (the layer's last
    # product, not recomputed), plus (a), the leaves replicated on an
    # axis of size 2 (norms: embed over data, replicated over model)
    cfg = dataclasses.replace(cfg, remat="full")
    params = init_lm(cfg, device="meta", dtype=torch.float32)
    got = comm.reckon_lm(cfg, "train", 4, 64, mesh, pshapes=params)
    b = (3 + 2) * cfg.n_layers * rows * 64 * cfg.d_model * es
    norms = (2 * cfg.n_layers + 1) * cfg.d_model // 2 * 4
    assert got["all-reduce"] == b + norms
    assert got["count"] == (3 + 2) * cfg.n_layers + 2 * cfg.n_layers + 1
    # moe: (c) once per layer at prefill, beside attention's wo (b)
    mcfg = ARCHS["moonshot-v1-16b-a3b"].smoke()
    mes = getattr(torch, mcfg.dtype)
    got = comm.reckon_lm(mcfg, "prefill", 4, 8, mesh)
    ep = mcfg.n_layers * comm.moe_ep_bytes(mcfg, 2 * 8, mesh, mes)
    attn = mcfg.n_layers * 2 * 8 * mcfg.d_model * mes.itemsize
    assert got["all-reduce"] == ep + attn
