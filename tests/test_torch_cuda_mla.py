"""The MLA kernels against their plain PyTorch versions, on the card.

This module imports torch and numpy only (no JAX), so it runs where the
card is:

    python -m pytest -q tests/test_torch_cuda_mla.py

Every test is marked ``cuda`` and skips without a CUDA device.

``flash_attention`` with V narrower than Q and K (MLA's expanded prefill,
qk 192 / v 128, bf16) is held against ``attention_ref`` by its largest
absolute difference, 2e-2, the bf16 limit of ``tests/test_torch_cuda.py``
(one bf16 ulp of an output |o| < 4 is at most 2^-6, and the tensor-core
route rounds P to bf16). ``mla_paged_decode`` (``csrc/mla_decode.cu``) is
held against ``mla_paged_decode_ref`` under the same limit and for the
same reasons, at Moonlight-16B-A3B's decode shape (64 slots, 16 heads,
rows of 576, values 512, blocks of 16) and at the edges: an idle slot
(exact zeros), one key, windows either side of a 32-key tile and of a
cluster block's share, partial blocks, garbage table entries past the
allocation, fewer than 16 heads and every cluster size the plan picks.
Then a 3-layer MLA model's prefill and decode through the kernels against
the same model through the plain versions, at the published attention
widths, and Moonlight's routed layer through ``gmm`` with the true group
sizes against ``gmm_ref`` (one input, so both route alike).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.mla_decode import (mla_paged_decode,
                                            mla_paged_decode_ref)

TOL = 2e-2            # bf16, as tests/test_torch_cuda.py's ATTN_TOL
DK, DV, BS = 576, 512, 16
SCALE = 1.0 / 192 ** 0.5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 means f32


def _normal(rng, *shape, dtype=torch.bfloat16):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)


# ------------------------------------------------------ expanded prefill
@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv", [(1, 3072, 3072), (1, 1, 1),
                                      (2, 77, 77), (1, 40, 96),
                                      (1, 70, 50), (1, 1235, 1235)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_mla_widths(card, B, Sq, Skv, causal):
    """qk 192 / v 128 with 16 heads (group 1) at the main-path prompt
    (3,072 tokens) and ragged, uneven and one-row shapes."""
    rng = np.random.default_rng(Sq * 7 + Skv)
    q, k = _normal(rng, B, Sq, 16, 192), _normal(rng, B, Skv, 16, 192)
    v = _normal(rng, B, Skv, 16, 128)
    ops.reset_launches()
    got = flash_attention(q, k, v, causal=causal, scale=SCALE)
    want = attention_ref(q, k, v, causal=causal, scale=SCALE)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["flash_attention"] == 1
    assert got.shape == (B, Sq, 16, 128) and got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL, err


@pytest.mark.cuda
def test_flash_attention_split_widths_are_bf16_and_192_128_only(card):
    rng = np.random.default_rng(0)
    q, k = _normal(rng, 1, 8, 4, 192), _normal(rng, 1, 8, 4, 192)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(),
                        _normal(rng, 1, 8, 4, 128).float())
    with pytest.raises(ValueError):
        flash_attention(q, k, _normal(rng, 1, 8, 4, 64))
    with pytest.raises(ValueError):
        flash_attention(q[..., :128], k[..., :128],
                        _normal(rng, 1, 8, 4, 64))


# -------------------------------------------------------- latent decode
def _decode_inputs(seed, lengths, H=16, extra_blocks=3):
    """q (B, H, 576), a pool whose blocks are handed out in a shuffled
    order, tables with garbage past each allocation, lengths."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    need = [-(-max(n, 0) // BS) for n in lengths]
    max_blocks = max(max(need), 1) + extra_blocks
    NB = sum(need) + 5
    perm = rng.permutation(NB)
    tables = rng.integers(-3, NB + 40, (B, max_blocks)).astype(np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    q = _normal(rng, B, H, DK)
    pool = _normal(rng, NB, BS, DK)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, pool, torch.from_numpy(tables).cuda(), lens


def _check_decode(q, pool, tables, lens):
    ops.reset_launches()
    got = mla_paged_decode(q, pool, tables, lens, v_dim=DV, scale=SCALE)
    want = mla_paged_decode_ref(q, pool, tables, lens, v_dim=DV,
                                scale=SCALE)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["mla_paged_decode"] == 1
    assert got.shape == (q.shape[0], q.shape[1], DV)
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL, err
    idle = (lens <= 0).nonzero()[:, 0]
    assert (got[idle] == 0).all()                 # exact zeros
    return got


@pytest.mark.cuda
def test_latent_decode_at_the_main_path_shape(card):
    """64 slots of Moonlight's docqa windows (1,224-7,821 keys)."""
    rng = np.random.default_rng(1)
    lengths = rng.integers(1224, 7822, 64).tolist()
    _check_decode(*_decode_inputs(2, lengths))


EDGES = [0, 1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255,
         256, 257, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 19, 64, 100])
def test_latent_decode_at_the_edges(card, B):
    """Windows at the edges of a tile, a block and a cluster block's
    share, idle slots and one key, at every cluster size the plan picks
    (8 at 1-33 slots, 4 at 64, 2 at 100)."""
    lengths = [EDGES[(b * 7) % len(EDGES)] for b in range(B)]
    c, _ = _build.latent_decode_plan(B)
    assert c == (8 if B <= 33 else 4 if B <= 66 else 2)
    _check_decode(*_decode_inputs(B, lengths))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 4, 15])
def test_latent_decode_with_fewer_heads(card, H):
    _check_decode(*_decode_inputs(H, [0, 5, 33, 300], H=H))


@pytest.mark.cuda
def test_latent_decode_lengths_past_the_table_are_clipped(card):
    q, pool, tables, _ = _decode_inputs(4, [64, 64])
    full = tables.shape[1] * BS
    lens = torch.tensor([full + 50, full], dtype=torch.int32, device="cuda")
    tables.clamp_(0, pool.shape[0] - 1)        # every entry a real block
    _check_decode(q, pool, tables, lens)


@pytest.mark.cuda
def test_latent_decode_routes_and_refusals(card):
    q, pool, tables, lens = _decode_inputs(5, [10, 20])
    ops.reset_launches()
    cpu = [t.cpu() for t in (q, pool, tables, lens)]
    ops.latent_attention(*cpu, v_dim=DV, scale=SCALE)          # plain
    ops.latent_attention(q, pool, tables, lens, v_dim=DV, scale=SCALE,
                         impl="paged_ref")                       # plain
    assert ops.kernel_launches()["mla_paged_decode"] == 0
    with pytest.raises(TypeError):
        mla_paged_decode(q.float(), pool.float(), tables, lens, v_dim=DV,
                         scale=SCALE)
    with pytest.raises(ValueError):
        mla_paged_decode(q[..., :512].contiguous(),
                         pool[..., :512].contiguous(), tables, lens,
                         v_dim=448, scale=SCALE)
    with pytest.raises(ValueError):
        mla_paged_decode(torch.cat([q, q], 1), pool, tables, lens,
                         v_dim=DV, scale=SCALE)             # 32 heads


# ------------------------------------------------------------- the model
def _mla_cfg(**kw):
    from repro_torch.models.config import MLAConfig
    return MLAConfig(
        name="mla-card", family="dense", n_layers=3, d_model=512,
        n_heads=16, n_kv_heads=16, d_ff=768, vocab=1000,
        rope_theta=50000.0, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, dtype="bfloat16", **kw)


@pytest.mark.cuda
def test_mla_model_through_the_kernels_matches_the_plain_route(card):
    """A 3-layer MLA model (dense MLPs) at the published attention widths:
    prefill logits through ``flash_attention`` and decode logits through
    the latent pool and ``mla_paged_decode`` against the same model
    through the plain versions, within 2e-2 of the largest logit; decode
    at each position gives the prefill's logits there."""
    from repro_torch.models import forward, init_lm, make_paged_cache

    cfg = _mla_cfg()
    plain = dataclasses.replace(cfg, attn_impl="ref",
                                decode_impl="paged_ref")
    g = torch.Generator(device="cuda").manual_seed(0)
    params = init_lm(cfg, g, device="cuda")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, 1000, (1, 100))).cuda()
    out = {}
    for name, c in (("kernel", cfg), ("plain", plain)):
        ops.reset_launches()
        pre, _, _ = forward(params, c, toks[:, :96], mode="prefill")
        cache = make_paged_cache(c, 16, BS, 2, device="cuda")
        bt = torch.arange(16, dtype=torch.int32, device="cuda")[None]
        bt = bt.expand(2, 16).contiguous()
        bt[1] = torch.flip(bt[1], [0])
        # the 100 tokens decoded one at a time into the pool, slot 1 idle
        lat = []
        for pos in range(100):
            tok = torch.stack([toks[0, pos], toks[0, pos]])[:, None]
            lens = torch.tensor([pos, -1], dtype=torch.int32,
                                device="cuda")
            lg, _, _ = forward(params, c, tok, cache=cache, cache_len=lens,
                               mode="decode", block_tables=bt)
            lat.append(lg[0, 0].float())
        out[name] = (pre[0].float(), torch.stack(lat))
        launches = ops.kernel_launches()
        if name == "kernel":
            assert launches["flash_attention"] == 3
            assert launches["mla_paged_decode"] == 3 * 100
        else:
            assert sum(launches.values()) == 0
    scale = out["plain"][0].abs().max().item()
    for k in range(2):
        err = (out["kernel"][k] - out["plain"][k]).abs().max().item()
        assert err <= 2e-2 * scale, (k, err, scale)
    err = (out["kernel"][1][:96] - out["plain"][0]).abs().max().item()
    assert err <= 2e-2 * scale, err


@pytest.mark.cuda
def test_dropless_moe_through_gmm_matches_the_plain_route(card):
    """Moonlight's routed layer (64 experts of 1408 on d 2048, top-6, two
    shared) through ``gmm`` with the true group sizes against
    ``gmm_ref``: the same input routes alike on both, so what differs is
    the products' summation order and bf16 rounding (2e-2 of the largest
    output, as above); every (token, k) row is counted."""
    from repro_torch.models.config import MLAConfig
    from repro_torch.models.moe import moe_fwd, moe_init

    cfg = MLAConfig(name="moe-card", family="moe", n_layers=1,
                    d_model=2048, n_heads=16, n_kv_heads=16, d_ff=11264,
                    vocab=1000, n_experts=64, top_k=6, moe_d_ff=1408,
                    n_shared_experts=2, routed_scale=2.446,
                    dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(1)
    p = moe_init(cfg, g, "cuda", torch.bfloat16)
    p["router_bias"].normal_(0, 0.02, generator=g)
    for T in (1, 64, 777):
        x = torch.randn(1, T, 2048, generator=g, device="cuda").to(
            torch.bfloat16)
        ops.reset_launches()
        y, aux = moe_fwd(p, x, cfg)
        assert ops.kernel_launches()["gmm"] == 3
        want, aux_ref = moe_fwd(p, x, dataclasses.replace(cfg,
                                                          moe_impl="ref"))
        torch.cuda.synchronize()
        assert torch.equal(aux["moe_load"], aux_ref["moe_load"])
        assert aux["moe_load"][0].item() == T * 6
        err = (y.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * want.float().abs().max().item(), (T, err)
