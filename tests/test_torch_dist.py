"""The port's ``dist`` package and expert-parallel MoE against the JAX
package, on the CPU.

One world of 8 gloo ranks (``_torch_dist_ranks.model_cases``) runs:
  * ``moe_impl="ep"`` on a (2 data x 4 model) mesh (the reference test's
    config: the phi3.5-moe smoke config with 8 experts, top 2): at
    capacity 8.0 each data shard's y is within 2e-5 of JAX's global
    ``moe_fwd`` and the counts are equal; at 1.25 (drops) y, ``dropped``
    and ``expert_counts`` are those of JAX's global ``moe_fwd`` run on
    each data shard's half of the batch, and ``aux_loss`` the mean of the
    halves' within 1e-6 (the reference's per-shard estimator); the same
    with a non-identity ``expert_perm``;
  * ``compressed_psum_mean`` on 4 ranks against a numpy rendering of the
    reference's formula (int32 sums exact, outputs and error buffers
    within 1e-7), and the reference test's 60-step regression;
  * ``pipeline_forward``: the reference test's config (L 8, D 16, M 6,
    MB 4, 4 stages) within 1e-5 of JAX's sequential forward, and a
    tinyllama smoke model's blocks over 2 stages equal to the port's own
    sequential forward bit for bit;
  * ``tree_shardings`` + ``distribute_tensor`` of two smoke models on a
    (2, 2) mesh: each rank's local shard shapes are as specified and
    ``full_tensor()`` round-trips bit for bit; ``shard_act`` on a DTensor;
  * a checkpoint saved by the port and one saved by the JAX package,
    restored under a (2,) and a (4,) mesh with identical values.
In-process: the rule engine's specs for all ten archs at smoke size and
at full width, on three fake meshes, entry for entry against the
reference's, and the local int8 round trip bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as R
from repro.configs import ARCHS as JARCHS
from repro.dist import compress as jcompress
from repro.dist import sharding as jsharding
from repro.ft import checkpoint as jckpt
from repro.models import init_lm as jinit_lm
from repro.models import make_cache as jmake_cache
from repro.models.moe import moe_fwd as jmoe_fwd
from repro.models.moe import moe_init as jmoe_init
from repro_torch.configs import ARCHS
from repro_torch.dist import compress, sharding
from repro_torch.ft import checkpoint as ckpt
from repro_torch.models import init_lm, make_cache
from repro_torch.models.moe import moe_fwd

WORLD = 8
MOE_ARCH = "phi3.5-moe-42b-a6.6b"


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16},
          "odd": {"pod": 3, "data": 6, "model": 5}}


def _moe_cfg(cf, impl="global"):
    return dataclasses.replace(JARCHS[MOE_ARCH].smoke(), n_experts=8,
                               top_k=2, capacity_factor=cf, moe_impl=impl)


def _jax_inputs(tmp_path):
    key = jax.random.key(0)
    p = jmoe_init(key, _moe_cfg(8.0))
    x = jax.random.normal(jax.random.fold_in(key, 1),
                          (4, 16, _moe_cfg(8.0).d_model), jnp.float32)
    rng = np.random.default_rng(3)
    W0 = jax.random.normal(key, (16, 16)) * 0.3
    X = jax.random.normal(jax.random.fold_in(key, 1), (32, 16))
    Y = X @ (jax.random.normal(jax.random.fold_in(key, 2), (16, 16)) * 0.5)
    tree = lambda s: {"a": (rng.standard_normal((64, 32)) * s),
                      "b": (rng.standard_normal(100) * s * 3)}
    f32 = lambda t: {k: np.asarray(v, np.float32) for k, v in t.items()}
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    ckpt.save(str(port_dir), 3, {"w": torch.from_numpy(w),
                                 "b": torch.ones(3)})
    jckpt.save(str(jax_dir), 5, {"w": jnp.asarray(w)})
    return dict(
        p={k: np.asarray(v, np.float32) for k, v in p.items()},
        x=np.asarray(x), perm=rng.permutation(8).astype(np.int32),
        g=[f32(tree(1.0)) for _ in range(4)],
        e=[f32(tree(0.01)) for _ in range(4)],
        W0=np.asarray(W0), X=np.asarray(X), Y=np.asarray(Y),
        Ws=np.asarray(jax.random.normal(key, (8, 16, 16)) * 0.3),
        x_pipe=np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                            (6, 4, 16))),
        tokens=rng.integers(0, 512, (4, 2, 16)),
        ckpts={"port": str(port_dir), "jax": str(jax_dir)})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inp = _jax_inputs(tmp_path_factory.mktemp("dist"))
    ranks = R.spawn(R.model_cases, WORLD, inp)
    return inp, ranks


# ------------------------------------------------------------------ EP
def _jax_moe(inp, x, cf, perm=None):
    p = {k: jnp.asarray(v) for k, v in inp["p"].items()}
    y, aux = jmoe_fwd(p, jnp.asarray(x), _moe_cfg(cf),
                      None if perm is None else jnp.asarray(perm))
    return np.asarray(y), {k: np.asarray(v) for k, v in aux.items()}


def test_ep_no_drops_matches_global(world):
    inp, ranks = world
    y_ref, aux_ref = _jax_moe(inp, inp["x"], 8.0)
    halves = [_jax_moe(inp, inp["x"][2 * d:2 * d + 2], 8.0)[1]
              for d in range(2)]
    for r in ranks:
        got, d = r["moe"]["cf8"], r["moe"]["data_rank"]
        assert np.abs(got["y"] - y_ref[2 * d:2 * d + 2]).max() < 2e-5
        np.testing.assert_array_equal(got["expert_counts"],
                                      aux_ref["expert_counts"])
        assert float(got["dropped"]) == 0.0 == float(aux_ref["dropped"])
        assert got["capacity"] == int(aux_ref["capacity"])
        assert abs(float(got["aux_loss"]) - np.mean(
            [float(h["aux_loss"]) for h in halves])) < 1e-6


@pytest.mark.parametrize("case", ["cf1.25", "perm", "auto"])
def test_ep_drops_match_global_per_shard(world, case):
    """Capacity per data shard, slots ranked in the stable token order:
    each shard is JAX's global dispatch on that shard alone."""
    inp, ranks = world
    perm = inp["perm"] if case == "perm" else None
    halves = [_jax_moe(inp, inp["x"][2 * d:2 * d + 2], 1.25, perm)
              for d in range(2)]
    cap = _jax_moe(inp, inp["x"], 1.25, perm)[1]["capacity"]
    assert sum(float(h[1]["dropped"]) for h in halves) > 0
    for r in ranks:
        got, d = r["moe"][case], r["moe"]["data_rank"]
        assert np.abs(got["y"] - halves[d][0]).max() < 2e-5
        assert float(got["dropped"]) == sum(float(h[1]["dropped"])
                                            for h in halves)
        np.testing.assert_array_equal(
            got["expert_counts"],
            sum(h[1]["expert_counts"] for h in halves))
        assert abs(float(got["aux_loss"]) - np.mean(
            [float(h[1]["aux_loss"]) for h in halves])) < 1e-6
        assert got["capacity"] == int(cap)
    if case == "auto":               # auto takes ep on a mesh: the same run
        for r in ranks:
            np.testing.assert_array_equal(r["moe"]["auto"]["y"],
                                          r["moe"]["cf1.25"]["y"])


def test_ep_needs_a_mesh():
    cfg = dataclasses.replace(ARCHS[MOE_ARCH].smoke(), n_experts=8,
                              top_k=2, moe_impl="ep")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.moe import moe_init
    p = moe_init(cfg, gen, "cpu", torch.float32)
    x = torch.randn((1, 4, cfg.d_model), generator=gen)
    with pytest.raises(ValueError, match="needs a mesh"):
        moe_fwd(p, x, cfg)
    y, _ = moe_fwd(p, x, dataclasses.replace(cfg, moe_impl="auto"))
    y2, _ = moe_fwd(p, x, dataclasses.replace(cfg, moe_impl="global"))
    assert torch.equal(y, y2)       # auto without a mesh is global


# ------------------------------------------------------------ compress
def test_quantize_roundtrip_bit_for_bit():
    for dt in (jnp.float32, jnp.bfloat16):
        x = jax.random.normal(jax.random.key(0), (512,)) * 3.0
        x = x.astype(dt)
        want = np.asarray(jcompress.quantize_roundtrip(x).astype(
            jnp.float32))
        xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16 if dt == jnp.bfloat16 else torch.float32)
        got = compress.quantize_roundtrip(xt).float().numpy()
        np.testing.assert_array_equal(got, want)


def test_local_error_feedback_bit_for_bit():
    """``group=None``: the local round trip, 50 steps of error feedback,
    every output and error buffer equal to JAX's."""
    g = jax.random.normal(jax.random.key(1), (256,)) * 0.1
    tree = {"g": g, "h": [g[:7] * 5.0]}
    jerr = jcompress.init_error(tree)
    t_tree = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)
    err = compress.init_error(t_tree)
    for _ in range(50):
        jout, jerr = jcompress.compressed_psum_mean(tree, None, jerr)
        out, err = compress.compressed_psum_mean(t_tree, None, err)
        for a, b in ((out["g"], jout["g"]), (err["g"], jerr["g"]),
                     (out["h"][0], jout["h"][0]),
                     (err["h"][0], jerr["h"][0])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="init_error"):
        compress.compressed_psum_mean(t_tree, None, {"g": err["g"]})


def test_compressed_psum_mean_matches_formula(world):
    """One call on 4 ranks against the reference's formula in numpy."""
    inp, ranks = world
    n = 4
    for k in inp["g"][0]:
        corr = [inp["g"][r][k] + inp["e"][r][k] for r in range(n)]
        amax = np.float32(max(np.abs(c).max() for c in corr))
        scale = np.float32(max(amax, np.float32(1e-30))) / np.float32(127)
        q = [np.clip(np.round(c / scale), -127, 127).astype(np.int8)
             for c in corr]
        total = np.sum([qi.astype(np.int32) for qi in q], axis=0)
        out = total.astype(np.float32) * (scale / np.float32(n))
        for res in ranks:
            got = res["compress"]
            r = got["rank"]
            np.testing.assert_array_equal(got["sums"][k], total)
            np.testing.assert_allclose(got["mean"][k], out, rtol=0,
                                       atol=1e-7)
            err = corr[r] - q[r].astype(np.float32) * scale
            np.testing.assert_allclose(got["err"][k], err, rtol=0,
                                       atol=1e-7)


def test_compressed_dp_training_tracks_exact(world):
    """The reference's 60-step regression on 4 ranks: the exact-pmean run
    within 1e-5 (relative) of JAX's, the compressed one within the
    reference's own bounds of it."""
    inp, ranks = world
    W0, X, Y = (jnp.asarray(inp[k]) for k in ("W0", "X", "Y"))
    loss_fn = lambda w, x, y: jnp.mean((x @ w - y) ** 2)
    w = W0
    for _ in range(60):
        g = sum(jax.grad(loss_fn)(w, X[8 * r:8 * r + 8], Y[8 * r:8 * r + 8])
                for r in range(4)) / 4
        w = w - 0.05 * g
    want = np.asarray(w)
    loss = lambda w: float(np.mean((inp["X"] @ w - inp["Y"]) ** 2))
    for res in ranks:
        fin = res["compress"]["finals"]
        assert np.abs(fin["exact"] - want).max() / np.abs(want).max() < 1e-5
        rel = (np.abs(fin["comp"] - fin["exact"]).max()
               / max(np.abs(fin["exact"]).max(), 1e-9))
        assert loss(fin["comp"]) < loss(fin["exact"]) * 1.5 + 1e-3
        assert rel < 0.05


# ------------------------------------------------------------ pipeline
def test_pipeline_matches_sequential(world):
    inp, ranks = world
    Ws, x = jnp.asarray(inp["Ws"]), jnp.asarray(inp["x_pipe"])

    def apply_layers(h):
        for i in range(Ws.shape[0]):
            h = jax.nn.relu(h @ Ws[i])
        return h

    ref = np.asarray(jnp.stack([apply_layers(x[m])
                                for m in range(x.shape[0])]))
    for r in ranks:
        assert np.abs(r["pipeline"]["relu"] - ref).max() < 1e-5
        assert r["pipeline"]["tiny_equal"], r["pipeline"]["tiny_max_diff"]


def test_split_layers_into_stages():
    from repro_torch.dist import split_layers_into_stages
    assert split_layers_into_stages(list(range(6)), 3) == [[0, 1], [2, 3],
                                                           [4, 5]]
    with pytest.raises(ValueError, match="not divisible"):
        split_layers_into_stages(list(range(7)), 2)


# ------------------------------------------------------------ sharding
def _jax_axes(cfg):
    return jax.tree_util.tree_flatten_with_path(
        jsharding.param_axes(cfg), is_leaf=jsharding._is_axes_leaf)[0]


def _port_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _count_leaves(axes):
    if isinstance(axes, dict):
        return sum(_count_leaves(v) for v in axes.values())
    if isinstance(axes, list):
        return sum(_count_leaves(v) for v in axes)
    return 1


def _key(entry):
    return getattr(entry, "key", getattr(entry, "idx", entry))


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_axes_and_specs_match_reference(arch, size):
    """Every leaf's logical axes and its spec on each fake mesh, entry for
    entry: a port layer leaf against the reference's stacked leaf without
    its leading ``layer``."""
    cfg = ARCHS[arch] if size == "full" else ARCHS[arch].smoke()
    jcfg = JARCHS[arch] if size == "full" else JARCHS[arch].smoke()
    jshapes = jax.eval_shape(lambda: jinit_lm(jax.random.key(0), jcfg))
    pshapes = init_lm(cfg, device="meta")
    axes = sharding.param_axes(cfg)
    assert axes == sharding.param_axes(cfg, pshapes)
    n_leaves = 0
    for path, jaxes in _jax_axes(jcfg):
        keys = tuple(_key(e) for e in path)
        jshape = _port_leaf(jshapes, keys).shape
        stacked = keys[0] == "blocks"
        layers = range(cfg.n_layers) if stacked else [None]
        for li in layers:
            pkeys = (("blocks", li) + keys[1:]) if stacked else keys
            got = _port_leaf(axes, pkeys)
            assert got == (jaxes[1:] if stacked else jaxes), pkeys
            shape = tuple(_port_leaf(pshapes, pkeys).shape)
            assert shape == (jshape[1:] if stacked else jshape)
            for m in MESHES.values():
                want = tuple(jsharding.spec_for(jshape, jaxes, FakeMesh(m)))
                assert sharding.spec_for(shape, got, FakeMesh(m)) == (
                    want[1:] if stacked else want), (pkeys, m)
            n_leaves += 1
    assert n_leaves == _count_leaves(axes)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_batch_opt_axes_match_reference(arch):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    assert sharding.cache_axes(cfg) == jsharding.cache_axes(jcfg)
    for kind in ("train", "prefill", "decode"):
        assert sharding.batch_axes(cfg, kind) == \
            jsharding.batch_axes(jcfg, kind)
    cache = make_cache(cfg, 8, 128, device="meta")
    jcache = jax.eval_shape(lambda: jmake_cache(jcfg, 8, 128))
    for m in MESHES.values():
        got = sharding.tree_specs(sharding.cache_axes(cfg), cache,
                                  FakeMesh(m))
        want = jsharding.tree_specs(jsharding.cache_axes(jcfg), jcache,
                                    FakeMesh(m))
        assert got == {k: tuple(v) for k, v in want.items()}
    paxes = sharding.param_axes(cfg.smoke())
    assert sharding.opt_axes(paxes) == {"m": paxes, "v": paxes, "step": ()}


def test_spec_for_rules():
    pod, multi = FakeMesh(MESHES["pod"]), FakeMesh(MESHES["multipod"])
    assert sharding.spec_for((2048, 12), ("embed", "heads"), pod) == \
        ("data", None)
    assert sharding.spec_for((256, 4096), ("batch", "seq"), multi) == \
        (("pod", "data"), None)
    assert sharding.spec_for((8, 128, 32768, 16, 128),
                             ("layer", "batch", "cache_seq", "kv_heads",
                              "none"), pod) == (None, "data", "model", None,
                                                None)
    with pytest.raises(ValueError):
        sharding.spec_for((4, 4), ("batch",), pod)
    with pytest.raises(KeyError):
        sharding.spec_for((4,), ("no-such-axis",), pod)
    x = torch.ones(2, 4)
    assert sharding.shard_act(x, "batch", "none") is x
    assert sharding.shard_act(x, "no-such-axis") is x   # JAX: no mesh


def test_tree_shardings_on_ranks(world):
    """distribute_tensor of two smoke models by tree_shardings on a (2, 2)
    (data, model) mesh: local shard shapes as the specs give them, and the
    full tensors back bit for bit."""
    _, ranks = world
    mesh = FakeMesh({"data": 2, "model": 2})
    for arch in ("tinyllama-1.1b", "moonshot-v1-16b-a3b"):
        jcfg = JARCHS[arch].smoke()
        jshapes = jax.eval_shape(lambda: jinit_lm(jax.random.key(0), jcfg))
        want = {}
        for path, jaxes in _jax_axes(jcfg):
            keys = tuple(_key(e) for e in path)
            spec = tuple(jsharding.spec_for(_port_leaf(jshapes, keys).shape,
                                            jaxes, mesh))
            want["/".join(map(str, keys))] = spec
        for r in ranks:
            rows = r["shardings"][arch]
            assert len(rows) == _count_leaves(sharding.param_axes(
                ARCHS[arch].smoke()))
            for row in rows:
                assert row["equal"], row
                assert row["local"] == row["want"], row
                keys = row["path"].split("/")
                if keys[0] == "blocks":
                    assert row["spec"] == want["/".join(
                        [keys[0]] + keys[2:])][1:], row
                else:
                    assert row["spec"] == want[row["path"]], row
        assert any(row["local"] != tuple(row["want"]) or any(row["spec"])
                   for row in ranks[0]["shardings"][arch])
    act = ranks[0]["shardings"]["shard_act"]
    assert act["placements"] == [("Shard", 0), ("Replicate", None)]
    assert act["local"] == (4, 4) and act["equal"] and act["plain_same"]
    assert act["errors"] == ["KeyError", "ValueError"]


# ---------------------------------------------------------- checkpoint
def test_elastic_restore_under_other_meshes(world):
    """A port checkpoint and a JAX one, restored as DTensors sharded over
    a (2,) and a (4,) mesh: identical values, each rank its rows."""
    _, ranks = world
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for r in ranks:
        got = r["restore"]
        for src, step in (("port", 3), ("jax", 5)):
            for label, rows in (("2", 4), ("4", 2)):
                g = got[f"{src}-{label}"]
                np.testing.assert_array_equal(g["full"], w)
                assert g["local"] == (rows, 8) and g["step"] == step
        np.testing.assert_array_equal(got["port-2"]["rest"]["b"],
                                      np.ones(3, np.float32))


# --------------------------------------------------- collectives, meshes
def test_collectives_match_lax_semantics(world):
    """all_gather stacks in rank order; the tiled all_to_all sends chunk j
    to rank j; ppermute gives zeros to a rank nobody sends to; the
    reductions; the refusals; the mesh builders on the 8-rank world."""
    _, ranks = world
    x = lambda r: np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r
    xs = np.stack([x(r) for r in range(4)])
    for res in ranks:
        got = res["collectives"]
        r = got["rank"]
        np.testing.assert_array_equal(got["gather"], xs)
        np.testing.assert_array_equal(
            got["a2a"], np.concatenate([np.arange(2 * r, 2 * r + 2)
                                        + 100 * s for s in range(4)]))
        want = x(r - 1) if r > 0 else np.zeros((3, 2), np.float32)
        np.testing.assert_array_equal(got["shift"][0], want)
        want_t = (np.arange(8) + 100 * (r - 1) if r > 0
                  else np.zeros(8))
        np.testing.assert_array_equal(got["shift"][1], want_t)
        np.testing.assert_array_equal(got["self"], x(r))
        np.testing.assert_array_equal(got["sum"], xs.sum(0))
        np.testing.assert_array_equal(got["max"], xs.max(0))
        np.testing.assert_array_equal(got["min"], xs.min(0))
        np.testing.assert_array_equal(got["mean"], xs.sum(0) / 4)
        assert got["errors"] == ["ValueError"] * 4
        assert got["host"] == (("place",), (8,))
        assert got["glb"] == (("place",), (8,))
