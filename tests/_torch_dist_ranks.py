"""Rank bodies for the distributed tests (``test_torch_dist*.py``), run on
gloo ranks of the CPU by ``repro_torch.launch.ranks.run_ranks``.

They import torch and the port only, never JAX: a spawned rank imports
this module by name, and JAX in every rank would cost seconds and memory
apiece. The test files make the JAX side's inputs and expectations in
the parent and compare what the ranks return.
"""
from __future__ import annotations

import os

import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.launch.ranks import run_ranks


def spawn(fn, world_size, *args):
    """``run_ranks`` without ``PYTHONPATH`` in the ranks' environment: with
    ``src`` on it every rank would run ``src/sitecustomize.py``, which
    imports JAX, at start-up (seconds apiece). A spawned rank takes its
    ``sys.path`` from this process, so it still finds ``src`` and this
    directory."""
    old = os.environ.pop("PYTHONPATH", None)
    try:
        return run_ranks(fn, world_size, *args, timeout=600)
    finally:
        if old is not None:
            os.environ["PYTHONPATH"] = old


def _meshes(shapes):
    """One DeviceMesh per (shape, names) in ``shapes``, built in the same
    order on every rank (each build is a collective)."""
    return {key: init_device_mesh("cpu", key[0], mesh_dim_names=key[1])
            for key in shapes}


# ------------------------------------------------------------ executor
def _problem(kind, kw):
    from repro_torch.problems import bc, fib, uts

    if kind == "uts":
        return uts.uts_problem(**kw)
    if kind == "fib":
        return fib.fib_problem(**kw)
    return bc.bc_problem(**kw)


def glb_cases(cases):
    """Each case: dict(problem=(kind, kwargs), params=GLBParams kwargs,
    routing, mesh=(shape, names), cand=(S, P, w) draws or None). Every
    rank runs every case in order; returns each case's GLBDistRun fields
    as this rank saw them."""
    from repro_torch.core import GLB, GLBParams

    meshes = _meshes(dict.fromkeys(c["mesh"] for c in cases))
    out = []
    for c in cases:
        cand = c["cand"]
        glb = GLB(_problem(*c["problem"]), GLBParams(**c["params"]),
                  mesh=meshes[c["mesh"]], mode="shard_map",
                  routing=c["routing"], device="cpu")
        glb.run(seed=c.get("seed", 0), candidates=None if cand is None
                else (lambda step, P, w, t=cand: t[step]))
        r = glb.last_run
        out.append(dict(result=r.result, per_place=r.per_place,
                        stats=r.stats, supersteps=r.supersteps,
                        converged=r.converged, wire_bytes=r.wire_bytes,
                        phases=sorted(r.host_ms)))
    return out


# -------------------------------------------------------- models, dist
EP = ((2, 4), ("data", "model"))
DP4 = ((2, 4), ("pod", "data"))
STAGE4 = ((2, 4), ("data", "stage"))
STAGE2 = ((4, 2), ("data", "stage"))
CUBE = ((2, 2, 2), ("pod", "data", "model"))
MODEL_MESHES = (EP, DP4, STAGE4, STAGE2, CUBE)


def tiny_stage_fn(cfg):
    """A pipeline stage of the dense family: its blocks in order, prefill
    mode, no cache."""
    from repro_torch.models import apply_layer

    def fn(blocks, h):
        B, S = h.shape[:2]
        pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
        for i in range(len(blocks)):
            h, _ = apply_layer({"blocks": blocks}, cfg, i, h, pos,
                               mode="prefill")
        return h
    return fn


def _moe(inp, meshes):
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models.moe import moe_fwd

    mesh = meshes[EP]
    d = mesh.get_local_rank("data")
    p = {k: torch.from_numpy(v) for k, v in inp["p"].items()}
    x = torch.from_numpy(inp["x"])
    half = x.shape[0] // mesh["data"].size()
    xl = x[d * half:(d + 1) * half]
    base = dataclasses.replace(ARCHS["phi3.5-moe-42b-a6.6b"].smoke(),
                               n_experts=8, top_k=2)
    out = {"data_rank": d}
    for name, cf, perm, impl in (("cf8", 8.0, None, "ep"),
                                 ("cf1.25", 1.25, None, "ep"),
                                 ("perm", 1.25, inp["perm"], "ep"),
                                 ("auto", 1.25, None, "auto")):
        cfg = dataclasses.replace(base, capacity_factor=cf, moe_impl=impl)
        y, aux = moe_fwd(p, xl, cfg, expert_perm=perm, mesh=mesh)
        out[name] = dict(y=y, **aux)
    return out


def _compress(inp, meshes):
    from repro_torch.dist import collectives as C
    from repro_torch.dist import compress

    group = meshes[DP4].get_group("data")
    r = C.rank(group)
    T = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}
    g, e = T(inp["g"][r]), T(inp["e"][r])
    mean, err = compress.compressed_psum_mean(g, group, e)
    sums = {}
    for k in g:
        corrected = g[k].float() + e[k]
        amax = C.pmax(corrected.abs().max(), group)
        q, _ = compress._quantize(corrected, amax)
        sums[k] = C.psum(q.to(torch.int32), group)

    W0 = torch.from_numpy(inp["W0"])
    n = inp["X"].shape[0] // C.size(group)
    X = torch.from_numpy(inp["X"][r * n:(r + 1) * n])
    Y = torch.from_numpy(inp["Y"][r * n:(r + 1) * n])
    finals = {}
    for comp in (False, True):
        w = W0.clone()
        ef = compress.init_error({"w": torch.zeros_like(W0)})
        for _ in range(60):
            wg = w.clone().requires_grad_(True)
            loss = torch.mean((X @ wg - Y) ** 2)
            (gw,) = torch.autograd.grad(loss, wg)
            if comp:
                gs, ef = compress.compressed_psum_mean({"w": gw}, group, ef)
                gw = gs["w"]
            else:
                gw = C.pmean(gw, group)
            w = w - 0.05 * gw
        finals["comp" if comp else "exact"] = w
    return dict(rank=r, mean=mean, err=err, sums=sums, finals=finals)


def _pipeline(inp, meshes):
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.dist import pipeline_forward, split_layers_into_stages
    from repro_torch.models import embed_tokens, init_lm

    blocks = [{"w": torch.from_numpy(w)} for w in inp["Ws"]]

    def relu_fn(stage, h):
        for b in stage:
            h = torch.relu(h @ b["w"])
        return h

    out = pipeline_forward(relu_fn, split_layers_into_stages(blocks, 4),
                           torch.from_numpy(inp["x_pipe"]), meshes[STAGE4])
    cfg = dataclasses.replace(ARCHS["tinyllama-1.1b"].smoke(), n_layers=4)
    with torch.inference_mode():
        params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        x = embed_tokens(params, cfg, torch.from_numpy(inp["tokens"]))
        fn = tiny_stage_fn(cfg)
        got = pipeline_forward(fn, split_layers_into_stages(
            params["blocks"], 2), x, meshes[STAGE2])
        want = torch.stack([fn(params["blocks"], x[m])
                            for m in range(x.shape[0])])
    return dict(relu=out, tiny_equal=torch.equal(got, want),
                tiny_max_diff=(got - want).abs().max().item())


def _shardings(inp, meshes):
    import dataclasses

    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs import ARCHS
    from repro_torch.dist import (param_axes, shard_act, tree_shardings,
                                  tree_specs)
    from repro_torch.dist.sharding import mesh_shape
    from repro_torch.models import init_lm

    sub = meshes[CUBE]["data", "model"]
    sizes = mesh_shape(sub)
    out = {}
    for arch in ("tinyllama-1.1b", "moonshot-v1-16b-a3b"):
        cfg = ARCHS[arch].smoke()
        params = init_lm(cfg, torch.Generator().manual_seed(1), "cpu")
        axes = param_axes(cfg)
        specs = tree_specs(axes, params, sub)
        shards = tree_shardings(axes, params, sub)
        rows = []

        def visit(t, spec, sh, path):
            if isinstance(t, dict):
                for k in t:
                    visit(t[k], spec[k], sh[k], path + (k,))
            elif isinstance(t, list):
                for i, v in enumerate(t):
                    visit(v, spec[i], sh[i], path + (i,))
            else:
                d = distribute_tensor(t, sh.mesh, list(sh.placements))
                want = []
                for n, e in zip(t.shape, spec):
                    names = () if e is None else (e,) if isinstance(
                        e, str) else e
                    for a in names:
                        n //= sizes[a]
                    want.append(n)
                rows.append(dict(path="/".join(map(str, path)),
                                 spec=spec, local=tuple(d.to_local().shape),
                                 want=tuple(want),
                                 equal=torch.equal(d.full_tensor(), t)))
        visit(params, specs, shards, ())
        out[arch] = rows
    x = distribute_tensor(torch.arange(32.0).reshape(8, 4), sub,
                          [Replicate(), Replicate()])
    y = shard_act(x, "batch", "none")
    plain = torch.ones(3)
    errors = []
    for bad in (("batch", "nope"), ("batch",)):
        try:
            shard_act(x, *bad)
        except (KeyError, ValueError) as exc:
            errors.append(type(exc).__name__)
    out["shard_act"] = dict(
        placements=[(type(p).__name__, getattr(p, "dim", None))
                    for p in y.placements],
        local=tuple(y.to_local().shape),
        equal=torch.equal(y.full_tensor(), x.full_tensor()),
        plain_same=shard_act(plain, "batch") is plain, errors=errors)
    return out


def _restore(inp, meshes):
    from torch.distributed.tensor import Shard

    from repro_torch.dist.sharding import LeafSharding
    from repro_torch.ft import checkpoint as ckpt

    out = {}
    for label, mesh in (("2", meshes[STAGE2]["stage"]),
                        ("4", meshes[DP4]["data"])):
        sh = {"w": LeafSharding(mesh, (Shard(0),))}
        for src, path in inp["ckpts"].items():
            tree, extra, step = ckpt.restore(path, shardings=sh)
            out[f"{src}-{label}"] = dict(
                full=tree["w"].full_tensor(),
                local=tuple(tree["w"].to_local().shape),
                rest={k: v for k, v in tree.items() if k != "w"},
                step=step)
    return out


def _collectives(inp, meshes):
    """Each collective on the 4-rank ``data`` groups of DP4, and the mesh
    builders on the world."""
    from repro_torch.dist import collectives as C
    from repro_torch.launch import mesh as M

    g = meshes[DP4].get_group("data")
    r = C.rank(g)
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * r
    tiled = torch.arange(8, dtype=torch.int32) + 100 * r   # 2 rows a rank
    out = dict(
        rank=r, gather=C.all_gather(x, g), a2a=C.all_to_all(tiled, g),
        shift=C.ppermute([x, tiled], [(0, 1), (1, 2), (2, 3)], g),
        self=C.ppermute([x], [(i, i) for i in range(4)], g)[0],
        sum=C.psum(x, g), max=C.pmax(x, g), min=C.pmin(x, g),
        mean=C.pmean(x, g))
    errors = []
    for bad in (lambda: C.all_to_all(torch.ones(3), g),
                lambda: C.ppermute([x], [(0, 1), (0, 2)], g)):
        try:
            bad()
        except ValueError:
            errors.append("ValueError")
    host = M.make_host_mesh(device_type="cpu")
    glb = M.make_glb_mesh(n=8, device_type="cpu")
    for bad in (lambda: M.make_host_mesh(4, device_type="cpu"),
                lambda: M.make_production_mesh(device_type="cpu")):
        try:
            bad()
        except ValueError:
            errors.append("ValueError")
    out.update(errors=errors, host=(host.mesh_dim_names, host.shape),
               glb=(glb.mesh_dim_names, glb.shape))
    return out


def model_cases(inp):
    """EP MoE, compress, pipeline, shardings and elastic restore, in that
    order, on one 8-rank world; returns each part's results."""
    meshes = _meshes(MODEL_MESHES)
    return {name: fn(inp, meshes) for name, fn in (
        ("moe", _moe), ("compress", _compress), ("pipeline", _pipeline),
        ("shardings", _shardings), ("restore", _restore),
        ("collectives", _collectives))}


def moe_ep_wire(inp):
    """One ``moe_impl="ep"`` MoE layer on a (2 data x 2 model) mesh of 4
    ranks, on this rank's data shard: what it handed to the collectives
    (``wire_bytes`` and ``wire_calls`` over the call)."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.dist import collectives as C
    from repro_torch.models.moe import moe_fwd

    mesh = _meshes([((2, 2), ("data", "model"))])[((2, 2),
                                                    ("data", "model"))]
    d = mesh.get_local_rank("data")
    p = {k: torch.from_numpy(v) for k, v in inp["p"].items()}
    x = torch.from_numpy(inp["x"])
    half = x.shape[0] // 2
    cfg = dataclasses.replace(ARCHS[inp["arch"]].smoke(), moe_impl="ep",
                              dtype="float32")
    C.reset_wire()
    moe_fwd(p, x[d * half:(d + 1) * half], cfg, mesh=mesh)
    return dict(wire=C.wire_bytes(), calls=C.wire_calls())
