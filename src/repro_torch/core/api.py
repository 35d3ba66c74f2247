"""Public GLB API — mirrors the paper's ``new GLB[...](init, params);
glb.run(start)``. The counterpart of ``repro.core.api``.

Users hand over a :class:`~repro_torch.core.problem.GLBProblem` (the
TaskQueue/TaskBag contract) and pick an execution mode:

  mode="sim"       — P virtual places on one device (``run_sim``); used by
                     the paper-figure runs to sweep place counts.
  mode="shard_map" — one place per process on the ``axis`` dimension of a
                     ``torch.distributed`` ``DeviceMesh``
                     (``executor.run_shardmap``); every rank of that
                     dimension constructs the same ``GLB`` and calls
                     ``run`` with the same seed.

Example (the paper's appendix)::

    from repro_torch.core import GLB, GLBParams
    from repro_torch.problems.fib import fib_problem

    glb = GLB(fib_problem(n=20), GLBParams(n=32), P=8, device="cpu")
    result = glb.run(seed=0)
    print(result, glb.stats_summary())

and, on each of 8 ranks of an initialised process group (``torchrun``, or
``repro_torch.launch.ranks.run_ranks``)::

    from repro_torch.launch.mesh import make_host_mesh

    glb = GLB(fib_problem(n=20), GLBParams(n=32), mesh=make_host_mesh(8),
              mode="shard_map")
"""
from __future__ import annotations

from typing import Any, Optional

from .executor import run_shardmap
from .params import GLBParams
from .problem import GLBProblem
from .scheduler import run_sim
from .stats import summarize

MODES = ("sim", "shard_map")


class GLB:
    def __init__(
        self,
        problem: GLBProblem,
        params: GLBParams = GLBParams(),
        P: Optional[int] = None,
        mesh=None,
        axis: str = "place",
        mode: str = "sim",
        routing: str = "dense",
        device="cuda",
    ):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "sim" and P is None:
            raise ValueError("sim mode needs P (number of virtual places)")
        if mode == "shard_map" and mesh is None:
            raise ValueError("shard_map mode needs a mesh")
        self.problem = problem
        self.params = params
        self.P = P if P is not None else int(
            mesh.shape[mesh.mesh_dim_names.index(axis)])
        self.mesh = mesh
        self.axis = axis
        self.mode = mode
        self.routing = routing
        self.device = device
        self.last_run = None

    def run(self, seed: int = 0, tracer: Any = None, faults: Any = None,
            candidates=None) -> Any:
        """Drive the problem to completion and return the reduced result
        as a numpy array. ``tracer`` and ``faults`` (sim mode only) and
        ``candidates`` are ``run_sim``'s. Per-place results and counters
        are kept, on the host, in ``last_run``."""
        if self.mode == "sim":
            out = run_sim(self.problem, self.P, self.params, seed=seed,
                          tracer=tracer, faults=faults,
                          candidates=candidates, device=self.device)
        elif faults is not None:
            raise ValueError("fault injection is supported in mode='sim' only")
        elif tracer is not None and getattr(tracer, "enabled", False):
            raise ValueError("tracing is supported in mode='sim' only")
        else:
            out = run_shardmap(self.problem, self.mesh, self.params,
                               seed=seed, axis=self.axis,
                               routing=self.routing, candidates=candidates,
                               device=self.device)
        host = lambda t: t.cpu().numpy()
        self.last_run = out._replace(
            result=host(out.result), per_place=host(out.per_place),
            stats={k: host(v) for k, v in out.stats.items()})
        if not self.last_run.converged:
            raise RuntimeError(
                f"GLB hit max_supersteps={self.params.max_supersteps} without "
                "draining; raise the bound or check capacity/steal settings"
            )
        return self.last_run.result

    @property
    def stats(self):
        return None if self.last_run is None else self.last_run.stats

    @property
    def supersteps(self) -> int:
        return -1 if self.last_run is None else int(self.last_run.supersteps)

    def stats_summary(self) -> str:
        if self.last_run is None:
            return "<not run>"
        return summarize(self.last_run.stats, self.supersteps)
