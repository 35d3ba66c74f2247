"""Public GLB API — mirrors the paper's ``new GLB[...](init, params);
glb.run(start)``. The counterpart of ``repro.core.api``.

Users hand over a :class:`~repro_torch.core.problem.GLBProblem` (the
TaskQueue/TaskBag contract) and run it on P virtual places of one device
(``mode="sim"``). The JAX package's ``mode="shard_map"`` (one place per
device, collectives between them) is not ported yet: it raises.

Example (the paper's appendix)::

    from repro_torch.core import GLB, GLBParams
    from repro_torch.problems.fib import fib_problem

    glb = GLB(fib_problem(n=20), GLBParams(n=32), P=8, device="cpu")
    result = glb.run(seed=0)
    print(result, glb.stats_summary())
"""
from __future__ import annotations

from typing import Any, Optional

from .params import GLBParams
from .problem import GLBProblem
from .scheduler import GLBRun, run_sim
from .stats import summarize


class GLB:
    def __init__(
        self,
        problem: GLBProblem,
        params: GLBParams = GLBParams(),
        P: Optional[int] = None,
        mode: str = "sim",
        device="cuda",
    ):
        if mode == "shard_map":
            raise NotImplementedError(
                "mode='shard_map' (one place per device) is not ported; it "
                "comes with the distribution item of ROADMAP.md §1 "
                "(core/executor.py over torch.distributed)")
        if mode != "sim":
            raise ValueError(f"unknown mode {mode!r}")
        if P is None:
            raise ValueError("sim mode needs P (number of virtual places)")
        self.problem = problem
        self.params = params
        self.P = P
        self.mode = mode
        self.device = device
        self.last_run = None

    def run(self, seed: int = 0, tracer: Any = None, faults: Any = None,
            candidates=None) -> Any:
        """Drive the problem to completion and return the reduced result
        as a numpy array. ``tracer``, ``faults`` and ``candidates`` are
        ``run_sim``'s. Per-place results and counters are kept, on the
        host, in ``last_run``."""
        out = run_sim(self.problem, self.P, self.params, seed=seed,
                      tracer=tracer, faults=faults, candidates=candidates,
                      device=self.device)
        host = lambda t: t.cpu().numpy()
        self.last_run = GLBRun(
            result=host(out.result), per_place=host(out.per_place),
            stats={k: host(v) for k, v in out.stats.items()},
            supersteps=out.supersteps, converged=out.converged,
            host_ms=out.host_ms)
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
