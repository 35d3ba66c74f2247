"""GLB tunables — the paper's user-facing knobs (§2.4). A copy of
``repro.core.params``.

The paper exposes three parameters:
  w — number of random victims tried per steal round,
  z — number of lifeline buddies (dimension of the lifeline hypercube),
  n — task granularity: how many task items ``process(n)`` handles between
      network probes (here: per superstep).

We add two knobs that exist implicitly in the paper's implementation:
  steal_k  — max items per steal packet (the paper ships "half the bag"; on a
             static-collective machine the packet must be bounded — interval
             task items still carry ~half the *work*, see DESIGN.md §2),
  min_give — the minimum bag size at which a place is considered a viable
             victim.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class GLBParams:
    w: int = 2                # random victims per round (paper: w)
    z: int = 0                # lifeline dims; 0 => ceil(log2(P)) at runtime
    n: int = 64               # task granularity per superstep (paper: n)
    steal_k: int = 64         # max items per steal packet
    steal_k_random: int = 0   # packet cap for random-round steals under
                              # routing='lifeline' (0 => steal_k)
    min_give: int = 1         # victim viability threshold (bag size)
    max_supersteps: int = 1_000_000  # safety bound on the while_loop
    no_steal: bool = False    # disable balancing entirely — the "legacy
                              # static partitioning" baseline of paper §3.6
    heartbeat_misses: int = 3  # consecutive missed load-vector gathers
                               # before a place is declared dead (the
                               # failure-detection window, DESIGN.md §15)

    def resolve_z(self, P: int) -> int:
        # Cap at ceil(log2 P): beyond that the circulant jumps 2^i wrap and
        # duplicate buddies (and break single-hop lifeline routing).
        cap = max(1, math.ceil(math.log2(max(2, P))))
        if self.z > 0:
            return min(self.z, cap)
        return cap


DEFAULT = GLBParams()
