"""The paper's workloads, expressed against the GLB user contract (§2.3).
The counterparts of ``repro.problems``:

  fib.py   — the pedagogical appendix example (default ArrayList-style bag)
  uts.py   — Unbalanced Tree Search (§2.5): geometric tree over a splittable
             hash RNG; interval-splitting TaskBag; node expansion through
             the hand-written ``uts_expand`` kernel; + numpy oracles
  bc.py    — Betweenness Centrality (§2.6): exact Brandes on SSCA2 R-MAT
             graphs as frontier matrix products; resumable per-vertex state
             machine
  rmat.py  — SSCA2 R-MAT graph generator + Brandes oracle (numpy)
"""
from . import fib, uts, bc, rmat  # noqa: F401
