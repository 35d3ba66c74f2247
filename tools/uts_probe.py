#!/usr/bin/env python3
"""UTS on one GPU at several tree depths: how the GLB task executor of the
PyTorch/CUDA port scales with the size of the tree.

    python3 tools/uts_probe.py [depth ...]        (default: 9 10 11)

Builds ``csrc/uts.cu`` (printing nvcc's register report), then for each
depth runs the paper's geometric tree (b0 4, r 19) on 1024 places with
``GLBParams(n=256, w=2, steal_k=64)`` through ``GLB.run`` on the card and
prints the count (checked against the breadth-first count), supersteps,
nodes/s, superstep efficiency, ``uts_expand`` launches and the host ms
per superstep of each phase. Needs a CUDA device; raises without one.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.core import GLB, GLBParams  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.problems.uts import uts_count_bfs, uts_problem  # noqa: E402

P = 1024
PARAMS = GLBParams(n=256, w=2, steal_k=64)


def main(depths) -> int:
    t0 = time.time()
    path = _build.build("uts")
    print(f"built {path.name} in {time.time() - t0:.1f} s")
    print(path.with_suffix(".log").read_text()[-400:])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for depth in depths:
        want = uts_count_bfs(b0=4.0, depth=depth, seed=19)
        glb = GLB(uts_problem(b0=4.0, depth=depth, seed=19), PARAMS, P=P)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.time()
        got = int(glb.run(seed=0))
        torch.cuda.synchronize()
        wall = time.time() - t0
        S = glb.supersteps
        print(f"depth {depth}: {got} nodes (want {want}), {S} supersteps, "
              f"{wall:.2f} s = {got / wall:.0f} nodes/s, efficiency "
              f"{got / (S * P * PARAMS.n):.4f}, uts_expand launches "
              f"{ops.kernel_launches()['uts_expand']}; host ms per "
              "superstep: " + ", ".join(
                  f"{k} {v / S:.2f}"
                  for k, v in glb.last_run.host_ms.items()), flush=True)
        if got != want:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main([int(d) for d in sys.argv[1:]] or [9, 10, 11]))
