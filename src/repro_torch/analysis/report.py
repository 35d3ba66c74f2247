"""The §Dry-run and §Roofline tables from the records that
``launch/dryrun.py`` writes. The counterpart of
``repro.analysis.report``; the mesh column comes from each record, and
the dry-run table adds the whole step's bytes (arguments unsharded plus
the traced peak) and the fewest 80 GB cards that hold them.

  PYTHONPATH=src python -m repro_torch.analysis.report artifacts/dryrun
"""
from __future__ import annotations

import json
import os
import sys


def load(dirpath: str):
    recs = []
    for f in sorted(os.listdir(dirpath)):
        if f.endswith(".json"):
            with open(os.path.join(dirpath, f)) as fh:
                recs.append(json.load(fh))
    return recs


def fmt_bytes(b):
    if b >= 1e9:
        return f"{b/1e9:.2f}G"
    if b >= 1e6:
        return f"{b/1e6:.1f}M"
    return f"{b/1e3:.0f}K"


def mesh_label(r) -> str:
    """'16x16' or '2x16x16' from the record's mesh, else from its
    multi_pod flag (a skipped cell builds no mesh)."""
    mesh = r.get("mesh")
    if mesh:
        return "x".join(str(v) for v in mesh.values())
    return "2x16x16" if r.get("multi_pod") else "16x16"


def dryrun_table(recs) -> str:
    lines = [
        "| arch | shape | mesh | status | trace_s | HBM/dev (args+tmp) | "
        "collectives (per dev) | whole step (args+tmp) | cards >= |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        mesh = mesh_label(r)
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {mesh} | SKIP (full-attn "
                f"500k, per spec) | — | — | — | — | — |"
            )
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {mesh} | ERROR "
                f"{r.get('error','')[:60]} | — | — | — | — | — |"
            )
            continue
        ma = r.get("memory_analysis", {})
        hbm = (ma.get("argument_size_in_bytes", 0)
               + ma.get("temp_size_in_bytes", 0)
               + ma.get("output_size_in_bytes", 0)
               - ma.get("alias_size_in_bytes", 0))
        cb = r.get("collective_bytes", {})
        coll = "+".join(
            f"{k.split('-')[-1][:4]}:{fmt_bytes(v)}"
            for k, v in sorted(cb.items())
            if k not in ("total", "count") and v
        )
        basis = r.get("collective_basis", "")
        whole = r.get("global_bytes")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {mesh} | ok | "
            f"{r['trace_s']} | {fmt_bytes(hbm)} | {coll or '-'}"
            f"{f' ({basis})' if basis else ''} | "
            f"{fmt_bytes(sum(whole.values())) if whole else '—'} | "
            f"{r.get('min_cards', '—')} |"
        )
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = [
        "| arch | shape | bottleneck | t_comp (s) | t_mem (s) | t_coll (s) |"
        " useful ratio | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("multi_pod") or r["status"] != "ok":
            continue
        ro = r.get("roofline", {})
        lines.append(
            f"| {r['arch']} | {r['shape']} | **{ro.get('bottleneck','-')}** |"
            f" {ro.get('t_compute_s','-')} | {ro.get('t_memory_s','-')} |"
            f" {ro.get('t_collective_s','-')} | {ro.get('useful_ratio','-')} |"
            f" {ro.get('roofline_frac','-')} |"
        )
    return "\n".join(lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else "artifacts/dryrun"
    recs = load(d)
    ok = sum(r["status"] == "ok" for r in recs)
    skip = sum(r["status"] == "skipped" for r in recs)
    err = sum(r["status"] == "error" for r in recs)
    print(f"## Dry-run summary: {ok} ok, {skip} skipped (per spec), "
          f"{err} errors, {len(recs)} cells\n")
    print("### §Dry-run\n")
    print(dryrun_table(recs))
    pod = next((mesh_label(r) for r in recs
                if not r.get("multi_pod") and r.get("mesh")), "16x16")
    print(f"\n### §Roofline (single pod {pod}; NVIDIA H100 SXM data-sheet "
          f"peaks, reckoned on a meta trace, not measured)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
