"""The §Dry-run and §Roofline tables from the records that
``launch/dryrun.py`` writes. The counterpart of
``repro.analysis.report``; the mesh column comes from each record, and
the dry-run table adds the whole step's bytes (arguments unsharded plus
the traced peak on every chip) and the fewest 80 GB cards that hold
them. Every collective figure names its basis (``traced``: the
per-device step's collectives; ``reckoned``: the sharding rule's
formula) and, for a language-model cell, the reckoned floor beside the
traced bytes. ``--grid`` prints the same numbers laid out arch x shape.

  PYTHONPATH=src python -m repro_torch.analysis.report artifacts/dryrun
  PYTHONPATH=src python -m repro_torch.analysis.report --grid DIR
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
        whole = r.get("global_bytes")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {mesh} | ok | "
            f"{r['trace_s']} | {fmt_bytes(hbm)} | {coll or '-'}"
            f"{_basis(r)} | "
            f"{fmt_bytes(sum(whole.values())) if whole else '—'} | "
            f"{r.get('min_cards', '—')} |"
        )
    return "\n".join(lines)


def _basis(r) -> str:
    """' (traced; floor 35.43G)', ' (traced)' or ''."""
    basis = r.get("collective_basis", "")
    floor = r.get("collective_floor")
    if floor is not None:
        return f" ({basis}; floor {fmt_bytes(floor)})"
    return f" ({basis})" if basis else ""


def roofline_table(recs) -> str:
    lines = [
        "| arch | shape | bottleneck | t_comp (s) | t_mem (s) | t_coll (s) |"
        " useful ratio | roofline frac | collectives |",
        "|---|---|---|---|---|---|---|---|---|",
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
            f" {r.get('collective_basis', '-')} |"
        )
    return "\n".join(lines)


SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def grid_tables(recs) -> str:
    """The two tables arch x shape: per device HBM (args + temp + out -
    alias) on the pod mesh (the multi-pod mesh's in parentheses), the
    traced collective bytes and their ratio to the reckoned floor, the
    whole step and the fewest cards; then the pod mesh's roofline terms
    and useful ratio."""
    by = {(r["arch"], r["shape"], bool(r.get("multi_pod"))): r
          for r in recs}
    archs = sorted({r["arch"] for r in recs if r["shape"] in SHAPES})
    head = "| arch | " + " | ".join(SHAPES) + " |\n|---" + "|---" * len(
        SHAPES) + "|"

    def hbm(r):
        ma = r["memory_analysis"]
        return (ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
                + ma["output_size_in_bytes"] - ma["alias_size_in_bytes"])

    def cell_a(pod, mp):
        if pod is None or pod["status"] == "skipped":
            return "skip"
        if pod["status"] != "ok":
            return "error"
        cb = pod["collective_bytes"]
        ratio = (f" = {cb['total'] / pod['collective_floor']:.2f}x floor"
                 if pod.get("collective_floor") else "")
        mpb = f" ({fmt_bytes(hbm(mp))})" if mp and mp["status"] == "ok" \
            else ""
        return (f"{fmt_bytes(hbm(pod))}{mpb}; coll {fmt_bytes(cb['total'])}"
                f" {pod.get('collective_basis', '')}{ratio}; whole "
                f"{fmt_bytes(sum(pod['global_bytes'].values()))}, >= "
                f"{pod['min_cards']}")

    def cell_b(pod):
        if pod is None or pod["status"] != "ok":
            return "skip" if pod is None or pod["status"] == "skipped" \
                else "error"
        ro = pod["roofline"]
        return (f"{ro['t_compute_s']} / {ro['t_memory_s']} / "
                f"{ro['t_collective_s']}; {ro['useful_ratio']}")

    a = [head] + [f"| {arch} | " + " | ".join(
        cell_a(by.get((arch, sh, False)), by.get((arch, sh, True)))
        for sh in SHAPES) + " |" for arch in archs]
    b = [head] + [f"| {arch} | " + " | ".join(
        cell_b(by.get((arch, sh, False))) for sh in SHAPES) + " |"
        for arch in archs]
    return "\n".join(a) + "\n\n" + "\n".join(b)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    grid = "--grid" in argv
    argv = [a for a in argv if a != "--grid"]
    d = argv[0] if argv else "artifacts/dryrun"
    recs = load(d)
    if grid:
        print(grid_tables(recs))
        return
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
