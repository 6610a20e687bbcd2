"""Roofline report: reads reports/dryrun_torch/*.json, emits the
per-(arch x shape) roofline table on one mesh as markdown + JSON.

Terms (H100 SXM data-sheet constants, ``roofline/costs.py``):
  compute_s    = flops per chip / peak at the cell's dtype (on a pod mesh
                 the partitioned step's count on one rank, else the
                 counted flops / chips)
  memory_s     = per-chip argument + output bytes / 3.35e12
  collective_s = the partitioned step's collective operand bytes on one
                 rank / :data:`LINK_BW`; 0 on one card, which runs no
                 collective (``COLLECTIVE_NOTE``)

``MODEL_FLOPS / counted flops`` exposes remat and dispatch waste; dominant
term = argmax; roofline step time = max of terms (perfect overlap); MFU =
MODEL_FLOPS / (chips * peak * step time), of the roofline step or of a
measured one (:func:`analyze`'s ``step_s``).

  PYTHONPATH=src python -m repro_torch.roofline.report [--mesh h100x1]
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Optional

import torch

from repro_torch.roofline import costs

REPORT_DIR = pathlib.Path(__file__).resolve().parents[3] / "reports"

#: NVLink 4 on an H100 SXM: 900 GB/s bidirectional per card, 450e9 B/s each
#: way (NVIDIA H100 data sheet).  Optimistic: it is the rate inside one
#: NVLink domain (8 cards of a node); a pod of 256 or 512 cards crosses
#: slower links, and no collective reaches the peak.  Not the reference's
#: TPU figure.
LINK_BW = 450e9
COLLECTIVE_NOTE = ("0 on one card: the step runs no collective; on a pod "
                   "mesh the partitioned step's collective bytes per chip "
                   "over NVLink 4's 450e9 B/s a direction (H100 SXM data "
                   "sheet; optimistic beyond one node)")


def model_flops_for(cfg, shape) -> float:
    n = cfg.active_param_count()
    tokens = shape.seq_len * shape.global_batch
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def analyze(rec: dict, step_s: Optional[float] = None) -> Optional[Dict]:
    """The roofline row of one dry-run record (None unless it is ``ok``);
    with ``step_s``, a measured step time, also that step's MFU."""
    if rec.get("status") != "ok":
        return None
    n_dev = rec["n_devices"]
    peak = costs.peak_flops(getattr(torch, rec["dtype"]))
    flops_dev = rec.get("flops_per_device", rec["flops"] / n_dev)
    mem = rec["memory"]
    hbm = mem["argument_bytes"] + mem["output_bytes"]
    mf = rec["model_flops"]
    compute_s = flops_dev / peak
    mem_s = hbm / costs.PEAK_BYTES
    coll = rec.get("collectives")
    coll_s = coll["total_bytes"] / LINK_BW if coll else 0.0
    if n_dev > 1 and not coll:
        coll_s = None       # an unpartitioned record of a pod mesh
    terms = {"compute": compute_s, "memory": mem_s}
    if coll_s:
        terms["collective"] = coll_s
    step = max(terms.values())
    row = {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "dtype": rec["dtype"],
        "flops_per_dev": flops_dev,
        "model_flops": mf,
        "useful_frac": mf / rec["flops"] if rec["flops"] else 0.0,
        "compute_s": compute_s,
        "memory_s": mem_s,
        "collective_s": coll_s,
        "collective_note": COLLECTIVE_NOTE,
        "dominant": max(terms, key=terms.get),
        "step_s": step,
        "mfu": mf / (n_dev * peak * step) if step > 0 else 0.0,
        "hbm_gib": hbm / 2**30,
        "fits": hbm <= costs.HBM_BYTES,
    }
    if step_s is not None:
        row["measured_step_s"] = step_s
        row["measured_mfu"] = mf / (n_dev * peak * step_s)
    return row


def load_all(mesh: str) -> List[Dict]:
    rows = []
    for p in sorted((REPORT_DIR / "dryrun_torch").glob(f"*__{mesh}.json")):
        rec = json.loads(p.read_text())
        if rec.get("status") == "skipped":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": mesh, "skipped": rec["reason"]})
            continue
        r = analyze(rec)
        if r:
            rows.append(r)
        else:
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": mesh, "error": rec.get("error", "?")})
    return rows


def to_markdown(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | coll s | dominant | "
           "step s | MFU | useful FLOPs | HBM GiB | fits H100 |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        if "skipped" in r:
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"skip (sub-quadratic only) | — | — | — | — | — |\n")
            continue
        if "error" in r:
            out.append(f"| {r['arch']} | {r['shape']} | ERROR: "
                       f"{r['error'][:40]} |\n")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | "
            f"{'n/a' if r['collective_s'] is None else format(r['collective_s'], '.3f')} | "
            f"{r['dominant']} | {r['step_s']:.3f} | {r['mfu']:.1%} | "
            f"{r['useful_frac']:.1%} | {r['hbm_gib']:.1f} | "
            f"{'yes' if r['fits'] else 'NO'} |\n")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="h100x1")
    args = ap.parse_args(argv)
    rows = load_all(args.mesh)
    md = to_markdown(rows)
    print(md)
    print(f"collective term: {COLLECTIVE_NOTE}")
    (REPORT_DIR / f"roofline_torch_{args.mesh}.json").write_text(
        json.dumps(rows, indent=2))
    (REPORT_DIR / f"roofline_torch_{args.mesh}.md").write_text(md)
    print(f"# wrote reports/roofline_torch_{args.mesh}.{{json,md}}")


if __name__ == "__main__":
    main()
