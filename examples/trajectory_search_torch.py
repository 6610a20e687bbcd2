"""Time-series scenario (paper §8 TRAJ) on the PyTorch/CUDA port:
sub-trajectory retrieval under the discrete Frechet distance and ERP —
including DTW via the consistency-only path (linear-scan filter, since DTW
is not a metric; paper §5).  Prints what `trajectory_search.py` prints.

  PYTHONPATH=src python examples/trajectory_search_torch.py [--device cpu]

Runs on the card by default (the wavefront kernel's float modes);
``--device cpu`` runs the kernel's plain torch version instead.  Asking for
``cuda`` without a card raises.
"""

import argparse

import numpy as np

from repro_torch import device as device_mod
from repro_torch.data.synthetic import trajectories
from repro_torch.retrieval import RetrievalConfig, Retriever


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = str(device_mod.resolve(args.device))

    rng = np.random.default_rng(0)
    # database trajectories: 2-D tracks, 120 points each
    base = trajectories(6, l=120, seed=3)
    seqs = [t for t in base]

    # query: a noisy replay of part of trajectory 2
    Q = seqs[2][30:90] + rng.normal(scale=0.05, size=(60, 2))

    # DTW is consistent but not metric: the config layer rejects the
    # indexed path and accepts the linear-scan filter (paper §5)
    validation = None
    try:
        RetrievalConfig("dtw", lam=16, index="refnet", device=dev)
    except ValueError as e:
        validation = str(e)
        print(f"config validation: {e}\n")

    results, eval_stats = {}, {}
    for dist_name, eps, index in [("frechet", 0.4, "refnet"),
                                  ("erp", 3.0, "refnet"),
                                  ("dtw", 2.0, "linear")]:
        cfg = RetrievalConfig(dist_name, lam=16, lambda0=1, index=index,
                              tight_bounds=(index == "refnet"), device=dev)
        r = Retriever.build(cfg, seqs)
        rs = r.query(Q).longest(eps)
        results[dist_name] = rs
        eval_stats[dist_name] = r.eval_stats()
        best = rs.first
        n_windows = len(r.meta)
        note = "(metric index)" if index == "refnet" else \
            "(consistent but non-metric -> linear-scan filter)"
        if best is None:
            print(f"{dist_name:8s} eps={eps}: no match {note}")
            continue
        print(f"{dist_name:8s} eps={eps}: traj {best.seq_id} "
              f"[{best.x_start}:{best.x_start+best.x_len}] ~ "
              f"Q[{best.q_start}:{best.q_start+best.q_len}] "
              f"d={best.distance:.2f}  evals={rs.stats['query']} "
              f"/ naive~{n_windows * 3 * len(Q)} {note}")
        assert best.seq_id == 2, "should recover the replayed trajectory"
    return {"validation": validation, "results": results,
            "eval_stats": eval_stats}


if __name__ == "__main__":
    main()
