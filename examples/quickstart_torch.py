"""Quickstart on the PyTorch/CUDA port: the paper's 5-step subsequence
matching framework end-to-end, through the unified `repro_torch.retrieval`
facade.  Prints what `quickstart.py` prints.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the card by default (every distance dispatch one launch of the
hand-written wavefront kernel); ``--device cpu`` runs the kernel's plain
torch version instead.  Asking for ``cuda`` without a card raises.
"""

import argparse

import numpy as np

from repro_torch import device as device_mod
from repro_torch.data.synthetic import protein_sequences
from repro_torch.retrieval import RetrievalConfig, Retriever

LAM, LAMBDA0, EPS = 16, 1, 2.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = str(device_mod.resolve(args.device))

    rng = np.random.default_rng(0)
    seqs = protein_sequences(8, length=300, seed=1)

    # a query containing a mutated copy of part of database sequence 3
    Q = rng.integers(0, 20, size=(80,)).astype(np.int32)
    Q[20:60] = seqs[3][100:140]
    Q[31] = (Q[31] + 1) % 20
    Q[48] = (Q[48] + 7) % 20

    config = RetrievalConfig("levenshtein", lam=LAM, lambda0=LAMBDA0,
                             index="refnet", tight_bounds=True, num_max=5,
                             device=dev)
    r = Retriever.build(config, seqs)
    print(f"indexed {len(r.meta)} windows of length {r.matcher.l} "
          f"from {len(seqs)} sequences")

    rs = r.query(Q).range(EPS)
    print(f"\n[type I] range query eps={EPS}: {len(rs)} similar pairs "
          f"({rs.stats['query']} distance evals, "
          f"{rs.stats['dispatches']} dispatches)")
    for p in rs.hits[:5]:
        print(f"  seq {p.seq_id} [{p.x_start}:{p.x_start+p.x_len}] ~ "
              f"Q[{p.q_start}:{p.q_start+p.q_len}] d={p.distance:.0f}")

    longest = r.query(Q).longest(EPS)
    best = longest.first
    print(f"\n[type II] longest similar subsequence: "
          f"seq {best.seq_id} [{best.x_start}:{best.x_start+best.x_len}] ~ "
          f"Q[{best.q_start}:{best.q_start+best.q_len}] "
          f"(|SQ|={best.q_len}, d={best.distance:.0f})")
    assert best.q_len >= 30, "planted 40-token match should dominate"

    nearest = r.query(Q).nearest(10.0)
    near = nearest.first
    print(f"\n[type III] nearest pair: d={near.distance:.0f} at "
          f"seq {near.seq_id} [{near.x_start}:{near.x_start+near.x_len}]")
    return {"retriever": r, "range": rs, "longest": longest,
            "nearest": nearest, "eval_stats": r.eval_stats()}


if __name__ == "__main__":
    main()
