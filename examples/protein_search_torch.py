"""String-database scenario (paper §8 PROTEINS) on the PyTorch/CUDA port:
compares the reference net against the cover tree and MV reference indexing
at equal space, reporting exact distance-evaluation counts — every index
behind the SAME facade config, only the ``index`` field (and its tuning)
changes.  Prints what `protein_search.py` prints.

  PYTHONPATH=src python examples/protein_search_torch.py [--device cpu]

Runs on the card by default (every Levenshtein dispatch one launch of the
wavefront kernel); ``--device cpu`` runs the kernel's plain torch version
instead.  Asking for ``cuda`` without a card raises.
"""

import argparse

import numpy as np

from repro_torch import device as device_mod
from repro_torch.data.synthetic import proteins
from repro_torch.retrieval import RetrievalConfig, Retriever


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = str(device_mod.resolve(args.device))

    data = proteins(2000, seed=0)
    rng = np.random.default_rng(1)

    # defaults: cohort bulk construction + the batched frontier engine —
    # exact-eval fractions are engine-independent (host parity is
    # property-tested), so the comparison currency is unchanged
    base = RetrievalConfig("levenshtein", eps_prime=1.0, num_max=5,
                           device=dev)
    configs = {
        "reference net": base,
        "reference net (tight)": base.replace(tight_bounds=True),
        "cover tree": base.replace(index="covertree"),
        "MV-5 references": base.replace(index="mv", mv_refs=5),
    }
    retrievers = {name: Retriever.build(cfg, data)
                  for name, cfg in configs.items()}

    queries = data[rng.integers(0, len(data), 10)].copy()
    flips = rng.random(queries.shape) < 0.1
    queries[flips] = rng.integers(0, 20, flips.sum())

    results = {}
    print(f"{'index':24s} {'eps':>4} {'evals%':>8} {'hits':>6}")
    for eps in [2.0, 4.0]:
        gold = None
        for name, r in retrievers.items():
            rs = r.batch(queries).range(eps)
            results[name, eps] = rs
            hits = sum(len(h) for h in rs.hits)
            frac = rs.stats["query"] / (len(queries) * len(data))
            if gold is None:
                gold = hits
            assert hits == gold, f"{name} returned different results!"
            print(f"{name:24s} {eps:4.0f} {frac:8.1%} {hits:6d}")
    print("\nall indices return identical result sets; "
          "the reference net needs the fewest distance computations")
    return {"results": results,
            "eval_stats": {name: r.eval_stats()
                           for name, r in retrievers.items()}}


if __name__ == "__main__":
    main()
