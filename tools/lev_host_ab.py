"""Host seconds of the two Levenshtein counter paths of ``chip_smoke.py``,
checkout against checkout, on the card.

The paths are phase 5A's lam=40 refnet build over ``--windows`` protein
windows and phase 11's near-duplicate filter (``data.pipeline.dedup_corpus``)
over the first ``--dedup-docs`` documents of the training corpus.  Both are
host-bound: their seconds are the Python plan code plus the per-dispatch
operand handling around each wavefront launch.

Each checkout named runs in a fresh process, in the order given, with its
own ``src/repro_torch`` (and its own kernel build, made before the timing):

    python3 tools/lev_host_ab.py <parent> . . <parent>

where ``<parent>`` is the root of another copy of the repository (for
example ``git archive`` of the parent commit unpacked under ``build/``).
Prints one JSON line per run: build and dedup seconds, with the build's
evaluations and the documents kept, which must agree between checkouts.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time


def one(root: pathlib.Path, windows: int, dedup_docs: int) -> dict:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.core.counter import CountedDistance
    from repro_torch.data.pipeline import dedup_corpus
    from repro_torch.data.synthetic import protein_sequences, token_corpus
    from repro_torch.distances import get
    from repro_torch.models import registry as models
    from repro_torch.retrieval import RetrievalConfig, Retriever
    dev = "cuda:0"
    # untimed: builds the wavefront kernel and warms the CUDA context
    rows = np.arange(8).reshape(2, 4)
    CountedDistance(get("levenshtein"), rows, device=dev).eval(rows[0], [1])
    torch.cuda.synchronize()

    seqs = protein_sequences(windows // 20, 400, seed=0)
    cfg = RetrievalConfig("levenshtein", lam=40, lambda0=2, index="refnet",
                          tight_bounds=True, num_max=5, device=dev)
    t0 = time.perf_counter()
    r = Retriever.build(cfg, seqs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    st = r.eval_stats()
    del r

    vocab = models.get("smollm-360m")[0].vocab
    corpus = token_corpus(512, 512, vocab, seed=0, dup_frac=0.1)
    t0 = time.perf_counter()
    kept = dedup_corpus(corpus, max_docs=dedup_docs, device=dev)
    torch.cuda.synchronize()
    dedup_s = time.perf_counter() - t0
    return {"root": str(root), "windows": windows, "build_s": build_s,
            "build_evals": int(st["build"]),
            "build_dispatches": int(st["build_dispatches"]),
            "dedup_docs": dedup_docs, "dedup_s": dedup_s,
            "kept": len(kept)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkout roots, in run order")
    ap.add_argument("--windows", type=int, default=10000)
    ap.add_argument("--dedup-docs", type=int, default=72)
    ap.add_argument("--one", action="store_true",
                    help="run the single checkout given, in this process")
    args = ap.parse_args(argv)
    if args.one:
        out = one(pathlib.Path(args.roots[0]).resolve(), args.windows,
                  args.dedup_docs)
        print(json.dumps(out), flush=True)
        return 0
    for root in args.roots:
        subprocess.run([sys.executable, __file__, "--one", root,
                        "--windows", str(args.windows),
                        "--dedup-docs", str(args.dedup_docs)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
