"""Continuous-batching serve CLI — the front end of the serve engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --dataset proteins \
      --n-windows 2000 --shards 4 --queries 32 --eps 2.0 --qps 16

  # or declaratively: the whole retrieval stack from one JSON config
  PYTHONPATH=src python -m repro_torch.launch.serve --config fleet.json \
      --qps 16 --duration 2.0 --snapshot-dir fleet-snaps

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; a config file's own ``device`` is replaced by the flag.

``--config path.json`` deserializes straight into
:class:`~repro.retrieval.RetrievalConfig` (the file is exactly
``RetrievalConfig.to_json()`` output).  The driver builds the fleet
through the :class:`~repro.retrieval.Retriever` facade, then serves an
open-loop Poisson request stream through the continuous-batching
:class:`~repro.serve.engine.ServeEngine`: asynchronous requests join the
shared frontier cadence mid-flight (one packed dispatch per merged
round), a mid-load ``resize()`` runs through the zero-downtime
snapshot-swap path, and every answer is cross-checked against the host
per-shard oracle loop.  Latency lands as p50/p95/p99 percentiles.

Timing methodology: an UNTIMED warmup batch runs first, so the timed
section measures warm serving — the kernel's first-use build and load
never pollute the reported qps.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np

from repro_torch.data import synthetic
from repro_torch.retrieval import RetrievalConfig, Retriever
from repro_torch.serve import OpenLoopLoadGen


def build_config(args) -> RetrievalConfig:
    """``--config path.json`` round-trips the declarative config; otherwise
    the legacy flags assemble the same dataclass."""
    if args.config:
        cfg = RetrievalConfig.from_json(
            pathlib.Path(args.config).read_text())
        if cfg.execution != "fleet":
            raise SystemExit(
                f"serve.py drives a fleet; config has "
                f"execution={cfg.execution!r}")
        return cfg.replace(device=args.device)
    _, default_dist = synthetic.DATASETS[args.dataset]
    return RetrievalConfig(
        distance=args.distance or default_dist or "erp",
        execution="fleet",
        workers=[f"worker{i}" for i in range(args.shards)],
        tight_bounds=True, device=args.device)


def make_queries(data: np.ndarray, n: int, rng) -> np.ndarray:
    """Database rows perturbed into near-miss queries."""
    queries = data[rng.integers(0, len(data), n)].copy()
    if data.dtype.kind == "i":
        flips = rng.random(queries.shape) < 0.1
        queries[flips] = rng.integers(0, queries.max() + 1, flips.sum())
    else:
        queries += rng.normal(scale=0.1, size=queries.shape).astype(
            queries.dtype)
    return queries


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="path to a RetrievalConfig JSON (to_json output); "
                         "replaces --distance/--shards")
    ap.add_argument("--dataset", default="proteins",
                    choices=["proteins", "songs", "traj"])
    ap.add_argument("--distance", default=None)
    ap.add_argument("--n-windows", type=int, default=2000)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--queries", type=int, default=32,
                    help="distinct query windows (cycled if --duration "
                         "asks for more requests)")
    ap.add_argument("--eps", type=float, default=2.0)
    ap.add_argument("--qps", type=float, default=8.0,
                    help="open-loop Poisson arrival rate")
    ap.add_argument("--duration", type=float, default=None,
                    help="seconds of load (default: queries/qps)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="fleet snapshot directory (default: a temp dir)")
    ap.add_argument("--resize-to", type=int, default=-1,
                    help="mid-load zero-downtime resize to this many "
                         "workers (-1 = one fewer than built; 0 = skip)")
    ap.add_argument("--device", default="cuda",
                    help="where the fleet evaluates: cuda (default) or cpu")
    args = ap.parse_args(argv)

    config = build_config(args)
    if args.snapshot_dir:
        config = config.replace(serve_snapshot_dir=args.snapshot_dir)
    gen, _ = synthetic.DATASETS[args.dataset]
    data = gen(args.n_windows, seed=0)
    rng = np.random.default_rng(1)

    t0 = time.time()
    fleet = Retriever.build(config, data)
    build_s = time.time() - t0
    workers = fleet.elastic().workers

    queries = make_queries(data, args.queries, rng)
    n_requests = len(queries) if args.duration is None \
        else max(1, int(args.qps * args.duration))
    qlist = [queries[i % len(queries)] for i in range(n_requests)]

    # oracle BEFORE serving: the host per-shard loop in ONE facade batch
    # call (hit sets are shard-layout-invariant, so it stays valid across
    # the mid-load resize below)
    oracle = fleet.batch(queries).via("host").range(args.eps).hits

    # UNTIMED warmup: the kernel's first use builds and loads it, so the
    # timed section below measures warm serving only
    fleet.batch(queries[:2]).range(args.eps)

    engine = fleet.serve(args.eps).start()
    load = OpenLoopLoadGen(engine, qlist, args.qps, eps=args.eps).start()
    t0 = time.time()
    resize_to = (len(workers) - 1 if args.resize_to == -1
                 else args.resize_to)
    did_resize = False
    if resize_to and resize_to != len(workers):
        # mid-load: snapshot -> reshard a clone off-path -> swap at a
        # round boundary; the stream keeps serving throughout
        time.sleep(0.5 / args.qps)
        new_workers = (workers[:resize_to] if resize_to < len(workers)
                       else workers + [f"w{i}" for i in
                                       range(resize_to - len(workers))])
        engine.resize(new_workers, block=False)
        did_resize = True
    reqs = load.join()
    if did_resize:
        deadline = time.time() + 60
        while engine.swaps == 0 and time.time() < deadline:
            time.sleep(1e-3)
    engine.close(drain=True)
    serve_s = time.time() - t0

    mismatched = [i for i, r in enumerate(reqs)
                  if not r.done or r.hits != oracle[i % len(queries)]]
    if mismatched:
        raise SystemExit(f"serving drifted from the oracle: {mismatched}")
    if did_resize:
        if engine.swaps != 1:
            raise SystemExit("the snapshot-swap resize did not complete")
        post = [engine.submit(q) for q in queries]
        engine.start()
        engine.close(drain=True)
        if [r.result() for r in post] != oracle:
            raise SystemExit("post-swap serving drifted from the oracle")

    lat = engine.latency_stats()
    stats = engine.engine_stats()
    evals = fleet.eval_stats()
    print(json.dumps({
        "dataset": args.dataset, "distance": config.dist.name,
        "config": config.to_dict(),
        "device": args.device,
        "windows": len(data), "shards": len(workers),
        "build_s": round(build_s, 2),
        "requests": len(reqs),
        "serve_s": round(serve_s, 3),
        "warm_qps": round(len(reqs) / serve_s, 1),
        "merged_rounds": stats["rounds"],
        "mean_rounds_per_request": lat.get("mean_rounds"),
        "swaps": stats["swaps"],
        "latency_p50_ms": round(1e3 * lat["p50"], 2),
        "latency_p95_ms": round(1e3 * lat["p95"], 2),
        "latency_p99_ms": round(1e3 * lat["p99"], 2),
        "queue_p50_ms": round(1e3 * lat.get("queue_p50", 0.0), 2),
        "hits": sum(len(r.hits) for r in reqs),
        "query_evals": evals["query"],
        "build_evals": evals["build"],
    }, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
