"""End-to-end training entry point.

  PYTHONPATH=src python -m repro_torch.launch.train --device cuda \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir /path/to/ckpt

Trains on the card by default (``--device cpu`` runs the host, with
``--reduced`` for the small configuration).  ``--dedup`` first drops
near-duplicate documents through the paper's retrieval stack
(``data.pipeline.dedup_corpus``), whose distances run on the same device.
A run resumes from the newest checkpoint in ``--ckpt-dir``, also one the
reference package wrote.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.data.pipeline import TokenBatcher, dedup_corpus
from repro_torch.data.synthetic import token_corpus
from repro_torch.models import registry
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import Trainer, TrainerConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m",
                    choices=registry.names())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true",
                    help="accepted for the reference's command line; a run "
                         "always resumes from the newest checkpoint")
    ap.add_argument("--dedup", action="store_true",
                    help="near-duplicate filtering via the retrieval stack")
    ap.add_argument("--dedup-docs", type=int, default=128,
                    help="documents the dedup filter reads (the first "
                         "ones; its cost grows as their square)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def corpus_for(args, cfg) -> np.ndarray:
    """The run's token corpus: seeded documents of ``4 * seq`` tokens, with
    planted near-duplicates dropped by ``--dedup``."""
    corpus = token_corpus(512, args.seq * 4, cfg.vocab, seed=0,
                          dup_frac=0.1 if args.dedup else 0.0)
    if args.dedup:
        before = len(corpus)
        corpus = dedup_corpus(corpus,
                              max_docs=min(len(corpus), args.dedup_docs),
                              device=args.device)
        print(f"dedup: {before} -> {len(corpus)} docs")
    return corpus


def trainer_for(args, cfg, mod, corpus: np.ndarray,
                failure_injector=None) -> Trainer:
    batcher = TokenBatcher(corpus, args.batch, args.seq, seed=1)
    ocfg = opt_lib.OptConfig(lr=args.lr,
                             warmup_steps=max(args.steps // 20, 1),
                             total_steps=args.steps)
    return Trainer(mod, cfg, ocfg, batcher, args.ckpt_dir,
                   TrainerConfig(total_steps=args.steps,
                                 ckpt_every=args.ckpt_every,
                                 log_every=args.log_every),
                   failure_injector=failure_injector, device=args.device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the training CLI; returns the trainer's output with the corpus it
    trained on (``corpus``) and the seconds it took to make (``corpus_s``,
    the dedup included)."""
    args = parser().parse_args(argv)
    cfg, mod = registry.get(args.arch, reduced=args.reduced)
    t0 = time.perf_counter()
    corpus = corpus_for(args, cfg)
    corpus_s = time.perf_counter() - t0
    out = trainer_for(args, cfg, mod, corpus).run()
    print(json.dumps(out["log"][-5:], indent=2))
    first = out["log"][0]["loss"] if out["log"] else float("nan")
    last = out["log"][-1]["loss"] if out["log"] else float("nan")
    print(f"loss {first:.3f} -> {last:.3f} over {out['final_step']} steps")
    return {**out, "corpus": corpus, "corpus_s": corpus_s}


if __name__ == "__main__":
    main()
