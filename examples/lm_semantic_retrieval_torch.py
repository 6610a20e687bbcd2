"""End-to-end driver on the PyTorch/CUDA port (model half x paper half):
train a small LM for a few hundred steps, then use its hidden states for
semantic subsequence retrieval — embedding windows indexed in a reference
net (Euclidean is metric + consistent, paper §4).  Prints what
`lm_semantic_retrieval.py` prints on its first run.

  PYTHONPATH=src python examples/lm_semantic_retrieval_torch.py \
      [--steps 200] [--device cpu]

Trains in f32 on the card by default; ``--device cpu`` trains on the host.
Asking for ``cuda`` without a card raises before training.  Checkpoints go
to a fresh temporary directory that is removed at exit, so every run trains
from its own initialisation and never resumes an earlier run.
"""

import argparse
import tempfile

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core.embedding_retrieval import embed_windows
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.data.synthetic import token_corpus
from repro_torch.models import registry
from repro_torch.retrieval import RetrievalConfig, Retriever
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    cfg, mod = registry.get(args.arch, reduced=True)
    corpus = token_corpus(256, 256, cfg.vocab, seed=0)
    batcher = TokenBatcher(corpus, batch=8, seq=64, seed=1)
    ocfg = opt_lib.OptConfig(lr=1e-3, warmup_steps=10,
                             total_steps=args.steps)
    with tempfile.TemporaryDirectory(prefix="lm_ckpt_") as ckpt_dir:
        trainer = Trainer(mod, cfg, ocfg, batcher, ckpt_dir,
                          TrainerConfig(total_steps=args.steps,
                                        ckpt_every=100,
                                        log_every=max(args.steps // 10, 1)),
                          device=dev)
        out = trainer.run()
    losses = [e["loss"] for e in out["log"]]
    print(f"trained {out['final_step']} steps; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training should reduce loss"

    # index hidden-state windows of a corpus slice; probe with a paraphrase
    # (here: the same sequence, which must retrieve itself at distance ~0,
    # and near-duplicates at small distance)
    rng = np.random.default_rng(5)
    seqs = [corpus[i, :96] for i in range(12)]
    dup = seqs[3].copy()
    flips = rng.random(dup.shape) < 0.05
    dup[flips] = rng.integers(0, cfg.vocab, flips.sum())
    seqs.append(dup)

    vecs, meta = embed_windows(mod, out["params"], cfg, seqs, window=16,
                               device=dev)
    ret = Retriever.build(
        RetrievalConfig("euclidean", index="embedding", eps_prime=0.02,
                        num_max=5, tight_bounds=True, device=str(dev)),
        vecs)
    probe = next(i for i, m in enumerate(meta) if m.seq_id == len(seqs) - 1)
    near = ret.query(vecs[probe]).nearest(2.0, tol=1e-3)
    assert near, "the probe must retrieve something"
    win, d = meta[near.first], near.distances[0]
    print(f"near-duplicate window retrieved: seq {win.seq_id} "
          f"@{win.start} (d={d:.4f}) for probe from seq {len(seqs)-1}")
    others = ret.query(vecs[probe]).range(0.5)
    print(f"{len(others)} windows within eps=0.5; "
          f"evals={ret.eval_stats()['query']} vs naive={len(vecs)}")
    return {"vecs": vecs, "meta": meta, "log": out["log"],
            "final_step": out["final_step"], "probe": probe,
            "nearest": near, "range": others,
            "eval_stats": ret.eval_stats()}


if __name__ == "__main__":
    main()
