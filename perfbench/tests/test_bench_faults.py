"""The timed path broken underneath a CPU rehearsal: ``correct`` has to
come out false for each fault a cell can have."""

import pytest

from perfbench.tests.test_bench_rehearsal import CELLS, TINY, rehearse

#: a larger database, so a fault has hits to spoil
BUSY = {"config": {"windows": 400}, "cell": TINY["cell"]}


def _altered_answers(monkeypatch):
    """A wrong answer where it is produced: the kernel's distances one
    higher, so a window at eps is no longer a hit."""
    from repro_torch.kernels import wavefront as wf

    def fault(run):
        orig = wf.wavefront_torch

        def altered(xs, ys, lens, eps, *, mode):
            dist, hit, pruned = orig(xs, ys, lens, eps, mode=mode)
            dist = dist + 1.0
            return dist, hit & (dist <= eps), pruned
        monkeypatch.setattr(wf, "wavefront_torch", altered)
    return fault


def _shard_left_out(monkeypatch):
    """One shard's answers never merged (the exchange between shards)."""
    from repro_torch.core import distributed

    def fault(run):
        orig = distributed.fleet_range_query

        def fleet_range_query(*a, **k):
            res, stats = orig(*a, **k)
            res[1] = None
            return res, stats
        monkeypatch.setattr(distributed, "fleet_range_query",
                            fleet_range_query)
    return fault


def _half_batch(monkeypatch):
    """Half of each batch answered, the rest left out (empty answers)."""
    from repro_torch.launch import elastic

    def fault(run):
        orig = elastic.ElasticIndex.range_query_batch

        def half(self, qs, eps, **k):
            n = len(qs) // 2
            return orig(self, qs[:n], eps, **k) + [[] for _ in qs[n:]]
        monkeypatch.setattr(elastic.ElasticIndex, "range_query_batch", half)
    return fault


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("kind", ["altered", "shard"])
def test_fault_makes_correct_false(monkeypatch, name, kind):
    fault = (_altered_answers(monkeypatch) if kind == "altered"
             else _shard_left_out(monkeypatch))
    res = rehearse(name, fault=fault, tiny=BUSY)
    assert not res["correct"], res["checks"]
    assert res["checks"]["mismatched_queries"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_half_batch_makes_correct_false(monkeypatch, name):
    res = rehearse(name, fault=_half_batch(monkeypatch), tiny=BUSY)
    assert not res["correct"]
    assert res["checks"]["mismatched_queries"]["value"] > 0
