"""The port's roofline tooling (``repro_torch.roofline``) on the CPU: the
kernels' cost models on hand-counted rows, the decode step's bytes, flop
counting, the model flops of every cell against the reference's, and the
report's terms on a synthetic record."""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.roofline import report as ref_report  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.roofline import costs, report  # noqa: E402

# -- the wavefront's cost model, rows counted by hand -------------------------

#: (mode, d, lx, ly, eps, ops, bytes): per cell cost + combine + clamp
#: (lev 1 + 4 + 0, dtw 3d+1 + 3 + 1, erp 3d+1 + 5 + 1 and per element of
#: the lengths 2d + 3, dfd 3d+1 + 3 + 0), one more per cell of a row with
#: finite eps; bytes 4 (|xs| + |ys|) + 12 per row (lengths, eps) + 6 per
#: row (dist, hit, pruned)
WAVEFRONT_ROWS = [
    # 3 x 4 cells; xs (1, 3), ys (1, 4) int32
    ("lev", 1, [3], [4], [np.inf], 12 * 5, 4 * 7 + 12 + 6),
    # 4 x 5 + 3 x 2 = 26 cells; the second row's 6 certified; xs (2, 4, 2),
    # ys (2, 5, 2)
    ("dtw", 2, [4, 3], [5, 2], [np.inf, 1.0], 26 * 11 + 6,
     4 * (16 + 20) + 2 * 12 + 2 * 6),
    ("dfd", 2, [4, 3], [5, 2], [np.inf, 1.0], 26 * 10 + 6,
     4 * (16 + 20) + 2 * 12 + 2 * 6),
    # gap and border: (4 + 5) + (3 + 2) elements x (2d + 3)
    ("erp", 2, [4, 3], [5, 2], [np.inf, 1.0], 26 * 13 + 6 + 14 * 7,
     4 * (16 + 20) + 2 * 12 + 2 * 6),
]


def _rows(mode, d, lx, ly):
    B, Lx, Ly = len(lx), max(lx), max(ly)
    if mode == "lev":
        return np.zeros((B, Lx), np.int32), np.zeros((B, Ly), np.int32)
    return (np.zeros((B, Lx, d), np.float32),
            np.zeros((B, Ly, d), np.float32))


@pytest.mark.parametrize("mode,d,lx,ly,eps,ops,nbytes", WAVEFRONT_ROWS,
                         ids=[r[0] for r in WAVEFRONT_ROWS])
def test_wavefront_cost_hand_counted(mode, d, lx, ly, eps, ops, nbytes):
    xs, ys = _rows(mode, d, lx, ly)
    rep = costs.wavefront_cost(mode, xs, ys, lx, ly, np.asarray(eps))
    assert rep["ops"] == ops
    assert rep["bytes"] == nbytes
    t_bytes = nbytes / costs.PEAK_BYTES * 1e3
    t_ops = ops / costs.PEAK_F32_OPS * 1e3
    assert rep["bound_ms"] == max(t_bytes, t_ops)
    assert rep["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")
    # the report over the kernel's own arguments (tensors, lens (B, 2))
    lens = torch.as_tensor(np.stack([lx, ly], 1).astype(np.int32))
    kr = costs.kernel_cost_report("wavefront", torch.as_tensor(xs),
                                  torch.as_tensor(ys), lens,
                                  torch.as_tensor(eps), mode=mode)
    assert {k: kr[k] for k in rep} == rep
    assert kr["intensity"] == ops / nbytes


def test_wavefront_cost_bound_by_operations():
    """One 20 x 20 Levenshtein row: 2,000 operations against 178 bytes
    bind on the operations; the earlier count (cost 3, combine 5, clamp 1,
    certificate 2 per cell, at the FMA rate) is kept beside it."""
    xs = np.zeros((1, 20), np.int32)
    rep = costs.wavefront_cost("lev", xs, xs, [20], [20], [np.inf])
    assert (rep["ops"], rep["bytes"]) == (2000, 178)
    assert rep["bound_by"] == "operations"
    assert rep["bound_ms"] == 2000 / costs.PEAK_F32_OPS * 1e3
    assert rep["old_bound_ms"] == 400 * 11 / costs.PEAK_F32_FLOPS * 1e3


def test_pairwise_l2_cost_at_8192_squared():
    rep = costs.pairwise_l2_cost(8192, 8192, 960)
    assert rep["bound_by"] == "operations"
    assert round(rep["bound_ms"], 3) == 0.786
    assert rep["bytes"] == 4.0 * (2 * 8192 * 960 + 8192 * 8192)
    kr = costs.kernel_cost_report("pairwise_l2",
                                  torch.empty(8192, 960, device="meta"),
                                  torch.empty(8192, 960, device="meta"))
    assert kr["bound_ms"] == rep["bound_ms"]
    assert kr["intensity"] == rep["flops"] / rep["bytes"]
    # a small matrix is bound by its bytes
    assert costs.pairwise_l2_cost(64, 64, 8)["bound_by"] == "bytes"
    with pytest.raises(KeyError):
        costs.kernel_cost_report("conv", None)


@pytest.mark.parametrize("n_need", [0, 7, 100])
def test_ring_filter_cost_hand_counted(n_need):
    """3 queries, 2 pivots, 5 pairs into 10 windows of 6 int32 tokens,
    query rows of 4 int32 tokens: 15 slots of 5 operations; read 5 x 12
    pair bytes, 2 x 4 radii, 3 x 2 x 4 of dp, 3 x (16 + 4) query bytes and
    min(10, n_need) window rows of 24 bytes; written n_need x (8 + 8 + 4
    + 16 + 24)."""
    rep = costs.ring_filter_cost(3, 2, 5, 10, 16, 24, n_need)
    nbytes = 60 + 8 + 24 + 60 + min(10, n_need) * 24 + n_need * 60
    assert rep["ops"] == 75
    assert rep["bytes"] == nbytes
    assert rep["bound_by"] == "bytes"
    assert rep["bound_ms"] == nbytes / costs.PEAK_BYTES * 1e3
    kr = costs.kernel_cost_report(
        "ring_filter", torch.empty(3, 2), torch.empty(5, dtype=torch.int32),
        torch.empty(3, 4, dtype=torch.int32),
        torch.empty(10, 6, dtype=torch.int32), n_need=n_need)
    assert {k: kr[k] for k in rep} == rep
    assert kr["intensity"] == 75 / nbytes


def test_peaks():
    assert costs.peak_flops(torch.bfloat16) == 989e12
    assert costs.peak_flops(torch.float32) == 67e12
    assert costs.HBM_BYTES == 80 * 2**30
    with pytest.raises(ValueError):
        costs.peak_flops(torch.int32)


# -- the decode step's bytes --------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-1.2b"])
def test_decode_step_bytes(arch):
    """Every parameter but the token table, read once (the hybrid's shared
    block once per application), plus the cache."""
    cfg, mod = registry.get(arch, reduced=True)
    defs = mod.param_defs(cfg)
    gen = torch.Generator().manual_seed(0)
    model = mod.build(cfg, init_params(defs, gen, torch.float32, "cpu"),
                      dtype=torch.float32, device="cpu")

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else
                   4 * math.prod(v.shape) for k, v in tree.items()
                   if k != "tok")
    w = count(defs)
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid
        w += (hybrid.n_applications(cfg) - 1) * count(defs["shared"])
        assert hybrid.n_applications(cfg) > 1
    assert costs.decode_step_bytes(model, 1000) == (w + 1000, w)


# -- flop counting -------------------------------------------------------------

def test_count_flops_counts_products_on_meta():
    a = torch.empty(4, 8, device="meta")
    b = torch.empty(8, 16, device="meta")
    flops, out = costs.count_flops(lambda x, y: torch.relu(x @ y), a, b)
    assert flops == 2 * 4 * 8 * 16
    assert out.shape == (4, 16) and out.device.type == "meta"


def test_count_flops_counts_the_backward():
    w = torch.empty(8, 16, device="meta", requires_grad=True)
    x = torch.empty(4, 8, device="meta")

    def step():
        return torch.autograd.grad((x @ w).sum(), w)
    flops, _ = costs.count_flops(step)
    assert flops == 2 * (2 * 4 * 8 * 16)  # forward and dW


# -- the report ----------------------------------------------------------------

@pytest.mark.parametrize("arch", registry.names())
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_match_reference(arch, shape):
    cfg, _ = registry.get(arch)
    rcfg, _ = ref_registry.get(arch)
    assert report.model_flops_for(cfg, SHAPES[shape]) == \
        ref_report.model_flops_for(rcfg, REF_SHAPES[shape])


def _record(**kw):
    rec = {"arch": "smollm-360m", "shape": "train_4k", "mesh": "h100x1",
           "status": "ok", "dtype": "bfloat16", "n_devices": 1,
           "flops": 4.0e15, "model_flops": 2.6e15,
           "memory": {"argument_bytes": 8e9, "output_bytes": 2e9}}
    rec.update(kw)
    return rec


def test_analyze_synthetic_record():
    row = report.analyze(_record(), step_s=5.0)
    assert row["compute_s"] == 4.0e15 / 989e12
    assert row["memory_s"] == 1e10 / 3.35e12
    assert row["dominant"] == "compute"
    assert row["step_s"] == row["compute_s"]
    assert row["mfu"] == pytest.approx(2.6 / 4.0)
    assert row["useful_frac"] == 2.6e15 / 4.0e15
    assert row["collective_s"] == 0 and row["collective_note"]
    assert row["fits"] and row["hbm_gib"] == 1e10 / 2**30
    assert row["measured_mfu"] == 2.6e15 / (989e12 * 5.0)
    # a pod: per-chip flops, f32 peak, memory-bound, over 80 GiB
    row = report.analyze(_record(n_devices=256, dtype="float32",
                                 flops=4.0e13,
                                 memory={"argument_bytes": 90 * 2**30,
                                         "output_bytes": 0}))
    assert row["flops_per_dev"] == 4.0e13 / 256
    assert row["compute_s"] == 4.0e13 / 256 / 67e12
    assert row["dominant"] == "memory" and not row["fits"]
    assert report.analyze(_record(status="error")) is None


def test_report_markdown_rows():
    rows = [report.analyze(_record()),
            {"arch": "qwen3-4b", "shape": "long_500k", "mesh": "h100x1",
             "skipped": "quadratic"},
            {"arch": "qwen3-4b", "shape": "train_4k", "mesh": "h100x1",
             "error": "RuntimeError: x"}]
    md = report.to_markdown(rows).splitlines()
    assert len(md) == 5 and "fits H100" in md[0]
    assert md[2].startswith("| smollm-360m | train_4k |") and "yes" in md[2]
    assert "skip" in md[3] and "ERROR" in md[4]
