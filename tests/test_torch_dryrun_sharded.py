"""The dry-run's partitioned program on the CPU: the step of a cell under
``Ctx`` on a ``DeviceMesh`` of a ``fake`` process group of the production
mesh's world size (256 for ``pod16x16``, 512 for ``pod2x16x16``, run on
its ``(32, 16)`` fold), counted on rank 0 with ``meta`` local shards by
``roofline.costs.count_collectives``.

The dense block's collectives against a hand count (qwen3-4b at
``reduced()``: d = 64, 16 padded query heads of 16 and 2 kv heads, which
no model axis of 16 divides, d_ff = 128, vocabulary 256; cut to L = 2
layers, batch 32 x 64 positions), derived from the code:

* ``SERVE_RULES`` forward: one all-reduce of the rank's ``(B_local, S,
  d)`` activations for the vocabulary-split embedding
  (``common.embed_tokens``'s partial rows), then per layer one for the
  row-parallel output projection ``wo`` and one for the row-parallel down
  projection ``wd`` (the Megatron schedule); nothing else: attention runs
  on each rank's heads and the logits stay split over the vocabulary.
* ``TRAIN_RULES`` forward: the same all-reduces, and the FSDP gathers of
  the weights' ``d_model`` split over ``data``, one per weight and use:
  the token table (its vocabulary rows split over ``model``), per layer
  ``wq``, ``wk``, ``wv``, ``wo``, ``wg``, ``wu``, ``wd``, and the output
  head; ``wk``/``wv`` (2 kv heads, whole over ``model``) are gathered as
  the rank's rows of their output (``DTensor`` splits the product's
  output over ``model``, which is free from a replicated weight), and
  their ``(B_local, S, Hkv hd / 16)`` outputs are gathered back whole over
  ``model``: two more all-gathers per layer.

Each gather's operand is the rank's block of the weight: rows split over
``model`` (16) where that axis splits the weight or (``wk``/``wv``) its
output, columns (``d``) over ``data``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import specs as specs_lib  # noqa: E402
from repro_torch.launch.mesh import MESHES, device_mesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.layers import Ctx, gated_mlp  # noqa: E402
from repro_torch.models.params import distribute  # noqa: E402
from repro_torch.roofline import costs, report  # noqa: E402

POD_MESHES = ["pod16x16", "pod2x16x16"]
L, B, S = 2, 32, 64
BF16 = 2


def _forward_trace(mesh_name, rules, train):
    """The collectives (in order) and flops of the dense forward on one
    rank, and the unpartitioned forward's flops."""
    cfg, mod = registry.get("qwen3-4b", reduced=True)
    cfg = dataclasses.replace(cfg, n_layers=L)
    tokens = torch.empty(B, S, dtype=torch.int32, device="meta")
    net1 = specs_lib.abstract_model(cfg, torch.bfloat16, train=False)
    flops1, _ = costs.count_flops(
        lambda: mod.forward(net1, {"tokens": tokens}, cfg))
    mesh = dryrun.program_mesh(MESHES[mesh_name])
    with dryrun.fake_group(mesh.n_devices):
        ctx = Ctx(device_mesh(mesh, "cuda"), rules)
        tp = ctx.axis_size("tensor")
        net = specs_lib.abstract_model(cfg, torch.bfloat16, train=train,
                                       tp=tp)
        distribute(net, mod.param_defs(cfg, tp), ctx.mesh, rules)
        trace = []
        flops, coll, _ = costs.count_collectives(
            lambda: mod.forward(net, {"tokens": tokens}, cfg, ctx),
            trace=trace)
    return cfg, mesh, trace, flops, flops1, coll


@pytest.mark.parametrize("mesh_name", POD_MESHES)
def test_serving_forward_collectives_are_the_hand_count(mesh_name):
    cfg, mesh, trace, flops, flops1, coll = _forward_trace(
        mesh_name, shd.SERVE_RULES, train=False)
    n_data, tp = mesh.sizes
    act = ("all-reduce", (B // n_data, S, cfg.d_model), torch.bfloat16)
    assert trace == [act] * (1 + 2 * L)
    assert coll["total_bytes"] == coll["all-reduce"] == \
        (1 + 2 * L) * (B // n_data) * S * cfg.d_model * BF16
    # the rank's products: at least the even split (the 2 kv heads'
    # projections are whole on every model rank)
    assert flops >= flops1 / (n_data * tp)


@pytest.mark.parametrize("mesh_name", POD_MESHES)
def test_training_forward_collectives_are_the_hand_count(mesh_name):
    cfg, mesh, trace, _, _, coll = _forward_trace(
        mesh_name, shd.TRAIN_RULES, train=True)
    n_data, tp = mesh.sizes
    d, hd, V = cfg.d_model, cfg.head_dim, cfg.vocab_padded()
    He, Hkv, f = cfg.heads_padded(tp), cfg.n_kv_heads, cfg.d_ff
    dl = d // n_data                       # FSDP: d_model over data
    act = (B // n_data, S, d)
    want = {"all-reduce": [act] * (1 + 2 * L),
            "all-gather": [(V // tp) * dl] + [
                (He * hd // tp) * dl,           # wq: heads over model
                (Hkv * hd // tp) * dl,          # wk: its output's rows
                (Hkv * hd // tp) * dl,          # wv
                (He * hd // tp) * dl,           # wo
                (f // tp) * dl, (f // tp) * dl,  # wg, wu
                (f // tp) * dl,                 # wd
                ] * L + [(V // tp) * dl]}       # the output head
    got = {"all-reduce": [s for k, s, _ in trace if k == "all-reduce"],
           "all-gather": sorted(
               n for n in (torch.Size(s).numel() for k, s, _ in trace
                           if k == "all-gather")
               if n != (B // n_data) * S * Hkv * hd // tp)}
    assert got["all-reduce"] == want["all-reduce"]
    assert got["all-gather"] == sorted(want["all-gather"])
    kv_out = [s for k, s, _ in trace if k == "all-gather"
              and torch.Size(s).numel() == (B // n_data) * S * Hkv * hd // tp]
    assert kv_out == [(B // n_data, S, Hkv * hd // tp)] * (2 * L)
    assert {k for k, _, _ in trace} == {"all-reduce", "all-gather"}
    assert coll["total_bytes"] == BF16 * (
        (1 + 2 * L) * (B // n_data) * S * d
        + sum(want["all-gather"]) + 2 * L * (B // n_data) * S * Hkv * hd
        // tp)


@pytest.mark.parametrize("mesh_name", POD_MESHES)
def test_mlp_products_are_the_even_split(mesh_name):
    """The Megatron MLP's counted flops on one rank are exactly the
    unpartitioned flops over the mesh's devices; it sends nothing, its
    output is the rank's partial sum over ``model`` (the caller's
    constraint reduces it)."""
    cfg, _ = registry.get("qwen3-4b", reduced=True)
    d, f = cfg.d_model, cfg.d_ff
    meta = dict(dtype=torch.bfloat16, device="meta")
    x, wg, wu, wd = (torch.empty(B, S, d, **meta), torch.empty(f, d, **meta),
                     torch.empty(f, d, **meta), torch.empty(d, f, **meta))
    flops1, _ = costs.count_flops(gated_mlp, x, wg, wu, wd)
    mesh = dryrun.program_mesh(MESHES[mesh_name])
    with dryrun.fake_group(mesh.n_devices):
        ctx = Ctx(device_mesh(mesh, "cuda"), shd.SERVE_RULES)
        xd = ctx.constrain(x, "batch", "seq", None)
        ws = [ctx.constrain(wg, "tensor", "embed"),
              ctx.constrain(wu, "tensor", "embed"),
              ctx.constrain(wd, "embed", "tensor")]
        with ctx.scope():
            flops, coll, out = costs.count_collectives(gated_mlp, xd, *ws,
                                                       ctx)
    assert flops == flops1 / mesh.n_devices
    assert coll["total_bytes"] == 0
    assert str(out.placements[1]) == "P(sum)"


def _cut(kind):
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    return dataclasses.replace(SHAPES[shape], global_batch=B,
                               seq_len=S if kind != "decode" else 128)


@pytest.mark.parametrize("mesh_name", POD_MESHES)
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dense_partitioned_step_runs(mesh_name, kind):
    rec = dryrun.partitioned("qwen3-4b", _cut(kind), mesh_name,
                             reduced=True, n_layers=L)
    coll = rec["collectives"]
    assert rec["flops_per_device"] > 0 and coll["total_bytes"] > 0
    assert coll["total_bytes"] == sum(coll[k] for k in costs.COLLECTIVES)


def test_report_collective_term():
    shape = ShapeConfig("cut", S, B, "train")
    recs = dryrun.add_partitioned(
        dryrun.measure("qwen3-4b", shape, reduced=True), shape)
    rows = {r["mesh"]: report.analyze(r) for r in recs}
    for m in POD_MESHES:
        rec = next(r for r in recs if r["mesh"] == m)
        assert rec["flops_per_device"] >= rec["flops_even_split"] > 0
        assert rows[m]["collective_s"] == \
            rec["collectives"]["total_bytes"] / report.LINK_BW > 0
        assert rows[m]["compute_s"] == rec["flops_per_device"] / \
            costs.peak_flops(torch.bfloat16)
    assert rows["h100x1"]["collective_s"] == 0
    assert "450e9" in report.COLLECTIVE_NOTE
