"""The port's launch helpers (``repro_torch.launch.{mesh,sharding,specs,
dryrun}``) on the CPU, against the reference's.

Specs are held to the reference's ``PartitionSpec`` entries on its tests'
``FakeMesh`` (only ``.shape`` and ``.axis_names`` are read) for every
``ParamDef`` and cache def of the ten configs.  The dry-run runs every
(arch x shape) cell at ``reduced()`` with the shape cut to batch 2 and,
except for decode (whose cache costs nothing on ``meta``), 64 positions;
its ``meta`` flop counts are held to the reference's HLO dot flops
(``parse_hlo_costs`` of the jitted forward on one CPU device) per family:
equal for the dense and MoE models; for Mamba2 and the hybrid equal once
the reference's per-head ``C . B`` products are added (it repeats ``B`` and
``C`` to the heads before contracting, the port contracts once per group:
``2 B S c N (H - G)`` more flops per SSM layer, a design difference).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.launch import sharding as ref_shd  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models.params import abstract_params as ref_abstract  # noqa: E402
from repro.roofline.hlo_costs import parse_hlo_costs  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import layers, registry  # noqa: E402
from repro_torch.models.params import param_count  # noqa: E402


class FakeMesh:
    """``tests/test_launch.py``'s stand-in for a jax Mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULES = {"train": (shd.TRAIN_RULES, ref_shd.TRAIN_RULES),
         "serve": (shd.SERVE_RULES, ref_shd.SERVE_RULES)}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


# -- meshes and specs against the reference -----------------------------------

def test_meshes():
    sp, mp = mesh_lib.make_production_mesh(), \
        mesh_lib.make_production_mesh(multi_pod=True)
    assert sp.shape == MESHES["pod16x16"] and sp.n_devices == 256
    assert mp.shape == MESHES["pod2x16x16"] and mp.n_devices == 512
    assert mp.axis_names == ("pod", "data", "model")
    one = mesh_lib.make_local_mesh()
    assert one.shape == {"data": 1, "model": 1} and one.n_devices == 1
    assert mesh_lib.MESHES["h100x1"] == one
    assert mesh_lib.MESHES["pod2x16x16"] == mp


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_axis_helpers_match_reference(mesh, rules):
    port_rules, ref_rules = RULES[rules]
    assert port_rules == ref_rules
    m = FakeMesh(MESHES[mesh])
    for ax in list(ref_rules.values()) + [("pod", "data", "model"),
                                          ("model",), "nope"]:
        kept = shd._drop_missing(ax, m)
        assert kept == ref_shd._drop_missing(ax, m)
        for dim in (1, 2, 3, 16, 32, 48, 50280, 1 << 20):
            assert shd._fit_axes(dim, kept, m) == \
                ref_shd._fit_axes(dim, kept, m)


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", registry.names())
def test_specs_match_reference(arch, mesh, rules):
    """Every ParamDef (heads padded to the model axis) and every cache def
    at the decode shapes: same shapes and axes in both packages, and the
    same mesh axes per dimension, with and without the shape."""
    port_rules, ref_rules = RULES[rules]
    m = FakeMesh(MESHES[mesh])
    tp = m.shape["model"]
    cfg, mod = registry.get(arch)
    rcfg, rmod = ref_registry.get(arch)
    pairs = [(mod.param_defs(cfg, tp), rmod.param_defs(rcfg, tp))]
    for name in ("decode_32k", "long_500k"):
        sh = SHAPES[name]
        pairs.append((mod.cache_defs(cfg, sh.global_batch, sh.seq_len),
                      rmod.cache_defs(rcfg, sh.global_batch, sh.seq_len,
                                      tp)))
    n = 0
    for port_defs, ref_defs in pairs:
        port = dict(_leaves(port_defs))
        ref = dict(_leaves(ref_defs))
        assert port.keys() == ref.keys()
        for k, d in port.items():
            r = ref[k]
            if r is None:
                assert d is None
                continue
            assert (d.shape, d.axes) == (r.shape, r.axes), k
            for shape in (None, d.shape):
                got = shd.spec(m, port_rules, *d.axes, shape=shape)
                want = ref_shd.spec(m, ref_rules, *r.axes, shape=shape)
                assert got == tuple(want), (k, shape)
            n += 1
    assert n > 10


def test_spec_rejects_unknown_axis():
    with pytest.raises(KeyError):
        shd.spec(mesh_lib.MESHES["h100x1"], shd.TRAIN_RULES, "nope")


def test_shard_shape():
    m = mesh_lib.MESHES["pod2x16x16"]
    assert shd.shard_shape((64, 4096, 960), (("pod", "data"), None, "model"),
                           m) == (2, 4096, 60)
    # a dimension the axes do not divide is padded up
    assert shd.shard_shape((50280,), ("model",), m) == (3143,)
    assert shd.shard_shape((), (), m) == ()


def test_tree_specs():
    cfg, mod = registry.get("smollm-360m")
    m = mesh_lib.MESHES["pod16x16"]
    tree = shd.tree_specs(mod.param_defs(cfg, 16), m, shd.TRAIN_RULES)
    assert tree["tok"] == ("model", "data")
    assert tree["layers"]["wq"] == (None, "data", "model", None)
    assert tree["final_norm"] == (None,)


# -- per-device bytes by hand ----------------------------------------------------

def test_smollm_specs_bytes_by_hand():
    """smollm-360m (d 960, 32 layers, vocab 49,152, 15 heads padded to 16,
    5 KV heads of 64, d_ff 2,560) in bf16 on pod16x16 under the training
    rules: embed over data (960 / 16 = 60), tensor over model."""
    cfg, mod = registry.get("smollm-360m")
    m = mesh_lib.MESHES["pod16x16"]
    psp = specs.param_specs(cfg, mod, m, shd.TRAIN_RULES, 16)
    L, V16, d16, f16 = 32, 49152 // 16, 60, 2560 // 16
    elems = (2 * V16 * d16            # tok, out
             + 960                    # final_norm
             + 2 * L * 960            # ln1, ln2
             + 2 * L * d16 * 64       # wq (16 heads / 16), wo
             + 2 * L * d16 * 5 * 64   # wk, wv (KV heads unsharded)
             + 3 * L * d16 * f16)     # wg, wu, wd
    assert specs.nbytes(psp) == 2 * elems == 5_654_400
    assert psp["layers"]["wq"].local_shape == (32, 60, 1, 64)
    assert psp["layers"]["wq"].tensor.device.type == "meta"
    # f32 moments, the step a 0-d int32
    osp = specs.opt_specs(cfg, mod, m, shd.TRAIN_RULES, 16)
    assert specs.nbytes(osp) == 2 * 4 * elems + 4
    # train_4k batch: 256 x 4096 int32 tokens and labels over data
    bsp = specs.batch_specs(cfg, SHAPES["train_4k"], m, shd.TRAIN_RULES)
    assert specs.nbytes(bsp) == 2 * 16 * 4096 * 4
    # on the one card every array is whole
    one = specs.param_specs(cfg, mod, mesh_lib.MESHES["h100x1"],
                            shd.TRAIN_RULES, 1, torch.float32)
    assert specs.nbytes(one) == 4 * param_count(mod.param_defs(cfg))


def test_cache_specs_dtypes_and_sharding():
    """The decode cache of qwen3-4b at decode_32k: bf16 K and V sharded
    by batch over data and by length over model (serving rules), a 0-d
    int32 position; mamba2's SSM state in f32."""
    cfg, mod = registry.get("qwen3-4b")
    m = mesh_lib.MESHES["pod16x16"]
    csp = specs.cache_specs(cfg, mod, SHAPES["decode_32k"], m,
                            shd.SERVE_RULES)
    assert csp["k"].spec == (None, "data", "model", None, None)
    assert csp["k"].local_shape == (36, 8, 2048, 8, 128)
    assert csp["k"].tensor.dtype == torch.bfloat16
    assert csp["pos"].tensor.dtype == torch.int32 and csp["pos"].nbytes == 4
    cfg, mod = registry.get("mamba2-370m")
    csp = specs.cache_specs(cfg, mod, SHAPES["long_500k"], m,
                            shd.SERVE_RULES)
    assert csp["state"].tensor.dtype == torch.float32
    assert specs._moment_dtype(registry.get("kimi-k2-1t-a32b")[0]) == \
        "bfloat16"
    assert specs._moment_dtype(cfg) == "float32"


def test_abstract_model_is_meta():
    cfg, mod = registry.get("qwen2-72b")
    net = specs.abstract_model(cfg, torch.bfloat16, train=False)
    p = next(net.parameters())
    assert p.device.type == "meta" and p.dtype == torch.bfloat16
    assert not p.requires_grad
    assert sum(q.numel() for q in net.parameters()) == param_count(
        mod.param_defs(cfg))


# -- the dry-run ------------------------------------------------------------------

def _arrays(out):
    """The tensors of a step's output with at least one dimension."""
    if isinstance(out, torch.Tensor):
        return [out] if out.ndim else []
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _arrays(o)]
    return []


def _returned_bytes(out, inputs) -> int:
    """Bytes of the arrays a step returns that are not its inputs (a
    decode step's cache is written in place and returned; positions,
    losses and step counters are scalars and left out)."""
    ins = {id(t) for t in _arrays(inputs)}
    return sum(t.numel() * t.element_size() for t in _arrays(out)
               if id(t) not in ins)


def _cut(shape: ShapeConfig) -> ShapeConfig:
    return dataclasses.replace(
        shape, global_batch=min(shape.global_batch, 2),
        seq_len=shape.seq_len if shape.kind == "decode" else 64)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", registry.names())
def test_dryrun_reduced_grid(arch, shape):
    cfg, mod = registry.get(arch, reduced=True)
    if not dryrun.runnable(cfg, shape):
        assert shape == "long_500k" and not cfg.sub_quadratic
        return
    cut = _cut(SHAPES[shape])
    recs = dryrun.measure(arch, cut, reduced=True)
    assert [r["mesh"] for r in recs] == ["pod16x16", "pod2x16x16", "h100x1"]
    one = recs[-1]
    for r in recs:
        assert r["status"] == "ok" and r["flops_source"] == "meta"
        assert r["flops"] == one["flops"] > 0
        assert r["flops_per_device"] == r["flops"] / r["n_devices"]
        assert r["memory"]["argument_bytes"] <= one["memory"][
            "argument_bytes"]
        assert r["model_flops"] > 0 and r["fits_one_h100"]
    # h100x1: the outputs as the step returns them on meta
    dtype = torch.bfloat16
    net = specs.abstract_model(cfg, dtype, train=cut.kind == "train")
    inputs = dryrun.abstract_inputs(cfg, mod, cut, net, dtype)
    out = dryrun.step_fn(cfg, mod, cut.kind)(net, inputs)
    assert _returned_bytes(out, inputs) == \
        one["memory"]["output_bytes"]
    assert one["memory"]["param_bytes"] == 2 * param_count(
        mod.param_defs(cfg))


def _hlo_flops(arch, B, S):
    rcfg, rmod = ref_registry.get(arch, reduced=True)
    prefix = rcfg.frontend_prefix if rcfg.frontend != "none" else 0
    params = ref_abstract(rmod.param_defs(rcfg), jnp.float32)
    batch = {"tokens": jax.ShapeDtypeStruct((B, S - prefix), jnp.int32)}
    compiled = jax.jit(lambda p, b: rmod.forward(p, b, rcfg)).lower(
        params, batch).compile()
    return parse_hlo_costs(compiled.as_text())["flops"]


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-4b",
                                  "deepseek-v2-236b", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_meta_flops_match_reference_hlo(arch):
    """The port's forward on meta against the reference's HLO dot flops,
    at reduced() with batch 2 x 64 positions."""
    B, S = 2, 64
    cfg, _ = registry.get(arch, reduced=True)
    rec = dryrun.measure(arch, ShapeConfig("fwd", S, B, "prefill"),
                         ("h100x1",), dtype=torch.float32, reduced=True)[0]
    ref = _hlo_flops(arch, B, S)
    extra = 0
    if cfg.family in ("ssm", "hybrid"):
        H, G, N = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
        c = min(cfg.ssm_chunk, S)
        extra = cfg.n_layers * 2 * B * S * c * N * (H - G)
        assert extra > 0
    assert rec["flops"] + extra == ref
    if cfg.family in ("dense", "moe"):
        assert rec["flops"] == ref


def test_moe_expert_count_matches_bincount():
    """The router's load-balancing counts (a scatter-add of ones, which
    runs on meta) against ``torch.bincount`` on seeded assignments."""
    rng = np.random.default_rng(3)
    T, d, E, k = 96, 16, 8, 2
    x = torch.as_tensor(rng.normal(size=(T, d)).astype(np.float32))
    wr = torch.as_tensor(rng.normal(size=(E, d)).astype(np.float32))
    gates, idx, aux = layers.moe_router(x, wr, k)
    probs = torch.softmax((x @ wr.T).to(torch.float32), dim=-1)
    ce = torch.bincount(idx.reshape(-1), minlength=E).to(
        torch.float32) / idx.numel()
    assert torch.equal(aux, E * torch.sum(probs.mean(dim=0) * ce))
    # and on meta
    _, idx_m, aux_m = layers.moe_router(x.to("meta"), wr.to("meta"), k)
    assert idx_m.shape == (T, k) and aux_m.shape == ()


def test_run_cell_skip_resume_and_error(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "REPORT_DIR", tmp_path)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k"])
    assert e.value.code == 0
    recs = {p.name: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert len(recs) == 3
    rec = recs["mamba2-370m__long_500k__h100x1.json"]
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    assert rec["memory"]["cache_bytes"] > 0
    # resumable: a second run reads the records
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                     "--mesh", "h100x1"])
    assert e.value.code == 0 and "(cached)" in capsys.readouterr().out
    # the long_500k skip of a full-attention arch
    recs = dryrun.run_cell("qwen3-4b", "long_500k", ["h100x1"])
    assert recs[0]["status"] == "skipped" and "quadratic" in recs[0][
        "reason"]
    # an error is recorded, counted and retried
    def boom(*a, **k):
        raise RuntimeError("no meta kernel")
    monkeypatch.setattr(dryrun, "measure", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                     "--mesh", "h100x1", "--force"])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "mamba2-370m__long_500k__h100x1.json")
                     .read_text())
    assert rec["status"] == "error" and "no meta kernel" in rec["error"]
    assert "done in" in capsys.readouterr().out
