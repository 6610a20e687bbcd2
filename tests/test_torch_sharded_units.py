"""Units of the port's partitioned program on the CPU.

* ``Ctx``: without a mesh ``constrain`` returns its input object and
  ``axis_size`` is 1; on every test and production mesh ``axis_size``
  equals the reference's for each logical axis and rule set.
* ``update_cache`` in a ``gloo`` group of 4 CPU processes: on a cache whose
  length is split over ``model`` only the shard owning ``pos`` changes,
  and only at ``pos``; the whole cache equals the unsharded write.
* The expert-parallel ``moe_block`` (deepseek-v2-236b at ``reduced()``,
  ``capacity_factor = 1.25``, the reference's init): on each mesh every
  data shard keeps exactly the ``(token, expert)`` assignments the
  reference's router and capacity rule keep on that shard's own tokens
  (capacity from its own count), its output is the reference's local
  function per shard (within ``rtol = atol = 1e-5``,
  ``tests/test_torch_moe.py``'s) and its aux loss data shard 0's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_sharded as tsd  # noqa: E402
from repro.launch import sharding as ref_shd  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import MESHES, Mesh  # noqa: E402
from repro_torch.models.layers import NOCTX, Ctx  # noqa: E402
from test_torch_moe import _oracle_kept  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TEST_MESHES = [Mesh(("data", "model"), m) for m in tsd.MESHES]


def test_constrain_without_a_mesh_is_the_identity():
    x = torch.ones(2, 3, 4)
    assert NOCTX.constrain(x, "batch", "seq", None) is x
    assert NOCTX.axis_size("tensor") == 1 and NOCTX.scope() is not None


@dataclasses.dataclass
class _RefMesh:
    """What the reference's ``Ctx.axis_size`` reads of a mesh."""

    shape: dict


@pytest.mark.parametrize("mesh", TEST_MESHES + list(MESHES.values()),
                         ids=lambda m: "x".join(map(str, m.sizes)))
@pytest.mark.parametrize("rules", ["TRAIN_RULES", "SERVE_RULES"])
def test_axis_size_is_the_references(mesh, rules):
    ours = Ctx(mesh, getattr(shd, rules))
    ref = ref_layers.Ctx(_RefMesh(mesh.shape), getattr(ref_shd, rules))
    for name in shd.TRAIN_RULES:
        assert ours.axis_size(name) == ref.axis_size(name), name


def _skewed(router, seed=1):
    """Tokens ``(4, 16, d)`` that lean toward expert 0 of ``router``
    (``(d, E)``), so that it overflows its capacity on every shard."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 16, router.shape[0])).astype(np.float32)
    lean = router[:, 0] / np.linalg.norm(router[:, 0])
    return x + 4.0 * lean.astype(np.float32)


CACHE_CASES = [((2, 2), 5), ((1, 4), 2), ((1, 4), 7)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both units' ranks in one group: the cache writes and, per mesh, the
    MoE layer on tokens leaning toward expert 0 of its router."""
    from torch_sharded_ref import init_params_np
    params, xs = {}, {}
    for m in tsd.MESHES:
        params[m] = tsd.sub(init_params_np("deepseek-v2-236b", {}, [m[1]]),
                            f"params/tp{m[1]}")
        xs[m] = _skewed(params[m]["moe_layers/router"][0])
    res = tsd.run_ranks(tsd.units, (CACHE_CASES, [
        (m, "SERVE_RULES", params[m], xs[m]) for m in tsd.MESHES]),
        tmp_path_factory.mktemp("units"))
    return res, params, xs


@pytest.mark.parametrize("mesh,pos", CACHE_CASES)
def test_update_cache_writes_only_the_owning_shard(runs, mesh, pos):
    res = runs[0]["cache"][(mesh, pos)]
    S, tp = 8, mesh[1]
    s_loc = S // tp
    assert res["placements"][1] == "S(2)"      # the length over model
    for rank, in_place, shape, changed in res["ranks"]:
        assert in_place and shape[2] == s_loc
        owner = rank % tp == pos // s_loc
        assert changed == ([pos % s_loc] if owner else []), rank
    want = np.zeros((1, 4, 8, 2, 4), np.float32)
    want[:, :, pos] = np.arange(32, dtype=np.float32).reshape(1, 4, 2, 4) + 1
    np.testing.assert_array_equal(res["full"], want)


@pytest.mark.parametrize("mesh", tsd.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_kept_sets_and_output_per_data_shard(runs, mesh):
    from repro.models import registry
    res, params, xs = runs
    res, x = res["moe"][mesh], xs[mesh]
    cfg, _ = registry.get("deepseek-v2-236b", reduced=True)
    layer = {k.split("/", 1)[1]: jnp.asarray(v[0])
             for k, v in params[mesh].items() if k.startswith("moe_layers/")}
    p = {k: v for k, v in layer.items() if not k.startswith("shared/")}
    p["shared"] = {k.split("/")[1]: v for k, v in layer.items()
                   if k.startswith("shared/")}
    n_data = mesh[0]
    b = x.shape[0] // n_data
    outs = []
    for d in range(n_data):
        xd = jnp.asarray(x[d * b:(d + 1) * b])
        T = b * x.shape[1]
        _, idx, aux = ref_layers.moe_router(xd.reshape(T, -1), p["router"],
                                            cfg.top_k)
        cap = max(8, int(T * cfg.top_k * cfg.capacity_factor)
                  // cfg.n_experts)
        assert res["kept"][d] == _oracle_kept(idx, cfg.n_experts, cap), d
        assert len(res["kept"][d]) < T * cfg.top_k    # tokens were dropped
        if d == 0:
            np.testing.assert_allclose(res["aux"], float(aux), **TOL)
        out, _ = ref_layers.moe_block(p, xd, cfg)
        outs.append(np.asarray(out))
    np.testing.assert_allclose(res["out"], np.concatenate(outs), **TOL)
