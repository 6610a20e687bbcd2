"""The port's partitioned program for the MoE family against the JAX
reference's on the CPU: deepseek-v2-236b at ``reduced()`` cut to 2 layers
(1 dense + 1 MoE, 8 experts, top 2, ``capacity_factor = 1.25``, the routed
experts split over ``model``), under ``SERVE_RULES`` on the ``(2, 2)``,
``(1, 4)`` and ``(4, 1)`` meshes: the forward's logits and aux loss, a
prefill's logits and latent caches, three absorbed decode steps.

The reference's expert-parallel branch is not its unsharded function: each
data shard routes its own tokens with a capacity from its own count, and
the aux loss it returns is data shard 0's.  The port is held to that
sharded program (logits within ``atol = 1e-4``, the aux loss within
``rtol = atol = 1e-5``, ``tests/test_torch_moe.py``'s); each shard's kept
assignments are checked in ``tests/test_torch_sharded_units.py``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_sharded as tsd  # noqa: E402

MESHES = [f"{d}x{m}" for d, m in tsd.MESHES]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tsd.outputs("deepseek-v2-236b", tmp_path_factory.mktemp("dsv2"),
                       [tsd.SERVE], n_layers=2)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("what", ["forward", "prefill", "decode"])
def test_serving_matches_the_sharded_reference(pair, mesh, what):
    n = pair.check(f"{mesh}/SERVE_RULES/{what}")
    assert n == {"forward": 2, "prefill": 6, "decode": 18}[what]


@pytest.mark.parametrize("mesh", MESHES)
def test_aux_is_data_shard_zeros(pair, mesh):
    key = f"{mesh}/SERVE_RULES/forward/aux"
    np.testing.assert_allclose(pair.got[key], pair.want[key], rtol=1e-5,
                               atol=1e-5)
