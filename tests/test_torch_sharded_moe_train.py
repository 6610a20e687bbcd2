"""The port's partitioned training step for the MoE family against the
JAX reference's on the CPU: deepseek-v2-236b at ``reduced()`` cut to 2
layers, under ``TRAIN_RULES`` on the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``
meshes: the forward's logits and aux loss and one AdamW step with the aux
loss in it.

The reference returns data shard 0's aux loss but differentiates the mean
over the data shards (each shard's cotangent is the replicated output's);
the port gives both.  Tolerances: logits within ``atol = 1e-4``; the step
as ``tests/torch_parity.py`` states for an MoE model (at most 1 element in
200 near its gradient's rounding).
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_sharded as tsd  # noqa: E402

MESHES = [f"{d}x{m}" for d, m in tsd.MESHES]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tsd.outputs("deepseek-v2-236b", tmp_path_factory.mktemp("dsv2"),
                       [tsd.TRAIN], n_layers=2)


@pytest.mark.parametrize("mesh", MESHES)
def test_forward_matches_the_sharded_reference(pair, mesh):
    assert pair.check(f"{mesh}/TRAIN_RULES/forward") == 2


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_matches_the_sharded_reference(pair, mesh):
    pair.check_train(f"{mesh}/TRAIN_RULES", max_loose=5e-3)
