"""The port's partitioned training step for the dense family against the
JAX reference's on the CPU: qwen3-4b at ``reduced()`` cut to 2 layers,
under ``TRAIN_RULES`` (FSDP over ``data``: the weights' ``d_model`` axis
split, gathered for each product, their gradients reduce-scattered; the
Megatron schedule over ``model``) on the ``(2, 2)``, ``(1, 4)`` and
``(4, 1)`` meshes: the forward's logits, and one AdamW step from the same
parameters and batch.

Tolerances: logits within ``atol = 1e-4``; the step as
``tests/torch_parity.py`` states (``tests/test_torch_train.py``'s), its
loss and gradient norm within ``rtol = atol = 1e-5``.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_sharded as tsd  # noqa: E402

MESHES = [f"{d}x{m}" for d, m in tsd.MESHES]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tsd.outputs("qwen3-4b", tmp_path_factory.mktemp("qwen3"),
                       [tsd.TRAIN], n_layers=2)


@pytest.mark.parametrize("mesh", MESHES)
def test_forward_matches_the_sharded_reference(pair, mesh):
    assert pair.check(f"{mesh}/TRAIN_RULES/forward") == 1


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_matches_the_sharded_reference(pair, mesh):
    pair.check_train(f"{mesh}/TRAIN_RULES")
