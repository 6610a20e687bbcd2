"""The port's partitioned program for the hybrid family against the JAX
reference's on the CPU: zamba2-1.2b at ``reduced()`` cut to 3 layers (a
group of 2 SSM layers and the shared attention block, then a tail layer),
on the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` meshes, under ``SERVE_RULES``
(forward, prefill, three decode steps: conv windows and states split over
``model``, the shared block's KV cache along its length) and
``TRAIN_RULES`` (forward, one AdamW step).  Tolerances as
``tests/test_torch_sharded_dense.py`` and ``_train.py`` state."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_sharded as tsd  # noqa: E402

MESHES = [f"{d}x{m}" for d, m in tsd.MESHES]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tsd.outputs("zamba2-1.2b", tmp_path_factory.mktemp("zamba2"),
                       [tsd.SERVE, tsd.TRAIN], n_layers=3)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("what", ["SERVE_RULES/forward", "SERVE_RULES/prefill",
                                  "SERVE_RULES/decode", "TRAIN_RULES/forward"])
def test_matches_the_sharded_reference(pair, mesh, what):
    assert pair.check(f"{mesh}/{what}")


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_matches_the_sharded_reference(pair, mesh):
    pair.check_train(f"{mesh}/TRAIN_RULES")
