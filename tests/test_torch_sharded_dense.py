"""The port's partitioned program for the dense family against the JAX
reference's on the CPU: qwen3-4b at ``reduced()`` cut to 2 layers (its 2 kv
heads split over a model axis of 2 and stay whole over one of 4), under
``SERVE_RULES`` on the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` meshes: the
forward's logits, a prefill's logits and cache, and three decode steps
(logits and cache after each, the cache's length split over ``model``, so
each step's write lands on one shard).

The reference runs with ``XLA_FLAGS=--xla_force_host_platform_device_count
=4`` in subprocesses, the port in a ``gloo`` group of 4 CPU processes, both
from one JAX initialisation (``tests/torch_sharded.py``).  Tolerance: the
unsharded f32 checks' ``atol = 1e-4`` (``tests/test_torch_decode.py``).
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_sharded as tsd  # noqa: E402

MESHES = [f"{d}x{m}" for d, m in tsd.MESHES]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tsd.outputs("qwen3-4b", tmp_path_factory.mktemp("qwen3"),
                       [tsd.SERVE], n_layers=2)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("what", ["forward", "prefill", "decode"])
def test_serving_matches_the_sharded_reference(pair, mesh, what):
    n = pair.check(f"{mesh}/SERVE_RULES/{what}")
    assert n == {"forward": 1, "prefill": 4, "decode": 12}[what]
