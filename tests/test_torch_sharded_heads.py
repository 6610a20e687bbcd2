"""Padded query heads in the port's partitioned program on the CPU:
smollm-360m at ``reduced()`` cut to 2 layers has 3 query heads and 1 kv
head; on a model axis of 4 the heads are padded to 4 (``heads_padded``)
and the padding head is masked, as in the reference.  Under
``SERVE_RULES`` on the ``(1, 4)`` mesh the forward, a prefill and three
decode steps (the ungrouped decode form: 4 heads are no multiple of the
group of 3) are held to the reference's sharded program within
``atol = 1e-4`` (``tests/torch_sharded.py``).
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_sharded as tsd  # noqa: E402


@pytest.fixture(scope="module")
def smollm(tmp_path_factory):
    return tsd.outputs("smollm-360m", tmp_path_factory.mktemp("smollm"),
                       [tsd.SERVE], meshes=[(1, 4)], n_layers=2)


@pytest.mark.parametrize("what", ["forward", "prefill", "decode"])
def test_padded_heads_match_the_sharded_reference(smollm, what):
    assert smollm.check(f"1x4/SERVE_RULES/{what}")
