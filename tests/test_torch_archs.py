"""Every architecture of the reference in the port: the registry, the
configs and ``SHAPES``, full-config parameter counts through ``meta``
tensors, the published sizes, the ``long_500k`` rule, and the training
CLI's ``--arch``.

Counts and configs are compared exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models.params import param_count as ref_param_count  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.params import abstract_params, param_count  # noqa: E402


@pytest.mark.parametrize("arch", sorted(ref_registry.ARCHS))
def test_full_config_param_count_matches_reference(arch):
    """Every architecture is ported and counts its full config's parameters
    exactly as the reference does, through ``meta`` tensors (nothing is
    allocated, kimi-k2's trillion included)."""
    assert arch in registry.ARCHS
    cfg, mod = registry.get(arch)
    rcfg, rmod = ref_registry.get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    want = ref_param_count(rmod.param_defs(rcfg))
    assert param_count(mod.param_defs(cfg)) == want
    tree = abstract_params(mod.param_defs(cfg))
    leaves = [t for _, t in _flat_leaves(tree)]
    assert all(t.is_meta and t.dtype == torch.bfloat16 for t in leaves)
    assert sum(t.numel() for t in leaves) == want
    assert abstract_params(mod.param_defs(cfg, tp=16),
                           torch.float32)["tok"].is_meta


def _flat_leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat_leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


@pytest.mark.parametrize("arch,published_b,tol", [
    ("qwen2-72b", 72.7, 0.08),
    ("qwen2.5-32b", 32.8, 0.08),
    ("qwen3-4b", 4.0, 0.15),
    ("smollm-360m", 0.362, 0.15),
    ("mamba2-370m", 0.37, 0.20),
    ("zamba2-1.2b", 1.2, 0.25),
    ("deepseek-v2-236b", 236.0, 0.08),
    ("kimi-k2-1t-a32b", 1026.0, 0.10),
])
def test_param_count_matches_published(arch, published_b, tol):
    """``tests/test_models_smoke.py``'s published sizes, every one of
    them."""
    cfg, mod = registry.get(arch)
    n = param_count(mod.param_defs(cfg))
    assert abs(n / 1e9 - published_b) / published_b < tol


def test_shapes_and_registry_match_reference():
    assert base.SHAPES.keys() == ref_base.SHAPES.keys()
    for k, v in base.SHAPES.items():
        assert dataclasses.asdict(v) == dataclasses.asdict(ref_base.SHAPES[k])
    assert registry.names() == ref_registry.names()
    assert len(registry.names()) == 10
    for arch in registry.names():
        for reduced in (False, True):
            cfg, _ = registry.get(arch, reduced=reduced)
            rcfg, _ = ref_registry.get(arch, reduced=reduced)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)


def test_long_context_cells_require_sub_quadratic():
    """``tests/test_models_smoke.py``'s rule (``launch/dryrun.py``'s
    ``runnable``): ``long_500k`` runs only the sub-quadratic architectures,
    exactly Mamba2 and the hybrid, in both packages."""
    runnable = [a for a in registry.names()
                if registry.get(a)[0].sub_quadratic]
    assert runnable == ["mamba2-370m", "zamba2-1.2b"]
    assert runnable == [a for a in ref_registry.names()
                        if ref_registry.get(a)[0].sub_quadratic]
    assert base.SHAPES["long_500k"].seq_len == 524_288
    assert base.SHAPES["long_500k"].kind == "decode"


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_train_cli_takes_every_ported_arch(arch, tmp_path):
    """``launch/train.py --arch`` at ``reduced()`` on the CPU: two steps,
    finite losses (the MoE models' aux loss in the step's total)."""
    assert arch in train_cli.parser().parse_args(["--arch", arch]).arch
    out = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq", "16",
                          "--log-every", "1", "--ckpt-dir",
                          str(tmp_path)])
    assert out["final_step"] == 2
    assert np.isfinite([e["loss"] for e in out["log"]]).all()
