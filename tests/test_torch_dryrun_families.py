"""The dry-run's partitioned step for the MoE, SSM and hybrid families on
the CPU (``tests/test_torch_dryrun_sharded.py`` has the dense family and
the hand count): deepseek-v2-236b (the expert-parallel MoE block, the
latent caches), mamba2-370m (the SSM blocks' local regions) and
zamba2-1.2b (both, and the shared block's KV caches) at ``reduced()``,
cut in depth, batch 32, on a ``fake`` group of each production mesh's
world size.  Each family's training, prefill and decode step runs on one
mesh and one step on the other; every step sends something, and its
counted flops per rank are at least the even split of the unpartitioned
step's.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as specs_lib  # noqa: E402
from repro_torch.launch.mesh import MESHES  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.roofline import costs  # noqa: E402

B, S = 32, 64
FAMILIES = {"deepseek-v2-236b": 2, "mamba2-370m": 2, "zamba2-1.2b": 3}
CELLS = [(a, k, "pod16x16") for a in FAMILIES
         for k in ("train", "prefill", "decode")] + [
    ("deepseek-v2-236b", "decode", "pod2x16x16"),
    ("mamba2-370m", "train", "pod2x16x16"),
    ("zamba2-1.2b", "prefill", "pod2x16x16")]


def _cut(kind):
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    return dataclasses.replace(SHAPES[name], global_batch=B,
                               seq_len=S if kind != "decode" else 128)


@pytest.mark.parametrize("arch,kind,mesh_name", CELLS)
def test_partitioned_step_runs(arch, kind, mesh_name):
    n_layers = FAMILIES[arch]
    shape = _cut(kind)
    rec = dryrun.partitioned(arch, shape, mesh_name, reduced=True,
                             n_layers=n_layers)
    coll = rec["collectives"]
    assert coll["total_bytes"] > 0
    assert coll["total_bytes"] == sum(coll[k] for k in costs.COLLECTIVES)
    # the unpartitioned step on meta, the same cut
    cfg, mod = registry.get(arch, reduced=True)
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dtype = getattr(torch, cfg.param_dtype)
    net = specs_lib.abstract_model(cfg, dtype, train=kind == "train")
    inputs = dryrun.abstract_inputs(cfg, mod, shape, net, dtype)
    flops, _ = costs.count_flops(dryrun.step_fn(cfg, mod, kind), net, inputs)
    n = MESHES[mesh_name].n_devices
    assert rec["flops_per_device"] >= flops / n > 0
