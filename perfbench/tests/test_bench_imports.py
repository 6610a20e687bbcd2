"""No run may load JAX or the JAX package ``repro``: module names are
compared by their top-level part, whole, so ``repro_torch`` passes."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from perfbench import harness

REPO = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("mods, bad", [
    ({"repro_torch", "repro_torch.core", "numpy"}, []),
    ({"repro"}, ["repro"]), ({"repro.core.refnet"}, ["repro.core.refnet"]),
    ({"jax"}, ["jax"]), ({"jaxlib.xla_client"}, ["jaxlib.xla_client"]),
    ({"flax.linen"}, ["flax.linen"]), ({"jaxtyping", "reprozip"}, []),
])
def test_forbidden_by_top_level_name(mods, bad):
    assert harness.forbidden_modules(mods) == bad


def test_a_runs_modules_load_no_jax():
    """A fresh interpreter that loads what a run loads (harness, every
    driver, reference, dataset and metric reader, and the program's
    modules a run drives) holds no forbidden module."""
    code = (
        "import sys\n"
        "from perfbench import harness, control, trace\n"
        "spec = harness.load_spec()\n"
        "for w in spec['workloads']:\n"
        "    run = harness.make_run(w['name'], 1, 1.0, True, device='cpu',\n"
        "        overrides={'config': {'windows': 40}})\n"
        "import repro_torch.retrieval, repro_torch.core.distributed\n"
        "import repro_torch.kernels.wavefront, repro_torch.launch.elastic\n"
        "bad = harness.forbidden_modules()\n"
        "assert not bad, bad\n"
        "assert 'repro_torch' in sys.modules\n")
    env = {**os.environ, "PYTHONPATH": f"{REPO / 'src'}:{REPO}"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _run(cwd, env):
    return subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "protein-lev.batch", "--seed", "1", "--seconds", "1"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints nothing
    on standard output; it does not fall back to the CPU."""
    proc = _run(REPO, {**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_program_no_result(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the files
    under ``paths``, the command exits non-zero and prints nothing."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run(tmp_path, env)
    assert proc.returncode != 0 and proc.stdout == ""
