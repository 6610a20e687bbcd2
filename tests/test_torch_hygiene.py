"""Hygiene of the PyTorch/CUDA port: it imports neither JAX nor the JAX
package ``repro``, and it never falls back from the card to the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
#: the port's examples, one beside each of ``repro``'s
EXAMPLES = sorted((REPO / "examples").glob("*_torch.py"))


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_port_imports_no_jax_and_no_reference_package():
    """Every module imports in a fresh interpreter without pulling in JAX
    or ``repro``, and importing builds no kernel."""
    mods = list(_modules())
    assert "repro_torch.kernels.wavefront" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import build\n"
        "assert not build.BUILDS, 'importing built a kernel'\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"] + EXAMPLES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_and_no_reference_package(path):
    for mod in _imports(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_default_config_build_raises_without_cuda(no_cuda):
    from repro_torch.data.synthetic import protein_sequences
    from repro_torch.retrieval import RetrievalConfig, Retriever
    cfg = RetrievalConfig("levenshtein", lam=16)
    assert cfg.device == "cuda" and cfg.backend == "kernel"
    with pytest.raises(RuntimeError, match="cuda"):
        Retriever.build(cfg, protein_sequences(2, 64, seed=0))


def test_cuda_requests_raise_rather_than_fall_back(no_cuda):
    from repro_torch.core.counter import CountedDistance
    from repro_torch.distances import get
    from repro_torch.kernels import dispatch, registry
    xs = np.zeros((3, 5), np.int32)
    with pytest.raises(RuntimeError, match="cuda"):
        registry.get("levenshtein").batch(xs, xs)          # default: card
    with pytest.raises(RuntimeError, match="cuda"):
        registry.get("levenshtein").batch(xs, xs, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        dispatch.packed_batch("levenshtein", xs, xs, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        CountedDistance(get("levenshtein"), xs)
    with pytest.raises(RuntimeError, match="cuda"):
        get("dtw").batch(np.zeros((2, 4, 1), np.float32),
                         np.zeros((2, 4, 1), np.float32))


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_default_device_raises_without_cuda(no_cuda, path,
                                                    monkeypatch, capsys):
    """Each example runs on the card by default: without one, ``main([])``
    raises naming ``cuda`` before it prints a result line or trains."""
    import runpy
    from repro_torch.train import trainer

    def no_training(*args, **kw):
        raise AssertionError("trained without a device")

    monkeypatch.setattr(trainer.Trainer, "run", no_training)
    main = runpy.run_path(str(path), run_name="example")["main"]
    with pytest.raises(RuntimeError, match="cuda"):
        main([])
    assert capsys.readouterr().out == ""
