"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` on first use.
Nothing is built when a module is imported: the first launch builds.  The
library lands in ``build/repro_torch/`` under the repository root (listed in
``.gitignore``) under a name that carries the hash of the source and the
flags, so a changed source is rebuilt and an unchanged one is loaded as is.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch")

#: route (b): plain C entry points for sm_90a.  No --use_fast_math (IEEE
#: sqrtf), and no fused multiply-add, so the wavefront's float modes round
#: as the plain torch version and the numpy host wavefront do.  ``-Xptxas
#: -v`` reports registers, shared memory and spills into the build log.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

#: sources held to their plain version by a tolerance, not bit-equality:
#: they may fuse multiply-adds (``--fmad=false`` halves the f32 rate)
FMA_SOURCES = frozenset({"pairwise_l2"})


def flags(name: str) -> List[str]:
    """The nvcc flags ``csrc/<name>.cu`` is built with."""
    if name in FMA_SOURCES:
        return [f for f in NVCC_FLAGS if f != "--fmad=false"]
    return list(NVCC_FLAGS)


@dataclasses.dataclass
class BuildInfo:
    """How a kernel library was obtained in this process."""
    path: pathlib.Path
    seconds: float      # nvcc wall-clock (0.0 when an existing build loaded)
    built: bool         # False: an up-to-date library was already on disk
    log: str            # nvcc's output (ptxas register/smem report)


_LOADED: Dict[str, ctypes.CDLL] = {}
#: per-source build record of this process (read by chip_smoke.py)
BUILDS: Dict[str, BuildInfo] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the
    ``PATH``, or the toolkit's default location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from source on first use")


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    nvcc_flags = flags(name)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(nvcc_flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{digest}.so"
    if so.exists():
        info = BuildInfo(so, 0.0, False, "")
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *nvcc_flags, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build never sees a stub
        info = BuildInfo(so, seconds, True, proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    _LOADED[name] = lib
    BUILDS[name] = info
    return lib
