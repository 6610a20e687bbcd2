"""The benchmark's own CPU tests (``python -m pytest perfbench/tests``):
the program's sources and the repository root on the path."""

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# the CPU rehearsals run the kernel's plain version on small tensors,
# which one thread runs faster than a pool
torch.set_num_threads(1)
