"""Time the wavefront kernel's row schedule at each choice of register widths.

``csrc/wavefront.cu`` compiles its one-thread-per-row schedule once per
register width ``ROW_WIDTH_STEP, 2 ROW_WIDTH_STEP, ..., 32`` and mode.  This
script builds the source at ``ROW_WIDTH_STEP`` = 8, 16 and 32 (4, 2 and 1
instances a mode; one ``nvcc`` each, all at once), checks that every build
gives the shipped library's outputs bit for bit, and times each at the
shapes of ``chip_smoke.py``'s ``[timing]`` lines plus two shorter rows.
Each shape is timed in the order 8, 16, 32 and again in the reverse order,
and the faster of the two times is kept.  Needs an NVIDIA GPU and nvcc:

    python3 tools/wavefront_widths.py

Prints one ``[widths]`` line per shape and build, the nvcc seconds and the
ptxas registers of every instance.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = (8, 16, 32)

#: (mode, rows, len_x range, len_y range, d, what): chip_smoke.py's timing
#: shapes, with the main path's rows per dispatch at its defaults (20,000
#: windows at lam=40), and two shapes whose rows are narrower
SHAPES = [
    ("lev", 111502, (20, 20), (20, 20), 1, "main path mean (build)"),
    ("lev", 1524992, (20, 20), (20, 20), 1, "main path largest (build)"),
    ("lev", 1767472, (18, 22), (20, 20), 1, "main path largest (step 4)"),
    ("lev", 1 << 20, (18, 22), (20, 20), 1, "1,048,576 rows"),
    ("erp", 1 << 18, (20, 20), (20, 20), 2, "262,144 rows"),
    ("lev", 1 << 20, (10, 14), (12, 12), 1, "narrower: 14 x 12"),
    ("lev", 1 << 20, (5, 7), (6, 6), 1, "narrower: 7 x 6"),
]


def build_step(build, step: int):
    """(library, nvcc seconds, ptxas log) of csrc/wavefront.cu built with
    ``ROW_WIDTH_STEP = step``."""
    src = (build.CSRC / "wavefront.cu").read_text()
    src, n = re.subn(r"constexpr int ROW_WIDTH_STEP = \d+;",
                     f"constexpr int ROW_WIDTH_STEP = {step};", src)
    if n != 1:
        raise RuntimeError("ROW_WIDTH_STEP not found once in wavefront.cu")
    out = build.BUILD_DIR / "widths"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"wavefront_step{step}.cu"
    cu.write_text(src)
    so = out / f"wavefront_step{step}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([build.nvcc(), *build.flags("wavefront"), "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed at step {step}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.wavefront_launch.restype = ctypes.c_int
    lib.wavefront_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                     + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return lib, seconds, proc.stdout + proc.stderr


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("wavefront_widths: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import wavefront as wf

    print(cs.smi(), flush=True)
    with ThreadPoolExecutor(len(STEPS)) as pool:
        built = dict(zip(STEPS, pool.map(lambda s: build_step(build, s),
                                         STEPS)))
    for step, (_, seconds, log) in built.items():
        regs = []
        entry = ""
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                entry = cs.kernel_name(ln)
            elif "Used" in ln and entry.startswith("row"):
                n = re.search(r"(\d+) registers", ln).group(1)
                regs.append(f"{entry}:{n}")
                entry = ""
        print(f"[widths-build] step={step} nvcc_s={seconds:.2f} "
              f"registers={','.join(regs)}", flush=True)

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    for mode, B, lxr, lyr, d, what in SHAPES:
        xs, ys, lx, ly = cs.make_rows(rng, mode, B, lxr, lyr, d)
        ops = cs.operands(mode, xs, ys, lx, ly, dev)
        eps = torch.full((B,), float("inf"), device=dev)
        Lx, Ly = ops[0].shape[1], ops[1].shape[1]
        want = wf.wavefront_cuda(*ops, eps, mode=mode)
        outs = (torch.empty(B, device=dev),
                torch.empty(B, dtype=torch.bool, device=dev),
                torch.empty(B, dtype=torch.bool, device=dev))

        def launch(lib):
            rc = lib.wavefront_launch(
                wf.MODE_IDS[mode], *(t.data_ptr() for t in ops),
                eps.data_ptr(), *(t.data_ptr() for t in outs), B, Lx, Ly, d,
                0, stream)
            if rc:
                raise RuntimeError(f"launch failed ({rc})")

        ms = {}
        for order in (STEPS, STEPS[::-1]):
            for step in order:
                lib = built[step][0]
                launch(lib)
                torch.cuda.synchronize()
                for got, w in zip(outs, want):
                    if not torch.equal(got, w):
                        raise AssertionError(f"step {step}: outputs differ "
                                             f"from the shipped kernel's")
                t = cs.time_ms(torch, lambda: launch(lib))
                ms[step] = min(ms.get(step, t), t)
        for step in STEPS:
            print(f"[widths] mode={mode} rows={B} shape={Lx}x{Ly}x{d} "
                  f"what={what!r} step={step} ms={ms[step]:.4f} "
                  f"vs_step8={ms[step] / ms[8]:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
