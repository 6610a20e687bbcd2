#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card, exits 0 on success

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc/``
(``wavefront.cu``, ``pairwise_l2.cu``, ``ring_filter.cu``) with ``nvcc``
for ``sm_90a``, one ``nvcc`` per source started together, and holds each
against its plain torch version on the card.  Then it drives the port's two
paths:

* the paper's five-step subsequence query through ``repro_torch.retrieval``,
  checked against the port's numpy host backend and run at full size with
  the wavefront kernel's launch count held to the counted dispatches;
* embedding retrieval over smollm-360m hidden states at the model's full
  widths (random weights from a seed): pooled windows indexed by the
  ``embedding`` index kind, range and nearest queries, then the exact
  all-pairs matrix of the probes against the database through
  ``ops.pairwise_l2`` (the index itself launches no pairwise kernel, which
  is checked); the range hits are held against that matrix and, at a cut
  size, hits and counts against the numpy backend;
* the elastic fleet (``execution="fleet"``): at a cut size (phase 7) its
  round-based, host-loop and one-shot paths against brute force and the
  numpy backend, and the envelope cascade on and off (the device envelope
  tier and the one-shot stage's bounds against the host's); at cell A's
  window size (phase 8, ``--windows-fleet``) the build, rounds and
  one-shot queries, a dead worker and a 4 -> 5 -> 4 resize held to 2/N of
  the build's evaluations; the one-shot query's ring filter on that merged
  fleet's own ``dp`` (64 queries): both passes through the kernel and the
  plain version on the same card operands, held equal byte for byte, then
  timed beside its bound;
* the continuous-batching serve engine on that fleet (phase 9): a seeded
  virtual-clock schedule against the sequential rounds oracle, wall-clock
  serving across a background snapshot-swap resize, and the serve CLI.
* the paper's comparison indexes (phase 10): ``benchmarks/bench_query.py``'s
  PROTEINS/Levenshtein and TRAJ/ERP sweeps over the reference net, its
  tighter variants, the cover tree and MV reference indexing, at the
  bench's check size held to ``BENCH_query.json`` row by row, and at its
  full size held to the numpy backend (evaluated by worker processes
  meanwhile), with each index's build seconds, space and evaluation
  fraction; the cover tree also flattened and queried on the card;
* the training half (phase 11): ``repro_torch.launch.train`` for
  smollm-360m at its published widths in f32 with ``--dedup`` (the
  retrieval stack as a data filter, through the wavefront kernel), the
  same run stopped by an injected failure and resumed, and the example's
  tail: the trained network's windows indexed and a near-duplicate probed;
* the LM stack's decode path (phase 12): qwen3-4b whole at its published
  widths and deepseek-v2-236b at its published widths cut to a few layers
  (random weights from a seed), prefill caches and ``decode_step`` held to
  the full forward in f32 (one step, and for qwen3-4b eight greedy steps
  against the forward's argmax), then prefill and decode timed in bf16
  against the decode step's memory bound, with peak memory, the card's
  busy time in one traced step and, for the MoE model, the share of
  routed assignments the capacity dispatch drops (every dispatch's kept
  set held to a token-major oracle in plain Python, beside the router's
  per-expert load and the correlation of its logits across tokens);
* the SSM families (phase 13): mamba2-370m and zamba2-1.2b whole at their
  published widths (random weights from a seed), decode after a one-chunk
  and a three-chunk prefill held to the forward in f32 (one step, eight
  greedy steps), bf16 serving timed against the step's byte bound with
  the scan's share of a traced step and prefill, the ``long_500k`` decode
  shape (batch 1) at three cache lengths from seeded caches (the new keys
  read back at their position), training in f32 (mamba2 through the train
  CLI, zamba2 through its ``Trainer``: finite gradients, a falling loss),
  and mamba2's embedding path: its pooled hidden states (``d = 1024``)
  indexed, range hits held to the exact ``pairwise_l2`` matrix (one
  launch, counted from zero) and, at a cut size, to the numpy backend;
* the tooling (phase 14): three cells one card holds, smollm-360m
  ``train_4k`` (batch 2, f32), qwen3-4b ``decode_32k`` (batch 4, a seeded
  cache of 32,768 positions) and mamba2-370m ``long_500k``, each run for
  one timed step at the shape of its ``launch/dryrun`` record (counted on
  ``meta`` by a worker process while phases 12-13 run): the flops counted
  on the card equal to the record's, the peak memory at least its
  argument bytes, with the roofline terms and MFU of
  ``roofline/report``.  Both kernels' bounds in the timing lines come
  from ``repro_torch.roofline.costs``;
* the four examples (phase 16): ``examples/*_torch.py`` through their
  ``main`` with ``--device cuda``, each one's printed lines held to its
  ``--device cpu`` run (computed by worker processes during phases
  12-15) by :func:`printed_lines_differ`, the wavefront's launches to the
  counted dispatches; the LM example also from the CPU run's
  initialisation, its counts held to brute force and the numpy backend.

Every float distance the card computes (the wavefront kernel's DTW, ERP
and Frechet, the elementwise Euclidean, the envelope bounds) is held bit
for bit to the numpy host lane at feature widths 1 to 300 (phase 3d), so a
range query whose ε sits one ulp under a distance answers as numpy does.

Levenshtein token ids over all of int32 (``2**24`` and up, where f32
rounds ids together) are held to the numpy backend through the counter
on the card, and the kernel to its plain version on ids whose bit
patterns include NaNs as floats (phase 4b).

The wavefront kernel takes each dispatch's rows as they are (the run fails
if the reference's padded layout is built on the card path), and the
pairwise kernel runs its products as 3xTF32 on the tensor cores, held to
the plain version within a derived bound.  Every path is driven with the
launch counts zeroed just before it, and its launches are held to what it
must launch: one per counted dispatch or merged round, one plus at most
one per one-shot fleet query, whose ring filter launches once and its
pass 2 once when a survivor is left.  The kernels are timed at their
paths' shapes, with their registers, shared memory and spills.  Each phase
prints one line; any failure raises and the script exits non-zero.  The
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Imports nothing of JAX and nothing of the JAX package ``repro``.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: tolerance of the kernel against its plain version (float modes): the
#: two share every operation and its order, so differences are at most a
#: few ulps (the plain version's f32 ops run as separate CUDA kernels)
RTOL = ATOL = 1e-5

#: the kernel's template mode ids (csrc/wavefront.cu)
MODES = ("dtw", "erp", "dfd", "lev")


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


#: a number as the examples print it (signs stay in the text around it)
_NUMBER = re.compile(r"\d+(?:\.\d+)?")


def _digits(number: str) -> int:
    return len(number.partition(".")[2])


def _lines_close(got: str, want: str, loose: str) -> bool:
    texts = _NUMBER.split(want)
    if _NUMBER.split(got) != texts:
        return False
    for before, a, b in zip(texts, _NUMBER.findall(got),
                            _NUMBER.findall(want)):
        if a == b:
            continue
        if not (loose and "." in b and re.search(f"(?:{loose})$", before)
                and _digits(a) == _digits(b)):
            return False
        if round(abs(float(a) - float(b)) * 10 ** _digits(b)) > 1:
            return False
    return True


def printed_lines_differ(got: str, want: str, loose: str = "") -> list:
    """The line pairs where an example's printed output ``got`` differs from
    its reference run's ``want`` (empty: they match).  Every character must
    be equal, numbers included, except a number with a decimal point right
    after text that the regex ``loose`` matches at its end (the distances
    and losses): it may differ by one unit in its last printed digit."""
    g_lines, w_lines = got.splitlines(), want.splitlines()
    if len(g_lines) != len(w_lines):
        return [(f"{len(g_lines)} lines", f"{len(w_lines)} lines")]
    return [(g, w) for g, w in zip(g_lines, w_lines)
            if g != w and not _lines_close(g, w, loose)]


# -- phase 1/2: facts and build ---------------------------------------------

def phase_facts(torch, build) -> dict:
    t0 = time.perf_counter()
    nv = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()[-1]
    facts = dict(torch=torch.__version__, cuda=torch.version.cuda,
                 device=torch.cuda.get_device_name(0),
                 capability=torch.cuda.get_device_capability(0),
                 count=torch.cuda.device_count(), nvcc=nv, smi=smi())
    log("facts", **{k: repr(v) for k, v in facts.items()},
        s=f"{time.perf_counter() - t0:.2f}")
    return facts


KERNEL_SOURCES = ("wavefront", "pairwise_l2", "ring_filter")


def kernel_name(ptxas_line: str) -> str:
    """A short name for a kernel that ptxas names in mangled form:
    ``row<lev,24>``, ``row<erp,32,d>=8>``, ``block<erp>``,
    ``pairwise_l2<wg=2,n=128,tma>``."""
    m = re.search(r"wavefront_row_kernelILi(\d)ELi(\d+)ELb(\d)E",
                  ptxas_line)
    if m:
        wide = ",d>=8" if m.group(3) == "1" else ""
        return f"row<{MODES[int(m.group(1))]},{m.group(2)}{wide}>"
    m = re.search(r"wavefront_block_kernelILi(\d)ELb(\d)E", ptxas_line)
    if m:
        wide = ",d>=8" if m.group(2) == "1" else ""
        return f"block<{MODES[int(m.group(1))]}{wide}>"
    m = re.search(r"pairwise_l2_kernelILi(\d)ELi(\d+)ELb(\d)E", ptxas_line)
    if m:
        return (f"pairwise_l2<wg={m.group(1)},n={m.group(2)},"
                f"{'tma' if m.group(3) == '1' else 'plain'}>")
    m = re.search(r"ring_(verdicts|scan|rows)_kernel(Ij|Ih)?", ptxas_line)
    if m:
        unit = {"Ij": "<word>", "Ih": "<byte>"}.get(m.group(2), "")
        return f"ring_{m.group(1)}{unit}"
    return "?"


def phase_build(build) -> dict:
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(build.load, KERNEL_SOURCES))  # one nvcc each, at once
    wall = time.perf_counter() - t0
    ptxas = {}  # short kernel name -> registers, shared memory, spills
    for name in KERNEL_SOURCES:
        info = build.BUILDS[name]
        log("build", library=info.path.name, built=info.built,
            nvcc_s=f"{info.seconds:.2f}", flags=repr(" ".join(
                build.flags(name))))
        entry, spill = "", ""
        for ln in info.log.splitlines():  # ptxas: registers, smem, spills
            if "Compiling entry" in ln:
                entry = kernel_name(ln)
            elif "spill stores" in ln:
                spill = ln.strip()
            elif "Used" in ln and entry:
                used = ln.split(':', 1)[1].strip()
                ptxas[entry] = f"{used}; {spill}"
                print(f"[build] ptxas {entry}: {used}; {spill}", flush=True)
            elif "C7514" in ln:
                print(f"[build] ptxas warning (wgmma serialized): "
                      f"{kernel_name(ln)}", flush=True)
    log("build-done", s=f"{wall:.2f}")
    return {"seconds": wall, "ptxas": ptxas}


# -- kernel operands ----------------------------------------------------------

def make_rows(rng, mode, B, lx_range, ly_range, d, *, scale=1.0,
              zero_pad=True):
    """Ragged rows: tokens for lev, random-walk series otherwise; past each
    row's lengths zeros (``zero_pad``) or seeded non-zero content."""
    import numpy as np
    lx = rng.integers(lx_range[0], lx_range[1] + 1, B)
    ly = rng.integers(ly_range[0], ly_range[1] + 1, B)
    Lx, Ly = int(lx.max()), int(ly.max())
    if mode == "lev":
        xs = rng.integers(0, 20, size=(B, Lx)).astype(np.int32)
        ys = np.where(rng.random((B, Ly)) < 0.3,
                      rng.integers(0, 20, size=(B, Ly)),
                      np.pad(xs, ((0, 0), (0, max(0, Ly - Lx))))[:, :Ly]
                      ).astype(np.int32)
    else:
        xs = (np.cumsum(rng.normal(scale=0.3, size=(B, Lx, d)), 1)
              * scale).astype(np.float32)
        ys = (xs[:, :1] + np.cumsum(rng.normal(scale=0.3, size=(B, Ly, d)),
                                    1) * scale).astype(np.float32)
    if zero_pad:
        for i in range(B):
            xs[i, lx[i]:] = 0
            ys[i, ly[i]:] = 0
    return xs, ys, lx, ly


def operands(mode, xs, ys, lx, ly, dev):
    """The kernel's operands as a dispatch hands them: the rows as they are
    (tokens as int32 ids, ``wavefront.lev_operand``, or f32
    series ``(B, L, d)``), lengths ``(B, 2)`` int32."""
    import numpy as np
    import torch
    from repro_torch.kernels.wavefront import lev_operand
    lens = torch.as_tensor(np.stack([lx, ly], 1).astype(np.int32),
                           device=dev)
    if mode == "lev":
        return [lev_operand(xs, dev), lev_operand(ys, dev), lens]
    return [torch.as_tensor(xs, device=dev, dtype=torch.float32),
            torch.as_tensor(ys, device=dev, dtype=torch.float32), lens]


# -- phase 3: kernel against its plain version ---------------------------------

def compare(wf, mode, ops, eps):
    import torch
    got = wf.wavefront_cuda(*ops, eps, mode=mode)
    want = wf.wavefront_torch(*ops, eps, mode=mode)
    torch.cuda.synchronize()
    gd, wd = got[0], want[0]
    if not torch.isfinite(gd).all():
        raise AssertionError(f"{mode}: kernel produced inf/NaN")
    if mode == "lev":
        if not torch.equal(gd, wd):
            raise AssertionError(f"lev: dist not bit-equal "
                                 f"({int((gd != wd).sum())} rows)")
    elif not torch.allclose(gd, wd, rtol=RTOL, atol=ATOL):
        raise AssertionError(
            f"{mode}: dist off by {float((gd - wd).abs().max())}")
    for k, name in ((1, "hit"), (2, "pruned")):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(
                f"{mode}: {name} differs on {int((got[k] != want[k]).sum())}"
                " rows")
    # the fused verdict never contradicts the exact value
    if bool((got[2] & got[1]).any()):
        raise AssertionError(f"{mode}: a pruned row is a hit")
    return float((gd - wd).abs().max()), got


def compare_mix(wf, mode, ops):
    """:func:`compare` at +inf, then at an ε mix: +inf rows, finite rows,
    rows whose ε IS their distance.  (largest |kernel - plain|, the +inf
    outputs, the mix's outputs)."""
    import torch
    B = ops[0].shape[0]
    inf = torch.full((B,), float("inf"), device=ops[0].device)
    err, exact = compare(wf, mode, ops, inf)
    dist = exact[0]
    eps = torch.quantile(dist, 0.4).expand(B).clone()
    eps[0::3] = float("inf")
    eps[1::3] = dist[1::3]
    err2, got = compare(wf, mode, ops, eps)
    return max(err, err2), exact, got


def phase_kernel_parity(torch, wf, rng, dev) -> float:
    import numpy as np
    t0 = time.perf_counter()
    cases = []
    for mode in ("dtw", "erp", "dfd", "lev"):
        for d in ((1,) if mode == "lev" else (1, 2, 3)):
            cases.append((mode, 300, (1, 13), (1, 9), d, 1.0, True))  # Lx!=Ly
            cases.append((mode, 200, (5, 22), (20, 20), d, 1.0, True))  # main
    for mode in ("dtw", "erp", "dfd", "lev"):
        cases.append((mode, 64, (60, 100), (40, 90), 2 if mode != "lev"
                      else 1, 1.0, True))                # past one warp
    cases.append(("erp", 4, (1000, 1100), (900, 1000), 3, 1.0, True))
    cases.append(("lev", 4, (1050, 1100), (1000, 1100), 1, 1.0, True))
    # overflow: long, high-gap-mass rows that saturate at BIG
    cases.append(("erp", 16, (40, 48), (40, 48), 1, 1e25, True))
    cases.append(("dtw", 16, (24, 32), (24, 32), 1, 3e24, True))
    # seeded non-zero content past the lengths: the padding cells' costs
    # feed the certificate, one schedule each (one thread or one warp a row)
    for mode in ("dtw", "erp", "dfd", "lev"):
        d = 1 if mode == "lev" else 2
        cases.append((mode, 300, (5, 22), (18, 20), d, 1.0, False))
        cases.append((mode, 32, (40, 70), (30, 60), d, 1.0, False))
    worst = 0.0
    pruned_pad = 0
    for mode, B, lxr, lyr, d, scale, zero_pad in cases:
        if scale > 1.0:  # constant huge rows of opposite signs
            xs = np.full((B, lxr[1], d), scale, np.float32)
            ys = -np.full((B, lyr[1], d), scale, np.float32)
            lx = rng.integers(lxr[0], lxr[1] + 1, B)
            ly = rng.integers(lyr[0], lyr[1] + 1, B)
        else:
            xs, ys, lx, ly = make_rows(rng, mode, B, lxr, lyr, d,
                                       zero_pad=zero_pad)
        ops = operands(mode, xs, ys, lx, ly, dev)
        err, exact, got = compare_mix(wf, mode, ops)
        worst = max(worst, err)
        if not zero_pad:
            pruned_pad += int(got[2].sum())
        if scale > 1.0 and not bool((exact[0] >= 3e37).all()):
            raise AssertionError(f"{mode}: overflow rows did not saturate")
    root_bad = wf.root_mismatches(dev)  # every non-negative f32
    if root_bad:
        raise AssertionError(f"block schedule root differs from sqrtf on "
                             f"{root_bad} inputs")
    log("kernel-vs-plain", cases=len(cases), nonzero_padding_cases=8,
        root_mismatches=root_bad,
        pruned_rows_there=pruned_pad, max_abs_err=worst,
        tol=f"lev bit-equal; float rtol=atol={RTOL}; hit/pruned equal",
        s=f"{time.perf_counter() - t0:.2f}")
    return worst


# -- phase 3d: float distances bit-equal to the numpy lane -------------------

#: feature widths of the numpy-order check: left to right below 8, eight
#: running sums up to 128, numpy's halving above
NUMPY_DS = (1, 2, 3, 7, 8, 9, 16, 60, 130, 300)

#: the Frechet range query of ``tests/test_torch_numpy_order.py``: numpy's
#: distance of query 1 to window 23 is one ulp above this ε
FRECHET_EPS, FRECHET_WINDOW = 6.4009246826171875, 23


def phase_numpy_parity(torch, wf, dev) -> float:
    """Phase 3d: the float distances the port computes on the card, held
    bit for bit to the reference's numpy lane (the port's copies
    ``distances/np_backend.py`` and ``distances/bounds.py``): the CUDA
    wavefront kernel for DTW, ERP and Frechet at every width of
    ``NUMPY_DS`` in both schedules (rows of up to 13 x 9 and of 33-40 x
    30-36), with ε at each row's distance a hit and one ulp under it a
    miss; the ``kernel`` backend's elementwise Euclidean; the ``lb:``
    envelope specs; the one-shot query's bound; ``sqrt_rn`` on 2**20
    values (the card's own f32 ``torch.sqrt`` only counted).  Then the
    Frechet range query at ``FRECHET_EPS`` on the card, where window 23
    must miss for query 1 as it does in numpy.  Returns the largest
    ``|card - numpy|``, which must be 0.0 (it raises otherwise)."""
    import numpy as np
    from repro_torch.core.distributed import _envelope_rows
    from repro_torch.data.synthetic import trajectories
    from repro_torch.distances import bounds, np_backend
    from repro_torch.distances._wavefront import sqrt_rn
    from repro_torch.kernels import registry
    from repro_torch.retrieval import RetrievalConfig, Retriever
    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    worst = {}

    def check(what, got, want):
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        err = float(np.abs(got.astype(np.float64) - want).max())
        worst[what] = max(worst.get(what, 0.0), err)
        if not np.array_equal(got, want):
            raise AssertionError(
                f"numpy parity: {what} differs in "
                f"{int((got != want).sum())} of {got.size} values (max "
                f"{err})")

    def card(a):
        return torch.as_tensor(a, device=dev)

    cases = 0
    for mode in ("dtw", "erp", "dfd"):
        for d in NUMPY_DS:
            for B, lxr, lyr in ((96, (1, 13), (1, 9)),
                                (6, (33, 40), (30, 36))):
                xs, ys, lx, ly = make_rows(rng, mode, B, lxr, lyr, d,
                                           zero_pad=False)
                ops = operands(mode, xs, ys, lx, ly, dev)
                want = np_backend.batch_alignment(xs, ys, mode, lx, ly)
                inf = torch.full((B,), float("inf"), device=dev)
                check(f"wavefront {mode}", wf.wavefront_cuda(
                    *ops, inf, mode=mode)[0], want)
                at = wf.wavefront_cuda(*ops, card(want), mode=mode)
                under = wf.wavefront_cuda(
                    *ops, card(np.nextafter(want, -np.inf)), mode=mode)
                if not bool(at[1].all()) or bool(under[1].any()):
                    raise AssertionError(
                        f"numpy parity: {mode} d={d}: a row at its own "
                        "distance misses, or one an ulp under it hits")
                cases += 1
    for d in (1, 8, 60):
        for L in (9, 300):
            xs = rng.normal(size=(64, L, d)).astype(np.float32)
            ys = rng.normal(size=(64, L, d)).astype(np.float32)
            lx = rng.integers(1, L + 1, 64)
            lx[0] = L
            check("euclidean", registry.get("euclidean").batch(
                xs, ys, lx, lx, device=dev).dist,
                np_backend.batch_euclidean(xs, ys, lx))
            cases += 1
    for name, bound in (("dtw", bounds.lb_dtw_envelope),
                        ("erp", bounds.lb_erp_envelope),
                        ("frechet", bounds.lb_frechet_envelope)):
        for d in NUMPY_DS:
            xs, ys, lx, ly = make_rows(rng, "erp", 64, (1, 13), (1, 9), d,
                                       zero_pad=False)
            check(f"lb:{name}", registry.get_envelope(name).batch(
                xs, ys, lx, ly, device=dev).dist,
                bound(xs, ys, lx, ly))
            env = bounds.build_envelopes(ys, ly)
            check("one-shot bound", _envelope_rows(
                name, card(xs), card(lx), card(env.lo), card(env.hi),
                card(env.mass)), bounds.lb_envelope_rows(
                    name, xs, lx, env.lo, env.hi, env.mass))
            cases += 2
    # the range query whose ε sits one ulp under a distance
    data = trajectories(160, seed=0)
    qrng = np.random.default_rng(2)
    qs = data[qrng.integers(0, len(data), 4)].copy()
    qs = qs + qrng.normal(scale=0.1 * np.std(data),
                          size=qs.shape).astype(qs.dtype)
    d23 = np_backend.batch_alignment(
        qs[1:2], data[FRECHET_WINDOW:FRECHET_WINDOW + 1], "dfd")[0]
    if not d23 == np.nextafter(np.float32(FRECHET_EPS), np.inf):
        raise AssertionError(f"numpy parity: the Frechet case moved "
                             f"(numpy's distance {d23!r})")
    got = Retriever.build(RetrievalConfig(
        "frechet", index="linear", device=str(dev)), data).batch(
        qs).range(FRECHET_EPS)
    want = Retriever.build(RetrievalConfig(
        "frechet", index="linear", backend="numpy", device=str(dev)),
        data).batch(qs).range(FRECHET_EPS)
    if FRECHET_WINDOW in got.hits[1] or got.hits != want.hits \
            or got.stats != want.stats:
        raise AssertionError("numpy parity: the Frechet range query at an "
                             "ulp under a distance differs from numpy")
    # the correctly rounded root, and what the card's own f32 root does
    v = (rng.random(1 << 20) * rng.choice(
        [1e-6, 1e-3, 1.0, 1e3, 1e6, 1e30], 1 << 20)).astype(np.float32)
    check("sqrt_rn", sqrt_rn(card(v)), np.sqrt(v))
    own = int((torch.sqrt(card(v)).cpu().numpy() != np.sqrt(v)).sum())
    err = max(worst.values())
    log("numpy-parity", cases=cases, widths=repr(NUMPY_DS),
        max_abs_err=err, **{k.replace(" ", "_").replace(":", "_"): v
                            for k, v in worst.items()},
        frechet_window23="miss", frechet_hits=sum(map(len, got.hits)),
        torch_sqrt_f32_mismatches=f"{own} of {v.size}",
        tol="bit-equal", s=f"{time.perf_counter() - t0:.2f}")
    return err


# -- phase 4: main-path parity against the numpy host backend -----------------

def planted_query(rng, seqs, n_q=80):
    import numpy as np
    Q = rng.integers(0, 20, size=(n_q,)).astype(np.int32)
    Q[20:60] = seqs[3][100:140]
    Q[31] = (Q[31] + 1) % 20
    Q[48] = (Q[48] + 7) % 20
    return Q


def phase_main_parity(torch, wf, rng, dev) -> None:
    import numpy as np
    from repro_torch.data.synthetic import protein_sequences, trajectories
    from repro_torch.retrieval import RetrievalConfig, Retriever
    t0 = time.perf_counter()
    seqs = protein_sequences(20, 400, n_motifs=160, seed=1)
    Q = planted_query(rng, seqs)
    out = {}
    for be in ("numpy", "kernel"):
        cfg = RetrievalConfig("levenshtein", lam=16, lambda0=1,
                              index="refnet", tight_bounds=True, num_max=5,
                              backend=be, device=str(dev))
        r = Retriever.build(cfg, seqs)
        res = [r.query(Q).range(2.0), r.query(Q).longest(2.0),
               r.query(Q).nearest(10.0)]
        out[be] = ([[m for m in rs.hits] for rs in res],
                   [rs.stats for rs in res], len(r.meta))
    (hn, sn, nw), (hk, sk, _) = out["numpy"], out["kernel"]
    if hn != hk:
        raise AssertionError("quickstart: MatchPairs differ kernel vs numpy")
    if sn != sk:
        raise AssertionError(f"quickstart: counts differ {sk} vs {sn}")
    if not hk[1] or hk[1][0].q_len < 30:
        raise AssertionError("quickstart: planted match not found")
    log("main-parity-lev", windows=nw, range_pairs=len(hk[0]),
        longest_q_len=hk[1][0].q_len, nearest_d=hk[2][0].distance,
        stats=json.dumps(sk[0]), s=f"{time.perf_counter() - t0:.2f}")

    t0 = time.perf_counter()
    data = trajectories(1500, 20, seed=3)
    qrng = np.random.default_rng(4)
    pick = qrng.choice(len(data), 24, replace=False)
    queries = [(data[i][:ln] + qrng.normal(scale=0.05, size=(ln, 2))
                ).astype(np.float32)
               for i, ln in zip(pick, qrng.integers(16, 21, len(pick)))]
    got = {}
    for be in ("numpy", "kernel"):
        cfg = RetrievalConfig("erp", index="refnet", tight_bounds=True,
                              num_max=5, eps_prime=2.0, backend=be,
                              device=str(dev))
        r = Retriever.build(cfg, data)
        rs = r.batch(queries).range(20.0)
        got[be] = (rs.hits, rs.stats)
    if got["numpy"][0] != got["kernel"][0]:
        raise AssertionError("erp window-level: hit ids differ")
    if got["numpy"][1] != got["kernel"][1]:
        raise AssertionError(
            f"erp counts differ {got['kernel'][1]} vs {got['numpy'][1]}")
    log("main-parity-erp", windows=len(data), queries=len(queries),
        hits=sum(len(h) for h in got["kernel"][0]),
        stats=json.dumps(got["kernel"][1]),
        s=f"{time.perf_counter() - t0:.2f}")


# -- phase 4b: Levenshtein token ids of the whole int32 range -----------------

def phase_lev_ids(torch, wf, dev) -> int:
    """Token ids that f32 rounds together (``2**24`` and up, near
    ``2**31 - 1``) through the counter's default backend on the card, held
    to the numpy backend (4.0 for four distinct pairs), and the kernel
    bit-equal to its plain version on ids drawn from all of int32 (some
    bit patterns are NaNs as floats).  Returns the launches of the counter
    cases (one each)."""
    import numpy as np
    from repro_torch.core.counter import CountedDistance
    from repro_torch.distances import get
    t0 = time.perf_counter()
    lev = get("levenshtein")
    wf.LAUNCHES = 0
    got = []
    for base in (1 << 24, (1 << 31) - 8):
        x = np.array([base + 2 * i for i in range(4)], np.int64)
        data = np.stack([x, x + 1])
        d_card = CountedDistance(lev, data, device=dev).eval(x, [1])[0]
        d_host = CountedDistance(lev, data, backend="numpy").eval(x, [1])[0]
        if not float(d_card) == float(d_host) == 4.0:
            raise AssertionError(f"levenshtein ids from {base}: card "
                                 f"{d_card}, numpy {d_host}, expected 4")
        got.append(float(d_card))
    launches = wf.LAUNCHES
    if launches != 2:
        raise AssertionError(f"lev ids: {launches} launches for 2 counted "
                             "dispatches")
    rng = np.random.default_rng(24)
    B, L = 4096, 20
    ids = rng.integers(-(1 << 31), 1 << 31, size=(B, L), dtype=np.int64)
    ys = np.where(rng.random((B, L)) < 0.6, ids, ids ^ 1)
    lx = rng.integers(1, L + 1, B)
    ly = rng.integers(1, L + 1, B)
    lx[0] = ly[0] = L
    ops = operands("lev", ids, ys, lx, ly, dev)
    nans = int(torch.isnan(ops[0].view(torch.float32)).sum())
    eps = torch.full((B,), 8.0, device=dev)
    compare(wf, "lev", ops, eps)
    log("lev-ids", counter_dist=got, numpy_dist=4.0, launches=launches,
        wide_rows=B, nan_bit_patterns=nans, wide="bit-equal",
        s=f"{time.perf_counter() - t0:.2f}")
    return launches


# -- phase 5: full-size main path on the card ---------------------------------

class Timed:
    """Host seconds vs kernel seconds of a run: wraps the wavefront wrapper
    with CUDA events (the events are recorded around each launch and read
    once at the end, so timing adds no synchronisation).  Also counts calls
    of ``wavefront.padded_layout``, the reference's padded operand layout,
    which only the plain version builds: on the card path it must run 0
    times."""

    def __init__(self, torch, wf):
        self.torch, self.wf = torch, wf
        self.events = []
        self.rows = []
        self.layouts = 0

    def __enter__(self):
        self._orig = self.wf.wavefront_cuda
        self._orig_layout = self.wf.padded_layout
        torch, events, rows = self.torch, self.events, self.rows

        def counted_layout(*args, **kw):
            self.layouts += 1
            return self._orig_layout(*args, **kw)

        self.wf.padded_layout = counted_layout

        def timed(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = self._orig(*args, **kw)
            b.record()
            events.append((a, b))
            rows.append(int(args[0].shape[0]))
            return out

        self.wf.wavefront_cuda = timed
        return self

    def __exit__(self, *exc):
        self.wf.wavefront_cuda = self._orig
        self.wf.padded_layout = self._orig_layout
        self.torch.cuda.synchronize()

    def kernel_s(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


def drive(torch, wf, dispatch, label, fn):
    """Run ``fn`` with launch counts zeroed just before; returns
    (result, seconds, launches, kernel seconds, rows per dispatch).  Fails
    if the padded operand layout was built on the way (the kernel reads the
    dispatch's rows as they are)."""
    dispatch.STATS.reset()
    wf.LAUNCHES = 0
    with Timed(torch, wf) as tm:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
    launches = wf.LAUNCHES
    if tm.layouts:
        raise AssertionError(f"{label}: the padded layout was built "
                             f"{tm.layouts} times on the card path")
    return out, s, launches, tm.kernel_s(), list(tm.rows)


def phase_full(torch, wf, dispatch, args, dev) -> dict:
    import numpy as np
    from repro_torch.core.segmentation import query_segments
    from repro_torch.data.synthetic import protein_sequences
    from repro_torch.retrieval import RetrievalConfig, Retriever
    sizes = {}
    total_launches = 0

    # (a) steps 1-4 at the paper's window size l = 20
    n_seqs = args.windows_a // 20
    seqs = protein_sequences(n_seqs, 400, seed=0)
    cfg = RetrievalConfig("levenshtein", lam=40, lambda0=2, index="refnet",
                          tight_bounds=True, num_max=5, device=str(dev))
    r, s, launches, ks, rows = drive(torch, wf, dispatch, "build",
                                     lambda: Retriever.build(cfg, seqs))
    st = r.eval_stats()
    if launches != st["build_dispatches"]:
        raise AssertionError(f"build: {launches} launches != "
                             f"{st['build_dispatches']} dispatches")
    total_launches += launches
    print("[full-a] the database size is cut by the host: the reference "
          "net's Python plan code costs microseconds per evaluation and "
          "evaluations grow about as n^1.9, so build time is host time",
          flush=True)
    log("full-a-build", windows=len(r.meta), build_s=f"{s:.2f}",
        host_s=f"{s - ks:.2f}", kernel_s=f"{ks:.4f}",
        build_evals=st["build"], build_dispatches=st["build_dispatches"],
        launches=launches, rows_mean=f"{np.mean(rows):.0f}",
        rows_max=max(rows))
    sizes["build_a"] = rows
    qrng = np.random.default_rng(7)
    queries = []
    for i in range(args.queries_a):
        a, b = qrng.choice(len(seqs), 2, replace=False)
        queries.append(np.concatenate([seqs[a][37 + i:97 + i],
                                       seqs[b][100:160]]))
    m = r.matcher
    for eps in (1.0, 2.0, 4.0):
        r.reset_counter()
        hits, s, launches, ks, rows = drive(
            torch, wf, dispatch, f"seg{eps}",
            lambda: [m.segment_hits(Q, eps) for Q in queries])
        st = r.eval_stats()
        if launches != st["dispatches"]:
            raise AssertionError(f"segment_hits eps={eps}: {launches} "
                                 f"launches != {st['dispatches']}")
        total_launches += launches
        sizes[f"seg_a_{eps}"] = rows
        log(f"full-a-step4-eps{eps}", queries=len(queries),
            segment_plans=sum(len(segs) for Q in queries for _, segs in
                              query_segments(Q, 40, 2).values()),
            segment_hits=sum(len(h) for h in hits),
            windows_hit=len({h.window_idx for hh in hits for h in hh}),
            evals=st["query"], dispatches=st["dispatches"],
            launches=launches, s=f"{s:.2f}", host_s=f"{s - ks:.2f}",
            kernel_s=f"{ks:.4f}", rows_mean=f"{np.mean(rows):.0f}",
            rows_max=max(rows))

    # (b) all three query types, quickstart configuration
    n_seqs = args.windows_b // 50
    seqs = protein_sequences(n_seqs, 400, n_motifs=8 * n_seqs, seed=1)
    Q = planted_query(np.random.default_rng(0), seqs)
    cfg = RetrievalConfig("levenshtein", lam=16, lambda0=1, index="refnet",
                          tight_bounds=True, num_max=5, device=str(dev))
    r, s, launches, ks, rows = drive(torch, wf, dispatch, "build-b",
                                     lambda: Retriever.build(cfg, seqs))
    st = r.eval_stats()
    if launches != st["build_dispatches"]:
        raise AssertionError("build b: launches != build dispatches")
    total_launches += launches
    sizes["build_b"] = rows
    log("full-b-build", windows=len(r.meta), build_s=f"{s:.2f}",
        host_s=f"{s - ks:.2f}", kernel_s=f"{ks:.4f}",
        build_evals=st["build"], build_dispatches=st["build_dispatches"],
        launches=launches, rows_mean=f"{np.mean(rows):.0f}",
        rows_max=max(rows))
    for name, call in (("range", lambda: r.query(Q).range(2.0)),
                       ("longest", lambda: r.query(Q).longest(2.0)),
                       ("nearest", lambda: r.query(Q).nearest(10.0))):
        rs, s, launches, ks, rows = drive(torch, wf, dispatch, name, call)
        if launches != rs.stats["dispatches"]:
            raise AssertionError(f"{name}: {launches} launches != "
                                 f"{rs.stats['dispatches']} dispatches")
        total_launches += launches
        sizes[f"q_b_{name}"] = rows
        extra = {}
        if name == "range":
            extra["pairs"] = len(rs.hits)
        else:
            if not rs.hits:
                raise AssertionError(f"{name}: no match")
            extra["match"] = repr(rs.hits[0].key())
            extra["d"] = rs.hits[0].distance
        if name == "longest" and rs.hits[0].q_len < 30:
            raise AssertionError("longest: planted match not found")
        log(f"full-b-{name}", evals=rs.stats["query"],
            dispatches=rs.stats["dispatches"], launches=launches,
            s=f"{s:.2f}", host_s=f"{s - ks:.2f}", kernel_s=f"{ks:.4f}",
            **extra)
    log("full-layouts", padded_layout_calls=0, launches=total_launches,
        note=repr("the kernel read every dispatch's rows as they are"))
    return {"launches": total_launches, "sizes": sizes}


# -- phase 3b: kernel timing at the main path's dispatch sizes -----------------

def time_ms(torch, fn, min_ms=50.0, max_iters=200) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    one = max(a.elapsed_time(b), 1e-3)
    iters = int(min(max_iters, max(1, min_ms / one)))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


#: wavefront rows a batch of perfbench's traj-dfd-l64.batch: 64 queries
#: times its 2,491 evaluations a query (10,000 windows, its traced run on
#: an H100), all on the kernel's block schedule (one warp a row)
DFD_L64_ROWS = 64 * 2491


def phase_timing(torch, wf, rng, dev, sizes) -> list:
    """Both kernels' bounds come from ``repro_torch.roofline.costs``: the
    operations and bytes the function needs at the timed shapes.  At each
    timed shape the kernel's outputs are held to the plain version's at
    +inf and at an ε mix (:func:`compare_mix`, which raises)."""
    import numpy as np
    from repro_torch.roofline import costs
    t0 = time.perf_counter()
    print("[timing] ms is all device work of a dispatch: the kernel reads the "
          "rows as the dispatch hands them (no padded layout is built "
          "before it)", flush=True)
    # the lam=40 build pairs windows with windows (20 x 20); step 4 pairs
    # query segments of 18-22 tokens with windows
    build_rows = sizes["build_a"]
    seg_rows = max(max(v) for k, v in sizes.items() if k.startswith("seg_a"))
    shapes = [("lev", int(np.mean(build_rows)), (20, 20), (20, 20), 1,
               "main path mean rows/dispatch (lam=40 build)"),
              ("lev", int(max(build_rows)), (20, 20), (20, 20), 1,
               "main path largest dispatch (lam=40 build)"),
              ("lev", seg_rows, (18, 22), (20, 20), 1,
               "main path largest dispatch (lam=40 step 4)"),
              ("lev", 1 << 20, (18, 22), (20, 20), 1, "1,048,576 rows"),
              ("erp", 1 << 18, (20, 20), (20, 20), 2, "262,144 rows"),
              ("erp", 1 << 16, (20, 20), (20, 20), 8,
               "65,536 rows, d = 8 (numpy's eight running sums)"),
              ("erp", 1 << 14, (20, 20), (20, 20), 60,
               "16,384 rows, d = 60"),
              ("dfd", DFD_L64_ROWS, (64, 64), (64, 64), 2,
               "traj-dfd-l64.batch's rows a batch (block schedule)"),
              ("erp", 2, (1100, 1100), (1000, 1000), 2,
               "few long rows (block schedule, one warp each)")]
    rows_out = []
    for mode, B, lxr, lyr, d, what in shapes:
        xs, ys, lx, ly = make_rows(rng, mode, B, lxr, lyr, d)
        ops = operands(mode, xs, ys, lx, ly, dev)
        eps = torch.full((B,), float("inf"), device=dev)
        ms = time_ms(torch, lambda: wf.wavefront_cuda(*ops, eps, mode=mode))
        plain = time_ms(torch, lambda: wf.wavefront_torch(
            *ops, eps, mode=mode), min_ms=500.0, max_iters=20)
        err = compare_mix(wf, mode, ops)[0]  # raises on a mismatch
        cost = costs.kernel_cost_report("wavefront", *ops, eps, mode=mode)
        b_ms, by, old = (cost["bound_ms"], cost["bound_by"],
                         cost["old_bound_ms"])
        smem, per_block = wf.smem_bytes(mode, xs.shape[1], ys.shape[1], d)
        log("timing", mode=mode, rows=B, rows_per_block=per_block,
            smem_bytes=smem,
            shape=f"{xs.shape[1]}x{ys.shape[1]}x{d}", what=repr(what),
            ms=f"{ms:.4f}", plain_ms=f"{plain:.3f}", bound_ms=f"{b_ms:.4f}",
            bound_by=by, share=f"{b_ms / ms:.3f}",
            old_bound_ms=f"{old:.4f}", old_share=f"{old / ms:.3f}",
            max_abs_err=err)
        rows_out.append(dict(mode=mode, rows=B, ms=ms, plain_ms=plain,
                             bound_ms=b_ms, bound_by=by, old_bound_ms=old,
                             max_abs_err=err))
    log("timing-done", s=f"{time.perf_counter() - t0:.2f}")
    return rows_out


# -- phase 3c: pairwise_l2 kernel against its plain version --------------------

def l2_sq_bound(x, y):
    """Worst-case gap on squared distances between the kernel (3xTF32
    products on the tensor cores) and the f32 plain version, derived in
    csrc/pairwise_l2.cu: (9d + 26 + 6d 2^-8) 2^-24 (|x|^2 + |y|^2)."""
    d = x.shape[1]
    return (9 * d + 26 + 6 * d * 2.0 ** -8) * 2.0 ** -24 * (
        (x.double() ** 2).sum(1)[:, None] + (y.double() ** 2).sum(1)[None, :])


def compare_l2(torch, pl2, x, y, rows=None):
    """(largest |dD^2| / bound, largest |dD|) of the kernel against the
    plain version; ``rows`` limits the plain version to a row subset."""
    got = pl2.pairwise_l2_cuda(x, y)
    if rows is not None:
        got, x = got[rows], x[rows]
    want = pl2.pairwise_l2_torch(x, y)
    torch.cuda.synchronize()
    if tuple(got.shape) != (x.shape[0], y.shape[0]):
        raise AssertionError(f"pairwise_l2: shape {tuple(got.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("pairwise_l2: kernel produced inf/NaN")
    ratio = float(((got.double() ** 2 - want.double() ** 2).abs()
                   / l2_sq_bound(x, y)).max())
    if ratio > 1.0:
        raise AssertionError(f"pairwise_l2 {tuple(got.shape)}: |dD^2| is "
                             f"{ratio:.3f} x its bound")
    return ratio, float((got - want).abs().max())


def phase_l2_parity(torch, pl2, dev) -> float:
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    cases = []
    # the reference's kernel-test shapes, ragged edges, d = 1 and d = 961
    for M, N, d in ((1, 1, 3), (16, 16, 8), (37, 51, 19), (128, 128, 64),
                    (130, 5, 33), (65, 67, 1), (100, 70, 961)):
        cases.append(("reference shape", randn(M, d), randn(N, d), None))
    # the embedding case: unit rows, exact and near (1e-4) duplicates
    x, y = randn(1000, 960), randn(3000, 960)
    y[:500] = x[:500]
    y[500:1000] = x[500:1000] + 1e-4 * randn(500, 960)
    x /= x.norm(dim=1, keepdim=True)
    y /= y.norm(dim=1, keepdim=True)
    cases.append(("unit rows, duplicates", x, y, None))
    # M * N > 2^31: 64-bit output offsets; rows straddling the 2^31 mark
    M, N = 65600, 32768
    rows = torch.tensor([0, 1, 65535, 65536, 65537, 65599], device=dev)
    cases.append(("M*N > 2^31", randn(M, 8), randn(N, 8), rows))
    # entries spread over 2^-20 .. 2^20 (the split's small parts span the
    # whole f32 range), with near twins; at both tiles and both loaders
    for M, N, d in ((203, 517, 960), (1000, 8300, 960), (77, 150, 957)):
        x = randn(M, d) * torch.exp2(
            torch.empty(M, d, device=dev).uniform_(-20, 20, generator=g))
        y = randn(N, d) * torch.exp2(
            torch.empty(N, d, device=dev).uniform_(-20, 20, generator=g))
        y[:M // 2] = x[:M // 2] * (1 + 1e-3 * randn(M // 2, d))
        cases.append(("mixed magnitudes", x, y, None))
    # M and N no multiple of either tile (64 x 80, 128 x 128)
    for M, N, d in ((131, 161, 960), (2049, 4097, 963)):
        cases.append(("ragged tiles", randn(M, d), randn(N, d), None))
    worst_ratio = worst_abs = worst_unit = 0.0
    for what, x, y, rows in cases:
        ratio, err = compare_l2(torch, pl2, x, y, rows)
        log("l2-case", what=repr(what),
            shape=f"{x.shape[0]}x{y.shape[0]}x{x.shape[1]}",
            loader=pl2.LAST_PLAN["loader"], tile=pl2.LAST_PLAN["tile"],
            sq_err_over_bound=f"{ratio:.4g}", max_abs_err=f"{err:.3g}")
        worst_ratio = max(worst_ratio, ratio)
        worst_abs = max(worst_abs, err)
        if what != "mixed magnitudes":  # there D reaches 1e7: held on D^2
            worst_unit = max(worst_unit, err)
    log("l2-kernel-vs-plain", cases=len(cases),
        max_sq_err_over_bound=f"{worst_ratio:.4f}", max_abs_err=worst_abs,
        max_abs_err_unit_scale=worst_unit,
        tol="|dD^2| <= (9d+26+6d/256) 2^-24 (|x|^2+|y|^2)",
        s=f"{time.perf_counter() - t0:.2f}")
    return {"max_abs_err": worst_abs, "max_abs_err_unit_scale": worst_unit,
            "max_sq_err_over_bound": worst_ratio}


# -- phase 6: embedding retrieval at smollm-360m's full widths ---------------

def duplicate_docs(corpus):
    """Ids of documents that are planted near-copies of an earlier one
    (more than 90 % equal tokens)."""
    dups = []
    for j in range(1, len(corpus)):
        same = (corpus[:j] == corpus[j]).mean(axis=1)
        if same.max() > 0.9:
            dups.append((j, int(same.argmax())))
    return dups


#: windows of the embedding run's check against the numpy backend (its
#: host build costs seconds there; the full database's would cost minutes)
EMBED_PARITY_WINDOWS = 1024


def phase_embedding(torch, pl2, args, dev) -> dict:
    import numpy as np
    from repro_torch.core.embedding_retrieval import embed_windows
    from repro_torch.data.synthetic import token_corpus
    from repro_torch.kernels import ops
    from repro_torch.models import registry as models
    from repro_torch.models.params import init_params, param_count
    from repro_torch.retrieval import RetrievalConfig, Retriever
    t_phase = time.perf_counter()
    cfg, mod = models.get("smollm-360m")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    defs = mod.param_defs(cfg)
    model = mod.build(cfg, init_params(defs, g, torch.bfloat16, dev),
                      device=dev)
    torch.cuda.synchronize()
    log("embed-model", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv_heads}x"
        f"{cfg.head_dim}", d_ff=cfg.d_ff, vocab=cfg.vocab,
        params=param_count(defs), dtype="bfloat16",
        init_s=f"{time.perf_counter() - t0:.2f}")

    window, doc_len = 16, 256
    corpus = token_corpus(args.embed_docs, doc_len, cfg.vocab, seed=0,
                          dup_frac=0.05)
    embed_windows(mod, model, cfg, list(corpus[:8]), window, device=dev)
    torch.cuda.synchronize()  # warm-up: the product kernels' first calls
    pl2.LAUNCHES = 0  # the path's launches: counted from here
    t0 = time.perf_counter()
    vecs, meta = embed_windows(mod, model, cfg, list(corpus), window,
                               device=dev)
    embed_s = time.perf_counter() - t0
    if vecs.shape != (args.embed_docs * doc_len // window, cfg.d_model) \
            or not np.isfinite(vecs).all():
        raise AssertionError(f"embed_windows: {vecs.shape}, finite="
                             f"{bool(np.isfinite(vecs).all())}")
    if np.abs(np.linalg.norm(vecs, axis=1) - 1).max() > 1e-5:
        raise AssertionError("embed_windows: vectors are not unit length")
    log("embed-windows", docs=args.embed_docs, tokens=corpus.size,
        windows=len(vecs), s=f"{embed_s:.3f}",
        tokens_per_s=f"{corpus.size / embed_s:.0f}")

    # probes: 64 windows of planted near-duplicate documents
    dups = duplicate_docs(corpus)
    if not dups:
        raise ValueError("no planted duplicate documents: --embed-docs "
                         "must be at least 20")
    per = -(-64 // len(dups))
    probe_ids = [dst * (doc_len // window) + w for dst, _ in dups
                 for w in range(per)][:64]
    twin_of = {dst * (doc_len // window) + w: src * (doc_len // window) + w
               for dst, src in dups for w in range(per)}
    probes = vecs[probe_ids]

    cfg_ix = RetrievalConfig("euclidean", index="embedding", eps_prime=0.02,
                             num_max=5, tight_bounds=True, device=str(dev))
    t0 = time.perf_counter()
    r = Retriever.build(cfg_ix, vecs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    st = r.eval_stats()
    print("[embed] the database size is cut by the host: the reference "
          "net's Python plan code costs microseconds per evaluation and "
          "build evaluations grow about as n^1.8", flush=True)
    log("embed-build", windows=len(vecs), build_s=f"{build_s:.2f}",
        build_evals=st["build"], build_dispatches=st["build_dispatches"])
    eps = 0.5
    t0 = time.perf_counter()
    rs = r.batch(probes).range(eps)
    range_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    near = r.batch(probes).nearest(2.0, tol=1e-3)
    nearest_s = time.perf_counter() - t0
    for i, pid in enumerate(probe_ids):
        if pid not in rs.hits[i]:
            raise AssertionError(f"range: probe {pid} misses itself")
        if near.distances[i] is None or near.distances[i] > 1e-3:
            raise AssertionError(f"nearest: probe {pid} got "
                                 f"{near.distances[i]}")
    twins = sum(twin_of[pid] in rs.hits[i] for i, pid in enumerate(probe_ids))
    # the index's Euclidean runs as elementwise torch ops: no pairwise_l2
    if pl2.LAUNCHES != 0:
        raise AssertionError(f"pairwise_l2: {pl2.LAUNCHES} launches inside "
                             "the embedding index, expected none")
    # the path's exact step: every probe against every window, all pairs
    x = torch.as_tensor(probes, device=dev)
    y = torch.as_tensor(vecs, device=dev)
    D = ops.pairwise_l2(x, y)
    torch.cuda.synchronize()
    launches = pl2.LAUNCHES  # the path ends here
    if launches != 1:
        raise AssertionError(f"pairwise_l2: {launches} launches for the one "
                             "all-pairs call of the embedding path")
    # the index's range hits agree with it on every pair outside the band
    band = l2_sq_bound(x, y)
    d2 = D.double() ** 2
    brute = (d2 <= eps * eps).cpu().numpy()
    outside = ((d2 - eps * eps).abs() > band).cpu().numpy()
    got = np.zeros_like(brute)
    for i, hits in enumerate(rs.hits):
        got[i, hits] = True
    if (got != brute)[outside].any():
        raise AssertionError(
            f"range hits differ from the pairwise_l2 matrix on "
            f"{int((got != brute)[outside].sum())} pairs outside the band")
    log("embed-queries", probes=len(probe_ids), dup_docs=len(dups),
        range_eps=eps, range_hits=sum(len(h) for h in rs.hits),
        twins_found=twins, range_s=f"{range_s:.3f}",
        range_evals=rs.stats["query"], range_dispatches=rs.stats["dispatches"],
        nearest_s=f"{nearest_s:.3f}", nearest_evals=near.stats["query"],
        nearest_dispatches=near.stats["dispatches"],
        brute_pairs=int(brute.size), band_pairs=int((~outside).sum()),
        index_pairwise_l2_launches=0, all_pairs_launches=launches)

    # at a cut size: hits and counts equal to the numpy host backend
    t0 = time.perf_counter()
    n_cut = min(EMBED_PARITY_WINDOWS, len(vecs))
    cut_probes = [p for p in probe_ids if p < n_cut][:16] or list(range(16))
    out = {}
    for be in ("numpy", "kernel"):
        rb = Retriever.build(cfg_ix.replace(backend=be), vecs[:n_cut])
        a = rb.batch(vecs[cut_probes]).range(eps)
        b = rb.batch(vecs[cut_probes]).nearest(2.0, tol=1e-3)
        out[be] = (a.hits, b.hits, a.stats, b.stats, rb.eval_stats())
    if out["numpy"][:2] != out["kernel"][:2]:
        raise AssertionError("embedding: hits differ kernel vs numpy")
    if out["numpy"][2:] != out["kernel"][2:]:
        raise AssertionError(f"embedding: counts differ {out['kernel'][2:]}"
                             f" vs {out['numpy'][2:]}")
    log("embed-parity", windows=n_cut, probes=len(cut_probes),
        stats=json.dumps(out["kernel"][4]), s=f"{time.perf_counter() - t0:.2f}")
    log("embed-done", s=f"{time.perf_counter() - t_phase:.2f}")
    return {"launches": launches, "x": x, "y": y,
            "row": dict(embed_s=embed_s, build_s=build_s, range_s=range_s,
                        nearest_s=nearest_s)}


# -- phase 6b: pairwise_l2 timing ---------------------------------------------

def phase_l2_timing(torch, pl2, build, dev, main_x, main_y) -> list:
    from repro_torch.roofline import costs
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(5)
    shapes = [("main path: probes x windows", main_x, main_y),
              ("8192 x 8192", torch.randn(8192, 960, generator=g, device=dev),
               torch.randn(8192, 960, generator=g, device=dev))]
    rows = []
    for what, x, y in shapes:
        M, N, d = x.shape[0], y.shape[0], x.shape[1]
        lib = time_ms(torch, lambda: torch.cdist(
            x, y, compute_mode="use_mm_for_euclid_dist"))
        ms = time_ms(torch, lambda: pl2.pairwise_l2_cuda(x, y))
        plain = time_ms(torch, lambda: pl2.pairwise_l2_torch(x, y))
        lib2 = time_ms(torch, lambda: torch.cdist(
            x, y, compute_mode="use_mm_for_euclid_dist"))
        lib = min(lib, lib2)  # library timed before and after the kernel
        cost = costs.kernel_cost_report("pairwise_l2", x, y)
        b_ms, by, f32 = (cost["bound_ms"], cost["bound_by"],
                         cost["f32_bound_ms"])
        plan = (pl2.LAST_PLAN["loader"] == "tma") | (
            2 * (pl2.LAST_PLAN["tile"] == "128x128"))
        log("l2-timing", what=repr(what), shape=f"{M}x{N}x{d}",
            loader=pl2.LAST_PLAN["loader"], tile=pl2.LAST_PLAN["tile"],
            smem_bytes=build.load("pairwise_l2").pairwise_l2_smem_bytes(plan),
            ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}", library_ms=f"{lib:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=by, share=f"{b_ms / ms:.3f}",
            f32_bound_ms=f"{f32:.4f}", f32_share=f"{f32 / ms:.3f}",
            tflops=f"{2.0 * M * N * d / ms / 1e9:.2f}")
        rows.append(dict(ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=b_ms, bound_by=by, f32_bound_ms=f32))
    log("l2-timing-done", s=f"{time.perf_counter() - t0:.2f}")
    return rows


# -- phases 7-9: the elastic fleet and the serve engine ------------------------

FLEET_WORKERS = ["w0", "w1", "w2", "w3"]


def mutate(data, n, seed, rate=0.1):
    """Database rows perturbed into near-miss queries (token flips or
    Gaussian noise), as the reference's benchmarks make them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    qs = data[rng.integers(0, len(data), n)].copy()
    if data.dtype.kind in "iu":
        flips = rng.random(qs.shape) < rate
        qs[flips] = rng.integers(0, int(data.max()) + 1, flips.sum())
    else:
        qs += rng.normal(scale=rate * np.std(data),
                         size=qs.shape).astype(qs.dtype)
    return qs


def fleet_config(name, dev, workers=FLEET_WORKERS, **kw):
    from repro_torch.retrieval import RetrievalConfig
    return RetrievalConfig(name, execution="fleet", workers=list(workers),
                           tight_bounds=True, device=str(dev), **kw)


def shard_dispatches(fleet):
    """(query dispatches, build dispatches) over the fleet's live shards."""
    shards = [s for s in fleet.shards.values() if s is not None]
    return (sum(s.net.counter.dispatches for s in shards),
            sum(s.net.counter.build_dispatches for s in shards))


def fleet_query(torch, wf, dispatch, r, qs, eps, via, label, dead=(),
                lb=None):
    """One facade fleet query, driven with the counts zeroed just before;
    checks its launches against what the path must launch: one per merged
    round (rounds), one per counted dispatch (the host loop), one for the
    query x pivot rows plus one when any survivor is left (one-shot, whose
    ring filter launches once, and its pass 2 once when any survivor is
    left).  Returns (ResultSet, seconds, launches, kernel seconds)."""
    fleet = r.elastic().index
    ds0 = dict(fleet.device_stats)
    qd0 = shard_dispatches(fleet)[0]
    plan = r.batch(qs).via(via)
    if dead:
        plan = plan.dead(*dead)
    if lb is not None:
        plan = plan.lb(lb)
    ring0 = ring_launches()
    rs, s, launches, ks, _ = drive(torch, wf, dispatch, label,
                                   lambda: plan.range(eps))
    ds = fleet.device_stats
    if via == "fleet-rounds":
        # one launch per merged round; a round whose every row the
        # envelope tier pruned launches nothing
        want = ds["rounds"] - ds0["rounds"]
        ok = launches == dispatch.STATS.dispatches and (
            launches <= want if lb == "envelope" else launches == want)
        if not ok:
            raise AssertionError(f"{label}: {launches} launches, "
                                 f"{dispatch.STATS.dispatches} dispatches, "
                                 f"{want} merged rounds")
    elif via == "host":
        want = shard_dispatches(fleet)[0] - qd0
        if not launches == dispatch.STATS.dispatches == want:
            raise AssertionError(f"{label}: {launches} launches != {want} "
                                 "counted dispatches")
    else:
        want = 1 + int(ds["member_evals"] > ds0["member_evals"])
        if launches != want or dispatch.STATS.dispatches:
            raise AssertionError(f"{label}: one-shot launched {launches} "
                                 f"times, expected {want}")
        # one filter; its pass 2 when any survivor is left (the envelope
        # stage counts them all in lb_rows, and may prune every one)
        need = max(ds["member_evals"] - ds0["member_evals"],
                   ds["lb_rows"] - ds0["lb_rows"])
        got = tuple(b - a for a, b in zip(ring0, ring_launches()))
        if got != (1, int(need > 0)):
            raise AssertionError(f"{label}: ring filter launched {got} "
                                 f"(filters, pass 2s), expected "
                                 f"{(1, int(need > 0))}")
    return rs, s, launches, ks


def unfused(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k != "fused_pruned"}


def brute_hits(fleet, qs, eps):
    """Global hit ids per query by brute force: ``host_reference_hits`` (the
    numpy oracle) over the merged FlatNet, columns mapped through gids."""
    import numpy as np
    from repro_torch.core.distributed import host_reference_hits, merge_flats
    alive = [fleet.shards[w] for w in fleet.workers
             if fleet.shards.get(w) is not None]
    merged, _ = merge_flats([s.flat for s in alive])
    gids = np.concatenate([s.gids for s in alive])
    H = host_reference_hits(merged, qs, eps)
    return [sorted(int(g) for g in gids[row]) for row in H]


RING_KERNELS = ("ring_verdicts", "ring_scan", "ring_rows")


def ring_launches() -> tuple:
    """(filters, pass 2s) the one-shot query's ring filter has launched."""
    from repro_torch.kernels import ring_filter as rf
    return rf.LAUNCHES, rf.ROW_LAUNCHES


def ring_kernel_ms(torch, fn, reps) -> dict:
    """Device ms a call of ``fn`` of each ring filter kernel, from the
    profiler's kernel events: CUDA events around a loop would time the
    wrappers' host code too, and pass 1 takes less device time than its
    launch."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(RING_KERNELS, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for k in RING_KERNELS:
                if k + "_kernel" in e.name:
                    out[k] += e.time_range.elapsed_us() / 1e3 / reps
    silent = [k for k, v in out.items() if not v > 0]
    if silent:
        raise AssertionError(f"ring filter: no device time for {silent}")
    return out


def ring_check(torch, dev, flat, qs, eps, reps=200) -> dict:
    """The ring filter on a merged fleet's own operands (``dp`` from the
    card's pivot launch, the one-shot query's queries and ``eps``): both
    passes through the CUDA wrappers and the plain versions on the same
    card operands, held equal byte for byte (the hit mask after pass 1,
    ``n_need``, and every row pass 2 writes); then the kernels' device ms,
    the plain version's ms and the bound from the bytes of this call."""
    from repro_torch.core import distributed as dist_mod
    from repro_torch.kernels import registry
    from repro_torch.kernels import ring_filter as rf
    from repro_torch.roofline import costs
    launches0 = ring_launches()
    Q, P, N = len(qs), flat.n_pivots, len(flat.data)
    arrs = flat.device_arrays(dev)
    qs_t = dist_mod._operand_of(flat.dist_name)(qs).to(dev).contiguous()
    q_lens = torch.full((Q,), qs.shape[1], dtype=torch.int32, device=dev)
    piv = arrs["pivots"]
    dp = registry.get(flat.dist_name).device_call(
        qs_t.repeat_interleave(P, dim=0),
        piv.repeat((Q,) + (1,) * (piv.ndim - 1)),
        lx=q_lens.repeat_interleave(P)).dist.reshape(Q, P).contiguous()
    ring = (dp, arrs["pradius"], arrs["mem_pivot"], arrs["mem_id"],
            arrs["mem_dist"])
    data = arrs["data"]
    out = []
    for f1, f2 in ((rf.ring_filter_cuda, rf.survivor_rows_cuda),
                   (rf.ring_filter_torch, rf.survivor_rows_torch)):
        hits = torch.zeros((Q, N), dtype=torch.bool, device=dev)
        v = f1(*ring, eps, hits)
        n = int(v.n_need)
        out.append((hits, n, f2(v, n, qs_t, q_lens, data)))
    torch.cuda.synchronize()
    (gh, gn, gr), (wh, wn, wr) = out
    bad = [k for k, ok in (("hits", torch.equal(gh, wh)),
                           ("n_need", gn == wn)) if not ok]
    if not bad:
        bad = [k for k, g, w in zip(rf.Rows._fields, gr, wr)
               if g.dtype != w.dtype or not torch.equal(g, w)]
    if bad or not gn:
        raise AssertionError(f"ring filter on the merged fleet: {bad} "
                             f"differ from the plain version (n_need "
                             f"{gn} vs {wn})")

    def kernel():
        h = torch.zeros((Q, N), dtype=torch.bool, device=dev)
        rf.survivor_rows_cuda(rf.ring_filter_cuda(*ring, eps, h), gn, qs_t,
                              q_lens, data)

    def plain():
        h = torch.zeros((Q, N), dtype=torch.bool, device=dev)
        rf.survivor_rows_torch(rf.ring_filter_torch(*ring, eps, h), gn,
                               qs_t, q_lens, data)

    per = ring_kernel_ms(torch, kernel, reps)
    ms = sum(per.values())
    launched = time_ms(torch, kernel)
    plain_ms = time_ms(torch, plain, min_ms=200.0, max_iters=20)
    cost = costs.kernel_cost_report("ring_filter", dp, arrs["mem_id"], qs_t,
                                    data, n_need=gn)
    nv = arrs["mem_id"].numel()
    res = dict(Q=Q, P=P, Nv=nv, N=N, n_need=gn, filter_slots=Q * nv, ms=ms,
               **{k + "_ms": v for k, v in per.items()},
               launched_ms=launched, plain_ms=plain_ms,
               bound_ms=cost["bound_ms"], bound_by=cost["bound_by"],
               bytes=cost["bytes"])
    log("fleet8-ring", held_to=repr("the plain version, byte for byte"),
        **{k: (f"{v:.4f}" if isinstance(v, float) and k.endswith("ms")
               else v) for k, v in res.items()},
        share=f"{cost['bound_ms'] / ms:.3f}")
    res["launches"] = tuple(b - a for a, b in zip(launches0,
                                                  ring_launches()))
    return res


def phase_fleet_parity(torch, wf, dispatch, dev) -> int:
    """Phase 7, at a cut size: the fleet's paths on the card against the
    host loop, brute force and the numpy backend; the envelope tier."""
    import numpy as np
    from repro_torch.core.distributed import _envelope_rows, merge_flats
    from repro_torch.data.synthetic import proteins, trajectories
    from repro_torch.distances import bounds, get
    from repro_torch.kernels import registry
    from repro_torch.retrieval import RetrievalConfig, Retriever
    t0 = time.perf_counter()
    launches_total = 0

    # Levenshtein: rounds, host loop, one-shot, brute force, numpy backend
    data = proteins(1200, seed=0)
    qs = mutate(data, 32, seed=3)
    rk = Retriever.build(fleet_config("levenshtein", dev), data)
    rn = Retriever.build(fleet_config("levenshtein", dev, backend="numpy"),
                         data)
    if rk.eval_stats() != rn.eval_stats():
        raise AssertionError(f"fleet build counts differ {rk.eval_stats()}"
                             f" vs {rn.eval_stats()}")
    want = brute_hits(rk.elastic().index, qs, 2.0)
    for via in ("fleet-rounds", "host", "fleet-oneshot"):
        rs, s, launches, _ = fleet_query(torch, wf, dispatch, rk, qs, 2.0,
                                         via, f"fleet7-{via}")
        launches_total += launches
        ref = rn.batch(qs).via(via).range(2.0)
        if rs.hits != want or ref.hits != want:
            raise AssertionError(f"fleet {via}: hits differ from brute "
                                 "force / the numpy backend")
        if rs.stats != ref.stats:
            raise AssertionError(f"fleet {via}: stats {rs.stats} vs numpy "
                                 f"{ref.stats}")
        log("fleet7-lev", via=via, windows=len(data), queries=len(qs),
            hits=sum(map(len, rs.hits)), launches=launches,
            stats=json.dumps(rs.stats), s=f"{s:.2f}")
    # every count but ``fused_pruned``: the numpy backend evaluates rounds
    # without fused ε, so it certifies no early prunes there
    for a, b, what in ((unfused(rk.elastic().device_stats),
                        unfused(rn.elastic().device_stats), "device_stats"),
                       (rk.elastic().index.eval_count(),
                        rn.elastic().index.eval_count(), "eval_count")):
        if a != b:
            raise AssertionError(f"fleet {what}: {a} vs numpy {b}")
    log("fleet7-lev-counts", device_stats=json.dumps(
        rk.elastic().device_stats), eval_count=json.dumps(
        rk.elastic().index.eval_count()))

    # ERP: the envelope cascade on and off — fleet rounds, one-shot, and
    # the counter's tier in window mode (batched linear scan)
    data = trajectories(1200, seed=0)
    qs = mutate(data, 32, seed=3, rate=0.003)  # noise ~0.02: hits at eps 1
    fk = Retriever.build(fleet_config("erp", dev), data)
    fn = Retriever.build(fleet_config("erp", dev, backend="numpy"), data)
    wk = Retriever.build(RetrievalConfig("erp", index="linear",
                                         device=str(dev)), data)
    wn = Retriever.build(RetrievalConfig("erp", index="linear",
                                         backend="numpy", device=str(dev)),
                         data)
    base = None
    for lb in ("off", "envelope"):
        for via in ("fleet-rounds", "fleet-oneshot"):
            rs, s, launches, _ = fleet_query(
                torch, wf, dispatch, fk, qs, 1.0, via,
                f"fleet7-erp-{via}-{lb}", lb=lb)
            launches_total += launches
            ref = fn.batch(qs).via(via).lb(lb).range(1.0)
            base = rs.hits if base is None else base
            if rs.hits != base or ref.hits != base or rs.stats != ref.stats:
                raise AssertionError(f"erp fleet {via} lb={lb}: hits or "
                                     "stats differ")
            log("fleet7-erp", via=via, lb=lb, hits=sum(map(len, rs.hits)),
                launches=launches, stats=json.dumps(rs.stats),
                s=f"{s:.2f}")
        dispatch.STATS.reset()
        wf.LAUNCHES = 0
        got = wk.batch(qs).via("batched").lb(lb).range(1.0)
        env_rows = dispatch.STATS.lb_rows.get("envelope", 0)
        ref = wn.batch(qs).via("batched").lb(lb).range(1.0)
        if got.hits != base or ref.hits != base or got.stats != ref.stats:
            raise AssertionError(f"erp window mode lb={lb}: hits or counts "
                                 f"differ {got.stats} vs {ref.stats}")
        if lb == "envelope" and not env_rows:
            raise AssertionError("the device envelope tier never ran")
        log("fleet7-erp-window", lb=lb, stats=json.dumps(got.stats),
            device_envelope_rows=env_rows,
            device_envelope_pruned=dispatch.STATS.lb_pruned.get(
                "envelope", 0))
    for a, b, what in (
            (unfused(fk.elastic().device_stats),
             unfused(fn.elastic().device_stats), "fleet device_stats"),
            ((wk.counter.lb_tier_rows, wk.counter.lb_tier_pruned),
             (wn.counter.lb_tier_rows, wn.counter.lb_tier_pruned),
             "window tier maps")):
        if a != b:
            raise AssertionError(f"erp {what}: {a} vs numpy {b}")
    ds = fk.elastic().device_stats
    if not ds["lb_pruned"]:
        raise AssertionError("the fleet envelope stage pruned nothing")

    # the device envelope bounds against the host's on every query x window
    fleet = fk.elastic().index
    merged, _ = merge_flats([fleet.shards[w].flat for w in fleet.workers])
    e = merged.envelopes
    Q, N = len(qs), len(merged.data)
    q_of = np.repeat(np.arange(Q), N)
    w_of = np.tile(np.arange(N), Q)
    lens = np.full(Q * N, qs.shape[1])
    host = bounds.lb_envelope_rows("erp", qs[q_of], lens, e.lo[w_of],
                                   e.hi[w_of], e.mass[w_of])
    t = {k: torch.as_tensor(v, device=dev) for k, v in
         (("q", qs[q_of]), ("l", lens), ("lo", e.lo[w_of]),
          ("hi", e.hi[w_of]), ("m", e.mass[w_of]))}
    devb = _envelope_rows("erp", t["q"], t["l"], t["lo"], t["hi"],
                          t["m"]).cpu().numpy()
    two = registry.get_envelope("erp").batch(
        qs[q_of], torch.as_tensor(merged.data, device=dev)[
            torch.as_tensor(w_of, device=dev)], eps=1.0).dist.cpu().numpy()
    host2 = get("erp").envelope_bound(qs[q_of], merged.data[w_of],
                                      y_env=e.take(w_of))
    # f32 sums of 20 terms in another order differ by a few ulps of the
    # summed magnitudes, and ERP's gap-mass terms are differences of such
    # sums (|sum g(x) - mass| cancels), so the error is held relative to
    # the summed magnitudes: the row norms of the query and the candidate
    gq = np.sqrt((qs[q_of].astype(np.float64) ** 2).sum(-1)).sum(1)
    scale = gq + e.mass[w_of]
    errs = {}
    for a, b, what in ((devb, host, "one-shot stage"),
                       (two, host2, "lb:erp spec")):
        if not np.array_equal(a, b):  # numpy's orders on the card too
            raise AssertionError(f"device envelope ({what}) not bit-equal "
                                 f"to the host's on {int((a != b).sum())} "
                                 "rows")
        d = np.abs(a.astype(np.float64) - b)
        errs[what] = (float((d / np.maximum(np.abs(b), 1e-6)).max()),
                      float((d / np.maximum(scale, np.abs(b))).max()))
        if errs[what][1] > 1e-5:
            raise AssertionError(f"device envelope ({what}) off the host's "
                                 f"by {errs[what][1]:.3g} of its scale")
    log("fleet7-envelope-bounds", rows=Q * N,
        rel_err_oneshot_stage=f"{errs['one-shot stage'][0]:.3g}",
        scaled_err_oneshot_stage=f"{errs['one-shot stage'][1]:.3g}",
        rel_err_lb_spec=f"{errs['lb:erp spec'][0]:.3g}",
        scaled_err_lb_spec=f"{errs['lb:erp spec'][1]:.3g}",
        tol=repr("bit-equal; |d| <= 1e-5 (sum|q_i| + mass)"),
        lb_rows=ds["lb_rows"], lb_pruned=ds["lb_pruned"],
        s=f"{time.perf_counter() - t0:.2f}")
    return launches_total


def phase_fleet_full(torch, wf, dispatch, args, dev) -> dict:
    """Phase 8: the fleet at cell A's window size: build, rounds and
    one-shot queries, a dead worker, resize 4 -> 5 -> 4."""
    import numpy as np
    from repro_torch.data.synthetic import proteins
    from repro_torch.launch.elastic import moved_fraction
    from repro_torch.retrieval import Retriever
    t_phase = time.perf_counter()
    data = proteins(args.windows_fleet, seed=0)
    cfg = fleet_config("levenshtein", dev)
    r, s, launches, ks, rows = drive(torch, wf, dispatch, "fleet-build",
                                     lambda: Retriever.build(cfg, data))
    fleet = r.elastic().index
    build_disp = shard_dispatches(fleet)[1]
    if launches != build_disp or dispatch.STATS.dispatches != build_disp:
        raise AssertionError(f"fleet build: {launches} launches != "
                             f"{build_disp} build dispatches")
    full_build = r.eval_stats()["build"]
    total = launches
    log("fleet8-build", windows=len(data), workers=len(fleet.workers),
        shard_windows=json.dumps([len(fleet.assignment[w])
                                  for w in fleet.workers]),
        pivots=json.dumps([fleet.shards[w].flat.n_pivots
                           for w in fleet.workers]),
        build_s=f"{s:.2f}", host_s=f"{s - ks:.2f}", kernel_s=f"{ks:.4f}",
        build_evals=full_build, build_dispatches=build_disp,
        launches=launches, rows_mean=f"{np.mean(rows):.0f}",
        rows_max=max(rows))
    row = dict(build_s=s, build_kernel_s=ks, build_evals=full_build,
               build_launches=launches)

    qs = mutate(data, 64, seed=5)
    res, ring_by_path = {}, {}
    for via in ("fleet-rounds", "fleet-oneshot"):
        ds0 = dict(fleet.device_stats)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ring0 = ring_launches()
        rs, s, launches, ks = fleet_query(torch, wf, dispatch, r, qs, 2.0,
                                          via, f"fleet8-{via}")
        ring_by_path["fleet8_" + via.split("-")[1]] = tuple(
            b - a for a, b in zip(ring0, ring_launches()))
        peak = torch.cuda.max_memory_allocated(dev) - base_mem
        total += launches
        res[via] = rs.hits
        ds = fleet.device_stats
        extra = {}
        if via == "fleet-oneshot":
            merged = fleet._merged[1][0]
            # the ring filter visits Q x (pairs) slots
            slots = len(qs) * len(merged.mem_id)
            extra = dict(Q=len(qs), P=merged.n_pivots, filter_slots=slots,
                         peak_bytes=peak,
                         survivors=ds["member_evals"] - ds0["member_evals"])
            row.update(oneshot_s=s, oneshot_kernel_s=ks,
                       oneshot_evals=rs.stats["device_evals"],
                       oneshot_launches=launches, filter_slots=slots,
                       peak_bytes=peak)
        else:
            extra = dict(rounds=ds["rounds"] - ds0["rounds"])
            row.update(rounds_s=s, rounds_kernel_s=ks,
                       rounds_evals=rs.stats["device_evals"],
                       rounds_launches=launches,
                       rounds=ds["rounds"] - ds0["rounds"])
        log("fleet8-query", via=via, queries=len(qs),
            hits=sum(map(len, rs.hits)), device_evals=rs.stats[
                "device_evals"], launches=launches, s=f"{s:.2f}",
            host_s=f"{s - ks:.2f}", kernel_s=f"{ks:.4f}", **extra)
    if res["fleet-rounds"] != res["fleet-oneshot"]:
        raise AssertionError("fleet: rounds and one-shot hits differ")
    full = res["fleet-rounds"]
    # the filter on the one-shot query's own merged fleet, at its eps
    row["ring"] = ring_check(torch, dev, merged, qs, 2.0)

    lost = set(fleet.assignment["w1"])
    survivors = [[h for h in hs if h not in lost] for hs in full]
    for via in ("fleet-rounds", "fleet-oneshot"):
        ring0 = ring_launches()
        rs, s, launches, _ = fleet_query(torch, wf, dispatch, r, qs, 2.0,
                                         via, f"fleet8-dead-{via}",
                                         dead=("w1",))
        ring_by_path["fleet8_dead_" + via.split("-")[1]] = tuple(
            b - a for a, b in zip(ring0, ring_launches()))
        total += launches
        if rs.hits != survivors:
            raise AssertionError(f"dead w1 ({via}): hits are not the "
                                 "survivors' union")
        log("fleet8-dead", via=via, dead="w1",
            hits=sum(map(len, rs.hits)), lost_hits=sum(map(len, full))
            - sum(map(len, survivors)), launches=launches, s=f"{s:.2f}")

    for workers in (FLEET_WORKERS + ["w4"], FLEET_WORKERS):
        before = dict(fleet.assignment)
        b0 = r.eval_stats()["build"]
        frac, s, launches, ks, _ = drive(
            torch, wf, dispatch, f"resize{len(workers)}",
            lambda: r.elastic().resize(workers))
        spent = r.eval_stats()["build"] - b0
        if launches != dispatch.STATS.dispatches:
            raise AssertionError("resize: launches != dispatches")
        if frac != moved_fraction(before, fleet.assignment):
            raise AssertionError("resize: moved fraction mismatch")
        if spent > 2.0 / len(FLEET_WORKERS) * full_build:
            raise AssertionError(f"resize to {len(workers)}: re-spent "
                                 f"{spent} > 2/N of {full_build}")
        total += launches
        row[f"resize_to_{len(workers)}"] = dict(
            moved=frac, build_frac=spent / full_build, s=s, launches=launches)
        log("fleet8-resize", workers=len(workers), moved_fraction=frac,
            build_evals=spent, build_frac=f"{spent / full_build:.4f}",
            gate="2/N = 0.5", launches=launches, s=f"{s:.2f}",
            host_s=f"{s - ks:.2f}", kernel_s=f"{ks:.4f}")
    for via in ("fleet-rounds", "fleet-oneshot"):
        ring0 = ring_launches()
        rs, s, launches, _ = fleet_query(torch, wf, dispatch, r, qs, 2.0,
                                         via, f"fleet8-after-{via}")
        ring_by_path["fleet8_after_" + via.split("-")[1]] = tuple(
            b - a for a, b in zip(ring0, ring_launches()))
        total += launches
        if rs.hits != full:
            raise AssertionError(f"after 4 -> 5 -> 4 ({via}): hit sets "
                                 "changed")
    log("fleet8-done", round_trip_hits="equal", launches=total,
        s=f"{time.perf_counter() - t_phase:.2f}")
    row["launches"] = total
    rounds = {k: v for k, v in ring_by_path.items() if k.endswith("rounds")}
    if any(map(any, rounds.values())):
        raise AssertionError(f"the rounds path ran the ring filter: {rounds}")
    row["ring_by_path"] = {k: v for k, v in ring_by_path.items()
                           if k not in rounds}
    return {"retriever": r, "data": data, "row": row}


def phase_serve(torch, wf, dispatch, dev, fleet8) -> dict:
    """Phase 9: continuous batching on the phase-8 fleet — a virtual-clock
    schedule against the sequential rounds oracle, then wall-clock serving
    across a snapshot-swap resize, then the serve CLI once."""
    import contextlib
    import io
    import tempfile
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import (OpenLoopLoadGen, ServeConfig,
                                   ServeEngine, poisson_schedule)
    t_phase = time.perf_counter()
    r, data = fleet8["retriever"], fleet8["data"]
    fleet = r.elastic().index
    qs = mutate(data, 256, seed=9)
    arrivals = poisson_schedule(16.0, 2 * len(qs) / 16.0, seed=7)[:len(qs)]
    if len(arrivals) < len(qs):
        raise ValueError("the Poisson schedule came up short")

    r0 = fleet.device_stats["rounds"]
    seq, s_seq, l_seq, k_seq, _ = drive(
        torch, wf, dispatch, "serve-sequential",
        lambda: [fleet.range_query_batch([q], 2.0)[0] for q in qs])
    seq_rounds = fleet.device_stats["rounds"] - r0
    if l_seq != seq_rounds:
        raise AssertionError(f"sequential: {l_seq} launches != "
                             f"{seq_rounds} rounds")
    eng = r.serve(2.0)
    reqs, s_cont, l_cont, k_cont, _ = drive(
        torch, wf, dispatch, "serve-continuous",
        lambda: eng.run_schedule(qs, arrivals))
    st = eng.engine_stats()
    if [q.hits for q in reqs] != seq:
        raise AssertionError("continuous batching drifted from the "
                             "sequential rounds oracle")
    if l_cont != st["rounds"] or dispatch.STATS.dispatches != st["rounds"]:
        raise AssertionError(f"continuous: {l_cont} launches != "
                             f"{st['rounds']} merged rounds")
    if not st["rounds"] / len(qs) < seq_rounds / len(qs):
        raise AssertionError(f"shared rounds are not real: {st['rounds']}"
                             f" vs {seq_rounds} sequential")
    lat = eng.latency_stats()
    log("serve9-virtual", requests=len(qs), qps=16, eps=2.0,
        seq_rounds=seq_rounds, seq_rounds_per_q=f"{seq_rounds / len(qs):.3f}",
        merged_rounds=st["rounds"],
        merged_rounds_per_q=f"{st['rounds'] / len(qs):.3f}",
        p50=lat["p50"], p95=lat["p95"], p99=lat["p99"],
        mean_rounds=f"{lat['mean_rounds']:.2f}", seq_s=f"{s_seq:.2f}",
        seq_kernel_s=f"{k_seq:.4f}", cont_s=f"{s_cont:.2f}",
        cont_kernel_s=f"{k_cont:.4f}", launches=l_seq + l_cont)
    row = dict(seq_rounds=seq_rounds, merged_rounds=st["rounds"],
               requests=len(qs), p50=lat["p50"], p95=lat["p95"],
               p99=lat["p99"], seq_s=s_seq, cont_s=s_cont,
               cont_kernel_s=k_cont)
    launches = l_seq + l_cont

    # wall clock: 32 requests over about 8 s (a resize at cell A's size
    # takes about 5 s on the H100's host, so requests arrive and are in
    # flight on both sides of the swap), a background resize to 5 workers
    # started with them, and 32 more once the resharded clone has swapped
    # in; launches of both threads are checked against the dispatches of
    # both (no per-launch events)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-snap-") as d:
        eng2 = ServeEngine(fleet, ServeConfig(eps=2.0, snapshot_dir=d))
        dispatch.STATS.reset()
        wf.LAUNCHES = 0
        t0 = time.perf_counter()
        eng2.start()
        first = OpenLoopLoadGen(eng2, qs[:32], qps=4.0, seed=0).start()
        eng2.resize(FLEET_WORKERS + ["w4"], block=False)
        reqs = first.join(timeout=300)
        deadline = time.monotonic() + 300
        while eng2.swaps == 0 and eng2.error is None \
                and time.monotonic() < deadline:
            time.sleep(1e-3)
        swap_at = time.monotonic()   # the engine's clock
        t_swap = time.perf_counter() - t0
        second = OpenLoopLoadGen(eng2, qs[32:64], qps=32.0, seed=1).start()
        reqs = reqs + second.join(timeout=300)
        eng2.close(drain=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    wall_launches = wf.LAUNCHES
    failed = sum(1 for q in reqs if q.failed or not q.done)
    mismatched = sum(1 for q, want in zip(reqs, seq[:64])
                     if q.done and not q.failed and q.hits != want)
    if eng2.swaps != 1 or failed or mismatched or len(reqs) != 64:
        raise AssertionError(f"wall clock: swaps={eng2.swaps} "
                             f"failed={failed} mismatched={mismatched}")
    if wall_launches != dispatch.STATS.dispatches:
        raise AssertionError(f"wall clock: {wall_launches} launches != "
                             f"{dispatch.STATS.dispatches} dispatches of "
                             "both threads")
    st2 = eng2.engine_stats()
    before_swap = sum(1 for q in reqs[:32] if q.t_complete < swap_at)
    lat2 = eng2.latency_stats()
    log("serve9-wall", requests=len(reqs), failed=failed,
        mismatched=mismatched, swaps=eng2.swaps,
        workers_after=len(eng2.fleet.workers), swap_s=f"{t_swap:.2f}",
        wall_s=f"{wall:.2f}", serve_rounds=st2["rounds"],
        resize_dispatches=dispatch.STATS.dispatches - st2["rounds"],
        launches=wall_launches, p50_s=f"{lat2['p50']:.4f}",
        p99_s=f"{lat2['p99']:.4f}", first_batch_served_before_swap=
        before_swap)
    row.update(wall_s=wall, swap_s=t_swap, wall_p50=lat2["p50"],
               wall_p99=lat2["p99"], wall_launches=wall_launches)
    launches += wall_launches

    # the CLI once, on a small fleet on the card
    buf = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as d, \
            contextlib.redirect_stdout(buf):
        rc = serve_cli.main(["--n-windows", "2000", "--queries", "16",
                             "--qps", "64", "--snapshot-dir", d])
    out = json.loads(buf.getvalue())
    if rc != 0 or out["device"] != "cuda" or out["swaps"] != 1:
        raise AssertionError(f"serve CLI: rc={rc} {out}")
    log("serve9-cli", windows=out["windows"], requests=out["requests"],
        merged_rounds=out["merged_rounds"], swaps=out["swaps"],
        p50_ms=out["latency_p50_ms"], p99_ms=out["latency_p99_ms"],
        s=f"{time.perf_counter() - t0:.2f}")
    log("serve9-done", launches=launches,
        s=f"{time.perf_counter() - t_phase:.2f}")
    row["launches"] = launches
    return row


# -- phase 10: the paper's index comparison (Figs. 8 and 10) -----------------

#: ``benchmarks/bench_query.py``'s sweeps that this phase runs: row-name
#: prefix, distance, data generator, eps', range sizes
INDEX_SWEEPS = (
    ("fig8_proteins_lev", "levenshtein", "proteins", 1.0,
     (1.0, 2.0, 4.0, 8.0)),
    ("fig10_traj_erp", "erp", "trajectories", 2.0, (1.0, 2.0, 4.0)),
)
#: worker processes that evaluate the numpy-backend reference of the full
#: sweep while the card runs it (the card's machine has 8 cores)
INDEX_REF_WORKERS = 6


def index_configs(dist, eps_prime, **kw) -> dict:
    """The bench's six index variants (``bench_query._retrievers``)."""
    from repro_torch.retrieval import RetrievalConfig
    base = RetrievalConfig(dist, eps_prime=eps_prime, **kw)
    return {
        "rn": base,
        "rn5": base.replace(num_max=5),
        "rn_tight": base.replace(num_max=5, tight_bounds=True),
        "ct": base.replace(index="covertree"),
        "mv5": base.replace(index="mv", mv_refs=5),
        "mv50": base.replace(index="mv", mv_refs=50),
    }


def index_data(gen, n, n_queries):
    """A sweep's windows and its mutated queries (the bench's seeds)."""
    from repro_torch.data import synthetic
    data = getattr(synthetic, gen)(n, seed=0)
    return data, mutate(data, n_queries, seed=2)


def index_reference(sweep, label, n, n_queries) -> dict:
    """One variant of a sweep on the numpy host backend, in a worker
    process: build counts, then hits and counts of the batched engine per
    range size."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.set_num_threads(1)
    from repro_torch.retrieval import Retriever
    _, dist, gen, eps_prime, ranges = sweep
    data, qs = index_data(gen, n, n_queries)
    r = Retriever.build(index_configs(dist, eps_prime, backend="numpy",
                                      device="cpu")[label], data)
    out = {"build": r.eval_stats()["build"]}
    for eps in ranges:
        r.reset_counter()
        rs = r.batch(qs).via("batched").range(eps)
        out[eps] = (rs.hits, rs.stats["query"])
    return out


def index_query(torch, wf, dispatch, r, qs, eps, via, label):
    """One facade batch range query with the counts zeroed just before; its
    launches are held to its counted dispatches."""
    r.reset_counter()
    rs, s, launches, ks, _ = drive(torch, wf, dispatch, label,
                                   lambda: r.batch(qs).via(via).range(eps))
    if not launches == dispatch.STATS.dispatches == rs.stats["dispatches"]:
        raise AssertionError(f"{label}: {launches} launches, "
                             f"{rs.stats['dispatches']} counted dispatches")
    return rs, s, launches, ks


def phase_index_check(torch, wf, dispatch, dev) -> int:
    """Phase 10a: the bench's check size (n = 1200, 8 queries, sequential
    builds) on the card, every row held to ``BENCH_query.json``:
    ``evals_frac``, ``hits_per_query`` and ``dispatches``, and the engine
    rows' ``dispatches`` and ``rounds``.  Returns the launches."""
    from repro_torch.retrieval import Retriever
    bench = {row["name"]: row for row in
             json.loads((ROOT / "BENCH_query.json").read_text())}
    total = 0
    for sweep in INDEX_SWEEPS:
        prefix, dist, gen, eps_prime, ranges = sweep
        data, qs = index_data(gen, 1200, 8)
        N, nq = len(data), len(qs)
        t0 = time.perf_counter()
        rows = 0
        built = {}
        for label, cfg in index_configs(dist, eps_prime, bulk_build=False,
                                        device=str(dev)).items():
            r, s, launches, ks, _ = drive(
                torch, wf, dispatch, f"index10-check-{label}",
                lambda: Retriever.build(cfg, data))
            if launches != r.eval_stats()["build_dispatches"]:
                raise AssertionError(f"{prefix} {label} build: {launches} "
                                     "launches != build dispatches")
            total += launches
            built[label] = r
        for eps in ranges:
            base = None
            for label, r in built.items():
                name = f"{prefix}_eps{eps}_{label}"
                host, _, l1, _ = index_query(torch, wf, dispatch, r, qs, eps,
                                             "host", name)
                eng, _, l2, _ = index_query(torch, wf, dispatch, r, qs, eps,
                                            "batched", name + "_engine")
                total += l1 + l2
                hits = sum(len(h) for h in host.hits)
                base = hits if base is None else base
                frac = round(host.stats["query"] / (nq * N), 4)
                if hits != base or eng.hits != host.hits \
                        or eng.stats["query"] != host.stats["query"]:
                    raise AssertionError(f"{name}: hits or counts disagree "
                                         "across variants or engines")
                got = {name: dict(evals_frac=frac,
                                  hits_per_query=round(hits / nq, 1),
                                  dispatches=host.stats["dispatches"]),
                       name + "_engine": dict(
                           evals_frac=frac,
                           dispatches=eng.stats["dispatches"],
                           rounds=eng.stats["rounds"])}
                for key, vals in got.items():
                    want = {k: bench[key][k] for k in vals}
                    if vals != want:
                        raise AssertionError(f"{key}: {vals} != "
                                             f"BENCH_query.json {want}")
                    rows += 1
        log("index10-check", sweep=prefix, windows=N, queries=nq,
            variants=len(built), rows_held=rows,
            s=f"{time.perf_counter() - t0:.2f}")
    return total


def phase_index_full(torch, wf, dispatch, args, dev, refs) -> int:
    """Phase 10b: the bench's full size on the card (default bulk build):
    each variant's build seconds (host / kernel), its space (``stats()``)
    and per range size its evaluation fraction and seconds, by host and
    batched execution; hits and ``{query, build}`` counts held to the numpy
    host backend (``refs``: futures of :func:`index_reference`).  The cover
    tree also flattens to a FlatNet whose device query must return the
    host's hits.  Returns the launches."""
    from repro_torch.retrieval import Retriever
    n, nq = args.windows_index, args.queries_index
    total = 0
    for sweep in INDEX_SWEEPS:
        prefix, dist, gen, eps_prime, ranges = sweep
        data, qs = index_data(gen, n, nq)
        N = len(data)
        for label, cfg in index_configs(dist, eps_prime,
                                        device=str(dev)).items():
            r, s, launches, ks, _ = drive(
                torch, wf, dispatch, f"index10-{label}",
                lambda: Retriever.build(cfg, data))
            st = r.eval_stats()
            if launches != st["build_dispatches"]:
                raise AssertionError(f"{prefix} {label} build: {launches} "
                                     "launches != build dispatches")
            total += launches
            space = r.index.stats()
            entries = space.get("n_list_entries", space.get("table_entries"))
            log("index10-build", sweep=prefix, index=label, windows=N,
                build_s=f"{s:.2f}", host_s=f"{s - ks:.2f}",
                kernel_s=f"{ks:.4f}", build_evals=st["build"],
                launches=launches, size_bytes=space["size_bytes"],
                entries=entries)
            ref = refs[(prefix, label)].result()
            if ref["build"] != st["build"]:
                raise AssertionError(f"{prefix} {label}: build evals "
                                     f"{st['build']} != numpy {ref['build']}")
            host_hits = {}
            for eps in ranges:
                name = f"{prefix}_eps{eps}_{label}"
                host, hs, l1, hk = index_query(torch, wf, dispatch, r, qs,
                                               eps, "host", name)
                eng, es, l2, ek = index_query(torch, wf, dispatch, r, qs,
                                              eps, "batched", name)
                total += l1 + l2
                want_hits, want_q = ref[eps]
                if not host.hits == eng.hits == want_hits or \
                        not host.stats["query"] == eng.stats["query"] \
                        == want_q:
                    raise AssertionError(f"{name}: hits or query evals "
                                         "differ from the numpy backend")
                log("index10-query", sweep=prefix, index=label, eps=eps,
                    queries=nq, evals_frac=f"{want_q / (nq * N):.4f}",
                    hits=sum(len(h) for h in host.hits),
                    host_s=f"{hs:.3f}", host_kernel_s=f"{hk:.4f}",
                    host_dispatches=host.stats["dispatches"],
                    batched_s=f"{es:.3f}", batched_kernel_s=f"{ek:.4f}",
                    rounds=eng.stats["rounds"])
                host_hits[eps] = host.hits
            if label == "ct":
                total += index_ct_flat(torch, wf, dispatch, r, qs, host_hits,
                                       prefix, dev)
    return total


def index_ct_flat(torch, wf, dispatch, r, qs, host_hits, prefix, dev):
    """The cover tree flattened to a FlatNet (as ``flat_net()`` does) and
    queried on the card in one stacked query per range size: its hits must
    equal the host's.  Each query launches once for the query x pivot rows
    and once more when a survivor is left.  Returns the launches."""
    import numpy as np
    from repro_torch.core.distributed import device_range_query, flatten_net
    flat, _, total, _, _ = drive(torch, wf, dispatch, "index10-ct-flat",
                                 lambda: flatten_net(r.index))
    if total != dispatch.STATS.dispatches:
        raise AssertionError(f"{prefix}: flattening launched {total} times "
                             f"for {dispatch.STATS.dispatches} dispatches")
    for eps, hits in host_hits.items():
        (got, st), s, launches, _, _ = drive(
            torch, wf, dispatch, "index10-ct-device",
            lambda: device_range_query(flat, qs, eps, device=dev))
        want = np.zeros(got.shape, bool)
        for i, h in enumerate(hits):
            want[i, h] = True
        if not np.array_equal(got, want):
            raise AssertionError(f"{prefix} eps={eps}: the flattened cover "
                                 "tree's device query differs from the "
                                 "host's hits")
        if launches != 1 + int(st["member_evals"] > 0) \
                or dispatch.STATS.dispatches:
            raise AssertionError(f"{prefix} eps={eps}: the device query "
                                 f"launched {launches} times")
        total += launches
        log("index10-ct-device", sweep=prefix, eps=eps, pivots=flat.n_pivots,
            member_evals=st["member_evals"], s=f"{s:.3f}",
            launches=launches, hits_equal=True)
    return total


def phase_index(torch, wf, dispatch, args, dev) -> int:
    """Phase 10: the bench's check size against ``BENCH_query.json``, then
    its full size against the numpy backend, whose worker processes start
    first and run while the card works.  Returns the launches."""
    import concurrent.futures
    import multiprocessing
    t_phase = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            INDEX_REF_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        refs = {(sweep[0], label): pool.submit(
                    index_reference, sweep, label, args.windows_index,
                    args.queries_index)
                for sweep in INDEX_SWEEPS
                for label in index_configs(sweep[1], sweep[3],
                                           device="cpu")}
        total = phase_index_check(torch, wf, dispatch, dev)
        total += phase_index_full(torch, wf, dispatch, args, dev, refs)
    log("index10-done", launches=total,
        s=f"{time.perf_counter() - t_phase:.2f}")
    return total


# -- phase 11: training at full width -----------------------------------------

#: the step that the injected failure stops, and the tolerance the resumed
#: run's parameters are held to against the uninterrupted run's: the two
#: replay the same batches through the same kernels, so they differ only
#: where a kernel sums in an order that can vary between runs
FAIL_AT = 13
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6


class CounterLog:
    """Records every ``CountedDistance`` made while it is entered, with the
    seconds its construction took (on the card: uploading the window
    table).  ``dedup_corpus`` builds a new counter for each document it
    keeps, so its dispatches are summed over all of them."""

    def __init__(self, torch):
        self.torch = torch
        self.counters = []
        self.init_s = 0.0

    def __enter__(self):
        from repro_torch.core import counter as counter_mod
        self._mod, self._orig = counter_mod, counter_mod.CountedDistance
        log_ = self

        class Logged(self._orig):
            def __init__(self, *a, **kw):
                t0 = time.perf_counter()
                super().__init__(*a, **kw)
                log_.torch.cuda.synchronize()
                log_.init_s += time.perf_counter() - t0
                log_.counters.append(self)

        counter_mod.CountedDistance = Logged
        return self

    def __exit__(self, *exc):
        self._mod.CountedDistance = self._orig

    def totals(self):
        cs = self.counters
        return (sum(c.dispatches + c.build_dispatches for c in cs),
                sum(c.count + c.build_count for c in cs))


def phase_train(torch, wf, dispatch, args, dev) -> dict:
    """Phase 11: ``launch/train.py`` for smollm-360m at its published
    widths (f32, ``remat="block"``) with ``--dedup``, the same run stopped
    by an injected failure and resumed, then the example's tail: the
    trained network's windows indexed and a near-duplicate probed."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core.embedding_retrieval import embed_windows
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry as models
    from repro_torch.retrieval import RetrievalConfig, Retriever
    t_phase = time.perf_counter()
    cfg, mod = models.get("smollm-360m")
    if cfg.remat != "block":
        raise AssertionError(f"smollm-360m trains with remat={cfg.remat!r}")
    steps, batch, seq = args.train_steps, 8, 128
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        def argv(name):
            return ["--device", str(dev), "--steps", str(steps), "--batch",
                    str(batch), "--seq", str(seq), "--dedup",
                    "--dedup-docs", str(args.dedup_docs), "--log-every",
                    "1", "--ckpt-every", str(10 * steps), "--ckpt-dir",
                    str(tmp / name)]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with CounterLog(torch) as cl:
            out, s, launches, ks, rows = drive(
                torch, wf, dispatch, "train11-cli",
                lambda: train_cli.main(argv("run")))
        peak = torch.cuda.max_memory_allocated(dev)
        shutil.rmtree(tmp / "run")  # one full-width checkpoint: 5.8 GB
        dispatches, evals = cl.totals()
        if not launches == dispatch.STATS.dispatches == dispatches:
            raise AssertionError(f"dedup: {launches} launches, {dispatches} "
                                 "counted dispatches")
        if args.dedup_docs >= 70 and len(out["corpus"]) >= args.dedup_docs:
            raise AssertionError("dedup: the planted near-duplicate of "
                                 "document 52 was kept")
        log("train11-dedup", docs_in=args.dedup_docs,
            kept=len(out["corpus"]),
            s=f"{out['corpus_s']:.2f}",
            host_s=f"{out['corpus_s'] - ks:.2f}", kernel_s=f"{ks:.4f}",
            evals=evals, launches=launches, dispatches=dispatches,
            counters=len(cl.counters), table_upload_s=f"{cl.init_s:.3f}",
            rows_mean=f"{np.mean(rows):.0f}", rows_max=max(rows))

        lg = out["log"]
        losses = [e["loss"] for e in lg]
        step_s = [e["step_s"] for e in lg]
        if out["final_step"] != steps or len(lg) != steps \
                or not np.isfinite(losses).all() or losses[-1] >= losses[0]:
            raise AssertionError(f"training: {out['final_step']} steps, "
                                 f"losses {losses}")
        med = float(np.median(step_s[1:]))
        log("train11-steps", arch=cfg.name, layers=cfg.n_layers,
            d_model=cfg.d_model, vocab=cfg.vocab, dtype="float32",
            remat=cfg.remat, batch=batch, seq=seq, steps=steps,
            loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}",
            first_step_s=f"{step_s[0]:.3f}", step_s_median=f"{med:.4f}",
            tokens_per_s=f"{batch * seq / med:.0f}",
            peak_bytes=peak, total_s=f"{s:.2f}")

        # the same run, stopped by a failure at step FAIL_AT and resumed
        # from its emergency checkpoint
        class Injected(RuntimeError):
            pass

        def inject(step):
            if step == FAIL_AT:
                raise Injected(step)

        targs = train_cli.parser().parse_args(argv("resume"))
        t0 = time.perf_counter()
        try:
            train_cli.trainer_for(targs, cfg, mod, out["corpus"],
                                  failure_injector=inject).run()
        except Injected:
            pass
        else:
            raise AssertionError("the injected failure did not fire")
        resumed = train_cli.trainer_for(targs, cfg, mod,
                                        out["corpus"]).run()
        fail_s = time.perf_counter() - t0
        if resumed["log"][0]["step"] != FAIL_AT + 1 \
                or resumed["final_step"] != steps:
            raise AssertionError(f"resume: first logged step "
                                 f"{resumed['log'][0]['step']}, final "
                                 f"{resumed['final_step']}")
        want, got = out["params"].state_dict(), \
            resumed["params"].state_dict()
        diffs = {k: float((got[k] - want[k]).abs().max()) for k in want}
        worst = max(diffs.values())
        for k in want:
            if not torch.allclose(got[k], want[k], rtol=RESUME_RTOL,
                                  atol=RESUME_ATOL):
                raise AssertionError(f"resume: {k} differs by {diffs[k]}")
        log("train11-resume", fail_at=FAIL_AT, s=f"{fail_s:.2f}",
            max_abs_diff=worst, rtol=RESUME_RTOL, atol=RESUME_ATOL)
        del resumed, got

        # the example's tail: index the trained network's hidden-state
        # windows and probe with a near-duplicate sequence
        rng = np.random.default_rng(5)
        seqs = [out["corpus"][i, :96]
                for i in range(min(12, len(out["corpus"])))]
        dup = seqs[3].copy()
        flips = rng.random(dup.shape) < 0.05
        dup[flips] = rng.integers(0, cfg.vocab, flips.sum())
        seqs.append(dup)
        vecs, meta = embed_windows(mod, out["params"], cfg, seqs, window=16,
                                   device=dev)
        ret = Retriever.build(RetrievalConfig(
            "euclidean", index="embedding", eps_prime=0.02, num_max=5,
            tight_bounds=True, device=str(dev)), vecs)
        probe = next(i for i, m in enumerate(meta)
                     if m.seq_id == len(seqs) - 1)
        near = ret.query(vecs[probe]).nearest(2.0, tol=1e-3)
        others = ret.query(vecs[probe]).range(0.5).hits
        if not near or probe not in others or not np.isfinite(vecs).all():
            raise AssertionError("the near-duplicate probe retrieved "
                                 "nothing")
        twin = next(i for i, m in enumerate(meta)
                    if m.seq_id == 3 and m.start == meta[probe].start)
        win = meta[near.first]
        log("train11-embed", windows=len(vecs), probe_seq=len(seqs) - 1,
            nearest=f"seq{win.seq_id}@{win.start}",
            d=f"{near.distances[0]:.4f}", in_range_0_5=len(others),
            twin_in_range=twin in others,
            evals=ret.eval_stats()["query"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("train11-done", launches=launches,
        s=f"{time.perf_counter() - t_phase:.2f}")
    return dict(launches=launches, loss_first=losses[0],
                loss_last=losses[-1], step_s=med)


# -- phase 12: decode on the LM stack ------------------------------------------

#: the reference's decode-equals-forward tolerance
#: (tests/test_models_smoke.py::test_decode_matches_forward)
DECODE_RTOL, DECODE_ATOL = 2e-2, 2e-3
#: greedy steps checked against a full forward over the growing sequence
GREEDY_STEPS = 8


def sync_s(torch, t0) -> float:
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def build_model(torch, mod, cfg, dtype, dev, seed):
    """A model of ``cfg`` with seeded random weights drawn on the card (the
    reference's fan-in rule): the layout tree is drawn, handed to ``build``
    and dropped, so only the linear layers' transposed copies exist twice,
    for a moment."""
    from repro_torch.models.params import init_params
    gen = torch.Generator(dev).manual_seed(seed)
    tree = init_params(mod.param_defs(cfg), gen, dtype, dev)
    model = mod.build(cfg, tree, dtype=dtype, device=dev)
    del tree
    return model


def logits_of(out):
    return out[0] if isinstance(out, tuple) else out


def decode_parity(torch, mod, model, cfg, tokens, label):
    """The reference's check: ``decode_step`` after a prefill of S-1 tokens
    gives ``forward``'s logits at S-1.  Returns the largest difference."""
    from repro_torch.models.common import grow_cache
    S = tokens.shape[1]
    full = logits_of(mod.forward(model, {"tokens": tokens}, cfg))
    cache = mod.forward(model, {"tokens": tokens[:, :S - 1]}, cfg,
                        return_cache=True)[-1]
    lg, cache = mod.decode_step(model, grow_cache(cache, S + 8),
                                tokens[:, S - 1:S], cfg)
    want = full[:, S - 1]
    err = float((lg[:, 0] - want).abs().max())
    if not torch.allclose(lg[:, 0], want, rtol=DECODE_RTOL,
                          atol=DECODE_ATOL) or int(cache["pos"]) != S - 1:
        raise AssertionError(f"{label}: decode differs from forward by {err}")
    return err, float(want.abs().max())


def greedy_parity(torch, mod, model, cfg, prompt):
    """GREEDY_STEPS greedy decode steps give the tokens of the argmax of a
    full forward over the growing sequence; returns the largest logit
    difference and the smallest top-2 margin of the forward's logits."""
    from repro_torch.models.common import grow_cache
    P = prompt.shape[1]
    logits, cache = mod.forward(model, {"tokens": prompt}, cfg,
                                return_cache=True)
    cache = grow_cache(cache, P + GREEDY_STEPS + 1)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    seq = torch.cat([prompt, tok], dim=1)
    worst, margin = 0.0, float("inf")
    for step in range(GREEDY_STEPS):
        lg, cache = mod.decode_step(model, cache, tok, cfg)
        full = mod.forward(model, {"tokens": seq}, cfg)[:, -1]
        worst = max(worst, float((lg[:, 0] - full).abs().max()))
        top2 = full.topk(2, dim=-1).values
        margin = min(margin, float((top2[:, 0] - top2[:, 1]).min()))
        tok = lg[:, 0].argmax(-1, keepdim=True)
        if not torch.equal(tok[:, 0], full.argmax(-1)):
            raise AssertionError(f"greedy step {step}: decode chose "
                                 f"{tok[:, 0].tolist()}, forward "
                                 f"{full.argmax(-1).tolist()}")
        if not torch.allclose(lg[:, 0], full, rtol=DECODE_RTOL,
                              atol=DECODE_ATOL):
            raise AssertionError(f"greedy step {step}: logits differ by "
                                 f"{worst}")
        seq = torch.cat([seq, tok], dim=1)
    return worst, margin


def cache_len(cache) -> float:
    """Positions the cache holds: the length of its sequence-indexed
    entries (``common.seq_indexed``), infinite for an SSM's conv window and
    state, which hold no positions."""
    from repro_torch.models.common import seq_indexed
    return min((v.shape[2] for k, v in cache.items()
                if seq_indexed(k) and v is not None), default=float("inf"))


def cache_bytes(cache) -> int:
    return sum(v.numel() * v.element_size() for k, v in cache.items()
               if k != "pos" and v is not None)


def timed_decode(torch, mod, model, cfg, B, P, steps, dev, rng, drops=None,
                 spans=()):
    """Prefill ``B`` prompts of ``P`` tokens and decode ``steps`` greedy
    tokens, after a short untimed warm-up.  Returns the seconds of the
    prefill, of the cache's growth and of the decode, the final cache's
    bytes (the last step's logits must be finite) and the
    :func:`profile_step` of one more step (with ``spans``).  ``drops`` (a
    :class:`MoeProbe`) marks the prefill and the decode."""
    from repro_torch.models.common import grow_cache
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)),
                             device=dev)
    warm = mod.forward(model, {"tokens": prompt[:, :16]}, cfg,
                       return_cache=True)[-1]
    warm = grow_cache(warm, 18)
    for _ in range(2):
        _, warm = mod.decode_step(model, warm, prompt[:, :1], cfg)
    del warm
    if drops is not None:
        drops.mark("warm-up")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = mod.forward(model, {"tokens": prompt}, cfg, return_cache=True)
    prefill_s = sync_s(torch, t0)
    if drops is not None:
        drops.mark("prefill")
    t0 = time.perf_counter()
    cache = grow_cache(out[-1], P + steps + 1)
    grow_s = sync_s(torch, t0)
    tok = logits_of(out)[:, -1].argmax(-1, keepdim=True)
    del out
    t0 = time.perf_counter()
    for _ in range(steps):
        lg, cache = mod.decode_step(model, cache, tok, cfg)
        tok = lg[:, 0].argmax(-1, keepdim=True)
    decode_s = sync_s(torch, t0)
    if drops is not None:
        drops.mark("decode")
    # one more step, traced: the card's busy time within a step
    if int(cache["pos"]) + 1 < cache_len(cache):
        busy = profile_step(torch, lambda: mod.decode_step(model, cache, tok,
                                                           cfg), spans)
    else:
        busy = (float("nan"), 0, float("nan"), {})
    if int(cache["pos"]) != P - 1 + steps or not bool(
            torch.isfinite(lg).all()):
        raise AssertionError(f"decode ended at pos {int(cache['pos'])}, "
                             f"finite logits {bool(torch.isfinite(lg).all())}")
    return prefill_s, grow_s, decode_s, cache_bytes(cache), busy


def profile_step(torch, fn, spans=()) -> tuple:
    """One call of ``fn`` under ``torch.profiler`` with CUDA activity:
    (the summed device time of its kernels in ms, the number of kernels
    and copies, the wall ms of the traced call, the device ms of each
    span).  The device time over the wall time is the share the card is
    busy.  ``spans`` are ``(module, function name)`` pairs: while traced,
    each such function runs inside a ``record_function`` range of its name,
    and the device time of the kernels launched inside is summed by
    name."""
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = []
    for module, name in spans:
        orig = getattr(module, name)

        def inside(*a, _orig=orig, _name=name, **kw):
            with record_function(_name):
                return _orig(*a, **kw)

        saved.append((module, name, orig))
        setattr(module, name, inside)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall = sync_s(torch, t0) * 1e3
    finally:
        for module, name, orig in saved:
            setattr(module, name, orig)
    names = {name for _, name in spans}
    dev_us, n, span_us = 0.0, 0, dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name not in names:  # not a range's own device-side mark
                dev_us += e.time_range.elapsed_us()
                n += 1
        elif e.name in names:  # the host range: its kernels, children's too
            span_us[e.name] += e.device_time_total
    silent = sorted(k for k, v in span_us.items() if not v > 0)
    if silent:  # called under another name, or not at all
        raise AssertionError(f"profile: no device time inside {silent}")
    return dev_us / 1e3, n, wall, {k: v / 1e3 for k, v in span_us.items()}


def kept_oracle(idx, E: int, capacity: int) -> set:
    """Token-major first-come ranks in plain Python: assignment ``(t, e)``
    is kept while expert ``e`` has fewer than ``capacity`` earlier ones."""
    seen, kept = [0] * E, set()
    for t, row in enumerate(idx.tolist()):
        for e in row:
            if seen[e] < capacity:
                kept.add((t, e))
            seen[e] += 1
    return kept


def balanced_drop_share(rng, T: int, k: int, E: int, capacity: int,
                        trials: int = 4) -> float:
    """The share of assignments the capacity dispatch would drop if every
    token drew its ``k`` experts uniformly and independently of the
    others: what a balanced router loses at this capacity."""
    dropped = 0
    for _ in range(trials):
        idx = rng.random((T, E)).argsort(axis=1)[:, :k]
        dropped += T * k - len(kept_oracle(idx, E, capacity))
    return dropped / (trials * T * k)


class MoeProbe:
    """Keeps, while entered, what the MoE layers route
    (``models.layers.moe_router`` and ``moe_dispatch`` wrapped): each
    router's input rows and weight, and each dispatch's expert ids and
    token buffer, by stretches closed with :meth:`mark`.  Nothing is
    computed while the model runs (references only); :meth:`check` holds
    every kept set to :func:`kept_oracle` afterwards, and :meth:`stats`
    reads drops, loads and the correlation of the routing."""

    def __enter__(self):
        from repro_torch.models import layers
        self._mod = layers
        self._router, self._dispatch = layers.moe_router, layers.moe_dispatch
        self.routers = []   # (x, wr) per router call
        self.calls = []     # (idx, buf_t, n_experts, capacity) per dispatch
        self.marks = {}     # name -> (first call, end call)
        self._start = 0

        def router(x, wr, top_k):
            self.routers.append((x, wr))
            return self._router(x, wr, top_k)

        def dispatch(gates, idx, n_experts, capacity, expert_offset=0):
            buf_t, buf_g = self._dispatch(gates, idx, n_experts, capacity,
                                          expert_offset)
            self.calls.append((idx, buf_t, n_experts, capacity))
            return buf_t, buf_g

        layers.moe_router, layers.moe_dispatch = router, dispatch
        return self

    def __exit__(self, *exc):
        self._mod.moe_router = self._router
        self._mod.moe_dispatch = self._dispatch

    def mark(self, name: str) -> None:
        self.marks[name] = (self._start, len(self.calls))
        self._start = len(self.calls)

    def check(self) -> int:
        """Every dispatch kept exactly the oracle's assignments; returns
        the number of dispatches checked."""
        for n, (idx, buf_t, E, cap) in enumerate(self.calls):
            bt = buf_t.cpu().numpy()
            kept = {(int(t) - 1, e) for e in range(E) for t in bt[e] if t}
            want = kept_oracle(idx.cpu().numpy(), E, cap)
            if kept != want:
                raise AssertionError(
                    f"moe dispatch {n} (T={idx.shape[0]}, capacity {cap}): "
                    f"{len(kept ^ want)} assignments differ from the "
                    "token-major oracle")
        return len(self.calls)

    def dropped_share(self, name: str) -> float:
        a, b = self.marks[name]
        assigned = sum(c[0].numel() for c in self.calls[a:b])
        kept = sum(int((c[1] > 0).sum()) for c in self.calls[a:b])
        return (assigned - kept) / max(assigned, 1)

    def stats(self, torch, name: str) -> dict:
        """Per MoE layer of stretch ``name``: the capacity, the largest
        expert load, the experts loaded past capacity, the mean pairwise
        cosine of the router's input rows and the mean pairwise correlation
        of the tokens' router logits (0 when tokens route independently)."""
        a, b = self.marks[name]

        def mean_pair(rows):
            rows = rows / rows.norm(dim=1, keepdim=True).clamp_min(1e-30)
            T, tot = rows.shape[0], rows.sum(dim=0)
            return float((tot @ tot - T) / (T * (T - 1)))

        out = {k: [] for k in ("capacity", "max_load", "over_capacity",
                               "input_cos", "logit_corr")}
        for (idx, _, E, cap), (x, wr) in zip(self.calls[a:b],
                                             self.routers[a:b]):
            load = torch.bincount(idx.reshape(-1), minlength=E)
            logits = (x.float() @ wr.float().T)
            out["capacity"].append(cap)
            out["max_load"].append(int(load.max()))
            out["over_capacity"].append(int((load > cap).sum()))
            out["input_cos"].append(round(mean_pair(x.float()), 4))
            out["logit_corr"].append(round(mean_pair(
                logits - logits.mean(dim=1, keepdim=True)), 4))
        return out


def phase_decode(torch, wf, pl2, args, dev) -> dict:
    """Phase 12: the LM stack's decode path.  (a) qwen3-4b whole at its
    published widths: decode held to forward in f32 (one step after a
    prefill, then greedy steps), then prefill and decode timed in bf16.
    (b) deepseek-v2-236b at its published widths, depth cut: the same check
    in f32 at 1 dense + 1 MoE layer with ``capacity_factor=100`` (no drops),
    then timed in bf16 at 1 dense + ``--moe-layers`` MoE layers at the
    default capacity factor, with the share of routed assignments dropped.
    Each model is freed before the next is built.  The path launches
    neither hand-written kernel (checked with the counts zeroed)."""
    import dataclasses
    import gc
    import numpy as np
    from repro_torch.models import registry as models
    from repro_torch.roofline import costs
    t_phase = time.perf_counter()
    rng = np.random.default_rng(12)
    wf.LAUNCHES = pl2.LAUNCHES = 0
    out = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # (a) qwen3-4b, whole
    cfg, mod = models.get("qwen3-4b")
    t0 = time.perf_counter()
    model = build_model(torch, mod, cfg, torch.float32, dev, seed=12)
    build_s = sync_s(torch, t0)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 33)), device=dev)
    err, scale = decode_parity(torch, mod, model, cfg, tokens, "qwen3-4b")
    g_err, margin = greedy_parity(torch, mod, model, cfg, tokens[:, :16])
    log("decode12-qwen3-parity", layers=cfg.n_layers, d_model=cfg.d_model,
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}",
        qk_norm=cfg.qk_norm, vocab=cfg.vocab, params=n_params,
        dtype="float32", build_s=f"{build_s:.2f}", decode_max_abs_err=err,
        logit_scale=f"{scale:.3f}", greedy_steps=GREEDY_STEPS,
        greedy_max_abs_err=g_err, greedy_min_top2_margin=f"{margin:.4g}",
        rtol=DECODE_RTOL, atol=DECODE_ATOL)
    del model
    free()
    model = build_model(torch, mod, cfg, torch.bfloat16, dev, seed=12)
    build_peak = torch.cuda.max_memory_allocated(dev)
    B, P, steps = args.decode_batch, args.prompt_len, args.decode_steps
    torch.cuda.reset_peak_memory_stats(dev)
    pre_s, grow_s, dec_s, cb, busy = timed_decode(torch, mod, model, cfg, B,
                                                  P, steps, dev, rng)
    nbytes, wbytes = costs.decode_step_bytes(model, cb)
    bound = costs.bytes_ms(nbytes)
    peak = torch.cuda.max_memory_allocated(dev)
    ms = dec_s / steps * 1e3
    log("decode12-qwen3-timed", dtype="bfloat16", batch=B, prompt=P,
        steps=steps, prefill_s=f"{pre_s:.4f}",
        prefill_tokens_per_s=f"{B * P / pre_s:.0f}",
        grow_cache_s=f"{grow_s:.4f}", decode_ms_per_step=f"{ms:.3f}",
        decode_tokens_per_s=f"{B * steps / dec_s:.0f}",
        step_bound_ms=f"{bound:.3f}", bound_share=f"{bound / ms:.3f}",
        traced_step_device_ms=f"{busy[0]:.3f}", traced_step_kernels=busy[1],
        traced_step_wall_ms=f"{busy[2]:.3f}",
        weight_bytes=wbytes, cache_bytes=cb, build_peak_bytes=build_peak,
        peak_bytes=peak)
    out["qwen3"] = dict(prefill_s=pre_s, decode_ms=ms, bound_ms=bound,
                        peak=peak, busy=busy)
    del model
    free()

    # (b) deepseek-v2-236b at its published widths, depth cut
    full, mod = models.get("deepseek-v2-236b")
    nd = full.first_dense_layers
    cfg = dataclasses.replace(full, n_layers=nd + 1, capacity_factor=100.0)
    t0 = time.perf_counter()
    model = build_model(torch, mod, cfg, torch.float32, dev, seed=13)
    build_s = sync_s(torch, t0)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)), device=dev)
    err, scale = decode_parity(torch, mod, model, cfg, tokens, "deepseek-v2")
    peak = torch.cuda.max_memory_allocated(dev)
    log("decode12-deepseek-parity", layers=f"{nd}+{cfg.n_layers - nd}",
        d_model=cfg.d_model, experts=f"{cfg.n_experts}+"
        f"{cfg.n_shared_experts} top{cfg.top_k}", q_lora=cfg.q_lora,
        kv_lora=cfg.kv_lora, params=n_params, dtype="float32",
        capacity_factor=cfg.capacity_factor, build_s=f"{build_s:.2f}",
        decode_max_abs_err=err, logit_scale=f"{scale:.3f}",
        rtol=DECODE_RTOL, atol=DECODE_ATOL, peak_bytes=peak)
    del model
    free()
    cfg = dataclasses.replace(full, n_layers=nd + args.moe_layers)
    t0 = time.perf_counter()
    model = build_model(torch, mod, cfg, torch.bfloat16, dev, seed=13)
    build_s = sync_s(torch, t0)
    build_peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(p.numel() for p in model.parameters())
    B, P, steps = args.decode_batch, args.prompt_len // 2, \
        args.decode_steps // 2
    torch.cuda.reset_peak_memory_stats(dev)
    with MoeProbe() as drops:
        pre_s, grow_s, dec_s, cb, busy = timed_decode(
            torch, mod, model, cfg, B, P, steps, dev, rng, drops)
    checked = drops.check()
    route = drops.stats(torch, "prefill")
    T = B * P
    balanced = balanced_drop_share(rng, T, cfg.top_k, cfg.n_experts,
                                   route["capacity"][0])
    nbytes, wbytes = costs.decode_step_bytes(model, cb)
    bound = costs.bytes_ms(nbytes)
    peak = torch.cuda.max_memory_allocated(dev)
    if max(build_peak, peak) >= 80e9:
        raise AssertionError(f"deepseek-v2 cut: peak memory "
                             f"{max(build_peak, peak)} bytes")
    ms = dec_s / steps * 1e3
    log("decode12-deepseek-timed", layers=f"{nd}+{args.moe_layers}",
        params=n_params, dtype="bfloat16", build_s=f"{build_s:.2f}",
        capacity_factor=cfg.capacity_factor, batch=B, prompt=P, steps=steps,
        prefill_s=f"{pre_s:.4f}",
        prefill_tokens_per_s=f"{B * P / pre_s:.0f}",
        decode_ms_per_step=f"{ms:.3f}",
        decode_tokens_per_s=f"{B * steps / dec_s:.0f}",
        step_bound_ms=f"{bound:.3f}", bound_share=f"{bound / ms:.3f}",
        traced_step_device_ms=f"{busy[0]:.3f}", traced_step_kernels=busy[1],
        traced_step_wall_ms=f"{busy[2]:.3f}",
        prefill_dropped_share=f"{drops.dropped_share('prefill'):.4f}",
        decode_dropped_share=f"{drops.dropped_share('decode'):.4f}",
        kept_sets_equal_oracle=checked,
        balanced_router_dropped_share=f"{balanced:.4f}",
        prefill_capacity=route["capacity"],
        prefill_max_expert_load=route["max_load"],
        prefill_experts_over_capacity=route["over_capacity"],
        prefill_router_input_cos=route["input_cos"],
        prefill_router_logit_corr=route["logit_corr"],
        weight_bytes=wbytes, cache_bytes=cb, build_peak_bytes=build_peak,
        peak_bytes=peak)
    out["deepseek"] = dict(prefill_s=pre_s, decode_ms=ms, bound_ms=bound,
                           peak=peak, busy=busy,
                           dropped=(drops.dropped_share("prefill"),
                                    drops.dropped_share("decode")))
    del model
    free()
    out["launches"] = {"wavefront": wf.LAUNCHES, "pairwise_l2": pl2.LAUNCHES}
    if any(out["launches"].values()):
        raise AssertionError(f"decode: hand-written kernels launched "
                             f"{out['launches']}")
    log("decode12-done", launches_wavefront=wf.LAUNCHES,
        launches_pairwise_l2=pl2.LAUNCHES,
        s=f"{time.perf_counter() - t_phase:.2f}")
    return out


# -- phase 13: Mamba2 and the Zamba2 hybrid -----------------------------------

#: the SSM families of phase 13, with the seed of their weights
SSM_ARCHS = (("mamba2-370m", 21), ("zamba2-1.2b", 22))
#: prompts of the f32 parity checks: one chunk, and 300 tokens (padded to
#: three chunks of 128)
SSM_PARITY_PROMPTS = (32, 300)
#: cache lengths of the long decode, the last ``SHAPES["long_500k"]``'s
LONG_LENGTHS = (32_768, 131_072)
#: untimed and timed steps of a long decode at each cache length
LONG_WARM, LONG_STEPS = 2, 16
#: training steps of mamba2-370m (through the train CLI) and zamba2-1.2b
SSM_TRAIN_STEPS, HYBRID_TRAIN_STEPS = 10, 3
#: phase 13's embedding run takes 1 / this of ``--embed-docs`` (at the
#: whole count its host-bound index build took 72-97 s of a script that
#: reached 957.67 s on a slow host)
SSM_EMBED_SHARE = 2


def span_text(span_ms: dict) -> str:
    """``name:ms,...`` of :func:`profile_step`'s spans."""
    return ",".join(f"{k}:{v:.3f}" for k, v in sorted(span_ms.items()))


class KVWrites:
    """Keeps, while entered, the last write of ``hybrid.update_cache`` (the
    KV caches' one write a decode step): the cache, what was written and at
    which position, so the write can be read back."""

    def __enter__(self):
        from repro_torch.models import hybrid
        self._mod, self._orig = hybrid, hybrid.update_cache
        self.last = {}

        def update(cache, new, pos, *args, **kwargs):
            self.last[id(cache)] = (new, pos)
            return self._orig(cache, new, pos, *args, **kwargs)

        hybrid.update_cache = update
        return self

    def __exit__(self, *exc):
        self._mod.update_cache = self._orig


def long_decode(torch, mod, model, cfg, S, steps, dev, seed):
    """One sequence decoding against a cache of ``S`` positions without a
    prefill: every cache entry filled with seeded normal values (the SSM
    state in f32, as a prefill leaves it), ``pos`` at ``S - steps -
    LONG_WARM - 2``, so the warm-up, the ``steps`` timed steps and one
    traced step write the cache's last positions.  Checks finite logits,
    ``pos`` advanced, the last K and V writes read back at their position
    and the positions before the first write unchanged.  Returns (wall ms a
    step, traced (device ms, kernels, wall ms), cache bytes)."""
    from repro_torch.models.common import init_cache
    B = 1
    cache = init_cache(mod.cache_defs(cfg, B, S), torch.bfloat16, dev)
    g = torch.Generator(dev).manual_seed(seed)
    for k, v in cache.items():
        if k != "pos":
            v.normal_(generator=g)
    pos0 = S - steps - LONG_WARM - 2
    cache["pos"].fill_(pos0)
    kv = "k" in cache
    if kv:  # the positions no step writes: read before and after
        before = {k: cache[k][:, :, pos0 - 3:pos0 + 1].clone()
                  for k in ("k", "v")}
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=g, device=dev)
    with KVWrites() as writes:
        for _ in range(LONG_WARM):
            lg, cache = mod.decode_step(model, cache, tok, cfg)
            tok = lg[:, 0].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            lg, cache = mod.decode_step(model, cache, tok, cfg)
            tok = lg[:, 0].argmax(-1, keepdim=True)
        ms = sync_s(torch, t0) / steps * 1e3
        traced = {}
        busy = profile_step(torch, lambda: traced.update(
            out=mod.decode_step(model, cache, tok, cfg)))
        lg, cache = traced.pop("out")
        for k in ("k", "v") if kv else ():
            new, pos = writes.last[id(cache[k])]
            if int(pos) != S - 1 or not torch.equal(
                    cache[k][:, :, S - 1:S], new.to(cache[k].dtype)):
                raise AssertionError(f"long decode at {S}: the last {k} was "
                                     f"not written at {S - 1}")
            if not torch.equal(cache[k][:, :, pos0 - 3:pos0 + 1], before[k]):
                raise AssertionError(f"long decode at {S}: {k} positions "
                                     "before the first step were overwritten")
    if int(cache["pos"]) != S - 1 or not bool(torch.isfinite(lg).all()) \
            or not bool(torch.isfinite(cache["state"]).all()):
        raise AssertionError(f"long decode at {S}: pos {int(cache['pos'])}, "
                             f"finite logits {bool(torch.isfinite(lg).all())}")
    if cache["state"].dtype != torch.float32:
        raise AssertionError("long decode: the SSM state is not f32")
    cb = cache_bytes(cache)
    del cache
    return ms, busy, cb


def ssm_train(torch, arch, steps, dev, via_cli: bool) -> dict:
    """Training at the published widths in f32 with ``remat="block"``,
    batch 4 x 256, the train CLI's corpus and optimizer: through
    ``launch/train.py`` itself (``via_cli``, which ends with a checkpoint),
    or through the ``Trainer`` it makes, its initialisation and step
    function over its batches, without the checkpoint (zamba2-1.2b's, f32
    weights and moments, would be 14 GB written for nothing this phase
    reads).  Checks finite losses and gradient norms (the reference's
    chunked scan gives a NaN gradient here, ROADMAP Queue 3) and a falling
    loss: the first step's batch, evaluated again with the trained
    weights, has a lower loss than at the first step (the same tokens, so
    no batch-to-batch noise); the last step's loss is reported beside the
    first's.  The initial gradient's norm is split by leaf
    (:func:`leaf_grad_norms`), and the parts must make up the first
    step's norm."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry as models
    from repro_torch.train import train_state
    cfg, mod = models.get(arch)
    if cfg.remat != "block" or cfg.ssm_chunk != 128:
        raise AssertionError(f"{arch} trains with remat={cfg.remat!r}, "
                             f"chunk {cfg.ssm_chunk}")
    batch, seq = 4, 256
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ssm_train_")
    argv = ["--arch", arch, "--device", str(dev), "--steps", str(steps),
            "--batch", str(batch), "--seq", str(seq), "--log-every", "1",
            "--ckpt-every", str(10 * steps), "--ckpt-dir", tmp]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        targs = train_cli.parser().parse_args(argv)
        tr = train_cli.trainer_for(targs, cfg, mod,
                                   train_cli.corpus_for(targs, cfg))
        params, opt_state, _ = tr.init_or_resume()
        leaves = leaf_grad_norms(torch, mod, cfg, params,
                                 tr.batcher.batch_at(0))
        if via_cli:
            del params, opt_state
            out = train_cli.main(argv)
            params, lg = out["params"], out["log"]
        else:
            lg = []
            for step in range(steps):
                t1 = time.perf_counter()
                params, opt_state, m = tr.step_fn(params, opt_state,
                                                  tr.batcher.batch_at(step))
                lg.append({"loss": float(m["loss"]),
                           "grad_norm": float(m["grad_norm"]),
                           "step_s": sync_s(torch, t1)})
            del opt_state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [e["loss"] for e in lg]
    norms = [e["grad_norm"] for e in lg]
    step_s = [e["step_s"] for e in lg]
    with torch.no_grad():
        again = float(train_state.make_loss_fn(mod, cfg)(
            params, tr.batcher.batch_at(0))[1]["loss"])
    if len(lg) != steps or not np.isfinite(losses + norms + [again]).all() \
            or again >= losses[0]:
        raise AssertionError(f"{arch} training: {len(lg)} steps, losses "
                             f"{losses}, grad norms {norms}, first batch "
                             f"after training {again}")
    parts = float(np.sqrt(sum(v * v for v in leaves.values())))
    if not abs(parts - norms[0]) <= 1e-3 * norms[0]:
        raise AssertionError(f"{arch}: the leaves' gradient norms make "
                             f"{parts}, the first step's norm is {norms[0]}")
    top = sorted(leaves.items(), key=lambda kv: -kv[1])[:4]
    med = float(np.median(step_s[1:])) if steps > 1 else step_s[0]
    log("ssm13-train", arch=arch, via="launch/train.py" if via_cli
        else "Trainer.step_fn", layers=cfg.n_layers, d_model=cfg.d_model,
        dtype="float32", remat=cfg.remat, chunk=cfg.ssm_chunk, batch=batch,
        seq=seq, steps=steps, losses=[round(x, 4) for x in losses],
        first_batch_loss_after=f"{again:.4f}",
        grad_norms=[round(x, 4) for x in norms],
        init_grad_leaf_norms=",".join(f"{k}:{v:.4f}({v * v / parts ** 2:.4f})"
                                      for k, v in top),
        first_step_s=f"{step_s[0]:.3f}", step_s_median=f"{med:.4f}",
        tokens_per_s=f"{batch * seq / med:.0f}", peak_bytes=peak,
        total_s=f"{total_s:.2f}")
    del params
    return dict(loss_first=losses[0], loss_last=losses[-1],
                loss_first_after=again, step_s=med, peak=peak,
                leaf_norms=dict(top))


def leaf_grad_norms(torch, mod, cfg, params, batch) -> dict:
    """The norm of the loss gradient at ``params`` on ``batch``, by leaf:
    each stacked leaf's layers together (``layers.w_in.weight`` for every
    ``layers.<i>.w_in.weight``)."""
    import re
    from repro_torch.train import train_state
    named = dict(params.named_parameters())
    with torch.enable_grad():
        total, _ = train_state.make_loss_fn(mod, cfg)(params, batch)
        grads = torch.autograd.grad(total, list(named.values()))
    sq = {}
    for k, g in zip(named, grads):
        leaf = re.sub(r"\.\d+\.", ".", k)
        sq[leaf] = sq.get(leaf, 0.0) + float(g.double().square().sum())
    return {k: v ** 0.5 for k, v in sq.items()}


def ssm_embedding(torch, pl2, args, dev) -> dict:
    """mamba2-370m's hidden states through ``embed_windows`` over C's
    corpus, the ``embedding`` index and the exact all-pairs step through
    ``pairwise_l2`` (counted from a zeroed count), the range hits held to
    that matrix and, at a cut size, to the numpy host backend; then the
    kernel against its plain version at d = 1024.  Half of C's documents
    (:data:`SSM_EMBED_SHARE`): the index build is host plan code, about
    n^1.8 in the windows."""
    import numpy as np
    from repro_torch.core.embedding_retrieval import embed_windows
    from repro_torch.data.synthetic import token_corpus
    from repro_torch.kernels import ops
    from repro_torch.models import registry as models
    from repro_torch.retrieval import RetrievalConfig, Retriever
    t_emb = time.perf_counter()
    docs = args.embed_docs // SSM_EMBED_SHARE
    cfg, mod = models.get("mamba2-370m")
    model = build_model(torch, mod, cfg, torch.bfloat16, dev, seed=23)
    window, doc_len = 16, 256
    corpus = token_corpus(docs, doc_len, cfg.vocab, seed=0,
                          dup_frac=0.05)
    embed_windows(mod, model, cfg, list(corpus[:8]), window, device=dev)
    torch.cuda.synchronize()
    pl2.LAUNCHES = 0  # the path's launches: counted from here
    t0 = time.perf_counter()
    vecs, meta = embed_windows(mod, model, cfg, list(corpus), window,
                               device=dev)
    embed_s = time.perf_counter() - t0
    if vecs.shape != (docs * doc_len // window, cfg.d_model) \
            or not np.isfinite(vecs).all():
        raise AssertionError(f"mamba2 embed_windows: {vecs.shape}")
    dups = duplicate_docs(corpus)
    if not dups:
        raise ValueError("no planted duplicate documents: --embed-docs "
                         f"must be at least {20 * SSM_EMBED_SHARE}")
    per = -(-64 // len(dups))
    probe_ids = [dst * (doc_len // window) + w for dst, _ in dups
                 for w in range(per)][:64]
    twin_of = {dst * (doc_len // window) + w: src * (doc_len // window) + w
               for dst, src in dups for w in range(per)}
    probes = vecs[probe_ids]
    cfg_ix = RetrievalConfig("euclidean", index="embedding", eps_prime=0.02,
                             num_max=5, tight_bounds=True, device=str(dev))
    t0 = time.perf_counter()
    r = Retriever.build(cfg_ix, vecs)
    build_s = sync_s(torch, t0)
    eps = 0.5
    t0 = time.perf_counter()
    rs = r.batch(probes).range(eps)
    range_s = time.perf_counter() - t0
    if any(pid not in rs.hits[i] for i, pid in enumerate(probe_ids)):
        raise AssertionError("mamba2 range: a probe misses itself")
    twins = sum(twin_of[pid] in rs.hits[i] for i, pid in enumerate(probe_ids))
    x = torch.as_tensor(probes, device=dev)
    y = torch.as_tensor(vecs, device=dev)
    D = ops.pairwise_l2(x, y)
    torch.cuda.synchronize()
    launches = pl2.LAUNCHES  # the path ends here
    if launches != 1:
        raise AssertionError(f"pairwise_l2: {launches} launches on the "
                             "mamba2 embedding path, expected 1")
    band = l2_sq_bound(x, y)
    d2 = D.double() ** 2
    brute = (d2 <= eps * eps).cpu().numpy()
    outside = ((d2 - eps * eps).abs() > band).cpu().numpy()
    got = np.zeros_like(brute)
    for i, hits in enumerate(rs.hits):
        got[i, hits] = True
    if (got != brute)[outside].any():
        raise AssertionError("mamba2 range hits differ from the pairwise_l2 "
                             "matrix outside the band")
    t0 = time.perf_counter()
    n_cut = min(EMBED_PARITY_WINDOWS, len(vecs))
    cut_probes = [p for p in probe_ids if p < n_cut][:16] or list(range(16))
    res = {}
    for be in ("numpy", "kernel"):
        rb = Retriever.build(cfg_ix.replace(backend=be), vecs[:n_cut])
        a = rb.batch(vecs[cut_probes]).range(eps)
        res[be] = (a.hits, a.stats, rb.eval_stats())
    if res["numpy"] != res["kernel"]:
        raise AssertionError("mamba2 embedding: range hits or counts differ "
                             "from the numpy host backend")
    parity_s = time.perf_counter() - t0
    # the kernel against its plain version at the path's shapes (these
    # launches are not the path's)
    ratio, err = compare_l2(torch, pl2, x, y)
    log("ssm13-embed", arch=cfg.name, d_model=cfg.d_model,
        docs=docs, windows=len(vecs), embed_s=f"{embed_s:.3f}",
        tokens_per_s=f"{corpus.size / embed_s:.0f}",
        build_s=f"{build_s:.2f}", build_evals=r.eval_stats()["build"],
        probes=len(probe_ids), range_eps=eps,
        range_hits=sum(len(h) for h in rs.hits), twins_found=twins,
        range_s=f"{range_s:.3f}", band_pairs=int((~outside).sum()),
        host_parity_windows=n_cut, host_parity_probes=len(cut_probes),
        host_parity_s=f"{parity_s:.2f}",
        pairwise_l2_launches=launches,
        kernel_sq_err_over_bound=f"{ratio:.4g}", kernel_max_abs_err=err,
        s=f"{time.perf_counter() - t_emb:.2f}")
    del model
    return dict(launches=launches, max_abs_err=err, ratio=ratio,
                embed_s=embed_s, build_s=build_s)


def phase_ssm(torch, wf, pl2, args, dev) -> dict:
    """Phase 13: Mamba2 and the Zamba2 hybrid whole at their published
    widths (seeded weights).  (a) f32: decode after a prefill equals
    forward, and greedy steps equal the forward's argmax, at a one-chunk
    and a three-chunk prompt.  (b) bf16 serving: prefill and decode timed
    against the step's byte bound, one step traced.  (c) the ``long_500k``
    decode (``SHAPES``, chosen by ``sub_quadratic``) at three cache
    lengths.  (d) training (mamba2 through ``launch/train.py``, zamba2
    through its ``Trainer``).  (e) mamba2's
    embedding path through ``pairwise_l2``.  (a)-(d) launch neither
    hand-written kernel (checked)."""
    import gc
    import numpy as np
    from repro_torch.configs.base import SHAPES
    from repro_torch.models import hybrid, mamba2
    from repro_torch.models import registry as models
    from repro_torch.roofline import costs
    t_phase = time.perf_counter()
    rng = np.random.default_rng(13)
    wf.LAUNCHES = pl2.LAUNCHES = 0
    long_shape = SHAPES["long_500k"]
    lengths = LONG_LENGTHS + (long_shape.seq_len,)
    out = {"long": {}}

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    for arch, seed in SSM_ARCHS:
        t_arch = time.perf_counter()
        cfg, mod = models.get(arch)
        shape = dict(layers=cfg.n_layers, d_model=cfg.d_model,
                     ssm_heads=f"{cfg.ssm_heads}x{cfg.ssm_head_dim}",
                     state=cfg.ssm_state, chunk=cfg.ssm_chunk, vocab=cfg.vocab)
        if cfg.family == "hybrid":
            shape.update(attn_every=cfg.attn_every,
                         shared_heads=f"{cfg.n_heads}/{cfg.n_kv_heads}x"
                         f"{cfg.head_dim}", d_ff=cfg.d_ff)
        # (a) f32 parity
        t0 = time.perf_counter()
        model = build_model(torch, mod, cfg, torch.float32, dev, seed)
        build_s = sync_s(torch, t0)
        n_params = sum(p.numel() for p in model.parameters())
        for P in SSM_PARITY_PROMPTS:
            tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, P + 1)),
                                     device=dev)
            err, scale = decode_parity(torch, mod, model, cfg, tokens,
                                       f"{arch} prompt {P}")
            g_err, margin = greedy_parity(torch, mod, model, cfg,
                                          tokens[:, :P])
            log("ssm13-parity", arch=arch, **shape, params=n_params,
                dtype="float32", build_s=f"{build_s:.2f}", prompt=P,
                chunks=-(-P // min(cfg.ssm_chunk, P)),
                decode_max_abs_err=err, logit_scale=f"{scale:.3f}",
                greedy_steps=GREEDY_STEPS, greedy_max_abs_err=g_err,
                greedy_min_top2_margin=f"{margin:.4g}", rtol=DECODE_RTOL,
                atol=DECODE_ATOL, s=f"{time.perf_counter() - t_arch:.2f}")
        del model
        free()

        # (b) bf16 serving
        t0 = time.perf_counter()
        model = build_model(torch, mod, cfg, torch.bfloat16, dev, seed)
        build_s = sync_s(torch, t0)
        build_peak = torch.cuda.max_memory_allocated(dev)
        B, P, steps = args.decode_batch, args.prompt_len, args.decode_steps
        torch.cuda.reset_peak_memory_stats(dev)
        spans = [(mamba2, "ssd_step"), (mamba2, "causal_conv1d")]
        if cfg.family == "hybrid":
            spans.append((hybrid, "_shared_block"))
        pre_s, grow_s, dec_s, cb, busy = timed_decode(
            torch, mod, model, cfg, B, P, steps, dev, rng, spans=spans)
        nbytes, wbytes = costs.decode_step_bytes(model, cb)
        bound = costs.bytes_ms(nbytes)
        peak = torch.cuda.max_memory_allocated(dev)
        ms = dec_s / steps * 1e3
        # one more prefill, traced: the chunked scan's share of it
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)),
                                 device=dev)
        spans[0] = (mamba2, "ssd_chunked")
        pre = profile_step(torch, lambda: mod.forward(
            model, {"tokens": prompt}, cfg, return_cache=True), spans)
        del prompt
        log("ssm13-timed", arch=arch, dtype="bfloat16", batch=B, prompt=P,
            steps=steps, build_s=f"{build_s:.2f}", prefill_s=f"{pre_s:.4f}",
            prefill_tokens_per_s=f"{B * P / pre_s:.0f}",
            decode_ms_per_step=f"{ms:.3f}",
            decode_tokens_per_s=f"{B * steps / dec_s:.0f}",
            step_bound_ms=f"{bound:.3f}", bound_share=f"{bound / ms:.3f}",
            traced_step_device_ms=f"{busy[0]:.3f}",
            traced_step_kernels=busy[1],
            traced_step_wall_ms=f"{busy[2]:.3f}",
            busy_share=f"{busy[0] / ms:.3f}",
            traced_step_span_ms=span_text(busy[3]),
            traced_prefill_device_ms=f"{pre[0]:.3f}",
            traced_prefill_kernels=pre[1],
            traced_prefill_wall_ms=f"{pre[2]:.3f}",
            traced_prefill_span_ms=span_text(pre[3]), weight_bytes=wbytes,
            cache_bytes=cb, build_peak_bytes=build_peak, peak_bytes=peak,
            s=f"{time.perf_counter() - t_arch:.2f}")
        out[arch] = dict(prefill_s=pre_s, decode_ms=ms, bound_ms=bound,
                         peak=peak, busy=busy, prefill_trace=pre)

        # (c) the long_500k decode, at three cache lengths
        if not cfg.sub_quadratic or long_shape.global_batch != 1:
            raise AssertionError(f"{arch}: not runnable at long_500k")
        rows = []
        for i, S in enumerate(lengths):
            torch.cuda.reset_peak_memory_stats(dev)
            ms_l, busy_l, cb_l = long_decode(torch, mod, model, cfg, S,
                                             LONG_STEPS, dev, seed=100 + i)
            bound_l = costs.bytes_ms(costs.decode_step_bytes(model,
                                                             cb_l)[0])
            peak_l = torch.cuda.max_memory_allocated(dev)
            log("ssm13-long", arch=arch, shape=long_shape.name, cache_len=S,
                batch=1, steps=LONG_STEPS, dtype="bfloat16",
                decode_ms_per_step=f"{ms_l:.3f}",
                traced_step_device_ms=f"{busy_l[0]:.3f}",
                traced_step_kernels=busy_l[1],
                traced_step_wall_ms=f"{busy_l[2]:.3f}",
                step_bound_ms=f"{bound_l:.3f}",
                bound_share=f"{bound_l / ms_l:.3f}",
                device_bound_share=f"{bound_l / busy_l[0]:.3f}",
                cache_bytes=cb_l, peak_bytes=peak_l,
                s=f"{time.perf_counter() - t_arch:.2f}")
            rows.append(dict(S=S, ms=ms_l, device_ms=busy_l[0],
                             bound_ms=bound_l))
            free()
        first, last = rows[0]["device_ms"], rows[-1]["device_ms"]
        if cfg.family == "hybrid" and not last > 2 * first:
            raise AssertionError(f"{arch}: a step's device time does not "
                                 f"grow with the cache ({first} -> {last} ms)")
        if cfg.family == "ssm" and not 0.67 < last / first < 1.5:
            raise AssertionError(f"{arch}: a step's device time moves with "
                                 f"the position ({first} -> {last} ms)")
        out["long"][arch] = rows
        del model
        free()

    # (d) training
    out["train"] = {
        "mamba2-370m": ssm_train(torch, "mamba2-370m", SSM_TRAIN_STEPS, dev,
                                 via_cli=True),
        "zamba2-1.2b": ssm_train(torch, "zamba2-1.2b", HYBRID_TRAIN_STEPS,
                                 dev, via_cli=False)}
    free()
    out["launches"] = {"wavefront": wf.LAUNCHES, "pairwise_l2": pl2.LAUNCHES}
    if any(out["launches"].values()):
        raise AssertionError(f"ssm: hand-written kernels launched "
                             f"{out['launches']} in (a)-(d)")
    # (e) the embedding path
    out["embedding"] = ssm_embedding(torch, pl2, args, dev)
    free()
    log("ssm13-done", launches_wavefront=out["launches"]["wavefront"],
        launches_pairwise_l2=out["launches"]["pairwise_l2"],
        embedding_pairwise_l2_launches=out["embedding"]["launches"],
        s=f"{time.perf_counter() - t_phase:.2f}")
    return out


# -- phase 14: the tooling on the card ----------------------------------------

#: phase 14's cells, which one card holds: (arch, ``SHAPES`` cell, global
#: batch, dtype, what is cut).  smollm-360m trains in f32, the port's
#: trainer's dtype; the decode cells serve in bf16
TOOLING_CELLS = (
    ("smollm-360m", "train_4k", 2, "float32", "global batch 256 -> 2"),
    ("qwen3-4b", "decode_32k", 4, "bfloat16",
     "batch 128 -> 4; seeded cache of 32,768 positions"),
    ("mamba2-370m", "long_500k", 1, "bfloat16", "none (batch 1, 524,288 "
     "positions)"),
)


def tooling_shape(shape_name: str, batch: int):
    import dataclasses
    from repro_torch.configs.base import SHAPES
    return dataclasses.replace(SHAPES[shape_name], global_batch=batch)


def tooling_records(pool) -> list:
    """Futures of the dry-run's ``h100x1`` record of each of
    :data:`TOOLING_CELLS` (``launch/dryrun.measure``: the step on
    ``meta``), computed in ``pool``'s worker processes while the card runs
    the phases before 14."""
    import torch
    from repro_torch.launch import dryrun
    return [pool.submit(dryrun.measure, arch, tooling_shape(shape, B),
                        ("h100x1",), dtype=getattr(torch, dt))
            for arch, shape, B, dt, _ in TOOLING_CELLS]


#: the production meshes of phase 15's pod records
POD_MESHES = ("pod16x16", "pod2x16x16")


def pod_records(pool) -> list:
    """Futures of the partitioned dry-run (``launch/dryrun.partitioned``) of
    each of :data:`TOOLING_CELLS` at its published global batch and whole
    depth on each of :data:`POD_MESHES`, as ``((arch, shape, mesh),
    future)``, computed in ``pool`` while the card runs phases 12-13."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    return [((arch, shape, m), pool.submit(
        dryrun.partitioned, arch, SHAPES[shape], m, dtype=getattr(torch, dt)))
        for arch, shape, _, dt, _ in TOOLING_CELLS for m in POD_MESHES]


def seeded_inputs(torch, cfg, mod, shape, model, dtype, dev, seed) -> dict:
    """The step's inputs on the card, as the dry-run shapes them
    (``launch/dryrun.abstract_inputs``): token ids and labels drawn from
    ``[0, vocab)``, the optimizer state of ``model`` (training), or a cache
    of normal draws with ``pos`` at its second-to-last position, so the
    step writes the last (decode)."""
    from repro_torch.launch import dryrun
    g = torch.Generator(dev).manual_seed(seed)

    def draw(t):
        if t is None:
            return None
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=g, device=dev,
                               dtype=t.dtype)
        return torch.randint(0, cfg.vocab, t.shape, generator=g,
                             device=dev, dtype=t.dtype)
    inputs = dryrun.abstract_inputs(cfg, mod, shape, model, dtype)
    inputs["batch"] = {k: draw(t) for k, t in inputs["batch"].items()}
    if "cache" in inputs:
        inputs["cache"] = {k: draw(t) for k, t in inputs["cache"].items()}
        inputs["cache"]["pos"] = torch.full(
            (), shape.seq_len - 2, dtype=torch.int32, device=dev)
    return inputs


def phase_tooling(torch, wf, pl2, dev, records) -> dict:
    """Phase 14: the tooling (``repro_torch.roofline``, ``launch/dryrun``)
    on the card.  Each of :data:`TOOLING_CELLS` runs for real, at the
    shape of its dry-run record (``records``, counted on ``meta``): one
    warm step, then one step timed with CUDA events; its flops counted on
    the card must equal the record's, and its peak memory must be at least
    the record's argument bytes (the rest is printed as ``temp``).  The
    roofline terms and MFU of the step come from ``roofline/report``.
    Launches neither hand-written kernel (checked)."""
    import gc
    from repro_torch.launch import dryrun
    from repro_torch.models import registry as models
    from repro_torch.roofline import costs, report
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    wf.LAUNCHES = pl2.LAUNCHES = 0
    rows = []
    for (arch, shape_name, B, dt, cut), fut in zip(TOOLING_CELLS, records):
        t_cell = time.perf_counter()
        rec = fut.result()[0]
        cfg, mod = models.get(arch)
        shape = tooling_shape(shape_name, B)
        dtype = getattr(torch, dt)
        train = shape.kind == "train"
        model = build_model(torch, mod, cfg, dtype, dev, seed=14)
        model.requires_grad_(train)
        inputs = seeded_inputs(torch, cfg, mod, shape, model, dtype, dev,
                               seed=14)
        step = dryrun.step_fn(cfg, mod, shape.kind)
        step(model, inputs)  # warm
        torch.cuda.synchronize()
        args_alloc = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = step(model, inputs)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        peak = torch.cuda.max_memory_allocated(dev)
        del out
        flops, out = costs.count_flops(step, model, inputs)
        del out
        mem = rec["memory"]
        if flops != rec["flops"]:
            raise AssertionError(f"{arch} x {shape_name}: {flops} flops "
                                 f"counted on the card, {rec['flops']} on "
                                 "meta")
        if peak < mem["argument_bytes"]:
            raise AssertionError(f"{arch} x {shape_name}: peak {peak} "
                                 "bytes below the record's arguments "
                                 f"{mem['argument_bytes']}")
        roof = report.analyze(rec, step_s=ms / 1e3)
        log("tooling14-cell", arch=arch, shape=shape_name, cut=repr(cut),
            batch=B, seq_len=shape.seq_len, dtype=dt, step_ms=f"{ms:.3f}",
            flops_cuda=flops, flops_meta=rec["flops"],
            model_flops=f"{rec['model_flops']:.6g}",
            meta_count_s=rec["count_s"], argument_bytes=mem["argument_bytes"],
            output_bytes=mem["output_bytes"], allocated_bytes=args_alloc,
            peak_bytes=peak, temp_bytes=peak - mem["argument_bytes"],
            fits_one_h100=rec["fits_one_h100"],
            compute_ms=f"{roof['compute_s'] * 1e3:.4f}",
            memory_ms=f"{roof['memory_s'] * 1e3:.4f}", collective_ms="null",
            dominant=roof["dominant"],
            roofline_mfu=f"{roof['mfu']:.4f}",
            measured_mfu=f"{roof['measured_mfu']:.4f}",
            bound_share=f"{roof['step_s'] * 1e3 / ms:.4f}",
            s=f"{time.perf_counter() - t_cell:.2f}")
        rows.append(dict(arch=arch, shape=shape_name, ms=ms, flops=flops,
                         peak=peak, temp=peak - mem["argument_bytes"],
                         mfu=roof["measured_mfu"]))
        del model, inputs, step
        gc.collect()
        torch.cuda.empty_cache()
    launches = {"wavefront": wf.LAUNCHES, "pairwise_l2": pl2.LAUNCHES}
    if any(launches.values()):
        raise AssertionError(f"phase 14 launched a kernel: {launches}")
    log("tooling14-done", cells=len(rows), launches=launches,
        s=f"{time.perf_counter() - t_phase:.2f}")
    return {"rows": rows, "launches": launches}


# -- phase 15: the partitioned program on the card ----------------------------

#: decode steps of phase 15's qwen3-4b run (the deepseek-v2 cut takes half)
SHARDED_STEPS = 16
#: documents of phase 15's sharded embedding run (256 tokens each)
SHARDED_DOCS = 32


def _whole(t):
    """A ``DTensor``'s global value (a tensor as it is)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def sharded_decode(torch, mod, model, cfg, ctx, prompt, steps, feed=None):
    """A prefill of ``prompt`` and ``steps`` greedy decode steps under
    ``ctx`` (fed ``feed``'s tokens instead, if given: another run's, so
    that a difference does not change the sequence): the prefill's and
    every step's logits (whole), the tokens fed, the final cache (whole)
    and the seconds of the decode steps.  Under a mesh the grown cache is
    laid out by ``cache_defs``' axes, so each step's write goes through
    the sharded ``update_cache``."""
    from repro_torch.models.common import grow_cache
    from repro_torch.models.params import distribute_tree
    B, P = prompt.shape
    out = mod.forward(model, {"tokens": prompt}, cfg, ctx, return_cache=True)
    logits = [_whole(out[0])[:, -1]]
    cache = grow_cache({k: None if v is None else _whole(v)
                        for k, v in out[-1].items()}, P + steps + 1)
    del out
    if ctx.mesh is not None:
        cache = distribute_tree(cache, mod.cache_defs(cfg, B, P + steps + 1),
                                ctx.mesh, ctx.rules)
    toks = [logits[0].argmax(-1, keepdim=True)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        tok = toks[i] if feed is None else feed[i]
        lg, cache = mod.decode_step(model, cache, tok, cfg, ctx)
        lg = _whole(lg)[:, 0]
        logits.append(lg)
        toks.append(lg.argmax(-1, keepdim=True))
    dec_s = sync_s(torch, t0)
    return logits, toks, {k: None if v is None else _whole(v)
                          for k, v in cache.items()}, dec_s


def same(torch, a, b):
    """(bit-equal, largest |a - b|) of two lists or dicts of tensors."""
    pairs = list(zip(a.values(), b.values())) if isinstance(a, dict) \
        else list(zip(a, b))
    pairs = [(x, y) for x, y in pairs if x is not None]
    equal = all(torch.equal(x, y) for x, y in pairs)
    diff = max(float((x.double() - y.double()).abs().max()) for x, y in pairs)
    return equal, diff


def phase_sharded(torch, wf, pl2, args, dev, pods) -> dict:
    """Phase 15: the partitioned program (``models.layers.Ctx``) on the
    card.  An NCCL group of world size 1 (a ``FileStore`` in a temporary
    directory) and a ``(1, 1)`` ``("data", "model")`` mesh; under
    ``Ctx(mesh, SERVE_RULES)``, each run against the same run under
    ``NOCTX`` on the same weights (the network's parameters are laid out as
    ``DTensor``s in place after the plain run): qwen3-4b whole (bf16, batch
    ``--decode-batch`` x ``--prompt-len``, :data:`SHARDED_STEPS` decode
    steps through the sharded ``update_cache``), phase 12's deepseek-v2 cut
    (1 dense + ``--moe-layers`` MoE layers, bf16, half the prompt and
    steps) through the expert-parallel ``moe_block``, and
    ``embed_windows(ctx=)`` on smollm-360m over :data:`SHARDED_DOCS`
    documents into one ``pairwise_l2`` launch, held to the plain version.
    Both runs go in deterministic mode (``index_add_``'s atomics would
    otherwise order the MoE's six expert outputs a token differently from
    run to run) and the ``Ctx`` run is fed the plain run's tokens:
    bit-equal results are expected; a difference is printed with its size
    and with the plain run's own, repeated.
    Then the pod-mesh records of phase 14's cells (``pods``), counted on
    ``meta`` in the worker processes, with the roofline's collective term.
    Launches: ``pairwise_l2`` once, the wavefront never (checked)."""
    import dataclasses
    import datetime
    import gc
    import tempfile
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core.embedding_retrieval import embed_windows
    from repro_torch.data.synthetic import token_corpus
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import registry as models
    from repro_torch.models.layers import NOCTX, Ctx
    from repro_torch.models.params import distribute
    from repro_torch.roofline import report
    t_phase = time.perf_counter()
    rng = np.random.default_rng(15)
    out = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=60),
            device_id=dev)
        try:
            mesh = device_mesh(Mesh(("data", "model"), (1, 1)), "cuda")
            ctx = Ctx(mesh, shd.SERVE_RULES)
            torch.use_deterministic_algorithms(True, warn_only=True)
            wf.LAUNCHES = pl2.LAUNCHES = 0   # the phase's launches from here
            for label, arch, layers, P, steps, seed in (
                    ("qwen3", "qwen3-4b", None, args.prompt_len,
                     SHARDED_STEPS, 15),
                    ("deepseek", "deepseek-v2-236b", args.moe_layers,
                     args.prompt_len // 2, SHARDED_STEPS // 2, 13)):
                t0 = time.perf_counter()
                cfg, mod = models.get(arch)
                if layers is not None:
                    cfg = dataclasses.replace(
                        cfg, n_layers=cfg.first_dense_layers + layers)
                model = build_model(torch, mod, cfg, torch.bfloat16, dev,
                                    seed)
                prompt = torch.as_tensor(rng.integers(
                    0, cfg.vocab, (args.decode_batch, P)), device=dev)
                lg0, tk0, c0, s0 = sharded_decode(torch, mod, model, cfg,
                                                  NOCTX, prompt, steps)
                lgr, _, _, _ = sharded_decode(torch, mod, model, cfg, NOCTX,
                                              prompt, steps, feed=tk0)
                distribute(model, mod.param_defs(cfg), mesh, ctx.rules)
                lg1, _, c1, s1 = sharded_decode(torch, mod, model, cfg, ctx,
                                                prompt, steps, feed=tk0)
                eq_l, d_l = same(torch, lg0, lg1)
                eq_c, d_c = same(torch, c0, c1)
                eq_r, d_r = same(torch, lg0, lgr)
                if not all(bool(torch.isfinite(x).all()) for x in lg1):
                    raise AssertionError(f"{label}: non-finite logits")
                if int(c1["pos"]) != P - 1 + steps:
                    raise AssertionError(f"{label}: pos {int(c1['pos'])}")
                log(f"sharded15-{label}", layers=cfg.n_layers,
                    mesh="1x1 (data, model)", rules="SERVE_RULES",
                    dtype="bfloat16", batch=args.decode_batch, prompt=P,
                    steps=steps, logits_bit_equal=eq_l,
                    logits_max_abs_diff=d_l, cache_bit_equal=eq_c,
                    cache_max_abs_diff=d_c, plain_repeat_bit_equal=eq_r,
                    plain_repeat_max_abs_diff=d_r,
                    nomesh_decode_ms_per_step=f"{s0 / steps * 1e3:.3f}",
                    ctx_decode_ms_per_step=f"{s1 / steps * 1e3:.3f}",
                    ctx_host_overhead=f"{s1 / s0:.2f}",
                    s=f"{time.perf_counter() - t0:.2f}")
                out[label] = dict(equal=eq_l and eq_c, diff=max(d_l, d_c),
                                  ms=s0 / steps * 1e3, ctx_ms=s1 / steps * 1e3)
                del model, lg0, lg1, lgr, c0, c1
                free()
            # embed_windows(ctx=) on smollm-360m into one pairwise_l2
            t0 = time.perf_counter()
            cfg, mod = models.get("smollm-360m")
            model = build_model(torch, mod, cfg, torch.float32, dev, seed=15)
            corpus = token_corpus(SHARDED_DOCS, 256, cfg.vocab, seed=15)
            v0, _ = embed_windows(mod, model, cfg, list(corpus), 16,
                                  device=dev)
            distribute(model, mod.param_defs(cfg), mesh, ctx.rules)
            v1, meta = embed_windows(mod, model, cfg, list(corpus), 16,
                                     ctx=ctx, device=dev)
            eq_e = bool(np.array_equal(v0, v1))
            d_e = float(np.abs(v0 - v1).max())
            x = torch.as_tensor(v1, device=dev)
            D = ops.pairwise_l2(x, x)
            want = pl2.pairwise_l2_torch(x, x)
            torch.cuda.synchronize()
            ratio = float(((D.double() ** 2 - want.double() ** 2).abs()
                           / l2_sq_bound(x, x)).max())
            if ratio > 1.0 or not bool(torch.isfinite(D).all()):
                raise AssertionError(f"sharded embedding: pairwise_l2 |dD^2|"
                                     f" {ratio} x its bound")
            launches = {"wavefront": wf.LAUNCHES,
                        "pairwise_l2": pl2.LAUNCHES}
            log("sharded15-embedding", docs=SHARDED_DOCS, windows=len(meta),
                d_model=cfg.d_model, vectors_bit_equal=eq_e,
                vectors_max_abs_diff=d_e, l2_over_bound=f"{ratio:.4f}",
                launches_pairwise_l2=launches["pairwise_l2"],
                launches_wavefront=launches["wavefront"],
                s=f"{time.perf_counter() - t0:.2f}")
            del model
            free()
        finally:
            torch.use_deterministic_algorithms(False)
            dist.destroy_process_group()
    if launches != {"wavefront": 0, "pairwise_l2": 1}:
        raise AssertionError(f"phase 15 launches {launches}")
    out["embedding"] = dict(equal=eq_e, diff=d_e)
    out["launches"] = launches
    for (arch, shape, m), fut in pods:
        rec = fut.result()
        coll = rec["collectives"]
        log("sharded15-pod", arch=arch, shape=shape, mesh=m, cut="none",
            flops_per_device=f"{rec['flops_per_device']:.6g}",
            collective_bytes=coll["total_bytes"],
            all_reduce=coll["all-reduce"], all_gather=coll["all-gather"],
            reduce_scatter=coll["reduce-scatter"],
            all_to_all=coll["all-to-all"], calls=coll["counts"],
            collective_ms=f"{coll['total_bytes'] / report.LINK_BW * 1e3:.4f}",
            count_s=rec["count_s"])
    log("sharded15-done", s=f"{time.perf_counter() - t_phase:.2f}")
    return out


# -- phase 16: the four examples on the card ----------------------------------

#: steps of phase 16's LM example runs (as CI runs the reference's)
LM_STEPS = 30
#: phase 16's examples: (``examples/<name>_torch.py``, its arguments besides
#: ``--device``, the regex of the printed numbers held to one unit in their
#: last digit, ``printed_lines_differ``'s ``loose``)
EXAMPLES = (("quickstart", (), ""),
            ("trajectory_search", (), r"d="),
            ("protein_search", (), ""),
            ("lm_semantic_retrieval", ("--steps", str(LM_STEPS)),
             r"loss |-> "))
LM = "lm_semantic_retrieval"
#: the LM example's printed lines, parsed
LM_LINES = re.compile(
    r"trained (?P<steps>\d+) steps; loss (?P<first>[\d.]+) -> "
    r"(?P<last>[\d.]+)\n"
    r"near-duplicate window retrieved: seq (?P<seq>\d+) @(?P<start>\d+) "
    r"\(d=(?P<d>[\d.]+)\) for probe from seq (?P<probe_seq>\d+)\n"
    r"(?P<count>\d+) windows within eps=0\.5; evals=(?P<evals>\d+) "
    r"vs naive=(?P<naive>\d+)\n\Z")
#: the card's losses against the CPU's, from one initialisation: the two
#: do f32 in different orders, which AdamW amplifies over the steps
LM_LOSS_ATOL = 5e-3


def example_main(name: str):
    """``main`` of ``examples/<name>_torch.py``, imported now."""
    import runpy
    return runpy.run_path(str(ROOT / "examples" / f"{name}_torch.py"),
                          run_name="example")["main"]


def example_run(main, argv) -> tuple:
    """(``main(argv)``'s result, what it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(list(argv))
    return res, buf.getvalue()


class LMFromInit:
    """The port's ``Trainer`` patched, while entered, to copy the checkpoint
    directory ``init`` into the one it is given (the LM example's fresh
    temporary directory), so that it resumes from that step-0
    initialisation: the CPU's generator and the card's draw different
    weights from one seed, so the card's run and the CPU's start from the
    one the CPU drew."""

    def __init__(self, init: str):
        self.init = init

    def __enter__(self):
        import shutil
        from repro_torch.train import trainer
        base = self.base = trainer.Trainer
        init = self.init

        class FromInit(base):
            def __init__(self, model, cfg, opt_cfg, batcher, ckpt_dir, tcfg,
                         *args, **kw):
                shutil.copytree(init, ckpt_dir, dirs_exist_ok=True)
                super().__init__(model, cfg, opt_cfg, batcher, ckpt_dir,
                                 tcfg, *args, **kw)

        trainer.Trainer = FromInit
        return self

    def __exit__(self, *exc):
        from repro_torch.train import trainer
        trainer.Trainer = self.base


def lm_init_checkpoint(directory: str) -> None:
    """The LM example's model and optimizer at step 0, drawn on the CPU,
    saved as a checkpoint in ``directory``."""
    from repro_torch.data.pipeline import TokenBatcher
    from repro_torch.data.synthetic import token_corpus
    from repro_torch.models import registry as models
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg, mod = models.get("smollm-360m", reduced=True)
    t = Trainer(mod, cfg, opt_lib.OptConfig(lr=1e-3, warmup_steps=10,
                                            total_steps=LM_STEPS),
                TokenBatcher(token_corpus(256, 256, cfg.vocab, seed=0),
                             batch=8, seq=64, seed=1),
                directory, TrainerConfig(total_steps=LM_STEPS), device="cpu")
    params, opt_state, _ = t.init_or_resume()
    t.ckpt.save(0, t._to_tree(params, opt_state), block=True)


def example_cpu(name: str, argv, lm_init: str) -> tuple:
    """What ``examples/<name>_torch.py`` prints with ``--device cpu`` (the
    LM example from ``lm_init``), and its seconds; run in a worker process,
    on one torch thread beside the card's phases."""
    import contextlib
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with LMFromInit(lm_init) if name == LM else contextlib.nullcontext():
            main = example_main(name)
            t0 = time.perf_counter()
            _, text = example_run(main, [*argv, "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    return text, time.perf_counter() - t0


def example_cpu_runs(pool, lm_init: str) -> dict:
    """Futures of :func:`example_cpu` for each of :data:`EXAMPLES`, computed
    in ``pool`` while the card runs phases 12-15 (the LM example's step-0
    checkpoint is written to ``lm_init`` first)."""
    lm_init_checkpoint(lm_init)
    return {name: pool.submit(example_cpu, name, argv, lm_init)
            for name, argv, _ in EXAMPLES}


def lm_lines(text: str, label: str) -> dict:
    """The LM example's printed lines, parsed (:data:`LM_LINES`)."""
    m = LM_LINES.fullmatch(text)
    if m is None:
        raise AssertionError(f"{label} printed {text!r}")
    return {k: float(v) if "." in v else int(v)
            for k, v in m.groupdict().items()}


def lm_checks(res, text: str, label: str) -> dict:
    """The LM example's printed lines, parsed, held to its own result: the
    near-duplicate probe retrieves its own window (``d < 1e-3``), the
    ``range(0.5)`` count equals a brute-force count over the run's own
    vectors, and the hits and evaluations equal the numpy backend's over
    those vectors."""
    import numpy as np
    from repro_torch.retrieval import RetrievalConfig, Retriever
    got = lm_lines(text, label)
    vecs, meta, probe = res["vecs"], res["meta"], res["probe"]
    if (got["steps"], got["naive"]) != (LM_STEPS, len(vecs)) \
            or got["seq"] != meta[probe].seq_id or got["start"] != \
            meta[probe].start or got["d"] >= 1e-3:
        raise AssertionError(f"{label}: {got}")
    dist = np.sqrt(((vecs.astype(np.float64)
                     - vecs[probe].astype(np.float64)) ** 2).sum(axis=1))
    brute = int((dist <= 0.5).sum())
    host = Retriever.build(RetrievalConfig(
        "euclidean", index="embedding", eps_prime=0.02, num_max=5,
        tight_bounds=True, backend="numpy", device="cpu"), vecs)
    near = host.query(vecs[probe]).nearest(2.0, tol=1e-3)
    within = host.query(vecs[probe]).range(0.5)
    if got["count"] != brute or sorted(res["range"].hits) != \
            sorted(within.hits) or res["nearest"].first != near.first \
            or got["evals"] != host.eval_stats()["query"]:
        raise AssertionError(
            f"{label}: count {got['count']} (brute force {brute}), "
            f"evals {got['evals']} (numpy backend "
            f"{host.eval_stats()['query']})")
    return got


def phase_examples(torch, wf, pl2, dispatch, dev, cpu_runs, lm_init
                   ) -> dict:
    """Phase 16: the four ``examples/*_torch.py`` through their ``main`` with
    ``--device cuda``, in process, each under :func:`drive` (launch counts
    zeroed, the padded layout never built).  Each one's printed lines are
    held to its ``--device cpu`` run (``cpu_runs``) by
    :func:`printed_lines_differ`; the retrieval examples launch the
    wavefront once per dispatch counted in ``dispatch.STATS`` and never
    ``pairwise_l2``.  The LM example runs twice: as a user runs it (its own
    initialisation on the card) and from the CPU run's initialisation
    (``lm_init``), whose losses are held to the CPU's within
    :data:`LM_LOSS_ATOL`, its near-duplicate line's sequence and offset
    exactly; each run's count and evaluations to :func:`lm_checks`; it
    launches neither kernel (its Euclidean distance is the elementwise
    spec's torch ops)."""
    import contextlib
    t_phase = time.perf_counter()
    dev_argv = ["--device", str(dev)]
    runs = [(name, argv, loose, False) for name, argv, loose in EXAMPLES]
    runs.append((LM, EXAMPLES[-1][1], EXAMPLES[-1][2], True))
    launches = {"wavefront": 0, "pairwise_l2": 0}
    for name, argv, loose, from_init in runs:
        label = f"examples16-{name}" + ("-cpu-init" if from_init else "")
        with LMFromInit(lm_init) if from_init else contextlib.nullcontext():
            main = example_main(name)
            pl2.LAUNCHES = 0
            (res, text), s, n_wf, ks, rows = drive(
                torch, wf, dispatch, label,
                lambda: example_run(main, [*argv, *dev_argv]))
        dispatches, n_l2 = dispatch.STATS.dispatches, pl2.LAUNCHES
        for line in text.splitlines():
            print(f"[{label}] | {line}", flush=True)
        extra = {}
        if name == LM:
            got = lm_checks(res, text, label)
            if n_wf or n_l2:
                raise AssertionError(f"{label}: launches {n_wf} wavefront, "
                                     f"{n_l2} pairwise_l2; expected none")
            extra = dict(loss_first=got["first"], loss_last=got["last"],
                         range_hits=got["count"], evals=got["evals"])
        elif n_wf != dispatches or n_l2:
            raise AssertionError(f"{label}: {n_wf} wavefront launches for "
                                 f"{dispatches} dispatches, {n_l2} "
                                 "pairwise_l2 launches")
        want, cpu_s = cpu_runs[name].result()
        if name != LM:
            bad = printed_lines_differ(text, want, loose)
        elif from_init:
            cpu = lm_lines(want, f"{label} on the CPU")
            bad = [(k, got[k], cpu[k]) for k in ("steps", "seq", "start",
                                                 "probe_seq", "naive")
                   if got[k] != cpu[k]]
            bad += [(k, got[k], cpu[k]) for k in ("first", "last")
                    if abs(got[k] - cpu[k]) > LM_LOSS_ATOL]
            extra.update(cpu_lines_equal=text == want,
                         cpu_count=cpu["count"], cpu_evals=cpu["evals"])
        else:
            bad = []
        if bad:
            raise AssertionError(f"{label}: the card's lines differ from the "
                                 f"CPU's: {bad}")
        launches["wavefront"] += n_wf
        launches["pairwise_l2"] += n_l2
        log(label, lines=len(text.splitlines()), s=f"{s:.2f}",
            host_s=f"{s - ks:.2f}", kernel_s=f"{ks:.4f}", launches=n_wf,
            launches_pairwise_l2=n_l2, dispatches=dispatches,
            rows_max=max(rows, default=0), cpu_s=f"{cpu_s:.2f}",
            held_to="the --device cpu run" if name != LM or from_init
            else "its own vectors", **extra)
    log("examples16-done", s=f"{time.perf_counter() - t_phase:.2f}",
        launches_wavefront=launches["wavefront"],
        launches_pairwise_l2=launches["pairwise_l2"])
    return {"launches": launches}


def ring_filter_entry(ring7, fleet8_row) -> dict:
    """The ring filter's entry of the ``kernels`` line: its launches,
    (filters, pass 2s), in all and by path (the one-shot queries of phases
    7 and 8, and any other phase's; the check's own launches on phase 8's
    merged fleet are left out), and the check's times and bound."""
    ring = fleet8_row["ring"]
    paths = {"fleet7": ring7, **fleet8_row["ring_by_path"]}
    every = tuple(t - c for t, c in zip(ring_launches(), ring["launches"]))
    paths["other_phases"] = tuple(t - sum(v[i] for v in paths.values())
                                  for i, t in enumerate(every))
    return {
        "name": "ring_filter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ring_filter.cu",
        "replaces": "src/repro/core/distributed.py:308",
        "launches": every[0], "row_launches": every[1],
        "launches_by_path": paths,
        "held_to": "the plain version, byte for byte, on phase 8's merged "
                   "fleet",
        **{k: ring[k] for k in ("Q", "P", "Nv", "N", "n_need", "ms",
                                "ring_verdicts_ms", "ring_scan_ms",
                                "ring_rows_ms", "launched_ms", "plain_ms",
                                "bound_ms", "bound_by")},
        "library_ms": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # 20,000 windows build in 120-210 s on the H100 host; step 4 at lam=40
    # costs 25-70 s of host plan code per 120-token query and eps there.
    # With every path driven, the script took 1,230.55 s at 20,000 windows
    # and 640 documents on a slow host (limit 1,200 s): both are cut to
    # half, which cuts about 400 s there.  Phase 13 adds 165-193 s (a whole
    # run took 947.09 s on an H100 80GB HBM3 at 700 W with a slow host), so
    # step 4 runs one query, not two: 58 s less on that host
    ap.add_argument("--windows-a", type=int, default=10000,
                    help="windows of the lam=40 steps 1-4 run")
    ap.add_argument("--queries-a", type=int, default=1,
                    help="queries of the lam=40 steps 1-4 run")
    ap.add_argument("--windows-b", type=int, default=3000,
                    help="windows of the quickstart three-query run")
    # 320 documents of 256 tokens give 5,120 windows of 16 tokens; the
    # index build over them is host-bound (about n^1.8 evaluations)
    ap.add_argument("--embed-docs", type=int, default=320,
                    help="documents of the smollm-360m embedding run")
    # cell A's window count, over 4 logical workers on the one card
    ap.add_argument("--windows-fleet", type=int, default=20000,
                    help="windows of the phase-8 fleet (and phase 9's)")
    # benchmarks/bench_query.py's full size (n = 4000, 20 queries)
    ap.add_argument("--windows-index", type=int, default=4000,
                    help="windows of each phase-10 full-size sweep")
    ap.add_argument("--queries-index", type=int, default=20,
                    help="queries of each phase-10 full-size sweep")
    ap.add_argument("--train-steps", type=int, default=20,
                    help="steps of the phase-11 training run")
    # the reference's CLI filters 128 documents: 192 s on the H100's host
    # (the filter's cost grows as the square of the documents); the first
    # 72 hold one planted near-duplicate pair (document 69 is a copy of 52
    # with 2 % of its tokens redrawn), which the filter must drop
    ap.add_argument("--dedup-docs", type=int, default=72,
                    help="documents the phase-11 dedup filter reads")
    # phase 12: qwen3-4b decodes --decode-steps tokens after prompts of
    # --prompt-len; the deepseek-v2 cut half of each
    ap.add_argument("--decode-batch", type=int, default=4,
                    help="sequences of the phase-12 timed decode runs")
    ap.add_argument("--prompt-len", type=int, default=1024,
                    help="prompt tokens of the phase-12 qwen3-4b run "
                         "(the deepseek-v2 cut takes half)")
    ap.add_argument("--decode-steps", type=int, default=64,
                    help="decode steps of the phase-12 qwen3-4b run (the "
                         "deepseek-v2 cut takes half)")
    ap.add_argument("--moe-layers", type=int, default=3,
                    help="MoE layers of the timed deepseek-v2 cut (after "
                         "its one dense layer)")
    # phase 13: mamba2-370m and zamba2-1.2b whole; their timed decode takes
    # --decode-batch, --prompt-len and --decode-steps, their embedding run
    # --embed-docs
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build, dispatch
        from repro_torch.kernels import pairwise_l2 as pl2
        from repro_torch.kernels import wavefront as wf
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np
    rng = np.random.default_rng(0)

    facts = phase_facts(torch, build)
    built = phase_build(build)
    max_err = phase_kernel_parity(torch, wf, rng, dev)
    numpy_err = phase_numpy_parity(torch, wf, dev)
    l2_err = phase_l2_parity(torch, pl2, dev)
    phase_main_parity(torch, wf, rng, dev)
    lev_launches = phase_lev_ids(torch, wf, dev)
    full = phase_full(torch, wf, dispatch, args, dev)
    emb = phase_embedding(torch, pl2, args, dev)
    t_fleet = time.perf_counter()
    ring0 = ring_launches()
    fleet_launches = phase_fleet_parity(torch, wf, dispatch, dev)
    ring7 = tuple(b - a for a, b in zip(ring0, ring_launches()))
    fleet8 = phase_fleet_full(torch, wf, dispatch, args, dev)
    serve = phase_serve(torch, wf, dispatch, dev, fleet8)
    log("fleet-serve-phases", s=f"{time.perf_counter() - t_fleet:.2f}",
        parity_launches=fleet_launches)
    t_new = time.perf_counter()
    index_launches = phase_index(torch, wf, dispatch, args, dev)
    train = phase_train(torch, wf, dispatch, args, dev)
    log("index-train-phases", s=f"{time.perf_counter() - t_new:.2f}")
    # phase 14's dry-run records are counted on meta by a worker process
    # while the card runs phases 12 and 13; then the examples' CPU runs
    # that phase 16 holds the card's to
    import concurrent.futures
    import multiprocessing
    import tempfile
    with tempfile.TemporaryDirectory() as lm_init, \
            concurrent.futures.ProcessPoolExecutor(
                2, mp_context=multiprocessing.get_context("spawn")) as pool:
        records = tooling_records(pool)
        pods = pod_records(pool)
        cpu_runs = example_cpu_runs(pool, lm_init)
        decode = phase_decode(torch, wf, pl2, args, dev)
        ssm = phase_ssm(torch, wf, pl2, args, dev)
        tooling = phase_tooling(torch, wf, pl2, dev, records)
        sharded = phase_sharded(torch, wf, pl2, args, dev, pods)
        examples = phase_examples(torch, wf, pl2, dispatch, dev, cpu_runs,
                                  lm_init)
    timing = phase_timing(torch, wf, rng, dev, full["sizes"])
    max_err = max([max_err] + [r["max_abs_err"] for r in timing])
    l2_rows = phase_l2_timing(torch, pl2, build, dev, emb["x"], emb["y"])

    main_row = timing[1]  # the main path's largest dispatch
    kernels = [{
        "name": "wavefront", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wavefront.cu",
        "replaces": "src/repro/kernels/wavefront.py:229",
        "launches": full["launches"] + fleet8["row"]["launches"]
        + serve["launches"] + index_launches + train["launches"]
        + lev_launches + examples["launches"]["wavefront"],
        "launches_by_path": {"matching": full["launches"],
                             "fleet": fleet8["row"]["launches"],
                             "serve": serve["launches"],
                             "indexes": index_launches,
                             "train_dedup": train["launches"],
                             "lev_ids": lev_launches,
                             "decode": decode["launches"]["wavefront"],
                             "ssm": ssm["launches"]["wavefront"],
                             "tooling": tooling["launches"]["wavefront"],
                             "sharded": sharded["launches"]["wavefront"],
                             "examples": examples["launches"]["wavefront"]},
        "schedule_rows": dict(wf.SCHEDULE_ROWS),
        "block_schedule": {
            "ptxas": {k: v for k, v in built["ptxas"].items()
                      if k.startswith("block<")},
            "smem_bytes_64x64x2": wf.smem_bytes("dfd", 64, 64, 2)[0],
            "ms_64x64x2": timing[-2]["ms"], "ms_few_long": timing[-1]["ms"]},
        "max_abs_err": max_err, "max_abs_err_numpy": numpy_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "old_bound_ms": main_row["old_bound_ms"], "library_ms": None}, {
        "name": "pairwise_l2", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pairwise_l2.cu",
        "replaces": "src/repro/kernels/pairwise_l2.py:47",
        "launches": emb["launches"] + ssm["embedding"]["launches"]
        + sharded["launches"]["pairwise_l2"]
        + examples["launches"]["pairwise_l2"],
        "launches_by_path": {"embedding": emb["launches"],
                             "decode": decode["launches"]["pairwise_l2"],
                             "ssm": ssm["launches"]["pairwise_l2"],
                             "ssm_embedding": ssm["embedding"]["launches"],
                             "tooling": tooling["launches"]["pairwise_l2"],
                             "sharded": sharded["launches"]["pairwise_l2"],
                             "examples": examples["launches"]["pairwise_l2"]},
        **l2_err,
        "max_abs_err_ssm_embedding": ssm["embedding"]["max_abs_err"],
        **l2_rows[0]}, ring_filter_entry(ring7, fleet8["row"])]
    log("total", s=f"{time.perf_counter() - t_start:.2f}")
    print(json.dumps({"kernels": kernels}))
    print(facts["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
