#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card, exits 0 on success

Builds the hand-written CUDA wavefront kernel from ``src/repro_torch/kernels/
csrc/wavefront.cu`` with ``nvcc`` for ``sm_90a``, holds it against its plain
torch version on the card, checks the port's main path (the paper's five-step
subsequence query through ``repro_torch.retrieval``) against the port's numpy
host backend, drives the main path at full size with the kernel's launch
count held to the counted dispatches, and times the kernel at the main
path's dispatch sizes.  Each phase prints one line; any failure raises and
the script exits non-zero.  The last line is
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

#: H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

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


def phase_build(build) -> dict:
    t0 = time.perf_counter()
    build.load("wavefront")
    info = build.BUILDS["wavefront"]
    log("build", library=info.path.name, built=info.built,
        nvcc_s=f"{info.seconds:.2f}", s=f"{time.perf_counter() - t0:.2f}",
        flags=repr(" ".join(build.NVCC_FLAGS)))
    entry = ""
    for ln in info.log.splitlines():  # ptxas: registers per kernel
        m = re.search(r"wavefront_(warp|block)_kernelILi(\d)E", ln)
        if "Compiling entry" in ln and m:
            entry = f"{m.group(1)}<{MODES[int(m.group(2))]}>"
        elif "Used" in ln and entry:
            print(f"[build] ptxas {entry}: {ln.split(':', 1)[1].strip()}",
                  flush=True)
    return {"seconds": info.seconds}


# -- kernel operands ----------------------------------------------------------

def make_rows(rng, mode, B, lx_range, ly_range, d, *, scale=1.0):
    """Ragged rows: tokens for lev, random-walk series otherwise."""
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
    for i in range(B):
        xs[i, lx[i]:] = 0
        ys[i, ly[i]:] = 0
    return xs, ys, lx, ly


def operands(spec, xs, ys, lx, ly, dev):
    import torch
    ops, (Lx, Ly) = spec.layout(torch.as_tensor(xs, device=dev),
                                torch.as_tensor(ys, device=dev),
                                torch.as_tensor(lx, device=dev),
                                torch.as_tensor(ly, device=dev))
    return ops, Lx, Ly


def bound(mode, xs, ys, lx, ly):
    """(bound_ms, bound_by): the larger of the bytes the alignment function
    must move over HBM rate and the f32 operations its cells need over the
    f32 peak.  Bytes: x and y at the dispatch's widths in their own dtype
    (int32 tokens for lev), the two lengths (int32), eps (f32), each read
    once, and dist (f32), hit and pruned (bool) written once.  The padded
    operand layout the kernel reads today (reversed, zero-padded y; borders
    that are constants, ``0..L`` or cumsums of the gaps) is derived from
    these, so it is not counted."""
    import numpy as np
    B = xs.shape[0]
    d = 1 if mode == "lev" else xs.shape[2]
    nbytes = xs.nbytes + ys.nbytes + B * (2 * 4 + 4) + B * (4 + 1 + 1)
    # per cell: cost (lev: d sub + d abs + d-1 add + compare; float modes:
    # d sub + d mul + d-1 add + max + sqrt + min), combine (dtw/dfd 3,
    # lev/erp 5), the BIG clamp, and the certificate's two mins
    cost = 3 * d if mode == "lev" else 3 * d + 2
    comb = 3 if mode in ("dtw", "dfd") else 5
    cells = float(np.sum(np.asarray(lx, np.float64) * np.asarray(ly)))
    flops = cells * (cost + comb + 1 + 2)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: kernel against its plain version ---------------------------------

def compare(wf, mode, ops, eps, Lx, Ly):
    import torch
    got = wf.wavefront_cuda(*ops, eps, mode=mode, Lx=Lx, Ly=Ly)
    want = wf.wavefront_torch(*ops, eps, mode=mode, Lx=Lx, Ly=Ly)
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


def phase_kernel_parity(torch, wf, registry, rng, dev) -> float:
    import numpy as np
    t0 = time.perf_counter()
    cases = []
    for mode in ("dtw", "erp", "dfd", "lev"):
        for d in ((1,) if mode == "lev" else (1, 2, 3)):
            cases.append((mode, 300, (1, 13), (1, 9), d, 1.0))   # Lx != Ly
            cases.append((mode, 200, (5, 22), (20, 20), d, 1.0))  # main path
    for mode in ("dtw", "erp", "dfd", "lev"):
        cases.append((mode, 64, (60, 100), (40, 90), 2 if mode != "lev"
                      else 1, 1.0))                     # past one warp
    cases.append(("erp", 4, (1000, 1100), (900, 1000), 3, 1.0))  # > block
    cases.append(("lev", 4, (1050, 1100), (1000, 1100), 1, 1.0))
    # overflow: long, high-gap-mass rows that saturate at BIG
    cases.append(("erp", 16, (40, 48), (40, 48), 1, 1e25))
    cases.append(("dtw", 16, (24, 32), (24, 32), 1, 3e24))
    worst = 0.0
    for mode, B, lxr, lyr, d, scale in cases:
        spec = registry.spec_for_mode(mode)
        if scale > 1.0:  # constant huge rows of opposite signs
            xs = np.full((B, lxr[1], d), scale, np.float32)
            ys = -np.full((B, lyr[1], d), scale, np.float32)
            lx = rng.integers(lxr[0], lxr[1] + 1, B)
            ly = rng.integers(lyr[0], lyr[1] + 1, B)
        else:
            xs, ys, lx, ly = make_rows(rng, mode, B, lxr, lyr, d)
        ops, Lx, Ly = operands(spec, xs, ys, lx, ly, dev)
        inf = torch.full((B,), float("inf"), device=dev)
        err, exact = compare(wf, mode, ops, inf, Lx, Ly)
        worst = max(worst, err)
        # eps mix: +inf rows, finite rows, rows whose eps IS their distance
        dist = exact[0]
        eps = torch.quantile(dist, 0.4).expand(B).clone()
        eps[0::3] = float("inf")
        eps[1::3] = dist[1::3]
        err, _ = compare(wf, mode, ops, eps, Lx, Ly)
        worst = max(worst, err)
        if scale > 1.0 and not bool((exact[0] >= 3e37).all()):
            raise AssertionError(f"{mode}: overflow rows did not saturate")
    log("kernel-vs-plain", cases=len(cases), max_abs_err=worst,
        tol=f"lev bit-equal; float rtol=atol={RTOL}; hit/pruned equal",
        s=f"{time.perf_counter() - t0:.2f}")
    return worst


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


# -- phase 5: full-size main path on the card ---------------------------------

class Timed:
    """Host seconds vs kernel seconds of a run: wraps the wavefront wrapper
    with CUDA events (the events are recorded around each launch and read
    once at the end, so timing adds no synchronisation)."""

    def __init__(self, torch, wf):
        self.torch, self.wf = torch, wf
        self.events = []
        self.rows = []

    def __enter__(self):
        self._orig = self.wf.wavefront_cuda
        torch, events, rows = self.torch, self.events, self.rows

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
        self.torch.cuda.synchronize()

    def kernel_s(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


def drive(torch, wf, dispatch, label, fn):
    """Run ``fn`` with launch counts zeroed just before; returns
    (result, seconds, launches, kernel seconds, rows per dispatch)."""
    dispatch.STATS.reset()
    wf.LAUNCHES = 0
    with Timed(torch, wf) as tm:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
    launches = wf.LAUNCHES
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


def phase_timing(torch, wf, registry, rng, dev, sizes) -> list:
    import numpy as np
    t0 = time.perf_counter()
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
              ("erp", 1 << 18, (20, 20), (20, 20), 2, "262,144 rows")]
    rows_out = []
    for mode, B, lxr, lyr, d, what in shapes:
        spec = registry.spec_for_mode(mode)
        xs, ys, lx, ly = make_rows(rng, mode, B, lxr, lyr, d)
        ops, Lx, Ly = operands(spec, xs, ys, lx, ly, dev)
        eps = torch.full((B,), float("inf"), device=dev)
        ms = time_ms(torch, lambda: wf.wavefront_cuda(
            *ops, eps, mode=mode, Lx=Lx, Ly=Ly))
        plain = time_ms(torch, lambda: wf.wavefront_torch(
            *ops, eps, mode=mode, Lx=Lx, Ly=Ly), min_ms=500.0, max_iters=20)
        # the registry's operand layout prep that precedes every launch,
        # from operands already on the card
        on_dev = [torch.as_tensor(a, device=dev) for a in (xs, ys, lx, ly)]
        layout = time_ms(torch, lambda: spec.layout(*on_dev),
                         min_ms=100.0, max_iters=50)
        del on_dev
        b_ms, by = bound(mode, xs, ys, lx, ly)
        log("timing", mode=mode, rows=B, shape=f"{Lx}x{Ly}x{d}",
            what=repr(what), ms=f"{ms:.4f}", plain_ms=f"{plain:.3f}",
            layout_ms=f"{layout:.3f}", bound_ms=f"{b_ms:.4f}", bound_by=by,
            share=f"{b_ms / ms:.3f}")
        rows_out.append(dict(mode=mode, rows=B, ms=ms, plain_ms=plain,
                             bound_ms=b_ms, bound_by=by))
    log("timing-done", s=f"{time.perf_counter() - t0:.2f}")
    return rows_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # 20,000 windows build in 160-210 s on the H100 host; step 4 at lam=40
    # costs 35-70 s of host plan code per 120-token query and eps there
    ap.add_argument("--windows-a", type=int, default=20000,
                    help="windows of the lam=40 steps 1-4 run")
    ap.add_argument("--queries-a", type=int, default=2,
                    help="queries of the lam=40 steps 1-4 run")
    ap.add_argument("--windows-b", type=int, default=3000,
                    help="windows of the quickstart three-query run")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build, registry, dispatch
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
    phase_build(build)
    max_err = phase_kernel_parity(torch, wf, registry, rng, dev)
    phase_main_parity(torch, wf, rng, dev)
    full = phase_full(torch, wf, dispatch, args, dev)
    timing = phase_timing(torch, wf, registry, rng, dev, full["sizes"])

    main_row = timing[1]  # the main path's largest dispatch
    kernels = [{
        "name": "wavefront", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wavefront.cu",
        "replaces": "src/repro/kernels/wavefront.py:229",
        "launches": full["launches"], "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}]
    log("total", s=f"{time.perf_counter() - t_start:.2f}")
    print(json.dumps({"kernels": kernels}))
    print(facts["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
