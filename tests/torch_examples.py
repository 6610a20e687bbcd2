"""Helpers of ``tests/test_torch_examples_*.py``: run one of ``examples/``
on ``repro`` and its ``_torch`` twin on the port in process, and capture
what each prints.

The reference runs as a script (``runpy`` with ``run_name="__main__"``) at
its own defaults, on its default ``numpy`` backend.  The port's file runs
through its ``main`` with ``--device cpu``, on the port's default
``kernel`` backend, which on the CPU is the wavefront kernel's plain torch
version; torch runs on one thread, as in ``tests/torch_sharded.py``.  The
two outputs are held line by line by ``chip_smoke.printed_lines_differ``,
the rule the smoke script also holds the card's runs to.
"""

from __future__ import annotations

import contextlib
import importlib.util
import pathlib
import runpy
import sys

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels import pairwise_l2 as pl2
from repro_torch.kernels import wavefront as wf

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"

_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
printed_lines_differ = chip_smoke.printed_lines_differ


def run_reference(name: str, argv, capsys, monkeypatch) -> str:
    """What ``examples/<name>.py`` prints, run as a script with ``argv``."""
    path = EXAMPLES / f"{name}.py"
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    capsys.readouterr()
    runpy.run_path(str(path), run_name="__main__")
    return capsys.readouterr().out


def port_main(name: str):
    """``main`` of ``examples/<name>_torch.py``, imported now (so that a
    class patched into ``repro_torch`` beforehand is the one it uses)."""
    return runpy.run_path(str(EXAMPLES / f"{name}_torch.py"),
                          run_name="example")["main"]


class TwinCalls:
    """Counts the calls of both kernels' plain versions, the CPU's
    counterpart of the card's launches, with ``dispatch.STATS`` zeroed on
    entry."""

    def __enter__(self):
        self.wavefront = self.pairwise_l2 = 0
        self._orig = wf.wavefront_torch, pl2.pairwise_l2_torch

        def count(attr, fn):
            def counted(*args, **kw):
                setattr(self, attr, getattr(self, attr) + 1)
                return fn(*args, **kw)
            return counted

        wf.wavefront_torch = count("wavefront", self._orig[0])
        pl2.pairwise_l2_torch = count("pairwise_l2", self._orig[1])
        dispatch.STATS.reset()
        return self

    def __exit__(self, *exc):
        wf.wavefront_torch, pl2.pairwise_l2_torch = self._orig
        self.dispatches = dispatch.STATS.dispatches


@contextlib.contextmanager
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def run_port(name: str, argv, capsys):
    """(printed text, ``main``'s result, :class:`TwinCalls`) of
    ``examples/<name>_torch.py`` run with ``argv`` on the CPU."""
    main = port_main(name)
    capsys.readouterr()
    with one_thread(), TwinCalls() as calls:
        result = main([*argv, "--device", "cpu"])
    return capsys.readouterr().out, result, calls


def assert_same_lines(got: str, want: str, loose: str = "") -> None:
    assert want.strip(), "the reference printed nothing"
    bad = printed_lines_differ(got, want, loose)
    assert not bad, "\n".join(f"port: {g}\nref:  {w}" for g, w in bad)
