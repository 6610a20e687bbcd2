"""``examples/lm_semantic_retrieval_torch.py`` against
``examples/lm_semantic_retrieval.py`` on the CPU: the reduced smollm-360m
trained for 30 steps (as CI runs the reference), its hidden-state windows
indexed by the ``embedding`` index, a near-duplicate probed with
``nearest(2.0, tol=1e-3)`` and ``range(0.5)``.

Both scripts start from one JAX initialisation (``jax.random`` cannot be
reproduced in torch): the reference's ``init_or_resume()`` saved as a
step-0 checkpoint, which each package's ``Trainer`` (patched to a subclass)
finds in its checkpoint directory, as ``tests/test_torch_train.py``'s
``three_steps`` does.  The reference's own directory,
``/tmp/repro_lm_ckpt``, is never read or written: the subclass swaps it for
a copy of the step-0 checkpoint.  Every character is equal but the two
losses, which may differ by one unit in their third decimal (the
frameworks' f32 gradients differ in their last bits, AdamW amplifies
that); the near-duplicate's sequence, offset and distance, the range count
and the evaluations are exact.  Euclidean goes through the elementwise
spec's torch ops: neither kernel's plain version is called.

The port's example keeps no checkpoint between runs: run twice, it prints
the same lines both times (the reference, run twice, resumes its first
run's final checkpoint, trains 0 steps and fails; ROADMAP Queue 3).
"""

import functools
import shutil
import tempfile

import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import TokenBatcher as RefBatcher  # noqa: E402
from repro.data.synthetic import token_corpus  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro_torch.train import trainer as port_trainer  # noqa: E402
from torch_examples import (assert_same_lines, one_thread,  # noqa: E402
                            port_main, run_port, run_reference)

STEPS = 30
#: the reference's hard-coded checkpoint directory
REF_CKPT = "/tmp/repro_lm_ckpt"


@pytest.fixture(autouse=True)
def no_straggler_entries(monkeypatch):
    """Both trainers log a step slower than 3x the median as a straggler,
    and the example prints the last logged loss: on a loaded host a slow
    step 29 or 30 would change that line.  Never flag one, so what each
    package prints does not depend on the host's load."""
    for mod in (ref_trainer, port_trainer):
        monkeypatch.setattr(mod, "TrainerConfig", functools.partial(
            mod.TrainerConfig, straggler_factor=float("inf")))


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """The reference's step-0 initialisation of the example's model, saved
    as a checkpoint directory."""
    root = tmp_path_factory.mktemp("lm_init")
    cfg, mod = ref_registry.get("smollm-360m", reduced=True)
    batcher = RefBatcher(token_corpus(256, 256, cfg.vocab, seed=0), batch=8,
                         seq=64, seed=1)
    t0 = ref_trainer.Trainer(
        mod, cfg, ref_opt.OptConfig(lr=1e-3, warmup_steps=10,
                                    total_steps=STEPS), batcher, root,
        ref_trainer.TrainerConfig(total_steps=STEPS))
    params, state, _ = t0.init_or_resume()
    t0.ckpt.save(0, (params, state), block=True)
    return root


def from_init(base, init, copies):
    """``base`` resuming from a copy of the checkpoint directory ``init``;
    the directory each instance was given is recorded in ``copies``."""

    class FromInit(base):
        def __init__(self, model, cfg, opt_cfg, batcher, ckpt_dir, tcfg,
                     *args, **kw):
            copy = copies["root"] / f"ckpt{len(copies['given'])}"
            copies["given"].append(str(ckpt_dir))
            shutil.copytree(init, copy)
            super().__init__(model, cfg, opt_cfg, batcher, copy, tcfg,
                             *args, **kw)
    return FromInit


def test_lm_example_prints_what_the_reference_prints(jax_init, tmp_path,
                                                     capsys, monkeypatch):
    copies = {"root": tmp_path, "given": []}
    monkeypatch.setattr(ref_trainer, "Trainer",
                        from_init(ref_trainer.Trainer, jax_init, copies))
    monkeypatch.setattr(port_trainer, "Trainer",
                        from_init(port_trainer.Trainer, jax_init, copies))
    want = run_reference("lm_semantic_retrieval", ["--steps", str(STEPS)],
                         capsys, monkeypatch)
    got, res, calls = run_port("lm_semantic_retrieval",
                               ["--steps", str(STEPS)], capsys)
    assert copies["given"][0] == REF_CKPT
    assert copies["given"][1] != REF_CKPT
    assert want.startswith(f"trained {STEPS} steps; ")
    assert_same_lines(got, want, loose=r"loss |-> ")
    assert res["final_step"] == STEPS
    assert res["vecs"].shape == (78, 60)   # 13 sequences x 6 windows
    assert res["meta"][res["nearest"].first].seq_id == 12
    assert calls.wavefront == calls.pairwise_l2 == 0
    assert calls.dispatches > 0   # the elementwise Euclidean's


def test_lm_example_run_twice_prints_the_same(tmp_path, capsys,
                                              monkeypatch):
    """Two runs through ``main`` in one process train from the same
    initialisation and print the same lines; each leaves no checkpoint
    behind."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    main = port_main("lm_semantic_retrieval")
    outs = []
    for _ in range(2):
        capsys.readouterr()
        with one_thread():
            res = main(["--steps", str(STEPS), "--device", "cpu"])
        outs.append(capsys.readouterr().out)
        assert res["final_step"] == STEPS
        assert not list(tmp.iterdir())
    assert outs[0].startswith(f"trained {STEPS} steps; ")
    assert outs[1] == outs[0]
