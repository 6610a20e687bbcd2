"""The port's training half against the JAX reference, on the CPU: AdamW
and its schedule, clipping and compression (``train/optimizer.py``), the
loss and the train step (``train/train_state.py``), the trainer and its
checkpoints (``train/trainer.py``), and the data pipeline
(``data/pipeline.py``).

Both packages get the same numpy inputs; the reduced smollm-360m starts in
both from one JAX initialisation, handed over as a step-0 checkpoint that
the port's trainer resumes (``jax.random`` cannot be reproduced in torch).

Tolerances, each for f32 arithmetic in another order or library:

* schedule, global norm, clipped gradients, cross entropy: ``rtol = 1e-6``;
* one AdamW step on f32 states: ``rtol = 1e-5, atol = 1e-7``; bf16 moments
  within one bf16 ulp (``rtol = 2**-7``);
* three train steps: loss within ``1e-5`` relative, parameters within
  ``rtol = 1e-4, atol = 1e-6`` wherever the gradient stands clear of its
  f32 rounding (``_assert_params_close`` says where and why not);
* top-k compression and the data pipeline: exact.
"""

import dataclasses
import pathlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import counter as ref_counter_mod  # noqa: E402
from repro.core import refnet as ref_refnet_mod  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_state as ref_ts  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro_torch.core import counter as counter_mod  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.synthetic import token_corpus  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.params import (decay_mask, params_from_jax,  # noqa: E402
                                       params_to_jax, port_leaves)
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_state as ts  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ARCH = "smollm-360m"
RNG = np.random.default_rng(11)


def _flat(tree, prefix=()):
    """A nested dict as ``{"a/b": leaf}`` in ``jax.tree.flatten`` order."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tree[k]
    return out


def _tree():
    """Leaves of rank 1-3 (norm-, bias- and weight-shaped), in f32."""
    shapes = {"a": {"w": (6, 4, 3), "ln": (6,)}, "b": (5, 7), "c": (3,),
              "emb": (9, 4)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return RNG.normal(size=s).astype(np.float32)
    return draw(shapes)


def _t(tree):
    return {k: torch.tensor(v) for k, v in _flat(tree).items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


# -- optimizer ----------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    opt.OptConfig(), opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=3),
    opt.OptConfig(warmup_steps=0, total_steps=0, min_lr_frac=0.0)])
def test_schedule_matches_reference(cfg):
    rcfg = ref_opt.OptConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 2, 3, 7, 50, 99, 100, 101, 5000, 10_000, 20_000):
        got = opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = ref_opt.schedule(rcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree()
    got, gn = opt.clip_by_global_norm(_t(g), max_norm)
    want, wn = ref_opt.clip_by_global_norm(_j(g), max_norm)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=1e-6)
    for k, w in _flat(jax.tree.map(np.asarray, want)).items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(state_dtype):
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                        state_dtype=state_dtype)
    rcfg = ref_opt.OptConfig(**dataclasses.asdict(cfg))
    p = _tree()
    tp, jp = _t(p), _j(p)
    ts_, js = opt.init_state(tp, cfg), ref_opt.init_state(jp, rcfg)
    for _ in range(3):
        g = _tree()
        tp, ts_, tm = opt.apply_updates(tp, _t(g), ts_, cfg)
        jp, js, jm = ref_opt.apply_updates(jp, _j(g), js, rcfg)
    assert int(ts_["step"]) == int(js["step"]) == 3
    assert ts_["step"].dtype == torch.int32
    np.testing.assert_allclose(tm["lr"].numpy(), np.asarray(jm["lr"]),
                               rtol=1e-6)
    for k, w in _flat(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(tp[k].numpy(), w, rtol=1e-5, atol=1e-7)
    tol = dict(rtol=2 ** -7, atol=1e-30) if state_dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-7)
    for key in ("m", "v"):
        want = _flat(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                  js[key]))
        for k, w in want.items():
            assert ts_[key][k].dtype == getattr(torch, state_dtype)
            np.testing.assert_allclose(ts_[key][k].float().numpy(), w,
                                       **tol)


def test_topk_compress_and_compress_tree_match_reference():
    g, r = _tree(), _tree()
    for keep in (0.01, 0.3, 1.0):
        got_s, got_r = opt.compress_tree(_t(g), _t(r), keep)
        want_s, want_r = ref_opt.compress_tree(_j(g), _j(r), keep)
        for k, w in _flat(jax.tree.map(np.asarray, want_s)).items():
            np.testing.assert_array_equal(got_s[k].numpy(), w)
        for k, w in _flat(jax.tree.map(np.asarray, want_r)).items():
            np.testing.assert_array_equal(got_r[k].numpy(), w)
    s, res = opt.topk_compress(torch.tensor(g["b"]), torch.zeros(5, 7), 0.1)
    assert int((s != 0).sum()) == 4 and torch.equal(s + res,
                                                    torch.tensor(g["b"]))


def test_cross_entropy_matches_reference():
    logits = RNG.normal(scale=3.0, size=(3, 5, 11)).astype(np.float32)
    labels = RNG.integers(-1, 11, size=(3, 5)).astype(np.int32)
    mask = RNG.integers(0, 2, size=(3, 5)).astype(np.int32)
    for m in (None, mask):
        got = ts.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                               None if m is None else torch.tensor(m))
        want = ref_ts.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # every label ignored: the denominator is max(0, 1), the loss 0
    none = ts.cross_entropy(torch.tensor(logits),
                            torch.full((3, 5), -1, dtype=torch.int32))
    assert float(none) == 0.0


def test_decay_mask_follows_the_reference_stacked_shapes():
    """The reference decays leaves with ``ndim >= 2`` of its layer-stacked
    tree: per-layer norms ``(n_layers, d)`` and QKV biases ``(H, hd)`` are
    decayed there, though the port holds them as 1-D tensors.  One AdamW
    step with weight decay on the port's per-layer tensors, with the mask,
    equals the reference's step on the stacked tree."""
    cfg, mod = registry.get(ARCH, reduced=True)
    cfg = dataclasses.replace(cfg, qkv_bias=True)
    defs = mod.param_defs(cfg)
    mask = decay_mask(defs)
    assert not mask["final_norm"]
    assert all(mask[f"layers.{i}.{n}"] for i in range(cfg.n_layers)
               for n in ("ln1", "ln2", "wq.bias", "wk.bias", "wv.bias"))
    assert sum(not v for v in mask.values()) == 1
    assert list(mask) == [n for _, _, names in port_leaves(defs)
                          for n in names]
    ref_cfg, ref_mod = ref_registry.get(ARCH, reduced=True)
    ref_cfg = dataclasses.replace(ref_cfg, qkv_bias=True)
    shapes = ref_mod.param_defs(ref_cfg)
    p = jax.tree.map(lambda d: RNG.normal(size=d.shape).astype(np.float32),
                     shapes, is_leaf=lambda x: hasattr(x, "init"))
    g = jax.tree.map(lambda a: RNG.normal(size=a.shape).astype(np.float32), p)
    ocfg = opt.OptConfig(lr=1e-2, warmup_steps=0, weight_decay=0.5)
    rcfg = ref_opt.OptConfig(**dataclasses.asdict(ocfg))
    want, _, _ = ref_opt.apply_updates(_j(p), _j(g),
                                       ref_opt.init_state(_j(p), rcfg), rcfg)
    tp = {k: params_from_jax(p)[k] for k in mask}
    tg = {k: params_from_jax(g)[k] for k in mask}
    got, _, _ = opt.apply_updates(tp, tg, opt.init_state(tp, ocfg), ocfg,
                                  decay=mask)
    back = params_to_jax(got, defs)
    for k, w in _flat(jax.tree.map(np.asarray, want)).items():
        np.testing.assert_allclose(_flat(back)[k], w, rtol=1e-5, atol=1e-7)
    # the port tensor's own rank would have left the norms undecayed
    wrong, _, _ = opt.apply_updates(tp, tg, opt.init_state(tp, ocfg), ocfg)
    assert not torch.allclose(wrong["layers.0.ln1"], got["layers.0.ln1"])


# -- train steps and the trainer ----------------------------------------------

OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _corpus(cfg):
    return token_corpus(32, 96, cfg.vocab, seed=0)


def _ref_trainer(path, steps, remat="none", **tkw):
    cfg, mod = ref_registry.get(ARCH, reduced=True)
    cfg = dataclasses.replace(cfg, remat=remat)
    batcher = ref_pipeline.TokenBatcher(_corpus(cfg), 2, 24, seed=0)
    return ref_trainer.Trainer(
        mod, cfg, ref_opt.OptConfig(**OCFG), batcher, path,
        ref_trainer.TrainerConfig(total_steps=steps, log_every=1, **tkw))


def _port_trainer(path, steps, remat="none", **kw):
    cfg, mod = registry.get(ARCH, reduced=True)
    cfg = dataclasses.replace(cfg, remat=remat)
    batcher = pipeline.TokenBatcher(_corpus(cfg), 2, 24, seed=0)
    tkw = {k: kw.pop(k) for k in ("ckpt_every", "keep_ckpts") if k in kw}
    return Trainer(mod, cfg, opt.OptConfig(**OCFG), batcher, path,
                   TrainerConfig(total_steps=steps, log_every=1, **tkw),
                   device="cpu", **kw)


def _ckpt_at(src: pathlib.Path, step: int, dst: pathlib.Path):
    """A checkpoint directory holding only ``src``'s checkpoint ``step``."""
    name = f"step_{step:010d}"
    dst.mkdir(parents=True)
    shutil.copytree(src / name, dst / name)
    (dst / "latest").write_text(name)
    return dst


def _port_params(out):
    t = out["params"]
    return _flat(params_to_jax(t.state_dict(), registry.get(
        ARCH, reduced=True)[1].param_defs(t.cfg)))


def _ref_params(out):
    return _flat(jax.tree.map(np.asarray, out["params"]))


#: largest step size of the runs (the schedule's peak, ``OCFG["lr"]``)
LR = OCFG["lr"]
#: gradients below this are near their f32 rounding: the two frameworks'
#: gradients of one batch differ by up to about 1.3e-7 (sums in another
#: order)
G_FLOOR = 1e-6


def _grad_floor(ckpt_dir: pathlib.Path, steps: int):
    """Per parameter element: whether its gradient came near its rounding
    (``0 < |g_t| < G_FLOOR``) in one of the reference's steps ``t <
    steps``, from its checkpoints at those steps in ``ckpt_dir``.  Exact
    zeros (embedding rows of tokens not in the batch) are exact in both
    frameworks."""
    cfg, mod = ref_registry.get(ARCH, reduced=True)
    batcher = ref_pipeline.TokenBatcher(_corpus(cfg), 2, 24, seed=0)
    grad = jax.jit(jax.grad(lambda p, b: ref_ts.make_loss_fn(mod, cfg)(
        p, b)[0]))
    t = _ref_trainer(ckpt_dir, 0)
    template, _, _ = t.init_or_resume()
    near = None
    for step in range(steps):
        (params, _), _ = t.ckpt.restore(
            (template, ref_opt.init_state(template, t.opt_cfg)), step)
        g = _flat(jax.tree.map(lambda a: np.abs(np.asarray(a)), grad(
            params, jax.tree.map(jnp.asarray, batcher.batch_at(step)))))
        g = {k: (a > 0) & (a < G_FLOOR) for k, a in g.items()}
        near = g if near is None else {k: near[k] | g[k] for k in g}
    return near


def _assert_params_close(got, want, near, steps):
    """``rtol = 1e-4, atol = 1e-6`` on every parameter element whose
    gradient never came near its rounding (``near``, :func:`_grad_floor`).
    AdamW divides a gradient by its RMS, so a gradient near its rounding
    moves its parameter by a share of ``lr`` that the rounding decides, up
    to ``2 lr`` a step: those few elements (at most 1 in 1,000, checked)
    are held within ``2 lr`` a step."""
    assert set(got) == set(want) == set(near)
    loose = 0
    for k in want:
        tight = ~near[k]
        loose += int((~tight).sum())
        np.testing.assert_allclose(got[k][tight], want[k][tight],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
        assert np.all(np.abs(got[k] - want[k]) <= 2 * LR * steps), k
    assert loose <= sum(a.size for a in want.values()) // 1000


@pytest.fixture(scope="module")
def three_steps(tmp_path_factory):
    """The reference's step-0 init as a checkpoint, then three steps in
    each package from it (checkpoints at every step)."""
    root = tmp_path_factory.mktemp("three_steps")
    t0 = _ref_trainer(root / "init", 0)
    params, state, _ = t0.init_or_resume()
    t0.ckpt.save(0, (params, state), block=True)
    ref_out = _ref_trainer(_ckpt_at(root / "init", 0, root / "ref"), 3,
                           ckpt_every=1, keep_ckpts=5).run()
    port_out = _port_trainer(_ckpt_at(root / "init", 0, root / "port"), 3,
                             ckpt_every=1, keep_ckpts=5).run()
    return root, ref_out, port_out, _grad_floor(root / "ref", 3)


def test_three_train_steps_match_reference(three_steps):
    _, ref_out, port_out, near = three_steps
    assert port_out["final_step"] == ref_out["final_step"] == 3
    for g, w in zip(port_out["log"], ref_out["log"], strict=True):
        assert g["step"] == w["step"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
    assert port_out["log"][-1]["loss"] < port_out["log"][0]["loss"]
    _assert_params_close(_port_params(port_out), _ref_params(ref_out), near,
                         3)
    st = port_out["opt_state"]
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 3


def test_checkpoints_resume_across_packages(three_steps, tmp_path):
    """Step 2 of each package's run, resumed by the other for step 3,
    lands on the reference's three-step parameters."""
    root, ref_out, _, near = three_steps
    want = _ref_params(ref_out)
    port_from_ref = _port_trainer(_ckpt_at(root / "ref", 2,
                                           tmp_path / "a"), 3).run()
    assert port_from_ref["log"][0]["step"] == 3
    _assert_params_close(_port_params(port_from_ref), want, near, 3)
    ref_from_port = _ref_trainer(_ckpt_at(root / "port", 2,
                                          tmp_path / "b"), 3).run()
    assert ref_from_port["log"][0]["step"] == 3
    _assert_params_close(_ref_params(ref_from_port), want, near, 3)


def test_block_remat_matches_reference(tmp_path):
    """``remat="block"`` recomputes each block in the backward pass (the
    reference's ``jax.checkpoint``): one step from the same init equals the
    reference's, and the port's own step without remat bit for bit."""
    t0 = _ref_trainer(tmp_path / "init", 0)
    params, state, _ = t0.init_or_resume()
    t0.ckpt.save(0, (params, state), block=True)
    outs = {}
    for remat in ("block", "none"):
        outs[remat] = _port_trainer(_ckpt_at(tmp_path / "init", 0,
                                             tmp_path / remat), 1,
                                    remat=remat).run()
    ref_out = _ref_trainer(_ckpt_at(tmp_path / "init", 0, tmp_path / "ref"),
                           1, remat="block").run()
    got = _port_params(outs["block"])
    _assert_params_close(got, _ref_params(ref_out),
                         _grad_floor(tmp_path / "init", 1), 1)
    for k, v in _port_params(outs["none"]).items():
        np.testing.assert_array_equal(got[k], v)


def test_trainer_checkpoints_and_resumes(tmp_path):
    tcfg = dict(ckpt_every=2)
    out1 = _port_trainer(tmp_path / "run1", 6, **tcfg).run()
    assert out1["final_step"] == 6

    class Boom(RuntimeError):
        pass

    def injector(step):
        if step == 3:
            raise Boom()

    with pytest.raises(Boom):
        _port_trainer(tmp_path / "run2", 6, failure_injector=injector,
                      **tcfg).run()
    t3 = _port_trainer(tmp_path / "run2", 6, **tcfg)
    _, _, start3 = t3.init_or_resume()
    assert start3 == 3  # resumed from the emergency checkpoint
    out3 = t3.run()
    assert out3["final_step"] == 6
    p1, p3 = _port_params(out1), _port_params(out3)
    for k in p1:
        np.testing.assert_allclose(p3[k], p1[k], rtol=1e-5, atol=1e-6)


# -- data pipeline ------------------------------------------------------------

def test_token_batcher_and_prefetcher_match_reference():
    corpus = token_corpus(40, 200, 1000, seed=3)
    for shard in range(2):
        got = pipeline.TokenBatcher(corpus, 8, 32, seed=7, shard=shard,
                                    n_shards=2)
        want = ref_pipeline.TokenBatcher(corpus, 8, 32, seed=7, shard=shard,
                                         n_shards=2)
        for step in (0, 5, 123):
            a, b = got.batch_at(step), want.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
    b = pipeline.TokenBatcher(corpus, 4, 16, seed=0)
    pf = pipeline.Prefetcher(b, start_step=3, depth=2)
    try:
        for want_step in (3, 4, 5):
            step, batch = pf.next()
            assert step == want_step
            np.testing.assert_array_equal(
                batch["tokens"],
                ref_pipeline.TokenBatcher(corpus, 4, 16, seed=0)
                .batch_at(step)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def _recording(monkeypatch, counter_module, *users):
    """Patch ``CountedDistance`` in ``counter_module`` and in the modules
    that bound it at import (``users``) to record every counter made."""
    made = []

    class Recorded(counter_module.CountedDistance):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    for module in (counter_module,) + users:
        monkeypatch.setattr(module, "CountedDistance", Recorded)
    return made


def test_dedup_corpus_matches_reference(monkeypatch):
    corpus = token_corpus(16, 64, 50, seed=2, dup_frac=0.3)
    port = _recording(monkeypatch, counter_mod)
    # the reference's first net makes its own counter (refnet's import)
    ref = _recording(monkeypatch, ref_counter_mod, ref_refnet_mod)
    got = pipeline.dedup_corpus(corpus, lam=16, eps=1.0, max_docs=16,
                                device="cpu")
    want = ref_pipeline.dedup_corpus(corpus, lam=16, eps=1.0, max_docs=16)
    assert len(got) < len(corpus)
    np.testing.assert_array_equal(got, want)
    assert len(port) == len(ref) > 1
    assert all(c.backend == "kernel" for c in port)

    def counts(cs):
        return [(c.count, c.build_count, c.dispatches, c.build_dispatches)
                for c in cs]
    assert counts(port) == counts(ref)


def test_dedup_corpus_rejects_token_ids_inexact_as_f32():
    """Token ids of ``2**24`` and above, which f32 rounds together, are
    carried exactly (the same documents kept as the reference's); ids
    outside int32 are refused."""
    corpus = token_corpus(16, 64, 50, seed=2, dup_frac=0.3)
    big = corpus.astype(np.int64) + (1 << 24)
    got = pipeline.dedup_corpus(big, lam=16, eps=1.0, max_docs=16,
                                device="cpu")
    want = ref_pipeline.dedup_corpus(big, lam=16, eps=1.0, max_docs=16)
    assert len(got) < len(big)
    np.testing.assert_array_equal(got, want)
    big[1, 3] = 1 << 31
    with pytest.raises(ValueError, match="int32"):
        pipeline.dedup_corpus(big, device="cpu")
