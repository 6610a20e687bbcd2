"""Preemption-safe training loop.

Fault-tolerance contract, as the reference's:

* checkpoint every ``ckpt_every`` steps (async, atomic) + on preemption
  signal + on exit;
* resume-from-latest reproduces the exact data stream ((seed, step)-keyed
  batches) so a restarted job continues where it stopped;
* a ``failure_injector`` hook lets tests kill the loop at arbitrary steps
  and assert recovery;
* slow-step (straggler) detection surfaces as metrics.

Checkpoints hold ``(params, opt_state)`` in the reference's tree layout
(layer-stacked parameters and moments via ``params_to_jax``, the step as an
int32 scalar), so each package resumes the other's training checkpoints.
Parameters are f32, initialised from ``torch.Generator(device)`` seeded
with ``rng_seed``; a step's time includes waiting for the device.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.models.params import (decay_mask, init_params,
                                       params_from_jax, params_to_jax,
                                       port_leaves)
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_state import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0


class Trainer:
    def __init__(self, model, cfg, opt_cfg: opt_lib.OptConfig,
                 batcher: TokenBatcher, ckpt_dir, tcfg: TrainerConfig,
                 failure_injector: Optional[Callable] = None, device=None):
        self.model = model
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.batcher = batcher
        self.tcfg = tcfg
        self.device = device_mod.resolve(device)
        self.ckpt = CheckpointManager(ckpt_dir, keep=tcfg.keep_ckpts)
        self.step_fn = make_train_step(model, cfg, opt_cfg)
        self.defs = model.param_defs(cfg)
        self.failure_injector = failure_injector
        self._preempted = False
        self.metrics_log: List[Dict] = []

    def _handle_preemption(self, signum, frame):
        self._preempted = True

    # -- state in the reference's layout ----------------------------------

    def _to_tree(self, params, opt_state):
        """``(params, opt_state)`` as the reference's trees of numpy arrays
        (bf16 moments widened to f32, which is exact)."""
        state = params.state_dict()

        def moments(d):
            return params_to_jax({k: t.to(torch.float32)
                                  for k, t in d.items()}, self.defs)
        return (params_to_jax(state, self.defs),
                {"m": moments(opt_state["m"]), "v": moments(opt_state["v"]),
                 "step": np.asarray(opt_state["step"].cpu())})

    def _template(self):
        shapes = {}
        for path, d, _ in port_leaves(self.defs):
            node = shapes
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = np.broadcast_to(np.float32(0), d.shape)
        return (shapes, {"m": shapes, "v": shapes,
                         "step": np.zeros((), np.int32)})

    def _load(self, params, opt_state, tree):
        ptree, otree = tree
        params.load_state_dict(params_from_jax(ptree, dtype=torch.float32,
                                               device=self.device))
        for key in ("m", "v"):
            dt = next(iter(opt_state[key].values())).dtype
            got = params_from_jax(otree[key], dtype=dt, device=self.device)
            opt_state[key] = {k: got[k] for k in opt_state[key]}
        opt_state["step"] = torch.as_tensor(
            np.asarray(otree["step"], np.int32), device=self.device)

    def init_or_resume(self, rng_seed: int = 0):
        gen = torch.Generator(self.device).manual_seed(rng_seed)
        tree = init_params(self.defs, gen, torch.float32, self.device)
        params = self.model.build(self.cfg, tree, dtype=torch.float32,
                                  device=self.device).requires_grad_(True)
        named = dict(params.named_parameters())
        opt_state = opt_lib.init_state(
            {k: named[k] for k in decay_mask(self.defs)}, self.opt_cfg)
        start = 0
        if self.ckpt.latest_step() is not None:
            tree, meta = self.ckpt.restore(self._template())
            self._load(params, opt_state, tree)
            start = meta["step"]
        return params, opt_state, start

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, rng_seed: int = 0) -> Dict:
        params, opt_state, start = self.init_or_resume(rng_seed)
        old = signal.signal(signal.SIGTERM, self._handle_preemption)
        durations: List[float] = []
        completed = start
        try:
            for step in range(start, self.tcfg.total_steps):
                if self.failure_injector is not None:
                    self.failure_injector(step)
                batch = self.batcher.batch_at(step)
                t0 = time.time()
                params, opt_state, m = self.step_fn(params, opt_state, batch)
                self._sync()
                completed = step + 1
                dt = time.time() - t0
                durations.append(dt)
                med = float(np.median(durations[-50:]))
                straggler = dt > self.tcfg.straggler_factor * med \
                    and len(durations) > 5
                if step % self.tcfg.log_every == 0 or straggler:
                    self.metrics_log.append({
                        "step": step + 1,
                        "loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "lr": float(m["lr"]),
                        "step_s": dt,
                        "straggler": bool(straggler),
                    })
                if completed % self.tcfg.ckpt_every == 0 or self._preempted:
                    self.ckpt.save(completed,
                                   self._to_tree(params, opt_state))
                if self._preempted:
                    break
        finally:
            # emergency/final checkpoint labels the COMPLETED step count,
            # so resume after a mid-step crash replays the failed step
            self.ckpt.save(completed, self._to_tree(params, opt_state),
                           block=True)
            signal.signal(signal.SIGTERM, old)
        return {"params": params, "opt_state": opt_state,
                "final_step": completed, "log": self.metrics_log}

