"""Training loop with checkpoint/restart, preemption handling and metrics:
the port of ``repro.train.train_loop``.

The loop is deliberately boring: a step + feeder + periodic checkpoint.
Fault tolerance is the point —
  * restart: ``run()`` restores the newest complete checkpoint (params,
    optimizer state, data cursor) and continues bit for bit (the feeder is
    a deterministic function of (seed, step), and the step's arithmetic is
    the same on every run: table lookups go through
    ``torch.nn.functional.embedding``, whose CUDA backward accumulates
    duplicates in a sorted order, not with atomics);
  * preemption: ``request_stop()`` finishes the in-flight step,
    checkpoints, and returns;
  * divergence guard: a non-finite loss restores the last checkpoint and
    continues with the LR scaled by ``lr_decay_on_divergence``.

Gradients come from ``torch.autograd``; the step runs eagerly on the
parameters' device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import (
    OptimizerConfig,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
)
from repro_torch.train.tree import leaves, tree_map, unflatten_like


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    log_every: int = 10
    lr: float = 3e-4
    warmup: int = 10
    grad_clip: float = 1.0
    optimizer: str = "adamw"
    lr_decay_on_divergence: float = 0.5


def _to_device(tree, dev: torch.device):
    return tree_map(lambda x: torch.as_tensor(x).to(dev), tree)


class Trainer:
    """``loss_fn(params, batch) -> (loss, metrics dict)`` over a tree of
    tensors; ``params`` (tensors or numpy arrays) move to ``device``.

    ``donate`` is kept for the reference's signature and has no effect:
    each step writes new parameter and state tensors and drops the old
    ones, which frees them as soon as nothing else holds them.
    """

    def __init__(self, loss_fn: Callable, params: Any, cfg: TrainLoopConfig,
                 donate: bool = True, device="cuda"):
        del donate
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.device = resolve_device(device)
        opt_cfg = OptimizerConfig(name=cfg.optimizer, lr=cfg.lr,
                                  grad_clip=cfg.grad_clip)
        self.opt_init, self.opt_update = make_optimizer(opt_cfg)
        self.schedule = cosine_schedule(cfg.lr, cfg.warmup, cfg.total_steps)
        self.params = _to_device(params, self.device)
        self.opt_state = self.opt_init(self.params)
        self.step = 0
        self._stop_requested = False
        self._lr_scale = 1.0

    def _train_step(self, params, opt_state, batch, step: int,
                    lr_scale: float):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        live = unflatten_like(params, flat)
        loss, metrics = self.loss_fn(live, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = unflatten_like(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, grads)])
        grads, gnorm = clip_by_global_norm(grads, self.cfg.grad_clip)
        dev = self.device
        lr = (self.schedule(torch.tensor(step, dtype=torch.int32, device=dev))
              * torch.tensor(lr_scale, dtype=torch.float32, device=dev))
        with torch.no_grad():
            new_params, new_state = self.opt_update(
                grads, opt_state, unflatten_like(params, [
                    p.detach() for p in flat]), lr)
        metrics = {k: v.detach() for k, v in dict(metrics).items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm, lr=lr)
        return new_params, new_state, metrics

    # ---- fault-tolerance API ----
    def request_stop(self):
        """Preemption hook: finish the current step, checkpoint, return."""
        self._stop_requested = True

    def save(self):
        if not self.cfg.ckpt_dir:
            return
        ckpt_lib.save_checkpoint(
            self.cfg.ckpt_dir, self.step,
            {"params": self.params, "opt": self.opt_state},
            extra={"lr_scale": self._lr_scale},
            keep=self.cfg.ckpt_keep,
        )

    def maybe_restore(self) -> bool:
        if not self.cfg.ckpt_dir:
            return False
        res = ckpt_lib.restore_checkpoint(
            self.cfg.ckpt_dir, {"params": self.params, "opt": self.opt_state})
        if res is None:
            return False
        step, state, extra = res
        self.step = step
        self.params = ckpt_lib.params_from_numpy(state["params"], self.device)
        self.opt_state = ckpt_lib.params_from_numpy(state["opt"], self.device)
        self._lr_scale = float(extra.get("lr_scale", 1.0))
        return True

    # ---- the loop ----
    def run(self, feeder, max_steps: Optional[int] = None
            ) -> Dict[str, list]:
        self.maybe_restore()
        history: Dict[str, list] = {"loss": [], "step": []}
        target = min(
            self.cfg.total_steps,
            self.step + (max_steps or self.cfg.total_steps),
        )
        t0 = time.time()
        while self.step < target and not self._stop_requested:
            data_step, batch = next(feeder)
            if data_step < self.step:  # skip ahead after restore
                continue
            batch = _to_device(batch, self.device)
            self.params, self.opt_state, metrics = self._train_step(
                self.params, self.opt_state, batch, self.step,
                self._lr_scale)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                # divergence: restore last good state, decay LR, continue
                restored = self.maybe_restore()
                self._lr_scale *= self.cfg.lr_decay_on_divergence
                if not restored:
                    raise FloatingPointError(
                        f"non-finite loss at step {self.step}, no checkpoint")
                continue
            self.step += 1
            history["loss"].append(loss)
            history["step"].append(self.step)
            if self.step % self.cfg.ckpt_every == 0:
                self.save()
            if self.step % self.cfg.log_every == 0:
                rate = self.step / max(time.time() - t0, 1e-9)
                print(f"step {self.step} loss {loss:.4f} "
                      f"({rate:.2f} steps/s)")
        self.save()
        return history
