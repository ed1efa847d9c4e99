"""Learning-rate policies and the Adam optimizer, in PyTorch.

Port of `viai_tpu/train/schedules.py`. The policies mirror the
reference's --lr_policy {lambda|step|plateau|cosine|constant}: the
closed-form ones are functions of the update count over epochs of
`steps_per_epoch` updates. `Adam` computes what the JAX package's
optax chain computes, in the same order:

    mu ← (1−β1)·g + β1·mu,  nu ← (1−β2)·g² + β2·nu,  t ← t + 1
    u  = −lr(k) · (mu/(1−β1^t)) / (sqrt(nu/(1−β2^t)) + eps)   [· scale]
    p  ← p + u

where k is the update's index counted from 0 (optax reads the schedule
before it increments its count), and `scale`, under
--lr_policy plateau, is the state of `ReduceOnPlateau`, a port of
optax.contrib.reduce_on_plateau: it averages the loss values fed to
`step(value=...)` over `accumulation_size` updates, and once per such
window cuts the scale by `factor` after `patience` windows without a
relative improvement of `rtol` (plus `atol`), then waits `cooldown`
windows. The new scale multiplies the update it was computed with.
torch's ReduceLROnPlateau counts and compares differently and is not
used. The plateau state lives on the parameters' device, so the loss
value is never read on the host.
"""

from __future__ import annotations

import math
import typing as tp

import torch

Schedule = tp.Callable[[int], float]


def lambda_linear(lr: float, niter: int, niter_decay: int,
                  steps_per_epoch: int) -> Schedule:
    """Constant for `niter` epochs, then linear decay to 0 over
    `niter_decay`; the epoch is the float count / steps_per_epoch."""

    def sched(step):
        epoch = step / max(steps_per_epoch, 1)
        frac = min(max((epoch - niter) / max(niter_decay, 1), 0.0), 1.0)
        return lr * (1.0 - frac)

    return sched


def step_decay(lr: float, lr_decay_iters: int, steps_per_epoch: int,
               gamma: float = 0.1) -> Schedule:
    """×gamma every lr_decay_iters epochs (reference 'step' policy)."""

    def sched(step):
        epoch = step // max(steps_per_epoch, 1)
        return lr * gamma ** (epoch // lr_decay_iters)

    return sched


def cosine(lr: float, niter: int, niter_decay: int,
           steps_per_epoch: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule(lr, total, alpha) over all epochs:
    lr·((1−α)·½(1 + cos(π·min(s, T)/T)) + α), T the total updates; the
    refiner trains with α 0.1 over --steps updates (niter = steps,
    niter_decay = 0, one update an epoch)."""
    total = max((niter + niter_decay) * steps_per_epoch, 1)

    def sched(step):
        decay = 0.5 * (1.0 + math.cos(math.pi * min(step, total) / total))
        return lr * ((1.0 - alpha) * decay + alpha)

    return sched


def make_schedule(policy: str, lr: float, *, niter: int = 100,
                  niter_decay: int = 100, lr_decay_iters: int = 50,
                  steps_per_epoch: int = 1) -> Schedule:
    if policy == "lambda":
        return lambda_linear(lr, niter, niter_decay, steps_per_epoch)
    if policy == "step":
        return step_decay(lr, lr_decay_iters, steps_per_epoch)
    if policy == "cosine":
        return cosine(lr, niter, niter_decay, steps_per_epoch)
    if policy in ("constant", "plateau"):
        # plateau: the base lr is constant; ReduceOnPlateau scales it.
        return lambda _: lr
    raise ValueError(f"unknown lr policy: {policy}")


def plateau_kwargs(steps_per_epoch: int) -> dict:
    """Reference ReduceLROnPlateau(factor 0.2, threshold 0.01, patience
    5) stepped once per epoch → ReduceOnPlateau arguments."""
    return dict(factor=0.2, patience=5, rtol=0.01, cooldown=0,
                accumulation_size=max(steps_per_epoch, 1))


class ReduceOnPlateau:
    """optax.contrib.reduce_on_plateau's state machine on 0-dim float32
    (and int32) tensors of one device; see the module docstring."""

    def __init__(self, factor: float = 0.1, patience: int = 10,
                 rtol: float = 1e-4, atol: float = 0.0, cooldown: int = 0,
                 accumulation_size: int = 1, min_scale: float = 0.0,
                 device: str | torch.device = "cpu"):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"Factor must be in the range (0, 1), got "
                             f"factor = {factor}.")
        if rtol < 0.0 or atol < 0.0 or (rtol == 0.0 and atol == 0.0) \
                or rtol > 1.0:
            raise ValueError(f"need 0 ≤ rtol ≤ 1, atol ≥ 0 and one of them "
                             f"positive, got rtol = {rtol}, atol = {atol}")
        self.factor, self.patience = factor, patience
        self.rtol, self.atol = rtol, atol
        self.cooldown, self.min_scale = cooldown, min_scale
        self.accumulation_size = accumulation_size
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self.state = {
            "scale": torch.ones((), **f32),
            "best_value": torch.full((), float("inf"), **f32),
            "plateau_count": torch.zeros((), **i32),
            "cooldown_count": torch.zeros((), **i32),
            "avg_value": torch.zeros((), **f32),
            "count": 0,                   # values in the current window
        }

    def update(self, value) -> torch.Tensor:
        """Feed one loss value; → the scale for this update."""
        s = self.state
        count = s["count"]
        value = torch.as_tensor(value, dtype=torch.float32,
                                device=s["avg_value"].device)
        s["avg_value"] = (count * s["avg_value"] + value) / (count + 1)
        s["count"] = count + 1
        if s["count"] == self.accumulation_size:
            self._update_scale()
        return s["scale"]

    def _update_scale(self):
        s = self.state
        avg = s["avg_value"]
        improved = avg < (1 - self.rtol) * s["best_value"] - self.atol
        s["best_value"] = torch.where(improved, avg, s["best_value"])
        curr = torch.where(improved, torch.zeros_like(s["plateau_count"]),
                           s["plateau_count"] + 1)
        cooling = s["cooldown_count"] > 0
        hit = curr == self.patience
        zero = torch.zeros_like(curr)
        reduced = torch.clamp(torch.where(hit, s["scale"] * self.factor,
                                          s["scale"]), min=self.min_scale)
        s["plateau_count"] = torch.where(cooling | hit, zero, curr)
        s["scale"] = torch.where(cooling, s["scale"], reduced)
        s["cooldown_count"] = torch.where(
            cooling, s["cooldown_count"] - 1,
            torch.where(hit, torch.full_like(curr, self.cooldown), zero))
        s["count"] = 0
        s["avg_value"] = torch.zeros_like(avg)


class Adam(torch.optim.Optimizer):
    """Adam with optax's arithmetic and count, a schedule lr(k), and an
    optional ReduceOnPlateau (`plateau`: its keyword arguments)."""

    def __init__(self, params, lr_schedule: Schedule | float,
                 betas: tuple[float, float] = (0.5, 0.999),
                 eps: float = 1e-8, plateau: dict | None = None):
        sched = (lr_schedule if callable(lr_schedule)
                 else (lambda _, lr=float(lr_schedule): lr))
        super().__init__(params, dict(betas=betas, eps=eps))
        self.lr_schedule = sched
        self.count = 0
        dev = self.param_groups[0]["params"][0].device
        self.plateau = (ReduceOnPlateau(**plateau, device=dev)
                        if plateau else None)

    @torch.no_grad()
    def step(self, closure=None, value=None):
        """One update from the params' .grad; `value` (the loss) feeds
        the plateau state and is ignored without it."""
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        lr = float(self.lr_schedule(self.count))
        self.count += 1
        t = self.count
        scale = None
        if self.plateau is not None:
            if value is None:
                raise ValueError("the plateau policy needs step(value=loss)")
            scale = self.plateau.update(value)
        for group in self.param_groups:
            b1, b2 = group["betas"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            # mu ← (1−b1)·g + b1·mu ; nu ← (1−b2)·g² + b2·nu (optax order)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
            c1 = float(torch.tensor(1.0) - torch.tensor(b1) ** t)
            c2 = float(torch.tensor(1.0) - torch.tensor(b2) ** t)
            den = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(mu, c1)
            torch._foreach_div_(upd, den)
            torch._foreach_mul_(upd, -lr)
            if scale is not None:
                torch._foreach_mul_(upd, scale)
            torch._foreach_add_(params, upd)
        return None

    def state_dict(self):
        sd = super().state_dict()
        sd["count"] = self.count
        if self.plateau is not None:
            sd["plateau"] = dict(self.plateau.state)
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        plateau = state_dict.pop("plateau", None)
        if (plateau is None) != (self.plateau is None):
            raise ValueError("the checkpoint's plateau state does not match "
                             "the optimizer's lr policy")
        if plateau is not None:
            dev = self.plateau.state["scale"].device
            self.plateau.state = {k: v.to(dev) if torch.is_tensor(v) else v
                                  for k, v in plateau.items()}
        super().load_state_dict(state_dict)


def adam(params, lr_schedule: Schedule | float, beta1: float = 0.5,
         beta2: float = 0.999, plateau: dict | None = None) -> Adam:
    """Adam(β1 = 0.5, β2 = 0.999, eps = 1e-8), the pix2pix/GAN
    convention, over `params`; `plateau` (from plateau_kwargs) adds the
    loss-reactive scale."""
    return Adam(params, lr_schedule, betas=(beta1, beta2), plateau=plateau)


def plateau_scale(opt) -> float | None:
    """The current plateau scale of an optimizer, if it has one."""
    plateau = getattr(opt, "plateau", None)
    if plateau is None:
        return None
    return float(plateau.state["scale"])


def optimizer_step(opt: torch.optim.Optimizer, value: torch.Tensor):
    """One update of `opt`; the loss `value` goes to an optimizer that
    takes it (Adam, and train/mesh.py's ShardedOptimizer, which passes
    it on), the others (e.g. torch.optim.SGD) ignore it."""
    if isinstance(opt, Adam) or getattr(opt, "takes_loss", False):
        opt.step(value=value)
    else:
        opt.step()
