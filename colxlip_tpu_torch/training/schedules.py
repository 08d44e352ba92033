"""Per-step learning-rate schedules: port of ``colxlip_tpu/training/schedules.py``.

Plain functions from the step (0-based) to the learning rate, with the JAX
package's warmup ``base_lr * (step + 1) / warmup_length``:
  - cosine_lr          : linear warmup -> cosine decay to 0
  - const_lr           : linear warmup -> constant
  - const_lr_cooldown  : warmup -> constant -> polynomial cooldown tail
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _warmup(step: float, base_lr: float, warmup_length: int) -> float:
    return base_lr * (step + 1) / max(warmup_length, 1)


def cosine_lr(base_lr: float, warmup_length: int, steps: int) -> Schedule:
    def schedule(step: int) -> float:
        if step < warmup_length:
            return _warmup(step, base_lr, warmup_length)
        e = step - warmup_length
        es = max(steps - warmup_length, 1)
        return 0.5 * (1 + math.cos(math.pi * e / es)) * base_lr
    return schedule


def const_lr(base_lr: float, warmup_length: int) -> Schedule:
    def schedule(step: int) -> float:
        if step < warmup_length:
            return _warmup(step, base_lr, warmup_length)
        return base_lr
    return schedule


def const_lr_cooldown(base_lr: float, warmup_length: int, steps: int,
                      cooldown_steps: int, cooldown_power: float = 1.0,
                      cooldown_end_lr: float = 0.0) -> Schedule:
    def schedule(step: int) -> float:
        # warmup first, as the JAX schedule does (a cooldown window that
        # starts inside the warmup still warms up)
        if step < warmup_length:
            return _warmup(step, base_lr, warmup_length)
        start_cooldown = steps - cooldown_steps
        if step < start_cooldown:
            return base_lr
        # decay clamped at 0: a run past `steps` holds end_lr
        e = max(step - start_cooldown, 0.0)
        decay = max(1 - e / cooldown_steps, 0.0) ** cooldown_power
        return decay * (base_lr - cooldown_end_lr) + cooldown_end_lr
    return schedule
