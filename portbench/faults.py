"""Faults planted in the program's timed path, to show that the check
catches them: each `plant(name)` patches the program in this process and
returns a function that takes the patch out.

- `still_step`: a step that returns its state unchanged (no optimizer
  update);
- `half_batch`: half of a training batch left out, the loss's mean taken
  over the rest;
- `shift_landmarks`: an answer altered where it is produced (every
  landmark the data source extracts moved by one pixel in x).

The single-card cell has no exchange between chips to leave out.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

TRAINING = ("still_step", "half_batch", "shift_landmarks")


def _patch(owner, name: str, value) -> Callable[[], None]:
    old = getattr(owner, name)
    setattr(owner, name, value)
    return lambda: setattr(owner, name, old)


def plant(name: str) -> Callable[[], None]:
    from contouring_uncertainty_torch.data import camus
    from contouring_uncertainty_torch.tasks import dsnt_al
    from contouring_uncertainty_torch.train.trainer import Trainer

    if name == "still_step":
        return _patch(Trainer, "apply_update", lambda self, step: None)
    if name == "half_batch":
        task = dsnt_al.DSNTAleatoric
        loss = task.loss

        def half_loss(self, model, batch, generator=None, train=True):
            return loss(self, model, {k: v[:len(v) // 2] for k, v in batch.items()},
                        generator, train)

        return _patch(task, "loss", half_loss)
    if name == "shift_landmarks":
        extract = camus.get_contour_points

        def shifted(*args, **kwargs):
            points = extract(*args, **kwargs)
            return points + np.array([1, 0], points.dtype)

        return _patch(camus, "get_contour_points", shifted)
    raise KeyError(f"no fault {name!r}")
