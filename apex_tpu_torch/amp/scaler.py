"""Dynamic loss scaler.

Counterpart of ``apex_tpu/amp/scaler.py``: the reference's algorithm
(start at 2^16, halve on overflow, double after ``scale_window`` clean
steps, clamp to [min, max], with a hysteresis budget of overflows before a
halve), its state held as device tensors and updated by a pure function
inside the optimizer's step, so no host value is read per step.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch


class ScalerState(NamedTuple):
    scale: torch.Tensor               # fp32 0-d
    growth_tracker: torch.Tensor      # int32 0-d: clean steps since growth
    dynamic: torch.Tensor             # fp32 0-d 0/1 flag
    hysteresis_tracker: torch.Tensor  # int32 0-d: overflows before a halve


class LossScaler:
    """API mirror of apex's ``LossScaler``. ``hysteresis``: tolerate that
    many overflow steps before halving; the tracker refills only when the
    scale grows (the reference's ``update_scale_hysteresis.cu``)."""

    def __init__(self, loss_scale: Union[float, str] = 1.0,
                 init_scale: float = 2.0 ** 16, scale_factor: float = 2.0,
                 scale_window: int = 2000, min_loss_scale: float = 1.0,
                 max_loss_scale: float = 2.0 ** 24, hysteresis: int = 1,
                 device=None):
        self.dynamic = loss_scale == "dynamic"
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._min_scale = min_loss_scale
        self._max_scale = max_loss_scale
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        self._hysteresis = hysteresis
        init = init_scale if self.dynamic else float(loss_scale)
        self.state = self._make_state(init, 0, hysteresis, device)

    def _make_state(self, scale, tracker, hyst, device) -> ScalerState:
        return ScalerState(
            scale=torch.as_tensor(scale, dtype=torch.float32, device=device),
            growth_tracker=torch.as_tensor(tracker, dtype=torch.int32,
                                           device=device),
            dynamic=torch.tensor(1.0 if self.dynamic else 0.0,
                                 dtype=torch.float32, device=device),
            hysteresis_tracker=torch.as_tensor(hyst, dtype=torch.int32,
                                               device=device))

    def loss_scale(self) -> torch.Tensor:
        return self.state.scale

    def scale_loss(self, loss):
        return loss * self.state.scale.to(device=loss.device,
                                          dtype=loss.dtype)

    def update(self, state: ScalerState, found_inf) -> ScalerState:
        """Pure update on device tensors: on overflow decrement the
        hysteresis tracker and halve once it reaches 0; double after
        ``scale_window`` clean steps (refilling the tracker); clamp to
        [min, max]. A static scaler's state comes back unchanged."""
        found = torch.as_tensor(found_inf,
                                device=state.scale.device).to(torch.bool)
        zero = torch.zeros_like(state.growth_tracker)
        hyst = torch.where(found,
                           torch.clamp(state.hysteresis_tracker - 1, min=0),
                           state.hysteresis_tracker)
        halve = found & (hyst <= 0)
        new_scale = torch.where(halve, state.scale / self._scale_factor,
                                state.scale)
        tracker = torch.where(found, zero, state.growth_tracker + 1)
        grow = tracker >= self._scale_window
        new_scale = torch.where(grow, new_scale * self._scale_factor,
                                new_scale)
        tracker = torch.where(grow, zero, tracker)
        hyst = torch.where(grow, torch.full_like(hyst, self._hysteresis),
                           hyst)
        new_scale = torch.clamp(new_scale, self._min_scale, self._max_scale)
        is_dyn = state.dynamic > 0.0
        return ScalerState(
            scale=torch.where(is_dyn, new_scale, state.scale),
            growth_tracker=torch.where(is_dyn, tracker, state.growth_tracker),
            dynamic=state.dynamic,
            hysteresis_tracker=torch.where(is_dyn, hyst,
                                           state.hysteresis_tracker))

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> dict:
        return {"scale": self.state.scale.clone(),
                "growth_tracker": self.state.growth_tracker.clone(),
                "dynamic": self.dynamic,
                "hysteresis_tracker": self.state.hysteresis_tracker.clone()}

    def load_state_dict(self, sd: dict) -> None:
        self.dynamic = bool(sd["dynamic"])
        device = self.state.scale.device
        # checkpoints from before hysteresis restore to a full tracker
        self.state = self._make_state(
            sd["scale"], sd["growth_tracker"],
            sd.get("hysteresis_tracker", self._hysteresis), device)
