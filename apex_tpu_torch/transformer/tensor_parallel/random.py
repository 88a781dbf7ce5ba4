"""Model-parallel RNG streams and activation checkpointing.

Counterpart of ``apex_tpu/transformer/tensor_parallel/random.py``. The
reference (Megatron's ``CudaRNGStatesTracker``) keeps named RNG streams so
that dropout inside a tensor-parallel region draws DIFFERENTLY on each rank
(each holds other columns) and identically outside. The JAX package's
streams are functional keys with the rank folded in; here each stream is
an explicit ``torch.Generator``:

- ``model_parallel_seed(seed)`` registers the ``"default"`` stream seeded
  ``seed`` on every rank and the model-parallel stream seeded ``seed + 2718
  + tp_rank`` (upstream Megatron's ``model_parallel_cuda_manual_seed``
  offset, the port's rule; threefry's bits are not reproduced);
- ``fork(name)`` makes a stream the active one, and ``generator()`` hands
  out the active stream's generator for ``torch`` draws (``dropout`` masks
  through ``torch.bernoulli(..., generator=)`` and the like);
- ``get_states``/``set_states`` save and restore every stream's state.

``checkpoint(function, distribute_saved_activations, *args)`` recomputes
``function`` in the backward (``torch.utils.checkpoint``, non-reentrant)
with every tracker stream put back to its state at the forward, so the
recomputed draws equal the forward's: torch's checkpoint restores only the
default generators. ``distribute_saved_activations`` is accepted and
recorded, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from apex_tpu_torch.transformer import parallel_state

#: the reference's ``_MODEL_PARALLEL_RNG_TRACKER_NAME``
_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"
#: the reference's per-rank seed offset of the model-parallel stream
MODEL_PARALLEL_SEED_OFFSET = 2718


class RNGStatesTracker:
    """Named ``torch.Generator`` streams (the reference's
    ``CudaRNGStatesTracker``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._generators: Dict[str, torch.Generator] = {}
        self._active: list = []

    def get_states(self) -> Dict[str, torch.Tensor]:
        return {name: g.get_state() for name, g in self._generators.items()}

    def set_states(self, states) -> None:
        for name, state in states.items():
            self._generators[name].set_state(state)

    def add(self, name: str, seed: int, device="cuda") -> None:
        if name in self._generators:
            raise RuntimeError(f"RNG stream {name} already exists")
        self._generators[name] = torch.Generator(device=device).manual_seed(
            int(seed))

    @contextlib.contextmanager
    def fork(self, name: str = _MODEL_PARALLEL_RNG_TRACKER_NAME):
        if name not in self._generators:
            raise RuntimeError(f"RNG stream {name} is not registered "
                               "(call model_parallel_seed first)")
        self._active.append(name)
        try:
            yield
        finally:
            self._active.pop()

    def generator(self) -> torch.Generator:
        """The active stream's generator (inside ``fork``)."""
        if not self._active:
            raise RuntimeError("generator() called outside tracker.fork(...)")
        return self._generators[self._active[-1]]


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _TRACKER


get_cuda_rng_tracker = get_rng_state_tracker


def model_parallel_seed(seed: int, device="cuda") -> None:
    """The ``"default"`` stream seeded ``seed`` (the same on every rank) and
    the model-parallel stream ``seed + 2718 + tp_rank``."""
    _TRACKER.reset()
    _TRACKER.add("default", seed, device=device)
    _TRACKER.add(_MODEL_PARALLEL_RNG_TRACKER_NAME,
                 seed + MODEL_PARALLEL_SEED_OFFSET
                 + parallel_state.get_tensor_model_parallel_rank(),
                 device=device)


model_parallel_cuda_manual_seed = model_parallel_seed


def checkpoint(function, distribute_saved_activations: bool = False,
               *args, **kwargs):
    """``function(*args)`` whose activations are recomputed in the
    backward, every tracker stream replayed from its state at this
    call."""
    del distribute_saved_activations
    states = _TRACKER.get_states()

    def replay(*a, **kw):
        _TRACKER.set_states(states)
        return function(*a, **kw)

    return _torch_checkpoint(replay, *args, use_reentrant=False, **kwargs)
