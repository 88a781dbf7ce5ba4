"""ASP: the automatic (2:4 structured) sparsity workflow.

Counterpart of ``apex_tpu/contrib/sparsity/asp.py`` (the reference's
``apex/contrib/sparsity/asp.py``), in PyTorch's idiom: the classmethod API
over a module's ``named_parameters()`` and the port's fused optimizers.
``init_model_for_pruning`` registers an all-ones mask for every prunable
weight; ``init_optimizer_for_pruning`` wraps ``optimizer.step`` so that
the flat gradient buffer is masked going in and the flat master buffer
(every parameter is a view into it) coming out: one flat fp32 mask in the
optimizer's ``flat_buffer`` layout, one multiply each way;
``compute_sparse_masks`` fills the masks from the weights' magnitudes
(``m4n2_1d``, optionally after a channel-permutation search) and masks the
weights in place; ``prune_trained_model`` is the three in a row. Masks
group along the last dimension of each tensor as stored (BERT keeps the
reference's ``(in, out)`` layout, so its masks equal the reference's). As
in the reference, the masks are class state: one model at a time, and
``reset`` forgets them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from apex_tpu_torch.contrib.sparsity import sparse_masklib
from apex_tpu_torch.contrib.sparsity.permutation_lib import (
    apply_permutation_and_mask, search_permutation)
from apex_tpu_torch.ops import flat_buffer


def _default_prunable(name: str, p: torch.Tensor) -> bool:
    """The reference whitelist's analog: weights of 2+ dimensions whose
    last dimension divides by 4, skipping embeddings, norms and biases by
    name."""
    if p.ndim < 2:
        return False
    n = name.lower()
    if any(t in n for t in ("emb", "norm", "bias", "bn")):
        return False
    return p.shape[-1] % 4 == 0


def _named(model):
    """``(name, tensor)`` pairs of a module's parameters, or of a mapping
    or iterable of such pairs."""
    if hasattr(model, "named_parameters"):
        return list(model.named_parameters())
    if hasattr(model, "items"):
        return list(model.items())
    return list(model)


class ASP:
    """Drop-in for ``apex.contrib.sparsity.ASP`` (classmethod API)."""

    __masks: Optional[Dict[str, torch.Tensor]] = None   # bool, by name
    __pattern = "m4n2_1d"
    __allow_recompute = False
    __allow_permutation = False
    __calculate_verbosity = 0
    __optimizer = None
    __orig_step = None
    __flat_mask: Optional[torch.Tensor] = None

    # -- the reference's API ---------------------------------------------
    @classmethod
    def init_model_for_pruning(cls, model, mask_calculator: str = "m4n2_1d",
                               verbosity: int = 3, whitelist=None,
                               allowed_layer_names=None,
                               disallowed_layer_names=(),
                               allow_recompute_mask: bool = False,
                               custom_layer_dict=None,
                               allow_permutation: bool = False,
                               prunable: Optional[Callable] = None):
        """Register an all-ones bool mask for every prunable parameter of
        ``model`` (a module, or ``(name, tensor)`` pairs).
        ``prunable(name, tensor) -> bool`` overrides the default whitelist;
        ``disallowed_layer_names`` and ``allowed_layer_names`` are
        substrings of names excluded or required. Returns the masks by
        name."""
        del whitelist, custom_layer_dict
        pred = prunable or _default_prunable
        masks = {}
        for name, p in _named(model):
            if any(d in name for d in disallowed_layer_names):
                continue
            if allowed_layer_names is not None and not any(
                    a in name for a in allowed_layer_names):
                continue
            if pred(name, p):
                masks[name] = torch.ones(p.shape, dtype=torch.bool,
                                         device=p.device)
        cls.__masks = masks
        cls.__pattern = mask_calculator
        cls.__allow_recompute = allow_recompute_mask
        cls.__allow_permutation = allow_permutation
        cls.__calculate_verbosity = verbosity
        cls._build_flat_mask()
        return cls.__masks

    @classmethod
    def init_optimizer_for_pruning(cls, optimizer):
        """Wrap ``optimizer.step`` (a port fused optimizer): the flat
        gradients are masked before the inner step and the flat master
        after it. Calling it twice raises ``RuntimeError``, as the
        reference does."""
        if cls.__optimizer is not None:
            raise RuntimeError(
                "ASP.init_optimizer_for_pruning called twice (reference "
                "raises the same)")
        cls.__optimizer = optimizer
        cls.__orig_step = optimizer.step
        cls._build_flat_mask()

        def masked_step(closure=None, **kwargs):
            mask = cls.__flat_mask
            if mask is None:
                return cls.__orig_step(closure, **kwargs)
            # the closure's backward runs before the mask, so the inner
            # step sees only masked gradients
            loss = None
            if closure is not None:
                with torch.enable_grad():
                    loss = closure()
            optimizer._gather_grads()
            optimizer.grads.mul_(mask)
            cls.__orig_step(None, **kwargs)
            optimizer.master.mul_(mask)
            return loss

        optimizer.step = masked_step
        return optimizer

    @classmethod
    def compute_sparse_masks(cls, model):
        """Fill the registered masks from the magnitudes of ``model``'s
        tensors and mask them in place; returns the masks by name."""
        if cls.__masks is None:
            raise RuntimeError("call init_model_for_pruning first")
        params = {n: p for n, p in _named(model) if n in cls.__masks}
        with torch.no_grad():
            for name, p in params.items():
                flat2d = p.detach().reshape(-1, p.shape[-1])
                if cls.__allow_permutation:
                    perm, _ = search_permutation(flat2d.abs())
                    m = apply_permutation_and_mask(flat2d, perm)
                else:
                    m = sparse_masklib.create_mask(flat2d, cls.__pattern)
                cls.__masks[name] = m.reshape(p.shape)
        cls._build_flat_mask()
        cls.apply_masks(params)
        return cls.__masks

    @classmethod
    def prune_trained_model(cls, model, optimizer):
        """The one-call recipe: init the model and the optimizer, then
        compute the masks. Returns ``(model, optimizer)``."""
        cls.init_model_for_pruning(model)
        cls.init_optimizer_for_pruning(optimizer)
        cls.compute_sparse_masks(model)
        return model, optimizer

    @classmethod
    def is_sparsity_enabled(cls) -> bool:
        return cls.__masks is not None

    @classmethod
    def restore_pruned_weights(cls, model):
        """Drop the masks and the optimizer hook (the reference's
        ``restore_pruned_weights``). The weights were masked in place and
        stay as they are; training goes on dense from them."""
        cls.reset()
        return model

    # -- helpers ----------------------------------------------------------
    @classmethod
    def masks(cls):
        return cls.__masks

    @classmethod
    def apply_masks(cls, model):
        """Multiply the masked tensors of ``model`` (a module, or ``(name,
        tensor)`` pairs) by their masks in place; others stay as they
        are. Returns ``model``."""
        with torch.no_grad():
            for name, t in _named(model):
                mask = cls.__masks.get(name)
                if mask is not None:
                    t.mul_(mask.to(device=t.device, dtype=t.dtype))
        return model

    @classmethod
    def _build_flat_mask(cls) -> None:
        """The masks in the hooked optimizer's flat layout, fp32, ones
        where no mask applies (the padding included)."""
        opt = cls.__optimizer
        if opt is None or cls.__masks is None:
            cls.__flat_mask = None
            return
        flat = torch.ones_like(opt.master)
        views = flat_buffer.unflatten(flat, opt.spec)
        for name, mask in cls.__masks.items():
            if name in views:
                views[name].copy_(mask)
        cls.__flat_mask = flat

    @classmethod
    def state_dict(cls):
        """The masks by name and the pattern (the reference checkpoints
        its masks as registered buffers)."""
        return {"masks": cls.__masks, "pattern": cls.__pattern}

    @classmethod
    def load_state_dict(cls, sd):
        cls.__masks = sd["masks"]
        cls.__pattern = sd.get("pattern", "m4n2_1d")
        cls._build_flat_mask()

    @classmethod
    def reset(cls):
        """Forget the masks and restore the hooked optimizer's ``step``."""
        opt = cls.__optimizer
        if opt is not None and cls.__orig_step is not None:
            if getattr(cls.__orig_step, "__func__", None) is type(opt).step:
                # the class's own method again; storing the bound method on
                # the instance would tie the optimizer to itself in a cycle
                # that only the collector frees
                del opt.step
            else:
                opt.step = cls.__orig_step
        cls.__masks = None
        cls.__optimizer = None
        cls.__orig_step = None
        cls.__flat_mask = None
