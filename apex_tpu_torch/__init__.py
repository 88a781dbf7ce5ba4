"""apex_tpu_torch: the PyTorch/CUDA port of apex_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``apex_tpu``. It imports torch
and numpy only — never jax, flax or anything under ``apex_tpu``. Its CUDA
kernels (``csrc/``) build with ``nvcc`` at first use on a CUDA tensor;
importing the package builds nothing and needs neither ``nvcc`` nor a card.

Subpackages load lazily: ``apex_tpu_torch.serving``, ``.models``,
``.ops``, ``.normalization``, ``.optimizers``, ``.transformer``,
``.contrib``, ``.amp``, ``.parallel``, ``.examples``.
"""

import importlib

__version__ = "0.1.0"

_SUBPACKAGES = ("amp", "bridge", "contrib", "examples", "models",
                "normalization", "ops", "optimizers", "parallel", "serving",
                "transformer")


def __getattr__(name):
    if name in _SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
