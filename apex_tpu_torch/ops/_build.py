"""Build, load and launch the port's CUDA kernels.

Counterpart of ``apex_tpu/ops/_dispatch.py``. Each source in
``apex_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` at first
use into its own shared library with a plain C interface, loaded with
``ctypes``. One source may hold several kernels (``flash_bwd.cu`` holds the
dq and the dk/dv kernels), each with its own name and launch count. The
build lands in ``apex_tpu_torch/_build/`` under a name that carries a hash
of the sources and flags, so an edited source rebuilds and a stale library
is never loaded. All sources build at once, one ``nvcc`` process each,
started together.

A kernel branch that a main path must be shown to take has a name of its
own over the same source and symbol: ``rms_norm_fwd`` and ``rms_norm_bwd``
are the LayerNorm kernels with their ``rms`` flag,
``layer_norm_bwd_from_y`` the LayerNorm backward of ``memory_efficient``
(either norm), ``flash_fwd_window``, ``flash_bwd_dq_window`` and
``flash_bwd_dkdv_window`` the flash kernels under a sliding window,
``paged_attention_window`` the unquantized paged decode under one (a
windowed call over a quantized pool counts as ``paged_attention_quant``),
and ``paged_attention_block``, ``paged_attention_window_block`` and
``paged_attention_quant_block`` the same three paged branches at ``s > 1``
query positions per slot (a speculative verify, a chunked-prefill piece);
each flash kernel's branch with an additive bias counts under its name
with ``_bias`` after it (``flash_fwd_bias``, ``flash_fwd_window_bias``,
``flash_bwd_dq_bias``, ...), and its branch with a causal diagonal
other than ``Sk - Sq`` or dropout at non-zero origins (a ring attention
step) with ``_ring`` after it
(``flash_fwd_ring``, ``flash_fwd_window_ring``, ``flash_bwd_dq_ring``,
...); the scaled-softmax forward counts under
``scaled_softmax_fwd_causal`` with the causal mask,
``scaled_softmax_fwd_masked`` with an explicit mask and
``scaled_softmax_fwd`` with neither.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`launch` raises on a non-zero code. A failed build raises too: a CUDA
tensor never falls back to a kernel's plain PyTorch twin. Each wrapper that
launches a kernel adds one to ``launches[name]``, so a run can show which
kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "layer_norm_fwd": ("layer_norm_fwd.cu",
                       "apex_tpu/ops/layer_norm.py:55"),
    "flash_fwd": ("flash_fwd.cu", "apex_tpu/ops/flash_attention.py:308"),
    "paged_attention": ("paged_attention.cu",
                        "apex_tpu/ops/paged_attention.py:65"),
    "layer_norm_bwd": ("layer_norm_bwd.cu",
                       "apex_tpu/ops/layer_norm.py:134"),
    "flash_bwd_dq": ("flash_bwd.cu", "apex_tpu/ops/flash_attention.py:526"),
    "flash_bwd_dkdv": ("flash_bwd.cu",
                       "apex_tpu/ops/flash_attention.py:572"),
    "adam": ("adam.cu", "apex_tpu/ops/optim_kernels.py:164"),
    "xentropy_fwd": ("xentropy.cu", "apex_tpu/ops/xentropy.py:43"),
    "xentropy_bwd": ("xentropy.cu", "apex_tpu/ops/xentropy.py:65"),
    "segment_stats": ("segment_stats.cu",
                      "apex_tpu/ops/optim_kernels.py:80"),
    "lamb_phase1": ("lamb.cu", "apex_tpu/ops/optim_kernels.py:331"),
    "lamb_phase2": ("lamb.cu", "apex_tpu/ops/optim_kernels.py:379"),
    "dequant_matmul": ("dequant_matmul.cu", "apex_tpu/ops/quant.py:290"),
    "dequant_matmul_w4": ("dequant_matmul.cu", "apex_tpu/ops/quant.py:300"),
    "paged_attention_quant": ("paged_attention.cu",
                              "apex_tpu/ops/paged_attention.py:108"),
    "rms_norm_fwd": ("layer_norm_fwd.cu", "apex_tpu/ops/layer_norm.py:55"),
    "flash_fwd_window": ("flash_fwd.cu",
                         "apex_tpu/ops/flash_attention.py:308"),
    "paged_attention_window": ("paged_attention.cu",
                               "apex_tpu/ops/paged_attention.py:65"),
    "rms_norm_bwd": ("layer_norm_bwd.cu", "apex_tpu/ops/layer_norm.py:134"),
    "layer_norm_bwd_from_y": ("layer_norm_bwd.cu",
                              "apex_tpu/ops/layer_norm.py:134"),
    "flash_bwd_dq_window": ("flash_bwd.cu",
                            "apex_tpu/ops/flash_attention.py:526"),
    "flash_bwd_dkdv_window": ("flash_bwd.cu",
                              "apex_tpu/ops/flash_attention.py:572"),
    "paged_attention_block": ("paged_attention.cu",
                              "apex_tpu/ops/paged_attention.py:65"),
    "paged_attention_window_block": ("paged_attention.cu",
                                     "apex_tpu/ops/paged_attention.py:65"),
    "paged_attention_quant_block": ("paged_attention.cu",
                                    "apex_tpu/ops/paged_attention.py:108"),
    "flash_fwd_bias": ("flash_fwd.cu", "apex_tpu/ops/flash_attention.py:308"),
    "flash_fwd_window_bias": ("flash_fwd.cu",
                              "apex_tpu/ops/flash_attention.py:308"),
    "flash_bwd_dq_bias": ("flash_bwd.cu",
                          "apex_tpu/ops/flash_attention.py:526"),
    "flash_bwd_dq_window_bias": ("flash_bwd.cu",
                                 "apex_tpu/ops/flash_attention.py:526"),
    "flash_bwd_dkdv_bias": ("flash_bwd.cu",
                            "apex_tpu/ops/flash_attention.py:572"),
    "flash_bwd_dkdv_window_bias": ("flash_bwd.cu",
                                   "apex_tpu/ops/flash_attention.py:572"),
    "flash_fwd_ring": ("flash_fwd.cu", "apex_tpu/ops/flash_attention.py:308"),
    "flash_fwd_window_ring": ("flash_fwd.cu",
                              "apex_tpu/ops/flash_attention.py:308"),
    "flash_bwd_dq_ring": ("flash_bwd.cu",
                          "apex_tpu/ops/flash_attention.py:526"),
    "flash_bwd_dq_window_ring": ("flash_bwd.cu",
                                 "apex_tpu/ops/flash_attention.py:526"),
    "flash_bwd_dkdv_ring": ("flash_bwd.cu",
                            "apex_tpu/ops/flash_attention.py:572"),
    "flash_bwd_dkdv_window_ring": ("flash_bwd.cu",
                                   "apex_tpu/ops/flash_attention.py:572"),
    "sgd": ("sgd.cu", "apex_tpu/ops/optim_kernels.py:272"),
    "novograd": ("novograd.cu", "apex_tpu/ops/optim_kernels.py:489"),
    "multi_tensor_scale": ("scale.cu", "apex_tpu/ops/optim_kernels.py:561"),
    "scaled_softmax_fwd": ("scaled_softmax.cu",
                           "apex_tpu/ops/scaled_softmax.py:41"),
    "scaled_softmax_fwd_masked": ("scaled_softmax.cu",
                                  "apex_tpu/ops/scaled_softmax.py:41"),
    "scaled_softmax_fwd_causal": ("scaled_softmax.cu",
                                  "apex_tpu/ops/scaled_softmax.py:41"),
    "scaled_softmax_bwd": ("scaled_softmax.cu",
                           "apex_tpu/ops/scaled_softmax.py:59"),
    "group_norm_fwd": ("group_norm.cu", "apex_tpu/ops/group_norm.py:56"),
    "group_norm_bwd": ("group_norm.cu", "apex_tpu/ops/group_norm.py:153"),
}

#: launches per kernel since the last :func:`reset_launches`
launches = {name: 0 for name in KERNELS}

#: dtype codes shared with ``common.cuh``'s ``ApexDtype``
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3, torch.float16: 4}
#: the compute dtypes every kernel takes, those the scaled-softmax and
#: GroupNorm kernels take (fp16 too: ``FusedScaleMaskSoftmax``'s
#: ``input_in_fp16``), and the narrow storage dtypes of quantized weights and
#: KV pages
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
HALF_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
NARROW_DTYPES = (torch.int8, torch.float8_e4m3fn)

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def source_path(name: str) -> Path:
    return CSRC / KERNELS[name][0]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels build at first use")


def _library_path(name: str) -> Path:
    src = source_path(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD / f"{src.stem}.{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every stale kernel source, all in parallel; returns the wall
    seconds spent. The ptxas report (registers, shared memory, spills) of
    each build is kept beside its library as ``<source stem>.log``."""
    by_source = {}                        # one build per source, not per name
    for name in KERNELS:
        by_source.setdefault(KERNELS[name][0], name)
    stale = [n for n in by_source.values() if not _library_path(n).exists()]
    if not stale:
        return 0.0
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in stale:
        out = _library_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        log_path = BUILD / f"{source_path(name).stem}.log"
        log = open(log_path, "w")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))],
            stdout=log, stderr=subprocess.STDOUT)
        procs.append((proc, tmp, out, log, log_path))
    failed = []
    for proc, tmp, out, log, log_path in procs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(log_path)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        logs = "\n".join(p.read_text()[-4000:] for p in failed)
        raise RuntimeError(f"nvcc failed for {[p.stem for p in failed]}:\n"
                           f"{logs}")
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``'s source (built if stale)."""
    src = KERNELS[name][0]
    with _lock:
        if src not in _libs:
            build_all()
            _libs[src] = ctypes.CDLL(str(_library_path(name)))
        return _libs[src]


def launch(name: str, symbol: str, argtypes, *args) -> None:
    """Call C entry point ``symbol`` of kernel ``name`` on ``args`` (the
    stream last) and raise if it reports a CUDA error. Counts the launch."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        lib = library(name)
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        lib.apex_error_string.argtypes = [ctypes.c_int]
        lib.apex_error_string.restype = ctypes.c_char_p
        _fns[key] = fn
    rc = fn(*args)
    if rc != 0:
        msg = library(name).apex_error_string(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")
    launches[name] += 1


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor, allowed=COMPUTE_DTYPES) -> int:
    if t.dtype not in allowed:
        names = " or ".join(str(d).split(".")[-1] for d in allowed)
        raise TypeError(f"this CUDA kernel takes {names}, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def check_cuda(*tensors: torch.Tensor) -> None:
    """Kernel-side argument check: every tensor on the same CUDA device and
    contiguous (the wrappers make them so before the call)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
