"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture, never at
collection) where there is no CUDA device. On a GPU machine run
``python -m pytest tests/test_torch_cuda_kernels.py -q``. Tolerances as in
``chip_smoke.py``: fp32 atol = rtol = 1e-4, bf16 atol 2e-2 / rtol 1e-2.
"""

import pytest
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.flash_attention import (flash_attention_reference,
                                                flash_attention_with_lse)
from apex_tpu_torch.ops.layer_norm import (layer_norm_fwd,
                                           layer_norm_fwd_reference)
from apex_tpu_torch.ops.paged_attention import (paged_attention,
                                                paged_attention_reference)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    return torch.device("cuda")


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_kernel_matches_twin(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(37, 768, generator=g).to(cuda, dtype)
    w = torch.rand(768, generator=g).to(cuda) + 0.5
    b = torch.randn(768, generator=g).to(cuda)
    before = _build.launches["layer_norm_fwd"]
    got = layer_norm_fwd(x, w, b)
    assert _build.launches["layer_norm_fwd"] == before + 1
    for a, r in zip(got, layer_norm_fwd_reference(x, w, b)):
        _close(a, r, dtype if a.dtype == dtype else torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,h,hkv", [(33, 12, 12), (128, 8, 2)])
def test_flash_kernel_matches_twin(cuda, dtype, s, h, hkv):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, h, s, 64, generator=g).to(cuda, dtype)
    k, v = (torch.randn(2, hkv, s, 64, generator=g).to(cuda, dtype)
            for _ in range(2))
    o, lse = flash_attention_with_lse(q, k, v, causal=True)
    ro, rlse = flash_attention_reference(q, k, v, scale=64 ** -0.5)
    _close(o, ro, dtype)
    _close(lse, rlse, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_matches_twin_and_zero_slot_is_zero(cuda, dtype):
    g = torch.Generator().manual_seed(2)
    lengths = torch.tensor([0, 1, 16, 17, 200, 1024], dtype=torch.int32)
    slots, maxp, ps = lengths.shape[0], 64, 16
    perm = torch.randperm(slots * maxp, generator=g) + 1
    bt = torch.zeros(slots, maxp, dtype=torch.int32)
    for i, n in enumerate(lengths.tolist()):
        bt[i, :-(-n // ps)] = perm[i * maxp:i * maxp - (-n // ps)]
    q = torch.randn(slots, 12, 1, 64, generator=g).to(cuda, dtype)
    kp, vp = (torch.randn(1 + slots * maxp, 4, ps, 64, generator=g)
              .to(cuda, dtype) for _ in range(2))
    args = (q, kp, vp, bt.to(cuda), lengths.to(cuda))
    got = paged_attention(*args)
    _close(got, paged_attention_reference(*args), dtype)
    assert (got[0] == 0).all()
