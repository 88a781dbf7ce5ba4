"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture, never at
collection) where there is no CUDA device. On a GPU machine run
``python -m pytest tests/test_torch_cuda_kernels.py -q``. Tolerances as in
``chip_smoke.py``: fp32 atol = rtol = 1e-4, bf16 atol 2e-2 / rtol 1e-2 (the
backward kernels' summed outputs at wider bf16 bounds, stated where used).
Each test also checks that the wrapper counted exactly its launches.
"""

import pytest
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                flash_attention_bwd_reference,
                                                flash_attention_reference,
                                                flash_attention_with_lse)
from apex_tpu_torch.ops.layer_norm import (layer_norm, layer_norm_bwd,
                                           layer_norm_bwd_reference,
                                           layer_norm_fwd,
                                           layer_norm_fwd_reference)
from apex_tpu_torch.ops.optim_kernels import (adam_update,
                                              adam_update_reference)
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


def _bwd_close(got, want, dtype):
    """bf16 backward outputs sum hundreds of rounded products: compare with
    atol 5e-2 / rtol 2e-2 (about two bf16 ulps); fp32 as elsewhere."""
    if dtype == torch.float32:
        _close(got, want, dtype)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=5e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [37, 1000])
def test_layer_norm_bwd_kernel_matches_twin(cuda, dtype, rows):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(rows, 768, generator=g) * 2 + 0.5).to(cuda, dtype)
    dy = torch.randn(rows, 768, generator=g).to(cuda, dtype)
    w = torch.rand(768, generator=g).to(cuda) + 0.5
    b = torch.randn(768, generator=g).to(cuda)
    _, mean, rstd = layer_norm_fwd_reference(x, w, b)
    before = _build.launches["layer_norm_bwd"]
    dx, dw, db = layer_norm_bwd(dy, x, mean, rstd, w)
    assert _build.launches["layer_norm_bwd"] == before + 1
    rdx, rdw, rdb = layer_norm_bwd_reference(dy, x, mean, rstd, w)
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    _close(dx, rdx, dtype)
    torch.testing.assert_close(dw, rdw, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(db, rdb, atol=1e-3, rtol=1e-4)
    again = layer_norm_bwd(dy, x, mean, rstd, w)
    assert torch.equal(again[1], dw) and torch.equal(again[2], db)


def test_layer_norm_autograd_takes_both_kernels(cuda):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(4, 9, 768, generator=g).to(cuda).requires_grad_()
    w = (torch.rand(768, generator=g) + 0.5).to(cuda).requires_grad_()
    b = torch.randn(768, generator=g).to(cuda).requires_grad_()
    before = dict(_build.launches)
    y = layer_norm(x, w, b)
    y.backward(torch.ones_like(y))
    assert _build.launches["layer_norm_fwd"] == before["layer_norm_fwd"] + 1
    assert _build.launches["layer_norm_bwd"] == before["layer_norm_bwd"] + 1
    assert x.grad is not None and w.grad is not None and b.grad is not None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,h,hkv", [(33, 12, 12), (128, 8, 2), (200, 4, 4)])
def test_flash_bwd_kernels_match_twin(cuda, dtype, s, h, hkv):
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, h, s, 64, generator=g).to(cuda, dtype)
    k, v = (torch.randn(2, hkv, s, 64, generator=g).to(cuda, dtype)
            for _ in range(2))
    do = torch.randn(2, h, s, 64, generator=g).to(cuda, dtype)
    o, lse = flash_attention_reference(q, k, v, scale=0.125)
    before = dict(_build.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, scale=0.125)
    for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
        assert _build.launches[name] == before[name] + 1
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, scale=0.125)
    for a, r in zip(got, want):
        assert a.dtype == dtype
        _bwd_close(a, r, dtype)


def test_flash_autograd_takes_the_backward_kernels(cuda):
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(1, 4, 40, 64, generator=g).to(cuda)
               .requires_grad_() for _ in range(3))
    before = dict(_build.launches)
    o, lse = flash_attention_with_lse(q, k, v, causal=True)
    (o.sum() + lse.sum()).backward()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        assert _build.launches[name] == before[name] + 1
    ro, rlse = flash_attention_reference(q.detach(), k.detach(), v.detach(),
                                         scale=0.125)
    want = flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), ro, rlse, torch.ones_like(ro),
        scale=0.125, dlse=torch.ones_like(rlse))
    for t, r in zip((q, k, v), want):
        _close(t.grad, r, torch.float32)


@pytest.mark.parametrize("adam_w", [True, False])
@pytest.mark.parametrize("per_segment", [True, False])
@pytest.mark.parametrize("noop", [0.0, 1.0])
def test_adam_kernel_matches_twin(cuda, adam_w, per_segment, noop):
    g = torch.Generator().manual_seed(7)
    rows = 300
    gr, p, m = (torch.randn(rows, 1024, generator=g).to(cuda)
                for _ in range(3))
    v = torch.rand(rows, 1024, generator=g).to(cuda)
    seg = torch.repeat_interleave(torch.arange(3, dtype=torch.int32),
                                  torch.tensor([100, 150, 50])).to(cuda)
    wd = (torch.tensor([0.0, 0.1, 0.01], device=cuda) if per_segment
          else 0.05)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd, lr=1e-3,
              step=torch.tensor(3, device=cuda), grad_scale=0.5,
              noop=torch.tensor(noop, device=cuda), adam_w_mode=adam_w,
              seg_rows=seg)
    want = adam_update_reference(gr, p, m, v, **kw)
    before = _build.launches["adam"]
    got = adam_update(gr, p.clone(), m.clone(), v.clone(), **kw)
    assert _build.launches["adam"] == before + 1
    for a, r, old in zip(got, want, (p, m, v)):
        if noop:
            assert torch.equal(a, old)
        else:
            torch.testing.assert_close(a, r, atol=1e-6, rtol=1e-5)
