"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture, never at
collection) where there is no CUDA device. On a GPU machine run
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q``.
Tolerances as in ``chip_smoke.py``: fp32 atol = rtol = 1e-4, bf16 atol
2e-2 / rtol 1e-2 (the backward kernels' summed outputs at wider bf16
bounds, stated where used).
Each test also checks that the wrapper counted exactly its launches.
"""

import importlib
from functools import partial

import pytest
import torch

from apex_tpu_torch.normalization import FusedRMSNorm
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.flash_attention import (DEFAULT_MASK_VALUE, Masking,
                                                flash_attention,
                                                flash_attention_bwd,
                                                flash_fwd,
                                                flash_attention_bwd_reference,
                                                flash_attention_reference,
                                                flash_attention_with_lse,
                                                launch_name)
from apex_tpu_torch.ops.layer_norm import (layer_norm, layer_norm_bwd,
                                           layer_norm_bwd_reference,
                                           layer_norm_fwd,
                                           layer_norm_fwd_reference,
                                           rms_norm, rms_norm_fwd,
                                           rms_norm_fwd_reference)
from apex_tpu_torch.ops.optim_kernels import (adam_update,
                                              adam_update_reference,
                                              lamb_hyperparams, lamb_phase1,
                                              lamb_phase1_reference,
                                              lamb_phase2,
                                              lamb_phase2_reference,
                                              multi_tensor_scale,
                                              multi_tensor_scale_reference,
                                              novograd_update,
                                              novograd_update_reference,
                                              segment_stats,
                                              segment_stats_reference,
                                              sgd_update,
                                              sgd_update_reference)
from apex_tpu_torch.ops.paged_attention import (paged_attention,
                                                paged_attention_reference)
from apex_tpu_torch.ops.quant import (fused_dequant_matmul,
                                      fused_dequant_matmul_reference,
                                      kv_quantize, quantize_weight,
                                      quantize_weight_fp8,
                                      quantize_weight_int4)
from apex_tpu_torch.ops.xentropy import (softmax_cross_entropy, xentropy_bwd,
                                         xentropy_bwd_reference, xentropy_fwd,
                                         xentropy_fwd_reference)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2),
       torch.float16: (1e-3, 1e-3)}
DTYPES = [torch.float32, torch.bfloat16]
#: the scaled-softmax and GroupNorm kernels take fp16 too (fp16: both sides
#: round one fp32 value, within one fp16 ulp, 2^-11 relative)
HALF_DTYPES = DTYPES + [torch.float16]


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


#: (rms, from_y, weight, bias): every branch of the backward kernel
NORM_BWD_BRANCHES = [
    (False, False, True, True), (False, False, False, False),
    (True, False, True, False), (True, False, False, False),
    (False, True, True, True), (False, True, True, False),
    (True, True, True, False), (False, True, False, False)]


def _check_norm_bwd(cuda, dtype, rows, cols, rms, from_y, affine, bias):
    """The backward kernel in one branch against its twin: dx at ``TOL``,
    dgamma/dbeta (fp32 sums over the rows, in other orders) at atol 1e-3 /
    rtol 1e-4; dgamma/dbeta the same bits in a second call."""
    g = torch.Generator().manual_seed(rows + cols)
    x = (torch.randn(rows, cols, generator=g) * 2 + 0.5).to(cuda, dtype)
    dy = torch.randn(rows, cols, generator=g).to(cuda, dtype)
    w = (torch.rand(cols, generator=g) + 0.5).to(cuda) if affine else None
    b = torch.randn(cols, generator=g).to(cuda) if bias else None
    if rms:
        y, mean, rstd = rms_norm_fwd_reference(x, w)
    else:
        y, mean, rstd = layer_norm_fwd_reference(x, w, b)
    args = (dy, y if from_y else x, None if rms or from_y else mean, rstd,
            w, b, rms, from_y)
    name = ("layer_norm_bwd_from_y" if from_y else
            "rms_norm_bwd" if rms else "layer_norm_bwd")
    before = _build.launches[name]
    got = layer_norm_bwd(*args)
    assert _build.launches[name] == before + 1
    want = layer_norm_bwd_reference(*args)
    assert got[0].dtype == dtype
    _close(got[0], want[0], dtype)
    if not affine:
        assert got[1] is None and got[2] is None
        return
    torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-4)
    if rms:
        assert got[2] is None
    else:
        torch.testing.assert_close(got[2], want[2], atol=1e-3, rtol=1e-4)
    again = layer_norm_bwd(*args)
    assert torch.equal(again[1], got[1])
    assert rms or torch.equal(again[2], got[2])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cols", [768, 1000, 4096])
@pytest.mark.parametrize("rows", [1, 7, 77, 640, 4224])
@pytest.mark.parametrize("rms,from_y,affine,bias", NORM_BWD_BRANCHES)
def test_norm_bwd_every_branch_matches_twin(cuda, dtype, rows, cols, rms,
                                            from_y, affine, bias):
    """Rows from one to several a team (4224); 2 warps a row (768, 1000:
    a ragged last slot) and a block (4096)."""
    _check_norm_bwd(cuda, dtype, rows, cols, rms, from_y, affine, bias)


@pytest.mark.parametrize("dtype,rows,cols", [
    (torch.bfloat16, 77, 8192), (torch.bfloat16, 640, 8192),
    (torch.float32, 7, 20000), (torch.bfloat16, 33, 1001),
    (torch.float32, 700, 1001), (torch.bfloat16, 300, 16384),
    (torch.float32, 9, 40000), (torch.bfloat16, 5, 8196)])
@pytest.mark.parametrize("rms,from_y,affine,bias", NORM_BWD_BRANCHES[:5])
def test_norm_bwd_wide_and_unaligned_rows_match_twin(cuda, dtype, rows, cols,
                                                     rms, from_y, affine,
                                                     bias):
    """Rows wider than a block holds, walked in passes: dgamma/dbeta's
    accumulators in shared memory at two blocks an SM (8192), at one
    (16384, 20000), unaligned (8196), and in device memory (40000); and
    widths that leave rows unaligned (one element at a time)."""
    _check_norm_bwd(cuda, dtype, rows, cols, rms, from_y, affine, bias)


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


# --- the BERT slice: masked flash, xentropy, segment stats, LAMB ------------


def _masking(cuda, b, s, causal, segments, rate, seed=17):
    seg = None
    if segments:
        g = torch.Generator().manual_seed(seed)
        lengths = torch.randint(1, s + 1, (b,), generator=g)
        seg = (torch.arange(s)[None, :] < lengths[:, None]).int().to(cuda)
    return Masking(causal=causal, segment_ids=seg, kv_segment_ids=seg,
                   dropout_rate=rate, dropout_seed=seed)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,segments,rate,h,hkv", [
    (False, True, 0.1, 16, 16), (False, False, 0.2, 8, 2),
    (True, True, 0.1, 4, 4), (False, True, 0.0, 4, 2)])
def test_masked_flash_kernels_match_twin(cuda, dtype, causal, segments, rate,
                                         h, hkv):
    """Forward and both backward kernels with non-causal masking, padding
    segment ids and dropout: the keep mask regenerated in the kernels is
    the twin's (and so the reference's)."""
    g = torch.Generator().manual_seed(8)
    b, s = 2, 77
    q, do = (torch.randn(b, h, s, 64, generator=g).to(cuda, dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, s, 64, generator=g).to(cuda, dtype)
            for _ in range(2))
    masking = _masking(cuda, b, s, causal, segments, rate)
    before = dict(_build.launches)
    o, lse = flash_attention_reference(q, k, v, scale=0.125, masking=masking)
    ko, klse = flash_fwd(q, k, v, scale=0.125, masking=masking)
    _close(ko, o, dtype)
    _close(klse, lse, torch.float32)
    got = flash_attention_bwd(q, k, v, o, lse, do, scale=0.125,
                              masking=masking)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        assert _build.launches[name] == before[name] + 1
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, scale=0.125,
                                         masking=masking)
    for a, r in zip(got, want):
        _bwd_close(a, r, dtype)


def test_masked_flash_autograd_on_the_card(cuda):
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(2, 4, 50, 64, generator=g).to(cuda)
               .requires_grad_() for _ in range(3))
    seg = torch.ones(2, 50, dtype=torch.int32, device=cuda)
    seg[1, 30:] = 0
    o = flash_attention(q, k, v, segment_ids=seg, dropout_rate=0.1,
                        dropout_seed=5)
    o.sum().backward()
    masking = Masking(causal=False, segment_ids=seg, kv_segment_ids=seg,
                      dropout_rate=0.1, dropout_seed=5)
    ro, rlse = flash_attention_reference(q.detach(), k.detach(), v.detach(),
                                         scale=0.125, masking=masking)
    _close(o, ro, torch.float32)
    want = flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), ro, rlse, torch.ones_like(ro),
        scale=0.125, masking=masking)
    for t, r in zip((q, k, v), want):
        _close(t.grad, r, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,vocab,smoothing,padding_idx", [
    (640, 30528, 0.0, 0), (64, 30528, 0.1, 0), (8, 2, 0.0, -1),
    (33, 1000, 0.1, None)])
def test_xentropy_kernels_match_twin(cuda, dtype, rows, vocab, smoothing,
                                     padding_idx):
    g = torch.Generator().manual_seed(10)
    x = (torch.randn(rows, vocab, generator=g) * 4).to(cuda, dtype)
    labels = torch.randint(0, vocab, (rows,), generator=g,
                           dtype=torch.int32)
    labels[::5] = 0
    labels = labels.to(cuda)
    dy = torch.randn(rows, generator=g).to(cuda)
    before = dict(_build.launches)
    loss, lse = xentropy_fwd(x, labels, smoothing, padding_idx)
    dx = xentropy_bwd(x, labels, lse, dy, smoothing, padding_idx)
    for name in ("xentropy_fwd", "xentropy_bwd"):
        assert _build.launches[name] == before[name] + 1
    rloss, rlse = xentropy_fwd_reference(x, labels, smoothing, padding_idx)
    _close(loss, rloss, torch.float32)
    _close(lse, rlse, torch.float32)
    assert dx.dtype == dtype
    _close(dx, xentropy_bwd_reference(x, labels, rlse, dy, smoothing,
                                      padding_idx), dtype)
    if padding_idx == 0:
        assert (loss[::5] == 0).all() and (dx[::5] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_xentropy_kernels_masked_columns_match_twin(cuda, dtype):
    """-inf logits in every thread's first strided column (the first 256)
    and a few later ones: a finite loss, as the twin gives it."""
    g = torch.Generator().manual_seed(14)
    x = (torch.randn(40, 1000, generator=g) * 4)
    x[:, :256] = float("-inf")
    x[::2, 500:510] = float("-inf")
    x = x.to(cuda, dtype)
    labels = torch.randint(600, 1000, (40,), generator=g,
                           dtype=torch.int32).to(cuda)
    dy = torch.randn(40, generator=g).to(cuda)
    loss, lse = xentropy_fwd(x, labels, 0.0, 0)
    dx = xentropy_bwd(x, labels, lse, dy, 0.0, 0)
    rloss, rlse = xentropy_fwd_reference(x, labels, 0.0, 0)
    assert torch.isfinite(loss).all() and torch.isfinite(dx).all()
    _close(loss, rloss, torch.float32)
    _close(lse, rlse, torch.float32)
    _close(dx, xentropy_bwd_reference(x, labels, rlse, dy, 0.0, 0), dtype)


def test_xentropy_autograd_takes_both_kernels(cuda):
    x = torch.randn(16, 300, device=cuda, requires_grad=True)
    labels = torch.randint(0, 300, (16,), device=cuda)
    before = dict(_build.launches)
    softmax_cross_entropy(x, labels, 0.1, 0).sum().backward()
    for name in ("xentropy_fwd", "xentropy_bwd"):
        assert _build.launches[name] == before[name] + 1
    assert x.grad is not None and torch.isfinite(x.grad).all()


def _flat(cuda, counts, seed):
    g = torch.Generator().manual_seed(seed)
    rows = sum(counts)
    seg = torch.repeat_interleave(torch.arange(len(counts), dtype=torch.int32),
                                  torch.tensor(counts)).to(cuda)
    bufs = [torch.randn(rows, 1024, generator=g).to(cuda) for _ in range(3)]
    bufs.append(torch.rand(rows, 1024, generator=g).to(cuda) * 0.01)
    return seg, bufs


@pytest.mark.parametrize("with_b", [False, True])
def test_segment_stats_kernel_matches_twin_counts_exactly(cuda, with_b):
    counts = (3000, 1, 7, 1, 129, 1)
    seg, (a, b, _, _) = _flat(cuda, counts, 11)
    a[0, 5] = float("inf")
    a[3005, 0] = float("nan")
    a[3005, 1] = float("nan")
    before = _build.launches["segment_stats"]
    got = segment_stats(a, seg, len(counts), b if with_b else None)
    assert _build.launches["segment_stats"] == before + 1
    want = segment_stats_reference(a, seg, len(counts),
                                   b if with_b else None)
    assert torch.equal(got[2], want[2])
    assert got[2].tolist() == [1, 0, 2, 0, 0, 0]
    finite = torch.isfinite(want[:2])
    torch.testing.assert_close(got[:2][finite], want[:2][finite], atol=1e-3,
                               rtol=1e-5)
    again = segment_stats(a, seg, len(counts), b if with_b else None)
    assert torch.equal(torch.nan_to_num(again), torch.nan_to_num(got))


@pytest.mark.parametrize("noop", [0.0, 1.0])
def test_lamb_phase_kernels_match_twin(cuda, noop):
    counts = (300, 1, 40, 2)
    seg, (g, p, m, v) = _flat(cuda, counts, 12)
    wd = torch.tensor([0.01, 0.0, 0.01, 0.0], device=cuda)
    hp = lamb_hyperparams(beta1=0.9, beta2=0.999, eps=1e-6,
                          step=torch.tensor(4, device=cuda), grad_scale=0.3,
                          noop=torch.tensor(noop, device=cuda), device=cuda)
    ru, rm, rv, rstats = lamb_phase1_reference(hp, g, p, m, v, seg, wd)
    m1, v1 = m.clone(), v.clone()
    before = dict(_build.launches)
    u, m1, v1, stats = lamb_phase1(hp, g, p, m1, v1, seg, wd)
    ratio = (torch.rand(len(counts), generator=torch.Generator().manual_seed(
        13)) + 0.5).to(cuda)
    hp2 = torch.stack([torch.tensor(1e-2, device=cuda), hp[7]])
    p1 = lamb_phase2(hp2, u, p.clone(), ratio, seg)
    for name in ("lamb_phase1", "lamb_phase2"):
        assert _build.launches[name] == before[name] + 1
    # phase 2 on the kernel's own u, so that it is checked alone
    rp = lamb_phase2_reference(hp2, u, p, ratio, seg)
    if noop:
        for got, old in ((m1, m), (v1, v), (p1, p)):
            assert torch.equal(got, old)
        assert (u == 0).all() and (stats[1] == 0).all()
    else:
        for got, want in ((u, ru), (m1, rm), (v1, rv)):
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
        # p - step u rounds to p's fp32 grid, whose ulp is up to 4.8e-7 at
        # |p| < 8: one rounding apart (a fused multiply-add on the card)
        torch.testing.assert_close(p1 - p, rp - p, atol=1e-6, rtol=1e-4)
    torch.testing.assert_close(stats, rstats, atol=1e-3, rtol=1e-5)


def test_fused_lamb_launches_three_kernels_per_step(cuda):
    from apex_tpu_torch.optimizers import FusedLAMB

    params = [(f"w{i}", torch.nn.Parameter(torch.randn(n, device=cuda)))
              for i, n in enumerate((5000, 3, 2048))]
    opt = FusedLAMB(params, lr=1e-2)
    for _, p in params:
        p.grad.normal_()
    before = dict(_build.launches)
    opt.step()
    for name in ("segment_stats", "lamb_phase1", "lamb_phase2"):
        assert _build.launches[name] == before[name] + 1
    assert int(opt.step_count) == 1


QUANTIZERS = {"int8": quantize_weight, "fp8": quantize_weight_fp8,
              "int4": partial(quantize_weight_int4, group_size=128),
              "int4_gs16": partial(quantize_weight_int4, group_size=16),
              "int4_gs512": partial(quantize_weight_int4, group_size=512)}
QUANTIZERS.update({f"int4_gs{gs}": partial(quantize_weight_int4,
                                           group_size=gs)
                   for gs in (2, 4, 8, 1024, 2048)})


def _check_dequant(cuda, dtype, kind, n_in, n_out, qw_offset=0):
    """Decode (8 rows, 1 row), prefill (37, 128 rows) and past four token
    tiles of the bf16 kernel (200 rows) against the twin; a row's value
    must not depend on the rows beside it (in bf16 a row alone runs its K
    split's parts in a cluster of blocks, a batch of 37 or 200 at most
    shapes one block through them all). ``qw_offset``: the weight's bytes
    start that far into their buffer (8: rows not 16-byte aligned)."""
    g = torch.Generator().manual_seed(3)
    qw, sc = QUANTIZERS[kind](torch.randn(n_out, n_in, generator=g)
                              * n_in ** -0.5)
    if qw_offset:
        buf = torch.empty(qw.numel() * qw.element_size() + qw_offset,
                          dtype=torch.uint8, device=cuda)
        qw = buf[qw_offset:].view(qw.dtype).view(qw.shape).copy_(
            qw.to(cuda))
        assert qw.data_ptr() % 16 == qw_offset % 16
    qw, sc = qw.to(cuda), sc.to(cuda)
    name = "dequant_matmul_w4" if kind.startswith("int4") else \
        "dequant_matmul"
    for m in (8, 1, 37, 128, 200):
        x = torch.randn(m, n_in, generator=g).to(cuda, dtype)
        before = _build.launches[name]
        got = fused_dequant_matmul(x, qw, sc)
        assert _build.launches[name] == before + 1
        _close(got, fused_dequant_matmul_reference(x, qw, sc), dtype)
        if m in (37, 200):
            for i in (5, m - 1):
                alone = fused_dequant_matmul(x[i:i + 1], qw, sc)
                assert torch.equal(alone, got[i:i + 1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["int8", "fp8", "int4", "int4_gs16"])
@pytest.mark.parametrize("n_in,n_out", [(768, 2304), (3072, 768),
                                        (768, 768), (768, 3072)])
def test_dequant_matmul_kernels_match_twin(cuda, dtype, kind, n_in, n_out):
    """GPT-2-small's four block-linear shapes."""
    _check_dequant(cuda, dtype, kind, n_in, n_out)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,n_in,n_out,qw_offset", [
    ("int4_gs512", 3072, 768, 0), ("int4_gs512", 1024, 40, 0),
    ("int8", 24, 40, 0), ("fp8", 24, 40, 0), ("int8", 520, 33, 0),
    ("int4_gs16", 48, 40, 0), ("int8", 768, 2304, 8),
    ("int4", 768, 2304, 8)])
def test_dequant_matmul_edge_shapes_match_twin(cuda, dtype, kind, n_in,
                                               n_out, qw_offset):
    """int4 at group 512; ragged widths (in 24 or 520: rows of whole 8-byte
    chunks only; out 33 or 40: a part of a channel tile); weights 8 bytes
    off a 16-byte boundary."""
    _check_dequant(cuda, dtype, kind, n_in, n_out, qw_offset)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,n_in,n_out", [
    ("int4_gs2", 768, 2304), ("int4_gs4", 768, 2304), ("int4_gs8", 768, 2304),
    ("int4_gs1024", 3072, 768), ("int4_gs2048", 2048, 768),
    ("int4_gs2", 36, 40), ("int4_gs4", 100, 33), ("int4_gs8", 72, 40),
    ("int8", 36, 40), ("fp8", 36, 40), ("int8", 100, 33), ("fp8", 100, 33),
    ("int8", 1001, 48)])
def test_dequant_matmul_every_served_shape_matches_twin(cuda, dtype, kind,
                                                        n_in, n_out):
    """ROADMAP C2: every shape the reference serves runs on the card. int4
    groups of 2, 4 and 8 (several groups in a k16 step) and of 1024 and
    2048 (a stage inside one group), at GPT-2-small's widths and at ragged
    ones (rows of 18, 50 and 36 packed bytes); int8/e4m3 in_features that
    are no multiple of 8. Against the twin at ``TOL``; a bf16 row alone
    bit-equal to the same row in a batch."""
    _check_dequant(cuda, dtype, kind, n_in, n_out)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_dtype", [torch.int8, torch.float8_e4m3fn])
def test_paged_quant_kernel_matches_twin(cuda, dtype, kv_dtype):
    g = torch.Generator().manual_seed(4)
    lengths = torch.tensor([0, 1, 16, 17, 200, 1024], dtype=torch.int32)
    slots, maxp, ps = lengths.shape[0], 64, 16
    perm = torch.randperm(slots * maxp, generator=g) + 1
    bt = torch.zeros(slots, maxp, dtype=torch.int32)
    for i, n in enumerate(lengths.tolist()):
        bt[i, :-(-n // ps)] = perm[i * maxp:i * maxp - (-n // ps)]
    q = torch.randn(slots, 12, 1, 64, generator=g).to(cuda, dtype)
    qmax = 127.0 if kv_dtype == torch.int8 else 448.0
    pools = [kv_quantize(torch.randn(1 + slots * maxp, 4, ps, 64,
                                     generator=g) * 2, kv_dtype, qmax,
                         axes=(2, 3)) for _ in range(2)]
    (kp, ks), (vp, vs) = ((p.to(cuda), s[:, :, 0, 0].to(cuda))
                          for p, s in pools)
    args = (q, kp, vp, bt.to(cuda), lengths.to(cuda))
    before = _build.launches["paged_attention_quant"]
    got = paged_attention(*args, k_scales=ks, v_scales=vs)
    assert _build.launches["paged_attention_quant"] == before + 1
    _close(got, paged_attention_reference(*args, k_scales=ks, v_scales=vs),
           dtype)
    assert (got[0] == 0).all()


# --- the Mistral-7B serving slice: RMSNorm, windowed flash and paged ------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [8, 37, 1030])
def test_rms_norm_kernel_matches_twin(cuda, dtype, rows):
    """Mistral-7B's width 4096 at a decode step's 8 rows and prefill rows;
    mean must be exactly 0."""
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(rows, 4096, generator=g) * 2 + 0.5).to(cuda, dtype)
    w = (torch.rand(4096, generator=g) + 0.5).to(cuda)
    before = dict(_build.launches)
    got = rms_norm_fwd(x, w, 1e-5)
    assert _build.launches["rms_norm_fwd"] == before["rms_norm_fwd"] + 1
    assert _build.launches["layer_norm_fwd"] == before["layer_norm_fwd"]
    want = rms_norm_fwd_reference(x, w, 1e-5)
    _close(got[0], want[0], dtype)
    assert (got[1] == 0).all()
    _close(got[2], want[2], torch.float32)
    assert torch.equal(rms_norm(x, w), got[0])


def test_rms_norm_refuses_autograd_on_the_card(cuda):
    """ROADMAP B10 is closed: a CUDA input or weight that requires grad
    goes forward and backward through the RMS branches of the two kernels
    (one launch each, the unfused LayerNorm kernels none) and matches the
    twins. What the kernels still refuse is a dtype they do not take."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(4, 5, 4096, generator=g).to(cuda).requires_grad_()
    mod = FusedRMSNorm(4096, device=cuda)
    with torch.no_grad():
        mod.weight.copy_(torch.rand(4096, generator=g) + 0.5)
    dy = torch.randn(4, 5, 4096, generator=g).to(cuda)
    before = dict(_build.launches)
    mod(x).backward(dy)
    for name in ("rms_norm_fwd", "rms_norm_bwd"):
        assert _build.launches[name] == before[name] + 1
    for name in ("layer_norm_fwd", "layer_norm_bwd", "layer_norm_bwd_from_y"):
        assert _build.launches[name] == before[name]
    x2d = x.detach().reshape(-1, 4096)
    _, _, rstd = rms_norm_fwd_reference(x2d, mod.weight.detach(), 1e-5)
    rdx, rdw, _ = layer_norm_bwd_reference(dy.reshape(-1, 4096), x2d, None,
                                           rstd, mod.weight.detach(),
                                           rms=True)
    _close(x.grad.reshape(-1, 4096), rdx, torch.float32)
    torch.testing.assert_close(mod.weight.grad, rdw, atol=1e-3, rtol=1e-4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rms_norm(x.detach().half(), mod.weight)


WINDOW_CASES = [
    # (sq, sk, h, hkv, d, window): Mistral's d = 128 and 4 q heads per kv
    # head; a band narrower than a key tile, one that starts mid-tile, a
    # window of 1 (the diagonal alone), and q_len < kv_len
    (200, 200, 8, 2, 128, 40),
    (300, 300, 4, 1, 128, 100),
    (70, 70, 4, 4, 64, 1),
    (48, 160, 8, 2, 128, 64),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,sk,h,hkv,d,window", WINDOW_CASES)
def test_windowed_flash_kernel_matches_twin(cuda, dtype, sq, sk, h, hkv, d,
                                            window):
    g = torch.Generator().manual_seed(6)
    q = torch.randn(2, h, sq, d, generator=g).to(cuda, dtype)
    k, v = (torch.randn(2, hkv, sk, d, generator=g).to(cuda, dtype)
            for _ in range(2))
    before = dict(_build.launches)
    o, lse = flash_attention_with_lse(q, k, v, causal=True, window=window)
    assert (_build.launches["flash_fwd_window"]
            == before["flash_fwd_window"] + 1)
    assert _build.launches["flash_fwd"] == before["flash_fwd"]
    masking = Masking(causal=True, window=window)
    ro, rlse = flash_attention_reference(q, k, v, scale=d ** -0.5,
                                         masking=masking)
    _close(o, ro, dtype)
    _close(lse, rlse, torch.float32)
    assert torch.equal(flash_attention(q, k, v, causal=True, window=window),
                       o)


def test_windowed_flash_refuses_autograd_on_the_card(cuda):
    """ROADMAP B9's window is ported: a windowed call under autograd runs
    the windowed forward and both windowed backward kernels, never the
    unwindowed ones; with a bias, their ``_window_bias`` branches. What the
    flash surface still refuses is a traced ``causal_offset``: a tensor
    (the port takes host ints; items 8 and 9 ported the rest)."""
    q, k, v = (torch.randn(1, 2, 16, 64, device=cuda, requires_grad=True)
               for _ in range(3))
    before = dict(_build.launches)
    flash_attention(q, k, v, causal=True, window=4).sum().backward()
    for name in ("flash_fwd_window", "flash_bwd_dq_window",
                 "flash_bwd_dkdv_window"):
        assert _build.launches[name] == before[name] + 1
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        assert _build.launches[name] == before[name]
    before = dict(_build.launches)
    flash_attention(q, k, v, torch.zeros(1, 2, 16, 16, device=cuda),
                    causal=True, window=4).sum().backward()
    for name in ("flash_fwd_window_bias", "flash_bwd_dq_window_bias",
                 "flash_bwd_dkdv_window_bias"):
        assert _build.launches[name] == before[name] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 3
    with pytest.raises(TypeError, match="host int"):
        flash_attention_with_lse(q, k, v, causal=True,
                                 causal_offset=torch.tensor(0, device=cuda))


def _windowed_pool(g, lengths, window, ps, kv, d, maxp, dtype, cuda,
                   kv_dtype=None):
    """A random pool whose slots' table entries below the band are nulled
    (to page 0) as ``drop_slot_pages`` leaves them, with page 0 poisoned so
    that a read of it would show."""
    slots = len(lengths)
    perm = torch.randperm(slots * maxp, generator=g) + 1
    bt = torch.zeros(slots, maxp, dtype=torch.int32)
    for i, n in enumerate(lengths):
        live = -(-n // ps)
        bt[i, :live] = perm[i * maxp:i * maxp + live]
        bt[i, :max(n - window, 0) // ps] = 0          # dropped pages
    pages = [torch.randn(1 + slots * maxp, kv, ps, d, generator=g) * 2
             for _ in range(2)]
    for p in pages:
        p[0] = 1e4
    if kv_dtype is None:
        return [p.to(cuda, dtype) for p in pages], None, bt.to(cuda)
    qmax = 127.0 if kv_dtype == torch.int8 else 448.0
    quant = [kv_quantize(p, kv_dtype, qmax, axes=(2, 3)) for p in pages]
    return ([p.to(cuda) for p, _ in quant],
            [s[:, :, 0, 0].to(cuda) for _, s in quant], bt.to(cuda))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_dtype", [None, torch.int8, torch.float8_e4m3fn])
def test_windowed_paged_kernels_match_twin(cuda, dtype, kv_dtype):
    """Mistral's d = 128 and rep 4, window 100 over page 16: lengths below,
    at and past the window, a band floor inside a page and on a page edge,
    leading entries nulled to a poisoned page 0."""
    g = torch.Generator().manual_seed(7)
    window, ps, kv, d, maxp = 100, 16, 2, 128, 40
    lengths = [0, 1, 99, 100, 101, 116, 117, 333, 640]
    (kp, vp), scales, bt = _windowed_pool(g, lengths, window, ps, kv, d,
                                          maxp, dtype, cuda, kv_dtype)
    q = torch.randn(len(lengths), 4 * kv, 1, d, generator=g).to(cuda, dtype)
    args = (q, kp, vp, bt, torch.tensor(lengths, dtype=torch.int32,
                                        device=cuda))
    kw = dict(window=window)
    if scales is not None:
        kw.update(k_scales=scales[0], v_scales=scales[1])
    name = "paged_attention_window" if kv_dtype is None else \
        "paged_attention_quant"
    before = dict(_build.launches)
    got = paged_attention(*args, **kw)
    assert _build.launches[name] == before[name] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 1
    _close(got, paged_attention_reference(*args, **kw), dtype)
    assert (got[0] == 0).all()


# --- the s > 1 query blocks: speculative verify and chunked prefill -------


def _block_pool(g, lengths, s, window, ps, kv, d, maxp, dtype, cuda,
                kv_dtype=None):
    """``_windowed_pool`` for a block of ``s`` queries: the entries wholly
    below each slot's EARLIEST query's band floor (``lengths - s - window +
    1``) are nulled to the poisoned page 0; none without a window."""
    nulled = 1 << 30 if window is None else window + s - 1
    return _windowed_pool(g, lengths, nulled, ps, kv, d, maxp, dtype, cuda,
                          kv_dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("branch", ["fp", "window", "int8", "fp8",
                                    "int8_window"])
@pytest.mark.parametrize("s,rep", [(2, 1), (4, 1), (16, 1), (4, 4),
                                   (16, 4), (5, 7)])
def test_paged_block_kernels_match_twin(cuda, dtype, branch, s, rep):
    """The s > 1 branches of the paged kernel against the twin: GPT-2's
    head_dim 64 at rep 1, Mistral's 128 at rep 4 (64 rows at s = 16: four
    row groups) and a ragged 35 rows; lengths shorter than s (their leading
    rows exactly 0), on page edges and past the window; page 0 poisoned.
    Each call counts once under its ``_block`` name and no s = 1 name."""
    g = torch.Generator().manual_seed(11 + s + rep)
    window = 40 if "window" in branch else None
    kv_dtype = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
                "int8_window": torch.int8}.get(branch)
    ps, kv, maxp = 16, 2, 12
    d = 64 if rep == 1 else 128
    lengths = [0, 1, s - 1, s, 16, 17, 41, 57, 100, 191]
    (kp, vp), scales, bt = _block_pool(g, lengths, s, window, ps, kv, d,
                                       maxp, dtype, cuda, kv_dtype)
    q = torch.randn(len(lengths), rep * kv, s, d, generator=g).to(cuda,
                                                                  dtype)
    args = (q, kp, vp, bt, torch.tensor(lengths, dtype=torch.int32,
                                        device=cuda))
    kw = {} if window is None else dict(window=window)
    if scales is not None:
        kw.update(k_scales=scales[0], v_scales=scales[1])
    name = ("paged_attention_quant_block" if kv_dtype is not None
            else "paged_attention_window_block" if window
            else "paged_attention_block")
    before = dict(_build.launches)
    got = paged_attention(*args, **kw)
    assert _build.launches[name] == before[name] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 1
    torch.cuda.synchronize()
    _close(got, paged_attention_reference(*args, **kw), dtype)
    for i, n in enumerate(lengths):
        if n < s:                      # rows before the sequence start
            assert (got[i, :, :s - n] == 0).all()


def test_paged_block_longer_than_a_page_raises(cuda):
    q = torch.randn(2, 4, 9, 64, device=cuda)
    kp = torch.randn(5, 4, 8, 64, device=cuda)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    ln = torch.tensor([9, 3], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="1..page_size"):
        paged_attention(q, kp, kp, bt, ln)


# --- the split page walk (flash-decode): splits, merge, batch invariance ---

#: (s, rep, d): GPT-2's decode and blocks (d 64), Mistral's (GQA 4, d 128),
#: d 16 and 80, a ragged 35 rows, and 80 rows (two row groups of 64 and 16)
SPLIT_SHAPES = [(1, 1, 64), (1, 4, 128), (4, 4, 16), (4, 1, 80),
                (16, 1, 64), (16, 4, 128), (5, 7, 80), (16, 5, 64)]
SPLIT_BRANCHES = ["fp", "window", "int8", "fp8", "int8_window"]


def _split_case(cuda, dtype, branch, s, rep, d, seed, lengths=None,
                extra_pages=0):
    """A shuffled pool of 48-page slots at page 16 (768 positions: at the
    plan's 8 pages a split, up to 6 splits a slot), lengths on page and
    split edges +-1, window 300 (its band floor inside a split); page 0
    poisoned. Returns (args, kwargs, launch name)."""
    g = torch.Generator().manual_seed(seed)
    window = 300 if "window" in branch else None
    kv_dtype = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
                "int8_window": torch.int8}.get(branch)
    ps, kv, maxp = 16, 2, 48
    if lengths is None:
        lengths = [0, 1, s - 1, 127, 128, 129, 256, 257, 400, 767, 768]
    (kp, vp), scales, bt = _block_pool(g, lengths, s, window, ps, kv, d,
                                       maxp, dtype, cuda, kv_dtype)
    if extra_pages:
        bt = torch.cat([bt, torch.zeros(bt.shape[0], extra_pages,
                                        dtype=bt.dtype, device=cuda)], 1)
    q = torch.randn(len(lengths), rep * kv, s, d, generator=g).to(cuda,
                                                                  dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kw = {} if window is None else dict(window=window)
    if scales is not None:
        kw.update(k_scales=scales[0], v_scales=scales[1])
    name = ("paged_attention_quant" if kv_dtype is not None
            else "paged_attention_window" if window else "paged_attention")
    return (q, kp, vp, bt, ln), kw, name + ("_block" if s > 1 else "")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("branch", SPLIT_BRANCHES)
@pytest.mark.parametrize("s,rep,d", SPLIT_SHAPES)
def test_paged_split_kernels_match_twin(cuda, dtype, branch, s, rep, d):
    """Every branch over up to 6 live splits a slot: the twin at ``TOL``,
    one launch counted under the branch's name and no other, rows before a
    slot's start and zero-length slots exactly 0, the same bits in a
    second call."""
    args, kw, name = _split_case(cuda, dtype, branch, s, rep, d,
                                 seed=31 + s + rep + d)
    before = dict(_build.launches)
    got = paged_attention(*args, **kw)
    assert _build.launches[name] == before[name] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 1
    torch.cuda.synchronize()
    _close(got, paged_attention_reference(*args, **kw), dtype)
    assert torch.isfinite(got.float()).all()
    for i, n in enumerate(args[4].tolist()):
        if n < s:
            assert (got[i, :, :s - n] == 0).all()
    assert torch.equal(paged_attention(*args, **kw), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("branch", ["fp", "window", "int8_window"])
@pytest.mark.parametrize("s,rep,d", [(1, 1, 64), (1, 4, 128), (16, 4, 128),
                                     (4, 1, 64)])
def test_paged_split_rows_are_batch_invariant(cuda, dtype, branch, s, rep,
                                              d):
    """A slot's output is the same bits alone (batch 1), in the batch and
    at a wider table: its splits and sum orders depend on its own length
    alone."""
    args, kw, _ = _split_case(cuda, dtype, branch, s, rep, d, seed=7)
    q, kp, vp, bt, ln = args
    batch = paged_attention(*args, **kw)
    wide = torch.cat([bt, torch.zeros(bt.shape[0], 40, dtype=bt.dtype,
                                      device=cuda)], 1)
    assert torch.equal(paged_attention(q, kp, vp, wide, ln, **kw), batch)
    for i in range(q.shape[0]):
        alone = paged_attention(q[i:i + 1], kp, vp, bt[i:i + 1],
                                ln[i:i + 1], **kw)
        assert torch.equal(alone[0], batch[i]), i


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_split_unaligned_pool_view_matches_twin(cuda, dtype):
    """A pool viewed one element off a 16-byte boundary takes element
    copies into the same tiles: the twin at ``TOL`` and the aligned pool's
    bits."""
    args, kw, _ = _split_case(cuda, dtype, "window", 4, 4, 64, seed=3)
    q, kp, vp, bt, ln = args
    views = []
    for p in (kp, vp):
        flat = torch.empty(p.numel() + 1, dtype=p.dtype, device=cuda)
        view = flat[1:].view(p.shape)
        view.copy_(p)
        views.append(view)
    got = paged_attention(q, *views, bt, ln, **kw)
    _close(got, paged_attention_reference(*args, **kw), dtype)
    assert torch.equal(got, paged_attention(*args, **kw))


# --- the training slice of Mistral-7B: RMSNorm and memory_efficient
# backward, the windowed flash backward ---------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [37, 1000])
@pytest.mark.parametrize("affine", [True, False])
def test_rms_norm_bwd_kernel_matches_twin(cuda, dtype, rows, affine):
    """The RMS branch at Mistral's width 4096, ragged row tiles; dgamma sums
    ``rows`` fp32 products in another order (atol 1e-3 / rtol 1e-4), and
    is the same bits from run to run."""
    g = torch.Generator().manual_seed(9)
    x = (torch.randn(rows, 4096, generator=g) * 2 + 0.5).to(cuda, dtype)
    dy = torch.randn(rows, 4096, generator=g).to(cuda, dtype)
    w = (torch.rand(4096, generator=g) + 0.5).to(cuda) if affine else None
    _, _, rstd = rms_norm_fwd_reference(x, w)
    before = dict(_build.launches)
    dx, dw, db = layer_norm_bwd(dy, x, None, rstd, w, rms=True)
    assert _build.launches["rms_norm_bwd"] == before["rms_norm_bwd"] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 1
    rdx, rdw, _ = layer_norm_bwd_reference(dy, x, None, rstd, w, rms=True)
    assert dx.dtype == dtype and db is None
    _close(dx, rdx, dtype)
    if not affine:
        assert dw is None
        return
    assert dw.dtype == torch.float32
    torch.testing.assert_close(dw, rdw, atol=1e-3, rtol=1e-4)
    assert torch.equal(layer_norm_bwd(dy, x, None, rstd, w, rms=True)[1],
                       dw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rms,bias", [(False, True), (False, False),
                                      (True, False)])
def test_layer_norm_bwd_from_y_kernel_matches_twin(cuda, dtype, rms, bias):
    """The memory_efficient branch: xhat from the saved y (and bias), for
    LayerNorm with and without a bias and for RMSNorm, at 300 x 4096; the
    weight kept in [0.5, 1.5) so that (y - b) / w stays well conditioned."""
    g = torch.Generator().manual_seed(10)
    x = (torch.randn(300, 4096, generator=g) * 2 + 0.5).to(cuda, dtype)
    dy = torch.randn(300, 4096, generator=g).to(cuda, dtype)
    w = (torch.rand(4096, generator=g) + 0.5).to(cuda)
    b = torch.randn(4096, generator=g).to(cuda) if bias else None
    if rms:
        y, _, rstd = rms_norm_fwd_reference(x, w)
    else:
        y, _, rstd = layer_norm_fwd_reference(x, w, b)
    before = dict(_build.launches)
    dx, dw, db = layer_norm_bwd(dy, y, None, rstd, w, b, rms=rms,
                                from_y=True)
    name = "layer_norm_bwd_from_y"
    assert _build.launches[name] == before[name] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 1
    rdx, rdw, rdb = layer_norm_bwd_reference(dy, y, None, rstd, w, b, rms,
                                             from_y=True)
    _close(dx, rdx, dtype)
    torch.testing.assert_close(dw, rdw, atol=1e-3, rtol=1e-4)
    assert (db is None) == (rdb is None) == rms
    if db is not None:
        torch.testing.assert_close(db, rdb, atol=1e-3, rtol=1e-4)


def test_memory_efficient_autograd_takes_the_from_y_kernel(cuda):
    """``memory_efficient`` under autograd, LayerNorm and RMSNorm: the
    forward kernel, then the from_y backward, and no saved-x backward."""
    g = torch.Generator().manual_seed(11)
    for rms in (False, True):
        x = torch.randn(6, 1024, generator=g).to(cuda).requires_grad_()
        w = (torch.rand(1024, generator=g) + 0.5).to(cuda).requires_grad_()
        b = None if rms else torch.randn(1024, generator=g).to(cuda)
        if b is not None:
            b.requires_grad_()
        before = dict(_build.launches)
        layer_norm(x, w, b, rms=rms, memory_efficient=True).sum().backward()
        fwd = "rms_norm_fwd" if rms else "layer_norm_fwd"
        assert _build.launches[fwd] == before[fwd] + 1
        assert (_build.launches["layer_norm_bwd_from_y"]
                == before["layer_norm_bwd_from_y"] + 1)
        assert _build.launches["layer_norm_bwd"] == before["layer_norm_bwd"]
        assert _build.launches["rms_norm_bwd"] == before["rms_norm_bwd"]
        assert x.grad is not None and w.grad is not None
        assert b is None or b.grad is not None


WINDOW_BWD_CASES = [
    # (sq, h, hkv, d, window): Mistral's d = 128 over rep 4; a band
    # narrower than a tile, one that starts mid-tile, the diagonal alone,
    # and a window as long as the sequence (plain causal)
    (200, 8, 2, 128, 40),
    (300, 4, 1, 128, 100),
    (70, 4, 4, 64, 1),
    (96, 4, 2, 128, 96),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,h,hkv,d,window", WINDOW_BWD_CASES)
def test_windowed_flash_bwd_kernels_match_twin(cuda, dtype, s, h, hkv, d,
                                               window):
    g = torch.Generator().manual_seed(12)
    q, do = (torch.randn(2, h, s, d, generator=g).to(cuda, dtype)
             for _ in range(2))
    k, v = (torch.randn(2, hkv, s, d, generator=g).to(cuda, dtype)
            for _ in range(2))
    masking = Masking(causal=True, window=window)
    scale = d ** -0.5
    o, lse = flash_attention_reference(q, k, v, scale=scale, masking=masking)
    dlse = torch.randn(2, h, s, generator=g).to(cuda)
    before = dict(_build.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, scale=scale, dlse=dlse,
                              masking=masking)
    for name in ("flash_bwd_dq_window", "flash_bwd_dkdv_window"):
        assert _build.launches[name] == before[name] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 2
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, scale=scale,
                                         dlse=dlse, masking=masking)
    for a, r in zip(got, want):
        assert a.dtype == dtype
        _bwd_close(a, r, dtype)


#: (batch, heads, kv heads, Sq, Sk, head dim, bias shape, causal, window,
#: segments, dropout rate): T5's encoder and decoder (a (1, H, S, S) table
#: serving B = 3), its start token (Sq = Sk = 1) and its decode-time
#: cross-attention shape with a padding bias (Sq = 1 against Sk = 77),
#: a full bias at Sq != Sk under GQA, a padding mask of -1e9 with segments
#: and dropout, and a windowed call with a table (the _window_bias names)
BIAS_CASES = [
    (3, 8, 8, 77, 77, 64, "table", False, None, False, 0.0),
    (3, 8, 8, 77, 77, 64, "table", True, None, False, 0.0),
    (3, 8, 8, 1, 1, 64, "table", True, None, False, 0.0),
    (3, 8, 8, 1, 77, 64, "padding", False, None, False, 0.0),
    (2, 8, 2, 40, 97, 128, "full", True, None, False, 0.0),
    (2, 4, 2, 64, 64, 64, "padding", False, None, True, 0.1),
    (2, 8, 2, 150, 150, 128, "table", True, 40, False, 0.0),
]


def _bias_for(kind, b, h, sq, sk, g):
    if kind == "table":
        return torch.randn(1, h, sq, sk, generator=g)
    if kind == "full":
        return torch.randn(b, h, sq, sk, generator=g)
    keep = torch.arange(sk)[None, :] < torch.randint(
        sk // 2, sk + 1, (b,), generator=g)[:, None]
    return torch.where(keep, 0.0, -1e9)[:, None, None, :]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,kind,causal,window,segments,rate",
                         BIAS_CASES)
def test_flash_bias_kernels_match_twin(cuda, dtype, b, h, hkv, sq, sk, d,
                                       kind, causal, window, segments, rate):
    """The bias branch of the forward and both backward kernels against the
    twins, a bias in q's dtype read in place through its broadcast strides,
    each launch counted under its ``_bias`` name (``_window_bias`` with a
    window) and under no other."""
    g = torch.Generator().manual_seed(21)
    q, do = (torch.randn(b, h, sq, d, generator=g).to(cuda, dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, sk, d, generator=g).to(cuda, dtype)
            for _ in range(2))
    bias = _bias_for(kind, b, h, sq, sk, g).to(cuda, dtype)
    seg = None
    if segments:
        seg = (torch.arange(sq)[None, :] < torch.tensor([sq, sq - 9])[:, None]
               ).int().to(cuda)
    masking = Masking(causal=causal, window=window, segment_ids=seg,
                      kv_segment_ids=seg, dropout_rate=rate, dropout_seed=3)
    scale = d ** -0.5
    o, lse = flash_attention_reference(q, k, v, scale=scale, masking=masking,
                                       bias=bias)
    before = dict(_build.launches)
    ko, klse = flash_fwd(q, k, v, scale=scale, masking=masking, bias=bias)
    got = flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                              masking=masking, bias=bias)
    suffix = "_bias" if window is None else "_window_bias"
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        assert _build.launches[name + suffix] == before[name + suffix] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 3
    _close(ko, o, dtype)
    _close(klse, lse, torch.float32)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, scale=scale,
                                         masking=masking, bias=bias)
    for a, r in zip(got, want):
        _bwd_close(a, r, dtype)


def test_flash_bias_batch_stride_on_the_card(cuda):
    """A (1, H, S, S) bias serving B = 3 equals the same bias repeated over
    the batch, and a non-contiguous fp32 bias under a bf16 q equals its
    contiguous copy (the kernels read through the strides)."""
    g = torch.Generator().manual_seed(22)
    q, k, v = (torch.randn(3, 8, 70, 64, generator=g).to(cuda, torch.bfloat16)
               for _ in range(3))
    table = torch.randn(1, 8, 70, 70, generator=g).to(cuda)
    for bias in (table.repeat(3, 1, 1, 1), table.transpose(2, 3).contiguous()
                 .transpose(2, 3)):
        a = flash_fwd(q, k, v, scale=1.0, masking=Masking(causal=False),
                      bias=table)
        r = flash_fwd(q, k, v, scale=1.0, masking=Masking(causal=False),
                      bias=bias)
        for x, y in zip(a, r):
            torch.testing.assert_close(x, y, atol=0, rtol=0)


def test_flash_bias_autograd_on_the_card(cuda):
    """Under autograd a bias launches the three ``_bias`` kernels; the
    bias's gradient is exactly zero, q/k/v's match the twins'."""
    g = torch.Generator().manual_seed(23)
    q, k, v = (torch.randn(2, 8, 60, 64, generator=g).to(cuda)
               .requires_grad_() for _ in range(3))
    table = torch.randn(1, 8, 60, 60, generator=g).to(cuda).requires_grad_()
    before = dict(_build.launches)
    o = flash_attention(q, k, v, table, causal=True, scale=1.0)
    o.sum().backward()
    for name in ("flash_fwd_bias", "flash_bwd_dq_bias",
                 "flash_bwd_dkdv_bias"):
        assert _build.launches[name] == before[name] + 1
    assert table.grad is not None and not table.grad.any()
    masking = Masking(causal=True)
    ro, rlse = flash_attention_reference(q.detach(), k.detach(), v.detach(),
                                         scale=1.0, masking=masking,
                                         bias=table.detach())
    _close(o, ro, torch.float32)
    want = flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), ro, rlse, torch.ones_like(ro),
        scale=1.0, masking=masking, bias=table.detach())
    for t, r in zip((q, k, v), want):
        _bwd_close(t.grad, r, torch.float32)


# --- the ResNet-50 slice: SGD, NovoGrad, scale ------------------------------


def _opt_buffers(cuda, rows=300, seed=11):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(rows, 1024, generator=g).to(cuda) for _ in range(3)]


@pytest.mark.parametrize("case", [
    dict(momentum=0.9, weight_decay=1e-4, step=1),
    dict(momentum=0.9, weight_decay=1e-4, step=2),
    dict(momentum=0.9, nesterov=True, step=2),
    dict(momentum=0.9, dampening=0.1, step=3),
    dict(momentum=0.0, weight_decay=1e-4, step=2),
    dict(momentum=0.9, weight_decay=1e-4, step=2, noop=1.0),
], ids=["first", "later", "nesterov", "dampening", "plain", "noop"])
def test_sgd_kernel_matches_twin(cuda, case):
    gr, p, m = _opt_buffers(cuda)
    kw = dict(lr=0.1, **dict(case, step=torch.tensor(case["step"],
                                                     device=cuda)))
    want = sgd_update_reference(gr, p, m, **kw)
    before = _build.launches["sgd"]
    got = sgd_update(gr, p.clone(), m.clone(), **kw)
    assert _build.launches["sgd"] == before + 1
    for a, r, old in zip(got, want, (p, m)):
        if case.get("noop") or (a is got[1] and case["momentum"] == 0.0):
            assert torch.equal(a, old)
        # one fused multiply-add apart at most: an fp32 ulp of |p| < 8
        torch.testing.assert_close(a, r, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("init_zero", [False, True])
@pytest.mark.parametrize("noop", [0.0, 1.0])
def test_novograd_kernel_matches_twin(cuda, init_zero, noop):
    gr, p, m = _opt_buffers(cuda, seed=12)
    seg = torch.repeat_interleave(torch.arange(3, dtype=torch.int32),
                                  torch.tensor([100, 150, 50])).to(cuda)
    v = torch.rand(3, device=cuda) * 1e5
    kw = dict(beta1=0.95, beta2=0.98, eps=1e-8, weight_decay=1e-3, lr=1e-2,
              step=torch.tensor(2, device=cuda), grad_scale=0.5,
              noop=torch.tensor(noop, device=cuda), init_zero=init_zero)
    want = novograd_update_reference(gr, p, m, v, seg, 3, **kw)
    before = dict(_build.launches)
    got = novograd_update(gr, p.clone(), m.clone(), v.clone(), seg, 3, **kw)
    for name in ("segment_stats", "novograd"):
        assert _build.launches[name] == before[name] + 1
    for a, r, old in zip(got, want, (p, m, v)):
        if noop:
            assert torch.equal(a, old)
        # the per-tensor sums: fp32 row partials added in fp64 against the
        # twin's fp64 sums, ~1e-7 relative
        torch.testing.assert_close(a, r, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_multi_tensor_scale_kernel_matches_twin(cuda, dtype):
    x = torch.randn(77, 1024, generator=torch.Generator().manual_seed(13))
    x = x.to(cuda, dtype)
    s = torch.tensor(2.0 ** -16, device=cuda)
    before = _build.launches["multi_tensor_scale"]
    got = multi_tensor_scale(x, s)
    assert _build.launches["multi_tensor_scale"] == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, multi_tensor_scale_reference(x, s))


def test_fused_sgd_amp_skip_launches_stats_and_sgd(cuda):
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedSGD

    module = torch.nn.ParameterDict({
        f"w{i}": torch.nn.Parameter(torch.randn(n, device=cuda))
        for i, n in enumerate((5000, 3, 2048))})
    opt = FusedSGD(list(module.named_parameters()), lr=0.1, momentum=0.9,
                   weight_decay=1e-4)
    try:
        amp.initialize(module, opt, opt_level="O1", half_dtype=torch.float16)
        for p in module.parameters():
            p.grad.normal_()
        module["w1"].grad[1] = float("inf")
        before, master = dict(_build.launches), opt.master.clone()
        opt.step()
        for name in ("segment_stats", "sgd"):
            assert _build.launches[name] == before[name] + 1
        assert torch.equal(opt.master, master)
        assert int(opt.step_count) == 0
        assert opt._amp_scaler.state.scale.item() == 2.0 ** 15
    finally:
        amp.reset()


@pytest.mark.parametrize("dtype", DTYPES)
def test_sync_batchnorm_on_the_card_matches_the_cpu_path(cuda, dtype):
    """The card's fused batch-norm ops against the plain fp32 formula of
    the CPU path, channels_last, train mode: output, every gradient and
    the running statistics."""
    from apex_tpu_torch.parallel import SyncBatchNorm

    g = torch.Generator().manual_seed(21)
    x = torch.randn(16, 24, 14, 14, generator=g) * 2 + 0.5
    dy = torch.randn(x.shape, generator=g)
    outs = {}
    for dev in ("cpu", cuda):
        bn = SyncBatchNorm(24, device=dev)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 24))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, 24))
        xd = x.to(dev, dtype).contiguous(memory_format=torch.channels_last)
        xd.requires_grad_()
        y = bn(xd)
        y.backward(dy.to(dev, dtype))
        outs[str(dev)] = [t.detach().float().cpu() for t in (
            y, xd.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var)]
        assert y.dtype == dtype
    tol = TOL[dtype]
    for got, want in zip(outs["cuda"][:2], outs["cpu"][:2]):
        torch.testing.assert_close(got, want, atol=tol[0], rtol=tol[1])
    # dw, db: fp32 sums over 3136 entries, in other orders
    for got, want in zip(outs["cuda"][2:], outs["cpu"][2:]):
        torch.testing.assert_close(got, want, atol=1e-3 if dtype ==
                                   torch.float32 else 1e-1, rtol=1e-3)


SOFTMAX_CASES = [
    # (b, np, sq, sk, branch): the three forward branches, a padding mask
    # read through a row stride of 0, a cyclic mask (mb = 2 over b = 3), a
    # row longer than any block's registers
    (2, 3, 40, 100, "plain"), (2, 4, 17, 300, "padding"),
    (3, 2, 24, 64, "cyclic"), (1, 5, 33, 33, "causal"),
    (1, 1, 20, 33, "causal"), (1, 2, 3, 8193, "padding")]


def _softmax_mask(branch, b, sq, sk, g):
    if branch == "padding":
        lengths = torch.randint(1, sk + 1, (b,), generator=g)
        lengths[0] = 1
        return (torch.arange(sk)[None, :] >= lengths[:, None])[:, None, None]
    if branch == "cyclic":
        return torch.rand(2, 1, sq, sk, generator=g) < 0.3
    return None


@pytest.mark.parametrize("dtype", HALF_DTYPES)
@pytest.mark.parametrize("b,np_,sq,sk,branch", SOFTMAX_CASES)
def test_scaled_softmax_kernels_match_twin(cuda, dtype, b, np_, sq, sk,
                                           branch):
    from apex_tpu_torch.ops.scaled_softmax import (
        scaled_softmax_bwd, scaled_softmax_bwd_reference, scaled_softmax_fwd,
        scaled_softmax_fwd_reference)

    g = torch.Generator().manual_seed(41)
    x = (torch.randn(b, np_, sq, sk, generator=g) * 2).to(cuda, dtype)
    dy = torch.randn(b, np_, sq, sk, generator=g).to(cuda, dtype)
    mask = _softmax_mask(branch, b, sq, sk, g)
    mask = mask.to(cuda) if mask is not None else None
    causal = branch == "causal"
    name = ("scaled_softmax_fwd_causal" if causal else
            "scaled_softmax_fwd" if mask is None else
            "scaled_softmax_fwd_masked")
    before = dict(_build.launches)
    y = scaled_softmax_fwd(x, mask, 0.7, causal)
    dx = scaled_softmax_bwd(y, dy, 0.7)
    torch.cuda.synchronize()
    assert _build.launches[name] == before[name] + 1
    assert _build.launches["scaled_softmax_bwd"] == \
        before["scaled_softmax_bwd"] + 1
    _close(y, scaled_softmax_fwd_reference(x, mask, 0.7, causal), dtype)
    _close(dx, scaled_softmax_bwd_reference(y, dy, 0.7), dtype)
    if branch == "padding":               # sample 0 sees column 0 alone
        assert (y[0, :, :, 0].float() == 1).all()


#: (b, np, sq, sk, mask kind, causal): sk at 1, 31, 32, 33, BERT's 512, the
#: warp path's limit and one past it, and 8193; every mask broadcast
SOFTMAX_PATH_CASES = [
    (2, 2, 5, 1, "padding", False), (2, 3, 7, 31, "padding", False),
    (3, 2, 6, 32, "cyclic", False), (2, 2, 9, 33, "padding", False),
    (2, 4, 16, 512, "padding", False), (2, 2, 8, 512, "full", False),
    (2, 2, 6, 512, "columns", False), (2, 2, 6, 512, "transposed", False),
    (1, 2, 8, 1024, "padding", False), (1, 2, 8, 1025, "padding", False),
    (1, 2, 3, 8193, "padding", False), (2, 2, 8, 1025, "transposed", False),
    (1, 3, 40, 100, None, True), (1, 2, 100, 40, None, True),
    (1, 2, 24, 1024, None, True), (1, 1, 9, 1100, None, True),
    (2, 3, 16, 512, None, False), (1, 2, 4, 1500, None, False)]


def _path_mask(kind, b, sq, sk, g):
    """A mask of ``kind`` whose broadcast to [mb, 1, sq, sk] reads with row
    stride 0 (padding), column stride 1 (full, cyclic), column stride 0
    (columns: one value a query) or a column stride of sq (transposed);
    sample 0's first row is masked everywhere."""
    if kind == "padding":
        m = torch.rand(b, 1, 1, sk, generator=g) < 0.3
        m[0] = True
    elif kind == "full":
        m = torch.rand(b, 1, sq, sk, generator=g) < 0.3
        m[0, 0, 0] = True
    elif kind == "cyclic":
        m = torch.rand(2, 1, sq, sk, generator=g) < 0.3
        m[0, 0, 0] = True
    elif kind == "columns":
        m = torch.rand(b, 1, sq, 1, generator=g) < 0.5
        m[0, 0, 0] = True
    else:
        m = (torch.rand(b, 1, sk, sq, generator=g) < 0.3).transpose(-1, -2)
        m[0, 0, 0] = True
    return m


@pytest.mark.parametrize("dtype", HALF_DTYPES)
@pytest.mark.parametrize("b,np_,sq,sk,kind,causal", SOFTMAX_PATH_CASES)
def test_scaled_softmax_fwd_paths_match_twin(cuda, dtype, b, np_, sq, sk,
                                             kind, causal):
    """The forward on both paths (a warp a row up to 1024 columns, a block
    past it) against the twin at ``TOL``; a row masked everywhere is
    uniform; the output is the same bits in a second call."""
    from apex_tpu_torch.ops.scaled_softmax import (
        _branch, scaled_softmax_fwd, scaled_softmax_fwd_reference)

    g = torch.Generator().manual_seed(sk + sq)
    x = (torch.randn(b, np_, sq, sk, generator=g) * 3).to(cuda, dtype)
    mask = _path_mask(kind, b, sq, sk, g) if kind else None
    mask = mask.to(cuda) if mask is not None else None
    name = _branch(mask, causal)
    before = _build.launches[name]
    y = scaled_softmax_fwd(x, mask, 0.7, causal)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    _close(y, scaled_softmax_fwd_reference(x, mask, 0.7, causal), dtype)
    if kind:
        torch.testing.assert_close(y[0, 0, 0].float(),
                                   torch.full((sk,), 1.0 / sk, device=cuda),
                                   atol=TOL[dtype][0], rtol=TOL[dtype][1])
    assert torch.equal(scaled_softmax_fwd(x, mask, 0.7, causal), y)


#: a view off a 16-byte boundary (the kernels' element loads)
GROUP_NORM_UNALIGNED = (2, 5, 7, 96, 8)
GROUP_NORM_CASES = [
    # (n, h, w, c, g): the reference's kernel and jnp routes, Stable
    # Diffusion's cg = 10 and 40, a group wider than the block (cg 2048)
    (2, 4, 4, 256, 2), (2, 3, 5, 24, 4), (2, 8, 8, 320, 32),
    (1, 4, 4, 1280, 32), (1, 3, 3, 2048, 1),
    # Stable Diffusion v1.5's four UNet norm shapes at batch 2 (several
    # chunks a sample), cg = 4 (a vector over two groups) and cg = 3 at a
    # c of no whole vectors, a row of two column tiles, an unaligned view
    (2, 64, 64, 320, 32), (2, 32, 32, 640, 32), (2, 16, 16, 1280, 32),
    (2, 8, 8, 1280, 32), (2, 6, 6, 48, 12), (2, 5, 3, 60, 20),
    (1, 3, 5, 4104, 4), GROUP_NORM_UNALIGNED]


def _unaligned(t):
    """``t`` as a view one element into a buffer of its dtype."""
    flat = t.new_empty(t.numel() + 1)
    flat[1:] = t.flatten()
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("dtype", HALF_DTYPES)
@pytest.mark.parametrize("n,h,w,c,groups", GROUP_NORM_CASES)
@pytest.mark.parametrize("act,affine", [(None, True), ("silu", True),
                                        ("silu", False)])
def test_group_norm_kernels_match_twin(cuda, dtype, n, h, w, c, groups, act,
                                       affine):
    from apex_tpu_torch.ops.group_norm import (group_norm_bwd,
                                               group_norm_bwd_reference,
                                               group_norm_fwd,
                                               group_norm_fwd_reference)

    g = torch.Generator().manual_seed(43)
    x = (torch.randn(n, h, w, c, generator=g) + 0.3).to(cuda, dtype)
    dy = torch.randn(n, h, w, c, generator=g).to(cuda, dtype)
    if (n, h, w, c, groups) == GROUP_NORM_UNALIGNED:
        x, dy = _unaligned(x), _unaligned(dy)
        assert x.data_ptr() % 16 and dy.data_ptr() % 16
    wt = (torch.randn(c, generator=g) * 0.1 + 1).to(cuda) if affine else None
    bt = (torch.randn(c, generator=g) * 0.1).to(cuda) if affine else None
    before = dict(_build.launches)
    y, mean, rstd = group_norm_fwd(x, wt, bt, groups, 1e-5, act)
    dx, dw, db = group_norm_bwd(x, dy, wt, bt, mean, rstd, groups, act)
    torch.cuda.synchronize()
    for name in ("group_norm_fwd", "group_norm_bwd"):
        assert _build.launches[name] == before[name] + 1
    ry, rmean, rrstd = group_norm_fwd_reference(x, wt, bt, groups, 1e-5, act)
    _close(y, ry, dtype)
    _close(mean, rmean, torch.float32)
    _close(rstd, rrstd, torch.float32)
    rdx, rdw, rdb = group_norm_bwd_reference(x, dy, wt, bt, mean, rstd,
                                             groups, act)
    _bwd_close(dx, rdx, dtype)
    if affine:                     # fp32 sums over n h w rows, other orders
        for got, want in ((dw, rdw), (db, rdb)):
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * want.abs().max().item())
    else:
        assert dw is None and db is None


@pytest.mark.parametrize("dtype", HALF_DTYPES)
def test_group_norm_sample_alone_is_the_batch_bits(cuda, dtype):
    """The kernels' cut depends on the shape alone: one sample's y, mean,
    rstd and dx are the same bits alone and inside a batch of 8."""
    from apex_tpu_torch.ops.group_norm import group_norm_bwd, group_norm_fwd

    g = torch.Generator().manual_seed(44)
    x = (torch.randn(8, 32, 32, 320, generator=g) + 0.3).to(cuda, dtype)
    dy = torch.randn(8, 32, 32, 320, generator=g).to(cuda, dtype)
    wt = (torch.randn(320, generator=g) * 0.1 + 1).to(cuda)
    bt = (torch.randn(320, generator=g) * 0.1).to(cuda)
    y, mean, rstd = group_norm_fwd(x, wt, bt, 32, 1e-5, "silu")
    dx = group_norm_bwd(x, dy, wt, bt, mean, rstd, 32, "silu")[0]
    for i in (0, 5):
        y1, mean1, rstd1 = group_norm_fwd(x[i:i + 1], wt, bt, 32, 1e-5,
                                          "silu")
        dx1 = group_norm_bwd(x[i:i + 1], dy[i:i + 1], wt, bt, mean1, rstd1,
                             32, "silu")[0]
        for got, want in ((y1, y), (mean1, mean), (rstd1, rstd), (dx1, dx)):
            assert torch.equal(got, want[i:i + 1])


@pytest.mark.parametrize("dtype", HALF_DTYPES)
@pytest.mark.parametrize("affine", [True, False])
def test_group_norm_second_call_gives_the_same_bits(cuda, dtype, affine):
    """Every sum runs in an order fixed by the shape: a second call gives
    the same y, mean, rstd, dx, dw and db."""
    from apex_tpu_torch.ops.group_norm import group_norm_bwd, group_norm_fwd

    g = torch.Generator().manual_seed(45)
    x = (torch.randn(8, 16, 16, 1280, generator=g) + 0.3).to(cuda, dtype)
    dy = torch.randn(8, 16, 16, 1280, generator=g).to(cuda, dtype)
    wt = (torch.randn(1280, generator=g) * 0.1 + 1).to(cuda) if affine else None
    bt = (torch.randn(1280, generator=g) * 0.1).to(cuda) if affine else None

    def call():
        y, mean, rstd = group_norm_fwd(x, wt, bt, 32, 1e-6, "silu")
        return (y, mean, rstd,
                *group_norm_bwd(x, dy, wt, bt, mean, rstd, 32, "silu"))

    first, second = call(), call()
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)


def test_softmax_and_group_norm_never_take_the_twin_on_the_card(
        cuda, monkeypatch):
    """Every public entry point on CUDA tensors launches its kernels; the
    twins, replaced by a function that raises, are never called."""
    from apex_tpu_torch.contrib.group_norm import GroupNorm
    from apex_tpu_torch.ops import group_norm as gn_ops
    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

    # the module (``apex_tpu_torch.ops.scaled_softmax`` is the function)
    ss = importlib.import_module("apex_tpu_torch.ops.scaled_softmax")

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor took a plain twin")

    for mod, names in ((ss, ("scaled_softmax_fwd_reference",
                             "scaled_softmax_bwd_reference")),
                       (gn_ops, ("group_norm_fwd_reference",
                                 "group_norm_bwd_reference",
                                 "group_norm_reference"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    before = dict(_build.launches)
    x = torch.randn(2, 4, 64, 64, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    mask = torch.zeros(2, 1, 1, 64, dtype=torch.bool, device=cuda)
    causal = FusedScaleMaskSoftmax(input_in_bf16=True,
                                   attn_mask_type=AttnMaskType.causal,
                                   scale=2.0)
    padded = FusedScaleMaskSoftmax(input_in_bf16=True)
    (causal(x) + padded(x, mask) + padded(x)).sum().backward()
    ss.scaled_upper_triang_masked_softmax(x[0].detach(), 1.0)
    gn = GroupNorm(8, 80, act="silu")
    xg = torch.randn(2, 80, 9, 9, device=cuda).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    gn(xg).sum().backward()
    torch.cuda.synchronize()
    got = {k: _build.launches[k] - before[k] for k in (
        "scaled_softmax_fwd_causal", "scaled_softmax_fwd_masked",
        "scaled_softmax_fwd", "scaled_softmax_bwd", "group_norm_fwd",
        "group_norm_bwd")}
    assert got == {"scaled_softmax_fwd_causal": 2,
                   "scaled_softmax_fwd_masked": 1, "scaled_softmax_fwd": 1,
                   "scaled_softmax_bwd": 3, "group_norm_fwd": 1,
                   "group_norm_bwd": 1}
    assert torch.isfinite(x.grad.float()).all()
    assert gn.weight.grad is not None and torch.isfinite(xg.grad).all()


def test_sync_batchnorm_statistics_match_fp64_sums(cuda):
    """ROADMAP C1: on the card the sum of squares is the reference's fp32
    sum of ``x32 * x32``, bit for bit, within 2e-6 of the fp64 sum per
    channel; the mean and variance follow from the sums as in fp64."""
    from apex_tpu_torch.parallel.sync_batchnorm import (channel_sums,
                                                        sync_batch_norm_stats)

    g = torch.Generator().manual_seed(23)
    x = (torch.randn(32, 64, 28, 28, generator=g) * 0.5 + 0.3).to(
        cuda, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dims = [0, 2, 3]
    s, ss = channel_sums(x)
    x32, x64 = x.float(), x.double()
    assert torch.equal(ss, (x32 * x32).sum(dims))
    s64, ss64 = x64.sum(dims), (x64 * x64).sum(dims)
    assert ((ss.double() - ss64).abs() / ss64).max().item() <= 2e-6
    assert ((s.double() - s64).abs() / x64.abs().sum(dims)).max().item() \
        <= 2e-6
    mean, var, n = sync_batch_norm_stats(x)
    assert n == 32 * 28 * 28
    torch.testing.assert_close(mean.double(), s64 / n, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(var.double(), ss64 / n - (s64 / n) ** 2,
                               rtol=1e-4, atol=1e-6)


#: (heads, kv heads, Sq, Sk, head dim, causal, window, causal_offset,
#: dropout rate, row0, col0): the ring branches. A ring hop's chunk one
#: chunk upstream under a window (offset Sk), zigzag's half-chunk offsets
#: above and below a window, a negative offset (the first rows see
#: nothing), a band that misses every key, dropout at a rank's origins on
#: the diagonal and off it (not causal), and an origin near 2^32 (the
#: hash's uint32 wrap)
RING_CASES = [
    (8, 2, 96, 96, 128, True, 96, 96, 0.0, 0, 0),
    (8, 2, 64, 64, 64, True, 100, 128, 0.0, 0, 0),
    (4, 4, 64, 64, 64, True, 40, 192, 0.0, 0, 0),
    (8, 2, 70, 70, 128, True, None, -20, 0.0, 0, 0),
    (4, 2, 64, 64, 64, True, 30, -10, 0.0, 0, 0),
    (4, 2, 32, 32, 64, True, 8, 200, 0.0, 0, 0),
    (8, 8, 100, 100, 64, True, None, None, 0.1, 300, 300),
    (8, 8, 100, 100, 64, False, None, None, 0.1, 300, 100),
    (4, 2, 64, 64, 128, True, 50, 64, 0.2, 2 ** 32 - 40, 64),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,hkv,sq,sk,d,causal,window,off,rate,row0,col0",
                         RING_CASES)
def test_flash_ring_kernels_match_twin(cuda, dtype, h, hkv, sq, sk, d, causal,
                                       window, off, rate, row0, col0):
    """The ring branch of the forward and both backward kernels (an
    explicit causal offset, dropout origins) against the twins, with an LSE
    cotangent; each launch counted under its ``_ring`` name (``_window_ring``
    with a window) and under no other; rows that see no key are 0."""
    g = torch.Generator().manual_seed(31)
    q, do = (torch.randn(2, h, sq, d, generator=g).to(cuda, dtype)
             for _ in range(2))
    k, v = (torch.randn(2, hkv, sk, d, generator=g).to(cuda, dtype)
            for _ in range(2))
    masking = Masking(causal=causal, window=window, causal_offset=off,
                      dropout_rate=rate, dropout_seed=9, dropout_row0=row0,
                      dropout_col0=col0)
    scale = d ** -0.5
    win = "" if window is None else "_window"
    before = dict(_build.launches)
    o, lse = flash_fwd(q, k, v, scale=scale, masking=masking)
    assert _build.launches[f"flash_fwd{win}_ring"] == \
        before[f"flash_fwd{win}_ring"] + 1
    ro, rlse = flash_attention_reference(q, k, v, scale=scale,
                                         masking=masking)
    _close(o, ro, dtype)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-4)
    dead = ~masking.visible(sq, sk, cuda).any(dim=-1)
    assert (o[:, :, dead[0, 0]] == 0).all()
    dlse = torch.randn(2, h, sq, generator=g).to(cuda)
    got = flash_attention_bwd(q, k, v, ro, rlse, do, scale=scale, dlse=dlse,
                              masking=masking)
    for name in (f"flash_bwd_dq{win}_ring", f"flash_bwd_dkdv{win}_ring"):
        assert _build.launches[name] == before[name] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 3
    want = flash_attention_bwd_reference(q, k, v, ro, rlse, do, scale=scale,
                                         dlse=dlse, masking=masking)
    for a, r in zip(got, want):
        assert a.dtype == dtype
        _bwd_close(a, r, dtype)


@pytest.mark.parametrize("layout", ["ring", "zigzag"])
def test_in_process_ring_on_the_card_matches_one_call(cuda, layout):
    """The in-process ring of 4 ranks on the card (GQA, windowed, dropout
    0.1) against one unsharded call of the kernels with the same seed: the
    output and every gradient within 1e-5 + 1e-4 |x| (fp32, merge order
    only); the windowed ring branches launched."""
    from apex_tpu_torch.ops.ring_attention import (LocalRing, from_zigzag,
                                                   ring_attention,
                                                   ring_attention_zigzag,
                                                   to_zigzag)

    g = torch.Generator().manual_seed(32)
    q, do = (torch.randn(1, 8, 512, 64, generator=g).to(cuda)
             for _ in range(2))
    k, v = (torch.randn(1, 2, 512, 64, generator=g).to(cuda)
            for _ in range(2))
    kw = dict(window=200, dropout_rate=0.1, dropout_seed=4)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention_with_lse(*leaves, causal=True, **kw)[0]
    want = (o, *torch.autograd.grad(o, leaves, do))
    before = dict(_build.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if layout == "ring":
        o = ring_attention(*leaves, ring=LocalRing(4), causal=True, **kw)
        got = (o, *torch.autograd.grad(o, leaves, do))
    else:
        o = ring_attention_zigzag(*(to_zigzag(t, 4) for t in leaves),
                                  ring=LocalRing(4), **kw)
        got = (from_zigzag(o, 4),
               *torch.autograd.grad(o, leaves, to_zigzag(do, 4)))
    for name in ("flash_fwd_window_ring", "flash_bwd_dq_window_ring",
                 "flash_bwd_dkdv_window_ring"):
        assert _build.launches[name] > before[name]
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-4)


# --- the bf16 forward on the tensor cores ------------------------------------

#: (b, h, hkv, sq, sk, d, causal, window, offset, segments, rate, bias kind):
#: ragged Sq and Sk around the kernel's 64-row and 64-key tiles, head dims
#: on both instances (32 and 64 on the 64 one, 80 and 128 on the 128 one),
#: GQA 32 over 8, every branch
MMA_CASES = [
    (2, 4, 4, 1, 1100, 64, False, None, None, False, 0.0, None),
    (2, 4, 4, 33, 65, 32, True, None, None, False, 0.0, None),
    (2, 4, 2, 65, 33, 80, False, None, None, False, 0.0, None),
    (1, 4, 4, 200, 200, 128, True, None, None, False, 0.0, None),
    (1, 4, 4, 1100, 1100, 64, True, None, None, False, 0.0, None),
    (1, 4, 4, 200, 1, 64, False, None, None, False, 0.0, None),
    (1, 32, 8, 200, 200, 128, True, None, None, False, 0.0, None),
    (2, 4, 2, 200, 200, 64, False, None, None, True, 0.1, None),
    (2, 4, 4, 65, 65, 128, True, None, None, True, 0.1, None),
    (1, 4, 2, 1100, 1100, 128, True, 100, None, False, 0.0, None),
    (1, 4, 4, 200, 200, 80, True, 33, None, False, 0.1, None),
    (2, 4, 4, 200, 200, 64, False, None, None, False, 0.0, "table"),
    (2, 4, 4, 65, 200, 64, True, None, None, False, 0.0, "full"),
    (2, 4, 4, 33, 200, 32, False, None, None, False, 0.0, "padding"),
    (1, 4, 4, 200, 200, 64, True, 40, None, False, 0.0, "table"),
    (1, 4, 2, 4096, 4096, 128, True, 4096, 4096, False, 0.0, None),
    (1, 4, 2, 4096, 4096, 128, True, 4096, 2048, False, 0.0, None),
    (1, 4, 2, 4096, 4096, 128, True, 4096, -1024, False, 0.0, None),
]


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window,off,segments,rate,"
                         "bias", MMA_CASES)
def test_bf16_flash_fwd_on_the_tensor_cores_matches_twin(
        cuda, b, h, hkv, sq, sk, d, causal, window, off, segments, rate,
        bias):
    """The bf16 forward (``flash_fwd_mma_kernel``) against its twin at the
    bf16 tolerance; the LSE at fp32's. Rows that see no key output exactly
    0 with the mask value as LSE; one launch, under the branch's name."""
    g = torch.Generator().manual_seed(41)
    q = torch.randn(b, h, sq, d, generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn(b, hkv, sk, d, generator=g).to(cuda, torch.bfloat16)
            for _ in range(2))
    seg = None
    if segments:
        lengths = torch.tensor([sq, max(1, sq - 37)])[:b]
        seg = (torch.arange(sq)[None, :] < lengths[:, None]).int().to(cuda)
    masking = Masking(causal=causal, window=window, causal_offset=off,
                      segment_ids=seg, kv_segment_ids=seg, dropout_rate=rate,
                      dropout_seed=13)
    bt = (None if bias is None else
          _bias_for(bias, b, h, sq, sk, g).to(cuda, torch.bfloat16))
    scale = d ** -0.5
    before = dict(_build.launches)
    o, lse = flash_fwd(q, k, v, scale=scale, masking=masking, bias=bt)
    torch.cuda.synchronize()
    name = launch_name("flash_fwd", masking, bt, sq, sk)
    assert _build.launches[name] == before[name] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 1
    ro, rlse = flash_attention_reference(q, k, v, scale=scale,
                                         masking=masking, bias=bt)
    _close(o, ro, torch.bfloat16)
    _close(lse, rlse, torch.float32)
    dead = ~masking.visible(sq, sk, cuda).expand(b, 1, sq, sk).any(dim=-1)
    dead = dead.expand(b, h, sq)
    assert (o[dead] == 0).all()
    assert (lse[dead] == DEFAULT_MASK_VALUE).all()
    if off == -1024:
        assert dead[:, :, :1024].all() and not dead[:, :, 1024:].any()


@pytest.mark.parametrize("d", [64, 80])
def test_bf16_flash_fwd_unaligned_rows_take_element_loads(cuda, d):
    """Operands whose rows are not whole 16-byte chunks (a storage offset of
    one element; d = 80 rows start 16-byte aligned only without it) give
    the twin's result through the element loads, bit for bit the same as
    aligned copies of the same values."""
    g = torch.Generator().manual_seed(42)
    h, s = 4, 130
    flat = torch.randn(3 * h * s * d + 1, generator=g).to(cuda,
                                                          torch.bfloat16)
    q, k, v = (flat[1 + i * h * s * d:1 + (i + 1) * h * s * d]
               .view(1, h, s, d) for i in range(3))
    assert q.data_ptr() % 16 != 0
    o, lse = flash_attention_with_lse(q, k, v, causal=True)
    ro, rlse = flash_attention_reference(q, k, v, scale=d ** -0.5)
    _close(o, ro, torch.bfloat16)
    _close(lse, rlse, torch.float32)
    ao, alse = flash_attention_with_lse(*(t.clone() for t in (q, k, v)),
                                        causal=True)
    assert torch.equal(ao, o) and torch.equal(alse, lse)


@pytest.mark.parametrize("dtype,symbol", [
    (torch.bfloat16, "flash_fwd_mma_kernel"),
    (torch.float32, "flash_fwd_kernel<float>")])
def test_flash_fwd_routes_by_dtype(cuda, dtype, symbol):
    """A bf16 forward runs the tensor-core kernel and nothing else on the
    card (no library attention, no GEMM); an fp32 one the CUDA-core
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(43)
    q, k, v = (torch.randn(1, 4, 256, 64, generator=g).to(cuda, dtype)
               for _ in range(3))
    flash_attention_with_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention_with_lse(q, k, v, causal=True)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA")]
    kernels = [n for n in names if "flash_fwd" in n]
    assert len(kernels) == 1 and symbol in kernels[0], names
    assert not [n for n in names if "flash_fwd" not in n
                and any(w in n.lower() for w in ("gemm", "attention",
                                                 "fmha", "sm90", "cutlass"))]


# --- the bf16 backward on the tensor cores -----------------------------------

#: (b, h, hkv, sq, sk, d, causal, window, offset, segments, rate, bias kind,
#: dlse): Sq and Sk off the kernels' 64-row and 64-key tiles and Sq != Sk
#: (rows 0..59 of the causal 100-over-40 case see nothing), head dims 16-64
#: on the 64 instance and 80 and 128 on the 128 one, GQA ratios 1, 2 and 4,
#: every branch, with and without an LSE cotangent
MMA_BWD_CASES = [
    (2, 4, 4, 33, 65, 32, True, None, None, False, 0.0, None, False),
    (2, 4, 2, 65, 33, 80, False, None, None, False, 0.0, None, True),
    (1, 4, 4, 100, 40, 64, True, None, None, False, 0.0, None, False),
    (1, 4, 4, 1, 300, 64, False, None, None, False, 0.0, None, True),
    (1, 4, 4, 130, 70, 16, False, None, None, False, 0.0, None, False),
    (1, 4, 4, 200, 200, 128, True, None, None, False, 0.0, None, False),
    (1, 4, 4, 300, 300, 64, True, None, None, False, 0.0, None, True),
    (1, 8, 2, 200, 200, 128, True, None, None, False, 0.0, None, False),
    (2, 4, 2, 200, 200, 64, False, None, None, True, 0.1, None, False),
    (2, 4, 4, 65, 65, 128, True, None, None, True, 0.1, None, True),
    (1, 4, 2, 1100, 1100, 128, True, 100, None, False, 0.0, None, True),
    (1, 4, 4, 200, 200, 80, True, 33, None, False, 0.1, None, False),
    (2, 4, 4, 200, 200, 64, False, None, None, False, 0.0, "table", False),
    (2, 4, 4, 65, 200, 64, True, None, None, False, 0.0, "full", False),
    (2, 4, 4, 33, 200, 32, False, None, None, False, 0.0, "padding", False),
    (1, 4, 4, 200, 200, 64, True, 40, None, False, 0.0, "table", False),
    (1, 4, 2, 4096, 4096, 128, True, 4096, 4096, False, 0.0, None, True),
    (1, 4, 2, 4096, 4096, 128, True, 4096, 2048, False, 0.0, None, True),
    (1, 4, 2, 4096, 4096, 128, True, 4096, -1024, False, 0.0, None, True),
]


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window,off,segments,rate,"
                         "bias,with_dlse", MMA_BWD_CASES)
def test_bf16_flash_bwd_on_the_tensor_cores_matches_twin(
        cuda, b, h, hkv, sq, sk, d, causal, window, off, segments, rate,
        bias, with_dlse):
    """The bf16 backward (``flash_bwd_dq_mma_kernel``,
    ``flash_bwd_dkdv_mma_kernel``) against the twins at the bf16 tolerance:
    one launch each, under the branch's names; rows that see no key give
    dq exactly 0 and add nothing to dk and dv (their q and do changed, dk
    and dv stay the same)."""
    g = torch.Generator().manual_seed(44)
    q, do = (torch.randn(b, h, sq, d, generator=g).to(cuda, torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, sk, d, generator=g).to(cuda, torch.bfloat16)
            for _ in range(2))
    seg = None
    if segments:
        lengths = torch.tensor([sq, max(1, sq - 37)])[:b]
        seg = (torch.arange(sq)[None, :] < lengths[:, None]).int().to(cuda)
    masking = Masking(causal=causal, window=window, causal_offset=off,
                      segment_ids=seg, kv_segment_ids=seg, dropout_rate=rate,
                      dropout_seed=13)
    bt = (None if bias is None else
          _bias_for(bias, b, h, sq, sk, g).to(cuda, torch.bfloat16))
    dlse = (torch.randn(b, h, sq, generator=g).to(cuda) if with_dlse
            else None)
    kw = dict(scale=d ** -0.5, dlse=dlse, masking=masking, bias=bt)
    o, lse = flash_attention_reference(q, k, v, scale=kw["scale"],
                                       masking=masking, bias=bt)
    before = dict(_build.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for kernel in ("flash_bwd_dq", "flash_bwd_dkdv"):
        name = launch_name(kernel, masking, bt, sq, sk)
        assert _build.launches[name] == before[name] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 2
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    for a, r in zip(got, want):
        assert a.dtype == torch.bfloat16
        _close(a, r, torch.bfloat16)
    dead = ~masking.visible(sq, sk, cuda).expand(b, 1, sq, sk).any(dim=-1)
    dead = dead.expand(b, h, sq)
    if off == -1024:
        assert dead[:, :, :1024].all() and not dead[:, :, 1024:].any()
    if (sq, sk, causal) == (100, 40, True):
        assert dead[:, :, :60].all() and not dead[:, :, 60:].any()
    if dead.any():
        assert (got[0][dead] == 0).all()
        noise = torch.randn(b, h, sq, d, generator=g).to(cuda,
                                                         torch.bfloat16)
        q2, do2 = (torch.where(dead[..., None], t + noise, t)
                   for t in (q, do))
        again = flash_attention_bwd(q2, k, v, o, lse, do2, **kw)
        assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])


@pytest.mark.parametrize("d", [64, 80])
def test_bf16_flash_bwd_unaligned_rows_take_element_loads(cuda, d):
    """q, k, v and do whose rows are not whole 16-byte chunks (a storage
    offset of one element) give the twins' dq, dk and dv through the
    element loads and stores, bit for bit those of aligned copies."""
    g = torch.Generator().manual_seed(45)
    h, hkv, s = 4, 2, 130
    n = h * s * d
    flat = torch.randn(2 * n + 2 * hkv * s * d + 1, generator=g).to(
        cuda, torch.bfloat16)
    q, do = (flat[1 + i * n:1 + (i + 1) * n].view(1, h, s, d)
             for i in range(2))
    kv0 = 1 + 2 * n
    k, v = (flat[kv0 + i * hkv * s * d:kv0 + (i + 1) * hkv * s * d]
            .view(1, hkv, s, d) for i in range(2))
    assert q.data_ptr() % 16 != 0 and k.data_ptr() % 16 != 0
    scale = d ** -0.5
    o, lse = flash_attention_reference(q, k, v, scale=scale)
    got = flash_attention_bwd(q, k, v, o, lse, do, scale=scale)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, scale=scale)
    for a, r in zip(got, want):
        _close(a, r, torch.bfloat16)
    aligned = flash_attention_bwd(*(t.clone() for t in (q, k, v, o, lse,
                                                         do)), scale=scale)
    for a, r in zip(got, aligned):
        assert torch.equal(a, r)


@pytest.mark.parametrize("dtype,symbols", [
    (torch.bfloat16, ("flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel")),
    (torch.float32, ("flash_bwd_dq_kernel<float>",
                     "flash_bwd_dkdv_kernel<float>"))])
def test_flash_bwd_routes_by_dtype(cuda, dtype, symbols):
    """A bf16 backward runs the two tensor-core kernels and no library
    attention or GEMM on the card; an fp32 one the CUDA-core kernels."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(46)
    q, k, v, do = (torch.randn(1, 4, 256, 64, generator=g).to(cuda, dtype)
                   for _ in range(4))
    o, lse = flash_attention_with_lse(q, k, v, causal=True)
    kw = dict(scale=0.125, masking=Masking(causal=True))
    flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA")]
    kernels = [n for n in names if "flash_bwd" in n]
    assert len(kernels) == 2, names
    for symbol in symbols:
        assert sum(symbol in n for n in kernels) == 1, names
    assert not [n for n in names if "flash_bwd" not in n
                and any(w in n.lower() for w in ("gemm", "attention",
                                                 "fmha", "sm90", "cutlass"))]


# --- the norm forward's tile plan and the stats pass at the paths' shapes ---

#: widths of the norm forward: one value, a ragged few, T5, GPT-2, a
#: ragged 1000, BERT, Mistral, a team of 256 with one ragged slot, a whole
#: block of 8 bf16 slots a thread, a row walked in passes
NORM_FWD_WIDTHS = [1, 7, 512, 768, 1000, 1024, 4096, 4097, 16384, 40000]
#: (rms, weight, bias): every branch of the forward
NORM_FWD_BRANCHES = [(False, True, True), (False, True, False),
                     (False, False, False), (True, True, False),
                     (True, False, False)]


def _norm_fwd(x, w, b, rms):
    if rms:
        return rms_norm_fwd(x, w, 1e-6), rms_norm_fwd_reference(x, w, 1e-6)
    return layer_norm_fwd(x, w, b), layer_norm_fwd_reference(x, w, b)


def _norm_inputs(cuda, rows, cols, dtype, seed, weight=True, bias=True):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, cols, generator=g) * 2 + 0.5).to(cuda, dtype)
    w = (torch.rand(cols, generator=g) + 0.5).to(cuda) if weight else None
    b = torch.randn(cols, generator=g).to(cuda) if bias else None
    return x, w, b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rms,weight,bias", NORM_FWD_BRANCHES)
@pytest.mark.parametrize("cols", NORM_FWD_WIDTHS)
def test_norm_fwd_every_width_and_branch_matches_twin(cuda, dtype, cols,
                                                      rms, weight, bias):
    """Every width the plan tiles differently (a warp to a block a row,
    element loads where a row is no whole 16-byte slots, passes past the
    registers), every branch, against the twin: y at ``TOL``, mean and
    rstd at fp32's; mean exactly 0 under RMS; one launch under the
    branch's name."""
    x, w, b = _norm_inputs(cuda, 37, cols, dtype, cols, weight, bias)
    name = "rms_norm_fwd" if rms else "layer_norm_fwd"
    before = dict(_build.launches)
    got, want = _norm_fwd(x, w, b, rms)
    assert _build.launches[name] == before[name] + 1
    _close(got[0], want[0], dtype)
    _close(got[2], want[2], torch.float32)
    if rms:
        assert (got[1] == 0).all()
    else:
        _close(got[1], want[1], torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("cols", [768, 1000, 4096, 40000])
def test_norm_fwd_rows_have_the_same_bits_alone_and_in_a_batch(cuda, dtype,
                                                               rms, cols):
    """The plan depends on the width alone: each row of a batch has the
    bits of the same row alone (a decode step's rows against a prefill's),
    and a second call gives the same bits."""
    x, w, b = _norm_inputs(cuda, 300, cols, dtype, 20 + cols, bias=not rms)
    got = _norm_fwd(x, w, b, rms)[0]
    again = _norm_fwd(x, w, b, rms)[0]
    for a, c in zip(got, again):
        assert torch.equal(a, c)
    for r in (0, 1, 150, 299):
        alone = _norm_fwd(x[r:r + 1], w, b, rms)[0]
        for a, c in zip(alone, got):
            assert torch.equal(a, c[r:r + 1])
    eight = _norm_fwd(x[:8], w, b, rms)[0]
    assert torch.equal(eight[0], got[0][:8])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("cols", [768, 4096])
def test_norm_fwd_unaligned_x_matches_the_aligned_bits(cuda, dtype, rms,
                                                       cols):
    """x one element into its buffer (no row on a 16-byte boundary) takes
    element loads over the same slots: the same bits as the aligned copy."""
    x, w, b = _norm_inputs(cuda, 37, cols, dtype, 30, bias=not rms)
    flat = x.new_empty(x.numel() + 1)
    flat[1:] = x.flatten()
    xu = flat[1:].view(x.shape)
    assert xu.data_ptr() % 16 != 0
    got, want = _norm_fwd(xu, w, b, rms)
    _close(got[0], want[0], dtype)
    for a, c in zip(got, _norm_fwd(x, w, b, rms)[0]):
        assert torch.equal(a, c)


@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("counts", [
    (1,) * 64 + (3, 1, 1),
    (30522, 1, 1, 512, 1024, 1, 1, 4096, 4, 4, 1),
])
def test_segment_stats_one_row_and_long_segments_match_twin(cuda, counts,
                                                            with_b):
    """One-row segments (biases and norm weights), and BERT-Large's word
    embedding's 30522 rows beside its neighbours: counts exact, sums at
    the fp64 twin's ~1.4e-7 (the smoke's ``SEGMENT_SUM_TOL``), the same
    bits in a second call; one launch."""
    seg, (a, b, _, _) = _flat(cuda, counts, 14)
    a[-1, 3] = float("inf")
    a[0, 0] = float("nan")
    before = _build.launches["segment_stats"]
    got = segment_stats(a, seg, len(counts), b if with_b else None)
    assert _build.launches["segment_stats"] == before + 1
    want = segment_stats_reference(a, seg, len(counts),
                                   b if with_b else None)
    assert torch.equal(got[2], want[2])
    assert got[2].sum().item() == 2
    finite = torch.isfinite(want[:2])
    torch.testing.assert_close(got[:2][finite], want[:2][finite], atol=1e-3,
                               rtol=1e-6)
    again = segment_stats(a, seg, len(counts), b if with_b else None)
    assert torch.equal(torch.nan_to_num(again), torch.nan_to_num(got))
