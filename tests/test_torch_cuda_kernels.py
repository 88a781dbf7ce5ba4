"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture, never at
collection) where there is no CUDA device. On a GPU machine run
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q``.
Tolerances as in ``chip_smoke.py``: fp32 atol = rtol = 1e-4, bf16 atol
2e-2 / rtol 1e-2 (the backward kernels' summed outputs at wider bf16
bounds, stated where used).
Each test also checks that the wrapper counted exactly its launches.
"""

from functools import partial

import pytest
import torch

from apex_tpu_torch.normalization import FusedRMSNorm
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.flash_attention import (Masking, flash_attention,
                                                flash_attention_bwd,
                                                flash_fwd,
                                                flash_attention_bwd_reference,
                                                flash_attention_reference,
                                                flash_attention_with_lse)
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
                                              segment_stats,
                                              segment_stats_reference)
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
              "int4_gs16": partial(quantize_weight_int4, group_size=16)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", list(QUANTIZERS))
@pytest.mark.parametrize("n_in,n_out", [(768, 2304), (3072, 768)])
def test_dequant_matmul_kernels_match_twin(cuda, dtype, kind, n_in, n_out):
    """GPT-2-small's linear shapes at decode (8 rows, 1 row) and prefill
    (37, 128 rows); a row's value must not depend on the rows beside it."""
    g = torch.Generator().manual_seed(3)
    qw, sc = QUANTIZERS[kind](torch.randn(n_out, n_in, generator=g)
                              * n_in ** -0.5)
    qw, sc = qw.to(cuda), sc.to(cuda)
    name = "dequant_matmul_w4" if kind.startswith("int4") else \
        "dequant_matmul"
    for m in (8, 1, 37, 128):
        x = torch.randn(m, n_in, generator=g).to(cuda, dtype)
        before = _build.launches[name]
        got = fused_dequant_matmul(x, qw, sc)
        assert _build.launches[name] == before + 1
        _close(got, fused_dequant_matmul_reference(x, qw, sc), dtype)
        if m == 37:
            alone = fused_dequant_matmul(x[5:6], qw, sc)
            assert torch.equal(alone, got[5:6])


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
    unwindowed ones. What the flash surface still refuses is a bias and a
    ``causal_offset`` (items 8 and 9)."""
    q, k, v = (torch.randn(1, 2, 16, 64, device=cuda, requires_grad=True)
               for _ in range(3))
    before = dict(_build.launches)
    flash_attention(q, k, v, causal=True, window=4).sum().backward()
    for name in ("flash_fwd_window", "flash_bwd_dq_window",
                 "flash_bwd_dkdv_window"):
        assert _build.launches[name] == before[name] + 1
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        assert _build.launches[name] == before[name]
    with pytest.raises(NotImplementedError, match="item 9"):
        flash_attention(q, k, v, torch.zeros(1, 2, 16, 16, device=cuda),
                        causal=True, window=4)
    with pytest.raises(NotImplementedError, match="item 9"):
        flash_attention_with_lse(q, k, v, causal=True, causal_offset=0)


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
