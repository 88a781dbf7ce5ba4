"""Port parity: apex_tpu_torch's fused softmax cross entropy vs apex_tpu's.

The same numpy logits and labels go through
``apex_tpu.ops.softmax_cross_entropy`` (its Pallas ``_fwd_kernel`` and
``_bwd_kernel`` in interpret mode, dx through ``jax.grad``) and the port's
twins through autograd: label smoothing, ``padding_idx`` rows, a vocabulary
that is not a multiple of 128, BERT's 2-wide NSP rows with
``padding_idx=-1``, and bf16 logits. fp32 losses within atol = rtol =
1e-5 and dx within 1e-6 (the same fp32 formula in another summation
order); bf16 dx within one bf16 ulp (atol 1e-2, rtol 1e-2) of the
reference's, since both round the same fp32 value once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.xentropy import SoftmaxCrossEntropyLoss as JaxLoss
from apex_tpu.ops import softmax_cross_entropy as jax_xent
from apex_tpu_torch.contrib.xentropy import (SoftmaxCrossEntropyLoss,
                                             softmax_cross_entropy_loss)
from apex_tpu_torch.ops.xentropy import (softmax_cross_entropy,
                                         xentropy_bwd_reference,
                                         xentropy_fwd_reference)

CASES = [
    # rows, vocab, smoothing, padding_idx, dtype
    (16, 512, 0.0, 0, "float32"),
    (16, 512, 0.1, 0, "float32"),
    (13, 300, 0.1, None, "float32"),      # V not a multiple of 128
    (8, 2, 0.0, -1, "float32"),           # the NSP head
    (16, 384, 0.1, 0, "bfloat16"),
]


def _inputs(rows, vocab, padding_idx, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, rows).astype(np.int32)
    if padding_idx is not None and padding_idx >= 0:
        labels[::3] = padding_idx             # some padded rows
    dy = rng.standard_normal(rows).astype(np.float32)
    return x, labels, dy


def _jax(x, labels, dy, smoothing, padding_idx, dtype):
    xj = jnp.asarray(x).astype(dtype)

    def f(x_):
        return jax_xent(x_, jnp.asarray(labels), smoothing, padding_idx)

    loss = f(xj)
    dx = jax.grad(lambda x_: jnp.sum(f(x_) * jnp.asarray(dy)))(xj)
    return np.asarray(loss), np.asarray(dx.astype(jnp.float32))


@pytest.mark.parametrize("rows,vocab,smoothing,padding_idx,dtype", CASES)
def test_loss_and_dx_match_jax(rows, vocab, smoothing, padding_idx, dtype):
    x, labels, dy = _inputs(rows, vocab, padding_idx, seed=rows + vocab)
    want_loss, want_dx = _jax(x, labels, dy, smoothing, padding_idx, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    loss = softmax_cross_entropy(xt, torch.from_numpy(labels), smoothing,
                                 padding_idx)
    assert loss.dtype == torch.float32 and loss.shape == (rows,)
    loss.backward(torch.from_numpy(dy))
    assert xt.grad.dtype == xt.dtype
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, atol=1e-5,
                               rtol=1e-5)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(xt.grad.float().numpy(), want_dx, atol=tol,
                               rtol=tol)
    if padding_idx is not None and padding_idx >= 0:
        pad = labels == padding_idx
        assert pad.any()
        assert (loss.detach().numpy()[pad] == 0).all()
        assert (xt.grad.float().numpy()[pad] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_logits_match_jax(dtype):
    """Logits masked to -inf (a vocabulary's special tokens, say) in the
    first columns and a few later ones: finite losses and gradients, 0 on
    the masked columns, as the reference gives them."""
    x, labels, dy = _inputs(12, 700, 0, seed=8)
    x[:, :256] = -np.inf
    x[::2, 300:310] = -np.inf
    labels = np.where(labels < 310, labels + 310, labels).astype(np.int32)
    labels[::3] = 0
    want_loss, want_dx = _jax(x, labels, dy, 0.0, 0, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    loss = softmax_cross_entropy(xt, torch.from_numpy(labels), 0.0, 0)
    loss.backward(torch.from_numpy(dy))
    assert torch.isfinite(loss).all() and torch.isfinite(xt.grad).all()
    assert (xt.grad[:, :256] == 0).all()
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, atol=1e-5,
                               rtol=1e-5)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(xt.grad.float().numpy(), want_dx, atol=tol,
                               rtol=tol)


def test_matches_torch_cross_entropy_without_smoothing():
    x, labels, _ = _inputs(10, 97, 0, seed=3)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels).long()
    want = torch.nn.functional.cross_entropy(xt, lt, reduction="none",
                                             ignore_index=0)
    torch.testing.assert_close(softmax_cross_entropy(xt, lt, padding_idx=0),
                               want, atol=1e-5, rtol=1e-5)


def test_leading_dims_and_out_of_range_label():
    """``[..., V]`` logits give ``[...]`` losses; a label outside ``[0, V)``
    picks no logit (loss = LSE), as in the reference."""
    x = torch.randn(2, 3, 7, generator=torch.Generator().manual_seed(4))
    labels = torch.tensor([[0, 6, 7], [1, -2, 3]])
    loss = softmax_cross_entropy(x, labels)
    assert loss.shape == (2, 3)
    lse = torch.logsumexp(x, dim=-1)
    torch.testing.assert_close(loss[0, 2], lse[0, 2])
    torch.testing.assert_close(loss[1, 1], lse[1, 1])
    want = jax_xent(jnp.asarray(x.numpy()), jnp.asarray(labels.numpy()))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_twins_are_the_functions_pieces():
    """The forward twin's LSE feeds the backward twin: their product is
    autograd's gradient of the loss."""
    x, labels, dy = _inputs(6, 33, 0, seed=5)
    xt, lt, dyt = (torch.from_numpy(a) for a in (x, labels, dy))
    loss, lse = xentropy_fwd_reference(xt, lt, 0.1, 0)
    torch.testing.assert_close(lse, torch.logsumexp(xt, dim=-1))
    dx = xentropy_bwd_reference(xt, lt, lse, dyt, 0.1, 0)
    xg = xt.clone().requires_grad_()
    (softmax_cross_entropy(xg, lt, 0.1, 0) * dyt).sum().backward()
    torch.testing.assert_close(dx, xg.grad, atol=0, rtol=0)


def test_smoothing_range():
    x, labels, _ = _inputs(2, 8, None, seed=6)
    with pytest.raises(ValueError, match="smoothing"):
        softmax_cross_entropy(torch.from_numpy(x), torch.from_numpy(labels),
                              smoothing=1.0)


@pytest.mark.parametrize("half_to_float", [False, True])
def test_contrib_loss_dtype_rule_matches_jax(half_to_float):
    """``SoftmaxCrossEntropyLoss`` keeps 16-bit losses for 16-bit logits
    unless ``half_to_float``, as the reference; padding_idx defaults to
    0."""
    x, labels, _ = _inputs(12, 64, 0, seed=7)
    xt = torch.from_numpy(x).bfloat16()
    got = SoftmaxCrossEntropyLoss.apply(xt, torch.from_numpy(labels), 0.1,
                                        0, half_to_float)
    want = JaxLoss.apply(jnp.asarray(x).astype(jnp.bfloat16),
                         jnp.asarray(labels), 0.1, 0, half_to_float)
    assert got.dtype == (torch.float32 if half_to_float else torch.bfloat16)
    assert str(np.asarray(want).dtype) == str(got.dtype).split(".")[1]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(
        softmax_cross_entropy_loss(xt, torch.from_numpy(labels), 0.1, 0,
                                   half_to_float), got)
    assert (got[::3] == 0).all()
