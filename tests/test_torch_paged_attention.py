"""Port parity: apex_tpu_torch paged-attention decode vs the JAX kernel.

Random block tables over a shuffled pool, lengths that include 0, exact
page boundaries and the full ``max_pages * page_size``, MHA and GQA. On the
CPU the port runs the kernel's plain twin; the JAX side runs its Pallas
kernel in interpret mode. fp32 tolerance atol = rtol = 1e-5; a zero-length
slot must output exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import paged_attention as jax_paged
from apex_tpu.ops.paged_attention import \
    paged_attention_reference as jax_paged_ref
from apex_tpu_torch.ops.paged_attention import (paged_attention,
                                                paged_attention_reference)

D, MAXP = 16, 4


def _case(h, kv, ps, lengths, seed=0):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    num_pages = 1 + b * MAXP
    q = rng.standard_normal((b, h, 1, D)).astype(np.float32)
    kp = rng.standard_normal((num_pages, kv, ps, D)).astype(np.float32)
    vp = rng.standard_normal((num_pages, kv, ps, D)).astype(np.float32)
    perm = rng.permutation(num_pages - 1) + 1        # shuffled pool
    bt = np.zeros((b, MAXP), np.int32)               # dead entries -> page 0
    for i, n in enumerate(lengths):
        used = -(-n // ps)
        bt[i, :used] = perm[i * MAXP:i * MAXP + used]
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


CASES = [
    (4, 4, 8, [0, 1, 8, 9, 32]),          # MHA: empty, 1, page edge, full
    (4, 2, 8, [5, 0, 16, 31, 17]),         # GQA rep 2
    (4, 1, 16, [64, 15, 16, 0, 33]),       # MQA, page 16, full table
]


@pytest.mark.parametrize("h,kv,ps,lengths", CASES)
def test_paged_matches_jax_kernel(h, kv, ps, lengths):
    q, kp, vp, bt, ln = _case(h, kv, ps, lengths, seed=ps + kv)
    want = np.asarray(jax_paged(*(jnp.asarray(a) for a in
                                  (q, kp, vp, bt, ln))))
    got = paged_attention(*(torch.from_numpy(a) for a in
                            (q, kp, vp, bt, ln))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for i, n in enumerate(lengths):
        if n == 0:
            assert (got[i] == 0).all()           # exactly 0, not merely small


@pytest.mark.parametrize("h,kv,ps,lengths", CASES[:2])
def test_paged_twin_matches_jax_reference(h, kv, ps, lengths):
    q, kp, vp, bt, ln = _case(h, kv, ps, lengths, seed=11)
    want = np.asarray(jax_paged_ref(*(jnp.asarray(a) for a in
                                      (q, kp, vp, bt, ln))))
    got = paged_attention_reference(*(torch.from_numpy(a) for a in
                                      (q, kp, vp, bt, ln))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_paged_never_reads_dead_pages():
    """Overwriting every page no slot owns (the null page included) with
    large values leaves every output unchanged."""
    q, kp, vp, bt, ln = _case(4, 2, 8, [5, 12, 0, 24, 7], seed=5)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, ln)]
    clean = paged_attention(*args)
    live = {int(p) for i, n in enumerate(ln) for p in bt[i, :-(-n // 8)]}
    dead = [p for p in range(kp.shape[0]) if p not in live]
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[dead] = 1e4
    vp2[dead] = -1e4
    poisoned = paged_attention(args[0], torch.from_numpy(kp2),
                               torch.from_numpy(vp2), args[3], args[4])
    torch.testing.assert_close(poisoned, clean, atol=0, rtol=0)


@pytest.mark.parametrize("kw,exc,match", [
    # a windowed query block longer than a page: the reference's limit
    pytest.param(dict(window=4, s=9), ValueError, "1..page_size",
                 id="kw0-window"),
    pytest.param(dict(k_scales=torch.ones(17, 2),
                      v_scales=torch.ones(17, 2)),
                 NotImplementedError, "quantized", id="kw1-quantized"),
])
def test_unported_paged_options_raise(kw, exc, match):
    """What the paged kernel refuses: a query block of more than
    ``page_size`` positions (the reference's ``ValueError``, windowed or
    not) and scales over full-precision pages."""
    kw = dict(kw)
    s = kw.pop("s", 1)
    q, kp, vp, bt, ln = (torch.from_numpy(a) for a in
                         _case(4, 2, 8, [3, 4, 5, 6]))
    with pytest.raises(exc, match=match):
        paged_attention(q.repeat(1, 1, s, 1), kp, vp, bt, ln, **kw)
    with pytest.raises(exc, match=match):
        paged_attention_reference(q.repeat(1, 1, s, 1), kp, vp, bt, ln,
                                  **kw)


def test_multi_token_query_block_raises():
    """``s > page_size`` raises the reference's ``ValueError`` on both
    sides; ``s = 2`` runs and matches JAX's kernel."""
    q, kp, vp, bt, ln = _case(4, 2, 8, [3, 4, 5, 6])
    q2 = np.concatenate([q, -q], axis=2)
    want = np.asarray(jax_paged(*(jnp.asarray(a) for a in
                                  (q2, kp, vp, bt, ln))))
    got = paged_attention(*(torch.from_numpy(a) for a in
                            (q2, kp, vp, bt, ln))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    q9 = np.repeat(q, 9, axis=2)
    with pytest.raises(ValueError, match="1..page_size"):
        jax_paged(*(jnp.asarray(a) for a in (q9, kp, vp, bt, ln)))
    with pytest.raises(ValueError, match="1..page_size"):
        paged_attention(*(torch.from_numpy(a) for a in
                          (q9, kp, vp, bt, ln)))
