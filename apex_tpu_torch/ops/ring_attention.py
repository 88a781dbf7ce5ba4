"""Ring attention: flash attention over a sequence sharded on a ring of
context-parallel ranks.

Counterpart of ``apex_tpu/ops/ring_attention.py`` (``_check_ring_shapes``,
``_merge``, ``ring_attention``, ``zigzag_chunk_indices``, ``to_zigzag``,
``from_zigzag``, ``ring_attention_zigzag``, ``_zigzag_windowed``). Each rank
holds a ``[B, H, S_loc, D]`` chunk of q and a ``[B, Hkv, S_loc, D]`` chunk of
k and v (GQA: the ring carries the UNEXPANDED K/V), attends its queries to
its own chunk, then to the chunks that rotate in around the ring, and
merges the partial ``(o, lse)`` of each flash call in fp32 (``_merge``).
Every partial is a call of the flash kernels with the chunk's global
positions: ``causal_offset`` places the causal diagonal and the window,
``dropout_row0``/``dropout_col0`` the keep mask, so the ring reproduces one
unsharded ``flash_attention`` call, dropout included, up to the merge's
rounding. Gradients ride the kernels' autograd and the merge's; the K/V
rotation's backward sends each chunk's gradient back the other way.

Each rank's schedule is written once, against a small ring interface: the
rank's index ``rank``, the ring's ``size``, and ``rotate(tensors, hops)``,
which returns what ``hops`` rotations (rank ``i`` to ``i + 1``) bring in.
Two rings implement it:

- :class:`DistributedRing`, over a ``torch.distributed`` group: each
  process is one rank and holds its own chunk; ``rotate`` sends to ``rank +
  hops`` and receives from ``rank - hops`` (``batch_isend_irecv``) inside an
  autograd Function whose backward sends the gradient the other way (the
  reference's ``ppermute`` transpose);
- :class:`LocalRing`, in one process: the caller passes the WHOLE sequence
  (in the layout's order), the ring cuts it into ``size`` chunks and runs
  every rank's schedule in turn, ``rotate`` returning chunk ``(rank - r) mod
  size`` after ``r`` hops. This is how one card runs ``cp > 1`` (one GPU
  is one NCCL rank), as the reference's tests force a CPU mesh.

The reference's traced exclusions (``lax.cond``, ``jnp.where(r <= idx, lse,
-inf)``) are Python branches on the host rank here: a partial the reference
computes and then weighs 0 is skipped; every rank still makes every
rotation, so the rings stay in step. Skipped window hops fold into one
multi-hop rotation, as ``_zigzag_windowed`` does. Partials are cast to q's
dtype (the kernels' output), merged in fp32 and cast back at the end.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from apex_tpu_torch.ops.flash_attention import flash_attention_with_lse


def _check_ring_shapes(q, k, v, kind: str):
    """Self-attention ring contract, GQA-aware: q ``[B, H, S, D]`` with k/v
    ``[B, Hkv, S, D]``, Hkv dividing H."""
    if k.shape != v.shape:
        raise ValueError(f"{kind}: k/v shapes differ: {tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2],
                                                k.shape[3]):
        raise ValueError(
            f"{kind} self-attention needs matching batch/seq/head-dim, got "
            f"q {tuple(q.shape)} vs kv {tuple(k.shape)}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"{kind}: q heads ({q.shape[1]}) must be a "
                         f"multiple of kv heads ({k.shape[1]})")


def _merge(o1, lse1, o2, lse2):
    """Combine two normalized partial attentions (fp32): the convex
    combination weighted by ``exp(lse_i - lse_tot)``. A partial whose rows
    saw no key carries ``-inf`` (or the kernels' finite mask value) and
    gets weight 0; ``m_safe`` keeps an all-``-inf`` row free of NaN, in the
    value and in the gradient."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    w1 = torch.where(torch.isneginf(lse1), 0.0, torch.exp(lse1 - m_safe))
    w2 = torch.where(torch.isneginf(lse2), 0.0, torch.exp(lse2 - m_safe))
    den = w1 + w2
    den_safe = torch.where(den == 0.0, 1.0, den)
    o = (w1[..., None] * o1 + w2[..., None] * o2) / den_safe[..., None]
    lse = torch.where(den == 0.0, float("-inf"), m_safe + torch.log(den_safe))
    return o, lse


# --- the two rings ----------------------------------------------------------


class _Rotate(torch.autograd.Function):
    """Shift tensors ``hops`` ranks along a ``torch.distributed`` ring; the
    backward shifts their gradients ``hops`` ranks back."""

    @staticmethod
    def forward(ctx, ring, hops, *xs):
        ctx.ring, ctx.hops = ring, hops
        return tuple(ring.shift(xs, hops))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *ctx.ring.shift(gs, -ctx.hops))


class _Anchor(torch.autograd.Function):
    """``out`` unchanged, with a zero gradient to each rotated tensor, so
    that every rank runs the backward of every rotation, in the forward's
    order, whether or not its own partials read the chunk (a rank that
    skipped every later chunk must still pass the gradients of the others
    along)."""

    @staticmethod
    def forward(ctx, out, *held):
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in held]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g, *_):
        return (g, *(torch.zeros(s, dtype=d, device=dev)
                     for s, d, dev in ctx.shapes))


class DistributedRing:
    """The ring over a ``torch.distributed`` process group (the default
    group when None): this process is rank ``dist.get_rank(group)`` of
    ``size`` and holds its own chunk."""

    local = False

    def __init__(self, group=None):
        dist = torch.distributed
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("DistributedRing needs an initialized "
                               "torch.distributed process group")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def _peer(self, rank: int) -> int:
        rank %= self.size
        dist = torch.distributed
        return rank if self.group is None else dist.get_global_rank(
            self.group, rank)

    def shift(self, xs: Sequence[torch.Tensor], hops: int):
        """Send each of ``xs`` to ``rank + hops`` and receive its
        counterpart from ``rank - hops``."""
        dist = torch.distributed
        xs = [x.contiguous() for x in xs]
        outs = [torch.empty_like(x) for x in xs]
        dst, src = self._peer(self.rank + hops), self._peer(self.rank - hops)
        ops = [dist.P2POp(dist.isend, x, dst, self.group) for x in xs]
        ops += [dist.P2POp(dist.irecv, o, src, self.group) for o in outs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs

    def run(self, schedule, q, k, v):
        """This rank's schedule on its own chunks."""
        view = _RankView(self)
        return view.close(schedule(q, k, v, view))


class _RankView:
    """One rank's side of a :class:`DistributedRing` for one ring call: it
    rotates through the ring and remembers what came in (for ``_Anchor``)."""

    def __init__(self, ring: DistributedRing):
        self.ring, self.rank, self.size = ring, ring.rank, ring.size
        self.held = []

    def rotate(self, tensors, hops: int):
        out = _Rotate.apply(self.ring, hops, *tensors)
        self.held += out
        return out

    def close(self, out):
        return _Anchor.apply(out, *self.held) if self.held else out


class LocalRing:
    """``size`` ranks in one process: a ring call takes the whole sequence
    (the layout's order) and runs every rank's schedule on its chunk in
    turn."""

    local = True
    group = None
    rank = None

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"ring size must be >= 1, got {size}")
        self.size = int(size)

    def run(self, schedule, q, k, v):
        """Every rank's schedule over its chunk; their outputs in order."""
        if q.shape[2] % self.size:
            raise ValueError(f"sequence {q.shape[2]} not divisible by the "
                             f"ring size {self.size}")
        qs, ks, vs = ([c.contiguous() for c in t.chunk(self.size, dim=2)]
                      for t in (q, k, v))
        return torch.cat([schedule(qs[i], ks[i], vs[i],
                                   _LocalRank(i, self.size, ks, vs))
                          for i in range(self.size)], dim=2)


class _LocalRank:
    """Rank ``rank`` of a :class:`LocalRing`: after ``r`` hops it holds
    chunk ``(rank - r) mod size`` of k and v."""

    def __init__(self, rank: int, size: int, ks, vs):
        self.rank, self.size = rank, size
        self._chunks, self._held = (ks, vs), rank

    def rotate(self, tensors, hops: int):
        self._held = (self._held - hops) % self.size
        return tuple(c[self._held] for c in self._chunks)


def _scale(q, scale) -> float:
    return 1.0 / (q.shape[-1] ** 0.5) if scale is None else float(scale)


# --- sequence-ordered ring --------------------------------------------------


def ring_attention(q, k, v, *, ring, causal: bool = False,
                   scale: Optional[float] = None,
                   window: Optional[int] = None, dropout_rate: float = 0.0,
                   dropout_seed: int = 0):
    """Flash attention over a sequence sharded IN ORDER over ``ring`` (a
    :class:`DistributedRing` or a :class:`LocalRing`; the models pass
    ``parallel_state``'s): rank ``i`` holds tokens ``[i S_loc, (i + 1)
    S_loc)``.

    q ``[B, H, S, D]``, k/v ``[B, Hkv, S, D]`` (Hkv dividing H): the rank's
    chunk over a :class:`DistributedRing`, the whole sequence over a
    :class:`LocalRing`. ``causal`` masks at global positions; ``window``
    (causal only) shortens the ring to the ``ceil((window - 1) / S_loc)``
    hops the band reaches, each at the static offset ``r S_loc``; dropout
    draws the keep mask at global coordinates, so the result is the one
    unsharded ``flash_attention`` call's, up to the merge's rounding.
    Returns the output in q's dtype, shaped like q."""
    _check_ring_shapes(q, k, v, "ring")
    if window is not None and not causal:
        raise ValueError("window requires causal=True (same contract as "
                         "flash_attention)")
    kw = dict(causal=bool(causal), scale=_scale(q, scale), window=window,
              dropout_rate=float(dropout_rate), dropout_seed=int(dropout_seed))
    return ring.run(lambda q_, k_, v_, rank: _ring_rank(
        q_, k_, v_, rank, **kw), q, k, v)


def _ring_rank(q, k, v, rank, *, causal, scale, window, dropout_rate,
               dropout_seed):
    """One rank's sequence-ordered ring (``ring_attention``'s body)."""
    cp, idx = rank.size, rank.rank
    s_loc = q.shape[2]

    def attend(kk, vv, src, **kw):
        o, lse = flash_attention_with_lse(
            q, kk, vv, scale=scale, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, dropout_row0=idx * s_loc,
            dropout_col0=src * s_loc, **kw)
        return o.float(), lse

    # step 0: own chunk, for causal layouts the diagonal
    o0, lse = flash_attention_with_lse(
        q, k, v, scale=scale, causal=causal, window=window,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
        dropout_row0=idx * s_loc, dropout_col0=idx * s_loc)
    if cp == 1:
        return o0
    o = o0.float()
    kc, vc = k, v
    if window is not None:
        # the window-aware ring: at hop r the chunk sits r * s_loc rows
        # upstream, and chunks wholly outside the band are never reached
        n_hops = min(cp - 1, (window - 2 + s_loc) // s_loc)
        for r in range(1, n_hops + 1):
            kc, vc = rank.rotate((kc, vc), 1)
            if r <= idx:           # the ring wrap: later chunks excluded
                o, lse = _merge(o, lse, *attend(
                    kc, vc, (idx - r) % cp, causal=True,
                    causal_offset=r * s_loc, window=window))
        return o.to(q.dtype)
    for r in range(1, cp):
        kc, vc = rank.rotate((kc, vc), 1)
        # at hop r the rank holds chunk (idx - r) mod cp; under causal only
        # chunks before its own (r <= idx) take part
        if not causal or r <= idx:
            o, lse = _merge(o, lse, *attend(kc, vc, (idx - r) % cp,
                                            causal=False))
    return o.to(q.dtype)


# --- zigzag layout: load-balanced causal ring -------------------------------


def zigzag_chunk_indices(cp: int):
    """Global chunk ids (out of 2 cp) each rank holds: ``(i, 2cp - 1 - i)``."""
    return [(i, 2 * cp - 1 - i) for i in range(cp)]


def to_zigzag(x, cp: int, axis: int = 2):
    """Permute a GLOBAL sequence into zigzag rank order: rank ``i``'s slice
    holds chunks ``(i, 2cp - 1 - i)`` of ``2 cp``."""
    s = x.shape[axis]
    if s % (2 * cp):
        raise ValueError(f"sequence {s} not divisible by 2*cp={2 * cp}")
    chunks = torch.chunk(x, 2 * cp, dim=axis)
    return torch.cat([chunks[c] for pair in zigzag_chunk_indices(cp)
                      for c in pair], dim=axis)


def from_zigzag(x, cp: int, axis: int = 2):
    """Inverse of :func:`to_zigzag`."""
    order = [c for pair in zigzag_chunk_indices(cp) for c in pair]
    inv = [order.index(c) for c in range(2 * cp)]
    chunks = torch.chunk(x, 2 * cp, dim=axis)
    return torch.cat([chunks[i] for i in inv], dim=axis)


def ring_attention_zigzag(q, k, v, *, ring,
                          scale: Optional[float] = None,
                          window: Optional[int] = None,
                          dropout_rate: float = 0.0, dropout_seed: int = 0):
    """CAUSAL ring attention over a zigzag-sharded sequence: the sequence
    is cut into ``2 cp`` chunks and rank ``i`` holds the pair ``(i, 2cp - 1
    - i)`` (``to_zigzag`` makes the layout), so every rank does the same
    causal work per hop. q/k/v as in :func:`ring_attention`: the rank's
    slice ``[B, H, 2 S_h, D]`` over a :class:`DistributedRing`, the whole
    zigzag-ordered sequence over a :class:`LocalRing`. With ``window`` the
    band's pairs ride static offsets per hop (``r S_h``, ``(cp - r) S_h``)
    and the late-query-against-early-key block the rank's own ``(cq_l - j)
    S_h``; hops with no live block are not run, their rotations folded
    into the next one. Dropout at global coordinates (chunk id x S_h)."""
    _check_ring_shapes(q, k, v, "zigzag ring")
    kw = dict(scale=_scale(q, scale), window=window,
              dropout_rate=float(dropout_rate), dropout_seed=int(dropout_seed))
    return ring.run(lambda q_, k_, v_, rank: _zigzag_rank(
        q_, k_, v_, rank, **kw), q, k, v)


def _halves(t):
    s_h = t.shape[2] // 2
    return t[:, :, :s_h], t[:, :, s_h:]


def _zigzag_rank(q, k, v, rank, *, scale, window, dropout_rate,
                 dropout_seed):
    """One rank's zigzag ring (``ring_attention_zigzag``'s body)."""
    if q.shape[2] % 2:
        raise ValueError("local zigzag slice must hold two half-chunks")
    cp, idx = rank.size, rank.rank
    s_h = q.shape[2] // 2
    q_e, q_l = _halves(q)
    cq_e, cq_l = idx, 2 * cp - 1 - idx   # global chunk ids of the halves

    def attend(qq, kk, vv, causal, cq, ck, off=None, win=None):
        """One half-chunk flash call at global chunk ids ``cq``/``ck``
        (units of S_h)."""
        o, lse = flash_attention_with_lse(
            qq, kk, vv, scale=scale, causal=causal, causal_offset=off,
            window=win, dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            dropout_row0=cq * s_h, dropout_col0=ck * s_h)
        return o.float(), lse

    if window is not None:
        return _zigzag_windowed(q_e, q_l, k, v, rank, attend=attend,
                                s_h=s_h, cq_e=cq_e, cq_l=cq_l,
                                window=window).to(q.dtype)
    k_e, k_l = _halves(k)
    v_e, v_l = _halves(v)
    # step 0: own pair (early diagonal; late against early, late diagonal)
    acc_e = attend(q_e, k_e, v_e, True, cq_e, cq_e)
    acc_l = _merge(*attend(q_l, k_e, v_e, False, cq_l, cq_e),
                   *attend(q_l, k_l, v_l, True, cq_l, cq_l))
    kc, vc = k, v
    for r in range(1, cp):
        kc, vc = rank.rotate((kc, vc), 1)
        j = (idx - r) % cp               # the pair (j, 2cp - 1 - j) held
        kc_e, kc_l = _halves(kc)
        vc_e, vc_l = _halves(vc)
        # always live: late q against j's early kv
        acc_l = _merge(*acc_l, *attend(q_l, kc_e, vc_e, False, cq_l, j))
        # and exactly one more, by ring position
        if j < idx:
            acc_e = _merge(*acc_e, *attend(q_e, kc_e, vc_e, False, cq_e, j))
        else:
            acc_l = _merge(*acc_l, *attend(q_l, kc_l, vc_l, False, cq_l,
                                           2 * cp - 1 - j))
    return torch.cat([acc_e[0], acc_l[0]], dim=2).to(q.dtype)


def _zigzag_windowed(q_e, q_l, k, v, rank, *, attend, s_h, cq_e, cq_l,
                     window):
    """The sliding-window zigzag ring. Global q row ``cq s_h + a`` sees
    global k row ``cs s_h + b`` iff ``0 <= (cq - cs) s_h + a - b <= window -
    1``: a pair of half-chunks ``d = cq - cs >= 1`` apart is wholly out of
    band when ``d > d_max = 1 + floor((window - 2) / s_h)``. Returns the
    fp32 output."""
    cp, idx = rank.size, rank.rank
    d_max = (window - 2 + s_h) // s_h if window >= 2 else 0
    k_e, k_l = _halves(k)
    v_e, v_l = _halves(v)
    acc_e = attend(q_e, k_e, v_e, True, cq_e, cq_e, win=window)
    acc_l = attend(q_l, k_l, v_l, True, cq_l, cq_l, win=window)
    if cq_l - cq_e <= d_max:
        # late q against own early k, (2cp - 1 - 2 idx) chunks apart
        acc_l = _merge(*acc_l, *attend(q_l, k_e, v_e, True, cq_l, cq_e,
                                       off=(cq_l - cq_e) * s_h, win=window))
    # hop r carries live work iff the EE band (distance r) or the LL band
    # (distance cp - r) is within d_max; skipped hops fold into the next
    # live hop's rotation
    rot = 0
    kc, vc = k, v
    for r in (r for r in range(1, cp) if r <= d_max or cp - r <= d_max):
        kc, vc = rank.rotate((kc, vc), r - rot)
        rot = r
        kc_e, kc_l = _halves(kc)
        vc_e, vc_l = _halves(vc)
        j = (idx - r) % cp               # the source rank of the held pair
        if r <= d_max and j < idx:
            acc_e = _merge(*acc_e, *attend(q_e, kc_e, vc_e, True, cq_e, j,
                                           off=r * s_h, win=window))
        if cp - r <= d_max and j > idx:
            acc_l = _merge(*acc_l, *attend(
                q_l, kc_l, vc_l, True, cq_l, 2 * cp - 1 - j,
                off=(cp - r) * s_h, win=window))
        # late q against the received early k, (cq_l - j) chunks apart:
        # run where that block reaches the band
        if cq_l - j <= d_max:
            acc_l = _merge(*acc_l, *attend(q_l, kc_e, vc_e, True, cq_l, j,
                                           off=(cq_l - j) * s_h, win=window))
    return torch.cat([acc_e[0], acc_l[0]], dim=2)


# --- the positions a process holds ------------------------------------------


def context_positions(ring, s: int, *, zigzag: bool, device=None):
    """The global positions (int64 ``[s]``) of the ``s`` tokens this
    process holds under context parallelism over ``ring``: the rank's
    chunk over a :class:`DistributedRing` (``[i s, (i + 1) s)``, or zigzag's
    two half-chunks ``i`` and ``2cp - 1 - i``), the whole sequence in the
    layout's order over a :class:`LocalRing`."""
    cp = ring.size
    if ring.local:
        pos = torch.arange(s, device=device)
        return to_zigzag(pos, cp, axis=0) if zigzag and cp > 1 else pos
    i = ring.rank
    if not zigzag or cp == 1:
        return torch.arange(s, device=device) + i * s
    if s % 2:
        raise ValueError("zigzag CP needs an even local sequence")
    s_h = s // 2
    return torch.cat([torch.arange(s_h, device=device) + i * s_h,
                      torch.arange(s_h, device=device)
                      + (2 * cp - 1 - i) * s_h])


def global_length(ring, s: int) -> int:
    """The global sequence length of ``s`` tokens held per process."""
    return s if ring.local else ring.size * s
