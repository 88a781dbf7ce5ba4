"""Port parity in bf16 for the dequant-matmul kernels, on the CPU.

(a) The port's plain twin of ``fused_dequant_matmul`` in bf16 against JAX's
``fused_dequant_matmul`` in bf16 (its Pallas kernel in interpret mode, as
the JAX package's tests run it): the same numpy inputs, x rounded once to
bf16; int8, e4m3 and int4 at groups 16 and 128; 1, 8, 37 and 128 rows;
tiny widths. The bar is the card's, ``chip_smoke.TOL["bfloat16"]``.

(b) An emulation of the bf16 tensor-core kernels' arithmetic
(``csrc/dequant_matmul.cu``, ``dequant_matmul_mma_kernel`` and
``dequant_matmul_w4_mma_kernel``), lane by lane: each lane's A registers
widened from its weight word by the kernels' bit operations
(``__byte_perm`` selectors, masks, the bf16 magic numbers), its B
registers read at the kernels' offsets of the staged x tiles (the values
under the low and the high nibbles for int4), each register placed where
``mma.m16n8k16`` reads it, every product exact and each step's sum
rounded once to fp32, the int4 partials folded with their group's scale
by one fma, the four warps' and the K split's parts summed in order, the
per-channel scale last. It is held against the twin's fp32 matmul within
the fp32 rounding bound of an n_in-term dot, at GPT-2-small's four block
shapes (int8, e4m3, int4 at groups 16 and 128; 512 where n_in allows),
at groups 32, 64 and 256, at ragged widths, and at every shape the
reference serves beyond those (groups of 2, 4, 8, 1024 and 2048, with
one masked product a group below 16; int8/e4m3 ``in_features`` that are
no multiple of 8); and a row alone equals, bit
for bit, the same row in a batch of 37 (the order is fixed by the shape,
``mma_k_split``, never by the rows). A wrong fragment mapping (a
nibble, a lane or a K offset of x off by one) leaves the bound by orders
of magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import quant as jq
from apex_tpu_torch.ops import quant as tq

TOL = (2e-2, 1e-2)                  # chip_smoke.TOL["bfloat16"]
GPT2_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
STAGE_K = tq.MMA_STAGE_K            # K values a stage holds, 64 a warp
LANE_G = np.arange(8)[:, None]      # lane // 4: a fragment's row (A), column (B)
LANE_T = np.arange(4)[None, :]      # lane % 4
ONES = 0x3F803F80                   # bf16x2 (1, 1)
E4M3 = torch.arange(256, dtype=torch.uint8).view(
    torch.float8_e4m3fn).double().numpy()


# --- the kernels' register arithmetic ----------------------------------------

def _bf16(bits):
    """16-bit bf16 patterns -> float64."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32).astype(
        np.float64)


def _halves(reg):
    return _bf16(reg & 0xFFFF), _bf16(reg >> 16)


def _round_bf16(v):
    """float64 values (exact in fp32) -> bf16 bits, to nearest even."""
    f = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return (((f + 0x7FFF + ((f >> 16) & 1)) >> 16) & 0xFFFF).astype(
        np.uint32)


def _pack(lo, hi):
    return _round_bf16(lo) | (_round_bf16(hi) << 16)


def fma_bf16x2(a, b, c):
    (al, ah), (bl, bh), (cl, ch) = _halves(a), _halves(b), _halves(c)
    return _pack(al * bl + cl, ah * bh + ch)


def byte_perm(x, y, sel):
    """CUDA's ``__byte_perm``: byte n of the result is byte ``sel >> 4n &
    7`` of the eight bytes (x's then y's)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(np.uint32(y) >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << (8 * n)
    return out


def int8_pair(h):
    return fma_bf16x2((h & 0x007F007F) | 0x43004300, ONES,
                      (h & 0x00800080) | 0xC300C300)


def e4m3_pair(h):
    return _pack(E4M3[h & 0xFF], E4M3[(h >> 8) & 0xFF])


def nibble_pair(w, s):
    return fma_bf16x2(((w >> s) & 0x000F000F) | 0x43004300, ONES, 0xC308C308)


def widen_word(kind, w):
    """``widen_word<KIND>``: bytes 0..3 of a row's word as that row's two A
    registers (bytes 0, 1 and bytes 2, 3)."""
    if kind == "int8":
        return (int8_pair(byte_perm(w, 0, 0x4140)),
                int8_pair(byte_perm(w, 0, 0x4342)))
    return e4m3_pair(w), e4m3_pair(w >> 16)


def a_matrix(regs):
    """A registers ``regs[r]`` ([F, 8 g, 4 t]) as F 16 x 16 matrices: a0
    (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..)."""
    a = np.zeros((regs[0].shape[0], 16, 16))
    for r, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        lo, hi = _halves(regs[r])
        a[:, LANE_G + dr, 2 * LANE_T + dk] = lo
        a[:, LANE_G + dr, 2 * LANE_T + dk + 1] = hi
    return a


def b_matrix(b0, b1):
    """B registers ([N, 8 g, 4 t]) as N 16 x 8 matrices: b0 (k 2t.., n
    g), b1 (k 2t + 8.., n g)."""
    b = np.zeros((b0.shape[0], 16, 8))
    for reg, dk in ((b0, 0), (b1, 8)):
        lo, hi = _halves(reg)
        b[:, 2 * LANE_T + dk, LANE_G] = lo
        b[:, 2 * LANE_T + dk + 1, LANE_G] = hi
    return b


def mma(acc, a, b):
    """``acc += a b`` per (fragment, n tile): the 16 products exact, their
    sum and the accumulator rounded once to fp32."""
    d = np.einsum("fik,nkj->fnij", a, b)
    return (acc.astype(np.float64) + d).astype(np.float32)


def emulate(x, qw, sc):
    """The bf16 kernels' fp32 result (before the cast to bf16) of
    ``fused_dequant_matmul(x, qw, sc)``, x bf16 ``(m, in)``."""
    kind, out, n_in, gs = tq._weight_dims(qw, sc)
    int4 = kind == "int4"
    m = x.shape[0]
    parts, per = tq.mma_k_split(n_in, out)
    stages = -(-n_in // STAGE_K)
    fr, nt = -(-out // 16), -(-m // 8)
    row_bytes = qw.shape[1]
    stage_bytes = STAGE_K // 2 if int4 else STAGE_K
    wb = np.zeros((16 * fr, stages * stage_bytes), np.uint32)
    wb[:out, :row_bytes] = qw.view(torch.uint8).numpy()
    xb = np.zeros((8 * nt, stages * STAGE_K + 8), np.uint32)
    xb[:m, :n_in] = x.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    half = gs // 2
    # int4: a stage past the row's end stages zero scales, as the kernel
    s = np.zeros((stages * STAGE_K // gs + 1 if int4 else 1, 16 * fr),
                 np.float32)
    s[:sc.shape[0] if int4 else 1, :out] = sc.numpy()
    rows = (np.arange(fr)[:, None] * 16 + LANE_G.T)[..., None]  # [F, 8, 1]
    toks = (np.arange(nt)[:, None] * 8 + LANE_G.T)[..., None]   # [N, 8, 1]

    def word(row0, off, n=4):
        return sum(wb[row0, off + i] << (8 * i) for i in range(n))

    def xreg(cols):                   # x's bf16 pair at columns (c, c + 1)
        return xb[toks, cols] | (xb[toks, cols + 1] << 16)

    def xpair(c0, c1):                # x's bf16 pair at columns (c0, c1)
        return xb[toks, c0] | (xb[toks, c1] << 16)

    def k_low(byte):                  # the value under a byte's low nibble
        return byte // half * gs + byte % half

    total = None
    for p in range(parts):
        warps = []
        for w in range(4):
            acc = np.zeros((fr, nt, 16, 8), np.float32)
            prt = np.zeros_like(acc)
            for st in range(p * per, min(stages, (p + 1) * per)):
                if not int4:
                    for step in range(4):
                        k = st * STAGE_K + w * 64 + 16 * step + 4 * LANE_T
                        a0, a2 = widen_word(kind, word(rows, k))
                        a1, a3 = widen_word(kind, word(rows + 8, k))
                        acc = mma(acc, a_matrix((a0, a1, a2, a3)),
                                  b_matrix(xreg(k), xreg(k + 2)))
                    continue
                bw = st * stage_bytes + w * 32   # the warp's first byte
                g0 = st * stage_bytes // half
                n_groups = max(1, stage_bytes // half)

                def fold(acc, prt, byte):
                    gi = byte // half - g0
                    assert 0 <= gi < n_groups
                    sg = s[g0 + gi].reshape(fr, 1, 16, 1)
                    acc = (prt.astype(np.float64) * sg + acc).astype(
                        np.float32)
                    return acc, np.zeros_like(prt)

                if gs < 16:
                    # 8 / half groups a step: one product a group, the
                    # other groups' K positions of A masked to zero
                    hs = half.bit_length() - 1
                    for q in range(4):
                        byte = bw + 8 * q + 2 * LANE_T
                        lo = byte_perm(word(rows, byte, 2), 0, 0x4140)
                        hi = byte_perm(word(rows + 8, byte, 2), 0, 0x4140)
                        a = (nibble_pair(lo, 0), nibble_pair(hi, 0),
                             nibble_pair(lo, 4), nibble_pair(hi, 4))
                        b0 = xpair(k_low(byte), k_low(byte + 1))
                        b1 = xpair(k_low(byte) + half, k_low(byte + 1) + half)
                        for qq in range(8 // half):
                            keep = (np.where((2 * LANE_T) >> hs == qq,
                                             0xFFFF, 0)
                                    | np.where((2 * LANE_T + 1) >> hs == qq,
                                               0xFFFF0000, 0)).astype(
                                                   np.uint32)
                            am = tuple(r & keep for r in a)
                            prt = mma(prt, a_matrix(am), b_matrix(b0, b1))
                            acc, prt = fold(acc, prt, bw + 8 * q + qq * half)
                    continue
                if gs == 16:
                    for q in range(4):
                        byte = bw + 8 * q + 2 * LANE_T
                        lo = byte_perm(word(rows, byte, 2), 0, 0x4140)
                        hi = byte_perm(word(rows + 8, byte, 2), 0, 0x4140)
                        a = (nibble_pair(lo, 0), nibble_pair(hi, 0),
                             nibble_pair(lo, 4), nibble_pair(hi, 4))
                        prt = mma(prt, a_matrix(a),
                                  b_matrix(xreg(k_low(byte)),
                                           xreg(k_low(byte) + half)))
                        acc, prt = fold(acc, prt, bw + 8 * q)
                    continue
                for u in range(2):
                    byte = bw + 16 * u + 4 * LANE_T
                    wl = byte_perm(word(rows, byte), 0, 0x3120)
                    wh = byte_perm(word(rows + 8, byte), 0, 0x3120)
                    for h in range(2):
                        a = (nibble_pair(wl, 4 * h), nibble_pair(wh, 4 * h),
                             nibble_pair(wl, 8 + 4 * h),
                             nibble_pair(wh, 8 + 4 * h))
                        col = k_low(byte) + h * half
                        prt = mma(prt, a_matrix(a),
                                  b_matrix(xreg(col), xreg(col + 2)))
                    if gs == 32:
                        acc, prt = fold(acc, prt, bw + 16 * u)
                if gs >= 64:
                    acc, prt = fold(acc, prt, bw)
            warps.append(acc)
        block = warps[0]
        for acc in warps[1:]:
            block = block + acc
        total = block if total is None else total + block
    y = total.transpose(1, 3, 0, 2).reshape(8 * nt, 16 * fr)[:m, :out]
    return y if int4 else y * s[0, :out]


# --- inputs ------------------------------------------------------------------

QUANTIZERS = {
    "int8": (tq.quantize_weight, jq.quantize_weight),
    "fp8": (tq.quantize_weight_fp8, jq.quantize_weight_fp8),
    "int4": (tq.quantize_weight_int4, jq.quantize_weight_int4)}


def _inputs(kind, gs, m, n_in, n_out, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_out, n_in)) * n_in ** -0.5).astype(
        np.float32)
    x = rng.standard_normal((m, n_in)).astype(np.float32)
    kw = {"group_size": gs} if kind == "int4" else {}
    qw, sc = QUANTIZERS[kind][0](torch.from_numpy(w), **kw)
    return w, x, kw, qw, sc


def _within_fp32_rounding(got, x, qw, sc):
    """``got`` (fp32) against the twin's fp32 matmul, within twice the
    rounding bound of an n_in-term fp32 dot (each side's error is at most
    n_in u sum |x w|)."""
    xf = x.float()
    deq = tq.dequantize_weight(qw, sc)
    want = (xf @ deq.T).numpy()
    bound = (2 * x.shape[1] + 4) * 2.0 ** -24 * (xf.abs() @ deq.abs().T)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= bound.numpy()).all(), \
        f"max err {err.max():.3e}, bound there {bound.numpy().flat[err.argmax()]:.3e}"


# --- (a) the twin in bf16 against JAX's kernel --------------------------------

@pytest.mark.parametrize("kind,gs", [("int8", 0), ("fp8", 0), ("int4", 16),
                                     ("int4", 128)])
@pytest.mark.parametrize("m", [1, 8, 37, 128])
def test_twin_bf16_matches_jax_kernel(kind, gs, m):
    w, x, kw, qw, sc = _inputs(kind, gs, m, 256, 48, seed=m)
    jw, js = QUANTIZERS[kind][1](jnp.asarray(w), **kw)
    want = np.asarray(jq.fused_dequant_matmul(
        jnp.asarray(x).astype(jnp.bfloat16), jw, js).astype(jnp.float32))
    got = tq.fused_dequant_matmul(torch.from_numpy(x).bfloat16(), qw, sc)
    assert got.dtype == torch.bfloat16 and got.shape == (m, 48)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[0],
                               rtol=TOL[1])


# --- (b) the kernels' arithmetic, emulated -------------------------------------

EMULATED = [(kind, gs, n_in, n_out)
            for n_in, n_out in GPT2_SHAPES
            for kind, gs in (("int8", 0), ("fp8", 0), ("int4", 16),
                             ("int4", 128))]
EMULATED += [("int4", 512, 3072, 768), ("int4", 512, 1024, 40),
             ("int4", 32, 256, 48), ("int4", 64, 384, 40),
             ("int4", 256, 768, 40), ("int8", 0, 24, 40), ("fp8", 0, 24, 40),
             ("int8", 0, 520, 33), ("int4", 16, 48, 40)]
# every shape the reference serves (ROADMAP C2): int4 groups of 2, 4 and 8
# (several groups in a k16 step, one masked product each) and of 1024 and
# 2048 (a stage inside one group), at GPT-2-small's widths and ragged ones
# (rows of 18 and 50 packed bytes); int8/e4m3 in_features that are no
# multiple of 8 (the K tail zero-filled)
C2_SHAPES = [("int4", gs, 768, 2304) for gs in (2, 4, 8)]
C2_SHAPES += [("int4", 1024, 768 * 4, 768), ("int4", 2048, 2048, 40),
              ("int4", 2, 36, 40), ("int4", 4, 100, 33), ("int4", 8, 72, 40),
              ("int8", 0, 36, 40), ("fp8", 0, 36, 40), ("int8", 0, 100, 33),
              ("fp8", 0, 1001, 48)]
EMULATED += C2_SHAPES


@pytest.mark.parametrize("kind,gs,n_in,n_out", EMULATED)
def test_emulated_kernel_within_fp32_rounding_of_twin(kind, gs, n_in, n_out):
    _, x, _, qw, sc = _inputs(kind, gs, 37, n_in, n_out, seed=n_in + n_out)
    x = torch.from_numpy(x).bfloat16()
    got = emulate(x, qw, sc)
    _within_fp32_rounding(got, x, qw, sc)
    # the cast: the emulation's bf16 output against the twin's, at the bar
    np.testing.assert_allclose(
        torch.from_numpy(got).bfloat16().float().numpy(),
        tq.fused_dequant_matmul(x, qw, sc).float().numpy(),
        atol=TOL[0], rtol=TOL[1])


@pytest.mark.parametrize("kind,gs,n_in,n_out", [
    ("int8", 0, 3072, 768), ("fp8", 0, 768, 2304), ("int4", 16, 768, 768),
    ("int4", 128, 768, 3072), ("int4", 512, 3072, 768),
    ("int4", 2, 768, 768), ("int4", 4, 100, 40), ("int4", 1024, 2048, 40),
    ("int8", 0, 36, 40)])
def test_emulated_row_alone_equals_row_in_batch(kind, gs, n_in, n_out):
    _, x, _, qw, sc = _inputs(kind, gs, 37, n_in, n_out, seed=1)
    x = torch.from_numpy(x).bfloat16()
    batch = emulate(x, qw, sc)
    for i in (0, 5, 36):
        np.testing.assert_array_equal(emulate(x[i:i + 1], qw, sc),
                                      batch[i:i + 1])


def test_k_split_depends_on_the_shape_alone():
    """Every stage in exactly one part, none empty, the parts even where
    the stages allow; at GPT-2-small's shapes a decode step's one token
    tile gets at least 72 blocks (132 where K has the stages for it)."""
    for n_in, n_out in GPT2_SHAPES + ((24, 40), (520, 33), (8192, 28672)):
        parts, per = tq.mma_k_split(n_in, n_out)
        stages = -(-n_in // STAGE_K)
        assert (parts - 1) * per < stages <= parts * per
        blocks = -(-n_out // tq.MMA_CHANNELS) * parts
        assert blocks >= min(tq.MMA_FILL_BLOCKS,
                             -(-n_out // tq.MMA_CHANNELS) * stages)
    assert [tq.mma_k_split(*s) for s in GPT2_SHAPES] == \
        [(3, 1), (3, 1), (3, 1), (6, 2)]
