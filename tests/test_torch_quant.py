"""Port parity: apex_tpu_torch.ops.quant against apex_tpu.ops.quant.

Weights made with numpy from a seed go through both packages. The
quantizers and the int4 packing must be bit-equal to JAX's; the port's
``fused_dequant_matmul`` twin (the CPU side of the ``dequant_matmul`` and
``dequant_matmul_w4`` kernels) must agree with JAX's Pallas kernel, run in
interpret mode, within 1e-5 in fp32 (both sum fp32 products of the same
values, in other orders); the dtype, group and policy errors carry JAX's
names; and the port's GPT-2-small state dict meets the reference's byte
pins (int8 <= 0.55x, int4 <= 0.35x of the fp tree).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import quant as jq
from apex_tpu_torch.models import GPTModel, gpt2_small_config
from apex_tpu_torch.ops import quant as tq


def _np(t):
    """A tensor or array as numpy, fp8 as its uint8 bits."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.float8_e4m3fn:
            return t.view(torch.uint8).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _weights(seed=0, shape=(96, 64)):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[3] = 0.0                                   # an all-zero channel
    return w


@pytest.mark.parametrize("kind", ["int8", "fp8", "int4"])
def test_quantizers_bit_equal_to_jax(kind):
    w = _weights()
    if kind == "int8":
        jw, js = jq.quantize_weight(jnp.asarray(w))
        tw, ts = tq.quantize_weight(torch.from_numpy(w))
    elif kind == "fp8":
        jw, js = jq.quantize_weight_fp8(jnp.asarray(w))
        tw, ts = tq.quantize_weight_fp8(torch.from_numpy(w))
    else:
        jw, js = jq.quantize_weight_int4(jnp.asarray(w), group_size=16)
        tw, ts = tq.quantize_weight_int4(torch.from_numpy(w), group_size=16)
    assert tw.dtype == tq.weight_storage_dtype(kind)
    np.testing.assert_array_equal(_np(tw), _np(jw))
    np.testing.assert_array_equal(_np(ts), _np(js))
    np.testing.assert_array_equal(
        tq.dequantize_weight(tw, ts).numpy(),
        np.asarray(jq.dequantize_weight(jw, js)))


@pytest.mark.parametrize("gs", [2, 16, 64])
def test_pack_unpack_int4_bit_equal_and_group_local(gs):
    q = np.random.default_rng(gs).integers(-8, 8, (6, 128)).astype(np.int8)
    tp = tq.pack_int4(torch.from_numpy(q), group_size=gs)
    np.testing.assert_array_equal(
        tp.numpy(), np.asarray(jq.pack_int4(jnp.asarray(q), group_size=gs)))
    np.testing.assert_array_equal(
        tq.unpack_int4(tp, group_size=gs).numpy(), q)
    # byte j of group g: value j low, value j + gs/2 high, both +8
    h = gs // 2
    j = h - 1
    assert int(tp[1, h + j]) == ((int(q[1, gs + j]) + 8)
                                 | ((int(q[1, gs + h + j]) + 8) << 4))
    # a slice of whole groups is the packed form of those groups
    np.testing.assert_array_equal(
        tq.pack_int4(torch.from_numpy(q[:, gs:2 * gs]),
                     group_size=gs).numpy(), tp[:, h:2 * h].numpy())


@pytest.mark.parametrize("kind", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("lead", [(5,), (5, 1)])
def test_fused_dequant_matmul_twin_matches_jax_kernel(kind, lead):
    w = _weights(1, (128, 64))
    x = np.random.default_rng(2).standard_normal(lead + (64,)).astype(
        np.float32)
    quantizer = {"int8": (jq.quantize_weight, tq.quantize_weight, {}),
                 "fp8": (jq.quantize_weight_fp8, tq.quantize_weight_fp8, {}),
                 "int4": (jq.quantize_weight_int4, tq.quantize_weight_int4,
                          {"group_size": 16})}[kind]
    jw, js = quantizer[0](jnp.asarray(w), **quantizer[2])
    tw, ts = quantizer[1](torch.from_numpy(w), **quantizer[2])
    want = np.asarray(jq.fused_dequant_matmul(jnp.asarray(x), jw, js))
    got = tq.fused_dequant_matmul(torch.from_numpy(x), tw, ts)
    assert got.shape == lead + (128,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(),
        tq.fused_dequant_matmul_reference(torch.from_numpy(x), tw,
                                          ts).numpy())


def test_fused_dequant_matmul_keeps_x_dtype_and_refuses_autograd():
    tw, ts = tq.quantize_weight(torch.from_numpy(_weights()))
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    assert tq.fused_dequant_matmul(x.bfloat16(), tw, ts).dtype == \
        torch.bfloat16
    with pytest.raises(RuntimeError, match="no backward"):
        tq.fused_dequant_matmul(x.requires_grad_(), tw, ts)
    with pytest.raises(ValueError, match="features"):
        tq.fused_dequant_matmul(torch.zeros(3, 32), tw, ts)


def _error(fn, *a, **kw):
    with pytest.raises(ValueError) as err:
        fn(*a, **kw)
    return str(err.value)


@pytest.mark.parametrize("mode", ["int16", "bf16", "uint8"])
def test_weight_dtype_errors_match_jax(mode):
    assert _error(tq.resolve_weight_dtype, mode) == \
        _error(jq.resolve_weight_dtype, mode)


@pytest.mark.parametrize("mode,want", [
    (None, None), (False, None), (True, "int8"), ("int8", "int8"),
    ("fp8", "fp8"), ("e4m3", "fp8"), ("int4", "int4")])
def test_weight_dtype_resolution_matches_jax(mode, want):
    assert tq.resolve_weight_dtype(mode) == jq.resolve_weight_dtype(mode) \
        == want


@pytest.mark.parametrize("kv_dtype", ["int4", "bf16", "float16"])
def test_kv_dtype_errors_match_jax(kv_dtype):
    assert _error(tq.resolve_kv_dtype, kv_dtype) == \
        _error(jq.resolve_kv_dtype, kv_dtype)


def test_kv_dtype_resolution_and_qmax_match_jax():
    assert tq.resolve_kv_dtype(None) is None
    for name in ("int8", "fp8", "e4m3", torch.int8, torch.float8_e4m3fn):
        dt, qmax = tq.resolve_kv_dtype(name)
        assert qmax == jq.resolve_kv_dtype(
            name if isinstance(name, str) else str(name).split(".")[-1])[1]
        assert tq.kv_qmax(dt) == qmax and tq.is_quantized_kv(dt)
    assert not tq.is_quantized_kv(torch.bfloat16)
    assert _error(tq.kv_qmax, torch.float32) == _error(jq.kv_qmax,
                                                       jnp.float32)


@pytest.mark.parametrize("in_features,gs", [(64, 3), (64, 0), (48, 32)])
def test_int4_group_errors_match_jax(in_features, gs):
    assert _error(tq.validate_int4_group, in_features, gs) == \
        _error(jq.validate_int4_group, in_features, gs)


def test_policy_resolution_and_errors_match_jax():
    for kind in ("int8", "fp8", "int4", None):
        tp = tq.WeightPrecisionPolicy(kind, group_size=64)
        jp = jq.WeightPrecisionPolicy(kind, group_size=64)
        assert (tp.linears, tp.group_size) == (jp.linears, jp.group_size)
        for flag in (False, True):
            if kind not in (None, "int8") and flag:
                assert _error(tq.WeightPrecisionPolicy.resolve, tp, flag) \
                    == _error(jq.WeightPrecisionPolicy.resolve, jp, flag)
                continue
            t = tq.WeightPrecisionPolicy.resolve(tp, flag)
            j = jq.WeightPrecisionPolicy.resolve(jp, flag)
            assert (t is None) == (j is None)
            if t is not None:
                assert (t.linears, t.group_size) == (j.linears, j.group_size)
    assert _error(tq.WeightPrecisionPolicy, "int4", group_size=24) == \
        _error(jq.WeightPrecisionPolicy, "int4", group_size=24)


def test_kv_quantize_matches_jax():
    x = np.random.default_rng(3).standard_normal((4, 2, 8, 16)).astype(
        np.float32)
    x[1, 0] = 0.0                                # an all-zero group
    for name in ("int8", "fp8"):
        tdt, qmax = tq.resolve_kv_dtype(name)
        jdt, _ = jq.resolve_kv_dtype(name)
        tqv, tsc = tq.kv_quantize(torch.from_numpy(x), tdt, qmax,
                                  axes=(2, 3))
        jqv, jsc = jq.kv_quantize(jnp.asarray(x), jdt, qmax, axes=(2, 3))
        np.testing.assert_array_equal(_np(tqv), _np(jqv))
        np.testing.assert_array_equal(_np(tsc), _np(jsc))
        assert (tqv[1, 0].float() == 0).all()


def _state_bytes(cfg):
    model = GPTModel(cfg, device="meta")
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())


def test_weight_bytes_ratio_pins_on_the_port_state_dict():
    """The reference's pins (tests/test_quantized_weights.py) on the port's
    own GPT-2-small: int8 <= 0.55x the fp tree, int4 (+ bf16 fp leaves)
    <= 0.35x; and the block linears alone at 0.502x / 0.266x of bf16."""
    base = gpt2_small_config(dtype=torch.bfloat16)
    fp = _state_bytes(base)
    w8 = _state_bytes(dataclasses.replace(
        base, weight_policy=tq.WeightPrecisionPolicy("int8")))
    w4 = _state_bytes(dataclasses.replace(
        base, weight_policy=tq.WeightPrecisionPolicy("int4"),
        param_dtype=torch.bfloat16))
    assert w8 <= 0.55 * fp, (w8, fp)
    assert w4 <= 0.35 * fp, (w4, fp)

    def linear_bytes(policy):
        model = GPTModel(dataclasses.replace(base, weight_policy=policy),
                         device="meta")
        return sum(t.numel() * t.element_size()
                   for n, t in model.state_dict().items()
                   if n.startswith("layers.")
                   and n.endswith((".weight", ".scale"))
                   and n.split(".")[2] in ("qkv", "out_proj", "mlp_in",
                                           "mlp_out"))

    bf16 = 2 * 12 * 12 * 768 * 768
    assert linear_bytes(tq.WeightPrecisionPolicy("int8")) == \
        12 * 12 * 768 * 768 + 12 * 4 * (3 * 768 + 768 + 3072 + 768)
    assert round(linear_bytes(tq.WeightPrecisionPolicy("int8")) / bf16,
                 3) == 0.502
    assert round(linear_bytes(tq.WeightPrecisionPolicy("int4")) / bf16,
                 3) == 0.266
