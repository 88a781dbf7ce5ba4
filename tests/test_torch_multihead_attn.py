"""Port parity: ``contrib.multihead_attn`` in apex_tpu_torch against
apex_tpu.

Each case builds the reference's flax module (``SelfMultiheadAttn`` or
``EncdecMultiheadAttn``, E = 32 over 4 heads, seq 8 (the cross
attention's keys 12), batch 2, fp32), bridges its variables into the
port's module through ``bridge.multihead_attn_params_from_flax`` and runs
the same numpy inputs through both, ``impl`` "fast" (JAX: its flash kernel
in interpret mode; the port: the flash twins) and "default" (the unfused
ground truth on both sides). Outputs within atol 2e-5 / rtol 2e-5; the
gradients of ``sum(out ** 2)`` in the input and every parameter within
atol 5e-5 / rtol 5e-4 (the reference suite's bars,
``tests/test_multihead_attn.py:37,42``). Covered: ``bias``,
``include_norm_add``, ``separate_qkv_params``, a bool key-padding mask, an
additive ``attn_mask`` and both masks together. Dropout: the fast core
against JAX's ``attention_core`` on a stub module whose ``make_rng``
returns a fixed key, the port handed the seed that key draws, so both
draw the same keep mask; the default core's dropout differs between seeds
and eval is deterministic. Then the reference's errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.multihead_attn import (
    EncdecMultiheadAttn as JaxEncdec, SelfMultiheadAttn as JaxSelf)
from apex_tpu.contrib.multihead_attn import _core as jax_core
from apex_tpu_torch.bridge import multihead_attn_params_from_flax
from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                   SelfMultiheadAttn)
from apex_tpu_torch.contrib.multihead_attn import _core

E, H, S, SK, B = 32, 4, 8, 12, 2
OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _masks(kind, sq, sk, additive):
    """(key_padding_mask, attn_mask) as numpy: the last 3 keys of batch 1
    padded; an attn_mask that hides key j from row i when j > i + 2."""
    pad = am = None
    if kind in ("pad", "both"):
        pad = np.zeros((B, sk), bool)
        pad[1, -3:] = True
    if kind in ("attn", "both"):
        am = np.arange(sk)[None, :] > np.arange(sq)[:, None] + 2
    if additive:
        pad = None if pad is None else np.where(pad, -1e9, 0.0).astype(
            np.float32)
        am = None if am is None else np.where(am, -1e9, 0.0).astype(
            np.float32)
    return pad, am


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _check(jax_mod, port_mod, args, kw):
    """Forward and the gradients of sum(out ** 2) on both sides; ``args``
    is ``[query]``, or ``[query, memory]`` for the cross attention (its
    key and value)."""
    if len(args) == 2:
        args = [*args, args[1]]
    mem = [jnp.asarray(args[1])] * 2 if len(args) == 3 else []
    variables = jax_mod.init(jax.random.PRNGKey(0), jnp.asarray(args[0]),
                             *mem, is_training=False, **kw)
    port_mod.load_state_dict(multihead_attn_params_from_flax(
        jax.tree.map(np.asarray, variables)))
    jkw = {k: None if v is None else jnp.asarray(v) for k, v in kw.items()}

    def jloss(p, x):
        xs = [x] + [jnp.asarray(a) for a in args[1:]]
        if len(args) == 3:      # the cross attention: key is value
            xs[2] = xs[1]
        out = jax_mod.apply({"params": p}, *xs, is_training=False, **jkw)[0]
        return (out ** 2).sum(), out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(args[0]))
    x = torch.from_numpy(args[0]).requires_grad_()
    rest = [torch.from_numpy(a) for a in args[1:]]
    if len(args) == 3:
        rest[1] = rest[0]
    out = port_mod(x, *rest, is_training=False,
                   **{k: _t(v) for k, v in kw.items()})[0]
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **OUT_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    want = multihead_attn_params_from_flax(jax.tree.map(np.asarray, jgp))
    got = dict(port_mod.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("impl", ["fast", "default"])
@pytest.mark.parametrize("bias,include_norm_add,separate_qkv_params",
                         [(False, False, False), (True, False, False),
                          (False, True, True), (True, True, True)])
def test_self_attention_matches_jax(impl, bias, include_norm_add,
                                    separate_qkv_params):
    kw = dict(bias=bias, include_norm_add=include_norm_add,
              separate_qkv_params=separate_qkv_params, impl=impl)
    _check(JaxSelf(E, H, **kw), SelfMultiheadAttn(E, H, **kw, device="cpu"),
           _inputs(1, (S, B, E)), {})


@pytest.mark.parametrize("impl", ["fast", "default"])
@pytest.mark.parametrize("masks", ["pad", "attn", "both", "both_additive"])
def test_self_attention_masks_match_jax(impl, masks):
    additive = masks.endswith("additive")
    pad, am = _masks(masks.split("_")[0], S, S, additive)
    kw = dict(include_norm_add=True, mask_additive=additive, impl=impl)
    _check(JaxSelf(E, H, **kw), SelfMultiheadAttn(E, H, **kw, device="cpu"),
           _inputs(2, (S, B, E)), dict(key_padding_mask=pad, attn_mask=am))


@pytest.mark.parametrize("impl", ["fast", "default"])
@pytest.mark.parametrize("include_norm_add,masks",
                         [(False, "none"), (True, "none"), (True, "pad"),
                          (False, "both")])
def test_encdec_attention_matches_jax(impl, include_norm_add, masks):
    pad, am = _masks(masks, S, SK, False)
    kw = dict(include_norm_add=include_norm_add, impl=impl)
    _check(JaxEncdec(E, H, **kw),
           EncdecMultiheadAttn(E, H, **kw, device="cpu"),
           _inputs(3, (S, B, E), (SK, B, E)),
           dict(key_padding_mask=pad, attn_mask=am))


class _Stub:
    """The module ``attention_core`` draws its dropout key from."""

    def __init__(self, key):
        self.key = key

    def make_rng(self, name):
        assert name == "dropout"
        return self.key


@pytest.mark.parametrize("masks", ["none", "both"])
def test_fast_core_dropout_matches_jax(masks):
    key = jax.random.PRNGKey(7)
    seed = int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max))
    q, k, v = _inputs(4, (B, H, S, 8), (B, H, SK, 8), (B, H, SK, 8))
    pad, am = _masks(masks, S, SK, False)
    jbias = jax_core.masks_to_bias(
        None if pad is None else jnp.asarray(pad),
        None if am is None else jnp.asarray(am), False)

    def jfn(q, k, v):
        return jax_core.attention_core(_Stub(key), q, 8, k, v, jbias, 0.1,
                                       "fast")

    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.ones_like(jout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    bias = _core.masks_to_bias(_t(pad), _t(am), False)
    out = _core.attention_core(tq, 8, tk, tv, bias, 0.1, "fast", seed=seed)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **OUT_TOL)
    for got, want in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)
    # a tenth of the probabilities dropped: not the undropped output
    plain = _core.attention_core(tq, 8, tk, tv, bias, 0.0, "fast")
    assert not torch.allclose(out, plain)


def test_default_dropout_differs_by_seed_and_eval_is_deterministic():
    x = torch.from_numpy(_inputs(5, (16, B, 64))[0])
    outs = []
    for seed in (1, 2):
        m = SelfMultiheadAttn(64, 4, dropout=0.5, impl="default",
                              device="cpu", dropout_generator=torch.Generator(
                                  ).manual_seed(seed))
        outs.append(m(x, is_training=True)[0])
    assert not torch.equal(outs[0], outs[1])
    o3, o4 = (m(x, is_training=False)[0] for _ in range(2))
    assert torch.equal(o3, o4)
    plain = SelfMultiheadAttn(64, 4, impl="default", device="cpu")
    torch.testing.assert_close(o3, plain(x, is_training=False)[0], atol=0,
                               rtol=0)


def test_fast_dropout_draws_its_seed_from_the_generator():
    """Two modules on generators of one seed draw the same keep masks; a
    third, on another seed, others."""
    x = torch.from_numpy(_inputs(6, (S, B, E))[0])
    outs = [SelfMultiheadAttn(E, H, dropout=0.3, device="cpu",
                              dropout_generator=torch.Generator()
                              .manual_seed(s))(x)[0] for s in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_the_reference_errors():
    with pytest.raises(ValueError):
        EncdecMultiheadAttn(E, H, bias=True, device="cpu")
    x, kv, other = (torch.zeros(4, 1, E) for _ in range(3))
    enc = EncdecMultiheadAttn(E, H, device="cpu")
    with pytest.raises(ValueError):
        enc(x, kv, other)
    assert enc(x, kv, kv)[1] is None and enc(x, kv, None)[0].shape == x.shape
    with pytest.raises(NotImplementedError):
        enc(x, kv, kv, need_weights=True)
    with pytest.raises(NotImplementedError):
        SelfMultiheadAttn(E, H, device="cpu")(x, need_weights=True)
    with pytest.raises(ValueError):
        SelfMultiheadAttn(E, 5, device="cpu")


def test_bridge_refuses_an_extra_or_a_missing_leaf():
    m = JaxSelf(E, H, include_norm_add=True)
    x = jnp.zeros((S, B, E))
    tree = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0), x,
                                           is_training=False))["params"]
    sd = multihead_attn_params_from_flax(tree)
    assert set(sd) == set(dict(SelfMultiheadAttn(
        E, H, include_norm_add=True, device="cpu").named_parameters()))
    with pytest.raises(KeyError):
        multihead_attn_params_from_flax(dict(tree, stray=np.zeros(3)))
    for leaf in ("out_proj_weight", "lyr_nrm_beta_weights"):
        with pytest.raises(KeyError):
            multihead_attn_params_from_flax(
                {k: v for k, v in tree.items() if k != leaf})
