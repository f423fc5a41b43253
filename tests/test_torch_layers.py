"""The port's layers (supertonic_tpu_torch.models.layers) against the JAX
package's (supertonic_tpu.models.layers), in f32 on the CPU, same params
and inputs. Tolerance 1e-5: f32 on both sides, only sum orders differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supertonic_tpu.models import layers as jL
from supertonic_tpu_torch.models import layers as tL

TOL = dict(rtol=1e-5, atol=1e-5)


def _mods(tree):
    return tL.tree_to_modules(tree, device="cpu")


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_j(v) for v in tree]
    return jnp.asarray(tree)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_linear_and_layer_norm():
    rng = np.random.default_rng(0)
    p = jL.linear_init(rng, 24, 40)
    p["b"] = rng.standard_normal(40).astype(np.float32)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    np.testing.assert_allclose(tL.linear(_mods(p), _t(x)).numpy(),
                               np.asarray(jL.linear(_j(p), jnp.asarray(x))), **TOL)
    ln = {"g": rng.standard_normal(24).astype(np.float32),
          "b": rng.standard_normal(24).astype(np.float32)}
    np.testing.assert_allclose(tL.layer_norm(_mods(ln), _t(x)).numpy(),
                               np.asarray(jL.layer_norm(_j(ln), jnp.asarray(x))), **TOL)


def test_bf16_rounding_points():
    """bf16 linear rounds the accumulator before the bias add; bf16
    layer_norm applies the affine in bf16 (exact re-derivations)."""
    rng = np.random.default_rng(1)
    p = jL.linear_init(rng, 16, 8)
    p["b"] = rng.standard_normal(8).astype(np.float32)
    x = _t(rng.standard_normal((3, 16))).to(torch.bfloat16)
    m = tL.tree_to_modules(p, device="cpu", dtype=torch.bfloat16)
    want = (x.float() @ m.weight.float().t()).to(torch.bfloat16) + m.bias.to(torch.bfloat16)
    torch.testing.assert_close(tL.linear(m, x), want, rtol=0, atol=0)
    ln = _mods({"g": rng.standard_normal(16).astype(np.float32),
                "b": rng.standard_normal(16).astype(np.float32)})
    y = tL.layer_norm(ln, x)
    assert y.dtype == torch.bfloat16
    xf = x.float()
    norm = ((xf - xf.mean(-1, keepdim=True))
            * torch.rsqrt(xf.var(-1, unbiased=False, keepdim=True) + 1e-5))
    want = norm.to(torch.bfloat16) * ln.g.to(torch.bfloat16) + ln.b.to(torch.bfloat16)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_conv1d_same_padding(dilation):
    rng = np.random.default_rng(dilation)
    p = jL.conv1d_init(rng, 12, 20, 3)
    p["b"] = rng.standard_normal(20).astype(np.float32)
    x = rng.standard_normal((2, 30, 12)).astype(np.float32)
    np.testing.assert_allclose(
        tL.conv1d(_mods(p), _t(x), dilation=dilation).numpy(),
        np.asarray(jL.conv1d(_j(p), jnp.asarray(x), dilation=dilation)), **TOL)


def test_conv1d_even_kernel_and_k5():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 17, 6)).astype(np.float32)
    for k in (4, 5):
        p = jL.conv1d_init(rng, 6, 5, k)
        np.testing.assert_allclose(
            tL.conv1d(_mods(p), _t(x)).numpy(),
            np.asarray(jL.conv1d(_j(p), jnp.asarray(x))), **TOL)


def test_rope_larope_and_time_embedding():
    rng = np.random.default_rng(5)
    lengths = np.array([7.0, 12.0], np.float32)
    pos_j = jL.larope_positions(jnp.asarray(lengths), 12, 1024.0)
    pos_t = tL.larope_positions(_t(lengths), 12, 1024.0)
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), **TOL)
    cos_j, sin_j = jL.rope_angles(pos_j, 16, 10000.0)
    cos_t, sin_t = tL.rope_angles(pos_t, 16, 10000.0)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), **TOL)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), **TOL)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tL.apply_rope(_t(x), cos_t, sin_t).numpy(),
        np.asarray(jL.apply_rope(jnp.asarray(x), cos_j, sin_j)), **TOL)
    t = np.array([0.0, 0.4], np.float32)
    np.testing.assert_allclose(
        tL.sinusoidal_embedding(_t(t), 32).numpy(),
        np.asarray(jL.sinusoidal_embedding(jnp.asarray(t), 32)), **TOL)


def test_init_helpers_draw_like_jax():
    for seed in (0, 1):
        a = jL.block_init(np.random.default_rng(seed), 16, 4, cross_dim=16,
                          adaln=True, cond_dim=8)
        b = tL.block_init(np.random.default_rng(seed), 16, 4, cross_dim=16,
                          adaln=True, cond_dim=8)
        fa = _flat(a)
        fb = _flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    else:
        out[prefix] = np.asarray(tree)
    return out


@pytest.mark.parametrize("adaln", [False, True])
def test_block(adaln):
    """A pre-LN block with self- and cross-attention; with AdaLN the FFN
    sublayer goes through the fused AdaLN-FFN wrapper in the port."""
    rng = np.random.default_rng(6)
    dim, heads = 32, 2
    p = jL.block_init(rng, dim, 4, cross_dim=dim, adaln=adaln, cond_dim=16)
    if adaln:  # zero-init would make every gate 0
        p["adaln"]["w"] = (rng.standard_normal(p["adaln"]["w"].shape) * 0.3).astype(np.float32)
    b, t, tm = 2, 10, 6
    x = rng.standard_normal((b, t, dim)).astype(np.float32)
    mem = rng.standard_normal((b, tm, dim)).astype(np.float32)
    self_mask = (np.arange(t)[None] < np.array([[t], [t - 3]])).astype(np.float32)
    mem_mask = (np.arange(tm)[None] < np.array([[tm], [tm - 2]])).astype(np.float32)
    cond = rng.standard_normal((b, 16)).astype(np.float32) if adaln else None
    pos = np.tile(np.arange(t, dtype=np.float32), (b, 1))
    rope_j = jL.rope_angles(jnp.asarray(pos), dim // heads, 10000.0)
    rope_t = tL.rope_angles(_t(pos), dim // heads, 10000.0)
    ref = jL.block(_j(p), jnp.asarray(x), heads, self_mask=jnp.asarray(self_mask),
                   self_rope=rope_j, memory=jnp.asarray(mem),
                   memory_mask=jnp.asarray(mem_mask),
                   cond=None if cond is None else jnp.asarray(cond))
    got = tL.block(_mods(p), _t(x), heads, self_mask=_t(self_mask),
                   self_rope=rope_t, memory=_t(mem), memory_mask=_t(mem_mask),
                   cond=None if cond is None else _t(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
