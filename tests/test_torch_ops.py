"""The port's kernel modules (supertonic_tpu_torch/ops) against the JAX
package's Pallas kernels, run on the CPU as the JAX tests run them (in
interpret mode). On CPU tensors each wrapper runs its kernel's plain
PyTorch version; the CUDA kernels themselves are held against those plain
versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from supertonic_tpu.models import layers as jL
from supertonic_tpu.models import vocoder as jvocoder
from supertonic_tpu.ops import fused_attention_interpret
from supertonic_tpu.ops import vocoder_fused as jvf
from supertonic_tpu.ops.ffn import fused_adaln_ffn as j_fused_adaln_ffn
from supertonic_tpu_torch import ops
from supertonic_tpu_torch.models import layers as tL
from supertonic_tpu_torch.ops import attention, ffn, vocoder_fused


def _qkv(b=2, h=2, tq=16, tk=24, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32)
               for t in (tq, tk, tk))
    mask = (np.arange(tk)[None, :] < rng.integers(4, tk + 1, (b, 1))).astype(np.float32)
    return q, k, v, mask


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("masked", [True, False])
def test_attention_matches_pallas(masked):
    # rtol = atol = 1e-5: f32 on both sides, only the sum order differs
    q, k, v, mask = _qkv(seed=1 if masked else 2)
    m = mask if masked else None
    ref = fused_attention_interpret(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    None if m is None else jnp.asarray(m))
    got = attention.fused_attention(_t(q), _t(k), _t(v), None if m is None else _t(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_attention_fully_masked_row_is_mean_of_v():
    q, k, v, _ = _qkv(seed=3)
    mask = np.zeros((q.shape[0], k.shape[1]), np.float32)
    ref = fused_attention_interpret(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(mask))
    got = attention.fused_attention(_t(q), _t(k), _t(v), _t(mask)).numpy()
    assert np.isfinite(got).all()
    mean_v = np.broadcast_to(v.mean(axis=1, keepdims=True), got.shape)
    np.testing.assert_allclose(got, mean_v, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_attention_bf16_matches_pallas():
    # 2e-2: bf16 inputs and outputs, probabilities rounded to bf16
    q, k, v, mask = _qkv(seed=4)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = fused_attention_interpret(qb, kb, vb, jnp.asarray(mask))
    got = attention.fused_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                    _t(v, torch.bfloat16), _t(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("tq,tk,masked", [(65, 70, True), (320, 50, False), (1, 1, True),
                                           (1, 1, False), (9, 1, True), (63, 65, True),
                                           (64, 64, False), (129, 127, True), (70, 5, True),
                                           (129, 100, False)])
def test_attention_bf16_dh64_matches_pallas(tq, tk, masked):
    """The port's plain version, which the card holds the kernel to, against
    the Pallas kernel at Dh = 64 (the kernel's head width): a path shape
    (Tq 320, Tk 50 unmasked, TE/DP cross) and the kernel's tile edges, the
    shapes chip_smoke.py holds the kernel to: Tq and Tk at 64 (queries a
    consumer warpgroup, keys a stage) and 128 plus or minus one, a single
    key (masked away, the row is the mean of v), fewer keys than one wgmma
    N step of 8, and a second key stage that crosses Tk without a mask.
    2e-2: bf16 in and out, probabilities rounded to bf16 on both sides."""
    rng = np.random.default_rng(tq * 1000 + tk)
    q, k, v = (rng.standard_normal((2, t, 2, 64)).astype(np.float32) for t in (tq, tk, tk))
    mask = None
    if masked:
        lens = rng.integers(max(1, tk // 2), tk + 1, (2, 1))
        mask = (np.arange(tk)[None, :] < lens).astype(np.float32)
        if tk == 1:
            mask[0] = 0.0
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = fused_attention_interpret(qb, kb, vb, None if mask is None else jnp.asarray(mask))
    got = attention.fused_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                    _t(v, torch.bfloat16), None if mask is None else _t(mask))
    assert got.dtype == torch.bfloat16 and got.shape == (2, tq, 2, 64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_attention_wrapper_rejects_bad_shapes():
    q, k, v, mask = _qkv()
    with pytest.raises(ValueError):
        attention.fused_attention(_t(q), _t(k), _t(v)[:, :-1], _t(mask))
    with pytest.raises(ValueError):
        attention.fused_attention(_t(q), _t(k), _t(v), _t(mask)[:, :-1])


def test_adaln_ffn_matches_pallas():
    # 1e-5: f32 on both sides, the products' sum order differs
    rng = np.random.default_rng(5)
    b, t, d, f = 2, 12, 32, 128
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bl = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(f)).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    shift, scale, gate = (rng.standard_normal((b, 1, d)).astype(np.float32)
                          for _ in range(3))
    ref = j_fused_adaln_ffn(*(jnp.asarray(a) for a in
                              (x, g, bl, w1, b1, w2, b2, shift, scale, gate)),
                            interpret=True)
    # the port takes torch's linear layout: w1 [F, D], w2 [D, F]
    got = ffn.fused_adaln_ffn(_t(x), _t(g), _t(bl), _t(w1.T).contiguous(), _t(b1),
                              _t(w2.T).contiguous(), _t(b2), _t(shift), _t(scale),
                              _t(gate))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_adaln_ffn_bf16_matches_pallas():
    """The plain version, which the card holds the bf16 kernel to, against
    the Pallas kernel in bf16 at a row count that leaves the kernel's
    128-row GEMM tiles and its LayerNorm pass ragged (B 3 x T 37). 2e-2:
    bf16 in and out, h and the intermediate rounded to bf16 on both sides."""
    rng = np.random.default_rng(6)
    b, t, d, f = 3, 37, 128, 256
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bl = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(f)).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    shift, scale, gate = ((0.5 * rng.standard_normal((b, 1, d))).astype(np.float32)
                          for _ in range(3))
    bf = jnp.bfloat16
    ref = j_fused_adaln_ffn(jnp.asarray(x, bf), jnp.asarray(g), jnp.asarray(bl),
                            jnp.asarray(w1, bf), jnp.asarray(b1), jnp.asarray(w2, bf),
                            jnp.asarray(b2), *(jnp.asarray(m, bf) for m in (shift, scale, gate)),
                            interpret=True)
    tb = torch.bfloat16
    got = ffn.fused_adaln_ffn(_t(x, tb), _t(g), _t(bl), _t(w1.T, tb).contiguous(), _t(b1),
                              _t(w2.T, tb).contiguous(), _t(b2), _t(shift, tb), _t(scale, tb),
                              _t(gate, tb))
    assert got.dtype == tb and got.shape == (b, t, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("b,t", [(2, 21), (5, 100)])
def test_adaln_ffn_bf16_tile_edges_match_pallas(b, t):
    """The plain version against the Pallas kernel in bf16 at the GEMM
    tiles' edges that chip_smoke.py holds the kernel to: fewer rows than one
    64-row tile (B 2 x T 21), and tiles whose rows span several batch rows,
    each with its own gate (B 5 x T 100). 2e-2 as above."""
    rng = np.random.default_rng(7 + t)
    d, f = 128, 256
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bl = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(f)).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    shift, scale, gate = ((0.5 * rng.standard_normal((b, 1, d))).astype(np.float32)
                          for _ in range(3))
    bf = jnp.bfloat16
    ref = j_fused_adaln_ffn(jnp.asarray(x, bf), jnp.asarray(g), jnp.asarray(bl),
                            jnp.asarray(w1, bf), jnp.asarray(b1), jnp.asarray(w2, bf),
                            jnp.asarray(b2), *(jnp.asarray(m, bf) for m in (shift, scale, gate)),
                            interpret=True)
    tb = torch.bfloat16
    got = ffn.fused_adaln_ffn(_t(x, tb), _t(g), _t(bl), _t(w1.T, tb).contiguous(), _t(b1),
                              _t(w2.T, tb).contiguous(), _t(b2), _t(shift, tb), _t(scale, tb),
                              _t(gate, tb))
    assert got.dtype == tb and got.shape == (b, t, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


def _chain_params(rng, c, dils, k=3):
    return {"convs": [{"a": jL.conv1d_init(rng, c, c, k),
                       "b": jL.conv1d_init(rng, c, c, k)} for _ in dils]}


@pytest.mark.parametrize("c,t,b", [(128, 96, 2), (256, 160, 1)])
def test_resblock_chain_matches_pallas_and_xla(c, t, b):
    # 2e-6: the bound the JAX package's own fused-vs-XLA test uses
    rng = np.random.default_rng(0)
    dils = (1, 3, 9)
    p = _chain_params(rng, c, dils)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    mask = np.ones((1, t, 1), np.float32)
    mask[0, -9:, 0] = 0.0
    jp = {"convs": [{k: {n: jnp.asarray(a) for n, a in cp[k].items()} for k in cp}
                    for cp in p["convs"]]}
    xla = np.asarray(jvocoder._resblock(jp, jnp.asarray(x), dils, jnp.asarray(mask)))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jvf.fused_resblock(jp, jnp.asarray(x), dils,
                                               jnp.asarray(mask)))
    mods = tL.tree_to_modules(p, device="cpu")
    got = vocoder_fused.fused_resblock(mods, _t(x), dils, _t(mask)).numpy()
    np.testing.assert_allclose(got, pallas, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, xla, rtol=2e-6, atol=2e-6)
    # masked tail frames: exact zeros from the convs, so x passes unchanged
    np.testing.assert_array_equal(got[:, -1], x[:, -1])


@pytest.mark.parametrize("k,dils", [(11, (1, 3, 5)), (7, (1, 3, 9)), (3, (27,))],
                         ids=["k11-d1,3,5", "k7-d1,3,9", "k3-d27"])
def test_resblock_chain_far_reach_matches_pallas_and_xla(k, dils):
    """Chains whose pairs reach past the fused kernels' MAX_PAIR_REACH in f32
    (30, 30 and 28 frames; the per-conv launches on the card where no fused
    tile holds them): the plain version the card holds them to, against the
    Pallas kernel in interpret mode and XLA's convs. 2e-6, as above."""
    rng = np.random.default_rng(k * 100 + dils[-1])
    c, t, b = 64, 150, 2
    assert max(vocoder_fused.pair_reach(k, d) for d in dils) > vocoder_fused.MAX_PAIR_REACH[
        torch.float32]
    p = _chain_params(rng, c, dils, k)
    for cp in p["convs"]:  # nonzero biases: conv1d_init leaves them at 0
        for key in ("a", "b"):
            cp[key]["b"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    mask = np.ones((1, t, 1), np.float32)
    mask[0, -13:, 0] = 0.0
    jp = {"convs": [{k_: {n: jnp.asarray(a) for n, a in cp[k_].items()} for k_ in cp}
                    for cp in p["convs"]]}
    xla = np.asarray(jvocoder._resblock(jp, jnp.asarray(x), dils, jnp.asarray(mask)))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jvf.fused_resblock(jp, jnp.asarray(x), dils, jnp.asarray(mask)))
    mods = tL.tree_to_modules(p, device="cpu")
    got = vocoder_fused.fused_resblock(mods, _t(x), dils, _t(mask)).numpy()
    np.testing.assert_allclose(got, pallas, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, xla, rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(got[:, -1], x[:, -1])


def _chain_by_tiles(x, fm, wa, ba, wb, bb, dils, tile):
    """The kernel's tiling, in plain torch: each block sees tile + 2*halo
    frames, zero outside [0, T), and keeps only its central tile."""
    halo = vocoder_fused.chain_halo(3, dils)
    t_len = x.shape[1]
    out = torch.empty_like(x)
    for t0 in range(0, t_len, tile):
        lo, hi = t0 - halo, t0 + tile + halo
        idx = torch.arange(lo, hi)
        inside = (idx >= 0) & (idx < t_len)
        xw = torch.zeros((x.shape[0], hi - lo, x.shape[2]))
        xw[:, inside] = x[:, idx[inside]]
        mw = torch.zeros(hi - lo)
        mw[inside] = fm[idx[inside]]
        yw = vocoder_fused.resblock_chain_plain(xw, mw, wa, ba, wb, bb, dils)
        n = min(tile, t_len - t0)
        out[:, t0:t0 + n] = yw[:, halo:halo + n]
    return out


# Tile widths (output frames per block) the CUDA kernel picks for dilations
# (1, 3, 9), halo 16, from the layouts in csrc/resblock_chain.cu: the bf16
# tensor-core kernel's blocks hold W0 = 256 frames at C 64 and 128, 128 at
# C 192 and 256 and 64 at C 320 and 384 (tiles 224, 96 and 32), and at a
# grid too small to fill the card W0 / 2 (C <= 256: tiles 96 and 32); the
# f32 blocks hold the largest multiple of 16 frames whose three f32 buffers
# (two with pad rows) fit 224 KB, W = 128 and 64 (tiles 96 and 32). Tile
# 160 at C 64 is an extra width, a tile no instance takes.
@pytest.mark.parametrize("c,tiles", [(128, (7, 96, 224)), (256, (7, 32, 96)),
                                     (64, (32, 96, 160, 224)), (384, (32,))])
def test_resblock_chain_tiles_are_seam_free(c, tiles):
    """Multi-tile output equals single-tile output: the halo argument of
    the kernel's design, at the kernel's own tile widths at this C and at a
    few frames (chip_smoke.py checks the kernel's tiling on the card)."""
    rng = np.random.default_rng(1)
    dils = (1, 3, 9)
    assert vocoder_fused.chain_halo(3, dils) == 16
    mods = tL.tree_to_modules(_chain_params(rng, c, dils), device="cpu")
    wa, ba, wb, bb = vocoder_fused.stack_resblock(mods, torch.float32)
    t_len = 300
    x = _t(rng.standard_normal((1, t_len, c)))
    fm = torch.ones(t_len)
    fm[-20:] = 0.0
    one = vocoder_fused.resblock_chain_plain(x, fm, wa, ba, wb, bb, dils)
    for tile in tiles:
        tiled = _chain_by_tiles(x, fm, wa, ba, wb, bb, dils, tile)
        np.testing.assert_allclose(tiled.numpy(), one.numpy(), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dh", [144, 192, 256, 320])
def test_attention_wide_heads_match_pallas(dh, dtype):
    """Head widths past 128 (the bf16 kernel's three- and four-panel
    instances, and past 256 its slices of the output columns): the plain
    version against the Pallas kernel, f32 1e-5 (only the sum order
    differs) and bf16 2e-2 (bf16 in and out, probabilities rounded to bf16
    on both sides)."""
    rng = np.random.default_rng(dh + (dtype == "bf16"))
    q, k, v = (rng.standard_normal((2, t, 2, dh)).astype(np.float32) for t in (37, 53, 53))
    mask = (np.arange(53)[None, :] < np.array([[53], [20]])).astype(np.float32)
    if dtype == "f32":
        ref = fused_attention_interpret(*(jnp.asarray(a) for a in (q, k, v, mask)))
        got = attention.fused_attention(_t(q), _t(k), _t(v), _t(mask))
        tol = 1e-5
    else:
        qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        ref = fused_attention_interpret(qb, kb, vb, jnp.asarray(mask))
        got = attention.fused_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)), _t(mask))
        assert got.dtype == torch.bfloat16
        tol = 2e-2
    assert attention.supports(dh, 53) and got.shape == (2, 37, 2, dh)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def test_launch_counters_do_not_move_on_cpu():
    ops.reset_launch_counts()
    q, k, v, mask = _qkv()
    attention.fused_attention(_t(q), _t(k), _t(v), _t(mask))
    x = torch.ones((2, 3, 8))
    half = torch.ones((2, 3, 2))
    ops.ln_modulate.ln_modulate(x, torch.ones(8), torch.zeros(8), x[:, :1], x[:, :1])
    ops.rope.bias_rope(x, torch.zeros(8), half, half, 2)
    ops.gated_residual.gated_residual(x, x, torch.zeros(8), x[:, :1])
    ops.conv1d.conv1d_fused(x, torch.ones((3, 8, 8)), torch.zeros(8), silu_in=True,
                            mask=torch.ones(3), residual=x)
    ops.linear.linear(x.bfloat16(), torch.ones((8, 8), dtype=torch.bfloat16), torch.zeros(8),
                      silu=True)
    assert ops.launch_counts() == {"attention": 0, "adaln_ffn": 0,
                                   "resblock_chain": 0, "int8_matmul": 0,
                                   "w8a8_matmul": 0, "quantize": 0, "ln_modulate": 0,
                                   "bias_rope": 0, "gated_residual": 0, "conv1d": 0,
                                   "linear": 0}
