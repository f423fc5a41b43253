"""The conv kernel's plain version (ops/conv1d.py) against the JAX
package's ``layers.conv1d`` composed as the JAX vocoder and text encoder
compose it, in f32 on the CPU (1e-5 relative: only the sum order differs);
in bf16 bit for bit against the unfused PyTorch sequence at the JAX
rounding points; the port's vocoder and text encoder, which route every
conv through it, against the JAX ones; bucket padding and windows; the
kernel's domain and the wrapper's refusals. Inputs from numpy seeds, tiny
shapes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from supertonic_tpu.models import layers as jL
from supertonic_tpu.models import text_encoder as jte
from supertonic_tpu.models import vocoder as jvoc
from supertonic_tpu_torch.config import TTSConfig
from supertonic_tpu_torch.engine import synthesis
from supertonic_tpu_torch.models import init_all, load_params
from supertonic_tpu_torch.models import layers as tL
from supertonic_tpu_torch.models import text_encoder as tte
from supertonic_tpu_torch.models import vocoder as tvoc
from supertonic_tpu_torch.ops import conv1d, vocoder_fused

# option sets as the port's call sites use them
SITES = ("plain", "pre: mask", "resblock a: silu_in, row mask",
         "resblock b: silu_in, mask, residual", "prenet: silu_out, row mask, residual",
         "up: silu_in, fold 2, mask", "head: silu_in, tanh")


def _case(site, b, t, cin, cout, k, seed):
    """numpy x, w (HIO), bias, and the site's options (mask, residual as
    numpy arrays)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, cin)).astype(np.float32)
    w = (rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(cout)).astype(np.float32)
    fold = 2 if site.startswith("up") else 1
    mask = None
    if "row mask" in site:
        mask = (np.arange(t * fold)[None] < np.array([[t * fold], [t * fold - 5]])[:b]
                ).astype(np.float32)
    elif "mask" in site:
        mask = (np.arange(t * fold) < t * fold - 3).astype(np.float32)
    kw = dict(silu_in="silu_in" in site, silu_out="silu_out" in site, fold=fold,
              tanh_f32="tanh" in site)
    residual = None
    if "residual" in site:
        residual = (x if cin == cout else rng.standard_normal((b, t, cout)).astype(np.float32))
    return x, w, bias, mask, residual, kw


def _jax(x, w, bias, d, mask, residual, silu_in, silu_out, fold, tanh_f32):
    """The JAX package's conv1d with its callers' ops around it."""
    p = {"w": jnp.asarray(w), "b": jnp.asarray(bias)}
    xj = jnp.asarray(x)
    y = jL.conv1d(p, jax.nn.silu(xj) if silu_in else xj, dilation=d)
    if silu_out:
        y = jax.nn.silu(y)
    if mask is not None:
        b, t, c = y.shape
        m = jnp.asarray(mask).reshape(-1, t * fold, 1)
        y = (y.reshape(b, t * fold, c // fold) * m).reshape(b, t, c)
    if residual is not None:
        y = jnp.asarray(residual) + y
    return np.asarray(jnp.tanh(y) if tanh_f32 else y)


def _opt(mask, residual, dtype=torch.float32):
    return dict(mask=None if mask is None else torch.from_numpy(mask),
                residual=None if residual is None else torch.from_numpy(residual).to(dtype))


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("k,d", [(3, 1), (3, 3), (3, 9), (5, 1), (7, 1), (7, 9), (4, 1), (4, 3),
                                 (11, 9)])
def test_plain_matches_jax_composition(site, k, d):
    """Every option at k 3/4/5/7/11 and d 1/3/9 (the resblocks' dilations;
    an even size pads one frame less on the left than on the right, as
    JAX's SAME does; k 11 at d 9 reaches 90 frames), T shorter than the
    conv's reach at d 9, f32: 1e-5 relative."""
    b, t, cin = 2, 11, 16
    cout = 24 if site.startswith(("up", "head")) else cin
    x, w, bias, mask, residual, kw = _case(site, b, t, cin, cout, k, seed=k * 10 + d)
    want = _jax(x, w, bias, d, mask, residual, **kw)
    got = conv1d.conv1d_fused(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                              dilation=d, **kw, **_opt(mask, residual))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=conv1d.F32_RTOL, atol=1e-6)


@pytest.mark.parametrize("site", SITES)
def test_bf16_plain_is_the_unfused_sequence(site):
    """In bf16, bit for bit the unfused PyTorch ops at the JAX rounding
    points: silu in f32 rounded once, the conv summed in f32 with the f32
    bias before one rounding, silu rounded again, the mask and the residual
    in bf16, tanh in f32."""
    b, t, cin, k, d = 2, 13, 16, 5, 3
    cout = 32 if site.startswith(("up", "head")) else cin
    x, w, bias, mask, residual, kw = _case(site, b, t, cin, cout, k, seed=7)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = conv1d.conv1d_fused(xb, wb, torch.from_numpy(bias), dilation=d, **kw,
                              **_opt(mask, residual, torch.bfloat16))

    s = vocoder_fused._silu_rounded(xb) if kw["silu_in"] else xb
    pad = d * (k - 1) // 2
    y = F.conv1d(s.float().transpose(1, 2), wb.float().permute(2, 1, 0), padding=pad,
                 dilation=d).transpose(1, 2)
    y = (y + torch.from_numpy(bias)).to(torch.bfloat16)
    if kw["silu_out"]:
        y = vocoder_fused._silu_rounded(y)
    if mask is not None:
        f = kw["fold"]
        m = torch.from_numpy(mask).reshape(-1, t * f, 1).to(torch.bfloat16)
        y = (y.reshape(b, t * f, cout // f) * m).reshape(b, t, cout)
    if residual is not None:
        y = torch.from_numpy(residual).bfloat16() + y
    want = torch.tanh(y.float()) if kw["tanh_f32"] else y
    assert got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the card's tolerance holds the plain version to itself
    share, ok = conv1d.bf16_within(got, xb, wb, torch.from_numpy(bias), dilation=d, **kw,
                                   **_opt(mask, residual, torch.bfloat16))
    assert share == 1.0 and ok


def _nets(cfg):
    params = init_all(0, cfg)
    rng = np.random.default_rng(3)
    for net in ("vocoder", "text_encoder"):  # nonzero conv biases (init leaves them at 0)
        for leaf in jax.tree_util.tree_leaves_with_path(params[net]):
            path, arr = leaf
            if jax.tree_util.keystr(path).endswith("['b']") and arr.ndim == 1:
                arr[...] = 0.1 * rng.standard_normal(arr.shape)
    return params, load_params(params, device="cpu")


@pytest.fixture(scope="module")
def nets(tiny_config):
    return _nets(tiny_config)


def _odd_config(tiny):
    """The tiny config at widths off every multiple of 8 and at even and
    wide conv sizes: latent 5 x 3 = 15 channels into the pre conv, a head
    of 15 channels, vocoder channels (36, 20) (up 1's masked fold: 36
    channels a fine frame), resblock size 11 at dilations (1, 3, 5)
    (reaching 50 frames), stage size 4 (even)."""
    return dataclasses.replace(
        tiny, ae=dataclasses.replace(tiny.ae, base_chunk_size=80),
        ttl=dataclasses.replace(tiny.ttl, latent_dim=5, chunk_compress_factor=3),
        dp=dataclasses.replace(tiny.dp, latent_dim=5, chunk_compress_factor=3),
        vocoder=dataclasses.replace(tiny.vocoder, channels=(36, 20), resblock_kernel=11,
                                    resblock_dilations=(1, 3, 5), stage_kernel=4))


@pytest.fixture(scope="module")
def odd(tiny_config):
    cfg = _odd_config(tiny_config)
    return cfg, *_nets(cfg)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("row_mask", [False, True])
def test_vocoder_matches_jax(nets, tiny_config, fused, row_mask):
    """The port's vocoder (every conv through the conv kernel's wrapper;
    the chains through the chain kernel's with fused_resblocks, or through
    _resblock's conv launches) against the JAX vocoder, f32, a [T] or a
    [B, T] frame mask (the latter takes _resblock either way)."""
    cfg = tiny_config
    params, mods = nets
    rng = np.random.default_rng(11)
    t = 14
    latent = rng.standard_normal((2, t, cfg.latent_channels)).astype(np.float32)
    fm = (np.arange(t)[None] < np.array([[t - 2], [t - 6]])).astype(np.float32)
    fm = fm if row_mask else fm[0]
    want = np.asarray(jvoc.apply(_jtree(params["vocoder"]), cfg, jnp.asarray(latent),
                                 frame_mask=jnp.asarray(fm), fused_resblocks=False))
    got = tvoc.apply(mods["vocoder"], cfg, torch.from_numpy(latent),
                     frame_mask=torch.from_numpy(fm), fused_resblocks=fused)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_vocoder_matches_jax_at_odd_widths(odd, fused):
    """The port's vocoder against the JAX vocoder at _odd_config's widths
    (channels off multiples of 8, an even stage size, resblocks of size 11
    reaching 50 frames), f32, a [B, T] mask and a [T] one (the chain
    kernel's plain version takes the latter with fused_resblocks)."""
    cfg, params, mods = odd
    assert cfg.latent_channels == 15 and tvoc.final_depth(cfg) == 15
    rng = np.random.default_rng(15)
    t = 13
    latent = rng.standard_normal((2, t, cfg.latent_channels)).astype(np.float32)
    fm = (np.arange(t)[None] < np.array([[t - 2], [t - 6]])).astype(np.float32)
    for m in (fm, fm[0]):
        want = np.asarray(jvoc.apply(_jtree(params["vocoder"]), cfg, jnp.asarray(latent),
                                     frame_mask=jnp.asarray(m), fused_resblocks=False))
        got = tvoc.apply(mods["vocoder"], cfg, torch.from_numpy(latent),
                         frame_mask=torch.from_numpy(m), fused_resblocks=fused)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _old_resblock(p, x, dilations, mask):
    """_resblock's earlier call order: conv a writes h (silu in, mask),
    conv b takes silu(h) in (silu in, mask, residual)."""
    rows = mask.reshape(mask.shape[0], -1)
    for cp, d in zip(p["convs"], dilations):
        h = tL.conv1d(cp["a"], x, dilation=d, silu_in=True, mask=rows)
        x = tL.conv1d(cp["b"], h, silu_in=True, mask=rows, residual=x)
    return x


@pytest.mark.parametrize("row_mask", [False, True])
def test_resblock_call_order_keeps_the_bits(odd, row_mask):
    """bf16: conv a with silu out (mask after it) and conv b without silu in
    give the bits of the earlier order (mask, then silu in conv b): the mask
    is 0/1 and silu(0) = 0, with the same rounding points. At every chain
    of _odd_config's vocoder and the default's C 512 dilations."""
    cfg, _params, mods = odd
    voc = mods["vocoder"]
    rng = np.random.default_rng(16)
    t = 40
    for p, c in [(voc["pre_res"], cfg.vocoder.dim)] + [
            (st["res"], ch) for st, ch in zip(voc["stages"], cfg.vocoder.channels)]:
        x = torch.from_numpy(rng.standard_normal((2, t, c)).astype(np.float32)).bfloat16()
        lens = np.array([[t - 3], [t - 11]]) if row_mask else np.array([[t - 3]])
        mask = torch.from_numpy((np.arange(t)[None] < lens).astype(np.float32))
        m = mask.bfloat16()[:, :, None]
        got = tvoc._resblock(p, x, cfg.vocoder.resblock_dilations, m)
        want = _old_resblock(p, x, cfg.vocoder.resblock_dilations, m)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_windows_equal_the_whole_sequence_at_odd_widths(odd):
    """bf16 windows against whole vocoding, bit for bit, at _odd_config (the
    resblocks as _resblock's conv launches: k 11 at d 5, the even stage
    size)."""
    cfg, _params, mods = odd
    halo = tvoc.receptive_field_frames(cfg)
    rng = np.random.default_rng(17)
    t_len, w = 19, 5
    xt = rng.standard_normal((1, t_len, cfg.latent_channels)).astype(np.float32)
    mask = (np.arange(t_len) < t_len - 2).astype(np.float32)
    full = tvoc.apply(mods["vocoder"], cfg, torch.from_numpy(xt),
                      frame_mask=torch.from_numpy(mask), dtype=torch.bfloat16,
                      fused_resblocks=False).numpy()
    xt_pad = np.pad(xt, ((0, 0), (halo, halo), (0, 0)))
    mask_pad = np.pad(mask, (halo, halo))
    pieces = []
    for k0 in range(0, t_len, w):
        start = max(0, min(k0, t_len - w))
        wav = synthesis.vocode_window(mods, cfg, torch.from_numpy(xt_pad),
                                      torch.from_numpy(mask_pad), start, w, halo,
                                      precision="bf16", egress="f32",
                                      fused_resblocks=False).numpy()
        off = (k0 - start) * cfg.chunk_size
        n = min(t_len - k0, w) * cfg.chunk_size
        pieces.append(wav[:, off: off + n])
    np.testing.assert_array_equal(np.concatenate(pieces, axis=1), full)


def test_text_encoder_at_an_even_conv_size_matches_jax(tiny_config):
    """The prenet at conv_kernel 4 (SAME: one frame on the left, two on the
    right), f32 against the JAX text encoder."""
    cfg = dataclasses.replace(tiny_config, text_encoder=dataclasses.replace(
        tiny_config.text_encoder, conv_kernel=4))
    params, mods = _nets(cfg)
    rng = np.random.default_rng(18)
    b, l = 2, 13
    ids = rng.integers(1, 200, (b, l))
    tmask = (np.arange(l)[None] < np.array([[l], [l - 4]])).astype(np.float32)
    style = rng.standard_normal((b, cfg.ttl.style.n_style,
                                 cfg.ttl.style.style_value_dim)).astype(np.float32)
    want = np.asarray(jte.apply(_jtree(params["text_encoder"]), cfg, jnp.asarray(ids),
                                jnp.asarray(style), jnp.asarray(tmask)))
    got = tte.apply(mods["text_encoder"], cfg, torch.from_numpy(ids), torch.from_numpy(style),
                    torch.from_numpy(tmask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_text_encoder_matches_jax(nets, tiny_config):
    """The prenet as two conv kernel launches (silu out, the text mask, the
    residual), the rest as before: f32 against the JAX text encoder."""
    cfg = tiny_config
    params, mods = nets
    rng = np.random.default_rng(12)
    b, l = 2, 15
    ids = rng.integers(1, 200, (b, l))
    tmask = (np.arange(l)[None] < np.array([[l], [l - 6]])).astype(np.float32)
    style = rng.standard_normal((b, cfg.ttl.style.n_style,
                                 cfg.ttl.style.style_value_dim)).astype(np.float32)
    want = np.asarray(jte.apply(_jtree(params["text_encoder"]), cfg, jnp.asarray(ids),
                                jnp.asarray(style), jnp.asarray(tmask)))
    got = tte.apply(mods["text_encoder"], cfg, torch.from_numpy(ids), torch.from_numpy(style),
                    torch.from_numpy(tmask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucket_padding_equals_exact_length(nets, tiny_config, dtype):
    """A latent padded past its length with zero frames, the pads masked,
    vocodes its real frames bit for bit as the exact-length latent does, in
    f32 and bf16."""
    cfg = tiny_config
    _params, mods = nets
    rng = np.random.default_rng(13)
    t, pad = 10, 6
    latent = rng.standard_normal((1, t, cfg.latent_channels)).astype(np.float32)
    padded = np.concatenate([latent, np.zeros((1, pad, cfg.latent_channels), np.float32)], 1)
    fm = (np.arange(t + pad) < t).astype(np.float32)
    exact = tvoc.apply(mods["vocoder"], cfg, torch.from_numpy(latent),
                       frame_mask=torch.ones(t), dtype=dtype, fused_resblocks=False)
    bucket = tvoc.apply(mods["vocoder"], cfg, torch.from_numpy(padded),
                        frame_mask=torch.from_numpy(fm), dtype=dtype, fused_resblocks=False)
    n = t * cfg.chunk_size
    np.testing.assert_allclose(bucket[:, :n].numpy(), exact.numpy(), rtol=0,
                               atol=0)


def test_windows_equal_the_whole_sequence_in_bf16(nets, tiny_config):
    """Windows of the padded latent put together against whole vocoding,
    bf16 with _resblock's conv launches (fused_resblocks=False), bit for
    bit: the conv's sums per frame do not depend on where the window
    starts."""
    cfg = tiny_config
    _params, mods = nets
    halo = tvoc.receptive_field_frames(cfg)
    rng = np.random.default_rng(14)
    t_len, w = 21, 4
    xt = rng.standard_normal((1, t_len, cfg.latent_channels)).astype(np.float32)
    mask = (np.arange(t_len) < t_len - 3).astype(np.float32)
    xt_pad = np.pad(xt, ((0, 0), (halo, halo), (0, 0)))
    mask_pad = np.pad(mask, (halo, halo))
    full = tvoc.apply(mods["vocoder"], cfg, torch.from_numpy(xt),
                      frame_mask=torch.from_numpy(mask), dtype=torch.bfloat16,
                      fused_resblocks=False).numpy()
    pieces = []
    for k0 in range(0, t_len, w):
        start = max(0, min(k0, t_len - w))
        wav = synthesis.vocode_window(mods, cfg, torch.from_numpy(xt_pad),
                                      torch.from_numpy(mask_pad), start, w, halo,
                                      precision="bf16", egress="f32",
                                      fused_resblocks=False).numpy()
        off = (k0 - start) * cfg.chunk_size
        n = min(t_len - k0, w) * cfg.chunk_size
        pieces.append(wav[:, off: off + n])
    np.testing.assert_array_equal(np.concatenate(pieces, axis=1), full)


def _conv_shapes(cfg):
    """(Cin, Cout, k, dilation) of every conv the port's path runs through
    the conv kernel at ``cfg``: the TE prenet, the vocoder's pre, up and
    head convs and its resblocks (any chain may take _resblock)."""
    voc, te = cfg.vocoder, cfg.text_encoder
    shapes = {(te.dim, te.dim, te.conv_kernel, 1), (cfg.latent_channels, voc.dim, 7, 1)}
    cin = voc.dim
    for c in (voc.dim, *voc.channels):
        for d in voc.resblock_dilations:
            shapes |= {(c, c, voc.resblock_kernel, d), (c, c, voc.resblock_kernel, 1)}
    for f, c in zip(voc.upsample_factors, voc.channels):
        shapes.add((cin, c * f, voc.stage_kernel, 1))
        cin = c
    shapes.add((cin, tvoc.final_depth(cfg), 3, 1))
    return shapes


def test_supports_every_shape_of_the_path(tiny_config):
    """The kernel's domain holds every conv of the default config, the tests'
    tiny config, _odd_config and phase 12's five configs, in both types."""
    cfgs = ([TTSConfig(), tiny_config, _odd_config(tiny_config)]
            + [c for _n, c in chip_smoke.width_configs()])
    shapes = set().union(*(_conv_shapes(c) for c in cfgs))
    assert (96, 512, 7, 1) in shapes and (512, 3072, 5, 1) in shapes
    assert (1024, 1024, 5, 1) in shapes and (512, 512, 7, 9) in shapes
    assert {(15, 64, 7, 1), (64, 144, 4, 1), (36, 80, 4, 1), (20, 15, 3, 1),
            (36, 36, 11, 5)} <= shapes
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            assert conv1d.supports(*shape, dtype), (shape, dtype)


@pytest.mark.parametrize("shape", [(12, 64, 3, 1), (64, 36, 3, 1), (15, 512, 7, 1),
                                   (30, 512, 7, 1), (128, 250, 3, 1), (256, 256, 4, 1),
                                   (512, 512, 11, 9), (512, 512, 11, 1), (8, 8, 9, 1),
                                   (64, 64, 5, 17), (1, 1, 1, 1), (3, 5, 2, 100)])
def test_domain_holds_what_jax_runs(shape):
    """Every Cin, Cout, size and dilation that JAX's conv1d takes, in both
    types: channels off multiples of 8 (the pre conv's 15 or 30, heads of
    15 or 250), even sizes, reaches past 64 frames, bf16 sizes past 7 (the
    earlier kernel refused all of these)."""
    for dtype in (torch.float32, torch.bfloat16):
        assert conv1d.supports(*shape, dtype)


def test_weight_rows_pad_bf16_to_16_bytes():
    """bf16 weights reach the kernel in rows of Cout rounded up to 8
    elements (a TMA map's 16-byte rows), the pad zero; f32 ones as they
    are; conv_weight writes that layout once, and the plain version reads
    the view."""
    assert conv1d.weight_rows(15, torch.bfloat16) == 16
    assert conv1d.weight_rows(512, torch.bfloat16) == 512
    assert conv1d.weight_rows(15, torch.float32) == 15
    w = conv1d.weight_buffer(3, 5, 15, torch.bfloat16, "cpu")
    assert w.shape == (3, 5, 15) and w.stride() == (80, 16, 1)
    assert torch.count_nonzero(w.as_strided((3, 5, 16), (80, 16, 1))[..., 15:]) == 0
    assert conv1d.weight_buffer(3, 5, 16, torch.bfloat16, "cpu").is_contiguous()
    rng = np.random.default_rng(19)
    p = tL.Conv1d(torch.from_numpy(rng.standard_normal((15, 5, 3)).astype(np.float32)),
                  torch.from_numpy(rng.standard_normal(15).astype(np.float32)))
    wb = tL.conv_weight(p, torch.bfloat16)
    assert wb.stride() == (80, 16, 1)
    torch.testing.assert_close(wb, p.weight.permute(2, 1, 0).bfloat16(), rtol=0, atol=0)
    x = torch.from_numpy(rng.standard_normal((2, 9, 5)).astype(np.float32)).bfloat16()
    got = tL.conv1d(p, x, silu_in=True)
    want = conv1d.conv1d_fused_plain(x, wb.contiguous(), p.bias, silu_in=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_domain_and_refusals():
    """What the kernel's domain holds (every shape) and what the wrapper
    still refuses: another type, bad shapes, a device other than the CPU
    and CUDA."""
    assert conv1d.supports(96, 512, 7, 1, torch.bfloat16)
    assert conv1d.supports(8, 8, 3, 32, torch.float32)
    assert conv1d.supports(8, 8, 9, 8, torch.float32)
    assert conv1d.supports(8, 8, 9, 1, torch.bfloat16)  # bf16 at any size
    assert conv1d.supports(12, 64, 3, 1, torch.float32)  # Cin no multiple of 8
    assert conv1d.supports(64, 36, 3, 1, torch.bfloat16)  # Cout no multiple of 8
    assert conv1d.supports(64, 64, 4, 1, torch.float32)  # even size
    assert conv1d.supports(64, 64, 5, 17, torch.float32)  # reach 68 frames
    assert not conv1d.supports(64, 64, 3, 1, torch.float16)
    assert not conv1d.supports(0, 64, 3, 1, torch.float32)
    assert not conv1d.supports(64, 64, 3, 0, torch.bfloat16)
    x, w, bias = torch.zeros((2, 6, 8)), torch.zeros((3, 8, 16)), torch.zeros(16)
    with pytest.raises(ValueError, match="w"):
        conv1d.conv1d_fused(x, torch.zeros((3, 4, 16)), bias)
    with pytest.raises(ValueError, match="bias"):
        conv1d.conv1d_fused(x, w, torch.zeros(8))
    with pytest.raises(ValueError, match="fold"):
        conv1d.conv1d_fused(x, w, bias, fold=3)
    with pytest.raises(ValueError, match="mask"):
        conv1d.conv1d_fused(x, w, bias, mask=torch.ones(5))
    with pytest.raises(ValueError, match="mask"):
        conv1d.conv1d_fused(x, w, bias, fold=2, mask=torch.ones((3, 12)))
    with pytest.raises(ValueError, match="residual"):
        conv1d.conv1d_fused(x, w, bias, residual=torch.zeros((2, 6, 8)))
    with pytest.raises(ValueError, match="device"):
        conv1d.conv1d_fused(x.to("meta"), w.to("meta"), bias.to("meta"))
    # the fine mask of a fold: [B, T * fold]; a fold whose Cout / fold (9) is
    # no multiple of 8
    assert conv1d.conv1d_fused(x, w, bias, fold=2, mask=torch.ones((2, 12))).shape == (2, 6, 16)
    w18 = torch.zeros((3, 8, 18))
    assert conv1d.conv1d_fused(x, w18, torch.zeros(18), fold=2,
                               mask=torch.ones((2, 12))).shape == (2, 6, 18)
    assert conv1d.options(silu_in=True, mask=torch.ones((2, 12)), fold=2, batch=2) == \
        "silu_in+row_mask+fold2"
