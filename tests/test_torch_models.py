"""The port's four networks against the JAX package's, same params (from
the shared numpy init) and same inputs, f32 on the CPU. The zero-init
heads of the vector estimator are randomized, as in test_oracle_parity,
so that the attention and FFN sublayers are not multiplied by a zero gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supertonic_tpu import models as jM
from supertonic_tpu.config import TTSConfig as JTTSConfig
from supertonic_tpu.models import duration_predictor as jdp
from supertonic_tpu.models import text_encoder as jte
from supertonic_tpu.models import vector_estimator as jve
from supertonic_tpu.models import vocoder as jvoc
from supertonic_tpu_torch import models as tM
from supertonic_tpu_torch.config import TTSConfig
from supertonic_tpu_torch.models import duration_predictor as tdp
from supertonic_tpu_torch.models import text_encoder as tte
from supertonic_tpu_torch.models import vector_estimator as tve
from supertonic_tpu_torch.models import vocoder as tvoc

# the wav passes through tanh, so its error is absolute
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _perturb_zero_heads(ve, rng):
    for key in ("out_proj", "adaln_out"):
        ve[key]["w"] = (rng.standard_normal(ve[key]["w"].shape) * 0.05).astype(np.float32)
    for bp in ve["blocks"]:
        bp["adaln"]["w"] = (rng.standard_normal(bp["adaln"]["w"].shape) * 0.05).astype(np.float32)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def setup(tiny_config):
    cfg = tiny_config
    params = tM.init_all(0, cfg)
    rng = np.random.default_rng(42)
    _perturb_zero_heads(params["vector_estimator"], rng)
    b, l, t = 2, 16, 12
    x = {
        "ids": rng.integers(1, 200, (b, l)),
        "tmask": (np.arange(l)[None] < np.array([[l], [l - 5]])).astype(np.float32),
        "style": rng.standard_normal(
            (b, cfg.ttl.style.n_style, cfg.ttl.style.style_value_dim)).astype(np.float32),
        "latent": rng.standard_normal((b, t, cfg.latent_channels)).astype(np.float32),
        "lmask": (np.arange(t)[None] < np.array([[t], [t - 4]])).astype(np.float32),
    }
    return cfg, params, tM.load_params(params, device="cpu"), x


def test_init_all_bit_equal_to_jax(tiny_config):
    a, b = jM.init_all(0, tiny_config), tM.init_all(0, tiny_config)
    fa, fb = _flatten(a), _flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype == np.float32
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def test_load_params_round_trip(setup):
    _cfg, params, mods, _x = setup
    back = tM.to_numpy_tree(mods)
    fa, fb = _flatten(params), _flatten(back)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    # torch layouts inside: linear [dout, din], conv [cout, cin, k]
    ve = mods["vector_estimator"]
    assert tuple(ve["in_proj"].weight.shape) == params["vector_estimator"]["in_proj"]["w"].shape[::-1]
    assert tuple(mods["vocoder"]["pre"].weight.shape) == (
        params["vocoder"]["pre"]["w"].shape[2], params["vocoder"]["pre"]["w"].shape[1], 7)
    bf = tM.load_params(params, device="cpu", dtype=torch.bfloat16)
    assert bf["vector_estimator"]["in_proj"].weight.dtype == torch.bfloat16
    assert bf["vector_estimator"]["in_proj"].bias.dtype == torch.float32


def test_duration_predictor(setup):
    cfg, params, mods, x = setup
    ref = jax.jit(lambda: jdp.apply(
        _jtree(params["duration_predictor"]), cfg, jnp.asarray(x["ids"]),
        jnp.asarray(x["style"]), jnp.asarray(x["tmask"])))()
    got = tdp.apply(mods["duration_predictor"], cfg, torch.as_tensor(x["ids"]),
                    _t(x["style"]), _t(x["tmask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_text_encoder(setup):
    cfg, params, mods, x = setup
    ref = jax.jit(lambda: jte.apply(
        _jtree(params["text_encoder"]), cfg, jnp.asarray(x["ids"]),
        jnp.asarray(x["style"]), jnp.asarray(x["tmask"])))()
    got = tte.apply(mods["text_encoder"], cfg, torch.as_tensor(x["ids"]),
                    _t(x["style"]), _t(x["tmask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _emb(cfg, x):
    b, l = x["ids"].shape
    return np.random.default_rng(9).standard_normal(
        (b, l, cfg.ttl.proj_out_odim)).astype(np.float32)


def test_vector_estimator_step(setup):
    cfg, params, mods, x = setup
    emb = _emb(cfg, x)
    b = emb.shape[0]
    cur, tot = np.array([1.0, 3.0], np.float32), np.full((b,), 5.0, np.float32)
    ref = jax.jit(lambda: jve.step(
        _jtree(params["vector_estimator"]), cfg, jnp.asarray(x["latent"]),
        jnp.asarray(emb), jnp.asarray(x["style"]), jnp.asarray(x["tmask"]),
        jnp.asarray(x["lmask"]), jnp.asarray(cur), jnp.asarray(tot)))()
    ve = mods["vector_estimator"]
    args = (_t(x["latent"]), _t(emb), _t(x["style"]), _t(x["tmask"]),
            _t(x["lmask"]), _t(cur), _t(tot))
    got = tve.step(ve, cfg, *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the hoisted cross K/V gives the same step
    cache = tve.precompute_cross(ve, cfg, _t(emb), _t(x["style"]), _t(x["tmask"]))
    np.testing.assert_allclose(tve.step(ve, cfg, *args, cross_cache=cache).numpy(),
                               got.numpy(), rtol=0, atol=0)


def test_vocoder(setup):
    cfg, params, mods, x = setup
    t = x["latent"].shape[1]
    fm = np.ones(t, np.float32)
    fm[-3:] = 0.0
    ref = jax.jit(lambda: jvoc.apply(
        _jtree(params["vocoder"]), cfg, jnp.asarray(x["latent"]),
        frame_mask=jnp.asarray(fm)))()
    got = tvoc.apply(mods["vocoder"], cfg, _t(x["latent"]), frame_mask=_t(fm))
    assert got.shape == (x["latent"].shape[0], t * cfg.chunk_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert tvoc.receptive_field_frames(cfg) == jvoc.receptive_field_frames(cfg)


def test_full_width_step_and_vocoder():
    """The default 66M widths once (H=8, Dh=64; vocoder C=512/256/128):
    catches layout bugs that tiny widths hide."""
    cfg, jcfg = TTSConfig(), JTTSConfig()
    rng = np.random.default_rng(0)
    ve_p = tve.init(rng, cfg)
    _perturb_zero_heads(ve_p, rng)
    voc_p = tvoc.init(rng, cfg)
    b, t, l = 1, 32, 32
    lat = rng.standard_normal((b, t, cfg.latent_channels)).astype(np.float32)
    emb = rng.standard_normal((b, l, cfg.ttl.proj_out_odim)).astype(np.float32)
    style = rng.standard_normal(
        (b, cfg.ttl.style.n_style, cfg.ttl.style.style_value_dim)).astype(np.float32)
    tmask = (np.arange(l)[None] < 27).astype(np.float32)
    lmask = (np.arange(t)[None] < 29).astype(np.float32)
    cur, tot = np.zeros(b, np.float32), np.full(b, 5.0, np.float32)
    ref = jax.jit(lambda p: jve.step(
        p, jcfg, jnp.asarray(lat), jnp.asarray(emb), jnp.asarray(style),
        jnp.asarray(tmask), jnp.asarray(lmask), jnp.asarray(cur),
        jnp.asarray(tot)))(_jtree(ve_p))
    got = tve.step(tL_load(ve_p), cfg, _t(lat), _t(emb), _t(style), _t(tmask),
                   _t(lmask), _t(cur), _t(tot))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    tv = 16
    lat = lat[:, :tv]
    fm = (np.arange(tv) < 13).astype(np.float32)
    ref = jax.jit(lambda p: jvoc.apply(p, jcfg, jnp.asarray(lat),
                                       frame_mask=jnp.asarray(fm)))(_jtree(voc_p))
    got = tvoc.apply(tL_load(voc_p), cfg, _t(lat), frame_mask=_t(fm))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def tL_load(tree):
    return tM.load_params(tree, device="cpu")
