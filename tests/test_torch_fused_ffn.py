"""The engine's ``fused_ffn`` option on the CPU: the port's engine against
the JAX engine on injected noise with the option off (the JAX default: the
AdaLN FFN as linear, silu, linear) and on (the fused kernel; in JAX the
Pallas kernel in interpret mode), in f32 and in bf16; the block and the
estimator step with the option off against JAX's; and the programs' keys,
which differ by the option.

Tolerances: f32 durations rtol 1e-6 with the same latent lengths and wav
atol 1e-4 (the bound of tests/test_torch_engine.py). bf16, both packages
with the option off: durations rtol 1e-6 (they agreed bit for bit) and wav
atol 2e-3 at a peak of ~0.09 (7.3e-4 measured: the port keeps f32
attention logits and adds conv biases in the epilogue, ROADMAP §3); the
port's two settings in bf16 within the same 2e-3."""

import numpy as np
import pytest
import torch

from supertonic_tpu.engine import SynthesisEngine as JEngine
from supertonic_tpu.engine import VoiceStyle as JVoiceStyle
from supertonic_tpu.frontend import UnicodeProcessor as JProcessor
from supertonic_tpu.frontend import build_default_indexer as j_indexer
from supertonic_tpu.models import layers as JL
from supertonic_tpu.models import vector_estimator as JVE
from supertonic_tpu_torch.engine import SynthesisEngine, VoiceStyle, programs
from supertonic_tpu_torch.frontend import UnicodeProcessor, build_default_indexer
from supertonic_tpu_torch.models import layers as L
from supertonic_tpu_torch.models import load_params
from supertonic_tpu_torch.models import vector_estimator as VE
from supertonic_tpu_torch.models import init_all

TEXTS = ["Hello there.", "A rather longer sentence, for a second row."]


@pytest.fixture(scope="module", autouse=True)
def rate_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTS_RATE_CACHE_DIR", str(tmp_path_factory.mktemp("rates")))
        yield


@pytest.fixture(scope="module")
def params(tiny_config):
    """init_all with the estimator's zero-init heads perturbed, so that the
    AdaLN gates are open and the FFN sublayer reaches the output."""
    p = init_all(0, tiny_config)
    rng = np.random.default_rng(42)
    ve = p["vector_estimator"]
    for key in ("out_proj", "adaln_out"):
        ve[key]["w"] = (rng.standard_normal(ve[key]["w"].shape) * 0.05).astype(np.float32)
    for bp in ve["blocks"]:
        bp["adaln"]["w"] = (rng.standard_normal(bp["adaln"]["w"].shape) * 0.05).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def styles(tiny_config):
    rng = np.random.default_rng(7)
    cfg = tiny_config
    ttl = rng.standard_normal((1, cfg.ttl.style.n_style,
                               cfg.ttl.style.style_value_dim)).astype(np.float32)
    dp = rng.standard_normal((1, cfg.dp.style.n_style,
                              cfg.dp.style.style_value_dim)).astype(np.float32)
    return JVoiceStyle(ttl, dp).tile(2), VoiceStyle(ttl, dp).tile(2)


@pytest.fixture(scope="module")
def noise(tiny_config):
    return np.random.default_rng(3).standard_normal(
        (2, 256, tiny_config.latent_channels)).astype(np.float32)


def _pair(params, cfg, styles, noise, precision, fused_ffn):
    jstyle, style = styles
    jeng = JEngine(params, cfg, JProcessor(j_indexer()), precision=precision,
                   fused_ffn=fused_ffn)
    eng = SynthesisEngine(params, cfg, UnicodeProcessor(build_default_indexer()),
                          precision=precision, device="cpu", fused_ffn=fused_ffn)
    assert eng.fused_ffn is fused_ffn
    jw, jd = jeng.infer_batch(TEXTS, ["en", "en"], jstyle, total_step=2, noise=noise)
    w, d = eng.infer_batch(TEXTS, ["en", "en"], style, total_step=2, noise=noise)
    return (w, d), (jw, jd)


def _latents(d, cfg):
    return np.ceil(d * cfg.sample_rate / cfg.chunk_size)


@pytest.mark.parametrize("fused_ffn", [False, True], ids=["unfused", "fused"])
def test_engine_matches_jax_engine_in_f32(params, tiny_config, styles, noise, fused_ffn):
    (w, d), (jw, jd) = _pair(params, tiny_config, styles, noise, "f32", fused_ffn)
    np.testing.assert_allclose(d, jd, rtol=1e-6)
    np.testing.assert_array_equal(_latents(d, tiny_config), _latents(jd, tiny_config))
    assert w.shape == jw.shape
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-4)


def test_engine_matches_jax_engine_in_bf16(params, tiny_config, styles, noise):
    """bf16 with the option off in both packages (the JAX default), and the
    port's two settings against each other."""
    (w, d), (jw, jd) = _pair(params, tiny_config, styles, noise, "bf16", False)
    np.testing.assert_allclose(d, jd, rtol=1e-6)
    assert w.shape == jw.shape
    np.testing.assert_allclose(w, jw, rtol=0, atol=2e-3)
    eng = SynthesisEngine(params, tiny_config, UnicodeProcessor(build_default_indexer()),
                          precision="bf16", device="cpu", fused_ffn=True)
    wf, df = eng.infer_batch(TEXTS, ["en", "en"], styles[1], total_step=2, noise=noise)
    np.testing.assert_array_equal(df, d)  # the text stage has no AdaLN FFN
    np.testing.assert_allclose(wf, w, rtol=0, atol=2e-3)


def test_unfused_block_and_step_match_jax(params, tiny_config):
    """The block with the option off is the JAX block's unfused path, and
    the estimator step threads the option down to it (f32, atol 1e-5)."""
    cfg = tiny_config
    hp = cfg.vector_estimator
    rng = np.random.default_rng(5)
    b, t = 2, 24
    mods = load_params(params, device="cpu")
    bp = params["vector_estimator"]["blocks"][0]
    x = rng.standard_normal((b, t, hp.dim)).astype(np.float32)
    cond = rng.standard_normal((b, hp.dim)).astype(np.float32)
    mem = rng.standard_normal((b, 10, hp.dim)).astype(np.float32)
    want = JL.block(bp, x, hp.n_heads, memory=mem, cond=cond, fused_ffn=False)
    for fused in (False, True):
        got = L.block(mods["vector_estimator"]["blocks"][0], torch.from_numpy(x),
                      hp.n_heads, memory=torch.from_numpy(mem), cond=torch.from_numpy(cond),
                      fused_ffn=fused)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    lat = rng.standard_normal((b, t, cfg.latent_channels)).astype(np.float32)
    emb = rng.standard_normal((b, 12, cfg.ttl.proj_out_odim)).astype(np.float32)
    sttl = rng.standard_normal((b, cfg.ttl.style.n_style,
                                cfg.ttl.style.style_value_dim)).astype(np.float32)
    tmask = np.ones((b, 12), np.float32)
    lmask = np.ones((b, t), np.float32)
    cur, tot = np.zeros(b, np.float32), np.full(b, 4.0, np.float32)
    want = JVE.step(params["vector_estimator"], cfg, lat, emb, sttl, tmask, lmask, cur, tot,
                    fused_ffn=False)
    got = VE.step(mods["vector_estimator"], cfg, *map(torch.from_numpy,
                                                      (lat, emb, sttl, tmask, lmask, cur, tot)),
                  fused_ffn=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_unfused_block_launches_no_ffn_kernel(params, tiny_config, monkeypatch):
    """With the option off the block never calls the fused FFN wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("fused_ffn=False reached the fused FFN")

    monkeypatch.setattr(L, "fused_adaln_ffn", refuse)
    hp = tiny_config.vector_estimator
    mods = load_params(params, device="cpu")
    x = torch.randn(1, 8, hp.dim)
    L.block(mods["vector_estimator"]["blocks"][0], x, hp.n_heads,
            memory=torch.randn(1, 4, hp.dim), cond=torch.randn(1, hp.dim), fused_ffn=False)
    with pytest.raises(AssertionError, match="reached the fused FFN"):
        L.block(mods["vector_estimator"]["blocks"][0], x, hp.n_heads,
                memory=torch.randn(1, 4, hp.dim), cond=torch.randn(1, hp.dim))


def test_program_keys_differ_by_fused_ffn():
    """Two engines with different settings never share a capture: every
    key of a program that runs the estimator holds the option."""
    ids = torch.zeros((4, 64), dtype=torch.int64)
    emb = torch.zeros((4, 64, 8))
    x = torch.zeros((4, 448, 8))
    lmask = torch.zeros((4, 448))
    pairs = [
        (programs.fused_key(ids, 5, 448, "bf16", "int16", fused_ffn=True),
         programs.fused_key(ids, 5, 448, "bf16", "int16", fused_ffn=False)),
        (programs.flow_key(ids, 5, 448, "bf16", 24, fused_ffn=True),
         programs.flow_key(ids, 5, 448, "bf16", 24, fused_ffn=False)),
        (programs.acoustic_key(emb, lmask, 5, "bf16", fused_ffn=True),
         programs.acoustic_key(emb, lmask, 5, "bf16", fused_ffn=False)),
        (programs.step_key(x, emb, "bf16", fused_ffn=True),
         programs.step_key(x, emb, "bf16", fused_ffn=False)),
    ]
    for on, off in pairs:
        assert on != off and on[0] == off[0]
