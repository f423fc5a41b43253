"""The vocoder's ``up_matmul`` lever on the CPU: each upsample conv as one
K-stacked product, against the JAX package's ``up_matmul=True`` and the
port's conv path (atol 1e-5, as tests/test_vocoder_fused.py holds JAX's
two paths), bucket-pad masking included; and ``TTS_VOC_UP_MATMUL``, read
once when the engine is built, through the engine against the JAX engine
under the same variable (f32, durations rtol 1e-6, wav atol 1e-4) and into
the keys of the programs that vocode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supertonic_tpu.config import TTSConfig as JTTSConfig
from supertonic_tpu.engine import SynthesisEngine as JEngine
from supertonic_tpu.engine import VoiceStyle as JVoiceStyle
from supertonic_tpu.frontend import UnicodeProcessor as JProcessor
from supertonic_tpu.frontend import build_default_indexer as j_indexer
from supertonic_tpu.models import vocoder as jvocoder
from supertonic_tpu_torch.config import TTSConfig
from supertonic_tpu_torch.engine import SynthesisEngine, VoiceStyle, programs
from supertonic_tpu_torch.frontend import UnicodeProcessor, build_default_indexer
from supertonic_tpu_torch.models import init_all, load_params, vocoder

TEXTS = ["Hello there.", "A rather longer sentence, for a second row."]


@pytest.fixture(scope="module", autouse=True)
def rate_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTS_RATE_CACHE_DIR", str(tmp_path_factory.mktemp("rates")))
        mp.delenv("TTS_VOC_UP_MATMUL", raising=False)
        yield


def test_up_matmul_matches_jax_and_the_conv_path():
    """The default config's vocoder (full width), B=2, T=24, the last five
    frames masked as bucket padding."""
    cfg, jcfg = TTSConfig(), JTTSConfig()
    rng = np.random.default_rng(3)
    tree = vocoder.init(rng, cfg)
    mods = load_params({"vocoder": tree}, device="cpu")["vocoder"]
    t = 24
    lat = rng.standard_normal((2, t, cfg.latent_channels)).astype(np.float32)
    fm = np.ones((t,), np.float32)
    fm[-5:] = 0.0
    want = jvocoder.apply(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(lat),
                          frame_mask=jnp.asarray(fm), up_matmul=True)
    got = vocoder.apply(mods, cfg, torch.from_numpy(lat), frame_mask=torch.from_numpy(fm),
                        up_matmul=True)
    conv = vocoder.apply(mods, cfg, torch.from_numpy(lat), frame_mask=torch.from_numpy(fm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), conv.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [3, 4, 5])
def test_up_matmul_is_the_same_conv_at_any_kernel(k):
    """SAME padding (k-1)//2 left, the rest right, for odd and even k."""
    from supertonic_tpu_torch.models import layers as L

    rng = np.random.default_rng(k)
    p = load_params({"c": L.conv1d_init(rng, 6, 10, k)}, device="cpu")["c"]
    p.bias.copy_(torch.from_numpy(rng.standard_normal(10).astype(np.float32)))
    s = torch.from_numpy(rng.standard_normal((2, 9, 6)).astype(np.float32))
    torch.testing.assert_close(vocoder._up_matmul(p, s), L.conv1d(p, s), rtol=0, atol=1e-5)


def test_engine_reads_the_variable_once_and_matches_jax(tiny_config, monkeypatch):
    cfg = tiny_config
    params = init_all(0, cfg)
    rng = np.random.default_rng(7)
    ttl = rng.standard_normal((1, cfg.ttl.style.n_style,
                               cfg.ttl.style.style_value_dim)).astype(np.float32)
    dp = rng.standard_normal((1, cfg.dp.style.n_style,
                              cfg.dp.style.style_value_dim)).astype(np.float32)
    noise = np.random.default_rng(3).standard_normal(
        (2, 256, cfg.latent_channels)).astype(np.float32)
    monkeypatch.setenv("TTS_VOC_UP_MATMUL", "1")
    eng = SynthesisEngine(params, cfg, UnicodeProcessor(build_default_indexer()),
                          precision="f32", device="cpu")
    jeng = JEngine(params, cfg, JProcessor(j_indexer()), precision="f32")
    jw, jd = jeng.infer_batch(TEXTS, ["en", "en"], JVoiceStyle(ttl, dp).tile(2),
                              total_step=2, noise=noise)
    monkeypatch.delenv("TTS_VOC_UP_MATMUL")
    assert eng.up_matmul  # read at construction, not at each call
    calls = []
    real = vocoder.apply

    def spy(*args, **kwargs):
        calls.append(kwargs.get("up_matmul"))
        return real(*args, **kwargs)

    monkeypatch.setattr(vocoder, "apply", spy)
    w, d = eng.infer_batch(TEXTS, ["en", "en"], VoiceStyle(ttl, dp).tile(2),
                           total_step=2, noise=noise)
    assert calls == [True]
    np.testing.assert_allclose(d, jd, rtol=1e-6)
    assert w.shape == jw.shape
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-4)
    off = SynthesisEngine(params, cfg, UnicodeProcessor(build_default_indexer()),
                          precision="f32", device="cpu")
    assert not off.up_matmul


def test_program_keys_hold_up_matmul():
    ids = torch.zeros((4, 64), dtype=torch.int64)
    emb = torch.zeros((4, 64, 8))
    x = torch.zeros((4, 448, 8))
    lmask = torch.zeros((4, 448))
    pairs = [
        (programs.fused_key(ids, 5, 448, "bf16", "int16", up_matmul=True),
         programs.fused_key(ids, 5, 448, "bf16", "int16", up_matmul=False)),
        (programs.window_key(x, 64, 24, "bf16", "int16", up_matmul=True),
         programs.window_key(x, 64, 24, "bf16", "int16", up_matmul=False)),
        (programs.acoustic_key(emb, lmask, 5, "bf16", up_matmul=True),
         programs.acoustic_key(emb, lmask, 5, "bf16", up_matmul=False)),
        (programs.vocoder_key(x, "bf16", up_matmul=True),
         programs.vocoder_key(x, "bf16", up_matmul=False)),
    ]
    for on, off in pairs:
        assert on != off and on[0] == off[0]
