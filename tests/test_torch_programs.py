"""The port's compiled programs (``engine/programs.py``) on the CPU: each
program's key against the JAX ``static_argnums`` it mirrors, the program
bodies with ``speed`` as a tensor against the JAX functions on the same
noise, the static noise draw and the window copy-in bit for bit against the
eager ops, the launch accounting of captures and replays, the capture lock,
and an engine on the CPU that never builds a program. The graphs themselves
are captured and replayed only on the card (``chip_smoke.py``)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supertonic_tpu.engine import synthesis as JS
from supertonic_tpu_torch import ops
from supertonic_tpu_torch.engine import SynthesisEngine, VoiceStyle, programs, synthesis
from supertonic_tpu_torch.frontend import UnicodeProcessor, build_default_indexer
from supertonic_tpu_torch.models import init_all, load_params, vocoder
from supertonic_tpu_torch.models.vocoder import receptive_field_frames
from supertonic_tpu_torch.ops import _count

TEXTS = ["Hello there.", "A rather longer sentence, for a second row."]


@pytest.fixture(scope="module", autouse=True)
def rate_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTS_RATE_CACHE_DIR", str(tmp_path_factory.mktemp("rates")))
        yield


@pytest.fixture(scope="module")
def params(tiny_config):
    p = init_all(0, tiny_config)
    rng = np.random.default_rng(42)
    ve = p["vector_estimator"]
    for key in ("out_proj", "adaln_out"):
        ve[key]["w"] = (rng.standard_normal(ve[key]["w"].shape) * 0.05).astype(np.float32)
    for bp in ve["blocks"]:
        bp["adaln"]["w"] = (rng.standard_normal(bp["adaln"]["w"].shape) * 0.05).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def mods(params):
    return load_params(params, device="cpu")


@pytest.fixture(scope="module")
def style(tiny_config):
    rng = np.random.default_rng(7)
    cfg = tiny_config
    return VoiceStyle(
        rng.standard_normal((1, cfg.ttl.style.n_style,
                             cfg.ttl.style.style_value_dim)).astype(np.float32),
        rng.standard_normal((1, cfg.dp.style.n_style,
                             cfg.dp.style.style_value_dim)).astype(np.float32))


@pytest.fixture(scope="module")
def engine(params, tiny_config):
    return SynthesisEngine(params, tiny_config, UnicodeProcessor(build_default_indexer()),
                           precision="f32", device="cpu")


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

IDS = torch.zeros((4, 64), dtype=torch.int64)
XT_PAD = torch.zeros((1, 112, 8))
KEYS = {  # program: (JAX jit factory, static names, key function, its arguments)
    "fused": (JS.jit_synthesize_fused, programs.FUSED_STATIC, programs.fused_key,
              dict(text_ids=IDS, total_step=5, t_pad=448, precision="bf16",
                   egress="int16")),
    "flow": (JS.jit_flow_fused, programs.FLOW_STATIC, programs.flow_key,
             dict(text_ids=IDS, total_step=5, t_pad=448, precision="bf16", halo=24)),
    "window": (JS.jit_vocode_window, programs.WINDOW_STATIC, programs.window_key,
               dict(xt_pad=XT_PAD, window=64, halo=24, precision="bf16", egress="int16")),
    "text": (JS.jit_text_stage, programs.TEXT_STATIC, programs.text_key,
             dict(text_ids=IDS, precision="bf16")),
    "acoustic": (JS.jit_acoustic_stage, programs.ACOUSTIC_STATIC, programs.acoustic_key,
                 dict(text_emb=torch.zeros((4, 64, 16)), latent_mask=torch.zeros((4, 448)),
                      total_step=5, precision="bf16")),
}
OTHER = {"total_step": 2, "t_pad": 640, "egress": "f32", "window": 32, "halo": 12,
         "precision": "int8", "text_ids": torch.zeros((4, 128), dtype=torch.int64),
         "xt_pad": torch.zeros((2, 112, 8)), "text_emb": torch.zeros((4, 128, 16)),
         "latent_mask": torch.zeros((4, 640)), "x": torch.zeros((1, 640, 8))}


@pytest.mark.parametrize("name", sorted(KEYS))
def test_program_key_holds_the_jax_static_arguments(name, tiny_config):
    """Each static argument of the JAX program is in the key, and so are the
    shapes of its array arguments (JAX traces per shape) and the precision
    (a partial in JAX: one jitted function per precision)."""
    make_jit, static, key_fn, kwargs = KEYS[name]
    assert make_jit(tiny_config)._jit_info.static_argnames == static
    base = key_fn(**kwargs)
    assert base == key_fn(**kwargs) and base[0] == name
    varied = [arg for arg in kwargs if key_fn(**dict(kwargs, **{arg: OTHER[arg]})) != base]
    assert set(static) <= set(varied)
    assert set(varied) == set(kwargs)  # array shapes and precision too


PROGRESS_KEYS = {  # the JAX engine's progress closure, key function, its arguments
    "cross": ("_cross_fn", programs.CROSS_STATIC, programs.cross_key,
              dict(text_emb=torch.zeros((1, 64, 16)), precision="bf16",
                   latent_mask=torch.zeros((1, 448)))),
    "step": ("_step_fn", programs.STEP_STATIC, programs.step_key,
             dict(x=torch.zeros((1, 448, 8)), text_emb=torch.zeros((1, 64, 16)),
                  precision="bf16")),
    "vocoder": ("_vocoder_fn", programs.VOCODER_STATIC, programs.vocoder_key,
                dict(x=torch.zeros((1, 448, 8)), precision="bf16")),
}


@pytest.fixture(scope="module")
def jax_progress_engine(params, tiny_config, style):
    """A JAX engine whose progress closures have been built by one call."""
    from supertonic_tpu.engine import SynthesisEngine as JEngine
    from supertonic_tpu.engine import VoiceStyle as JVoiceStyle
    from supertonic_tpu.frontend import UnicodeProcessor as JProcessor
    from supertonic_tpu.frontend import build_default_indexer as j_indexer

    jeng = JEngine(params, tiny_config, JProcessor(j_indexer()), precision="f32")
    jeng.infer_with_progress(TEXTS[0], "en", JVoiceStyle(style.ttl, style.dp), total_step=2)
    return jeng


@pytest.mark.parametrize("name", sorted(PROGRESS_KEYS))
def test_progress_key_holds_the_jax_static_arguments(name, jax_progress_engine):
    """The JAX engine jits its progress closures with no static argument:
    the key holds the shapes of the arrays they take and the precision."""
    attr, static, key_fn, kwargs = PROGRESS_KEYS[name]
    assert getattr(jax_progress_engine, attr)._jit_info.static_argnames == static == ()
    base = key_fn(**kwargs)
    assert base == key_fn(**kwargs) and base[0] == name
    varied = [arg for arg in kwargs if key_fn(**dict(kwargs, **{arg: OTHER[arg]})) != base]
    assert set(varied) == set(kwargs)


def test_flow_key_holds_the_engine_halo():
    _b, _s, key_fn, kwargs = KEYS["flow"]
    assert key_fn(**dict(kwargs, halo=0)) != key_fn(**kwargs)


# ---------------------------------------------------------------------------
# bodies against JAX, speed a tensor
# ---------------------------------------------------------------------------

def _inputs(engine, style):
    dev_args, *_ = engine._prepare_inputs(TEXTS, ["en", "en"], style.tile(2))
    return dev_args, [jnp.asarray(a.numpy()) for a in dev_args]


@pytest.mark.parametrize("program", ["fused", "flow"])
def test_program_body_with_tensor_speed_matches_jax(program, params, mods, tiny_config,
                                                     engine, style):
    """The bodies the fused and flow programs capture, with speed a 0-dim
    tensor, on the noise JAX's synthesize_fused / flow_fused draw from their
    key: duration rtol 1e-6 and the same latent grid, audio and latent atol
    1e-4 (f32, sum order only; the tolerance of the engine test)."""
    cfg = tiny_config
    t_pad, steps = 512, 2
    dev_args, jargs = _inputs(engine, style)
    key = jax.random.PRNGKey(11)
    b = dev_args[0].shape[0]  # the batch bucket
    noise = np.array(jax.random.normal(key, (b, t_pad, cfg.latent_channels), jnp.float32))
    speed = torch.tensor(1.05, dtype=torch.float32)
    if program == "fused":
        jw, jd = JS.synthesize_fused(params, cfg, *jargs, key, jnp.float32(1.05), steps,
                                     t_pad, precision="f32", egress="f32")
        wav, dur = synthesis.synthesize_padded(mods, cfg, *dev_args, torch.as_tensor(noise),
                                               speed, steps, precision="f32")
        got, want = synthesis.encode_egress(wav, "f32"), np.asarray(jw)
    else:
        jx, jd, jm = JS.flow_fused(params, cfg, *jargs, key, jnp.float32(1.05), steps,
                                   t_pad, precision="f32")
        got, dur, fmask = synthesis.flow_padded(mods, cfg, *dev_args, torch.as_tensor(noise),
                                                speed, steps, precision="f32")
        want = np.asarray(jx)
        np.testing.assert_array_equal(fmask.numpy(), np.asarray(jm))
    jd = np.asarray(jd)
    np.testing.assert_allclose(dur.numpy(), jd, rtol=1e-6)
    lat = np.ceil(dur.numpy() * cfg.sample_rate / cfg.chunk_size)
    np.testing.assert_array_equal(lat, np.ceil(jd * cfg.sample_rate / cfg.chunk_size))
    assert lat[0] != lat[1] and lat.max() < t_pad and b > len(TEXTS)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_tensor_speed_keeps_the_duration_on_the_cpu(mods, tiny_config, engine, style):
    """On the CPU a float and a 0-dim tensor divide alike (CUDA alone
    multiplies by the reciprocal of a Python scalar)."""
    dev_args, _ = _inputs(engine, style)
    d_float, _ = synthesis.text_stage(mods, tiny_config, *dev_args, 1.05, precision="f32")
    d_tensor, _ = synthesis.text_stage(mods, tiny_config, *dev_args,
                                       engine._speed(1.05), precision="f32")
    assert engine._speed(1.05).dim() == 0
    torch.testing.assert_close(d_tensor, d_float, rtol=0, atol=0)


@pytest.mark.parametrize("halo", [0, 5])
def test_flow_fused_is_flow_padded_on_its_noise(mods, tiny_config, engine, style, halo):
    """flow_fused pads the latent and the frame mask with halo zero frames,
    as the flow program does for the windows."""
    cfg = tiny_config
    dev_args, _ = _inputs(engine, style)
    speed = engine._speed(1.05)
    xt, dur, fmask = synthesis.flow_fused(mods, cfg, *dev_args,
                                          torch.Generator().manual_seed(3), speed, 2, 64,
                                          precision="f32", halo=halo)
    b = dev_args[0].shape[0]
    noise = synthesis._noise(cfg, b, 64, torch.Generator().manual_seed(3), "cpu")
    x0, d0, m0 = synthesis.flow_padded(mods, cfg, *dev_args, noise, speed, 2,
                                       precision="f32")
    assert xt.shape == (b, 64 + 2 * halo, cfg.latent_channels)
    assert fmask.shape == (64 + 2 * halo,)
    torch.testing.assert_close(xt[:, halo:halo + 64], x0, rtol=0, atol=0)
    torch.testing.assert_close(fmask[halo:halo + 64], m0, rtol=0, atol=0)
    torch.testing.assert_close(dur, d0, rtol=0, atol=0)
    assert not xt[:, :halo].any() and not xt[:, 64 + halo:].any()
    assert not fmask[:halo].any() and not fmask[64 + halo:].any()


# ---------------------------------------------------------------------------
# static inputs: the noise draw and the window copy-in
# ---------------------------------------------------------------------------

def test_noise_drawn_into_a_static_buffer_equals_the_eager_noise(tiny_config):
    """Two draws into one preallocated buffer, from one generator, give the
    eager function's two draws from a generator of the same seed."""
    cfg = tiny_config
    gen, ref_gen = torch.Generator().manual_seed(21), torch.Generator().manual_seed(21)
    draw = programs.Draw((3, 40, cfg.latent_channels), torch.float32,
                         lambda out: synthesis._noise(cfg, 3, 40, gen, out.device, out=out))
    (buf,) = programs.static_like((draw,), "cpu")
    ptr = buf.data_ptr()
    for _ in range(2):
        programs.fill((buf,), (draw,))
        want = synthesis._noise(cfg, 3, 40, ref_gen, "cpu")
        assert buf.data_ptr() == ptr
        assert torch.equal(buf, want)


@pytest.mark.parametrize("precision,egress", [("f32", "f32"), ("f32", "int16"),
                                              ("bf16", "int16")])
def test_window_copy_in_equals_the_slice_at_every_start(params, tiny_config, precision,
                                                        egress):
    """The window program's form, one static window buffer filled by copy
    before each window and vocoded whole, bit-equal at every start of a
    chunk to vocoding the slice of the padded latent."""
    cfg = tiny_config
    mods = load_params(params, device="cpu", dtype=synthesis.dtype_of(precision))
    halo, w, t_len = receptive_field_frames(cfg), 16, 70
    rng = np.random.default_rng(4)
    xt = torch.as_tensor(rng.standard_normal((1, t_len, cfg.latent_channels)).astype(np.float32))
    fmask = (torch.arange(t_len) < 61).float()
    xt_pad = torch.nn.functional.pad(xt, (0, 0, halo, halo))
    m_pad = torch.nn.functional.pad(fmask, (halo, halo))
    span, chunk = w + 2 * halo, cfg.chunk_size
    static = None
    starts = sorted({max(0, min(k0, t_len - w)) for k0 in range(0, t_len, w)})
    assert len(starts) == 5
    for start in starts:
        inputs = synthesis.window_span(xt_pad, m_pad, start, w, halo)
        if static is None:
            static = programs.static_like(inputs, "cpu")
        programs.fill(static, inputs)
        got = synthesis.vocode_span(mods, cfg, *static, w, halo, precision=precision,
                                    egress=egress)
        wav = vocoder.apply(mods["vocoder"], cfg, xt_pad[:, start:start + span],
                            frame_mask=m_pad[start:start + span],
                            dtype=synthesis.dtype_of(precision))
        want = synthesis.encode_egress(wav[:, halo * chunk:(halo + w) * chunk], egress)
        assert got.dtype == want.dtype and torch.equal(got, want), start
        assert torch.equal(synthesis.vocode_window(mods, cfg, xt_pad, m_pad, start, w, halo,
                                                   precision=precision, egress=egress), want)
    with pytest.raises(ValueError, match="outside the padded latent"):
        synthesis.window_span(xt_pad, m_pad, t_len + 2 * halo - span + 1, w, halo)


# ---------------------------------------------------------------------------
# launch accounting, the capture lock, the CPU engine
# ---------------------------------------------------------------------------

def test_a_capture_records_launches_and_a_replay_credits_them():
    """Launches made while this thread captures go to the capture's record,
    not to the counts; another thread's go to the counts; crediting the
    record counts them and tallies their shapes."""
    ops.reset_launch_counts()
    shape = (2, 8, 64, 64, True)
    with ops.record_launches() as tally:
        with _count.capturing() as record:
            _count.launched("attention", shape)
            _count.launched("attention", shape)
            other = threading.Thread(target=_count.launched, args=("adaln_ffn", (2, 64, 512, 2048)))
            other.start()
            other.join()
        assert ops.launch_counts()["attention"] == 0
        assert ops.launch_counts()["adaln_ffn"] == 1
        assert record["attention"] == {shape: 2} and record["adaln_ffn"] == {}
        for _ in range(3):
            _count.credit(record)
    assert ops.launch_counts()["attention"] == 6
    assert tally["attention"] == {shape: 6} and tally["adaln_ffn"] == {(2, 64, 512, 2048): 1}
    _count.launched("attention", shape)  # the tally is closed
    assert tally["attention"] == {shape: 6} and ops.launch_counts()["attention"] == 7
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_launch_counts_lose_no_update_across_threads():
    """The batcher, egress and handler threads count launches and credit
    replays at once: no update is lost (more threads than cores, a short
    switch interval)."""
    import os
    import sys

    n_threads, n_each = 2 * (os.cpu_count() or 4), 500
    record = {"quantize": {(8, 512): 2}}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ops.reset_launch_counts()
        with ops.record_launches() as tally:
            def work():
                for _ in range(n_each):
                    _count.launched("quantize", (8, 512))
                    _count.credit(record)

            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert ops.launch_counts()["quantize"] == 3 * n_threads * n_each
    assert tally["quantize"] == {(8, 512): 3 * n_threads * n_each}
    ops.reset_launch_counts()


def test_the_capture_lock_captures_a_key_once():
    """Two threads that meet one key together get one capture; another key
    gets its own."""
    progs = programs.Programs(torch.device("cuda"))  # nothing touches the card here
    calls = []

    def capture(key, body, inputs):
        calls.append(key)
        time.sleep(0.2)  # the second thread arrives while this one captures
        return object()

    progs._capture = capture
    gate = threading.Barrier(2)
    got = [None, None]

    def meet(i):
        gate.wait()
        got[i] = progs._program(("fused", 1), None, ())

    threads = [threading.Thread(target=meet, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == [("fused", 1)] and got[0] is got[1] is not None
    assert progs._program(("fused", 1), None, ()) is got[0]
    progs._program(("flow", 1), None, ())
    assert calls == [("fused", 1), ("flow", 1)]


def test_programs_need_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        programs.Programs(torch.device("cpu"))


def test_cpu_engine_builds_no_program(engine, style, monkeypatch):
    """device="cpu" runs the synthesis functions eagerly: no Programs, and
    neither a batch nor a windowed stream reaches a capture."""
    def refuse(*args):
        raise AssertionError("a CPU engine captured a program")

    monkeypatch.setattr(programs.Programs, "_capture", refuse)
    monkeypatch.setattr(programs.Programs, "run", refuse)
    assert engine.programs is None and engine._synth is synthesis
    wav, dur = engine.infer_batch(TEXTS, ["en", "en"], style.tile(2), total_step=2)
    assert np.isfinite(wav).all() and wav.shape[0] == 2
    pieces = list(engine._vocode_stream(TEXTS[0], "en", style, 2, 3.0, 8))
    assert len(pieces) > 1 and pieces[-1][2]
    noise = np.zeros((2, 64, engine.cfg.latent_channels), np.float32)
    wav, _ = engine.infer_batch(TEXTS, ["en", "en"], style.tile(2), total_step=2, noise=noise)
    assert np.isfinite(wav).all()
    wav, _ = engine.infer_with_progress(TEXTS[0], "en", style, total_step=2)
    assert np.isfinite(wav).all()


# ---------------------------------------------------------------------------
# the progress and injected-noise programs' bodies, run eagerly on the CPU
# ---------------------------------------------------------------------------

class EagerPrograms(programs.Programs):
    """``Programs`` whose ``run`` calls the body eagerly on fresh copies of
    its inputs (the graph capture needs a card): what a replay computes,
    with each key recorded."""

    def __init__(self):
        self.keys = []

    def run(self, key, body, inputs):
        self.keys.append(key)
        static = programs.static_like(inputs, "cpu")
        programs.fill(static, inputs)
        return tuple(out.clone() for out in body(*static))


def _eager_programs_engine(params, cfg, **kw):
    eng = SynthesisEngine(params, cfg, UnicodeProcessor(build_default_indexer()),
                          device="cpu", **kw)
    eng.programs = eng._synth = EagerPrograms()
    return eng


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_progress_programs_equal_the_eager_path(params, tiny_config, engine, style,
                                                precision):
    """infer_with_progress through the text, cross, step and vocoder
    programs' bodies equals the eager path bit for bit with the same seed;
    the step program is one key replayed per step, and the callbacks fire
    in order after each step."""
    eng = _eager_programs_engine(params, tiny_config, precision=precision, seed=5)
    ref = SynthesisEngine(params, tiny_config, UnicodeProcessor(build_default_indexer()),
                          precision=precision, device="cpu", seed=5)
    seen = []
    wav, dur = eng.infer_with_progress(TEXTS[1], "en", style, total_step=3,
                                       progress_callback=lambda *a: seen.append(a))
    want_wav, want_dur = ref.infer_with_progress(TEXTS[1], "en", style, total_step=3)
    assert seen == [(1, 3), (2, 3), (3, 3)]
    np.testing.assert_array_equal(dur, want_dur)
    np.testing.assert_array_equal(wav, want_wav)
    kinds = [k[0] for k in eng.programs.keys]
    assert kinds == ["text", "cross", "step", "step", "step", "vocoder"]
    steps = [k for k in eng.programs.keys if k[0] == "step"]
    assert len(set(steps)) == 1 and steps[0][-1] is True  # fused_ffn
    t_bucket = steps[0][3]
    assert eng.programs.keys[-1] == ("vocoder", 1, t_bucket, precision, False)


def test_injected_noise_programs_match_jax(params, tiny_config, style):
    """infer_batch(noise=...) through the text and acoustic programs'
    bodies (the host syncs on the duration between them) against the JAX
    engine: duration rtol 1e-6 with the same latent grid, wav atol 1e-4."""
    from supertonic_tpu.engine import SynthesisEngine as JEngine
    from supertonic_tpu.engine import VoiceStyle as JVoiceStyle
    from supertonic_tpu.frontend import UnicodeProcessor as JProcessor
    from supertonic_tpu.frontend import build_default_indexer as j_indexer

    cfg = tiny_config
    noise = np.random.default_rng(3).standard_normal(
        (2, 256, cfg.latent_channels)).astype(np.float32)
    for fused_ffn in (False, True):
        eng = _eager_programs_engine(params, cfg, precision="f32", fused_ffn=fused_ffn)
        jeng = JEngine(params, cfg, JProcessor(j_indexer()), precision="f32",
                       fused_ffn=fused_ffn)
        w, d = eng.infer_batch(TEXTS, ["en", "en"], style.tile(2), total_step=2, noise=noise)
        jw, jd = jeng.infer_batch(TEXTS, ["en", "en"], JVoiceStyle(style.ttl, style.dp).tile(2),
                                  total_step=2, noise=noise)
        np.testing.assert_allclose(d, jd, rtol=1e-6)
        np.testing.assert_array_equal(np.ceil(d * cfg.sample_rate / cfg.chunk_size),
                                      np.ceil(jd * cfg.sample_rate / cfg.chunk_size))
        np.testing.assert_allclose(w, jw, rtol=0, atol=1e-4)
        text, acoustic = eng.programs.keys
        assert text[0] == "text" and acoustic[0] == "acoustic"
        assert acoustic[-2:] == (fused_ffn, False) and acoustic[4] == 2
