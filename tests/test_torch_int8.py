"""The port's W8A8 int8 path (``precision="int8"``) against the JAX package's,
on the CPU: the int8 product against the Pallas kernel (TPU interpret mode)
and against ``dot_general``, the per-token quantize pass and the weight
quantization and round trip bit for bit, the W8A8 ``linear`` (quantize pass,
then the product with its rescale-and-bias epilogue), the vector-estimator
step and the engine end to end. On CPU tensors the wrappers run their plain
versions; the CUDA kernels are held against those plain versions on the card
by chip_smoke.py."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from supertonic_tpu import models as jM
from supertonic_tpu.engine import SynthesisEngine as JEngine
from supertonic_tpu.engine import VoiceStyle as JVoiceStyle
from supertonic_tpu.frontend import UnicodeProcessor as JProcessor
from supertonic_tpu.frontend import build_default_indexer as j_indexer
from supertonic_tpu.models import layers as jL
from supertonic_tpu.models import vector_estimator as jve
from supertonic_tpu_torch import TTS, ops
from supertonic_tpu_torch import models as tM
from supertonic_tpu_torch.assets import flatten_tree
from supertonic_tpu_torch.assets import load_params as load_npz
from supertonic_tpu_torch.assets import save_params
from supertonic_tpu_torch.engine import SynthesisEngine, VoiceStyle
from supertonic_tpu_torch.frontend import UnicodeProcessor, build_default_indexer
from supertonic_tpu_torch.models import layers as tL
from supertonic_tpu_torch.models import vector_estimator as tve
from supertonic_tpu_torch.ops import int8_matmul as i8
from supertonic_tpu_torch.ops import quantize as qz
from supertonic_tpu_torch.ops import w8a8

ROOT = pathlib.Path(__file__).resolve().parent.parent
TEXTS = ["Hello there.", "A rather longer sentence, for a second row."]
DN = (((1,), (0,)), ((), ()))  # a [M, K] . b [K, N]


@pytest.fixture(scope="module", autouse=True)
def rate_dir(tmp_path_factory):
    """The engines' learned-rate cache in a fresh folder, never the user's."""
    with pytest.MonkeyPatch.context() as mp:
        d = tmp_path_factory.mktemp("rates")
        mp.setenv("TTS_RATE_CACHE_DIR", str(d))
        yield d


@pytest.fixture(scope="module")
def microbench():
    """tools/int8_microbench.py, a script: loaded from its file (importing it
    only sets the JAX compile-cache directory)."""
    spec = importlib.util.spec_from_file_location(
        "int8_microbench", ROOT / "tools" / "int8_microbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _assert_trees_equal(a, b, keys=None):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert fa.keys() == fb.keys()
    for k in keys or fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _de_zeroed(cfg):
    """init_all with the VE's zero-init heads and AdaLN gates de-zeroed, as
    chip_smoke.smoke_params does: with the zeros, the velocity is 0 and the
    quantized linears never reach the output."""
    p = tM.init_all(0, cfg)
    rng = np.random.default_rng(42)
    ve = p["vector_estimator"]
    for key in ("out_proj", "adaln_out"):
        ve[key]["w"] = (rng.standard_normal(ve[key]["w"].shape) * 0.05).astype(np.float32)
    for bp in ve["blocks"]:
        bp["adaln"]["w"] = (rng.standard_normal(bp["adaln"]["w"].shape) * 0.05).astype(np.float32)
    return p


# ---------------------------------------------------------------------------
# the int8 product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(512, 256, 512), (1024, 512, 512)])
def test_int8_matmul_equals_pallas_kernel(microbench, m, k, n):
    """Exact (atol 0): integer sums on both sides."""
    rng = np.random.default_rng(m + k)
    a, b = _i8(rng, (m, k)), _i8(rng, (k, n))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(microbench._pallas_i8_matmul(jnp.asarray(a), jnp.asarray(b)))
    assert ref.dtype == np.int32
    ops.reset_launch_counts()
    # the port's layout: w [N, K]
    got = i8.int8_matmul(torch.as_tensor(a), torch.as_tensor(np.ascontiguousarray(b.T)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ops.launch_counts()["int8_matmul"] == 0


@pytest.mark.parametrize("m,k,n", [(1, 32, 24), (37, 32, 24), (37, 2048, 24),
                                   (1, 512, 512), (37, 512, 7), (37, 512, 37)])
def test_int8_matmul_edge_shapes_equal_dot_general(m, k, n):
    """Shapes the 512 tiles of the Pallas kernel do not divide, against the
    product _linear_w8a8 uses; exact. An odd N is where the card's kernel
    stores from the registers, element by element."""
    rng = np.random.default_rng(m * n + k)
    a, b = _i8(rng, (m, k)), _i8(rng, (k, n))
    b[:, 0] = a[0] = 127  # the largest sum: 127^2 * K
    ref = np.asarray(jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), DN,
                                         preferred_element_type=jnp.int32))
    assert ref[0, 0] == 127 * 127 * k
    ops.reset_launch_counts()
    w = torch.as_tensor(np.ascontiguousarray(b.T))
    got = i8.int8_matmul(torch.as_tensor(a), w)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(i8.int8_matmul_plain(torch.as_tensor(a), w).numpy(), ref)
    assert ops.launch_counts()["int8_matmul"] == 0


def test_int8_matmul_wrapper_rejects_bad_operands():
    a = torch.zeros((4, 32), dtype=torch.int8)
    with pytest.raises(TypeError):
        i8.int8_matmul(a.float(), torch.zeros((8, 32), dtype=torch.int8))
    with pytest.raises(ValueError):
        i8.int8_matmul(a, torch.zeros((8, 64), dtype=torch.int8))
    with pytest.raises(ValueError):
        i8.int8_matmul(a[None], torch.zeros((8, 32), dtype=torch.int8))


# ---------------------------------------------------------------------------
# quantization and the weights
# ---------------------------------------------------------------------------

def _jax_quantize(x):
    """The activation quantization of the JAX ``_linear_w8a8``
    (supertonic_tpu/models/layers.py:83-85), its own operations run eagerly
    as ``jL.linear`` runs them; sx as [M]."""
    xf = x.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) / 127.0
    xq = jnp.round(xf / sx).astype(jnp.int8)
    return np.asarray(xq), np.asarray(sx[:, 0])


# rows 0 and 1 of the "edges" case: a zero row (the 1e-12 clamp), and a row
# whose amax is 127, so sx = 1 exactly and x / sx lands on x.5 (half to even)
HALVES = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 4.5]
HALVES_Q = [127, 2, -4, 0, 0, 2, -126, 4]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,k", [("random", 32), ("random", 512), ("edges", 512),
                                    ("random", 2048)])
def test_quantize_rows_bit_equal_to_jax(dtype, case, k):
    """The plain quantize pass (which the card holds the kernel to, bit for
    bit) gives JAX's sx and xq exactly, and the amax element of each row
    maps to +-127."""
    rng = np.random.default_rng(k)
    x = (rng.standard_normal((37, k)) * 3).astype(np.float32)
    if case == "edges":
        x[0] = 0.0
        x[1] = 0.0
        x[1, :len(HALVES)] = HALVES
    xt = torch.as_tensor(x).to(dtype)
    held = xt.float().numpy()  # the values as dtype holds them
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref_q, ref_s = _jax_quantize(jnp.asarray(held, jdt))
    ops.reset_launch_counts()
    xq, sx = qz.quantize_rows(xt)
    assert ops.launch_counts()["quantize"] == 0
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32
    assert tuple(xq.shape) == (37, k) and tuple(sx.shape) == (37,)
    np.testing.assert_array_equal(sx.numpy(), ref_s)
    np.testing.assert_array_equal(xq.numpy(), ref_q)
    rows = np.nonzero(np.abs(held).max(1) > 0)[0]
    at_max = xq.numpy()[rows, np.abs(held[rows]).argmax(1)]
    np.testing.assert_array_equal(np.abs(at_max.astype(np.int32)), 127)
    if case == "edges":
        assert float(sx[0]) == np.float32(1e-12) / np.float32(127) and not xq[0].any()
        assert float(sx[1]) == 1.0
        np.testing.assert_array_equal(xq[1, :len(HALVES)].numpy(), HALVES_Q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(37, 2048, 24), (1, 32, 512), (130, 512, 96),
                                   (37, 512, 7)])
def test_w8a8_linear_wrappers_bit_equal_to_jax(dtype, m, k, n):
    """The W8A8 ``linear`` built from the new wrappers' plain versions
    (quantize pass, then the product with its rescale-and-bias epilogue) is
    bit-equal to the JAX ``_linear_w8a8``, a zero row included; the
    epilogue alone is bit-equal to the plain f32 operations on the exact
    int32 product."""
    rng = np.random.default_rng(m + k + n)
    p = {"w": (rng.standard_normal((k, n)) * 0.05).astype(np.float32),
         "b": (rng.standard_normal(n) * 0.1).astype(np.float32)}
    q = jL.quantize_linear(p)
    mod = tL.tree_to_modules(q, device="cpu")
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    x[0] = 0.0
    xt = torch.as_tensor(x).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(jL.linear(q, jnp.asarray(xt.float().numpy(), jdt)).astype(jnp.float32))
    ops.reset_launch_counts()
    got = tL.linear(mod, xt)
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    xq, sx = qz.quantize_rows(xt)
    acc = i8.int8_matmul(xq, mod.w_q).float()
    y = w8a8.w8a8_matmul(xq, sx, mod.w_q, mod.w_scale, mod.bias, dtype)
    np.testing.assert_array_equal(y.float().numpy(),
                                  ((acc * sx[:, None] * mod.w_scale + mod.bias).to(dtype))
                                  .float().numpy())
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


def test_w8a8_wrappers_reject_bad_operands():
    xq = torch.zeros((4, 32), dtype=torch.int8)
    w = torch.zeros((8, 32), dtype=torch.int8)
    sx, ws, b = torch.ones(4), torch.ones(8), torch.zeros(8)
    with pytest.raises(TypeError):
        qz.quantize_rows(torch.zeros((4, 32), dtype=torch.float16))
    with pytest.raises(ValueError):
        qz.quantize_rows(torch.zeros((2, 4, 32)))
    with pytest.raises(ValueError):
        w8a8.w8a8_matmul(xq, sx, torch.zeros((8, 64), dtype=torch.int8), ws, b,
                         torch.float32)
    with pytest.raises(ValueError):
        w8a8.w8a8_matmul(xq, sx[:3], w, ws, b, torch.float32)
    with pytest.raises(TypeError):
        w8a8.w8a8_matmul(xq, sx, w, ws, b, torch.float16)
    with pytest.raises(TypeError):
        w8a8.w8a8_matmul(xq.float(), sx, w, ws, b, torch.float32)


def test_quantize_linear_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    p = {"w": (rng.standard_normal((64, 96)) * 0.05).astype(np.float32),
         "b": rng.standard_normal(96).astype(np.float32)}
    p["w"][:, 5] = 0.0  # a zero column takes the 1e-12 floor
    _assert_trees_equal(jL.quantize_linear(p), tL.quantize_linear(p))


@pytest.mark.parametrize("fused", [False, True])
def test_quantize_params_bit_equal_to_jax(tiny_config, fused):
    a, b = jM.init_all(0, tiny_config), tM.init_all(0, tiny_config)
    if fused:
        a, b = jM.fuse_projections(a), tM.fuse_projections(b)
        _assert_trees_equal(a, b)
        assert "qkv" in b["vector_estimator"]["blocks"][0]["self"]
    qa, qb = jM.quantize_params(a), tM.quantize_params(b)
    _assert_trees_equal(qa, qb)
    assert qb["vector_estimator"]["blocks"][0]["ffn"]["in"]["w_q"].dtype == np.int8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_weights_carry_across(tiny_config, dtype):
    """load_params then to_numpy_tree: int8 w_q and f32 w_scale / b exactly,
    in the JAX layout, whatever the compute dtype."""
    q = tM.quantize_params(tM.init_all(0, tiny_config))
    mods = tM.load_params(q, device="cpu", dtype=dtype)
    leaf = mods["vector_estimator"]["blocks"][0]["ffn"]["in"]
    assert isinstance(leaf, tL.QLinear)
    din, dout = q["vector_estimator"]["blocks"][0]["ffn"]["in"]["w_q"].shape
    assert leaf.w_q.dtype == torch.int8 and tuple(leaf.w_q.shape) == (dout, din)
    assert leaf.w_scale.dtype == leaf.bias.dtype == torch.float32
    back = tM.to_numpy_tree(mods)
    flat = flatten_tree(q)
    quantized = [k for k in flat if k.rsplit("/", 1)[-1] in ("w_q", "w_scale")
                 or (k.endswith("/b") and k[:-1] + "w_q" in flat)]
    assert len(quantized) == 3 * 10 * tiny_config.vector_estimator.n_layers
    _assert_trees_equal(q, back, keys=None if dtype == torch.float32 else quantized)


def test_params_npz_keeps_int8(tiny_config, tmp_path):
    q = tM.quantize_params(tM.fuse_projections(tM.init_all(0, tiny_config)))
    path = tmp_path / "params.npz"
    save_params(str(path), q)
    _assert_trees_equal(q, load_npz(str(path)))


# ---------------------------------------------------------------------------
# the W8A8 linear and the vector-estimator step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 7, 64), (300, 64)])
def test_w8a8_linear_matches_jax(shape):
    """f32 input: within 1 ulp (the same operations in the same order);
    bf16 input: exact in bf16."""
    rng = np.random.default_rng(len(shape))
    p = {"w": (rng.standard_normal((64, 96)) * 0.05).astype(np.float32),
         "b": (rng.standard_normal(96) * 0.1).astype(np.float32)}
    q = jL.quantize_linear(p)
    mod = tL.tree_to_modules(q, device="cpu")
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    ref = np.asarray(jL.linear(q, jnp.asarray(x)))
    got = tL.linear(mod, torch.as_tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), ref, maxulp=1)
    ref_bf = np.asarray(jL.linear(q, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got_bf = tL.linear(mod, torch.as_tensor(x).to(torch.bfloat16))
    assert got_bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_bf.float().numpy(), ref_bf)


@pytest.mark.parametrize("fused", [False, True])
def test_vector_estimator_step_int8_matches_jax(tiny_config, fused):
    """f32 step with quantized, de-zeroed params: port against JAX at 1e-4,
    and not equal to the unquantized step (the quantized linears reach the
    output)."""
    cfg = tiny_config
    params = _de_zeroed(cfg)
    if fused:
        params = tM.fuse_projections(params)
    ve = params["vector_estimator"]
    qve = tM.quantize_params(params)["vector_estimator"]
    rng = np.random.default_rng(5)
    b, t, l = 2, 16, 12
    latent = rng.standard_normal((b, t, cfg.latent_channels)).astype(np.float32)
    emb = rng.standard_normal((b, l, cfg.ttl.proj_out_odim)).astype(np.float32)
    style = rng.standard_normal(
        (b, cfg.ttl.style.n_style, cfg.ttl.style.style_value_dim)).astype(np.float32)
    tmask = (np.arange(l)[None] < np.array([[l], [l - 3]])).astype(np.float32)
    lmask = (np.arange(t)[None] < np.array([[t], [t - 5]])).astype(np.float32)
    cur, tot = np.array([0.0, 2.0], np.float32), np.full((b,), 4.0, np.float32)
    args = (latent, emb, style, tmask, lmask, cur, tot)
    ref = np.asarray(jax.jit(lambda p: jve.step(p, cfg, *map(jnp.asarray, args)))(
        jax.tree_util.tree_map(jnp.asarray, qve)))
    targs = [torch.as_tensor(a) for a in args]
    got = tve.step(tM.load_params(qve, device="cpu"), cfg, *targs).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    plain = tve.step(tM.load_params(ve, device="cpu"), cfg, *targs).numpy()
    assert not np.array_equal(got, plain)


# ---------------------------------------------------------------------------
# the engine end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def style_arrays(tiny_config):
    rng = np.random.default_rng(7)
    cfg = tiny_config
    return (rng.standard_normal((1, cfg.ttl.style.n_style,
                                 cfg.ttl.style.style_value_dim)).astype(np.float32),
            rng.standard_normal((1, cfg.dp.style.n_style,
                                 cfg.dp.style.style_value_dim)).astype(np.float32))


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _infer(engine, style_cls, style_arrays, noise):
    return engine.infer_batch(TEXTS, ["en", "en"], style_cls(*style_arrays).tile(2),
                              total_step=2, noise=noise)


def _noise(cfg):
    return np.random.default_rng(3).standard_normal(
        (2, 256, cfg.latent_channels)).astype(np.float32)


def _jax_run(params, cfg, style_arrays, precision):
    eng = JEngine(params, cfg, JProcessor(j_indexer()), precision=precision)
    return _infer(eng, JVoiceStyle, style_arrays, _noise(cfg))


def _port_run(params, cfg, style_arrays, precision):
    eng = SynthesisEngine(params, cfg, UnicodeProcessor(build_default_indexer()),
                          precision=precision, device="cpu")
    w, d = _infer(eng, VoiceStyle, style_arrays, _noise(cfg))
    assert np.isfinite(w).all()
    return w, d


def test_engine_int8_matches_jax_int8_engine(tiny_config, style_arrays):
    """Injected noise, 2 steps. Both sides run bf16 outside the quantized
    linears; the port's attention keeps f32 logits where the JAX XLA path
    stores them in bf16, and the bf16 vocoder's last roundings leave the wav
    a floor of ~0.006 relative L2 between any two bf16 runs that differ
    anywhere upstream (0.0058 between the JAX engine's own two attention
    paths). Read: durations equal, wav relative L2 0.0089 (0.0086 for the
    bf16 paths); held to the same latent grid, durations within rtol 1e-2
    and about 3x the wav reading. The test below separates int8 from bf16."""
    cfg = tiny_config
    params = _de_zeroed(cfg)
    jw, jd = _jax_run(params, cfg, style_arrays, "int8")
    w, d = _port_run(params, cfg, style_arrays, "int8")
    assert w.shape == jw.shape
    lat = np.ceil(d * cfg.sample_rate / cfg.chunk_size)
    np.testing.assert_array_equal(lat, np.ceil(jd * cfg.sample_rate / cfg.chunk_size))
    dur_rel = float(np.max(np.abs(d - jd) / np.abs(jd)))
    wav_rel = _rel_l2(w, jw)
    msg = f"int8 port vs JAX: duration rel {dur_rel:.3e}, wav rel L2 {wav_rel:.4f}"
    assert dur_rel <= 1e-2, msg
    assert wav_rel <= 0.03, msg


def test_engine_w8a8_in_f32_is_nearer_jax_w8a8_than_unquantized(tiny_config,
                                                              style_arrays):
    """The engines in f32 on a tree quantized beforehand (both load a tree
    that holds ``w_q`` as it is), so no bf16 rounding hides the
    quantization: the port's wav is within 3e-4 of JAX's W8A8 wav (read:
    1.0e-4, from rounding ties that an f32 ulp flips) and at least 5x
    nearer to it than to JAX's unquantized wav (read: 1.6e-3 away, 16x)."""
    cfg = tiny_config
    params = _de_zeroed(cfg)
    qparams = tM.quantize_params(params)
    w, d = _port_run(qparams, cfg, style_arrays, "f32")
    jw_q, jd_q = _jax_run(qparams, cfg, style_arrays, "f32")
    jw, _ = _jax_run(params, cfg, style_arrays, "f32")
    np.testing.assert_allclose(d, jd_q, rtol=1e-5)
    to_q, to_plain = _rel_l2(w, jw_q), _rel_l2(w, jw)
    msg = f"wav rel L2 to JAX W8A8 {to_q:.3e}, to JAX unquantized {to_plain:.3e}"
    assert to_q <= 3e-4, msg
    assert 5 * to_q < to_plain, msg


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_engine_fused_projections_equal_unfused(tiny_config, style_arrays, precision):
    """A fused tree (``fuse_projections``, quantized at init in int8) gives
    the unfused engine's wav and durations bit for bit on the CPU: each
    fused output column is the same dot product, and the W8A8 scales are
    per output column."""
    cfg = tiny_config
    params = _de_zeroed(cfg)
    w, d = _port_run(params, cfg, style_arrays, precision)
    wf, df = _port_run(tM.fuse_projections(params), cfg, style_arrays, precision)
    np.testing.assert_array_equal(df, d)
    np.testing.assert_array_equal(wf, w)


def test_tts_int8_on_cpu_skips_the_fused_ffn(tiny_config, monkeypatch):
    """TTS(precision="int8") answers a request; the quantized VE blocks do
    not reach the fused AdaLN-FFN, and every W8A8 linear goes through the
    W8A8 product's wrapper: 8 per block and step, 2 per block for the cross
    K/V; the quantize wrapper runs once for the linears that share an input
    (cross K and V: 1 per block) and once for each self and cross O (2 per
    block and step): the LayerNorms before self Q, K and V, cross Q and the
    FFN-in write their (xq, sx) themselves (3 per block and step), and the
    FFN-in's silu form quantizes the FFN-out's input."""
    calls = {"adaln_ffn": 0, "quantize": 0, "ln_modulate_quantize": 0, "w8a8_matmul": 0}

    def counted(name, real):
        def f(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        return f

    monkeypatch.setattr(tL, "fused_adaln_ffn", counted("adaln_ffn", tL.fused_adaln_ffn))
    monkeypatch.setattr(tL, "quantize_rows", counted("quantize", tL.quantize_rows))
    monkeypatch.setattr(tL, "ln_modulate_quantize",
                        counted("ln_modulate_quantize", tL.ln_modulate_quantize))
    monkeypatch.setattr(tL, "w8a8_matmul", counted("w8a8_matmul", tL.w8a8_matmul))
    tts = TTS(device="cpu", cfg=tiny_config, precision="int8")
    assert tts.engine.precision == "int8" and tts.engine.dtype == torch.bfloat16
    style = tts.get_voice_style("M1")
    wav, dur = tts.synthesize("Hello world, this is the int8 path.", style, total_step=2)
    assert wav.shape[0] == 1 and np.isfinite(wav).all()
    assert abs(wav.shape[1] - int(tiny_config.sample_rate * float(dur[0]))) <= 1
    n_layers = tiny_config.vector_estimator.n_layers
    n_linears = n_layers * (8 * 2 + 2)
    assert calls == {"adaln_ffn": 0, "quantize": n_layers * (2 * 2 + 1),
                     "ln_modulate_quantize": n_layers * 3 * 2, "w8a8_matmul": n_linears}


def test_int8_entry_points_default_to_cuda(tiny_config):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTS(cfg=tiny_config, precision="int8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SynthesisEngine(tM.init_all(0, tiny_config), tiny_config,
                        UnicodeProcessor(build_default_indexer()), precision="int8")
    with pytest.raises(ValueError, match="precision"):
        SynthesisEngine(tM.init_all(0, tiny_config), tiny_config,
                        UnicodeProcessor(build_default_indexer()), precision="int4",
                        device="cpu")
