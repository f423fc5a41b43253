"""The port's device mesh on the CPU (``supertonic_tpu_torch/parallel/mesh.py``
and ``SynthesisEngine(mesh=...)``): mesh shapes, the TP layout leaf by leaf
against JAX's, the data-parallel and tensor-parallel engines against the
port's single-device engine with the same seed (durations 1e-6, wav 3e-5;
TP 5e-5, the JAX mesh tests' bounds) and against the JAX mesh engines on
injected noise (durations rtol 1e-6, wav atol 1e-4, as
tests/test_torch_engine.py), the same noise drawn, every W8A8 linear of
a vector-estimator block bit-equal sharded and unsharded, the head
divisibility error, the batcher and the HTTP server over a ``[cpu] * 8``
mesh, the graph backend under a mesh, and windowed streaming off under a
mesh. A mesh of one repeated device runs the sharding logic and the
plain versions of the kernels at their sharded shapes."""

import concurrent.futures
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from supertonic_tpu.engine import SynthesisEngine as JEngine
from supertonic_tpu.engine import VoiceStyle as JVoiceStyle
from supertonic_tpu.frontend import UnicodeProcessor as JProcessor
from supertonic_tpu.frontend import build_default_indexer as j_indexer
from supertonic_tpu.parallel import make_mesh as j_make_mesh
from supertonic_tpu.parallel import param_pspecs as j_param_pspecs
from supertonic_tpu_torch.engine import SynthesisEngine, VoiceStyle, synthesis
from supertonic_tpu_torch.frontend import UnicodeProcessor, build_default_indexer
from supertonic_tpu_torch.models import init_all, layers as L, load_params, quantize_params
from supertonic_tpu_torch.parallel import (Mesh, batch_sharding, make_mesh,
                                           pad_batch_to_multiple, param_pspecs,
                                           shard_batch, shard_params)

from test_onnx_pipeline import onnx_dir  # noqa: F401  (module fixture)

CPU8 = ["cpu"] * 8
TEXTS = [f"Utterance number {i} for the mesh test." + " More words." * (i % 3)
         for i in range(8)]


@pytest.fixture(scope="module", autouse=True)
def rate_dir(tmp_path_factory):
    """The engines' learned-rate cache in a fresh folder, never the user's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTS_RATE_CACHE_DIR", str(tmp_path_factory.mktemp("rates")))
        if getattr(sys.modules.get("onnxruntime"), "__spec__", True) is None:
            # a stub left by tests/test_reference_differential.py (see
            # tests/test_torch_onnx_backend.py)
            mp.delitem(sys.modules, "onnxruntime")
        mp.delenv("TTS_ONNX_FUSED", raising=False)
        mp.delenv("TTS_ONNX_BF16", raising=False)
        yield


@pytest.fixture(scope="module")
def params(tiny_config):
    """init_all with the AdaLN-Zero outputs perturbed, so that the vector
    estimator moves the latent (as tests/test_torch_engine.py)."""
    p = init_all(0, tiny_config)
    rng = np.random.default_rng(42)
    ve = p["vector_estimator"]
    for key in ("out_proj", "adaln_out"):
        ve[key]["w"] = (rng.standard_normal(ve[key]["w"].shape) * 0.05).astype(np.float32)
    for bp in ve["blocks"]:
        bp["adaln"]["w"] = (rng.standard_normal(bp["adaln"]["w"].shape) * 0.05).astype(np.float32)
    return p


def _style(cfg, n, seed=7):
    rng = np.random.default_rng(seed)
    ttl = rng.standard_normal((n, cfg.ttl.style.n_style,
                               cfg.ttl.style.style_value_dim)).astype(np.float32)
    dp = rng.standard_normal((n, cfg.dp.style.n_style,
                              cfg.dp.style.style_value_dim)).astype(np.float32)
    return VoiceStyle(ttl, dp)


def _engine(params, cfg, *, mesh=None, **kw):
    kw.setdefault("precision", "f32")
    kw.setdefault("egress_format", "f32")
    if mesh is None:
        kw.setdefault("device", "cpu")
    eng = SynthesisEngine(params, cfg, UnicodeProcessor(build_default_indexer()),
                          mesh=mesh, **kw)
    eng._pin_rate(1.0 / 11.0)
    return eng


# ---------------------------------------------------------------------------
# the mesh and the layout
# ---------------------------------------------------------------------------

def test_mesh_shapes():
    mesh = make_mesh(devices=CPU8)
    assert isinstance(mesh, Mesh)
    assert mesh.shape == {"data": 8, "model": 1}
    assert make_mesh(devices=CPU8, model_parallel=2).shape == {"data": 4, "model": 2}
    assert make_mesh(4, devices=CPU8).shape == {"data": 4, "model": 1}
    mesh = make_mesh(devices=CPU8, model_parallel=4)
    assert mesh.row(1) == [torch.device("cpu")] * 4
    assert mesh.leads == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(devices=["cpu"] * 6, model_parallel=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_batch_helpers():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert batch_sharding(mesh, 3) == ("data", None, None)
    a = np.arange(24, dtype=np.int32).reshape(8, 3)
    b = np.ones((8,), np.float32)
    parts_a, parts_b = shard_batch(mesh, a, b)
    assert [p.shape for p in parts_a] == [(2, 3)] * 4 and parts_a[0].dtype == torch.int32
    np.testing.assert_array_equal(torch.cat(parts_a).numpy(), a)
    assert len(parts_b) == 4
    with pytest.raises(ValueError, match="divide"):
        shard_batch(mesh, np.zeros((6, 2)))
    assert pad_batch_to_multiple(5, 4) == 8 and pad_batch_to_multiple(8, 4) == 8


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


@pytest.mark.parametrize("quantized", [False, True])
def test_param_pspecs_equal_jax(params, quantized):
    tree = quantize_params(params) if quantized else params
    want = dict(_leaves(j_param_pspecs(tree)))
    got = dict(_leaves(param_pspecs(tree)))
    assert want.keys() == got.keys()
    for path in want:
        assert tuple(want[path]) == got[path], path
    ve = param_pspecs(tree)["vector_estimator"]["blocks"][0]
    w = "w_q" if quantized else "w"
    assert ve["self"]["q"][w] == (None, "model") and ve["self"]["o"][w] == ("model", None)
    assert ve["ffn"]["in"]["b"] == ("model",) and ve["ffn"]["out"]["b"] == ()


def test_shard_params_places_each_ranks_slice(params, tiny_config):
    mesh = make_mesh(devices=CPU8, model_parallel=2)
    rows = shard_params(params, mesh)
    assert len(rows) == 4
    blk = rows[0]["vector_estimator"]["blocks"][0]
    q, o = blk["self"]["q"], blk["self"]["o"]
    assert isinstance(q, L.ShardedLinear) and q.split == "col" and o.split == "row"
    d = tiny_config.vector_estimator.dim
    assert tuple(q.shards[0].weight.shape) == (d // 2, d)
    assert tuple(o.shards[1].weight.shape) == (d, d // 2)
    assert isinstance(rows[0]["vector_estimator"]["in_proj"], L.Linear)
    # the replica is the unsharded tree again
    from supertonic_tpu_torch.models import to_numpy_tree

    back = dict(_leaves(to_numpy_tree(rows[3])))
    for path, arr in _leaves(params):
        np.testing.assert_array_equal(back[path], arr, err_msg=str(path))


def test_tensor_parallel_needs_whole_heads(params, tiny_config):
    """A rank runs whole heads: the tiny config's 2 heads do not split 4
    ways (GSPMD accepts it, tests/test_engine_mesh.py), and fused
    projections have no per-rank column slice."""
    from supertonic_tpu_torch.models import fuse_projections

    with pytest.raises(ValueError, match="n_heads"):
        _engine(params, tiny_config, mesh=make_mesh(devices=CPU8, model_parallel=4))
    mesh = make_mesh(devices=["cpu"] * 2, model_parallel=2)
    with pytest.raises(ValueError, match="fused projections"):
        shard_params(fuse_projections(params), mesh)
    assert len(shard_params(fuse_projections(params), make_mesh(devices=["cpu"] * 2))) == 2


# ---------------------------------------------------------------------------
# the mesh engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single(params, tiny_config):
    return _engine(params, tiny_config, seed=3)


@pytest.mark.parametrize("model,atol", [(1, 3e-5), (2, 5e-5)])
def test_mesh_engine_matches_single_device(params, tiny_config, single, model, atol):
    eng = _engine(params, tiny_config, seed=3,
                  mesh=make_mesh(devices=CPU8, model_parallel=model))
    single._seed_chain.manual_seed(3)
    style = _style(tiny_config, 8)
    w1, d1 = single.batch(TEXTS, ["en"] * 8, style, total_step=2)
    w2, d2 = eng.batch(TEXTS, ["en"] * 8, style, total_step=2)
    np.testing.assert_allclose(d1, d2, atol=1e-6)
    assert [len(a) for a in w1] == [len(b) for b in w2]
    for a, b in zip(w1, w2):
        np.testing.assert_allclose(a, b, atol=atol)


def test_mesh_draws_the_single_device_noise(params, tiny_config, single, monkeypatch):
    """The whole batch's noise is drawn once, on the lead device, from the
    dispatch generator: the same numbers as the single-device engine."""
    drawn = []
    real = synthesis._noise

    def spy(*a, **k):
        out = real(*a, **k)
        drawn.append(out.clone())
        return out

    monkeypatch.setattr(synthesis, "_noise", spy)
    eng = _engine(params, tiny_config, seed=3, mesh=make_mesh(devices=CPU8))
    single._seed_chain.manual_seed(3)
    style = _style(tiny_config, 8)
    single.infer_batch(TEXTS, ["en"] * 8, style, total_step=2)
    eng.infer_batch(TEXTS, ["en"] * 8, style, total_step=2)
    assert len(drawn) == 2 and drawn[0].shape[0] >= 8
    torch.testing.assert_close(drawn[0], drawn[1], rtol=0, atol=0)


@pytest.mark.parametrize("model", [1, 2])
def test_mesh_engine_matches_the_jax_mesh_engine(params, tiny_config, model):
    """Injected noise: the port's mesh engine against the JAX engine on the
    8-device mesh (``model=2``: TP over the heads)."""
    cfg = tiny_config
    style = _style(cfg, 8)
    noise = np.random.default_rng(3).standard_normal(
        (8, 128, cfg.latent_channels)).astype(np.float32)
    jeng = JEngine(params, cfg, JProcessor(j_indexer()), precision="f32",
                   mesh=j_make_mesh(8, model_parallel=model))
    jw, jd = jeng.infer_batch(TEXTS, ["en"] * 8, JVoiceStyle(style.ttl, style.dp),
                              total_step=2, noise=noise)
    eng = _engine(params, cfg, mesh=make_mesh(devices=CPU8, model_parallel=model))
    w, d = eng.infer_batch(TEXTS, ["en"] * 8, style, total_step=2, noise=noise)
    np.testing.assert_allclose(d, jd, rtol=1e-6)
    assert w.shape == jw.shape
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-4)


def test_injected_noise_and_progress_match_single_device(params, tiny_config, single):
    cfg = tiny_config
    eng = _engine(params, cfg, mesh=make_mesh(devices=CPU8, model_parallel=2))
    style = _style(cfg, 8)
    noise = np.random.default_rng(5).standard_normal(
        (8, 128, cfg.latent_channels)).astype(np.float32)
    w1, d1 = single.infer_batch(TEXTS, ["en"] * 8, style, total_step=2, noise=noise)
    w2, d2 = eng.infer_batch(TEXTS, ["en"] * 8, style, total_step=2, noise=noise)
    np.testing.assert_allclose(d1, d2, atol=1e-6)
    np.testing.assert_allclose(w1, w2, atol=5e-5)
    one = style.take(slice(0, 1))
    single._seed_chain.manual_seed(9)
    eng._seed_chain.manual_seed(9)
    seen = []
    p1, e1 = single.infer_with_progress(TEXTS[1], "en", one, total_step=3)
    p2, e2 = eng.infer_with_progress(TEXTS[1], "en", one, total_step=3,
                                     progress_callback=lambda i, n: seen.append((i, n)))
    assert seen == [(1, 3), (2, 3), (3, 3)]
    np.testing.assert_allclose(e1, e2, atol=1e-6)
    np.testing.assert_allclose(p1, p2, atol=5e-5)


def _w8a8_inputs(cfg, dim, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (3, 5, dim)).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_w8a8_linears_bit_equal_under_tensor_parallelism(params, tiny_config, dtype):
    """Every W8A8 linear of a vector-estimator block, column-parallel (q,
    k, v, ffn.in) and row-parallel (o, ffn.out: the activation's amax over
    the whole row, the int32 partials summed exactly, one rescale), equals
    its unsharded form bit for bit."""
    qtree = quantize_params(params)
    mesh = make_mesh(devices=["cpu"] * 2, model_parallel=2)
    (row,) = shard_params(qtree, mesh, dtype=dtype)
    full = load_params(qtree, device="cpu", dtype=dtype)
    for b in range(len(qtree["vector_estimator"]["blocks"])):
        sb = row["vector_estimator"]["blocks"][b]
        fb = full["vector_estimator"]["blocks"][b]
        pairs = [(sb[sub][k], fb[sub][k]) for sub in ("self", "cross")
                 for k in ("q", "k", "v", "o")] + [(sb["ffn"][k], fb["ffn"][k])
                                                   for k in ("in", "out")]
        for i, (sharded, whole) in enumerate(pairs):
            assert isinstance(whole, L.QLinear)
            x = _w8a8_inputs(tiny_config, whole.w_q.shape[1], 10 * b + i).to(dtype)
            want = L.linear(whole, x)
            if sharded.split == "col":
                got = torch.cat(L.col_linear(sharded, x), dim=-1)
            else:
                xs = list(x.chunk(2, dim=-1))
                got = L.row_linear(sharded, xs, x.device)
            assert got.dtype == dtype
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_int8_tensor_parallel_engine(params, tiny_config):
    """The W8A8 path under TP: bit-equal linears, so the int8 TP engine
    stays close to the single-device int8 engine (the attention and the
    partial sums of the bf16 parts differ in order only)."""
    cfg = tiny_config
    style = _style(cfg, 4)
    noise = np.random.default_rng(11).standard_normal(
        (4, 128, cfg.latent_channels)).astype(np.float32)
    a = _engine(params, cfg, precision="int8")
    b = _engine(params, cfg, precision="int8",
                mesh=make_mesh(devices=["cpu"] * 4, model_parallel=2))
    w1, d1 = a.infer_batch(TEXTS[:4], ["en"] * 4, style, total_step=2, noise=noise)
    w2, d2 = b.infer_batch(TEXTS[:4], ["en"] * 4, style, total_step=2, noise=noise)
    assert np.isfinite(w2).all()
    np.testing.assert_allclose(d1, d2, rtol=1e-2)
    assert float(np.sqrt(np.mean((w1 - w2) ** 2)) / np.sqrt(np.mean(w1 ** 2))) < 0.05


# ---------------------------------------------------------------------------
# serving over the mesh
# ---------------------------------------------------------------------------

def test_batcher_over_mesh(params, tiny_config):
    from supertonic_tpu_torch.parallel.batcher import ContinuousBatcher

    eng = _engine(params, tiny_config, mesh=make_mesh(devices=CPU8), egress_format="int16")
    batcher = ContinuousBatcher(eng, max_batch=8, max_wait_ms=5)
    try:
        futs = [batcher.submit(f"Mesh batcher request {i}.", "en",
                               _style(tiny_config, 1, seed=i), total_step=2)
                for i in range(12)]
        for f in futs:
            wav, dur = f.result(timeout=300)
            assert wav.ndim == 1 and dur > 0 and np.isfinite(wav).all()
        assert batcher.stats["batches"] < 12
    finally:
        batcher.shutdown()


def test_http_soak_over_mesh(params, tiny_config):
    """HTTP server -> batcher -> mesh engine, concurrent clients."""
    import httpx

    from supertonic_tpu_torch import TTS
    from supertonic_tpu_torch.assets import Assets
    from supertonic_tpu_torch.serve.http_server import make_server

    tts = TTS.__new__(TTS)
    tts.assets = Assets(tiny_config, params, UnicodeProcessor(build_default_indexer()), None)
    tts.cfg = tiny_config
    tts.engine = _engine(params, tiny_config, mesh=make_mesh(devices=CPU8),
                         egress_format="int16")
    server = make_server(tts, "127.0.0.1", 0, use_batcher=True, max_batch=8)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        def one(i):
            with httpx.Client(timeout=300) as c:
                r = c.post(f"{base}/tts", json={"text": f"Mesh soak request number {i}.",
                                                 "total_step": 2})
                assert r.status_code == 200, r.text
                return len(r.content)

        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
            sizes = list(pool.map(one, range(24)))
        assert all(s > 44 for s in sizes)
        stats = server.service.batcher.stats
        assert stats["batched_requests"] >= 24 and stats["batches"] < 24
        # the first chunk of a stream is a whole chunk through the batcher
        r = httpx.post(f"{base}/tts/stream", json={"text": "A streamed mesh request.",
                                                   "total_step": 2}, timeout=300)
        assert r.status_code == 200 and len(r.content) > 44
    finally:
        server.shutdown()
        server.service.close()


def test_windowed_streaming_is_off_under_a_mesh(params, tiny_config, monkeypatch):
    eng = _engine(params, tiny_config, mesh=make_mesh(devices=["cpu"] * 2))

    def never(*a, **k):
        raise AssertionError("windowed streaming ran under a mesh")

    monkeypatch.setattr(eng, "_vocode_stream", never)
    text = "First sentence of the stream. " * 12
    pieces = list(eng.stream_windows(text, "en", _style(tiny_config, 1), total_step=2))
    assert pieces and all(end for _w, _s, end in pieces)


def test_graph_backend_under_a_mesh(onnx_dir):  # noqa: F811
    """The backend's stages per data shard on its device, weights
    replicated (tests/test_onnx_backend.py:143): equal to the
    single-device backend engine."""
    from supertonic_tpu_torch.assets.onnx_backend import load_onnx_backend
    from supertonic_tpu_torch.config import load_tts_json

    cfg = load_tts_json(os.path.join(onnx_dir, "tts.json"))
    with open(os.path.join(onnx_dir, "unicode_indexer.json")) as f:
        proc = UnicodeProcessor(np.asarray(json.load(f), np.int64))
    backend = load_onnx_backend(onnx_dir, cfg, matmul_precision="float32", device="cpu")
    engines = [SynthesisEngine(None, cfg, proc, precision="f32", seed=3, egress_format="f32",
                               backend=backend, mesh=mesh)
               for mesh in (None, make_mesh(devices=CPU8))]
    for e in engines:
        e._pin_rate(1.0 / 11.0)
    texts = [f"Mesh utterance number {i}." + " And more." * (i % 3) for i in range(8)]
    rng = np.random.default_rng(13)
    style = VoiceStyle(rng.standard_normal((8, 2, 4)).astype(np.float32),
                       rng.standard_normal((8, 2, 4)).astype(np.float32))
    (w1, d1), (w2, d2) = (e.batch(texts, ["en"] * 8, style, total_step=2) for e in engines)
    np.testing.assert_allclose(d1, d2, atol=1e-6)
    for a, b in zip(w1, w2):
        np.testing.assert_allclose(a, b, atol=3e-5)
    noise = rng.standard_normal((8, 64, cfg.latent_channels)).astype(np.float32)
    (n1, e1), (n2, e2) = (e.infer_batch(texts, ["en"] * 8, style, total_step=2, noise=noise)
                          for e in engines)
    np.testing.assert_allclose(e1, e2, atol=1e-6)
    np.testing.assert_allclose(n1, n2, atol=3e-5)
