"""The port's copies of the framework-free asset modules against the
originals: the ONNX reader and writer, the exporter, the structural
auto-mapper, the MappingRule converter, save_assets, and the converter CLI
whose bundle the port's ``TTS`` serves with the native engine."""

import dataclasses
import os

import numpy as np
import pytest

import supertonic_tpu.assets.automap as j_automap
import supertonic_tpu.assets.convert as j_convert
import supertonic_tpu.assets.onnx_export as j_export
import supertonic_tpu.assets.onnx_reader as jR
import supertonic_tpu.assets.store as j_store
import supertonic_tpu_torch.assets.automap as t_automap
import supertonic_tpu_torch.assets.convert as t_convert
import supertonic_tpu_torch.assets.onnx_export as t_export
import supertonic_tpu_torch.assets.onnx_reader as tR
import supertonic_tpu_torch.assets.store as t_store
from supertonic_tpu.models import init_all as j_init_all
from supertonic_tpu_torch import TTS
from supertonic_tpu_torch.config import TTSConfig, _dataclass_from_dict
from supertonic_tpu_torch.frontend import build_default_indexer
from supertonic_tpu_torch.models import init_all

F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def rate_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTS_RATE_CACHE_DIR", str(tmp_path_factory.mktemp("rates")))
        mp.delenv("TTS_ONNX_FUSED", raising=False)
        yield


@pytest.fixture(scope="module")
def cfg(tiny_config):
    """The port's config object with the values of the JAX tiny config."""
    return _dataclass_from_dict(TTSConfig, dataclasses.asdict(tiny_config))


@pytest.fixture(scope="module")
def bundles(tiny_config, cfg, tmp_path_factory):
    """The same params exported by both packages, plain and anonymized."""
    out = {}
    for anon in (False, True):
        jd = str(tmp_path_factory.mktemp("jax_bundle"))
        td = str(tmp_path_factory.mktemp("port_bundle"))
        j_export.export_bundle(j_init_all(42, tiny_config), tiny_config, jd,
                               indexer=build_default_indexer(), anonymize=anon)
        t_export.export_bundle(init_all(42, cfg), cfg, td,
                               indexer=build_default_indexer(), anonymize=anon)
        out[anon] = (jd, td)
    return out


def _same(a, b, path="graph"):
    """Field-by-field equality of the two readers' parse results."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), path


@pytest.mark.parametrize("anon", [False, True], ids=["named", "anonymized"])
def test_export_bundle_is_byte_equal(bundles, anon):
    jd, td = bundles[anon]
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in os.listdir(jd):
        with open(os.path.join(jd, name), "rb") as f, \
                open(os.path.join(td, name), "rb") as g:
            assert f.read() == g.read(), name


def test_reader_parses_like_the_original(bundles):
    jd, _ = bundles[False]
    for model in t_export.MODEL_FILES:
        path = os.path.join(jd, f"{model}.onnx")
        _same(jR.load_onnx(path), tR.load_onnx(path))
    # the writer half: the same calls give the same bytes
    rng = np.random.default_rng(0)
    for arr in (rng.standard_normal((3, 4)).astype(F32), np.arange(6, dtype=np.int64),
                np.array(True), np.zeros((0, 2), np.int32)):
        assert jR.encode_tensor("t", arr) == tR.encode_tensor("t", arr)
    attrs = {"axis": -1, "alpha": 0.5, "mode": "reflect", "pads": [1, 2],
             "scales": [1.0, 2.0]}
    assert (jR.encode_node("Pad", ["x", "p"], ["y"], name="n", attrs=attrs)
            == tR.encode_node("Pad", ["x", "p"], ["y"], name="n", attrs=attrs))

    def graph(R):
        return R.encode_graph("body", [R.encode_node("Relu", ["a"], ["b"], name="r")],
                              [R.encode_tensor("w", np.ones(2, F32))],
                              [R.encode_value_info("a", F32, ("N",))],
                              [R.encode_value_info("b", F32, ("N",))])

    assert graph(jR) == graph(tR)
    model = [R.encode_model("g", [R.encode_node("Relu", ["a"], ["b"], name="r")], [],
                            [R.encode_value_info("a", F32, ("N", 2))],
                            [R.encode_value_info("b", F32, ("N", 2))]) for R in (jR, tR)]
    assert model[0] == model[1]
    _same(jR.parse_model(model[0]), tR.parse_model(model[0]))


def test_automap_round_trip_is_bit_equal(bundles, tiny_config, cfg):
    """No name information: every param comes back exactly, as from the
    JAX auto-mapper."""
    _, td = bundles[True]
    got, reports = t_automap.automap_bundle(td, cfg, seed=0)
    want, _ = j_automap.automap_bundle(td, tiny_config, seed=0)
    src = t_store.flatten_tree(init_all(42, cfg))
    fg, fw = t_store.flatten_tree(got), t_store.flatten_tree(want)
    assert set(fg) == set(src) == set(fw)
    for k in src:
        np.testing.assert_array_equal(fg[k], src[k], err_msg=k)
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    assert all(r["matched_params"] > 0 and r["consts_checked"] > 0
               for r in reports.values())
    other = dataclasses.replace(cfg, vector_estimator=dataclasses.replace(
        cfg.vector_estimator, n_layers=cfg.vector_estimator.n_layers + 1))
    with pytest.raises(t_automap.AutomapError):
        t_automap.automap_bundle(td, other, seed=0)


def test_mapping_rule_converter_matches_the_original(bundles, tiny_config, cfg):
    jd, _ = bundles[False]
    rules = {m: [t_convert.MappingRule(r"(.*)", r"\1")] for m in t_convert.MODEL_FILES}
    jrules = {m: [j_convert.MappingRule(r"(.*)", r"\1")] for m in j_convert.MODEL_FILES}
    got, rep = t_convert.convert(jd, cfg, rules, strict=False)
    want, jrep = j_convert.convert(jd, tiny_config, jrules, strict=False)
    assert rep == jrep
    fg, fw = t_store.flatten_tree(got), j_store.flatten_tree(want)
    assert set(fg) == set(fw)
    for k in fg:
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


def test_save_assets_writes_the_jax_bundle(tmp_path, tiny_config, cfg):
    params = init_all(1, cfg)
    t_store.save_assets(str(tmp_path / "t"), cfg, params)
    j_store.save_assets(str(tmp_path / "j"), tiny_config, j_init_all(1, tiny_config))
    for rel in ("tts.json", "model_config.json", "unicode_indexer.json",
                "voice_styles/M1.json", "voice_styles/F5.json"):
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel
    with np.load(tmp_path / "t" / "params.npz") as a, np.load(tmp_path / "j" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_converter_cli_bundle_serves_bit_equal_audio(bundles, cfg, tmp_path, capsys):
    """convert_onnx with no --mapping (automap) writes a bundle the port's
    TTS loads natively; its audio equals, bit for bit, that of a bundle
    saved from the source params."""
    from supertonic_tpu_torch.assets import convert_onnx

    _, td = bundles[True]
    out = str(tmp_path / "converted")
    assert convert_onnx.main(["--onnx-dir", td, "--out", out]) == 0
    text = capsys.readouterr().out
    assert "automapped vector_estimator" in text
    convert_onnx.main(["--onnx-dir", td, "--out", out, "--list-only"])
    assert "== vocoder" in capsys.readouterr().out
    src = str(tmp_path / "source")
    t_store.save_assets(src, cfg, init_all(42, cfg), indexer=build_default_indexer())
    outs = []
    for d in (out, src):
        tts = TTS(d, device="cpu", precision="f32")
        assert tts.engine.backend is None
        tts.engine._pin_rate(1.0 / 11.0)
        outs.append(tts.synthesize("Converted bundle check.",
                                   tts.get_voice_style("M1"), total_step=2))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_fetch_matches_the_original(tmp_path):
    """The copied fetcher, on an injected transport (no network): the same
    files and digests as the JAX package's, a resumed .part, a sha256
    mismatch and an unreachable host refused alike."""
    import hashlib
    import io
    import urllib.error

    import supertonic_tpu.assets.fetch as j_fetch
    import supertonic_tpu_torch.assets.fetch as t_fetch

    class Resp(io.BytesIO):
        def __init__(self, data, status=200):
            super().__init__(data)
            self.status = status

    def opener(req):
        data = req.full_url.encode() * 50
        rng = req.headers.get("Range")
        if rng:
            off = int(rng.split("=")[1].rstrip("-"))
            return Resp(data[off:], 206)
        return Resp(data)

    quiet = dict(progress=lambda *a, **k: None)
    got = t_fetch.fetch_all(str(tmp_path / "t"), opener=opener, **quiet)
    want = j_fetch.fetch_all(str(tmp_path / "j"), opener=opener, **quiet)
    assert got == want and t_fetch.FILES == j_fetch.FILES
    for rel in got:
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()
    url = "http://x/m.onnx"
    data = url.encode() * 50
    (tmp_path / "m.onnx.part").write_bytes(data[:100])
    assert t_fetch.download_file(url, str(tmp_path / "m.onnx"), opener=opener, **quiet) \
        == hashlib.sha256(data).hexdigest()
    with pytest.raises(t_fetch.FetchError, match="sha256 mismatch"):
        t_fetch.download_file(url, str(tmp_path / "n.onnx"), opener=opener,
                              expected_sha256="0" * 64, **quiet)

    def offline(req):
        raise urllib.error.URLError("no route")

    with pytest.raises(t_fetch.FetchError, match="cannot reach"):
        t_fetch.download_file(url, str(tmp_path / "o.onnx"), opener=offline, **quiet)
