"""The port's tools (``python -m supertonic_tpu_torch.tools.parity_check``
and ``...tools.bench_onnx_backend``) on the CPU, on the JAX tests'
four-graph contract bundle: the cases of tests/test_parity_check.py (the
self-checks, the full gate with a stubbed onnxruntime that wraps the
port's own executor, a divergent reference failing the gate), the
absent-onnxruntime skip, and a smoke run of the bench printing both modes."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from supertonic_tpu_torch.assets.onnx_exec import OnnxSession
from supertonic_tpu_torch.tools import bench_onnx_backend, parity_check

from test_onnx_pipeline import onnx_dir  # noqa: F401  (module-scoped fixture)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module", autouse=True)
def rate_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTS_RATE_CACHE_DIR", str(tmp_path_factory.mktemp("rates")))
        if getattr(sys.modules.get("onnxruntime"), "__spec__", True) is None:
            # a stub left by tests/test_reference_differential.py (see
            # tests/test_torch_onnx_backend.py)
            mp.delitem(sys.modules, "onnxruntime")
        for k in ("TTS_ONNX_FUSED", "TTS_ONNX_BF16"):
            mp.delenv(k, raising=False)
        yield


def _stub_ort(monkeypatch, root=None):
    """An onnxruntime module whose sessions are the port's executor (on the
    graphs of ``root`` when given)."""
    stub = types.ModuleType("onnxruntime")

    class InferenceSession:
        def __init__(self, path, providers=None):
            if root is not None:
                path = os.path.join(root, os.path.basename(path))
            self._s = OnnxSession(path, matmul_precision="float32", device="cpu")

        def run(self, names, feeds):
            return self._s.run(names, feeds)

    stub.InferenceSession = InferenceSession
    monkeypatch.setitem(sys.modules, "onnxruntime", stub)


def test_self_check_passes(onnx_dir, capsys):  # noqa: F811
    rc = parity_check.main(["--assets-dir", onnx_dir, "--total-step", "2", "--skip-ort",
                            "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["parity_ok"] is True
    assert summary["stages"] >= 8  # wav + dur per text, two padded vocoder runs


def test_full_gate_with_stub_ort(onnx_dir, capsys, monkeypatch):  # noqa: F811
    _stub_ort(monkeypatch)
    rc = parity_check.main(["--assets-dir", onnx_dir, "--total-step", "2",
                            "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    stages = {r.get("stage") for r in lines if "stage" in r}
    assert {"duration_predictor", "text_encoder", "vocoder", "seeded_end_to_end_wav",
            "full_own_chain_wav", "fused_vs_pipeline_wav",
            "padded_vs_exact_vocoder"} <= stages
    assert lines[-1]["parity_ok"] is True


def test_gate_fails_on_divergent_graph(onnx_dir, tmp_path, capsys,  # noqa: F811
                                       monkeypatch):
    """A reference whose vocoder differs FAILS the gate."""
    from supertonic_tpu_torch.assets import onnx_reader as R

    ref_dir = tmp_path / "ref"
    shutil.copytree(onnx_dir, ref_dir)
    w = np.load(os.path.join(onnx_dir, "weights.npy"), allow_pickle=True).item()
    base_chunk, ccf = 4, 2
    node = [R.encode_node("ConvTranspose", ["latent", "w_voc"], ["up"], name="n0",
                          attrs={"strides": [base_chunk * ccf],
                                 "kernel_shape": [base_chunk * ccf]}),
            R.encode_node("Mul", ["up", "gain"], ["g"], name="n1"),
            R.encode_node("Squeeze", ["g", "ax1"], ["sq"], name="n2"),
            R.encode_node("Tanh", ["sq"], ["wav_tts"], name="n3")]
    inits = [R.encode_tensor("w_voc", w["w_voc"]),
             R.encode_tensor("gain", np.float32(1.5)),
             R.encode_tensor("ax1", np.asarray([1], np.int64))]
    vi_in = [R.encode_value_info("latent", np.float32, ("B", ccf * 3, "T"))]
    vi_out = [R.encode_value_info("wav_tts", np.float32, ("B", "W"))]
    (ref_dir / "vocoder.onnx").write_bytes(R.encode_model("g", node, inits, vi_in, vi_out))
    _stub_ort(monkeypatch, root=str(ref_dir))
    rc = parity_check.main(["--assets-dir", onnx_dir, "--total-step", "2",
                            "--device", "cpu"])
    assert rc == 1
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["parity_ok"] is False


def test_without_onnxruntime_the_gate_skips_clearly(onnx_dir, capsys,  # noqa: F811
                                                     monkeypatch):
    monkeypatch.setitem(sys.modules, "onnxruntime", None)  # import raises
    rc = parity_check.main(["--assets-dir", onnx_dir, "--total-step", "2",
                            "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc == 0
    assert "onnxruntime not installed" in captured.err
    stages = {json.loads(x).get("stage") for x in captured.out.splitlines()}
    assert "duration_predictor" not in stages and "fused_vs_pipeline_wav" in stages


def test_bench_prints_both_modes(onnx_dir, capsys):  # noqa: F811
    rc = bench_onnx_backend.main(["--assets-dir", onnx_dir, "--total-step", "2",
                                  "--n", "2", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["adapter"]["engine"] == "OnnxEngineAdapter"
    assert out["fused"]["engine"] == "SynthesisEngine"
    for arm in ("adapter", "fused"):
        assert 0 < out[arm]["min_ms"] <= out[arm]["p50_ms"] <= out[arm]["p90_ms"]
    assert out["speedup_p50"] > 0
    assert "TTS_ONNX_FUSED" not in os.environ


def test_tools_run_as_modules(onnx_dir, tmp_path):  # noqa: F811
    env = dict(os.environ, TTS_RATE_CACHE_DIR=str(tmp_path))
    env["PYTHONPATH"] = os.pathsep.join([REPO] + ([env["PYTHONPATH"]]
                                                  if env.get("PYTHONPATH") else []))
    r = subprocess.run([sys.executable, "-m", "supertonic_tpu_torch.tools.parity_check",
                        "--assets-dir", onnx_dir, "--total-step", "2", "--skip-ort",
                        "--device", "cpu"], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.splitlines()[-1])["parity_ok"] is True


# ---------------------------------------------------------------------------
# the repo tools ported in the same way: smoke_test, precision_ladder,
# export_onnx, inspect_onnx, gen_mapping_template, each as ``python -m`` at
# the tiny config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_assets(tiny_config, tmp_path_factory):
    """A native bundle at the tiny config (model_config.json, params.npz),
    the estimator's zero-init gates perturbed so that every tier of the
    precision ladder reaches the output."""
    import dataclasses

    from supertonic_tpu_torch.assets import save_params
    from supertonic_tpu_torch.models import init_all

    params = init_all(0, tiny_config)
    rng = np.random.default_rng(42)
    ve = params["vector_estimator"]
    for key in ("out_proj", "adaln_out"):
        ve[key]["w"] = (rng.standard_normal(ve[key]["w"].shape) * 0.05).astype(np.float32)
    for bp in ve["blocks"]:
        bp["adaln"]["w"] = (rng.standard_normal(bp["adaln"]["w"].shape) * 0.05).astype(np.float32)
    d = tmp_path_factory.mktemp("tiny_assets")
    (d / "model_config.json").write_text(json.dumps(dataclasses.asdict(tiny_config)))
    save_params(str(d / "params.npz"), params)
    return str(d)


def _tool(name, *args, tmp_path):
    env = dict(os.environ, TTS_RATE_CACHE_DIR=str(tmp_path))
    env["PYTHONPATH"] = os.pathsep.join([REPO] + ([env["PYTHONPATH"]]
                                                  if env.get("PYTHONPATH") else []))
    return subprocess.run([sys.executable, "-m", f"supertonic_tpu_torch.tools.{name}", *args],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=300)


def test_smoke_test_drives_the_cli_and_the_bundle(tiny_assets, tmp_path):
    """One native CLI mode (batch: two WAVs over 1,000 bytes) and the bundle
    mode, whose graphs assets/onnx_export.py writes from the same params."""
    r = _tool("smoke_test", "--platform", "cpu", "--assets-dir", tiny_assets,
              "--modes", "batch", "bundle", tmp_path=tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    summary = json.loads(r.stdout.splitlines()[-1])
    assert summary["smoke_ok"] is True and summary["wavs"] == 3
    assert all(size > 1000 for size in summary["modes"]["batch"].values())
    assert len(summary["modes"]["bundle"]) == 1


def test_smoke_test_fails_on_a_broken_mode(tmp_path):
    """A CLI run that exits non-zero fails the smoke test (an assets dir
    with neither params.npz nor the graphs raises in the CLI)."""
    r = _tool("smoke_test", "--platform", "cpu", "--assets-dir", str(tmp_path),
              "--modes", "default", tmp_path=tmp_path)
    assert r.returncode == 1
    assert json.loads(r.stdout.splitlines()[-1])["smoke_ok"] is False


def test_precision_ladder_prints_its_tiers(tiny_assets, tmp_path):
    """Each protocol text's bf16, int8 and bf16 + mu-law tiers against the
    f32 tier: finite MCD and log-mel SNR, and every tier off the f32 wave."""
    r = _tool("precision_ladder", "--platform", "cpu", "--assets-dir", tiny_assets,
              "--total-step", "2", tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    assert [(x["text"], x["tier"]) for x in rows] == [
        (t, tier) for t in ("short", "mid") for tier in ("bf16", "int8", "bf16_mulaw8")]
    for x in rows:
        assert x["reference"] == "f32" and x["platform"] == "cpu"
        assert np.isfinite(x["mcd_db"]) and np.isfinite(x["log_mel_snr_db"])
        assert np.isfinite(x["wav_snr_db"]) and x["mcd_db"] > 0
    assert "| mid | int8 |" in r.stderr


def test_export_inspect_and_template_on_a_bundle(tiny_assets, tmp_path):
    out = tmp_path / "graphs"
    r = _tool("export_onnx", "--out", str(out), "--assets-dir", tiny_assets, tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    listed = json.loads(r.stdout.splitlines()[-1])["graphs"]
    assert {"duration_predictor.onnx", "text_encoder.onnx", "vector_estimator.onnx",
            "vocoder.onnx", "tts.json", "model_config.json",
            "unicode_indexer.json"} <= set(listed)
    r = _tool("inspect_onnx", "--assets-dir", str(out), "--json", tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(r.stdout)
    assert sorted(rep) == sorted(["duration_predictor", "text_encoder", "vector_estimator",
                                  "vocoder"])
    for g in rep.values():
        assert g["unsupported_ops"] == [] and g["float_params"] > 0 and g["nodes"] > 0
    r = _tool("gen_mapping_template", "--assets-dir", str(out), tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "from supertonic_tpu_torch.assets.convert import MappingRule" in r.stdout
    scope = {}
    exec(r.stdout, scope)  # the template is valid Python, every rule a comment
    assert sorted(scope["RULES"]) == ["duration_predictor", "text_encoder",
                                      "vector_estimator", "vocoder"]
    from supertonic_tpu_torch.assets.store import flatten_tree
    from supertonic_tpu_torch.models import init_all

    cfg = json.loads((out / "model_config.json").read_text())
    for path in flatten_tree(init_all(0, _cfg(cfg))):
        assert f"r'{path.split('/', 1)[1]}'" in r.stdout
    r = _tool("inspect_onnx", "--assets-dir", str(tmp_path / "nope"), tmp_path=tmp_path)
    assert r.returncode == 1  # a wrong directory does not look like success


def _cfg(d):
    from supertonic_tpu_torch.assets.store import _dataclass_from_dict
    from supertonic_tpu_torch.config import TTSConfig

    return _dataclass_from_dict(TTSConfig, d)


def test_inspect_onnx_preflight_against_the_port_executor(tmp_path):
    """tests/test_assets.py's preflight against the port's executor
    registry: a graph of supported ops passes, an unknown op is named."""
    from supertonic_tpu_torch.assets import onnx_reader as R
    from supertonic_tpu_torch.tools import inspect_onnx

    def graph(op):
        return R.encode_model("g", [R.encode_node(op, ["x"], ["y"], name="n0")], [],
                              [R.encode_value_info("x", np.float32, (2,))],
                              [R.encode_value_info("y", np.float32, (2,))])

    (tmp_path / "ok.onnx").write_bytes(graph("Relu"))
    (tmp_path / "bad.onnx").write_bytes(graph("TotallyMadeUpOp"))
    assert inspect_onnx.report(str(tmp_path / "ok.onnx"))["unsupported_ops"] == []
    assert inspect_onnx.report(str(tmp_path / "bad.onnx"))["unsupported_ops"] == [
        "TotallyMadeUpOp"]
