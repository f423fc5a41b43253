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
