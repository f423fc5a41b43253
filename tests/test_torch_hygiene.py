"""The port stands alone: no module of supertonic_tpu_torch (its mesh,
multi-process bring-up and tools included), nor chip_smoke.py or
kernel_variants.py, imports JAX or the JAX package; and its framework-free
copies (config, frontend, buckets, stitch, wav, and the ONNX reader, exporter, auto-mapper
and converter) behave like the originals."""

import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest

import supertonic_tpu.assets.automap as j_automap
import supertonic_tpu.assets.convert as j_convert
import supertonic_tpu.assets.onnx_export as j_export
import supertonic_tpu.assets.onnx_reader as jR
import supertonic_tpu.config as jcfg
import supertonic_tpu.engine.buckets as jbuckets
import supertonic_tpu.frontend as jfront
import supertonic_tpu.utils.wav as jwav
import supertonic_tpu_torch.assets.automap as t_automap
import supertonic_tpu_torch.assets.convert as t_convert
import supertonic_tpu_torch.assets.onnx_export as t_export
import supertonic_tpu_torch.assets.onnx_reader as tR
import supertonic_tpu_torch.config as tcfg
import supertonic_tpu_torch.engine.buckets as tbuckets
import supertonic_tpu_torch.frontend as tfront
import supertonic_tpu_torch.utils.wav as twav
from supertonic_tpu.engine.stitch import stitch as j_stitch
from supertonic_tpu_torch.engine.stitch import stitch as t_stitch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "supertonic_tpu")


def _port_files():
    pkg = ROOT / "supertonic_tpu_torch"
    # build/ holds outputs made at run time, not the package's sources
    files = sorted(p for p in pkg.rglob("*.py")
                   if p.relative_to(pkg).parts[0] != "build")
    return files + [ROOT / "chip_smoke.py", ROOT / "kernel_variants.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


GRAPH_BACKEND = ("assets/fetch.py", "assets/onnx_reader.py", "assets/onnx_export.py", "assets/automap.py",
                 "assets/convert.py", "assets/convert_onnx.py", "assets/onnx_exec.py",
                 "assets/onnx_pipeline.py", "assets/onnx_backend.py",
                 "engine/onnx_adapter.py")


SINGLE_CARD_SURFACE = ("compat.py", "__main__.py", "frontend/native.py",
                       "utils/audio_metrics.py", "utils/timing.py", "serve/app.py")


def _covered_and_imports_without_jax(modules, skip_import=()):
    """The modules are among the files checked above, and import in a
    process where JAX and the JAX package cannot be found."""
    import subprocess
    import sys

    files = {p.relative_to(ROOT / "supertonic_tpu_torch").as_posix()
             for p in _port_files() if p.is_relative_to(ROOT / "supertonic_tpu_torch")}
    assert set(modules) <= files
    mods = ", ".join(repr("supertonic_tpu_torch." + m[:-3].replace("/", "."))
                     for m in modules if m not in skip_import)
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib')]:\n"
        "    del sys.modules[k]\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'supertonic_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in ({mods},):\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'supertonic_tpu') for k in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_graph_backend_modules_are_covered_and_import_without_jax():
    """The graph backend's modules are among the files checked above, and
    import in a process where JAX and the JAX package cannot be found."""
    _covered_and_imports_without_jax(GRAPH_BACKEND)


def test_single_card_surface_modules_are_covered_and_import_without_jax():
    """The same for the compat layer, the native frontend's binding, the
    audio metrics, the timers with device_trace and the FastAPI app
    (``__main__`` is checked by the AST scan only: importing it runs the
    CLI)."""
    _covered_and_imports_without_jax(SINGLE_CARD_SURFACE, skip_import=("__main__.py",))


MESH_AND_TOOLS = ("parallel/mesh.py", "parallel/multihost.py", "tools/__init__.py",
                  "tools/parity_check.py", "tools/bench_onnx_backend.py")


def test_mesh_multihost_and_tools_are_covered_and_import_without_jax():
    """The same for the device mesh, the multi-process bring-up and the
    port's tools."""
    _covered_and_imports_without_jax(MESH_AND_TOOLS)


def test_forbidden_name_match():
    assert _forbidden("supertonic_tpu.models") and _forbidden("jax.numpy")
    assert not _forbidden("supertonic_tpu_torch") and not _forbidden("jaxtyping")


@pytest.mark.parametrize("idim", [256, 384])
def test_config_copy_round_trips_like_the_original(idim):
    raw = jcfg.to_reference_dict(jcfg.TTSConfig())
    raw["ttl"]["text_encoder"]["proj_out"]["idim"] = idim
    a = jcfg.tts_config_from_reference_dict(raw)
    b = tcfg.tts_config_from_reference_dict(raw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert jcfg.to_reference_dict(a) == tcfg.to_reference_dict(b)


def test_frontend_copy_matches_the_original():
    texts = ["Hello, world!", "  spaced   out  text ", "Ça va? «Très» bien…",
             "e.g., 3 @ 4 — ok", "안녕하세요", "¿Qué tal?"]
    langs = ["en", "en", "fr", "en", "ko", "es"]
    jp = jfront.UnicodeProcessor(jfront.build_default_indexer())
    tp = tfront.UnicodeProcessor(tfront.build_default_indexer())
    for t, lang in zip(texts, langs):
        assert jfront.preprocess_text(t, lang) == tfront.preprocess_text(t, lang)
    ji, jm = jp(texts, langs)
    ti, tm = tp(texts, langs)
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(jm, tm)
    long = ("First sentence here. Second one, with a comma, follows! " * 12
            + "\n\nA new paragraph. Dr. Who met Mr. Smith.")
    for lang in ("en", "ko"):
        n = jfront.max_len_for_lang(lang)
        assert n == tfront.max_len_for_lang(lang)
        assert jfront.chunk_text(long, max_len=n) == tfront.chunk_text(long, max_len=n)


def test_buckets_stitch_and_wav_copies():
    for v in (0, 1, 33, 700, 5000):
        assert (jbuckets.pick_bucket(v, (64, 128, 640))
                == tbuckets.pick_bucket(v, (64, 128, 640)))
        assert (jbuckets.latent_len_for_duration(v / 100, 44100, 2048)
                == tbuckets.latent_len_for_duration(v / 100, 44100, 2048))
    rng = np.random.default_rng(0)
    wavs = [rng.standard_normal(400).astype(np.float32) for _ in range(3)]
    durs = [0.02, 0.015, 0.025]
    for xf in (0.0, 0.002):
        a, da = j_stitch(wavs, durs, 16000, crossfade_duration=xf)
        b, db = t_stitch(wavs, durs, 16000, crossfade_duration=xf)
        np.testing.assert_array_equal(a, b)
        assert da == db
    assert (jwav.wav_bytes(wavs[0] * 0.5, 16000)
            == twav.wav_bytes(wavs[0] * 0.5, 16000))


def test_onnx_asset_copies_keep_the_originals_code():
    """The copies differ from the originals only in their docstrings."""
    def body(mod):
        tree = ast.parse(open(mod.__file__).read())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and \
                    node.body and isinstance(node.body[0], ast.Expr) and \
                    isinstance(getattr(node.body[0], "value", None), ast.Constant):
                node.body = node.body[1:]
        return ast.dump(tree)

    import supertonic_tpu.assets.fetch as j_fetch
    import supertonic_tpu_torch.assets.fetch as t_fetch

    for j, t in ((jR, tR), (j_export, t_export), (j_automap, t_automap),
                 (j_convert, t_convert), (j_fetch, t_fetch)):
        assert body(j) == body(t), t.__name__
    with open(tR.__file__) as f:
        assert "jax" not in f.read().lower().replace("ml_dtypes", "")
    assert json.dumps(sorted(tR.DTYPE_MAP)) == json.dumps(sorted(jR.DTYPE_MAP))
