"""The port's style files against the JAX package's: ``load_voice_style``
with and without ``verbose``, the same arrays and the same printed line."""

import numpy as np
import pytest

from supertonic_tpu.assets import load_voice_style as j_load_voice_style
from supertonic_tpu.assets import save_voice_style as j_save_voice_style
from supertonic_tpu.assets import synthesize_default_styles as j_default_styles
from supertonic_tpu.config import TTSConfig as JTTSConfig
from supertonic_tpu_torch.assets import store


@pytest.mark.parametrize("verbose", [False, True])
@pytest.mark.parametrize("names", [("M1",), ("M1", "F2", "M3")])
def test_load_voice_style_matches_jax(tmp_path, capsys, names, verbose):
    styles = j_default_styles(JTTSConfig())
    paths = []
    for name in names:
        paths.append(str(tmp_path / f"{name}.json"))
        j_save_voice_style(paths[-1], styles[name])
    want = j_load_voice_style(paths, verbose=verbose)
    printed = capsys.readouterr().out
    got = store.load_voice_style(paths, verbose=verbose)
    assert capsys.readouterr().out == printed
    assert printed == (f"Loaded {len(names)} voice styles\n" if verbose else "")
    assert got.ttl.dtype == got.dp.dtype == np.float32
    np.testing.assert_array_equal(got.ttl, want.ttl)
    np.testing.assert_array_equal(got.dp, want.dp)
    assert got.batch == len(names)


def test_load_voice_style_takes_verbose_as_the_reference_helper_passes_it(tmp_path, capsys):
    path = str(tmp_path / "F1.json")
    j_save_voice_style(path, j_default_styles(JTTSConfig())["F1"])
    store.load_voice_style([path], True)
    assert capsys.readouterr().out == "Loaded 1 voice styles\n"
