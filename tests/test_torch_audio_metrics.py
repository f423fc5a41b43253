"""The port's copy of the audio metrics (``utils/audio_metrics.py``, numpy
only) against the JAX package's module: every public function bit-equal on
seeded signals, and the copy's code equal to the original's."""

import ast
import inspect

import numpy as np
import pytest

import supertonic_tpu.utils.audio_metrics as J
import supertonic_tpu_torch.utils.audio_metrics as T
from supertonic_tpu_torch.utils.mulaw import decode, encode

SR = 16000


def _speechlike(n=24000, sr=SR, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 2.3 * t)
    x = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / sr) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.1 * t))
    return (0.3 * x * env + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _pairs():
    x = _speechlike()
    noise = np.random.default_rng(1).standard_normal(x.size).astype(np.float32)
    return x, {"noisy": x + 1e-3 * noise, "mulaw": decode(encode(x)), "same": x.copy(),
               "short": (x + 1e-2 * noise)[: x.size // 2]}


@pytest.mark.parametrize("sr,n_fft,n_mels,fmax", [(16000, 1024, 80, None),
                                                  (44100, 2048, 128, 12000.0)])
def test_mel_filterbank_bit_equal(sr, n_fft, n_mels, fmax):
    kw = {} if fmax is None else {"fmax": fmax}
    np.testing.assert_array_equal(T.mel_filterbank(sr, n_fft, n_mels, **kw),
                                  J.mel_filterbank(sr, n_fft, n_mels, **kw))


@pytest.mark.parametrize("seed", [0, 3])
def test_log_mel_bit_equal(seed):
    x = _speechlike(seed=seed)
    np.testing.assert_array_equal(T.log_mel(x, SR), J.log_mel(x, SR))
    np.testing.assert_array_equal(T.log_mel(x, SR, n_fft=512, hop=128, n_mels=40),
                                  J.log_mel(x, SR, n_fft=512, hop=128, n_mels=40))


def test_log_mel_snr_and_mcd_bit_equal():
    x, others = _pairs()
    for name, y in others.items():
        assert T.log_mel_snr(x, y, SR) == J.log_mel_snr(x, y, SR), name
        assert T.mcd(x, y, SR) == J.mcd(x, y, SR), name
    assert T.mcd(x, x, SR) == 0.0 and T.log_mel_snr(x, x, SR) == float("inf")


def test_precision_ladder_report_equal():
    x, others = _pairs()
    assert T.precision_ladder_report(x, others, SR) == J.precision_ladder_report(x, others, SR)


def test_copy_keeps_the_originals_code():
    """The copy differs from the original only in its module docstring."""
    def body(mod):
        tree = ast.parse(inspect.getsource(mod))
        tree.body = tree.body[1:]  # the module docstring
        return ast.dump(tree)

    assert body(T) == body(J)
