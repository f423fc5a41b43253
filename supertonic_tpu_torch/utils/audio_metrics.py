"""Perceptual audio metrics for the precision ladder (host-side numpy), a
copy of ``supertonic_tpu.utils.audio_metrics``.

The reference ships no quality metric at all (its test driver checks WAV
file sizes only — test_all.sh); serving a quantized fast path (bf16 / int8 /
mu-law egress) needs a perceptually-grounded gate, not a raw-sample SNR.
Two standards:

* **log-mel SNR** — SNR computed on log-mel spectrograms (the domain TTS
  fidelity is judged in; insensitive to imperceptible phase drift that
  wrecks waveform SNR).
* **MCD** — mel-cepstral distortion in dB,
  ``(10/ln10) * sqrt(2 * sum_{k=1..K} (c_k - c'_k)^2)`` averaged over
  frames (Kubichek 1993). Rule of thumb: < 0.5 dB inaudible, ~1 dB subtle,
  > 2-3 dB clearly audible.

The mel frontend defaults to a standard 1024/256/80 analysis; pass ``spec``
(the config's spec_processor block — tts.json schema, reference
go/helper.go:30-40) to ``precision_ladder_report`` to measure in the
model's own analysis geometry when real assets are mounted
(the JAX package's tools/precision_ladder.py does).
"""

from __future__ import annotations

import numpy as np


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular HTK-mel filterbank."""
    fmax = fmax or sr / 2.0
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                 n_mels + 2))
    bins = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((n_mels, bins.size))
    for i in range(n_mels):
        lo, mid, hi = pts[i], pts[i + 1], pts[i + 2]
        up = (bins - lo) / max(mid - lo, 1e-9)
        down = (hi - bins) / max(hi - mid, 1e-9)
        fb[i] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


def log_mel(wav: np.ndarray, sr: int, *, n_fft: int = 1024,
            hop: int = 256, n_mels: int = 80, eps: float = 1e-5) -> np.ndarray:
    """[frames, n_mels] log-mel spectrogram (hann window, reflect-padded)."""
    wav = np.asarray(wav, np.float64).reshape(-1)
    if wav.size < n_fft:
        wav = np.pad(wav, (0, n_fft - wav.size))
    pad = n_fft // 2
    wav = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (wav.size - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * np.hanning(n_fft)[None, :]
    mag = np.abs(np.fft.rfft(frames, axis=1))
    fb = mel_filterbank(sr, n_fft, n_mels)
    return np.log(np.maximum(mag @ fb.T, eps))


def log_mel_snr(ref: np.ndarray, test: np.ndarray, sr: int, **kw) -> float:
    """SNR (dB) between log-mel spectrograms; +inf for identical audio."""
    n = min(len(np.ravel(ref)), len(np.ravel(test)))
    a = log_mel(np.ravel(ref)[:n], sr, **kw)
    b = log_mel(np.ravel(test)[:n], sr, **kw)
    num = float(np.mean(a * a))
    den = float(np.mean((a - b) ** 2))
    if den == 0.0:
        return float("inf")
    return 10.0 * np.log10(num / den)


def mcd(ref: np.ndarray, test: np.ndarray, sr: int, *, n_mfcc: int = 13,
        n_fft: int = 1024, hop: int = 256, n_mels: int = 80) -> float:
    """Mel-cepstral distortion (dB), c0 excluded, frame-averaged.

    Frames are time-aligned by construction (same synthesis, different
    precision) so no DTW is applied — this measures quantization damage,
    not prosody difference."""
    n = min(len(np.ravel(ref)), len(np.ravel(test)))
    a = log_mel(np.ravel(ref)[:n], sr, n_fft=n_fft, hop=hop, n_mels=n_mels)
    b = log_mel(np.ravel(test)[:n], sr, n_fft=n_fft, hop=hop, n_mels=n_mels)
    ca = _dct2(a)[:, 1:n_mfcc + 1]
    cb = _dct2(b)[:, 1:n_mfcc + 1]
    k = 10.0 / np.log(10.0) * np.sqrt(2.0)
    return float(k * np.mean(np.sqrt(np.sum((ca - cb) ** 2, axis=1))))


def _dct2(x: np.ndarray) -> np.ndarray:
    """Orthonormal DCT-II along the last axis (mel -> cepstra)."""
    n = x.shape[-1]
    basis = np.cos(np.pi / n * (np.arange(n)[None, :] + 0.5)
                   * np.arange(n)[:, None])
    basis[0] *= 1.0 / np.sqrt(2.0)
    return x @ basis.T * np.sqrt(2.0 / n)


def precision_ladder_report(ref_wav: np.ndarray, others: dict[str, np.ndarray],
                            sr: int, spec=None) -> dict[str, dict[str, float]]:
    """{name: {mcd_db, log_mel_snr_db, wav_snr_db}} vs the f32 reference.

    ``spec``: optional SpecProcessorConfig (config.py) — mel geometry then
    follows the model's own analysis settings (n_fft / hop_length / n_mels)
    instead of the 1024/256/80 defaults."""
    geo = {}
    if spec is not None:
        geo = {"n_fft": spec.n_fft, "hop": spec.hop_length,
               "n_mels": spec.n_mels}
    out = {}
    ref = np.ravel(np.asarray(ref_wav, np.float64))
    for name, wav in others.items():
        w = np.ravel(np.asarray(wav, np.float64))
        n = min(ref.size, w.size)
        d = ref[:n] - w[:n]
        wav_snr = (float("inf") if not d.any() else
                   10.0 * np.log10(np.mean(ref[:n] ** 2)
                                   / max(np.mean(d ** 2), 1e-300)))
        out[name] = {
            "mcd_db": mcd(ref, w, sr, **geo),
            "log_mel_snr_db": log_mel_snr(ref, w, sr, **geo),
            "wav_snr_db": wav_snr,
        }
    return out
