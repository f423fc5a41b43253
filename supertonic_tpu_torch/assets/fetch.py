"""Hugging Face asset fetching, a copy of ``supertonic_tpu.assets.fetch``
(stdlib only; ``opener`` injects the transport).

The reference auto-downloads ~260 MB from ``Supertone/supertonic-2``
(reference py/example_pypi.py:3-4, README.md:104). Resumable (HTTP Range),
per-file sha256 validation against an optional manifest, and a clear
actionable error when the environment has no egress. Stdlib-only (urllib).
"""

from __future__ import annotations

import hashlib
import os
import urllib.error
import urllib.request

REPO = "Supertone/supertonic-2"
BASE_URL = "https://huggingface.co/{repo}/resolve/main/{path}"

# Asset layout per the reference (py/helper.py:297-319, web/index.html:31-41)
FILES = (
    ["onnx/tts.json", "onnx/unicode_indexer.json"]
    + [f"onnx/{m}.onnx" for m in (
        "duration_predictor", "text_encoder", "vector_estimator", "vocoder")]
    + [f"voice_styles/{v}.json" for v in
       ("M1", "M2", "M3", "M4", "M5", "F1", "F2", "F3", "F4", "F5")]
)

CHUNK = 1 << 20  # 1 MiB


class FetchError(RuntimeError):
    pass


def _open(url: str, headers: dict | None = None, opener=None):
    req = urllib.request.Request(url, headers=headers or {})
    fn = opener or urllib.request.urlopen
    return fn(req)


def download_file(url: str, dest: str, *, opener=None,
                  expected_sha256: str | None = None,
                  progress=print) -> str:
    """Resumable download: picks up from ``dest + '.part'`` if present.
    Returns the hex sha256 of the completed file."""
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    part = dest + ".part"
    offset = os.path.getsize(part) if os.path.exists(part) else 0
    headers = {"Range": f"bytes={offset}-"} if offset else {}
    try:
        resp = _open(url, headers, opener)
    except urllib.error.HTTPError as e:
        if e.code == 416:  # range beyond EOF: .part is already complete
            resp = None
        else:
            raise FetchError(f"HTTP {e.code} fetching {url}") from e
    except (urllib.error.URLError, OSError) as e:
        raise FetchError(
            f"cannot reach {url}: {e}. This environment may have no network "
            f"egress — download the '{REPO}' repo on a connected machine "
            f"(git lfs clone or huggingface-cli download) and point "
            f"--onnx-dir at it instead."
        ) from e

    if resp is not None:
        status = getattr(resp, "status", 200)
        mode = "ab" if (offset and status == 206) else "wb"
        if offset and status != 206:
            offset = 0  # server ignored Range; restart
        with open(part, mode) as f:
            while True:
                buf = resp.read(CHUNK)
                if not buf:
                    break
                f.write(buf)
                offset += len(buf)
                progress(f"\r  {os.path.basename(dest)}: "
                         f"{offset / 1e6:.1f} MB", end="")
        progress("")

    h = hashlib.sha256()
    with open(part, "rb") as f:
        for blk in iter(lambda: f.read(CHUNK), b""):
            h.update(blk)
    digest = h.hexdigest()
    if expected_sha256 and digest != expected_sha256:
        os.remove(part)  # corrupt: force a clean re-download next run
        raise FetchError(
            f"sha256 mismatch for {dest}: got {digest}, "
            f"expected {expected_sha256} (removed partial; re-run to retry)"
        )
    os.replace(part, dest)
    return digest


def fetch_all(out_dir: str, *, repo: str = REPO, opener=None,
              manifest: dict | None = None, progress=print) -> dict[str, str]:
    """Download every asset file into ``out_dir`` (flattened: onnx/* at the
    top level like the reference's assets/onnx, voice_styles/ preserved).
    Returns {relative_path: sha256}. Skips files that already exist."""
    digests: dict[str, str] = {}
    for rel in FILES:
        # reference layout: assets/onnx/{graphs,configs}, assets/voice_styles
        local_rel = rel[len("onnx/"):] if rel.startswith("onnx/") else rel
        dest = os.path.join(out_dir, local_rel)
        expected = (manifest or {}).get(rel)
        if os.path.exists(dest):
            # verify pre-existing files too (a stale/corrupt leftover must
            # not be served as current) and keep them in the digest map
            h = hashlib.sha256()
            with open(dest, "rb") as f:
                for blk in iter(lambda: f.read(CHUNK), b""):
                    h.update(blk)
            digest = h.hexdigest()
            if expected and digest != expected:
                progress(f"  {local_rel}: exists but sha256 mismatch — "
                         f"re-fetching")
                os.remove(dest)
            else:
                digests[local_rel] = digest
                progress(f"  {local_rel}: exists, skipping")
                continue
        url = BASE_URL.format(repo=repo, path=rel)
        progress(f"fetching {rel}")
        digests[local_rel] = download_file(
            url, dest, opener=opener, expected_sha256=expected,
            progress=lambda *a, **k: None)
    return digests


