"""The port's multi-process bring-up (``supertonic_tpu_torch/parallel/multihost.py``)
on the CPU: two OS processes join a ``torch.distributed`` gloo group over
localhost TCP, each with a local mesh of two CPU devices, and each runs
the per-host engine pattern on its ``host_shard`` of a request list, as
tests/test_multiprocess.py does for the JAX package. The worker is this
file's own ``__main__``. Beside it: no config is a no-op, a bad
coordinator raises."""

import os
import socket
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + ([env["PYTHONPATH"]]
                                                  if env.get("PYTHONPATH") else []))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    return env


def test_two_process_distributed_engine(tmp_path):
    port = _free_port()
    env = dict(_env(), TTS_RATE_CACHE_DIR=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, __file__, str(i), "2", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=REPO)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"MULTIPROC_OK pid={i} nprocs=2 global_devices=4" in out, out


def test_initialize_distributed_noop_without_config(monkeypatch):
    """No coordinator config -> clean no-op (single-process serving)."""
    import torch.distributed as dist

    from supertonic_tpu_torch.parallel import multihost
    from supertonic_tpu_torch.parallel.mesh import initialize_distributed

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    initialize_distributed()
    multihost.initialize()
    assert not dist.is_initialized()
    assert multihost.process_index() == 0 and multihost.world_size() == 1
    assert multihost.host_shard(list(range(5))) == list(range(5))
    assert multihost.is_egress_host()
    shards = [multihost.host_shard(list(range(10)), pid, 3) for pid in range(3)]
    assert sorted(sum(shards, [])) == list(range(10))


def test_initialize_distributed_loud_on_bad_coordinator():
    """A configured-but-unreachable coordinator fails loudly within its
    timeout, never degrades to single-process serving. In a subprocess, so
    a failed init cannot leave state in this one."""
    code = (
        "from supertonic_tpu_torch.parallel.mesh import initialize_distributed\n"
        "try:\n"
        "    initialize_distributed(coordinator_address='localhost:1',\n"
        "                           num_processes=2, process_id=1,\n"
        "                           initialization_timeout=5)\n"
        "except Exception as e:\n"
        "    print('RAISED', type(e).__name__)\n"
        "else:\n"
        "    print('SWALLOWED')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=REPO, timeout=120)
    assert "SWALLOWED" not in out.stdout, out.stdout + out.stderr
    assert "RAISED" in out.stdout or out.returncode != 0, out.stdout + out.stderr


def _worker(pid: int, nprocs: int, port: int) -> None:
    import numpy as np

    from supertonic_tpu_torch.config import (AEConfig, DPConfig, DurationPredictorHParams,
                                             StyleTokenLayerConfig, TextEncoderHParams,
                                             TTLConfig, TTSConfig, VectorEstimatorHParams,
                                             VocoderHParams)
    from supertonic_tpu_torch.engine import SynthesisEngine, VoiceStyle
    from supertonic_tpu_torch.frontend import UnicodeProcessor, build_default_indexer
    from supertonic_tpu_torch.models import init_all
    from supertonic_tpu_torch.parallel import multihost

    multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=nprocs,
                         process_id=pid)
    multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=nprocs,
                         process_id=pid)  # already up: a no-op
    assert multihost.world_size() == nprocs and multihost.process_index() == pid
    counts = multihost.device_counts(local=2)  # each process: two CPU devices
    assert counts == [2] * nprocs, counts

    style_cfg = StyleTokenLayerConfig(n_style=4, style_value_dim=16)
    cfg = TTSConfig(
        ae=AEConfig(sample_rate=16000, base_chunk_size=64),
        ttl=TTLConfig(chunk_compress_factor=2, latent_dim=8, proj_out_idim=32,
                      proj_out_odim=64, style=style_cfg),
        dp=DPConfig(latent_dim=8, chunk_compress_factor=2, style=style_cfg),
        text_encoder=TextEncoderHParams(vocab_size=256, dim=32, n_layers=2, n_heads=2),
        duration_predictor=DurationPredictorHParams(vocab_size=256, dim=32, n_layers=2,
                                                    n_heads=2),
        vector_estimator=VectorEstimatorHParams(dim=64, n_layers=2, n_heads=2,
                                                time_embed_dim=32),
        vocoder=VocoderHParams(dim=64, upsample_factors=(4, 4), channels=(32, 16),
                               resblock_dilations=(1, 3)),
    )
    mesh = multihost.local_mesh(devices=["cpu"] * 2)  # DP within the host
    assert mesh.size == 2
    engine = SynthesisEngine(init_all(0, cfg), cfg, UnicodeProcessor(build_default_indexer()),
                             precision="f32", mesh=mesh)
    requests = [f"Distributed request number {i}." for i in range(8)]
    mine = multihost.host_shard(requests)
    assert len(mine) == len(requests) // nprocs
    rng = np.random.default_rng(0)
    b = len(mine)
    style = VoiceStyle(rng.standard_normal((b, 4, 16)).astype(np.float32),
                       rng.standard_normal((b, 4, 16)).astype(np.float32))
    wav, dur = engine.infer_batch(mine, ["en"] * b, style, total_step=2)
    assert wav.shape[0] == b and wav.ndim == 2
    assert np.all(dur > 0) and np.isfinite(wav).all()
    assert multihost.is_egress_host() == (pid == 0)
    print(f"MULTIPROC_OK pid={pid} nprocs={multihost.world_size()} "
          f"global_devices={sum(counts)} shard={len(mine)} wav={tuple(wav.shape)}",
          flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
