"""The port's pod on the CPU: its router over port HTTP servers
(``python -m supertonic_tpu_torch.serve.http_server``) in separate OS
processes, each serving the JAX tests' four-graph contract bundle through
the port's graph executor: the five cases of
tests/test_pod_multiprocess.py (serving, failover on process death,
restart under load, SIGTERM drain, and straggler shedding with
``TTS_FAULT_DELAY_S``)."""

import os
import socket
import subprocess
import sys
import threading
import time

import httpx
import pytest

from test_onnx_pipeline import onnx_dir  # noqa: F401  (module-scoped fixture)

from supertonic_tpu_torch.serve.router import Router, make_router_server

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_backend(onnx_dir: str, port: int,
                   extra_env: dict | None = None) -> subprocess.Popen:
    env = dict(os.environ)
    env.update(TTS_PLATFORM="cpu", TTS_ASSETS_DIR=onnx_dir,
               TTS_HOST="127.0.0.1", TTS_PORT=str(port), TTS_BATCHER="1")
    env["PYTHONPATH"] = os.pathsep.join([REPO] + ([env["PYTHONPATH"]]
                                                  if env.get("PYTHONPATH") else []))
    env.update(extra_env or {})
    return subprocess.Popen(
        [sys.executable, "-m", "supertonic_tpu_torch.serve.http_server"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=REPO,
    )


def _wait_healthy(url: str, proc: subprocess.Popen, timeout_s: float = 120):
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        if proc.poll() is not None:
            raise RuntimeError(f"backend died rc={proc.returncode}")
        try:
            if httpx.get(f"{url}/health", timeout=2).status_code == 200:
                return
        except httpx.HTTPError:
            time.sleep(0.5)
    raise TimeoutError(f"backend at {url} never became healthy")


@pytest.fixture(scope="module", autouse=True)
def rate_dir(tmp_path_factory):
    """The servers' learned-rate cache in a fresh folder, never the user's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTS_RATE_CACHE_DIR", str(tmp_path_factory.mktemp("rates")))
        for k in ("TTS_ONNX_FUSED", "TTS_ONNX_BF16", "TTS_FAULT_DELAY_S", "TTS_WARMUP"):
            mp.delenv(k, raising=False)
        yield


@pytest.fixture(scope="module")
def pod_procs(onnx_dir):  # noqa: F811
    ports = [_free_port(), _free_port()]
    procs = [_spawn_backend(onnx_dir, p) for p in ports]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    try:
        for u, pr in zip(urls, procs):
            _wait_healthy(u, pr)
        router = Router(urls, health_interval_s=0.2, failure_threshold=1)
        router.check_health()
        front = make_router_server(router, "127.0.0.1", 0)
        threading.Thread(target=front.serve_forever, daemon=True).start()
        front_url = f"http://127.0.0.1:{front.server_address[1]}"
        yield front_url, router, procs, urls
        front.shutdown()
        router.close()
    finally:
        for pr in procs:
            pr.terminate()
        for pr in procs:
            try:
                pr.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pr.kill()


def test_pod_serves_through_real_processes(pod_procs):
    front_url, router, procs, urls = pod_procs
    code, agg = router.health()
    assert code == 200 and agg["status"] == "ok"
    assert sum(b["healthy"] for b in agg["backends"].values()) == 2

    ok = 0
    for i in range(6):
        r = httpx.post(f"{front_url}/tts",
                       json={"text": f"Pod request number {i}.",
                             "total_step": 2}, timeout=120)
        assert r.status_code == 200, r.text
        assert r.headers["content-type"].startswith("audio/wav")
        assert len(r.content) > 44
        ok += 1
    assert ok == 6
    # every request landed on a real backend process
    total = sum(httpx.get(f"{u}/metrics", timeout=10).json()["requests"]
                for u in urls)
    assert total == 6


def test_pod_failover_on_process_death(pod_procs):
    front_url, router, procs, urls = pod_procs
    procs[0].terminate()
    procs[0].wait(timeout=10)
    deadline = time.time() + 10
    while time.time() < deadline:
        agg = router.health()[1]
        if sum(b["healthy"] for b in agg["backends"].values()) == 1:
            break
        time.sleep(0.2)
    # the router keeps serving from the survivor (retry path covers the
    # window where the dead backend is still marked healthy)
    r = httpx.post(f"{front_url}/tts",
                   json={"text": "After a host loss.", "total_step": 2},
                   timeout=120)
    assert r.status_code == 200


def test_pod_backend_restart_under_load(onnx_dir):  # noqa: F811
    """Elasticity: a backend is killed AND restarted mid-soak; the router
    must eject it, keep serving with zero client-visible errors through the
    loss window (bounded retry), re-admit it when its health endpoint
    recovers, and route NEW traffic to it again (VERDICT r2 item 8 — the
    health re-add path under live traffic)."""
    import signal

    ports = [_free_port(), _free_port()]
    procs = [_spawn_backend(onnx_dir, p) for p in ports]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    router = front = None
    stop = threading.Event()
    errors: list[str] = []
    ok_count = [0]

    def soak():
        i = 0
        while not stop.is_set():
            try:
                r = httpx.post(f"{front_url}/tts",
                               json={"text": f"Elastic request {i}.",
                                     "total_step": 2}, timeout=120)
                if r.status_code != 200 or len(r.content) <= 44:
                    errors.append(f"req {i}: {r.status_code}")
                else:
                    ok_count[0] += 1
            except Exception as e:  # noqa: BLE001 — any client error fails
                errors.append(f"req {i}: {type(e).__name__}: {e}")
            i += 1

    def healthy_count():
        return sum(b["healthy"] for b in router.health()[1]["backends"].values())

    try:
        for u, pr in zip(urls, procs):
            _wait_healthy(u, pr)
        router = Router(urls, health_interval_s=0.2, failure_threshold=1)
        router.check_health()
        router.start_health_loop()
        front = make_router_server(router, "127.0.0.1", 0)
        threading.Thread(target=front.serve_forever, daemon=True).start()
        front_url = f"http://127.0.0.1:{front.server_address[1]}"

        workers = [threading.Thread(target=soak) for _ in range(4)]
        for w in workers:
            w.start()
        # let traffic establish, then take backend 0 down
        deadline = time.time() + 30
        while ok_count[0] < 4 and time.time() < deadline:
            time.sleep(0.1)
        assert ok_count[0] >= 4, f"soak never got going: {errors[:3]}"
        procs[0].send_signal(signal.SIGTERM)
        procs[0].wait(timeout=30)
        deadline = time.time() + 15
        while healthy_count() != 1 and time.time() < deadline:
            time.sleep(0.1)
        assert healthy_count() == 1, "router never ejected the dead backend"
        before_down = ok_count[0]
        # serve through the loss window
        deadline = time.time() + 30
        while ok_count[0] < before_down + 4 and time.time() < deadline:
            time.sleep(0.1)
        assert ok_count[0] >= before_down + 4, "no progress during loss window"
        # restart on the SAME port: the health loop must re-admit it
        procs[0] = _spawn_backend(onnx_dir, ports[0])
        _wait_healthy(urls[0], procs[0])
        deadline = time.time() + 20
        while healthy_count() != 2 and time.time() < deadline:
            time.sleep(0.1)
        assert healthy_count() == 2, "router never re-admitted the restarted backend"
        base0 = httpx.get(f"{urls[0]}/metrics", timeout=10).json()["requests"]
        # traffic must reach the re-admitted backend again
        deadline = time.time() + 60
        while time.time() < deadline:
            if httpx.get(f"{urls[0]}/metrics",
                         timeout=10).json()["requests"] > base0:
                break
            time.sleep(0.2)
        else:
            raise AssertionError("re-admitted backend received no traffic")
        stop.set()
        for w in workers:
            w.join(timeout=120)
        assert not errors, f"{len(errors)} soak errors, first: {errors[:5]}"
        assert ok_count[0] >= 12
    finally:
        stop.set()
        if front is not None:
            front.shutdown()
        if router is not None:
            router.close()
        for pr in procs:
            if pr.poll() is None:
                pr.terminate()
        for pr in procs:
            try:
                pr.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pr.kill()


def test_graceful_sigterm_drain(onnx_dir):  # noqa: F811
    """SIGTERM mid-request: the in-flight response completes (200 + audio),
    the batcher shuts down, and the process exits 0 after draining."""
    import signal

    port = _free_port()
    proc = _spawn_backend(onnx_dir, port)
    base = f"http://127.0.0.1:{port}"
    try:
        _wait_healthy(base, proc)
        result = {}

        def long_req():
            text = ("A fairly long sentence for the drain test, with "
                    "words. " * 12)
            r = httpx.post(f"{base}/tts",
                           json={"text": text, "total_step": 5}, timeout=120)
            result["status"] = r.status_code
            result["bytes"] = len(r.content)

        t = threading.Thread(target=long_req)
        t.start()
        time.sleep(0.25)  # request now in flight
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=90)
        rc = proc.wait(timeout=90)
        assert result.get("status") == 200 and result.get("bytes", 0) > 44
        assert rc == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_pod_straggler_load_shedding(onnx_dir):  # noqa: F811
    """Straggler hardening (VERDICT r3 item 8): one backend is DEGRADED but
    alive — health checks pass, every synthesis request pays an injected
    delay ~10x the healthy service time (TTS_FAULT_DELAY_S). The router's
    least-expected-wait policy ((pending+1) x EWMA service time) must
    (a) shed almost all traffic onto the healthy backend and (b) keep
    client p95 latency bounded below the straggler's injected delay — the
    failure modes this guards against are round-robin (half of all
    requests queue behind the slow host) and pure least-pending (the idle
    straggler keeps being re-fed one request at a time, so ~1 request per
    delay-window pays full straggler latency and p95 sits AT the injected
    delay — measured before the EWMA policy landed)."""
    delay_s = 2.0  # ~10x the warm tiny-bundle service time on CPU
    ports = [_free_port(), _free_port()]
    # backend 0 is the straggler; list order means pending TIES pick it
    # first, so the test cannot pass by ordering luck
    procs = [
        _spawn_backend(onnx_dir, ports[0],
                       {"TTS_FAULT_DELAY_S": str(delay_s)}),
        _spawn_backend(onnx_dir, ports[1]),
    ]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    router = front = None
    errors: list[str] = []
    latencies: list[float] = []
    lat_lock = threading.Lock()
    try:
        for u, pr in zip(urls, procs):
            _wait_healthy(u, pr)
        # warm both backends DIRECTLY (first synthesis may compile); the
        # measured window must contain only steady-state service time
        for u in urls:
            r = httpx.post(f"{u}/tts", json={"text": "Warm up run.",
                                             "total_step": 2}, timeout=300)
            assert r.status_code == 200
        router = Router(urls, health_interval_s=0.2, failure_threshold=2)
        router.check_health()
        router.start_health_loop()
        # the straggler must STAY healthy the whole test: shedding has to
        # come from dispatch policy, not from health ejection
        agg = router.health()[1]
        assert sum(b["healthy"] for b in agg["backends"].values()) == 2
        front = make_router_server(router, "127.0.0.1", 0)
        threading.Thread(target=front.serve_forever, daemon=True).start()
        front_url = f"http://127.0.0.1:{front.server_address[1]}"

        n_workers, per_worker = 4, 16

        def soak(w: int):
            for i in range(per_worker):
                t0 = time.perf_counter()
                try:
                    r = httpx.post(
                        f"{front_url}/tts",
                        json={"text": f"Straggler probe {w}-{i}.",
                              "total_step": 2}, timeout=120)
                    if r.status_code != 200 or len(r.content) <= 44:
                        errors.append(f"req {w}-{i}: {r.status_code}")
                        return
                except Exception as e:  # noqa: BLE001
                    errors.append(f"req {w}-{i}: {type(e).__name__}: {e}")
                    return
                with lat_lock:
                    latencies.append(time.perf_counter() - t0)

        workers = [threading.Thread(target=soak, args=(w,))
                   for w in range(n_workers)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
        assert not errors, f"{len(errors)} errors, first: {errors[:5]}"
        total = n_workers * per_worker
        assert len(latencies) == total

        # (a) load shed: the straggler absorbed a small minority of traffic
        reqs = [httpx.get(f"{u}/metrics", timeout=10).json()["requests"]
                for u in urls]
        slow_share = (reqs[0] - 1) / total  # -1: the direct warmup request
        assert slow_share < 0.15, (
            f"straggler absorbed {slow_share:.0%} of traffic "
            f"(reqs={reqs}); dispatch failed to shed load")
        # (b) bounded client latency: p95 must sit BELOW the injected delay
        # (round-robin would put every other request behind the straggler,
        # pushing p95 to >= delay_s)
        p95 = sorted(latencies)[int(0.95 * (len(latencies) - 1))]
        assert p95 < delay_s, (
            f"client p95 {p95:.2f}s >= injected straggler delay {delay_s}s")
        # the straggler was never ejected: its traffic share came from
        # routing pressure, not health removal
        agg = router.health()[1]
        assert sum(b["healthy"] for b in agg["backends"].values()) == 2
    finally:
        if front is not None:
            front.shutdown()
        if router is not None:
            router.close()
        for pr in procs:
            if pr.poll() is None:
                pr.terminate()
        for pr in procs:
            try:
                pr.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pr.kill()
