"""Command-line tools of the port, run with ``python -m``:
``parity_check`` (the graph backend's parity gate) and
``bench_onnx_backend`` (the adapter against the fused backend)."""
