"""``python -m supertonic_tpu_torch`` runs the CLI (reference example flags)."""

from .serve.cli import main

main()
