from .batcher import ContinuousBatcher

__all__ = ["ContinuousBatcher"]
