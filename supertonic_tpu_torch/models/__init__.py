"""The four networks of the Supertonic pipeline in PyTorch, with the JAX
package's param tree as their exchange format."""

import numpy as np
import torch

from . import duration_predictor, layers, text_encoder, vector_estimator, vocoder


def init_all(seed: int, cfg):
    """Initialize all four networks from an int seed with numpy: the same
    arrays, bit for bit, as ``supertonic_tpu.models.init_all(seed, cfg)``.
    Returns the JAX-layout param tree (nested dicts/lists of f32 arrays)."""
    rng = np.random.default_rng(seed)
    return {
        "duration_predictor": duration_predictor.init(rng, cfg),
        "text_encoder": text_encoder.init(rng, cfg),
        "vector_estimator": vector_estimator.init(rng, cfg),
        "vocoder": vocoder.init(rng, cfg),
    }


def load_params(tree, *, device, dtype=torch.float32) -> torch.nn.Module:
    """The port's parameter modules from a JAX-layout param tree (the shape
    of ``init_all`` and of ``assets.store.unflatten_tree`` on a
    ``params.npz``). Linear weights [din, dout] and conv weights [k, cin,
    cout] are transposed to torch's layouts here; weight matrices go to
    ``dtype`` on ``device``, biases and norm parameters stay f32."""
    return layers.tree_to_modules(tree, device=device, dtype=dtype)


def to_numpy_tree(modules: torch.nn.Module):
    """Inverse of ``load_params``: the JAX-layout tree of f32 numpy arrays
    (exact for modules loaded in float32)."""
    return layers.modules_to_tree(modules)


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return int(np.prod(np.shape(tree)))


__all__ = [
    "count_params",
    "duration_predictor",
    "init_all",
    "load_params",
    "text_encoder",
    "to_numpy_tree",
    "vector_estimator",
    "vocoder",
]
