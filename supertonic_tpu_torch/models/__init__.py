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


def fuse_projections(params):
    """Derive fused QKV (self-attn) and KV (cross-attn) projection weights:
    fewer, larger matmuls per transformer block. A numpy copy of the JAX
    package's ``fuse_projections``; opt-in (the engine keeps params
    unfused)."""

    def cat(sub, keys):  # weights [din, dout] side by side, biases end to end
        return {n: np.concatenate([np.asarray(sub[k][n]) for k in keys], axis=axis)
                for n, axis in (("w", 1), ("b", 0))}

    def fuse_block(bp):
        bp = dict(bp)
        sa = bp["self"]
        bp["self"] = {"qkv": cat(sa, ("q", "k", "v")), "o": sa["o"]}
        if "cross" in bp:
            ca = bp["cross"]
            bp["cross"] = {"q": ca["q"], "kv": cat(ca, ("k", "v")), "o": ca["o"]}
        return bp

    out = {}
    for model, tree in params.items():
        tree = dict(tree)
        if "blocks" in tree:
            tree["blocks"] = [fuse_block(bp) for bp in tree["blocks"]]
        out[model] = tree
    return out


def quantize_params(params):
    """Derive W8A8 int8 weights (``layers.quantize_linear``) for the
    vector estimator's transformer-block linears (the only network inside
    the ``total_step`` loop): attention projections and FFN. Norms, AdaLN
    and the other linears stay as they are. A numpy copy of the JAX
    package's ``quantize_params`` at its default networks; applied by
    ``SynthesisEngine(precision="int8")``."""
    proj_keys = ("q", "k", "v", "o", "qkv", "kv")

    def q_block(bp):
        bp = dict(bp)
        for sub in ("self", "cross"):
            if sub in bp:
                bp[sub] = {k: (layers.quantize_linear(v) if k in proj_keys else v)
                           for k, v in bp[sub].items()}
        if "ffn" in bp:
            bp["ffn"] = {k: layers.quantize_linear(v) for k, v in bp["ffn"].items()}
        return bp

    out = {}
    for name, tree in params.items():
        if name == "vector_estimator":
            tree = dict(tree)
            tree["blocks"] = [q_block(bp) for bp in tree["blocks"]]
        out[name] = tree
    return out


def load_params(tree, *, device, dtype=torch.float32) -> torch.nn.Module:
    """The port's parameter modules from a JAX-layout param tree (the shape
    of ``init_all`` and of ``assets.store.unflatten_tree`` on a
    ``params.npz``). Linear weights [din, dout] and conv weights [k, cin,
    cout] are transposed to torch's layouts here; weight matrices go to
    ``dtype`` on ``device``, biases, norm parameters and W8A8 scales stay
    f32, W8A8 weights int8."""
    return layers.tree_to_modules(tree, device=device, dtype=dtype)


def to_numpy_tree(modules: torch.nn.Module):
    """Inverse of ``load_params``: the JAX-layout tree of numpy arrays, f32
    except the int8 W8A8 weights (exact for modules loaded in float32, and
    for W8A8 leaves in any dtype)."""
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
    "fuse_projections",
    "init_all",
    "load_params",
    "quantize_params",
    "text_encoder",
    "to_numpy_tree",
    "vector_estimator",
    "vocoder",
]
