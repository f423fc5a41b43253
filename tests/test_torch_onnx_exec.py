"""The port's ONNX executor against the JAX one, op case by op case.

Every test of ``tests/test_onnx_exec.py`` runs here with its executor
replaced by ``Dual``, which runs each graph through both executors: float
outputs must agree within rtol=1e-5, atol=1e-6 (bf16-storage executors
within bf16's rounding, 1e-2), integer and bool outputs exactly, and a graph
the JAX executor refuses (``UnsupportedOp``, or any other error) must be
refused by the port with the same kind of error. The original test's own
oracle (numpy, torch) then checks the port's outputs. The four tests that
reach into the JAX executor's internals have port counterparts below.
"""

import inspect

import numpy as np
import pytest
import torch

import test_onnx_exec as J
from supertonic_tpu.assets import onnx_exec as jexec
from supertonic_tpu.assets import onnx_reader as jR
from supertonic_tpu_torch.assets import onnx_exec as texec
from supertonic_tpu_torch.assets import onnx_reader as tR

F32, I64 = np.float32, np.int64

# tests that reach the JAX executor's internals (weight swapping, the traced
# body with jnp inputs, Ctx): ported individually below
INTERNAL = {"test_small_float_initializers_are_jit_arguments",
            "test_time_mask_makes_bucket_padded_conv_stack_exact",
            "test_store_mixed_pointwise_policy"}


def _same_kind(j_exc, t_exc) -> bool:
    if isinstance(j_exc, jexec.UnsupportedOp):
        return isinstance(t_exc, texec.UnsupportedOp)
    return type(t_exc) is type(j_exc) or isinstance(t_exc, type(j_exc))


def _refused_alike(j_exc, fn):
    try:
        fn()
    except Exception as t_exc:  # noqa: BLE001 - compared with the JAX error
        assert _same_kind(j_exc, t_exc), (
            f"JAX raised {type(j_exc).__name__}: {j_exc}; the port raised "
            f"{type(t_exc).__name__}: {t_exc}")
    else:
        raise AssertionError(f"JAX raised {type(j_exc).__name__}: {j_exc}; "
                             f"the port ran")


def assert_agree(j_out, t_out, *, bf16=False):
    j_out, t_out = np.asarray(j_out), np.asarray(t_out)
    assert j_out.shape == t_out.shape, (j_out.shape, t_out.shape)
    if np.issubdtype(j_out.dtype, np.floating) or j_out.dtype.name == "bfloat16":
        tol = dict(rtol=1e-2, atol=1e-2) if bf16 else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t_out.astype(np.float64),
                                   j_out.astype(np.float64), **tol)
    else:
        np.testing.assert_array_equal(t_out, j_out)


class Dual:
    """Both executors on one graph; ``run`` holds them against each other
    and returns the port's outputs in the JAX outputs' dtypes."""

    def __init__(self, graph, **kw):
        data = graph._encoded
        self.bf16 = bool(kw.get("bf16_storage"))
        try:
            self.j = jexec.OnnxExecutor(graph, **kw)
        except Exception as e:
            _refused_alike(e, lambda: texec.OnnxExecutor(
                tR.parse_model(data), device="cpu", **kw))
            raise
        self.t = texec.OnnxExecutor(tR.parse_model(data), device="cpu", **kw)
        assert ([n.op_type for n in self.t._nodes]
                == [n.op_type for n in self.j._nodes])
        assert self.t.input_names == self.j.input_names
        assert self.t.output_names == self.j.output_names

    def __getattr__(self, name):
        return getattr(self.j, name)

    def run(self, output_names=None, feeds=None):
        try:
            j_outs = self.j.run(output_names, feeds)
        except Exception as e:
            _refused_alike(e, lambda: self.t.run(output_names, feeds))
            raise
        t_outs = self.t.run(output_names, feeds)
        assert len(j_outs) == len(t_outs)
        for a, b in zip(j_outs, t_outs):
            assert_agree(a, b, bf16=self.bf16)
        return [np.asarray(b).astype(np.asarray(a).dtype)
                for a, b in zip(j_outs, t_outs)]

    def __call__(self, feeds):
        return self.run(None, feeds)


def _cases():
    out = []
    for name, fn in inspect.getmembers(J, inspect.isfunction):
        if not name.startswith("test_") or name in INTERNAL:
            continue
        marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
        if not marks:
            out.append(pytest.param(name, {}, id=name))
            continue
        (mark,) = marks
        argnames = [a.strip() for a in mark.args[0].split(",")]
        for vals in mark.args[1]:
            vals = vals if isinstance(vals, (tuple, list)) else (vals,)
            kw = dict(zip(argnames, vals))
            out.append(pytest.param(name, kw, id=f"{name}[{'-'.join(map(str, vals))}]"))
    return out


@pytest.fixture
def dual(monkeypatch):
    parse = jR.parse_model

    def parse_keeping_bytes(data, *a, **kw):
        g = parse(data, *a, **kw)
        g._encoded = data
        return g

    monkeypatch.setattr(jR, "parse_model", parse_keeping_bytes)
    monkeypatch.setattr(J, "OnnxExecutor", Dual)


@pytest.mark.parametrize("name,params", _cases())
def test_op_case_agrees_with_the_jax_executor(dual, name, params):
    fn = getattr(J, name)
    sig = inspect.signature(fn)
    kw = dict(params)
    if "rng" in sig.parameters:
        kw["rng"] = np.random.default_rng(0)
    fn(**kw)


def test_registries_name_the_same_ops():
    assert sorted(texec._REGISTRY) == sorted(jexec._REGISTRY)
    for name, h in jexec._REGISTRY.items():
        assert getattr(texec._REGISTRY[name], "static_ok", False) == \
            getattr(h, "static_ok", False), name


# ---------------------------------------------------------------------------
# the port's counterparts of the internal tests
# ---------------------------------------------------------------------------

def _port(nodes, inits=None, inputs=(), outputs=(), **kw):
    node_bufs = [tR.encode_node(s[0], list(s[1]), list(s[2]), name=f"n{i}",
                                attrs=s[3] if len(s) > 3 else None)
                 for i, s in enumerate(nodes)]
    init_bufs = [tR.encode_tensor(k, np.asarray(v)) for k, v in (inits or {}).items()]
    data = tR.encode_model("g", node_bufs, init_bufs,
                           [tR.encode_value_info(n, d, s) for n, d, s in inputs],
                           [tR.encode_value_info(n, d, s) for n, d, s in outputs])
    return texec.OnnxExecutor(tR.parse_model(data), device="cpu", **kw)


def test_float_initializers_are_device_weights():
    x = np.random.default_rng(0).standard_normal((2, 4)).astype(F32)
    gain = np.array([1.0, 2.0, 3.0, 4.0], F32)
    ex = _port([("Mul", ["x", "g"], ["y"])], inits={"g": gain},
               inputs=[("x", F32, (2, 4))], outputs=[("y", F32, (2, 4))])
    assert isinstance(ex._weights["g"], torch.Tensor) and "g" not in ex._static_inits
    np.testing.assert_allclose(ex.run(None, {"x": x})[0], x * gain, rtol=1e-6)
    ex._weights["g"] = ex._weights["g"] * 10.0  # a swapped weight takes effect
    np.testing.assert_allclose(ex.run(None, {"x": x})[0], x * gain * 10.0, rtol=1e-6)
    ex = _port([("Resize", ["x", "", "s"], ["y"],
                 {"mode": "nearest", "coordinate_transformation_mode": "asymmetric",
                  "nearest_mode": "floor"})],
               inits={"s": np.array([1, 1, 2], F32)},
               inputs=[("x", F32, (1, 2, 4))], outputs=[("y", F32, (1, 2, 8))])
    assert "s" in ex._static_inits
    assert ex.run(None, {"x": x[:1, None, :].repeat(2, 1)})[0].shape == (1, 2, 8)


def test_time_mask_matches_the_jax_executor():
    """The bucket-padding mask: padded execution with the mask equals
    exact-length execution, and both executors agree with and without it."""
    from test_onnx_pipeline import _model

    rng = np.random.default_rng(7)
    c, up, k_up, k = 4, 4, 8, 3
    w = {"w_up": rng.standard_normal((c, c, k_up)).astype(F32) * 0.3,
         "b_up": rng.standard_normal((c,)).astype(F32),
         "w_c": rng.standard_normal((c, c, k)).astype(F32) * 0.3,
         "b_c": rng.standard_normal((c,)).astype(F32)}
    model = _model(
        [("ConvTranspose", ["latent", "w_up", "b_up"], ["h"],
          {"strides": [up], "kernel_shape": [k_up], "pads": [2, 2]}),
         ("Conv", ["h", "w_c", "b_c"], ["h2"],
          {"kernel_shape": [k], "dilations": [2], "pads": [2, 2]}),
         ("Tanh", ["h2"], ["wav"], None)],
        w, [("latent", F32, ("B", c, "T"))], [("wav", F32, ("B", c, "W"))])
    jex = jexec.OnnxExecutor(jR.parse_model(model))
    tex = texec.OnnxExecutor(tR.parse_model(model), device="cpu")
    t_true, pad = 11, 5
    x = rng.standard_normal((2, c, t_true)).astype(F32)
    xp = np.zeros((2, c, t_true + pad), F32)
    xp[:, :, :t_true] = x
    mask = (np.arange(t_true + pad) < t_true).astype(F32)
    (exact,) = tex._run_traced(tex._weights, (torch.from_numpy(x),))
    for m in (None, mask):
        (j_out,) = jex._run_traced(jex._weights, (xp,), m)
        (t_out,) = tex._run_traced(tex._weights, (torch.from_numpy(xp),),
                                   None if m is None else torch.from_numpy(m))
        assert_agree(np.asarray(j_out), t_out.numpy())
        if m is None:  # unmasked, the padded frames bleed into the tail
            assert not np.allclose(t_out.numpy()[..., :exact.shape[-1]],
                                   exact.numpy(), atol=1e-6)
    # torch's conv may sum in another order at another length: equal to
    # f32 rounding, where the unmasked run is off by the halo
    valid = t_out.numpy()[..., :exact.shape[-1]]
    np.testing.assert_allclose(valid, exact.numpy(), rtol=1e-5, atol=1e-6)


def test_store_mixed_pointwise_policy():
    from supertonic_tpu_torch.assets.onnx_reader import OnnxNode

    node = OnnxNode("Add", "n", ["a", "b"], ["t"], {})
    a16 = torch.ones((2, 3, 4), dtype=torch.bfloat16)
    b32 = torch.ones((2, 3, 4))
    tx = texec.TX(torch.device("cpu"), {})
    y = tx.add(a16, b32)  # promotion by dtype -> f32
    assert y.dtype == torch.float32
    on = {"__bf16_storage__": True, "__graph_outputs__": frozenset({"out"})}
    ctx = texec.Ctx(tx, {}, node, on)
    assert texec._store_mixed(ctx, y, a16, b32).dtype == torch.bfloat16
    assert texec._store_mixed(ctx, y, b32, b32).dtype == torch.float32
    assert texec._store_mixed(texec.Ctx(tx, {}, node, {}), y, a16, b32).dtype \
        == torch.float32
    out_node = OnnxNode("Add", "n2", ["a", "b"], ["out"], {})
    assert texec._store_mixed(texec.Ctx(tx, {}, out_node, on), y, a16, b32).dtype \
        == torch.float32
    ys = np.ones((2,), F32)
    assert texec._store_mixed(ctx, ys, a16, b32).dtype == F32


def test_a_zero_dim_tensor_promotes_like_a_jax_array():
    """torch lets a 0-dim f32 tensor take a bf16 operand's dtype; JAX
    promotes the pair to f32, and so does the port's namespace."""
    tx = texec.TX(torch.device("cpu"), {})
    y = tx.multiply(torch.ones(3, dtype=torch.bfloat16), np.float32(0.1))
    assert y.dtype == torch.float32
    assert tx.multiply(torch.ones(3, dtype=torch.bfloat16), 0.5).dtype == torch.bfloat16


def test_device_values_are_never_read_on_the_host():
    """A shape operand computed on the device is refused, not synced:
    the graph runs on meta tensors only as far as the refusal."""
    ex = _port([("Relu", ["s"], ["s2"]), ("Reshape", ["x", "s2"], ["y"])],
               inits={"s": np.array([4, 2], I64)},
               inputs=[("x", F32, (2, 4))], outputs=[("y", F32, (4, 2))])
    with pytest.raises(texec.UnsupportedOp):
        ex.run(None, {"x": np.zeros((2, 4), F32)})
    meta = torch.empty((2, 4), device="meta")
    ex2 = _port([("Shape", ["x"], ["s"]), ("Reshape", ["x", "s"], ["y"]),
                 ("Softmax", ["y"], ["z"])],
                inputs=[("x", F32, (2, 4))], outputs=[("z", F32, (2, 4))])
    (z,) = ex2._run_traced({}, (meta,))
    assert z.device.type == "meta" and tuple(z.shape) == (2, 4)


def test_values_are_released_after_their_last_use():
    """The env drops each intermediate after its last reader (the memory a
    captured program holds), never a graph output."""
    ex = _port([("Relu", ["x"], ["a"]), ("Neg", ["a"], ["b"]),
                ("LayerNormalization", ["b", "g"], ["c", "mean"], {"axis": -1}),
                ("Add", ["a", "c"], ["y"]), ("Exp", ["y"], ["z"])],
               inits={"g": np.ones(4, F32)},
               inputs=[("x", F32, (2, 4))], outputs=[("y", F32, (2, 4)), ("z", F32, (2, 4))])
    assert [sorted(d) for d in ex._drop] == [["x"], [], ["b", "g", "mean"], ["a", "c"], []]
    x = np.random.default_rng(0).standard_normal((2, 4)).astype(F32)
    y, z = ex.run(None, {"x": x})
    np.testing.assert_allclose(z, np.exp(y), rtol=1e-6)
