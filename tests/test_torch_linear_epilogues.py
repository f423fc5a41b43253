"""The linear kernel's rope and residual forms (``ops.linear.linear`` with
``rope=`` or ``residual=``): the Q, K and O projections' XLA output fusion,
on the CPU. Their plain versions against the JAX package's ``linear`` with
``apply_rope`` and with the gated residual ``x + gate * linear(...)``; the
layers' routing (a bf16 plain ``Linear`` takes the forms, one call each; f32
and sharded linears keep the bias-and-rope and gated-residual kernels; W8A8
blocks are tests/test_torch_w8a8_epilogues.py's) bit for bit the earlier
two-call route over whole blocks; and what
the wrapper refuses. chip_smoke.py holds the CUDA kernel against these
plain versions on the card.

Tolerances. f32: 1e-5 absolute (the sums' order). bf16: the product y
rounded by sums in another order than XLA's (one bf16 step, 2^-7 |y|), the
bias add's rounding (2^-7 |o|), both carried through the rotation (|cos|,
|sin| <= 1, two terms) or the gate (|g|), the gate's product's rounding
and the last rounding (2^-7 each), plus 2^-14 of the largest |y| for sums
that cancel far below their terms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supertonic_tpu.models import layers as jL
from supertonic_tpu_torch.models import layers as L
from supertonic_tpu_torch.ops import linear
from supertonic_tpu_torch.parallel import make_mesh
from supertonic_tpu_torch.parallel.mesh import shard_params

BF16 = torch.bfloat16
STEP = 2.0 ** -7  # one bf16 step, relative


def _dtypes(name):
    return (torch.float32, jnp.float32) if name == "f32" else (BF16, jnp.bfloat16)


def _linear_params(rng, k, n):
    return {"w": (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32),
            "b": (0.3 * rng.standard_normal(n)).astype(np.float32)}


def _jax_linear(p, x, jdt):
    return jL.linear({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x.float().numpy(), jdt))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bound, dtype):
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        err = np.abs(got - want)
        assert (err <= bound).all(), float((err / bound).max())


# ---------------------------------------------------------------------------
# the forms against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dh", [16, 64, 96, 128, 256])
def test_rope_form_matches_jax(dh, dtype):
    """``linear(..., rope=(cos, sin), n_heads=H)`` against JAX's
    ``apply_rope(_split_heads(linear(p, x)))`` with LARoPE angles, and bit
    for bit the earlier route: the product, then the bias-and-rope kernel's
    wrapper (``layers._heads``)."""
    tdt, jdt = _dtypes(dtype)
    rng = np.random.default_rng(dh)
    b, t, heads, k = 2, 7, 2, 48
    p = _linear_params(rng, k, heads * dh)
    lengths = np.array([t, t - 3], np.float32)
    pos = jL.larope_positions(jnp.asarray(lengths), t, 100.0)
    cos, sin = (np.array(a) for a in jL.rope_angles(pos, dh, 10000.0))
    mod = L.tree_to_modules(p, device="cpu", dtype=tdt)
    x = torch.as_tensor(rng.standard_normal((b, t, k)).astype(np.float32)).to(tdt)
    rope = (torch.as_tensor(cos), torch.as_tensor(sin))
    got = linear.linear(x, mod.weight, mod.bias, rope=rope, n_heads=heads)
    assert got.dtype == tdt and got.shape == (b, t, heads, dh)
    assert torch.equal(got, L._heads(*L._product(mod, x), rope, heads))
    want = _np(jL.apply_rope(jL._split_heads(_jax_linear(p, x, jdt), heads), cos, sin))
    y = L._product(mod, x)[0].float().reshape(b, t, heads, dh).abs()
    o = L.linear(mod, x).float().reshape(b, t, heads, dh).abs()
    amp = sum(torch.cat([a + c, a + c], dim=-1) for a, c in (y.chunk(2, dim=-1),
                                                             o.chunk(2, dim=-1)))
    bound = STEP * (amp.numpy() + np.abs(want)) + 2.0 ** -14 * float(y.max())
    _close(got, want, bound, tdt)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gate", ["batch rows", "one row", "none"])
@pytest.mark.parametrize("n", [16, 64, 96, 128, 256])
def test_residual_form_matches_jax(n, gate, dtype):
    """``linear(..., residual=r, gate=g)`` against JAX's ``r + g *
    linear(p, h)`` with a gate of a row a batch row (a strided [B, 1, N]
    slice of one AdaLN projection, as ``block`` takes it), of one row for
    all, and without a gate (``r + linear``); bit for bit the earlier route:
    the product, then the gated-residual kernel's wrapper
    (``layers._close``)."""
    tdt, jdt = _dtypes(dtype)
    rng = np.random.default_rng(n + len(gate))
    b, t, k = 3, 5, 40
    p = _linear_params(rng, k, n)
    mod = L.tree_to_modules(p, device="cpu", dtype=tdt)
    h = torch.as_tensor(rng.standard_normal((b, t, k)).astype(np.float32)).to(tdt)
    r = torch.as_tensor(rng.standard_normal((b, t, n)).astype(np.float32)).to(tdt)
    mods = torch.as_tensor((0.5 * rng.standard_normal((b, 1, 3 * n))).astype(np.float32))
    g = {"batch rows": mods.to(tdt).chunk(3, dim=-1)[2], "one row": mods[:1].to(tdt)[..., :n],
         "none": None}[gate]
    got = linear.linear(h, mod.weight, mod.bias, residual=r, gate=g)
    assert got.dtype == tdt and got.shape == (b, t, n)
    assert torch.equal(got, L._close(*L._product(mod, h), r, g))
    jg = 1.0 if g is None else jnp.asarray(g.float().numpy(), jdt)
    want = _np(jnp.asarray(r.float().numpy(), jdt) + jg * _jax_linear(p, h, jdt))
    gm = 1.0 if g is None else g.float().abs().numpy()
    y = L._product(mod, h)[0].float().abs().numpy()
    o = L.linear(mod, h).float().abs().numpy()
    bound = STEP * (gm * (y + 2 * o) + np.abs(want)) + 2.0 ** -14 * float(y.max()) * np.max(gm)
    _close(got, want, bound, tdt)


# ---------------------------------------------------------------------------
# the layers' routing over whole blocks
# ---------------------------------------------------------------------------

def _block_params(seed, dim, *, cross, adaln):
    """block_init's tree with random biases and AdaLN weights (block_init
    zeroes them: the gates would be zero and every bias add trivial)."""
    rng = np.random.default_rng(seed)
    p = L.block_init(rng, dim, 2, cross_dim=dim if cross else None, adaln=adaln, cond_dim=dim)

    def perturb(node):
        if isinstance(node, dict):
            if set(node) == {"w", "b"}:
                node["b"] = (0.2 * rng.standard_normal(node["b"].shape)).astype(np.float32)
                if not node["w"].any():
                    node["w"] = (0.2 * rng.standard_normal(node["w"].shape)).astype(np.float32)
            for v in node.values():
                perturb(v)
    perturb(p)
    return p


def _block_inputs(seed, dim, heads, dtype, *, cross, adaln):
    """Keyword arguments of ``layers.block``: masks with padded rows, LARoPE
    angles for the self-attention and, with ``cross``, for the cross Q and
    the memory's K (as the vector estimator), an AdaLN condition."""
    rng = np.random.default_rng(seed)
    b, t, s = 2, 9, 6
    dh = dim // heads
    kw = {"self_mask": torch.as_tensor(np.arange(t)[None] < np.array([[t], [t - 4]])).float()}
    q_pos = L.larope_positions(kw["self_mask"].sum(-1), t, 100.0)
    kw["self_rope"] = L.rope_angles(q_pos, dh, 10000.0)
    if cross:
        kw["memory"] = torch.as_tensor(rng.standard_normal((b, s, dim)).astype(np.float32)).to(
            dtype)
        kw["memory_mask"] = torch.as_tensor(np.arange(s)[None] < np.array([[s], [s - 2]])).float()
        kw["q_rope_cross"] = kw["self_rope"]
        kw["k_rope_cross"] = L.rope_angles(L.larope_positions(kw["memory_mask"].sum(-1), s,
                                                              100.0), dh, 10000.0)
    if adaln:
        kw["cond"] = torch.as_tensor(rng.standard_normal((b, dim)).astype(np.float32)).to(dtype)
    x = torch.as_tensor(rng.standard_normal((b, t, dim)).astype(np.float32)).to(dtype)
    return x, kw


def _earlier_route(monkeypatch):
    """The routing before the forms: each Q and K the product and the
    bias-and-rope kernel (or the bias form, head-split), each O and FFN-out
    the product and the gated-residual kernel."""
    real = L.linear

    def earlier(p, x, *, rope=None, n_heads=0, residual=None, gate=None, **kw):
        if rope is not None:
            return L._heads(*L._product(p, x), rope, n_heads)
        if residual is not None:
            return L._close(*L._product(p, x), residual, gate)
        y = real(p, x, **kw)
        return L._split_heads(y, n_heads) if n_heads else y
    monkeypatch.setattr(L, "linear", earlier)


def _counted(monkeypatch):
    """Counts of the bias-and-rope and gated-residual wrappers' calls and of
    the linear wrapper's calls by form, over what runs after this call."""
    seen = dict.fromkeys(("bias_rope", "gated_residual", *linear.FORMS), 0)
    for name in ("bias_rope", "gated_residual"):
        def counted(*args, _fn=getattr(L, name), _name=name, **kw):
            seen[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(L, name, counted)
    real = L.linear_fused

    def counting(x, w, b, **kw):
        seen["tail" if kw.get("tail") is not None else "rope" if kw.get("rope") is not None
             else "residual" if kw.get("residual") is not None
             else "silu" if kw.get("silu") else "bias"] += 1
        return real(x, w, b, **kw)
    monkeypatch.setattr(L, "linear_fused", counting)
    return seen


BLOCKS = {  # (cross-attention, AdaLN, fused_ffn): the networks' blocks
    "VE: cross, AdaLN, fused FFN": (True, True, True),
    "VE: cross, AdaLN, unfused FFN": (True, True, False),
    "TE/DP: cross, no AdaLN": (True, False, True),
    "self-attention and AdaLN alone": (False, True, False),
    "self-attention alone": (False, False, True)}


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("case", list(BLOCKS))
def test_bf16_block_routing_is_the_earlier_route(case, heads, monkeypatch):
    """A bf16 block through the forms (every plain Linear's Q and K with
    LARoPE in the rope form, O and FFN-out in the residual form, a cross Q
    and K without rotation in the bias form) bit for bit the block through
    the earlier two-call route; the bias-and-rope and gated-residual
    wrappers are not called."""
    cross, adaln, fused_ffn = BLOCKS[case]
    dim = 64
    p = L.tree_to_modules(_block_params(len(case) + heads, dim, cross=cross, adaln=adaln),
                          device="cpu", dtype=BF16)
    x, kw = _block_inputs(heads, dim, heads, BF16, cross=cross, adaln=adaln)
    with monkeypatch.context() as m:
        seen = _counted(m)
        got = L.block(p, x, heads, fused_ffn=fused_ffn, **kw)
    assert seen["bias_rope"] == seen["gated_residual"] == 0
    assert seen["rope"] == 2 + (2 if cross else 0)
    assert seen["residual"] == 1 + cross + (not (adaln and fused_ffn))
    with monkeypatch.context() as m:
        _earlier_route(m)
        want = L.block(p, x, heads, fused_ffn=fused_ffn, **kw)
    assert got.dtype == BF16 and torch.equal(got, want)


@pytest.mark.parametrize("route", ["f32", "sharded bf16"])
def test_other_linears_keep_the_elementwise_kernels(route, monkeypatch):
    """f32 and sharded (tensor-parallel) blocks keep the product and the
    bias-and-rope and gated-residual kernels: the linear wrapper takes no
    rope or residual form there, and the block is the earlier route's bit
    for bit. (A bf16 W8A8 block takes the W8A8 product's forms:
    tests/test_torch_w8a8_epilogues.py.)"""
    dim, heads = 64, 2
    tree = _block_params(7, dim, cross=True, adaln=True)
    dtype = torch.float32 if route == "f32" else BF16
    if route == "sharded bf16":
        mesh = make_mesh(devices=["cpu", "cpu"], model_parallel=2)
        p = shard_params({"blocks": [tree]}, mesh, dtype=BF16)[0]["blocks"][0]
        assert isinstance(p["self"]["o"], L.ShardedLinear)
    else:
        p = L.tree_to_modules(tree, device="cpu", dtype=dtype)
    x, kw = _block_inputs(3, dim, heads, dtype, cross=True, adaln=True)
    with monkeypatch.context() as m:
        seen = _counted(m)
        got = L.block(p, x, heads, fused_ffn=False, **kw)
    assert seen["rope"] == seen["residual"] == 0
    # self Q and K, cross Q and K (on each rank's heads when sharded); self
    # O, cross O, FFN-out
    assert seen["bias_rope"] == 4 * L.tp_ranks(p["self"]) and seen["gated_residual"] == 3
    with monkeypatch.context() as m:
        _earlier_route(m)
        want = L.block(p, x, heads, fused_ffn=False, **kw)
    assert got.dtype == dtype and torch.equal(got, want)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "rope with silu", "rope with the tail", "residual with silu", "residual with rope",
    "a gate without the residual", "rope on 2-d x", "heads that do not divide N",
    "an odd head width", "cos of another length", "residual of another width",
    "gate of another width"])
def test_linear_refuses_bad_forms(case):
    x = torch.zeros((2, 5, 8), dtype=BF16)
    w = torch.zeros((12, 8), dtype=BF16)
    b = torch.zeros(12)
    half = (torch.zeros((2, 5, 3)), torch.zeros((2, 5, 3)))
    r = torch.zeros((2, 5, 12), dtype=BF16)
    tail = (torch.zeros((2, 5, 12)), torch.ones(2), torch.ones((2, 5)))
    calls = {
        "rope with silu": lambda: linear.linear(x, w, b, rope=half, n_heads=2, silu=True),
        "rope with the tail": lambda: linear.linear(x, w, b, rope=half, n_heads=2, tail=tail),
        "residual with silu": lambda: linear.linear(x, w, b, residual=r, silu=True),
        "residual with rope": lambda: linear.linear(x, w, b, residual=r, rope=half, n_heads=2),
        "a gate without the residual": lambda: linear.linear(x, w, b, gate=r[:, :1]),
        "rope on 2-d x": lambda: linear.linear(x[0], w, b, rope=half, n_heads=2),
        "heads that do not divide N": lambda: linear.linear(x, w, b, rope=half, n_heads=5),
        "an odd head width": lambda: linear.linear(x, w, b, rope=half, n_heads=4),
        "cos of another length": lambda: linear.linear(
            x, w, b, rope=(torch.zeros((2, 4, 3)), torch.zeros((2, 4, 3))), n_heads=2),
        "residual of another width": lambda: linear.linear(x, w, b, residual=r[..., :6]),
        "gate of another width": lambda: linear.linear(x, w, b, residual=r,
                                                       gate=torch.zeros((2, 1, 6), dtype=BF16)),
    }
    with pytest.raises(ValueError):
        calls[case]()


# ---------------------------------------------------------------------------
# the device trace's check that the bf16 batch runs no library product
# ---------------------------------------------------------------------------

TRACE_NAMES = {  # a kernel name in a device trace: whether it is a library product
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_"
    "execute_segment_k_off_kernel__5x_cublas": True,
    "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTN": True,
    "void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_128x2_tn_"
    "align8>(cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_128x2_tn_align8::Params)": True,
    "void gemv2T_kernel_val<int, int, __nv_bfloat16, float, float, 128, 16, 4, 4, false>": True,
    "void stk::wgmma_gemm<(anonymous namespace)::Bf16Op, (anonymous namespace)::Tile, "
    "(anonymous namespace)::SiluOut>(CUtensorMap, CUtensorMap, int)": False,
    "void (anonymous namespace)::mma_gemm<(anonymous namespace)::Int8Op>(int)": False,
    "_ZN3stk10wgmma_gemmIN12_GLOBAL__N_15Bf16OpEEEv14CUtensorMap_st": False,
    "void (anonymous namespace)::linear_wgmma<3, (anonymous namespace)::Tile<2, 2, 128, 5, "
    "1, false, true, 2>, 64>(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap)": False,
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>":
        False}


@pytest.mark.parametrize("name", list(TRACE_NAMES))
def test_trace_filter_tells_library_products_from_the_ports_gemms(name):
    """chip_smoke.py's phase 3 check (no library matrix product in the
    replayed bf16 batch) and elementwise_split.py's kinds flag cuBLAS's
    kernels, xmma_gemm among them, and pass the port's own GEMM kernels."""
    import chip_smoke
    import elementwise_split

    library = TRACE_NAMES[name]
    assert chip_smoke.library_product(name) is library
    kind = elementwise_split.kind(name)
    assert (kind == "library products") is library
    assert (kind == "hand-written") is ("wgmma" in name or "mma_gemm<" in name
                                        or "wgmma_gemmI" in name)

