"""The bf16 attention kernel's whole-row form (``csrc/attention.cu``,
``attn_rows``): a model of its algorithm on the CPU, the route the C
launcher takes, and the cap the source states.

The model does what the form does at bf16 Dh 64 and Tk up to ``ROW_KEYS``:
the row's keys padded to whole 64-key boxes, the first ``kw`` = 32 ceil(Tk /
64) keys the first consumer warpgroup's, the next ``kw`` the second's; the
logits in log2 units with the key bias (-inf past Tk), each warpgroup's row
max and the two combined, one
exponential a logit, each warpgroup's row sum and the two added, p =
exp2(s - max) * (1 / sum) rounded to v's type, each warpgroup's partial P.V
in f32 and the two partials summed. It is held against the JAX package's
Pallas kernel (interpret mode) and the port's plain version, in f32 (1e-5:
exp2 with log2(e) folded in against exp, and other sum orders) and in bf16
(2e-2: bf16 inputs and outputs, probabilities rounded to bf16, as the port's
other bf16 attention tests)."""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supertonic_tpu.ops import fused_attention_interpret
from supertonic_tpu_torch.ops import _build, attention

LOG2E = 1.4426950408889634
SOURCE = (_build.CSRC_DIR / "attention.cu").read_text()
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def rows_model(q, k, v, key_mask=None, scale=None):
    """The whole-row form's algorithm; q [B, Tq, H, 64], k/v [B, Tk, H, 64]
    of one dtype, key_mask [B, Tk] or None -> [B, Tq, H, 64]."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if d != attention.ROW_DH or tk > attention.ROW_KEYS:
        raise ValueError(f"the whole-row form takes Dh {attention.ROW_DH} and Tk <= "
                         f"{attention.ROW_KEYS}, got Dh {d}, Tk {tk}")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    kw = 32 * -(-tk // 64)  # keys a consumer warpgroup
    slots = 2 * kw
    # keys past Tk as zeros (TMA's fill)
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, slots - tk)) for t in (k, v))
    key = torch.arange(slots)
    bias = torch.zeros((b, slots))
    if key_mask is not None:
        bias[:, :tk] = (1.0 - key_mask.float()) * (-1e9 * LOG2E)
    bias[:, key >= tk] = -math.inf
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (scale * LOG2E) + bias[:, None, None]
    ranges = (slice(0, kw), slice(kw, slots))
    m = torch.maximum(*(s[..., r].amax(-1, keepdim=True) for r in ranges))
    e = torch.exp2(s - m)
    inv_l = 1.0 / (e[..., ranges[0]].sum(-1, keepdim=True)
                   + e[..., ranges[1]].sum(-1, keepdim=True))
    p = (e * inv_l).to(v.dtype).float()
    o0, o1 = (torch.einsum("bhqk,bkhd->bqhd", p[..., r], vf[:, r]) for r in ranges)
    return (o0 + o1).to(q.dtype)


def _inputs(tk, dtype, seed, tq=65, b=2, h=1, masked=True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, 64)).astype(np.float32) for t in (tq, tk, tk))
    mask = None
    if masked:
        lens = rng.integers(max(1, tk // 2), tk + 1, (b,))
        lens[0] = tk
        mask = (np.arange(tk)[None] < lens[:, None]).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tq_, tk_, tv_ = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    return (tq_, tk_, tv_, tm), (jq, jk, jv, jm), mask


def _close(got, ref, dtype):
    if isinstance(ref, torch.Tensor):
        ref = ref.float().numpy()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("tk", [1, 5, 63, 64, 65, 370, 448, 511, 512])
def test_the_model_matches_pallas_and_the_plain_version(tk, dtype):
    """Tk below one tile, at a tile's edges, the cell's lengths and the cap."""
    (q, k, v, m), (jq, jk, jv, jm), _ = _inputs(tk, dtype, seed=tk)
    got = rows_model(q, k, v, m)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    _close(got, fused_attention_interpret(jq, jk, jv, jm), dtype)
    _close(got, attention.attention_plain(q, k, v, m), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_past_the_cap_the_two_pass_kernel_runs(dtype):
    """Tk = ROW_KEYS + 1 leaves the whole-row form: the launcher takes the
    two-pass kernel, whose plain version is the port's."""
    tk = attention.ROW_KEYS + 1
    (q, k, v, m), (jq, jk, jv, jm), _ = _inputs(tk, dtype, seed=7)
    assert attention.kernel_form(torch.bfloat16, 64, tk) == "two_pass"
    with pytest.raises(ValueError):
        rows_model(q, k, v, m)
    _close(attention.attention_plain(q, k, v, m), fused_attention_interpret(jq, jk, jv, jm),
           dtype)


@pytest.mark.parametrize("tk,valid", [(300, None), (30, None), (448, (224, 448)),
                                      (448, (0, 224))],
                         ids=["crossing the split", "one warpgroup's keys",
                              "the second range alone unmasked",
                              "the first range alone unmasked"])
def test_masked_rows(tk, valid):
    """A fully masked row gives the mean of v: Tk 300 puts masked keys in
    both warpgroups' ranges (160 each), Tk 30 all of them in the first (the
    second's 32 lie past Tk). With the keys of one range (224 each at Tk
    448) masked the row is the other range's softmax."""
    dtype = torch.float32
    (q, k, v, m), (jq, jk, jv, _), mask = _inputs(tk, dtype, seed=tk + 1)
    mask[0] = 0.0
    if valid is not None:
        mask[0, valid[0]:valid[1]] = 1.0
    m = torch.from_numpy(mask)
    got = rows_model(q, k, v, m)
    _close(got, fused_attention_interpret(jq, jk, jv, jnp.asarray(mask)), dtype)
    _close(got, attention.attention_plain(q, k, v, m), dtype)
    if valid is None:
        mean_v = v[0].mean(0, keepdim=True).expand_as(got[0])
        _close(got[0], mean_v.numpy(), dtype)
    else:
        lo, hi = valid
        alone = attention.attention_plain(q[:1], k[:1, lo:hi], v[:1, lo:hi])
        _close(got[:1], alone.numpy(), dtype)


def test_a_warpgroup_with_no_keys():
    """Tk 33 without a mask: the second warpgroup's keys 32 .. 63 hold one
    key below Tk; Tk 32 leaves it none (all -inf: it adds nothing)."""
    dtype = torch.bfloat16
    for tk in (32, 33):
        (q, k, v, _), (jq, jk, jv, _), _ = _inputs(tk, dtype, seed=tk, tq=320, masked=False)
        got = rows_model(q, k, v)
        _close(got, fused_attention_interpret(jq, jk, jv), dtype)
        _close(got, attention.attention_plain(q, k, v), dtype)


def test_the_cells_short_cross_row():
    """Tk 50 without a mask (the TE/DP cross attention): the second
    warpgroup's keys 32 .. 63, 18 of them past Tk."""
    dtype = torch.bfloat16
    (q, k, v, _), (jq, jk, jv, _), _ = _inputs(50, dtype, seed=50, tq=320, masked=False)
    got = rows_model(q, k, v)
    _close(got, fused_attention_interpret(jq, jk, jv), dtype)
    _close(got, attention.attention_plain(q, k, v), dtype)


# (dtype, Dh, Tk) -> the form csrc/attention.cu's launcher picks
ROUTES = [
    # the b64 cell (VE self and cross, TE/DP self and cross) and a streamed chunk
    ((torch.bfloat16, 64, 448), "rows"), ((torch.bfloat16, 64, 370), "rows"),
    ((torch.bfloat16, 64, 320), "rows"), ((torch.bfloat16, 64, 50), "rows"),
    # the cap's edges and the longer rows (the 640 bucket, long_1100)
    ((torch.bfloat16, 64, 512), "rows"), ((torch.bfloat16, 64, 513), "two_pass"),
    ((torch.bfloat16, 64, 640), "two_pass"), ((torch.bfloat16, 64, 1100), "two_pass"),
    # phase 12's widths; a width the wrapper pads to 64, and one it pads to 16
    ((torch.bfloat16, 16, 192), "two_pass"), ((torch.bfloat16, 32, 2560), "two_pass"),
    ((torch.bfloat16, 96, 192), "two_pass"), ((torch.bfloat16, 128, 448), "two_pass"),
    ((torch.bfloat16, 192, 320), "two_pass"), ((torch.bfloat16, 256, 320), "two_pass"),
    ((torch.bfloat16, 60, 448), "rows"), ((torch.bfloat16, 12, 63), "two_pass"),
    # past the panels, and f32 at every width
    ((torch.bfloat16, 320, 63), "wide"), ((torch.float32, 64, 448), "wide"),
    ((torch.float32, 64, 50), "wide"),
]


@pytest.mark.parametrize("key,form", ROUTES, ids=[f"{'bf16' if k[0] == torch.bfloat16 else 'f32'}"
                                                   f"-Dh{k[1]}-Tk{k[2]}" for k, _ in ROUTES])
def test_the_route(key, form):
    assert attention.kernel_form(*key) == form


def test_the_source_states_the_same_cap():
    """csrc/attention.cu's ROW_KEYS (two consumer warpgroups of ROW_KW keys)
    is the mirror's, and its launcher has one instance for each warpgroup
    width 32 ceil(Tk / 64) up to ROW_KW."""
    kw = int(re.search(r"constexpr int ROW_KW = (\d+);", SOURCE).group(1))
    dh = int(re.search(r"constexpr int DH = (\d+);", SOURCE).group(1))
    assert "constexpr int ROW_KEYS = 2 * ROW_KW;" in SOURCE
    assert 2 * kw == attention.ROW_KEYS and dh == attention.ROW_DH
    assert "switch (32 * ((Tk + 63) / 64)) {" in SOURCE
    for width in range(32, kw + 1, 32):
        assert f"case {width}: return launch_rows<{width}>(" in SOURCE
    assert f"case {kw + 32}: return launch_rows" not in SOURCE
