"""The silu table of the linear kernel's silu and silu-quantize epilogues
(``supertonic_tpu_torch/csrc/silu_table.cuh``), on the CPU: its rule,
mirrored in plain PyTorch with the bounds read from the header that the
kernels compile, is F.silu rounded to bf16 at every one of the 65,536 bf16
bit patterns, and the table fits beside the silu-quantize form's resident
weights and ring. The table's entries are the exact sequence's values on the
card (``stk::silu_bf16_torch``), which chip_smoke.py holds against F.silu at
every finite bf16 value, as it holds every kernel that reads the table.

Exact: bit for bit, with NaN wherever F.silu gives NaN (NaN and -inf)."""

import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

CSRC = Path(__file__).resolve().parent.parent / "supertonic_tpu_torch" / "csrc"
SMEM_PER_BLOCK = 232448  # the H100's shared memory a block can take


def _constant(text: str, name: str) -> int:
    m = re.search(rf"constexpr (?:int|bool) {name} = (-?\w+);", text)
    assert m, f"{name} not defined"
    return {"true": 1, "false": 0}.get(m.group(1)) if m.group(1) in ("true", "false") \
        else int(m.group(1))


def _bounds() -> tuple[int, int]:
    text = (CSRC / "silu_table.cuh").read_text()
    return _constant(text, "SILU_TAB_EMIN"), _constant(text, "SILU_TAB_EMAX")


def _all_bf16():
    """Every bf16 bit pattern, as bf16, and its 16 bits as int32."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    return bits.view(torch.bfloat16), bits.to(torch.int32) & 0xFFFF


def _table():
    """The table the kernels fill, from F.silu: 128 (EMAX - EMIN + 1) words,
    word i holding silu(+v) and silu(-v) (v the bf16 value of bits LO + i,
    LO = (127 + EMIN) 2^7, 2^EMIN <= v < 2^(EMAX + 1)) in its low and high
    halves, as int32; and LO."""
    emin, emax = _bounds()
    lo = (127 + emin) << 7
    v = (lo + torch.arange((emax - emin + 1) * 128, dtype=torch.int32)).to(torch.int16)
    v = v.view(torch.bfloat16).float()
    low, high = (F.silu(s * v).bfloat16().view(torch.int16).to(torch.int32) & 0xFFFF
                 for s in (1.0, -1.0))
    return low | (high << 16), lo


def _half(word: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    return torch.where(neg, (word >> 16) & 0xFFFF, word & 0xFFFF)


def _bf16(bits: torch.Tensor) -> torch.Tensor:
    return (bits & 0xFFFF).to(torch.int16).view(torch.bfloat16)


def silu_fast_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """silu_bf16x2_table's arithmetic on each value of bf16 x: the word at
    |x|'s bits less LO, clamped to the table, the half the sign picks, plus
    min(|x| bits - LO, 0) no less than 0x80 - LO (an exponent one less below
    the table, down to +-0); and where that is exact (|x| bits 0 or 1, or
    from SILU_FAST_LO to LO + the table's words)."""
    table, lo = _table()
    u = x.view(torch.int16).to(torch.int32) & 0xFFFF
    a, neg = u & 0x7FFF, u >= 0x8000
    i = a - lo
    r = _half(table[i.clamp(0, table.numel() - 1)], neg) + i.clamp(0x80 - lo, 0)
    return _bf16(r), (a <= 1) | ((a >= 0x100) & (a < lo + table.numel()))


def silu_rest_plain(x: torch.Tensor, nan_as_zero: bool = False) -> torch.Tensor:
    """silu_bf16_rest on each value of bf16 x: the table where |x| lies in
    it, rnd(x / 2) below it, x above it (x > 0), -0 below -2^(EMAX + 1), NaN
    (nan_as_zero: -0) for NaN and -inf."""
    table, lo = _table()
    u = x.view(torch.int16).to(torch.int32) & 0xFFFF
    a, neg = u & 0x7FFF, u >= 0x8000
    i = a - lo
    in_table = (i >= 0) & (i < table.numel())
    looked_up = _bf16(_half(table[torch.where(in_table, i, 0)], neg))
    small = (x.float() * 0.5).bfloat16()
    big = torch.where(neg, torch.full_like(x, -0.0), x)
    out = torch.where(in_table, looked_up, torch.where(a < lo, small, big))
    nan = (a > 0x7F80) | (neg & (a == 0x7F80))
    return torch.where(nan, torch.full_like(x, -0.0 if nan_as_zero else float("nan")), out)


def _region(u: torch.Tensor, name: str) -> torch.Tensor:
    emin, emax = _bounds()
    a, neg = u & 0x7FFF, u >= 0x8000
    lo, hi = (127 + emin) << 7, (128 + emax) << 7
    return {"table": (a >= lo) & (a < hi), "below": a < lo,
            "above, positive": (a >= hi) & ~neg & (a <= 0x7F80),
            "above, negative": (a >= hi) & neg & (a < 0x7F80),
            "NaN and -inf": (a > 0x7F80) | (neg & (a == 0x7F80))}[name]


@pytest.mark.parametrize("region", ["table", "below", "above, positive", "above, negative",
                                    "NaN and -inf"])
def test_rest_is_f_silu_at_every_bf16_pattern(region):
    x, u = _all_bf16()
    sel = _region(u, region)
    got = silu_rest_plain(x)[sel]
    want = F.silu(x.float()).bfloat16()[sel]
    assert sel.any()
    both_nan = torch.isnan(got.float()) & torch.isnan(want.float())
    if region == "NaN and -inf":
        assert both_nan.all()
        assert torch.equal(silu_rest_plain(x, nan_as_zero=True)[sel].view(torch.int16),
                           torch.full_like(got, -0.0).view(torch.int16))
    else:
        assert not both_nan.any()
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("region", ["table", "below"])
def test_fast_path_is_f_silu_on_its_domain(region):
    """The fast path (the clamped lookup plus the small values' exponent
    step) at every bf16 pattern of its domain in the region: the table's
    values, the normal values from 2^-125 below it, the zeros and the least
    subnormals; the patterns outside the domain are those the kernels redo
    (the other subnormals, 2^-126, |x| from 2^(EMAX + 1), NaN)."""
    x, u = _all_bf16()
    got, exact = silu_fast_plain(x)
    sel = _region(u, region) & exact
    want = F.silu(x.float()).bfloat16()
    assert sel.any()
    assert torch.equal(got[sel].view(torch.int16), want[sel].view(torch.int16))
    outside = ~exact & torch.isfinite(x.float())
    assert int(outside.sum()) == 2 * (0x100 - 2) + 2 * int(_region(u, "above, positive").sum() - 1)


def test_regions_cover_every_pattern_once():
    _, u = _all_bf16()
    names = ["table", "below", "above, positive", "above, negative", "NaN and -inf"]
    counts = torch.stack([_region(u, n).int() for n in names]).sum(0)
    assert torch.equal(counts, torch.ones_like(counts))
    emin, emax = _bounds()
    assert int(_region(u, "table").sum()) == 2 * 128 * (emax - emin + 1)


def test_table_holds_every_value_that_no_closed_form_gives():
    """Outside the table's exponents the closed forms are F.silu; inside
    them neither closed form is at some values of either sign, so the table
    is needed at both."""
    x, u = _all_bf16()
    want = F.silu(x.float()).bfloat16().view(torch.int16)
    emin, _ = _bounds()
    e = ((u & 0x7FFF) >> 7) - 127
    neg = u >= 0x8000
    closed = torch.where(e < emin, (x.float() * 0.5).bfloat16(),
                         torch.where(neg, torch.full_like(x, -0.0), x)).view(torch.int16)
    needs = (closed != want) & torch.isfinite(x.float())
    table = _region(u, "table")
    assert needs[table & neg].any() and needs[table & ~neg].any()
    assert not needs[~table].any()


def _tile(text: str, name: str) -> list[int]:
    m = re.search(rf"using {name} = Tile<([^>]*)>;", text)
    assert m, f"{name} not in linear.cu"
    return [{"true": 1, "false": 0}.get(a.strip(), None) if a.strip() in ("true", "false")
            else int(a) for a in m.group(1).split(",")]


def test_table_fits_beside_the_silu_quantize_tile():
    """linear.cu's Tile::SMEM and smem_of for the silu-quantize form (SiluQ:
    W8A8, W resident, the exchange slots of a cluster of SQ_BLOCKS) plus the
    table, within a block's shared memory."""
    text = (CSRC / "linear.cu").read_text()
    assert _constant(text, "SILU_BY_TABLE") == 1
    sq_blocks = _constant(text, "SQ_BLOCKS")
    nc, mi, bn, ns, bps, coop, tma_store, es, wrs = _tile(text, "SiluQ")
    assert (mi, bps, coop, tma_store, es) == (1, 1, 0, 1, 1) and wrs > 0
    emin, emax = _bounds()
    table = 2 * 2 * 128 * (emax - emin + 1)

    def smem(stages: int) -> int:
        rows = 64 * mi
        tile = (stages * rows * 128 + wrs * bn * 128 + nc * (rows * bn * es + 4 * bn)
                + 16 * stages + 16 * nc + 1024)
        return tile + nc * 4 * bn + 8 * (1 + 2 * nc) + nc * 2 * sq_blocks * rows * 4 + table

    assert table == 9216
    assert smem(ns) <= SMEM_PER_BLOCK
