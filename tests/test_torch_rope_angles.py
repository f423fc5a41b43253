"""The linear kernel's rope form brings a tile's cos and sin by TMA into
the consumer's output buffer and writes its results over them
(``csrc/linear.cu``, ``angles_by_tma``): a model of that layout on the CPU,
and the variant builds ``kernel_variants.py`` makes from the sources.

The layout model: a TMA box of ROWS rows of 128 bytes with the 128-byte
swizzle puts byte b of row r at r * 128 + ((b / 16) ^ (r % 8)) * 16 + b % 16
of its 1024-byte aligned buffer; cos fills the consumer's first box, sin the
next. The epilogue's thread (warp, lane g * 4 + t) reads the angles of
columns 8q + 2t, + 1 of its rows 64 r + 16 warp + g (+ 8) and writes its
result pairs where ``pair_at`` puts them. Exact integer arithmetic: no
tolerance."""

import re

import pytest

import kernel_variants as kv
from supertonic_tpu_torch.ops import _build

SOURCE = (_build.CSRC_DIR / "linear.cu").read_text()


def _tile(line):
    """(MI, BN, ES) of a Tile<...> line: a consumer's 64-row groups, the
    tile's columns, the result's bytes."""
    m = re.search(r"Tile<\d+, (\d+), (\d+), \d+, \d+, (\w+), (\w+), (\d+)", line)
    assert m, line
    mi, bn, coop, tma_store, es = m.groups()
    assert coop == "false" and tma_store == "true"
    return int(mi), int(bn), int(es)


def _swizzled(row, byte):
    return row * 128 + (((byte // 16) ^ (row % 8)) << 4) + byte % 16


# the rope form's tiles at Dh 64: the committed bf16 and W8A8 ones (128 x
# 128, two consumers) and the 64 x 128 tiles of three that
# kernel_variants.py times
TILES = {"RopeMany": kv.LIN_ROPE, "RopeMany8": kv.LIN_ROPE8,
         "64 x 128": "Tile<3, 1, 128, 7, 1, false, true, 2>"}


def test_the_rope_tiles_are_the_kernels():
    assert kv.LIN_ROPE in SOURCE and kv.LIN_ROPE8 in SOURCE


@pytest.mark.parametrize("name", sorted(TILES))
def test_each_rows_angles_lie_where_only_its_warp_writes(name):
    """At Dh 64 on the tiles that take the angles by TMA: every thread reads
    the cos and sin of its own columns, and each byte a result pair
    overwrites held an angle of the same row, which only the four threads of
    that row (one warp) read, before the warp's barrier."""
    mi, bn, es = _tile(TILES[name])
    dh, rows = 64, 64 * mi
    out = rows * bn * es  # the consumer's output buffer
    assert es == 2 and dh == 64 and 2 * rows * 128 <= out  # angles_by_tma
    # the TMA boxes: (kind, row, f32 column) at each byte of the buffer
    holds = {}
    for kind, base in (("cos", 0), ("sin", rows * 128)):
        for row in range(rows):
            for col in range(dh // 2):
                for b in range(4):
                    holds[base + _swizzled(row, 4 * col + b)] = (kind, row, col)
    readers, writers = {}, {}
    for warp in range(4):
        for g in range(8):
            for t in range(4):
                lane = (warp, g * 4 + t)
                for r in range(mi):
                    for half in range(2):
                        rr = 64 * r + 16 * warp + g + 8 * half
                        for q in range(dh // 16):  # the epilogue's reads
                            at = rr * 128 + (((2 * q + t // 2) ^ (rr % 8)) << 4) + 8 * (t % 2)
                            for base, kind in ((0, "cos"), (rows * 128, "sin")):
                                got = [holds[base + at + b] for b in range(8)]
                                assert got == [(kind, rr, 8 * q + 2 * t + b // 4)
                                               for b in range(8)]
                                readers.setdefault(rr, set()).add(lane)
                        for j in range(bn // 8):  # pair_at<S>(buf, j, rr, t), 4 bytes
                            at = (j // 8) * rows * 128 + rr * 128 + (((j % 8) ^ (rr % 8)) << 4)
                            for b in range(4):
                                assert at + 4 * t + b not in writers
                                writers[at + 4 * t + b] = (lane, rr)
    assert len(writers) == out  # the results fill the buffer, each byte once
    for byte, (lane, rr) in writers.items():
        if byte in holds:
            kind, row, _col = holds[byte]
            assert row == rr and lane in readers[rr]
            assert {w for w, _ in readers[rr]} == {lane[0]}  # one warp reads the row


@pytest.mark.parametrize("kernel", sorted(kv.VARIANTS))
def test_every_variant_builds_from_the_sources(kernel):
    """kernel_variants.py's variants and splits (--split) of each kernel: every
    substitution finds its text in the source it acts on, so a change to a
    kernel cannot silently leave a variant timing something else."""
    for name, subs in kv.variants_of(kernel, split=True).items():
        text = kv.variant_source(kernel, subs)
        assert text, name
        if subs and subs[0] != kv.FILE:
            assert all(new in text for _old, new in subs), name
