"""The linear kernel's residual form (``csrc/linear.cu``, MODE_RESID of
``linear_wgmma`` and ``w8a8_wgmma``) walks its output tiles at many tiles
on ``ManyResid``'s 64 x 128 tiles of three consumers in turns, the
residual by TMA into the consumer's output buffer, and at few tiles on
``Few``'s 64 x 64 tiles of one consumer. The design alternatives that
``kernel_variants.py`` times from ``csrc/variants/linear_resid_next_tile.cu``
walk theirs otherwise: W resident in the block (``ResidW``, ``ResidW8``: the
blocks of a column tile walk its row tiles), a cluster of CM blocks along M
sharing each W stage by TMA multicast (``ResidPair``), or a consumer loading
its next tile's residual behind its epilogue (``ResidNext``). A model of
those walks on the CPU: which block, cluster rank and consumer takes which
(row tile, column tile); that every output tile is covered once; that the
blocks of a cluster load the slices of one W stage; that each barrier
expects the bytes of the boxes it receives; and where each row's gate row
comes from. The tile parameters are parsed from the sources, so the model
follows the code. Exact integer arithmetic: no tolerance."""

import math
import re

import pytest

import kernel_variants as kv
from supertonic_tpu_torch.ops import _build

SOURCE = (_build.CSRC_DIR / "linear.cu").read_text()
VARIANT = (_build.CSRC_DIR / kv.RESID_NEXT_SRC).read_text()
SMS = 132  # the H100's SMs
FIELDS = ("NC", "MI", "BN", "NS", "BPS", "COOP", "TMA_STORE", "ES", "WRS", "CM", "RB")


def _tiles(src):
    """{name: parameters} of every ``using X = Tile<...>;`` in src."""
    out = {}
    for name, args in re.findall(r"using (\w+) = Tile<([^>]*)>;", src):
        vals = [a.strip() for a in args.split(",")]
        vals += ["0", "1", "false"][len(vals) - 8:]  # WRS, CM and RB by default
        t = {f: (v == "true" if v in ("true", "false") else int(v)) for f, v in zip(FIELDS, vals)}
        t["ROWS"] = 64 * t["MI"]
        t["BM"] = t["ROWS"] * (t["NC"] if t["COOP"] else 1)
        out[name] = t
    return out


TILES, VTILES = _tiles(SOURCE), _tiles(VARIANT)
RESID_W_K = int(re.search(r"constexpr int RESID_W_K = (\d+);", VARIANT).group(1))


def test_the_model_reads_the_kernels_rule():
    """The rule the model follows is pick's (the residual form at many tiles
    on ManyResid, else Few, AnyN at N off 8, SIMT at K off 8), and the
    variant routes as kernel_variants.py's substitution has it."""
    for src in (SOURCE, VARIANT):
        assert "if (K % 8) return I_SIMT;" in src and "if (N % 8) return I_ANY_N;" in src
        assert ("mode == MODE_SILU ? I_MANY_SILU : mode == MODE_RESID ? I_RESID_MANY : I_MANY"
                in src)
        assert "if (mode == MODE_RESID || 2 * tiles_of<Few>(M, N) >= sms) return I_FEW;" in src
    assert "std::conditional_t<MODE == MODE_RESID, ManyResid, Many>" in SOURCE
    assert "if (in == I_RESID_MANY) return launch_tiles<MODE, ResidNext, 0, Q8>" in VARIANT
    assert kv.RESID_SHARED_W[0][0] in VARIANT and "I_RESID_W" in kv.RESID_SHARED_W[0][1]


def pick(m, n, k, design="committed"):
    """The residual form's instance: the committed pick, or a variant's
    ("next": ResidNext at many tiles; "shared": W resident or a cluster)."""
    if k % 8:
        return "simt"
    if n % 8:
        return "AnyN"
    many = TILES["Many"]
    if math.ceil(m / many["BM"]) * math.ceil(n / many["BN"]) >= 2 * SMS:
        if design == "next":
            return "ResidNext"
        if design == "shared":
            return "ResidW" if k <= RESID_W_K and math.ceil(n / VTILES["ResidW"]["BN"]) <= SMS \
                else "ResidPair"
        return "ManyResid"
    return "Few"


def instance(m, n, k, q8, design="committed"):
    """(name, parameters) of the instance a launch takes."""
    name = pick(m, n, k, design)
    if q8 and name == "ResidW":
        name = "ResidW8"
    return name, (TILES if design == "committed" else VTILES)[name]


def grid(s, m, n):
    """(blocks, units): the launch's blocks (launch_tiles) and the count of
    what the blocks walk (tiles, or with a cluster its units of CM row
    tiles); a cluster of CM blocks fits on CM SMs."""
    row_tiles, n_tiles = math.ceil(m / s["BM"]), math.ceil(n / s["BN"])
    tiles = row_tiles * n_tiles
    if s["CM"] > 1:
        units = math.ceil(row_tiles / s["CM"]) * n_tiles
        return s["CM"] * min(math.ceil(units / s["NC"]), SMS // s["CM"]), units
    if s["WRS"]:
        per_column = math.ceil(row_tiles / s["NC"])
        return n_tiles * min(per_column, SMS * s["BPS"] // n_tiles), tiles
    return min(math.ceil(tiles / s["NC"]), SMS * s["BPS"]), tiles


def walk(s, m, n):
    """{(block, consumer): [(row tile, column tile), ...]} in the order each
    takes them (wgmma_body's loops: block b's tiles, or with a cluster its
    units, are b + i gridDim.x, i = consumer, consumer + NC, ...)."""
    blocks, total = grid(s, m, n)
    n_tiles, cm = math.ceil(n / s["BN"]), s["CM"]
    units = blocks // cm
    out = {}
    for b in range(blocks):
        crank, unit0 = b % cm, b // cm
        for c in range(s["NC"]):
            seq, i = [], c
            while unit0 + i * units < total:
                tile = unit0 + i * units
                seq.append(((tile // n_tiles) * cm + crank, tile % n_tiles))
                i += s["NC"]
            out[(b, c)] = seq
    return out


# (M, K, N, T) of the residual form: the b64 cell's (T = 448: the VE's self
# and cross O and the int8 FFN-out; L = 320: the TE's and DP's O and the
# bf16 FFN-out, no gate), a streamed chunk's (B = 1), phase 12's widths
# (B = 2: the tiny dims, the TE at Dh 96 and 256, the VE at Dh 128) and
# edges (M off 64, N off 128, T below 64)
SHAPES = [(28672, 512, 512, 448), (28672, 2048, 512, 448), (20480, 256, 256, 320),
          (20480, 1024, 256, 320), (448, 512, 512, 448), (448, 2048, 512, 448),
          (320, 256, 256, 320), (320, 1024, 256, 320), (2 * 50, 32, 32, 50),
          (2 * 120, 64, 64, 120), (2 * 90, 384, 384, 90), (2 * 200, 512, 512, 200),
          (2 * 60, 1024, 1024, 60), (17037, 512, 200, 0), (17037, 1024, 256, 0),
          (17050, 2048, 512, 50), (17050, 512, 512, 50)]


DESIGNS = ["committed", "next", "shared"]


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "w8a8"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "M%d-K%d-N%d-T%d" % s)
def test_every_output_tile_once(shape, q8, design):
    """Each (row tile, column tile) of the output is taken by one consumer
    of one block, once; a tile past M (a cluster's last rank) only where
    the cluster's units hold more row tiles than M; resident W serves every
    tile of its block."""
    m, k, n, _t = shape
    assert not q8 or k % 32 == 0  # the W8A8 product's K
    _name, s = instance(m, n, k, q8, design)
    seen = {}
    n_tiles = math.ceil(n / s["BN"])
    for (b, c), seq in walk(s, m, n).items():
        for rt, ct in seq:
            if rt * s["BM"] >= m:  # past M: only a cluster's rank past the last row tile
                assert s["CM"] > 1 and rt < math.ceil(m / s["BM"] / s["CM"]) * s["CM"], (b, rt)
                continue
            assert (rt, ct) not in seen, ((rt, ct), seen.get((rt, ct)), (b, c))
            seen[(rt, ct)] = (b, c)
            if s["WRS"]:
                assert ct == b % n_tiles  # the block's resident columns of W
    assert len(seen) == math.ceil(m / s["BM"]) * n_tiles
    if s["WRS"]:
        assert k <= RESID_W_K and k <= s["WRS"] * (128 if q8 else 64)
    blocks, _ = grid(s, m, n)
    assert blocks <= SMS * s["BPS"]


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "w8a8"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "M%d-K%d-N%d-T%d" % s)
def test_barriers_expect_the_bytes_of_their_boxes(shape, q8, design):
    """The ring's full barrier expects STEP bytes: the block's X box (BM
    rows of 128 bytes) and the CM slices of the W stage (BN / CM rows each,
    one from each block of the cluster), or X alone where W is resident,
    whose barrier expects the K steps' BN-row boxes; the residual's barrier
    expects the consumer's buffer, BN / BOX boxes of ROWS rows. TMA counts
    a box's bytes whole, the parts past M, N or K zero-filled, so the last
    partial tiles expect the same bytes."""
    m, k, n, _t = shape
    _name, s = instance(m, n, k, q8, design)
    stage_a, stage_w = s["BM"] * 128, s["BN"] * 128
    step = stage_a + (0 if s["WRS"] else stage_w)
    w_boxes = [] if s["WRS"] else [(s["BN"] // s["CM"]) * 128] * s["CM"]
    assert step == stage_a + sum(w_boxes)
    assert s["BN"] % (8 * s["CM"]) == 0  # slices of whole 8-row swizzle groups
    # each slice lands at its rank's offset, 1024-byte aligned as the swizzle wants
    assert all((r * (s["BN"] // s["CM"]) * 128) % 1024 == 0 for r in range(s["CM"]))
    kt_n = math.ceil(k / (128 if q8 else 64))
    if s["WRS"]:
        assert kt_n <= s["WRS"] and kt_n * stage_w == sum([s["BN"] * 128] * kt_n)
    box = 128 // s["ES"]
    assert s["BN"] % box == 0
    out = s["ROWS"] * s["BN"] * s["ES"]
    assert out == (s["BN"] // box) * s["ROWS"] * 128


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "w8a8"])
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[0] >= 17037],
                         ids=lambda s: "M%d-K%d-N%d-T%d" % s)
def test_a_clusters_blocks_load_one_w_stage(shape, q8):
    """At every step the blocks of a cluster take the same column tile and
    the same K step (the units walk in lockstep: the same count each), and
    their W slices cover the tile's BN rows once."""
    m, k, n, _t = shape
    s = VTILES["ResidPair"]
    assert s["CM"] > 1 and pick(m, n, k, "shared") == ("ResidW" if k <= RESID_W_K else "ResidPair")
    w = walk(s, m, n)
    blocks, _ = grid(s, m, n)
    for b0 in range(0, blocks, s["CM"]):
        for c in range(s["NC"]):
            seqs = [w[(b0 + r, c)] for r in range(s["CM"])]
            assert len({len(q) for q in seqs}) == 1
            for step in zip(*seqs):
                assert len({ct for _rt, ct in step}) == 1
                assert [rt for rt, _ct in step] == [step[0][0] + r for r in range(s["CM"])]
    rows = sorted(r * (s["BN"] // s["CM"]) + j for r in range(s["CM"])
                  for j in range(s["BN"] // s["CM"]))
    assert rows == list(range(s["BN"]))


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[0] >= 17037],
                         ids=lambda s: "M%d-K%d-N%d-T%d" % s)
def test_the_next_tile_a_consumer_loads_is_the_one_it_takes(shape):
    """ResidNext's consumer loads, behind each epilogue, the residual of the
    tile tile + NC gridDim.x, the one its loop takes next, and its first
    tile's at the top: every tile's residual lands once, in the consumer
    that takes it, before it takes it."""
    m, k, n, _t = shape
    s = VTILES["ResidNext"]
    assert s["RB"] and "const int next = tile + STRIDE * units;" in VARIANT
    blocks, total = grid(s, m, n)
    n_tiles = math.ceil(n / s["BN"])
    for (b, c), seq in walk(s, m, n).items():
        loaded = [seq[0]] if seq else []
        tile = b + c * blocks
        while tile < total:
            nxt = tile + s["NC"] * blocks
            if nxt < total:
                loaded.append((nxt // n_tiles, nxt % n_tiles))
            tile = nxt
        assert loaded == seq


GATED = [s for s in SHAPES if s[3]]


@pytest.mark.parametrize("shape", GATED, ids=lambda s: "M%d-K%d-N%d-T%d" % s)
def test_gate_rows_staged_or_from_memory(shape):
    """Each row of a tile reads its batch row's gate: from the consumer's
    staged slice (the tile's first two batch rows, pair c of slot c // (BN /
    2)) where it is one of them, else from device memory; a staged slot a
    row reads holds a batch row that exists. At T of 64 rows or more no row
    falls to device memory."""
    m, k, n, t = shape
    for q8 in (False, True):
        _name, s = instance(m, n, k, q8)
        if not s["TMA_STORE"]:
            continue
        batch, half = m // t, s["BN"] // 2
        from_memory = 0
        for (_b, _c), seq in walk(s, m, n).items():
            for rt, ct in seq:
                m0, n0 = rt * s["BM"], ct * s["BN"]
                if m0 >= m:
                    continue
                b0 = m0 // t
                for rr in range(s["ROWS"]):
                    at = min(m0 + rr, m - 1)
                    gsel = at // t - b0
                    assert gsel >= 0
                    if gsel >= 2:
                        from_memory += 1
                        continue
                    assert b0 + gsel < batch
                    for j in range(s["BN"] // 8):
                        for th in range(4):
                            slot = gsel * half + 4 * j + th
                            assert b0 + slot // half == at // t
                            assert n0 + 2 * (slot % half) == n0 + 8 * j + 2 * th
        if t >= 64:
            assert from_memory == 0
        elif s["ROWS"] > 2 * t - 1:
            assert from_memory > 0


# kernel_variants.py's residual-form entries of both precisions: the
# splits of this design, its variants and the replaced design
RESID_ENTRIES = [(kernel, name) for kernel in ("linear", "w8a8_forms")
                 for name in kv.variants_of(kernel, split=True) if "residual form" in name]


@pytest.mark.parametrize("kernel, name", RESID_ENTRIES)
def test_residual_variants_apply(kernel, name):
    """Every residual split and variant of both precisions finds its text in
    the source it acts on, once, so a change to the kernel cannot leave
    one timing something else."""
    entries = kv.variants_of(kernel, split=True)
    subs = entries[name]
    if subs and subs[0] == kv.FILE:
        _, where, subs = subs
        src = (_build.CSRC_DIR / where).read_text()
    else:
        src = SOURCE
    for old, _new in subs:
        assert src.count(old) == 1, (name, old)
    assert kv.variant_source(kernel, entries[name])


def test_both_precisions_take_the_residual_entries():
    """The W8A8 forms' entries hold the linear kernel's residual splits and
    the earlier design."""
    w8 = kv.variants_of("w8a8_forms", split=True)
    assert all(name in w8 for name in kv.SPLIT["linear"] if "residual form" in name)
    assert any(name.startswith("earlier: the residual form") for name in w8)
    assert (_build.CSRC_DIR / kv.RESID_EARLIER).exists()
