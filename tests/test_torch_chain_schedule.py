"""The bf16 chain kernel's schedule (``csrc/resblock_chain.cu``
``chain_wgmma``), modelled in numpy, and the plain chain it is held to
against the JAX package at the kernel's tile widths and window edges.

The kernel's consumer warpgroups split a window's M tiles (or its output
panels); the producer warpgroup's one thread streams the weight stages
through one ring and loads a slot once every consumer warp has released
it, with a block barrier among the consumers at each conv boundary. The
model replays every order the waits allow (random schedules) and checks
that no slot is loaded over a stage a warp still reads, that no wait finds
its barrier two phases ahead (where a parity wait would hang), that nothing
deadlocks, and that every row a conv reads lies in the block's shared
memory and feeds only frames that are not kept when it lies outside the
window.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from supertonic_tpu.models import layers as jL
from supertonic_tpu.models import vocoder as jvocoder
from supertonic_tpu.ops import vocoder_fused as jvf
from supertonic_tpu_torch.models import layers as tL
from supertonic_tpu_torch.ops import _build, vocoder_fused

SRC = (_build.CSRC_DIR / "resblock_chain.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", SRC).group(1))


WG_SMEM_MAX, MAX_STAGES, WIDE = _const("WG_SMEM_MAX"), _const("MAX_STAGES"), _const(
    "WIDE_CONSUMERS")


def frames(c: int) -> int:
    """wg_frames<C>() of the source."""
    return 256 if c <= 128 else 128 if c <= 256 else 64


def layout(c: int, w: int) -> dict:
    """WgLayout<C, W> of the source."""
    mts, np_ = w // 64, c // 64
    nc = WIDE if mts * np_ % WIDE == 0 and np_ % (WIDE // min(mts, WIDE)) == 0 else 2
    cm = min(mts, nc)
    cn = nc // cm
    npc = -(-np_ // cn)
    bufs = 3 * w * c * 2
    kc = 64 if bufs <= 128 * 1024 and np_ % 2 == 0 else 16 if c == 256 else 32
    stage = cn * npc * kc * 128
    stages = min((WG_SMEM_MAX - 1024 - bufs) // (stage + 16), MAX_STAGES)
    return dict(W=w, NC=nc, THREADS=(nc + 1) * 128, NP=np_, CM=cm, CN=cn, NPC=npc, NPS=cn * npc,
                MT=mts // cm, KC=kc, NKT=c // kc, STAGE=stage, STAGES=stages, BUFS=bufs,
                BYTES=1024 + stages * stage + bufs + 16 * stages)


INSTANCES = [(c, w) for c in vocoder_fused.CHAIN_WIDTHS
             for w in ((frames(c), frames(c) // 2) if c <= 256 else (frames(c),))]


def test_the_source_states_what_the_model_mirrors():
    assert "return C <= 128 ? 256 : C <= 256 ? 128 : 64;" in SRC
    assert "static constexpr int THREADS = (NC + 1) * 128;" in SRC
    assert "stk::mbar_init(&empty[s], 4 * L::NC);  // every consumer warp" in SRC
    assert "stk::mbar_wait(&empty[st], ((s / NS) & 1) ^ 1);" in SRC
    assert "stk::mbar_wait(&full[st], (step / NS) & 1);" in SRC
    assert "if (r > 0) release(step - 1);" in SRC
    assert "static constexpr size_t BYTES = 1024 + (size_t)STAGES * STAGE + BUFS + 16 * STAGES;" \
        in SRC


@pytest.mark.parametrize("c,w", INSTANCES)
def test_layout_fits_and_splits_evenly(c, w):
    """Every instance: its shared memory fits a block, its ring holds the W
    / 2 rows a read past the buffers' start may reach, the consumers split
    the M tiles and the panels evenly, and a conv's stages pair up (two A
    banks)."""
    L = layout(c, w)
    assert L["BYTES"] <= WG_SMEM_MAX and L["STAGES"] >= 2
    assert L["STAGES"] * L["STAGE"] >= w // 2 * c * 2
    assert L["CM"] * L["CN"] == L["NC"] and L["MT"] * L["CM"] * 64 == w
    assert L["NPS"] >= L["NP"] and L["NKT"] % 2 == 0 and c % L["KC"] == 0


def _simulate_ring(nc, ns, steps, nk, rng):
    """One schedule of the ring the waits allow; returns the stages loaded.
    The producer loads stage s into slot s % NS once every consumer has
    released stage s - NS (empty). A consumer (its warps act together at
    each wgmma) takes stage st once it is loaded (full), and then its
    products of the stage before are complete (wait_group 1): it releases
    that one; at its conv's end (wait_group 0) the last, then a block
    barrier ends the conv."""
    issued = 0
    holds = [-1] * ns                   # the stage in each slot
    released = np.zeros((steps,), int)  # consumers that released stage s
    empty_done = np.zeros((ns,), int)   # completed phases of empty[slot]
    step = [0] * nc
    state = ["take"] * nc               # take, end, barrier, exit
    while any(x != "exit" for x in state) or issued < steps:
        moves = []
        if issued < steps:
            n = issued // ns - 1  # the completion of empty[slot] waited for (none: -1)
            assert empty_done[issued % ns] <= n + 1, "a parity wait two phases ahead"
            if empty_done[issued % ns] == n + 1:
                moves.append((None, "load"))
        for q in range(nc):
            if state[q] == "take" and holds[step[q] % ns] == step[q]:
                moves.append((q, "take"))
            elif state[q] == "end":
                moves.append((q, "end"))
        if not moves:
            assert all(x in ("barrier", "exit") for x in state), "deadlock"
            state = ["take" if x == "barrier" else x for x in state]  # the barrier opens
            continue
        q, kind = moves[rng.integers(len(moves))]

        def release(stage):
            released[stage] += 1
            if released[stage] == nc:
                empty_done[stage % ns] += 1

        if kind == "load":
            slot = issued % ns
            assert issued < ns or (holds[slot] == issued - ns and released[issued - ns] == nc), \
                "a slot loaded over a stage a consumer still reads"
            holds[slot] = issued
            issued += 1
        elif kind == "take":
            if step[q] % nk:
                release(step[q] - 1)
            step[q] += 1
            if step[q] % nk == 0:
                state[q] = "end"
        else:  # the conv's end: its last stage released, then the barrier
            release(step[q] - 1)
            state[q] = "exit" if step[q] == steps else "barrier"
    assert (released == nc).all()
    return issued


@pytest.mark.parametrize("c,w", INSTANCES)
def test_the_ring_never_loads_over_a_stage_in_use_nor_hangs(c, w):
    L = layout(c, w)
    rng = np.random.default_rng(c + w)
    for pairs, k in ((1, 3), (3, 3), (4, 3), (2, 5)):
        nk = k * L["NKT"]
        for _ in range(20):
            assert _simulate_ring(L["NC"], L["STAGES"], 2 * pairs * nk, nk, rng) == (
                2 * pairs * nk)


def _tiled(c, w, k, dils):
    """Whether the instance at (C, W) tiles this chain in one launch."""
    return w > 2 * vocoder_fused.chain_halo(k, dils)


READS = [(c, w, k, dils) for c, w in INSTANCES
         for k, dils in ((3, (1, 3, 9)), (3, (30,)), (5, (1, 3)), (7, (1, 9)))
         if _tiled(c, w, k, dils)]


@pytest.mark.parametrize("c,w,k,dils", READS)
def test_reads_stay_in_shared_memory_and_off_the_kept_frames(c, w, k, dils):
    """Rows a conv reads at its taps' offsets, in byte offsets from the
    block's ring base (ring | silu h | silu x | x): inside the allocation,
    and outside the window only for frames whose value no kept frame needs
    (the exact region shrinks by each conv's reach; what is kept, the
    central W - 2 halo frames, stays inside it); every row and channel of
    the window is some consumer thread's accumulator position."""
    halo = vocoder_fused.chain_halo(k, dils)
    L = layout(c, w)
    row = c * 2
    ring_bytes = L["STAGES"] * L["STAGE"]
    base = {"silu h": ring_bytes, "silu x": ring_bytes + w * row}
    lo, hi = 0, w  # rows of the current input that are exact
    for d in dils:
        for buf, dil in (("silu x", d), ("silu h", 1)):
            reach = dil * (k - 1) // 2
            for off in (-reach, reach):
                first, last = off, w - 1 + off
                assert base[buf] + first * row >= 0
                assert base[buf] + (last + 1) * row <= L["BYTES"] - 1024
            # output row f is exact iff [f - reach, f + reach] lies in [lo, hi)
            lo, hi = lo + reach, hi - reach
    assert lo == halo and hi == w - halo
    # consumer wg: M tiles cm + CM i, panels cn NPC + j (cm = wg % CM, cn = wg / CM)
    cells = set()
    for wg in range(L["NC"]):
        cm, cn = wg % L["CM"], wg // L["CM"]
        for i in range(L["MT"]):
            for j in range(L["NPC"]):
                if cn * L["NPC"] + j < L["NP"]:
                    cells.add((cm + L["CM"] * i, cn * L["NPC"] + j))
    assert cells == {(m, pn) for m in range(w // 64) for pn in range(L["NP"])}
    rows = sorted(16 * wp + g + 8 * h for wp in range(4) for g in range(8) for h in range(2))
    assert rows == list(range(64))


# --------------------------------------------------------------------------
# the plain chain the kernel is held to, at its tile widths and edges
# --------------------------------------------------------------------------

def _chain_params(rng, c, dils, k=3):
    p = {"convs": [{"a": jL.conv1d_init(rng, c, c, k),
                    "b": jL.conv1d_init(rng, c, c, k)} for _ in dils]}
    for cp in p["convs"]:  # nonzero biases: conv1d_init leaves them at 0
        for key in ("a", "b"):
            cp[key]["b"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return p


def _by_tiles(x, fm, wa, ba, wb, bb, dils, tile, k):
    """The kernel's tiling in plain torch: each block sees tile + 2 halo
    frames, zero outside [0, T), and keeps its central tile."""
    halo = vocoder_fused.chain_halo(k, dils)
    t_len = x.shape[1]
    out = torch.empty_like(x)
    for t0 in range(0, t_len, tile):
        idx = torch.arange(t0 - halo, t0 + tile + halo)
        inside = (idx >= 0) & (idx < t_len)
        xw = torch.zeros((x.shape[0], len(idx), x.shape[2]))
        xw[:, inside] = x[:, idx[inside]]
        mw = torch.zeros(len(idx))
        mw[inside] = fm[idx[inside]]
        yw = vocoder_fused.resblock_chain_plain(xw, mw, wa, ba, wb, bb, dils)
        n = min(tile, t_len - t0)
        out[:, t0:t0 + n] = yw[:, halo:halo + n]
    return out


@pytest.mark.parametrize("c,k,dils,t_len", [
    (128, 3, (1, 3, 9), 3 * 96 + 5),     # the half instance's tile, T off it
    (128, 3, (1, 3, 9), 224 + 17),       # the b64 instance's tile
    (256, 3, (1, 3, 9), 2 * 96 + 1),     # C 256's tile
    (64, 3, (30,), 3 * 64 + 3),          # a lone pair at bf16's MAX_PAIR_REACH 31
    (64, 5, (1, 3), 2 * 96 + 7),
], ids=["c128-t96", "c128-t224", "c256-t96", "reach31", "k5"])
def test_plain_chain_by_tiles_matches_pallas_and_xla(c, k, dils, t_len):
    """The plain chain, run window by window at the kernel's tiles (T not a
    multiple of the tile, the last 10% of the frames masked), against the
    Pallas kernel in interpret mode and XLA's convs. 2e-6: the bound the
    JAX package's own fused-vs-XLA test uses."""
    rng = np.random.default_rng(c + t_len)
    p = _chain_params(rng, c, dils, k)
    x = rng.standard_normal((1, t_len, c)).astype(np.float32)
    mask = np.ones((1, t_len, 1), np.float32)
    mask[0, -(t_len // 10):, 0] = 0.0
    jp = {"convs": [{key: {n: jnp.asarray(a) for n, a in cp[key].items()} for key in cp}
                    for cp in p["convs"]]}
    xla = np.asarray(jvocoder._resblock(jp, jnp.asarray(x), dils, jnp.asarray(mask)))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jvf.fused_resblock(jp, jnp.asarray(x), dils, jnp.asarray(mask)))
    mods = tL.tree_to_modules(p, device="cpu")
    wa, ba, wb, bb = vocoder_fused.stack_resblock(mods, torch.float32)
    xt, fm = torch.from_numpy(x), torch.from_numpy(mask.reshape(t_len))
    halo = vocoder_fused.chain_halo(k, dils)
    tiles = sorted({w - 2 * halo for w in (frames(c), frames(c) // 2) if w > 2 * halo})
    for tile in tiles:
        got = _by_tiles(xt, fm, wa, ba, wb, bb, dils, tile, k).numpy()
        np.testing.assert_allclose(got, pallas, rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(got, xla, rtol=2e-6, atol=2e-6)
        np.testing.assert_array_equal(got[:, -1], x[:, -1])  # masked frames pass x


def test_plain_per_conv_route_matches_pallas_and_xla():
    """A pair past every fused tile (k 3, dilation 40: reach 41) takes the
    per-conv route on the card; its plain version against JAX."""
    rng = np.random.default_rng(40)
    c, t_len, dils = 64, 130, (40,)
    assert vocoder_fused.pair_reach(3, 40) > vocoder_fused.MAX_PAIR_REACH[torch.bfloat16]
    p = _chain_params(rng, c, dils)
    x = rng.standard_normal((2, t_len, c)).astype(np.float32)
    mask = np.ones((1, t_len, 1), np.float32)
    mask[0, -11:, 0] = 0.0
    jp = {"convs": [{key: {n: jnp.asarray(a) for n, a in cp[key].items()} for key in cp}
                    for cp in p["convs"]]}
    xla = np.asarray(jvocoder._resblock(jp, jnp.asarray(x), dils, jnp.asarray(mask)))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jvf.fused_resblock(jp, jnp.asarray(x), dils, jnp.asarray(mask)))
    mods = tL.tree_to_modules(p, device="cpu")
    got = vocoder_fused.fused_resblock(mods, torch.from_numpy(x), dils,
                                       torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, pallas, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, xla, rtol=2e-6, atol=2e-6)
