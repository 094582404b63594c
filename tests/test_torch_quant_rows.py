"""K6q rows (`kernels/quant_rows.py`, `csrc/quant_rows.cu`): the
compressed squared L2 by row id of the quantized scan and the compressed
oracle.

- A torch transcription of the kernel (`_k6q_rows_tiled`: int8's tiles,
  exact dot and float tail; PQ's compaction of each lane's unmasked
  positions, the
  work items of `pq_work_items`, each lane's table by chunks of SEG_SLOTS
  slots once an item, and each row's slot-order sum carried across the
  chunks) equals `sqdist_rows_quant_plain` bit for bit under hypothesis,
  on unrounded data: widths off 32 and off SEG_SLOTS, V across tile
  boundaries, the scan's and the oracle's layouts, dead lanes,
  block counts and item lengths that cut lanes.
- The compaction's edge cases (`_k6q_compact`): a lane with none
  unmasked, one with all, a V off a multiple of a thread's positions and
  of the item length, ids outside [0, N), the B=130 layout.
- `cuda` tests (skipped without a card): the kernel against its plain
  version bit for bit, NaN for an unmasked id outside [0, N), the same
  edge cases; and each (query, row) pair's value equal to K3's / K4's.

No JAX here, so the `cuda` tests run on a machine without it:
    python -m pytest -q -m cuda tests/test_torch_quant_rows.py
"""
import numpy as np
import pytest
import torch

from _hyp_compat import given, settings, st  # hypothesis or fallback
from repro_torch.kernels.quant_rows import (PQ_SEG_ROWS, pq_work_items,
                                            sqdist_rows_quant,
                                            sqdist_rows_quant_plain)
from repro_torch.quant import codecs as P

CODECS = ("int8", "pq")
INT8_TILE = 256      # csrc/quant_rows.cu::kInt8Rows
COMPACT_THREADS = 256  # csrc/quant_rows.cu::kCompactThreads
COMPACT_ROUNDS = 4   # csrc/quant_rows.cu::kCompactRounds
COMPACT_PER = 4 * COMPACT_ROUNDS  # csrc/quant_rows.cu::kCompactPer
SEG_SLOTS = 64       # csrc/quant_rows.cu::kSegSlots


def _k6q_compact(ids, mask, n, threads=COMPACT_THREADS):
    """A torch transcription of `rows_pq_count` and `rows_pq_compact` for
    every lane: tiles of threads·COMPACT_PER positions, thread t owning
    positions 4·(threads·q + t) + i of round q < COMPACT_ROUNDS, i < 4; an
    unmasked position goes to slot (the lane's earlier tiles' counts) +
    (the tile's earlier rounds' counts) + (the counts of round q's threads
    before t) + (its rank among t's in round q), with its id, or −1 for an
    id outside [0, n). Returns (cid [B, V], pos [B, V], cnt [B] — slots
    past cnt left at −2 — and out [B, V]: +inf, NaN at an unmasked id
    outside [0, n))."""
    b, v = mask.shape
    read = mask
    cid = torch.full((b, v), -2, dtype=torch.int32)
    pos = torch.full((b, v), -2, dtype=torch.int32)
    good = (ids >= 0) & (ids < n)
    out = torch.where(mask & ~good, float("nan"), float("inf"))
    tile = threads * COMPACT_PER
    tiles = -(-v // tile)
    flags = torch.nn.functional.pad(read, (0, tiles * tile - v)).view(
        b, tiles, COMPACT_ROUNDS, threads, 4)             # [B, tile, q, t, i]
    mine = flags.sum(4)                                   # [B, tile, q, t]
    tcnt = mine.sum((2, 3))                               # rows_pq_count
    base = torch.cumsum(tcnt, 1) - tcnt                   # earlier tiles
    rounds = mine.sum(3)
    earlier = torch.cumsum(rounds, 2) - rounds            # earlier rounds
    before = torch.cumsum(mine, 3) - mine                 # block prefix
    rank = torch.cumsum(flags.to(torch.int64), 4) - 1
    at = (base[:, :, None, None, None] + earlier[..., None, None]
          + before[..., None] + rank)
    p = torch.arange(tiles * tile).view(tiles, COMPACT_ROUNDS, threads, 4)
    for lane in range(b):
        f = flags[lane]
        cid[lane, at[lane][f]] = torch.where(good[lane, p[f]],
                                             ids[lane, p[f]], -1)
        pos[lane, at[lane][f]] = p[f].to(torch.int32)
    return cid, pos, tcnt.sum(1), out


def _k6q_rows_tiled(prep, codes, norms, ids, mask, grid=3,
                    seg_rows=PQ_SEG_ROWS, threads=COMPACT_THREADS):
    """A torch transcription of `csrc/quant_rows.cu` for every lane.

    int8: tiles of INT8_TILE positions, one row a warp: the dot of the
    int8 query and the row's codes (an integer: exact), then (qn + xn) −
    (2·sq)·dot, each rounded once, clamped at 0. PQ: the compaction
    (`_k6q_compact`, tiles of `threads`·COMPACT_PER positions), then the
    sum on `grid` blocks: the work items of `pq_work_items`, each reading
    its lane's table by chunks of SEG_SLOTS slots, every row's partial
    sum carried from chunk to chunk in slot order from 0, then
    max((qn + xn) − 2·ip, 0) at the row's position. (How the kernel
    brings a row's codes to the thread that sums it changes no value.)
    Every float32 operation is one torch op on float32 tensors, rounded
    once. Returns (out [B, V], the PQ work items that read a table, as
    (block, lane, k0, k1))."""
    b, v = mask.shape
    f32 = torch.float32
    if isinstance(prep, P.Int8Prep):
        out = torch.full((b, v), float("inf"))
        for lane in range(b):
            for p0 in range(0, v, INT8_TILE):  # warp w: p0 + w, p0 + w + 8
                pos = torch.arange(p0, min(p0 + INT8_TILE, v))
                on = pos[mask[lane, pos]]
                if on.numel() == 0:
                    continue
                rows = ids[lane, on].long()
                dot = (prep.qq[lane].to(torch.int64)
                       * codes[rows].to(torch.int64)).sum(dim=1)
                sq2 = (2.0 * prep.sq[lane]).to(f32)
                t = sq2 * dot.to(f32)                  # exact: |dot| < 2^24
                a = prep.qn[lane] + norms[rows]
                out[lane, on] = torch.clamp(a - t, min=0.0)
        return out, []
    cid, pos, cnt, out = _k6q_compact(ids, mask, codes.shape[0], threads)
    items = pq_work_items(cnt.tolist(), grid, seg_rows)
    sl = codes.shape[1]
    for _, lane, k0, k1 in items:
        ok = cid[lane, k0:k1] >= 0          # an id outside [0, N): NaN
        rows = cid[lane, k0:k1][ok].long()
        at = pos[lane, k0:k1][ok].long()
        ip = torch.zeros(rows.numel(), dtype=f32)
        for j0 in range(0, sl, SEG_SLOTS):
            chunk = prep.lut[lane, j0:j0 + SEG_SLOTS]  # the table, once
            for jj in range(chunk.shape[0]):
                ip = ip + chunk[jj, codes[rows, j0 + jj].long()]
        a = prep.qn[lane] + norms[rows]
        out[lane, at] = torch.clamp(a - 2.0 * ip, min=0.0)
    return out, items


def _check_items(items, cnt, grid):
    """Each lane's table is read once per work item, every item holds an
    unmasked row, a lane with none is in no item, and the items of a lane
    cover its listed rows once, in order, with each block's items in
    lane order."""
    by_lane = {}
    for blk, lane, k0, k1 in items:
        assert 0 <= blk < grid and k1 > k0
        by_lane.setdefault(lane, []).append((k0, k1))
    assert set(by_lane) == {i for i, c in enumerate(cnt) if c > 0}
    for lane, spans in by_lane.items():
        assert spans[0][0] == 0 and spans[-1][1] == cnt[lane]
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert [(b, l) for b, l, _, _ in items] == sorted(
        (b, l) for b, l, _, _ in items)


def test_k6q_constants_match_the_kernel():
    """The Python mirrors of `csrc/quant_rows.cu`'s shapes (the wrapper's
    `pq_work_items` and scratch sizes, and this file's transcription) hold
    the kernel's own constants."""
    import re
    from pathlib import Path

    from repro_torch.kernels import quant_rows as qr

    src = (Path(qr.__file__).resolve().parents[1] / "csrc" /
           "quant_rows.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert qr.PQ_SEG_ROWS == const("kSegRows")
    assert qr.PQ_LANE_ROWS == const("kSegLaneRows")
    assert COMPACT_THREADS == const("kCompactThreads")
    assert COMPACT_ROUNDS == const("kCompactRounds")
    assert qr.PQ_TILE == COMPACT_THREADS * COMPACT_PER
    assert SEG_SLOTS == const("kSegSlots")
    assert INT8_TILE == const("kInt8Rows")


def _k6q_inputs(rng, precision, b, v, n, width, kc=16):
    """Unrounded codec inputs of K6q rows at small sizes: a prep of b lanes,
    codes [n, width], norms, ids [b, v] (sorted per lane with a masked
    tail, as the scan's, or one block of rows, as the oracle's) and mask;
    lane b − 1 passes no row."""
    t = torch.from_numpy
    if precision == "int8":
        codes = t(rng.integers(-127, 128, (n, width)).astype(np.int8))
        prep = P.Int8Prep(
            qq=t(rng.integers(-127, 128, (b, width)).astype(np.int8)),
            sq=t((2e-3 * (1 + rng.random(b))).astype(np.float32)),
            qn=t((1 + rng.random(b)).astype(np.float32)))
    else:
        codes = t(rng.integers(0, kc, (n, width)).astype(np.uint8))
        prep = P.PQPrep(
            lut=t((rng.normal(size=(b, width, kc)) / np.sqrt(width)).astype(
                np.float32)),
            qn=t((1 + rng.random(b)).astype(np.float32)))
    norms = t((1 + rng.random(n)).astype(np.float32))
    if rng.random() < 0.5:
        ids = np.sort(rng.integers(0, n, (b, v)), axis=1)
        mask = np.arange(v)[None, :] < rng.integers(0, v + 1, (b, 1))
    else:
        ids = np.broadcast_to(np.arange(v) % n, (b, v))
        mask = rng.random((b, v)) < rng.random((b, 1))
    mask[-1] = False
    return (prep, codes, norms, t(np.ascontiguousarray(ids, np.int32)),
            t(np.ascontiguousarray(mask)))


@pytest.mark.parametrize("precision", CODECS)
def test_k6q_rows_tiles_equal_plain(precision):
    """K6q rows' int8 tiles, and PQ's compaction, work items and chunked
    slot-order sum (`_k6q_rows_tiled`), == `sqdist_rows_quant_plain` bit
    for bit on unrounded data: widths off a multiple of 32 (int8: of 4
    only) and of SEG_SLOTS, V across a tile and a thread's positions, the
    scan's and the oracle's layouts, dead lanes, compaction tiles of
    32–COMPACT_THREADS·COMPACT_PER positions, 1–7 blocks and items cut at
    5–PQ_SEG_ROWS rows; each lane's table is read once per work item
    holding an unmasked row, and never for a lane with none."""

    @settings(max_examples=6, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), wi=st.integers(0, 2),
           vi=st.integers(0, 2), gi=st.integers(0, 2))
    def check(seed, wi, vi, gi):
        rng = np.random.default_rng(seed)
        width = ((36, 100, 12) if precision == "int8" else (13, 50, 97))[wi]
        v = (64, 1088, 327)[vi]
        grid, seg, thr = ((1, PQ_SEG_ROWS, COMPACT_THREADS), (3, 64, 4),
                          (7, 5, 2))[gi]
        args = _k6q_inputs(rng, precision, 3, v, 700, width)
        got, items = _k6q_rows_tiled(*args, grid=grid, seg_rows=seg,
                                     threads=thr)
        want = sqdist_rows_quant_plain(*args)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        mask = args[4]
        assert torch.isinf(want[~mask]).all()
        assert torch.isfinite(want[mask]).all()
        if precision == "pq":
            _check_items(items, mask.sum(1).tolist(), grid)

    check()


def _edge_layout(case):
    """ids [B, V] int32 and mask for a compaction edge case, over N=700
    rows: "none" (a lane with no unmasked position), "all" (every position
    unmasked), "ragged" (V = 2·16·3 + 5: off a multiple of a thread's
    positions; ids outside [0, N) at unmasked positions), "last" (one lane
    with only its last position unmasked, one fully unmasked: the
    oracle's layout), "b130" (B=130, the scan's layout, lanes 1 and 129
    dead)."""
    rng = np.random.default_rng(len(case))
    b, v = {"b130": (130, 96)}.get(case, (4, 101 if case == "ragged" else 64))
    ids = rng.integers(0, 700, (b, v))
    mask = rng.random((b, v)) < 0.4
    if case == "none":
        mask[2] = False
    elif case == "all":
        mask[:] = True
    elif case == "ragged":
        ids[0, 3], ids[1, v - 1], ids[3, 0] = -1, 700, 10 ** 6
        mask[0, 3] = mask[1, v - 1] = mask[3, 0] = True
    elif case == "last":
        ids = np.broadcast_to(np.arange(2 * v, 3 * v) % 700, (b, v))
        mask[0], mask[1] = True, np.arange(v) == v - 1
    else:
        ids = np.sort(ids, axis=1)
        mask = np.arange(v)[None] < rng.integers(0, v + 1, (b, 1))
        mask[[1, b - 1]] = False
    return (torch.from_numpy(np.ascontiguousarray(ids, np.int32)),
            torch.from_numpy(np.ascontiguousarray(mask)))


EDGES = ("none", "all", "ragged", "last", "b130")


@pytest.mark.parametrize("case", EDGES)
def test_k6q_compaction_edges(case):
    """The compaction (`_k6q_compact`, tiles of 2 threads here so that a
    V crosses tiles) lists each lane's unmasked positions in position
    order, cnt of them, with their ids (−1 for an id outside [0, N)), and
    leaves +inf at masked and NaN at bad-id positions; the work items over
    them (items of 7 rows) cover every listed row once; the PQ sum over
    them equals the plain version where the ids are good."""
    ids, mask = _edge_layout(case)
    n = 700
    cid, pos, cnt, out = _k6q_compact(ids, mask, n, threads=2)
    read = mask & (ids >= 0) & (ids < n)
    for lane in range(mask.shape[0]):
        want = torch.nonzero(mask[lane]).flatten()
        c = int(cnt[lane])
        assert c == want.numel()
        assert torch.equal(pos[lane, :c].long(), want)
        assert torch.equal(cid[lane, :c],
                           torch.where(read[lane, want], ids[lane, want], -1))
        assert (pos[lane, c:] == -2).all()
    assert torch.equal(torch.isnan(out), mask & ~read)
    assert torch.isinf(out[~(mask & ~read)]).all()
    if case == "none":
        assert int(cnt[2]) == 0
    if case == "all":
        assert (cnt == mask.shape[1]).all()
    for grid in (1, 5):
        _check_items(pq_work_items(cnt.tolist(), grid, 7), cnt.tolist(),
                     grid)
    prep, codes, norms, _, _ = _k6q_inputs(np.random.default_rng(7), "pq",
                                           mask.shape[0], 8, n, 70)
    got, items = _k6q_rows_tiled(prep, codes, norms, ids, mask, grid=5,
                                 seg_rows=7)
    good = ~(mask & ~read)
    want = sqdist_rows_quant_plain(prep, codes, norms,
                                   torch.where(good, ids, 0), mask & good)
    assert torch.equal(got[good].view(torch.int32),
                       want[good].view(torch.int32))
    assert torch.isnan(got[~good]).all()
    _check_items(items, cnt.tolist(), 5)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", CODECS)
def test_k6q_rows_kernel_matches_plain_on_cuda(precision):
    """K6q rows on the card == its plain version bit for bit (int8: an
    exact dot and the same tail; PQ: the same slot-order sum), at widths
    off 32 / off SEG_SLOTS and a V across tiles, with a dead lane; an
    unmasked id outside [0, N) gives NaN and nothing else moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K6q rows has no CPU mode)")
    rng = np.random.default_rng(41)
    for width, v in (((100, 1088), (768, 4096)) if precision == "int8"
                     else ((97, 1088), (576, 4096))):
        prep, codes, norms, ids, mask = _k6q_inputs(
            rng, precision, 5, v, 5000, width,
            kc=16 if width < 500 else 256)
        cuda = lambda a: a.cuda()  # noqa: E731
        gprep = type(prep)(*map(cuda, prep))
        got = sqdist_rows_quant(gprep, codes.cuda(), norms.cuda(),
                                ids.cuda(), mask.cuda())
        want = sqdist_rows_quant_plain(gprep, codes.cuda(), norms.cuda(),
                                       ids.cuda(), mask.cuda())
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        bad = ids.clone()
        bad[0, 0], mask2 = 10 ** 6, mask.clone()
        mask2[0, 0] = True
        out = sqdist_rows_quant(gprep, codes.cuda(), norms.cuda(),
                                bad.cuda(), mask2.cuda())
        assert torch.isnan(out[0, 0])
        assert torch.equal(out[:, 1:], got[:, 1:])


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGES + ("long",))
def test_k6q_compaction_edges_on_cuda(case):
    """K6q rows PQ on the card over the compaction's edge cases
    (`_edge_layout`), at S·L=70, Kc=16 (byte loads of the codes) and
    S·L=64, Kc=256 (16-byte loads, bulk copies): bit for bit the plain
    version where the ids are good, NaN at an unmasked bad id, +inf where
    masked. "long": two fully unmasked lanes of V = 2^21 + 16, so that a
    block's share (≈31.8 k rows on 132 SMs) is cut into items of at most
    PQ_SEG_ROWS rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K6q rows has no CPU mode)")
    n = 700
    if case == "long":
        v = (1 << 21) + 16
        ids = torch.from_numpy(np.random.default_rng(5).integers(
            0, n, (2, v)).astype(np.int32))
        mask = torch.ones((2, v), dtype=torch.bool)
    else:
        ids, mask = _edge_layout(case)
    read = mask & (ids >= 0) & (ids < n)
    good = ~(mask & ~read)
    for width, kc in ((70, 16), (64, 256)):
        prep, codes, norms, _, _ = _k6q_inputs(
            np.random.default_rng(width), "pq", mask.shape[0], 8, n, width,
            kc=kc)
        gprep = P.PQPrep(*(t.cuda() for t in prep))
        args = (codes.cuda(), norms.cuda())
        got = sqdist_rows_quant(gprep, *args, ids.cuda(), mask.cuda())
        want = sqdist_rows_quant_plain(
            gprep, *args, torch.where(good, ids, 0).cuda(),
            (mask & good).cuda())
        torch.cuda.synchronize()
        g = good.cuda()
        assert torch.equal(got[g].view(torch.int32),
                           want[g].view(torch.int32))
        assert torch.isnan(got[~g]).all()
        assert torch.equal(torch.isinf(got), ~mask.cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", CODECS)
def test_k6q_rows_equals_fused_step_on_cuda(precision):
    """K6q rows' value for each (query, row) pair == K3's / K4's, bit for
    bit: one fused step from an all-inf queue stores every new pair's
    distance, found again by its payload."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels K3/K4 and K6q rows)")
    from test_torch_kernels import _inputs, _torch_args

    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.topk import unpack_payload

    rng = np.random.default_rng(43)
    b, r, m, k, n = 8, 32, 64, 5, 4000
    width = 96 if precision == "int8" else 576
    prep, codes, norms, _, _ = _k6q_inputs(rng, precision, b, 64, n, width,
                                           kc=256)
    dev = "cuda"
    prep = type(prep)(*(t.to(dev) for t in prep))
    codes, norms = codes.to(dev), norms.to(dev)
    ids = torch.from_numpy(rng.integers(0, n, (b, 64)).astype(np.int32)).to(
        dev)
    a = list(_torch_args(_inputs(rng, b, m, r, k, 16, compiled=False), dev))
    nb = ids[:, :r].contiguous()
    a[0], a[1], a[2] = None, None, torch.arange(
        r, dtype=torch.int32, device=dev).repeat(b, 1)
    a[3] = torch.ones((b, r), dtype=torch.bool, device=dev)
    a[7] = torch.full_like(a[7], float("inf"))
    a[8] = torch.full_like(a[8], -1)
    qg = P.QuantGather(prep=prep, codes=codes[nb.long()].contiguous(),
                       norms=norms[nb.long()].contiguous())
    cd, cp = fused_step(*a, quant=qg, precision=precision)[:2]
    k6q = sqdist_rows_quant(prep, codes, norms, ids,
                            torch.ones_like(ids, dtype=torch.bool))
    pos = unpack_payload(cp[:, :r])[0].long()
    torch.cuda.synchronize()
    assert torch.equal(torch.sort(pos, dim=1)[0], a[2].long())
    assert torch.equal(cd[:, :r], torch.gather(k6q[:, :r], 1, pos))
