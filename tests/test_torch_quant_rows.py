"""K6q rows (`kernels/quant_rows.py`, `csrc/quant_rows.cu`): the
compressed squared L2 by row id of the quantized scan and the compressed
oracle.

- A torch transcription of the kernel (`_k6q_rows_tiled`: its tiles, the
  PQ tile's early exit, the lane's table by chunks of PQ_CHUNK slots and
  each row's slot-order sum carried across them; int8's exact dot and
  float tail) equals `sqdist_rows_quant_plain` bit for bit under
  hypothesis, on unrounded data: widths off 32 and off PQ_CHUNK, V across
  tile boundaries, the scan's and the oracle's layouts, dead lanes.
- `cuda` tests (skipped without a card): the kernel against its plain
  version bit for bit, NaN for an unmasked id outside [0, N); and each
  (query, row) pair's value equal to K3's / K4's.

No JAX here, so the `cuda` tests run on a machine without it:
    python -m pytest -q -m cuda tests/test_torch_quant_rows.py
"""
import numpy as np
import pytest
import torch

from _hyp_compat import given, settings, st  # hypothesis or fallback
from repro_torch.kernels.quant_rows import (sqdist_rows_quant,
                                            sqdist_rows_quant_plain)
from repro_torch.quant import codecs as P

CODECS = ("int8", "pq")
PQ_CHUNK = 48        # csrc/step_common.cuh::kPQChunk
THREADS = 256        # csrc/step_common.cuh::kThreads
PQ_ROWS_PER_THREAD = 4
INT8_TILE = 256      # csrc/quant_rows.cu::kInt8Rows


def _k6q_rows_tiled(prep, codes, norms, ids, mask):
    """A torch transcription of `csrc/quant_rows.cu` for every lane.

    int8: tiles of INT8_TILE positions, one row a warp: the dot of the
    int8 query and the row's codes (an integer: exact), then (qn + xn) −
    (2·sq)·dot, each rounded once, clamped at 0. PQ: tiles of
    THREADS·PQ_ROWS_PER_THREAD positions, thread t owning positions t +
    THREADS·k; a tile with no unmasked row reads nothing; the lane's table
    by chunks of PQ_CHUNK slots, each row's sum carried across chunks in
    slot order from 0, then max((qn + xn) − 2·ip, 0). +inf where masked.
    Every float32 operation is one torch op on float32 tensors, rounded
    once. Returns (out [B, V], the PQ (lane, tile) pairs that read their
    table)."""
    b, v = mask.shape
    out = torch.full((b, v), float("inf"))
    streamed = []
    f32 = torch.float32
    int8 = isinstance(prep, P.Int8Prep)
    tile = INT8_TILE if int8 else THREADS * PQ_ROWS_PER_THREAD
    for lane in range(b):
        for p0 in range(0, v, tile):
            if int8:      # warp w: positions p0 + w, p0 + w + 8, …
                pos = torch.arange(p0, min(p0 + tile, v))
            else:         # thread t: positions p0 + t + THREADS·k
                pos = torch.tensor(sorted(
                    p0 + t + THREADS * k for t in range(THREADS)
                    for k in range(PQ_ROWS_PER_THREAD)
                    if p0 + t + THREADS * k < v))
            on = pos[mask[lane, pos]]
            if on.numel() == 0:
                continue  # a PQ tile with no unmasked row reads nothing
            rows = ids[lane, on].long()
            if int8:
                dot = (prep.qq[lane].to(torch.int64)
                       * codes[rows].to(torch.int64)).sum(dim=1)
                sq2 = (2.0 * prep.sq[lane]).to(f32)
                t = sq2 * dot.to(f32)                  # exact: |dot| < 2^24
            else:
                streamed.append((lane, p0 // tile))
                ip = torch.zeros(on.numel(), dtype=f32)
                sl = codes.shape[1]
                for j0 in range(0, sl, PQ_CHUNK):
                    chunk = prep.lut[lane, j0:j0 + PQ_CHUNK]  # bulk copy
                    for jj in range(chunk.shape[0]):
                        ip = ip + chunk[jj, codes[rows, j0 + jj].long()]
                t = 2.0 * ip
            a = prep.qn[lane] + norms[rows]
            out[lane, on] = torch.clamp(a - t, min=0.0)
    return out, streamed


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
    """K6q rows' tiles and chunked slot-order PQ sum (`_k6q_rows_tiled`)
    == `sqdist_rows_quant_plain` bit for bit on unrounded data: widths off
    a multiple of 32 (int8: of 4 only) and of PQ_CHUNK, V across a tile
    boundary, the scan's and the oracle's layouts, dead lanes; a PQ tile
    reads its table only when one of its rows is unmasked."""

    @settings(max_examples=6, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), wi=st.integers(0, 2),
           vi=st.integers(0, 2))
    def check(seed, wi, vi):
        rng = np.random.default_rng(seed)
        width = ((36, 100, 12) if precision == "int8" else (13, 50, 97))[wi]
        v = (64, 1088, 320)[vi]
        args = _k6q_inputs(rng, precision, 3, v, 700, width)
        got, streamed = _k6q_rows_tiled(*args)
        want = sqdist_rows_quant_plain(*args)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        mask = args[4]
        assert torch.isinf(want[~mask]).all()
        assert torch.isfinite(want[mask]).all()
        if precision == "pq":
            tile = THREADS * PQ_ROWS_PER_THREAD
            need = {(lane, p // tile) for lane, p in
                    torch.nonzero(mask).tolist()}
            assert set(streamed) == need

    check()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", CODECS)
def test_k6q_rows_kernel_matches_plain_on_cuda(precision):
    """K6q rows on the card == its plain version bit for bit (int8: an
    exact dot and the same tail; PQ: the same slot-order sum), at widths
    off 32 / off PQ_CHUNK and a V across tiles, with a dead lane; an
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
