"""Vector-quantization codecs: int8 scalar quantization and product
quantization, with their asymmetric distances (ADC).

Counterpart of `repro/quant/codecs.py`, on torch tensors:

  int8  per-dimension affine quantization, x̂ = zero + scale ⊙ c with
        c ∈ [-127, 127]^d. The query factor qs = (q − zero) ⊙ scale is
        quantized once per query to int8 (step sq), so a candidate costs an
        int8 dot plus two stored scalars:
        d̂ = ‖q − zero‖² + ‖scale ⊙ c‖² − 2·sq·(qq · c).
  pq    multi-level (residual) product quantization: S subspaces, L levels
        of Kc ≤ 256 centroids; a vector is S·L uint8 codes (slot l·S + s is
        level l of subspace s) and d̂ = ‖q‖² + ‖x̂‖² − 2·Σ_slots lut[slot,
        code] with lut[l·S + s, c] = q_s · centroid_{l,s,c}.

Both store the per-node reconstruction error ‖x − x̂‖², which the
traversal sums into `q_err_sum` (the `quant_err_*` features).

`quant_dist` is the plain form of the compressed distance: the dense
backend, `init_state` and the plain versions of kernels K3, K4 and K5's
codec branches call it. The int8 dot is an integer: here a float32 matrix
product, exact because every partial sum is an integer below 2²⁴
(127²·d < 2²⁴ for d ≤ 1040; int8 values are exact in TF32 too), so plain
and kernel int8 distances agree bit for bit. The PQ lookup sum is
`torch.sum`'s order here and slot order 0..S·L−1 in the kernels, as in
the reference's kernels. `compressed_filtered_topk`, the compressed
oracle, lives in `index.bruteforce` beside the float32 oracles and takes
its distances from kernel K6q rows (by row id) and its plain version,
which both sum in slot order.

The codecs train on the device: the k-means of all S subspaces of a
level run batched, from the initial centroids the reference's numpy
generator draws (same seed, same draws, same order).
"""
from __future__ import annotations

import hashlib
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

_EPS = 1e-12
MAX_INT8_DIM = 1040  # 127² · d < 2²⁴: the float32 int8 dot stays exact
_SUB_CHUNK = 16      # PQ subspaces whose k-means run as one batch


# ---------------------------------------------------------------- indices ----
class Int8Index(NamedTuple):
    """int8 scalar-quantized vector store."""

    codes: torch.Tensor   # [N, d] int8
    scale: torch.Tensor   # [d] f32 — dequant step per dimension
    zero: torch.Tensor    # [d] f32 — per-dimension zero point
    norms: torch.Tensor   # [N] f32 — ‖scale ⊙ codes‖² (the ADC xn term)
    err: torch.Tensor     # [N] f32 — ‖x − x̂‖² reconstruction error


class PQIndex(NamedTuple):
    """(Multi-level) product-quantized vector store, levels flattened
    level-major into one slot axis of size S·L."""

    codes: torch.Tensor      # [N, S·L] uint8 (slot l·S + s = level l of s)
    codebooks: torch.Tensor  # [L, S, Kc, dsub] f32
    norms: torch.Tensor      # [N] f32 — ‖x̂‖² (the ADC xn term)
    err: torch.Tensor        # [N] f32 — ‖x − x̂‖² reconstruction error


class Int8Prep(NamedTuple):
    """Per-query ADC state of the int8 codec (built once per search)."""

    qq: torch.Tensor  # [B, d] int8 — quantized (q − zero) ⊙ scale
    sq: torch.Tensor  # [B] f32 — per-query step of qq
    qn: torch.Tensor  # [B] f32 — ‖q − zero‖²


class PQPrep(NamedTuple):
    """Per-query ADC state of the PQ codec: the inner-product table."""

    lut: torch.Tensor  # [B, S·L, Kc] f32 — q_s · centroid (slot l·S + s)
    qn: torch.Tensor   # [B] f32 — ‖q‖²


class QuantGather(NamedTuple):
    """One step's gathered compressed data, handed to the backend: `codes`
    [B, R, d] int8 or [B, R, S·L] uint8 (read as uint8 — no widening),
    `norms` [B, R] f32 (‖scale⊙c‖² for int8, ‖x̂‖² for pq)."""

    prep: Any              # Int8Prep | PQPrep
    codes: torch.Tensor
    norms: torch.Tensor


def _f32(a, device=None) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=torch.float32)


# --------------------------------------------------------------- int8 SQ ----
def train_int8(vectors) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-dimension affine parameters (scale, zero) from a training sample."""
    v = _f32(vectors)
    lo = v.min(dim=0).values
    hi = v.max(dim=0).values
    scale = torch.clamp((hi - lo) / 254.0, min=_EPS)
    zero = (hi + lo) / 2.0
    return scale, zero


def encode_int8(scale, zero, vectors, chunk: int = 65536):
    """vectors [N, d] → (codes int8 [N, d], norms [N], err [N]), chunked
    over N to bound the float intermediates."""
    v = torch.as_tensor(vectors)
    codes, norms, err = [], [], []
    for s in range(0, v.shape[0], chunk):
        x = v[s:s + chunk].to(device=scale.device, dtype=torch.float32)
        c = torch.clamp(torch.round((x - zero) / scale), -127, 127)
        dec = c * scale                       # x̂ − zero
        resid = (x - zero) - dec
        codes.append(c.to(torch.int8))
        norms.append((dec * dec).sum(dim=1))
        err.append((resid * resid).sum(dim=1))
    return torch.cat(codes), torch.cat(norms), torch.cat(err)


def prep_int8(index: Int8Index, queries) -> Int8Prep:
    """Quantize the per-query ADC factor qs = (q − zero) ⊙ scale to int8
    (round half to even, as `jnp.round`)."""
    q = _f32(queries, index.scale.device)
    qz = q - index.zero[None, :]
    qs = qz * index.scale[None, :]
    sq = torch.clamp(qs.abs().max(dim=1).values / 127.0, min=_EPS)
    qq = torch.clamp(torch.round(qs / sq[:, None]), -127, 127).to(torch.int8)
    qn = (qz * qz).sum(dim=1)
    return Int8Prep(qq=qq, sq=sq, qn=qn)


def _int8_assemble(prep: Int8Prep, norms, dot):
    """The int8 ADC float tail: (qn + xn) − (2·sq)·dot, clamped ≥ 0 — one
    source for the gathered and the corpus-blocked layouts, and the
    expression kernels K3 and K5 round the same way."""
    d = prep.qn[:, None] + norms - 2.0 * prep.sq[:, None] * dot
    return torch.clamp(d, min=0.0)


def _int8_dot_check(d: int) -> None:
    if d > MAX_INT8_DIM:
        raise ValueError(f"int8 ADC at d={d}: the float32 dot is exact only "
                         f"up to d={MAX_INT8_DIM}")


def adc_int8(prep: Int8Prep, codes_g, norms_g):
    """Compressed squared L2 from gathered codes [B, R, d] int8 and norms
    [B, R]: an exact integer dot, then the float tail."""
    _int8_dot_check(codes_g.shape[-1])
    dot = torch.einsum("bd,brd->br", prep.qq.to(torch.float32),
                       codes_g.to(torch.float32))
    return _int8_assemble(prep, norms_g, dot)


def decode_int8(index: Int8Index, codes=None):
    """codes int8 [..., d] → float32 reconstruction x̂."""
    c = index.codes if codes is None else codes
    return index.zero + c.to(torch.float32) * index.scale


# -------------------------------------------------------------------- PQ ----
def _kmeans(x, cent, iters: int):
    """Lloyd iterations, batched over subspaces: x [S, n, dsub],
    cent [S, Kc, dsub] → [S, Kc, dsub]. Per subspace the reference's
    step: assign by ‖x‖² + ‖c‖² − 2 x·c, then the mean of each non-empty
    cluster (one-hot product, as the reference's)."""
    kc = cent.shape[1]
    xx = (x * x).sum(dim=2)[:, :, None]
    for _ in range(iters):
        d = (xx + (cent * cent).sum(dim=2)[:, None, :]
             - 2.0 * torch.bmm(x, cent.transpose(1, 2)))
        assign = torch.argmin(d, dim=2)                        # [S, n]
        onehot = torch.nn.functional.one_hot(assign, kc).to(torch.float32)
        counts = onehot.sum(dim=1)                             # [S, Kc]
        sums = torch.bmm(onehot.transpose(1, 2), x)            # [S, Kc, dsub]
        cent = torch.where(counts[:, :, None] > 0,
                           sums / torch.clamp(counts, min=1.0)[:, :, None],
                           cent)
    return cent


def train_pq(vectors, n_subspaces: int, n_centroids: int = 256,
             iters: int = 20, seed: int = 0, n_levels: int = 1
             ) -> torch.Tensor:
    """Residual k-means codebooks [L, S, Kc, dsub] from a training sample.

    Level 0 quantizes the subspace vectors; level l > 0 quantizes the
    residual left by the levels before it. The initial centroids are the
    rows the reference draws with `np.random.default_rng(seed).choice`,
    level by level and subspace by subspace; the k-means of `_SUB_CHUNK`
    subspaces run as one batch, on `vectors`' device.
    """
    v = _f32(vectors)
    n, d = v.shape
    if d % n_subspaces:
        raise ValueError(f"dim {d} not divisible by {n_subspaces} subspaces")
    if not 2 <= n_centroids <= 256:
        raise ValueError(f"n_centroids must be in [2, 256] (uint8 codes), "
                         f"got {n_centroids}")
    if n_levels < 1:
        raise ValueError(f"n_levels must be >= 1, got {n_levels}")
    dsub = d // n_subspaces
    rng = np.random.default_rng(seed)
    xs = v.reshape(n, n_subspaces, dsub).transpose(0, 1).contiguous()
    books = []
    for _ in range(n_levels):
        init = np.stack([rng.choice(n, size=n_centroids,
                                    replace=n < n_centroids)
                         for _ in range(n_subspaces)])          # [S, Kc]
        init_t = torch.from_numpy(init).to(v.device)
        level = []
        for s0 in range(0, n_subspaces, _SUB_CHUNK):
            x = xs[s0:s0 + _SUB_CHUNK]                          # [s, n, dsub]
            cent0 = torch.gather(
                x, 1, init_t[s0:s0 + _SUB_CHUNK, :, None].expand(-1, -1, dsub))
            cent = _kmeans(x, cent0, iters)
            # residual: subtract the nearest centroid (direct differences,
            # as the reference's numpy pass)
            dd = ((x[:, :, None, :] - cent[:, None, :, :]) ** 2).sum(dim=3)
            pick = torch.gather(
                cent, 1, dd.argmin(dim=2)[:, :, None].expand(-1, -1, dsub))
            xs[s0:s0 + _SUB_CHUNK] = x - pick
            level.append(cent)
        books.append(torch.cat(level))
    return torch.stack(books)


def _encode_pq_chunk(codebooks, v):
    levels, s, kc, dsub = codebooks.shape
    n = v.shape[0]
    xs = v.reshape(n, s, dsub)
    codes = []
    for lvl in range(levels):
        bl = codebooks[lvl]                                    # [S, Kc, dsub]
        dd = ((xs * xs).sum(dim=2)[:, :, None]
              + (bl * bl).sum(dim=2)[None, :, :]
              - 2.0 * torch.einsum("nsd,scd->nsc", xs, bl))
        c = torch.argmin(dd, dim=2)                            # [n, S]
        codes.append(c)
        picked = torch.gather(bl[None].expand(n, -1, -1, -1), 2,
                              c[:, :, None, None].expand(-1, -1, 1, dsub)
                              )[:, :, 0, :]                    # [n, S, dsub]
        xs = xs - picked
    err = (xs * xs).sum(dim=(1, 2))
    dec = v.reshape(n, s, dsub) - xs                           # x̂ per subspace
    norms = (dec * dec).sum(dim=(1, 2))
    return torch.cat(codes, dim=1).to(torch.uint8), norms, err


def encode_pq(codebooks, vectors, chunk: int = 4096):
    """vectors [N, d] → (codes uint8 [N, S·L], norms ‖x̂‖² [N], err [N]);
    chunked over N to bound the [chunk, S, Kc] assignment intermediate."""
    v = torch.as_tensor(vectors)
    parts = [_encode_pq_chunk(codebooks, v[i:i + chunk].to(
        device=codebooks.device, dtype=torch.float32))
        for i in range(0, v.shape[0], chunk)]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def build_pq_lut(codebooks, queries):
    """Per-query inner-product table [B, S·L, Kc]; slot l·S + s holds
    q_s · centroid_{l,s,c}."""
    levels, s, kc, dsub = codebooks.shape
    q = _f32(queries, codebooks.device)
    qs = q.reshape(q.shape[0], s, dsub)
    lut = torch.einsum("bsd,lscd->blsc", qs, codebooks)
    return lut.reshape(q.shape[0], levels * s, kc).contiguous()


def _pq_assemble(prep: PQPrep, norms, ip):
    """The PQ ADC float tail: (qn + xn) − 2·ip, clamped ≥ 0."""
    return torch.clamp(prep.qn[:, None] + norms - 2.0 * ip, min=0.0)


def adc_pq(prep: PQPrep, codes_g, norms_g):
    """Compressed squared L2 from gathered codes [B, R, S·L] (uint8) and
    norms [B, R]: d̂ = ‖q‖² + ‖x̂‖² − 2·Σ_slots lut[slot, code]."""
    idx = codes_g.to(torch.int64).transpose(1, 2)              # [B, S·L, R]
    ip = torch.gather(prep.lut, 2, idx).sum(dim=1)
    return _pq_assemble(prep, norms_g, ip)


def decode_pq(index: PQIndex, codes=None):
    """codes [..., S·L] → float32 reconstruction x̂ (the sum of the L level
    centroids of each subspace)."""
    c = (index.codes if codes is None else codes).to(torch.int64)
    levels, s, kc, dsub = index.codebooks.shape
    n = c.shape[0]
    flat = index.codebooks.reshape(levels * s, kc, dsub)
    slot = torch.arange(levels * s, device=c.device)
    gathered = flat[slot[None, :], c]                          # [N, S·L, dsub]
    return gathered.reshape(n, levels, s, dsub).sum(dim=1).reshape(
        n, s * dsub)


# ------------------------------------------------------------- dispatch ----
def prepare_query(precision: str, index, queries):
    """Per-search query preparation."""
    if precision == "int8":
        return prep_int8(index, queries)
    if precision == "pq":
        q = _f32(queries, index.codebooks.device)
        return PQPrep(lut=build_pq_lut(index.codebooks, q),
                      qn=(q * q).sum(dim=1))
    raise ValueError(f"unknown precision {precision!r}")


def quant_dist(precision: str, qg: QuantGather):
    """[B, R] compressed squared L2 from one step's gathered codes."""
    if precision == "int8":
        return adc_int8(qg.prep, qg.codes, qg.norms)
    if precision == "pq":
        return adc_pq(qg.prep, qg.codes, qg.norms)
    raise ValueError(f"unknown precision {precision!r}")


def build_quant_index(precision: str, vectors, train_sample=None, *,
                      pq_subspaces: int | None = None, pq_centroids: int = 256,
                      pq_iters: int = 20, pq_levels: int | None = None,
                      seed: int = 0, device=None):
    """Train a codec on `train_sample` (default: all of `vectors`) and
    encode every row of `vectors`, on `device` (the card by default; the
    CPU only when asked, see `resolve_device`)."""
    v = torch.as_tensor(vectors)
    dev = resolve_device(device)
    t = v if train_sample is None else torch.as_tensor(train_sample)
    t = t.to(dev, torch.float32)
    if precision == "int8":
        _int8_dot_check(int(v.shape[1]))
        scale, zero = train_int8(t)
        codes, norms, err = encode_int8(scale, zero, v)
        return Int8Index(codes=codes, scale=scale, zero=zero, norms=norms,
                         err=err)
    if precision == "pq":
        d = int(v.shape[1])
        if pq_subspaces is None:  # 4-dim subspaces by default
            pq_subspaces = next(s for s in (d // 4, 8, 4, 2, 1)
                                if s >= 1 and d % s == 0)
        if pq_levels is None:     # three residual levels
            pq_levels = 3
        books = train_pq(t, pq_subspaces, pq_centroids, pq_iters, seed,
                         n_levels=pq_levels)
        codes, norms, err = encode_pq(books, v)
        return PQIndex(codes=codes, codebooks=books, norms=norms, err=err)
    raise ValueError(f"unknown precision {precision!r} "
                     "(expected 'int8' or 'pq')")


def codec_key(precision: str, index) -> str:
    """Codec identity: precision tag + a digest of the codec parameters
    (scale/zero or codebooks, not the codes) — the reference's key for the
    same parameters."""
    if index is None or precision == "float32":
        return "float32"
    h = hashlib.sha1()
    if isinstance(index, Int8Index):
        h.update(index.scale.detach().cpu().numpy().tobytes())
        h.update(index.zero.detach().cpu().numpy().tobytes())
    elif isinstance(index, PQIndex):
        h.update(index.codebooks.detach().cpu().numpy().tobytes())
    else:
        raise TypeError(f"unknown quant index {type(index).__name__}")
    return f"{precision}:{h.hexdigest()[:12]}"


def index_nbytes(index) -> int:
    """Traversal-resident bytes of a quant index: codes, per-node stats and
    codec parameters."""
    return sum(t.numel() * t.element_size() for t in index)


def store_ratio(index, base_vectors) -> float:
    """How many times smaller the quant store is than the float32 store."""
    b = torch.as_tensor(base_vectors)
    return b.numel() * b.element_size() / index_nbytes(index)


def compressed_filtered_topk(precision: str, index, queries, valid_mask,
                             k: int, chunk: int = 128,
                             n_block: int = 1 << 18):
    """The compressed oracle under the reference's name and module: see
    `index.bruteforce.compressed_filtered_topk`, which shares its loop
    with the float32 oracles."""
    # imported here: index.bruteforce imports the kernels, which import
    # this module
    from repro_torch.index.bruteforce import compressed_filtered_topk as topk

    return topk(precision, index, queries, valid_mask, k, chunk, n_block)
