"""Batched affine-gap Smith-Waterman over read x window rectangles (ref:
aligner_swsse_ee_u8.cpp:775 alignNucleotidesEnd2EndSseU8 and the other
three SSE kernel variants, aligner_sw.cpp:500 SwAligner::align).

The reference implements Farrar striped DP over SSE lanes, one read at a
time, with u8/i16 precision switching. Here the DP is problem-parallel AND
row-parallel:

  state tiles are [Lq, P] (query position x problem-lane); a `lax.scan`
  walks the ref columns left->right. Within a column, the vertical
  (ref-gap) dependency F[i] = max(F[i-1]-e, H[i-1]-o) is resolved with a
  Kogge-Stone max-prefix-scan in log2(Lq) shifted maxes — the lazy-F loop
  of Farrar's method becomes a data-parallel scan.

  This is exact (not an approximation) because gap-open >= 0 lets F be
  computed from H-without-F of the same column: re-opening a vertical gap
  from a cell that was itself reached by a vertical gap is never better
  than extending the existing gap.

Scoring semantics mirror the reference (ref: scoring.h):
  cell score  = +MA on match, -mmpen[i] on mismatch, -NP if either char is N
  read gap    (ref consumed, horizontal E) open/extend
  ref gap     (read consumed, vertical F)  open/extend
  gap barrier: no gap moves in the first/last `gapbar` read rows
               (ref: scoring.h gapbar, "rows can only be entered diagonally")
  end-to-end:  alignment consumes the whole read; best over row len-1
  local:       H clamped at 0; best over all cells; +MA bonus per match

Engines with one semantics, tie rules included:
  - `sw_align_batch`: the jitted column scan on the default device
  - `sw_align_numpy_batch`: the same column scan in numpy, for the host
  - numpy oracle `sw_score_numpy` for tests (scalar, obviously-correct)
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = -(10 ** 8)
# padding unit of the problem axis: batches are padded to a power-of-two
# number of LANES-wide tiles, which bounds the set of compiled shapes
LANES = 128


@dataclass(frozen=True)
class SwConfig:
    ma: int = 0            # match bonus
    npen: int = 1          # N penalty
    rdg_open: int = 8      # read-gap first base (const+linear)
    rdg_ext: int = 3
    rfg_open: int = 8      # ref-gap first base
    rfg_ext: int = 3
    gapbar: int = 4
    local: bool = False


# ---------------------------------------------------------------- oracle ---

def sw_score_numpy(rd, mmpen, ref, cfg: SwConfig):
    """Scalar textbook-DP oracle. rd: [lq] codes, mmpen: [lq], ref: [lc]
    codes. Returns (best, best_i, best_j); ties prefer the leftmost end
    column, then the topmost row — matching the batched engines."""
    lq, lc = len(rd), len(ref)
    H = np.full((lq + 1, lc + 1), NEG_INF, dtype=np.int64)
    E = np.full((lq + 1, lc + 1), NEG_INF, dtype=np.int64)  # read gap (horiz)
    F = np.full((lq + 1, lc + 1), NEG_INF, dtype=np.int64)  # ref gap (vert)
    H[0, :] = 0  # alignment may start before any column (row -1)
    if cfg.local:
        H[:, 0] = 0  # local alignments may also start at any row at col 0
    best, bi, bj = NEG_INF, -1, -1
    for j in range(1, lc + 1):
        for i in range(1, lq + 1):
            rdc, rfc = rd[i - 1], ref[j - 1]
            if rdc > 3 or rfc > 3:
                s = -cfg.npen
            elif rdc == rfc:
                s = cfg.ma
            else:
                s = -int(mmpen[i - 1])
            gap_ok = (i - 1 >= cfg.gapbar) and (i - 1 < lq - cfg.gapbar)
            if gap_ok:
                E[i, j] = max(E[i, j - 1] - cfg.rdg_ext,
                              H[i, j - 1] - cfg.rdg_open)
                F[i, j] = max(F[i - 1, j] - cfg.rfg_ext,
                              H[i - 1, j] - cfg.rfg_open)
            h = max(H[i - 1, j - 1] + s, E[i, j], F[i, j])
            if cfg.local:
                h = max(h, 0)
            H[i, j] = h
        if cfg.local:
            for i in range(1, lq + 1):
                if H[i, j] >= best:  # ties: prefer later column & larger row
                    best, bi, bj = H[i, j], i - 1, j - 1
        else:
            if H[lq, j] > best:
                best, bi, bj = H[lq, j], lq - 1, j - 1
    return int(best), bi, bj


def sw_align_numpy_batch(rd, lens, mmpen, ref, reflens, cfg: SwConfig):
    """Vectorized host column-scan — same semantics (including tie rules)
    as the device engines. Used for SMALL job counts on the fused path's
    host side: a device call there would queue behind the in-flight fused
    batches (~2 batch periods of latency), so a few-problem rectangle DP
    is cheaper on the host even at numpy speed.

    rd: [B, Lq] codes (pad 5); lens: [B]; mmpen: [B, Lq] int;
    ref: [B, Lc] codes (pad 4); reflens: [B].
    Returns (best, best_i, best_j) int64 arrays, NEG_INF when no cell.
    """
    B, lq = rd.shape
    lc = ref.shape[1]
    neg = np.int64(NEG_INF)
    rd_t = np.asarray(rd, np.int64).T                    # [Lq, B]
    mm_t = np.asarray(mmpen, np.int64).T
    lens_a = np.asarray(lens, np.int64)
    reflens_a = np.asarray(reflens, np.int64)
    rows = np.arange(lq, dtype=np.int64)[:, None]
    gap_ok = (rows >= cfg.gapbar) & (rows < lens_a[None, :] - cfg.gapbar)
    last_mask = (rows < lens_a[None, :]) if cfg.local else \
        (rows == lens_a[None, :] - 1)
    h = np.zeros((lq, B), np.int64) if cfg.local else \
        np.full((lq, B), neg, np.int64)
    e = np.full((lq, B), neg, np.int64)
    best = np.full(B, neg, np.int64)
    bi = np.full(B, -1, np.int64)
    bj = np.full(B, -1, np.int64)
    is_n_rd = rd_t > 3
    for j in range(lc):
        rcol = np.asarray(ref[:, j], np.int64)[None, :]
        is_n = is_n_rd | (rcol > 3)
        s = np.where(is_n, -cfg.npen,
                     np.where(rd_t == rcol, cfg.ma, -mm_t))
        e = np.maximum(e - cfg.rdg_ext, h - cfg.rdg_open)
        e[~gap_ok] = neg
        h_up = np.concatenate([np.zeros((1, B), np.int64), h[:-1]], axis=0)
        hnf = np.maximum(h_up + s, e)
        hnf_src = np.where(rows >= (cfg.gapbar - 1), hnf, neg)
        f = np.concatenate([np.full((1, B), neg, np.int64),
                            hnf_src[:-1] - cfg.rfg_open], axis=0)
        d = 1
        while d < lq:
            f[d:] = np.maximum(f[d:], f[:-d] - d * cfg.rfg_ext)
            d *= 2
        f[~gap_ok] = neg
        h = np.maximum(hnf, f)
        if cfg.local:
            np.maximum(h, 0, out=h)
        scored = np.where(last_mask, h, neg)
        col_best = scored.max(axis=0)
        if cfg.local:   # ties: larger row
            col_arg = np.where(scored == col_best[None, :],
                               rows, -1).max(axis=0)
            ok = (j < reflens_a) & (col_best >= best)
        else:           # ties: smallest row
            col_arg = np.where(scored == col_best[None, :],
                               rows, np.int64(1 << 30)).min(axis=0)
            ok = (j < reflens_a) & (col_best > best)
        best = np.where(ok, col_best, best)
        bi = np.where(ok, col_arg, bi)
        bj = np.where(ok, j, bj)
    return best, bi, bj


# ------------------------------------------------- shared column update ----

def _column_update(cfg: SwConfig, lq_pad: int, rd, mmpen, gap_ok, last_mask,
                   h_prev, e_prev, rcol):
    """One DP column for a [Lq, P] tile.

    rd, mmpen, gap_ok, last_mask: [Lq, P] static per problem
    h_prev, e_prev: [Lq, P] carries (H and E of the previous column)
    rcol: [1, P] ref codes of this column
    returns (h, e, col_best, col_arg): new carries + per-problem best-in-column
    """
    neg = jnp.int32(NEG_INF)
    is_n = (rd > 3) | (rcol > 3)
    s = jnp.where(is_n, -cfg.npen, jnp.where(rd == rcol, cfg.ma, -mmpen))
    s = s.astype(jnp.int32)

    # E: read gap (horizontal)
    e = jnp.maximum(e_prev - cfg.rdg_ext, h_prev - cfg.rdg_open)
    e = jnp.where(gap_ok, e, neg)

    # diagonal: H_prev shifted down one row; row 0 sees H[-1] = 0 (e2e start)
    p = h_prev.shape[1]
    h_up = jnp.concatenate(
        [jnp.zeros((1, p), jnp.int32), h_prev[:-1]], axis=0)
    diag = h_up + s
    hnf = jnp.maximum(diag, e)

    # F: ref gap (vertical) via Kogge-Stone max-scan over rows.
    # Gap-barrier chain-breaking: a vertical gap spanning rows k+1..i needs
    # every spanned row un-barred. Barred rows form a prefix (< gapbar) and a
    # per-problem suffix (>= len-gapbar), so it suffices to (a) mask targets
    # by gap_ok (done below) and (b) restrict scan *sources* to rows
    # >= gapbar-1 — otherwise the scan would let gaps jump over barred prefix
    # rows, which the reference's sequential lazy-F forbids.
    rows_iota = jax.lax.broadcasted_iota(jnp.int32, hnf.shape, 0)
    src_ok = rows_iota >= (cfg.gapbar - 1)
    hnf_src = jnp.where(src_ok, hnf, neg)
    f = jnp.concatenate([jnp.full((1, p), neg, jnp.int32),
                         hnf_src[:-1] - cfg.rfg_open], axis=0)
    d = 1
    while d < lq_pad:
        shifted = jnp.concatenate(
            [jnp.full((d, p), neg, jnp.int32), f[:-d] - d * cfg.rfg_ext],
            axis=0)
        f = jnp.maximum(f, shifted)
        d *= 2
    f = jnp.where(gap_ok, f, neg)

    h = jnp.maximum(hnf, f)
    if cfg.local:
        h = jnp.maximum(h, 0)
    # last_mask: all valid rows (local) or row len-1 only (end-to-end)
    scored = jnp.where(last_mask, h, neg)
    col_best = jnp.max(scored, axis=0)
    rows = jax.lax.broadcasted_iota(jnp.int32, scored.shape, 0)
    if cfg.local:  # ties: larger row = longer alignment
        col_arg = jnp.max(
            jnp.where(scored == col_best[None, :], rows, jnp.int32(-1)),
            axis=0)
    else:
        col_arg = jnp.min(
            jnp.where(scored == col_best[None, :], rows, jnp.int32(1 << 30)),
            axis=0)
    return h, e, col_best, col_arg


def _make_masks(cfg: SwConfig, lens, lq_pad):
    """Build [Lq, P] masks from per-problem read lengths [P]."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (lq_pad, lens.shape[0]), 0)
    lens_b = lens[None, :]
    gap_ok = (rows >= cfg.gapbar) & (rows < lens_b - cfg.gapbar)
    if cfg.local:
        last_mask = rows < lens_b
    else:
        last_mask = rows == lens_b - 1
    return gap_ok, last_mask


# --------------------------------------------------------------- engines ---

def _sw_tile_xla(cfg: SwConfig, rd, mmpen, lens, ref, reflens):
    """[Lq, P] tile via lax.scan over ref columns. rd/mmpen: [Lq,P],
    lens/reflens: [P], ref: [Lc, P]."""
    lq_pad, p = rd.shape
    lc = ref.shape[0]
    gap_ok, last_mask = _make_masks(cfg, lens, lq_pad)
    neg = jnp.int32(NEG_INF)
    h0 = jnp.zeros((lq_pad, p), jnp.int32) if cfg.local else \
        jnp.full((lq_pad, p), neg, jnp.int32)
    init = (h0,
            jnp.full((lq_pad, p), neg, jnp.int32),
            jnp.full((p,), neg, jnp.int32),
            jnp.full((p,), -1, jnp.int32),
            jnp.full((p,), -1, jnp.int32))

    def step(carry, inp):
        h_prev, e_prev, best, bi, bj = carry
        rcol, j = inp
        h, e, col_best, col_arg = _column_update(
            cfg, lq_pad, rd, mmpen, gap_ok, last_mask, h_prev, e_prev,
            rcol[None, :])
        ok = (j < reflens) & (
            (col_best >= best) if cfg.local else (col_best > best))
        best = jnp.where(ok, col_best, best)
        bi = jnp.where(ok, col_arg, bi)
        bj = jnp.where(ok, j, bj)
        return (h, e, best, bi, bj), None

    (h, e, best, bi, bj), _ = jax.lax.scan(
        step, init, (ref.astype(jnp.int32), jnp.arange(lc, dtype=jnp.int32)))
    return best, bi, bj


@functools.lru_cache(maxsize=64)
def _sw_xla_jit(cfg: SwConfig):
    return jax.jit(functools.partial(_sw_tile_xla, cfg))


def sw_align_batch(rd, lens, mmpen, ref, reflens, cfg: SwConfig,
                   device=None):
    """Batched best-score alignment.

    rd:      [B, Lq] uint8 read codes (pad with 5)
    lens:    [B] int32 read lengths
    mmpen:   [B, Lq] int32 per-position mismatch penalties
    ref:     [B, Lc] uint8 ref window codes (pad with 4)
    reflens: [B] int32 valid window lengths
    device:  where to run (None = the default device)
    -> (best, best_i, best_j): [B] int32; best_i/j are 0-based read/window
       coordinates of the alignment end cell; best=NEG_INF if none.
    """
    B, lq = rd.shape
    lc = ref.shape[1]
    lq_pad = max(8, -(-lq // 8) * 8)

    # power-of-two tile count (shape bucketing; see ops/fm.py _pow2_pad)
    n_tiles_p = max(1, 1 << max(0, int(-(-B // LANES) - 1).bit_length()))
    Bp = n_tiles_p * LANES
    pad_b = Bp - B

    def prep(x, pad_val, width):
        x = np.asarray(x)
        if x.ndim == 1:
            out = np.full(Bp, pad_val, x.dtype)
            out[:B] = x
            return out
        out = np.full((Bp, width), pad_val, x.dtype)
        out[:B, : x.shape[1]] = x
        return out

    rd_p = prep(rd, 5, lq)
    rd_t = np.full((lq_pad, Bp), 5, np.int32)
    rd_t[:lq] = rd_p.T
    mm_t = np.zeros((lq_pad, Bp), np.int32)
    mm_t[:lq] = prep(mmpen, 0, lq).T
    ref_t = prep(ref, 4, lc).T.astype(np.int32)
    lens_p = prep(np.asarray(lens, np.int32), 1, 0)
    reflens_p = prep(np.asarray(reflens, np.int32), 0, 0)

    best, bi, bj = _sw_xla_jit(cfg)(*jax.device_put(
        (rd_t, mm_t, lens_p, ref_t, reflens_p), device))
    return (np.asarray(best)[:B], np.asarray(bi)[:B], np.asarray(bj)[:B])
