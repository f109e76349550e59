"""Banded affine-gap DP in diagonal coordinates — the seed-extension
workhorse (ref: aligner_swsse_*.cpp fills a read x window rectangle; here
the DP covers a band of width K around the anchor diagonal, O(L*K) cells
instead of O(L^2)).

Coordinates: band index k in [0, K), center c = K//2. Cell (i, k) is read
position i against joined position pos = (diag - c) + i + k, i.e. ref char
`band[i + k]` where `band` is the window slice of length len+K starting at
diag - c.

Moves in band coordinates:
  diagonal  (i-1, j-1) -> (i-1, k)     consume read+ref
  vertical  (i-1, j)   -> (i-1, k+1)   ref gap (read char inserted), F
  horizontal(i,   j-1) -> (i,   k-1)   read gap (ref char deleted),  E
E has a within-row chain along k, resolved with a Kogge-Stone max-scan from
H-without-E (exact while gap-open >= gap-extend, same argument as ops/sw.py).

Equivalence to the reference's rectangle: paths whose column excursion from
the anchor diagonal stays within +-c. A path leaving the band needs > c gap
bases in one direction, costing >= open + c*extend; for the default scoring
and read lengths <= ~110 bp this exceeds any valid score budget, making the
band exact; for longer reads it is the standard banded approximation (and
the band can be widened).

Engines with one semantics, tie rules included:
  - `_banded_tile_xla`: lax.scan over rows on [K, P] tiles, the device
    engine (inside the fused program and via `sw_banded_batch`)
  - numpy oracles `banded_best_numpy` (one problem) and
    `banded_best_numpy_batch` (vectorized over problems) for tests
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .sw import LANES, NEG_INF, SwConfig

DEFAULT_BAND = 32


# ---------------------------------------------------------------- oracle ---

def banded_fill_numpy(rd, mmpen, band, cfg: SwConfig, K: int = DEFAULT_BAND):
    """Host fill (vectorized over k per row). band: [len(rd)+K] ref codes.
    Returns H, E, F arrays of shape [lq, K] (no boundary rows; row -1
    handled implicitly: H[-1][*] = 0)."""
    lq = len(rd)
    H = np.full((lq, K), NEG_INF, np.int64)
    E = np.full((lq, K), NEG_INF, np.int64)
    F = np.full((lq, K), NEG_INF, np.int64)
    ks = np.arange(K)
    for i in range(lq):
        rfc = band[i : i + K].astype(np.int64)
        rdc = int(rd[i])
        if rdc > 3:
            s = np.full(K, -cfg.npen, np.int64)
        else:
            s = np.where(rfc > 3, -cfg.npen,
                         np.where(rfc == rdc, cfg.ma, -int(mmpen[i])))
        gap_ok = (i >= cfg.gapbar) and (i < lq - cfg.gapbar)
        h_up = H[i - 1] if i > 0 else np.zeros(K, np.int64)
        f_up = F[i - 1] if i > 0 else np.full(K, NEG_INF, np.int64)
        diag = h_up + s
        # F from (i-1, k+1)
        f = np.full(K, NEG_INF, np.int64)
        f[:-1] = np.maximum(f_up[1:] - cfg.rfg_ext, h_up[1:] - cfg.rfg_open)
        if not gap_ok:
            f[:] = NEG_INF
        base = np.maximum(diag, f)
        # E scan along k from base
        e = np.full(K, NEG_INF, np.int64)
        e[1:] = base[:-1] - cfg.rdg_open
        d = 1
        while d < K:
            e[d:] = np.maximum(e[d:], e[:-d] - d * cfg.rdg_ext)
            d *= 2
        if not gap_ok:
            e[:] = NEG_INF
        h = np.maximum(base, e)
        if cfg.local:
            h = np.maximum(h, 0)
        H[i], E[i], F[i] = h, e, f
    return H, E, F


def banded_best_numpy(rd, mmpen, band, cfg, K=DEFAULT_BAND):
    H, _, _ = banded_fill_numpy(rd, mmpen, band, cfg, K)
    lq = len(rd)
    if cfg.local:
        # ties: prefer the LAST maximal cell (longer alignment), matching
        # the reference's observed choice
        m = int(H.max())
        rows, ks = np.nonzero(H == m)
        return m, int(rows[-1]), int(ks[-1])
    row = H[lq - 1]
    m = int(row.max())
    k = int(np.nonzero(row == m)[0][-1])   # ties: larger k, see engines
    return m, lq - 1, k


def banded_best_numpy_batch(rd, lens, mmpen, band, cfg: SwConfig,
                            K: int = DEFAULT_BAND):
    """`banded_best_numpy` vectorized over problems, same layout as
    `sw_banded_batch` (rd/mmpen [B, Lq], lens [B], band [B, Lq+K]); problem
    b is rd[b, :lens[b]] against band[b, :lens[b]+K]. Returns (best, bi, bk)
    int64 [B]."""
    rd = np.asarray(rd, np.int64)
    mmpen = np.asarray(mmpen, np.int64)
    band = np.asarray(band, np.int64)
    lens = np.asarray(lens, np.int64)
    B, lq = rd.shape
    neg = np.int64(NEG_INF)
    h = np.zeros((B, K), np.int64)
    f = np.full((B, K), neg, np.int64)
    best = np.full(B, neg, np.int64)
    bi = np.full(B, -1, np.int64)
    bk = np.full(B, -1, np.int64)
    ks = np.arange(K, dtype=np.int64)[None, :]
    for i in range(int(lens.max(initial=0))):
        rfc = band[:, i : i + K]
        rdc = rd[:, i : i + 1]
        s = np.where((rdc > 3) | (rfc > 3), -cfg.npen,
                     np.where(rfc == rdc, cfg.ma, -mmpen[:, i : i + 1]))
        gap_ok = ((i >= cfg.gapbar) & (i < lens - cfg.gapbar))[:, None]
        diag = h + s
        f_new = np.full((B, K), neg, np.int64)
        f_new[:, :-1] = np.maximum(f[:, 1:] - cfg.rfg_ext,
                                   h[:, 1:] - cfg.rfg_open)
        f = np.where(gap_ok, f_new, neg)
        base = np.maximum(diag, f)
        e = np.full((B, K), neg, np.int64)
        e[:, 1:] = base[:, :-1] - cfg.rdg_open
        d = 1
        while d < K:
            e[:, d:] = np.maximum(e[:, d:], e[:, :-d] - d * cfg.rdg_ext)
            d *= 2
        e = np.where(gap_ok, e, neg)
        h = np.maximum(base, e)
        if cfg.local:
            h = np.maximum(h, 0)
            scored = np.where((i < lens)[:, None], h, neg)
        else:
            scored = np.where((i == lens - 1)[:, None], h, neg)
        row_best = scored.max(axis=1)
        row_arg = np.where(scored == row_best[:, None], ks, -1).max(axis=1)
        ok = (row_best >= best) if cfg.local else (row_best > best)
        best = np.where(ok, row_best, best)
        bi = np.where(ok, i, bi)
        bk = np.where(ok, row_arg, bk)
    return best, bi, bk


def banded_traceback(rd, mmpen, band, cfg, end_i, end_k, K=DEFAULT_BAND):
    """Backtrace in band coordinates. Returns (edits, start_band_pos,
    read_start): start_band_pos = index into `band` of the first aligned ref
    base. Edit convention matches align/edits.py."""
    H, E, F = banded_fill_numpy(rd, mmpen, band, cfg, K)
    edits = []
    i, k = end_i, end_k
    state = "H"
    while True:
        if state == "H":
            rdc, rfc = int(rd[i]), int(band[i + k])
            if rdc > 3 or rfc > 3:
                s = -cfg.npen
            elif rdc == rfc:
                s = cfg.ma
            else:
                s = -int(mmpen[i])
            h_up = H[i - 1, k] if i > 0 else 0
            # Local zero cells: continue only through a GAP predecessor
            # (see edits.py rect traceback note — golden-verified both
            # ways), otherwise clip here.
            if cfg.local and H[i, k] == 0:
                if H[i, k] == E[i, k]:
                    state = "E"
                    continue
                if H[i, k] == F[i, k]:
                    state = "F"
                    continue
                # zero-restart cell: the local alignment starts at i+1
                i += 1
                break
            if H[i, k] == h_up + s:
                if rdc != rfc or rdc > 3 or rfc > 3:
                    edits.append(("M", i, rfc, rdc))
                i -= 1
                if i < 0:
                    i = 0
                    break
            elif H[i, k] == E[i, k]:
                state = "E"
            elif H[i, k] == F[i, k]:
                state = "F"
            else:
                raise AssertionError(f"banded backtrace stuck at ({i},{k})")
        elif state == "E":  # read gap: ref char at band[i+k] deleted
            # keyed at i+1: the gap's ref chars precede read char i+1
            edits.append(("D", i + 1, int(band[i + k])))
            prev_ext = k >= 1 and E[i, k] == E[i, k - 1] - cfg.rdg_ext
            k -= 1
            if not prev_ext:
                state = "H"
        else:  # state == "F": read char i inserted
            edits.append(("I", i, int(rd[i])))
            prev_ext = (i >= 1 and k + 1 < K
                        and F[i, k] == F[i - 1, k + 1] - cfg.rfg_ext)
            i -= 1
            k += 1
            if i < 0:
                i = 0
                break
            if not prev_ext:
                state = "H"
    edits.reverse()
    # after the loop: (i, k) is the first aligned cell
    return edits, i + k, i


# --------------------------------------------------------------- engines ---

def _banded_update(cfg: SwConfig, K: int, h_up, f_up, s, gap_row):
    """One row update on [K, P] tiles. gap_row: scalar-per-problem [1, P]
    bool (row within gap barrier limits)."""
    neg = jnp.int32(NEG_INF)
    p = h_up.shape[1]
    diag = h_up + s
    f = jnp.concatenate(
        [jnp.maximum(f_up[1:] - cfg.rfg_ext, h_up[1:] - cfg.rfg_open),
         jnp.full((1, p), neg, jnp.int32)], axis=0)
    f = jnp.where(gap_row, f, neg)
    base = jnp.maximum(diag, f)
    e = jnp.concatenate(
        [jnp.full((1, p), neg, jnp.int32), base[:-1] - cfg.rdg_open], axis=0)
    d = 1
    while d < K:
        e = jnp.maximum(
            e,
            jnp.concatenate([jnp.full((d, p), neg, jnp.int32),
                             e[:-d] - d * cfg.rdg_ext], axis=0))
        d *= 2
    e = jnp.where(gap_row, e, neg)
    h = jnp.maximum(base, e)
    if cfg.local:
        h = jnp.maximum(h, 0)
    return h, f


def _banded_tile_xla(cfg: SwConfig, K: int, rd, mmpen, lens, band):
    """rd/mmpen: [Lq, P]; lens: [P]; band: [Lq+K, P]. Scan over rows."""
    lq, p = rd.shape
    neg = jnp.int32(NEG_INF)
    ks = jnp.arange(K, dtype=jnp.int32)[:, None]

    def step(carry, i):
        h_up, f_up, best, bi, bk = carry
        rfc = jax.lax.dynamic_slice(band, (i, 0), (K, p))
        rdc = rd[i][None, :]
        mm = mmpen[i][None, :]
        is_n = (rdc > 3) | (rfc > 3)
        s = jnp.where(is_n, -cfg.npen,
                      jnp.where(rfc == rdc, cfg.ma, -mm)).astype(jnp.int32)
        gap_row = ((i >= cfg.gapbar) & (i < lens - cfg.gapbar))[None, :]
        h, f = _banded_update(cfg, K, h_up, f_up, s, gap_row)
        if cfg.local:
            scored = jnp.where(i < lens[None, :], h, neg)
        else:
            scored = jnp.where(i == lens[None, :] - 1, h, neg)
        col_best = jnp.max(scored, axis=0)
        # ties: larger k (rightmost end column) in BOTH modes — the
        # reference's backtrace branch order prefers the larger column
        # (aligner_bt.h:450 operator<: `col_ > o.col_`), observed on the
        # co-optimal-tie class of the lambda longreads
        col_arg = jnp.max(
            jnp.where(scored == col_best[None, :], ks, jnp.int32(-1)),
            axis=0)
        ok = (col_best >= best) if cfg.local else (col_best > best)
        best = jnp.where(ok, col_best, best)
        bi = jnp.where(ok, i, bi)
        bk = jnp.where(ok, col_arg, bk)
        return (h, f, best, bi, bk), None

    init = (jnp.zeros((K, p), jnp.int32),          # H[-1] = 0 (free start)
            jnp.full((K, p), neg, jnp.int32),
            jnp.full((p,), neg, jnp.int32),
            jnp.full((p,), -1, jnp.int32),
            jnp.full((p,), -1, jnp.int32))
    (h, f, best, bi, bk), _ = jax.lax.scan(
        step, init, jnp.arange(lq, dtype=jnp.int32))
    return best, bi, bk


@functools.lru_cache(maxsize=64)
def _banded_xla_jit(cfg: SwConfig, K: int):
    return jax.jit(functools.partial(_banded_tile_xla, cfg, K))


def sw_banded_batch(rd, lens, mmpen, band, cfg: SwConfig,
                    K: int = DEFAULT_BAND, device=None):
    """Batched banded alignment.

    rd:    [B, Lq] uint8 (pad 5); lens: [B]; mmpen: [B, Lq] int32
    band:  [B, Lq+K] uint8 ref codes (pad 4)
    device: where to run (None = the default device)
    -> (best, bi, bk): [B] int32; joined end pos = band_start + bi + bk.
    """
    B, lq = rd.shape
    assert band.shape[1] == lq + K
    # power-of-two tile count: bounds the set of compiled shapes
    Bp = max(1, 1 << max(0, int(-(-B // LANES) - 1).bit_length())) * LANES

    rd_t = np.full((lq, Bp), 5, np.int32)
    rd_t[:, :B] = np.asarray(rd, np.int32).T
    mm_t = np.zeros((lq, Bp), np.int32)
    mm_t[:, :B] = np.asarray(mmpen, np.int32).T
    band_t = np.full((lq + K, Bp), 4, np.int32)
    band_t[:, :B] = np.asarray(band, np.int32).T
    lens_t = np.ones(Bp, np.int32)
    lens_t[:B] = np.asarray(lens, np.int32)

    best, bi, bk = _banded_xla_jit(cfg, K)(*jax.device_put(
        (rd_t, mm_t, lens_t, band_t), device))
    return np.asarray(best)[:B], np.asarray(bi)[:B], np.asarray(bk)[:B]
