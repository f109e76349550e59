"""Batched FM-index ops on device (ref: aligner_seed.cpp:668 searchSeedBi,
:854 exactSweep; bt2_idx.h:1758 countBt2Side, :2087 mapLFEx).

The reference walks one read at a time through LF-mapping with software
prefetch and popcount intrinsics. On the device the same math becomes
batched gathers + vectorized in-block counts:

    occ(c, row) = occ_ckpt[row // B, c] + count(bwt[row//B*B : row] == c)
    LF: top' = cnt[c] + occ(c, top);  bot' = cnt[c] + occ(c, bot)

applied to [batch]-shaped row vectors under `lax.fori_loop`, one iteration
per pattern character (fixed trip count, masked for finished/invalid lanes —
XLA-friendly control flow instead of data-dependent loops).

SA resolution is a single gather into the full on-device suffix array,
replacing the group-walk subsystem (ref: group_walk.h).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index.fm import FTAB_CHARS, OCC_BLOCK, FmDirection


# Device occ layout: fused 32-byte "sides", one per 64-row block:
# [cntA, cntC, cntG, cntT, w0..w3] as 8 uint32 — checkpoint counts followed
# by the block's 2-bit packed BWT (16 bases/word, little-endian).
# An occ query is ONE 32-byte row gather (the whole side in one gather
# index) + XOR/popcount counting. This is the reference's side layout (bt2_idx.h:112-166,
# ccnt_lut.cpp) re-derived for 32-bit lanes + jax.lax.population_count.
DEV_OCC_BLOCK = 64
_SIDE_W = 8
_PAIR_MASK = 0x55555555


# Big-index mode: joined texts within int32 run the classic layout; texts
# beyond it (GRCh38-scale .bt2l genomes) switch every row value to uint32
# (covers 4.29 Gbp — the same span the reference's 32-bit-offset build
# covers before forcing `-l`) and replace the full on-device SA with an
# offRate-sampled SA resolved by a device walk-left loop (ref:
# bt2_idx.h:1607 walkLeft, :1612 getOffset; offRate=5 default at
# bt2_idx.h:133). IMPORTANT: JAX's uint32/int32 mixed-op promotion truncates
# to int32 with x64 disabled, so all row-typed math below keeps a single
# dtype (`fm.cnt.dtype`) end to end.
BIG_THRESHOLD = (1 << 31) - (1 << 23)   # leave headroom for the diag bias
OFF_RATE_BIG = 4                        # sample every SA value % 16 == 0


class DeviceFm(NamedTuple):
    """Device-resident arrays of one FM direction (a JAX pytree)."""
    side: jax.Array      # [n_blocks+1, 8] uint32 fused sides (see above)
    cnt: jax.Array       # [4] int32 (uint32 in big mode) C-array
    sa: jax.Array        # [n] uint32 full SA (size-1 dummy in big mode)
    ftab_top: jax.Array  # [4^k] uint32
    ftab_bot: jax.Array  # [4^k] uint32
    n: jax.Array         # [] int32/uint32 number of rows (text length + 1)
    primary: jax.Array   # [] int32/uint32 row of the BWT hole ($, packed 0)
    # big mode only (size-0/1 dummies otherwise):
    mark: jax.Array      # [n_blocks+1, 4] uint32: [bits_lo, bits_hi, rank,
                         # pad] — mark bit b set iff SA[blk*64+b] % 2^r == 0;
                         # rank = #marked rows before the block
    sa_samp: jax.Array   # [n_marked] uint32: SA values of marked rows,
                         # in row order
    off_rate: int = 0    # static: 0 = full SA, else the sampling exponent

    @property
    def big(self) -> bool:
        return self.off_rate > 0


def to_device(d: FmDirection, device=None, big: bool | None = None,
              off_rate: int = OFF_RATE_BIG) -> DeviceFm:
    n = d.n  # rows
    if big is None:
        big = n >= BIG_THRESHOLD
    n_blocks = (n + DEV_OCC_BLOCK - 1) // DEV_OCC_BLOCK
    n_pad = (n_blocks + 1) * DEV_OCC_BLOCK
    codes = np.zeros(n_pad, np.uint8)
    codes[:n] = d.bwt
    hole = codes > 3          # the $ hole (and padding) packs as char 0
    codes[hole] = 0
    words = (codes.reshape(-1, 16).astype(np.uint32)
             << (2 * np.arange(16, dtype=np.uint32))
             ).sum(axis=1, dtype=np.uint64).astype(np.uint32)
    words = words.reshape(n_blocks + 1, 4)
    # checkpoint counts at block starts, from the byte BWT (hole uncounted);
    # chunked bincount keeps build memory O(chunk), not O(16n)
    per_block = np.zeros((n_blocks + 1, 4), np.uint64)
    CH = 1 << 24
    for lo in range(0, n_pad, CH):
        hi = min(lo + CH, n_pad)
        seg = np.minimum(codes[lo:hi], 3).astype(np.int64)
        vmask = np.zeros(hi - lo, bool)
        vn = min(hi, n) - lo
        if vn > 0:
            vmask[:vn] = d.bwt[lo : lo + vn] < 4
        blk_local = (np.arange(lo, hi) // DEV_OCC_BLOCK)
        key = (blk_local - lo // DEV_OCC_BLOCK) * 4 + seg
        cnts = np.bincount(key[vmask],
                           minlength=((hi - 1) // DEV_OCC_BLOCK
                                      - lo // DEV_OCC_BLOCK + 1) * 4)
        per_block[lo // DEV_OCC_BLOCK :
                  lo // DEV_OCC_BLOCK + len(cnts) // 4] += \
            cnts.reshape(-1, 4).astype(np.uint64)
    ckpt = np.zeros((n_blocks + 1, 4), np.uint32)
    ckpt[1:] = np.cumsum(per_block[:-1], axis=0).astype(np.uint32)
    side = np.zeros((n_blocks + 1, _SIDE_W), np.uint32)
    side[:, :4] = ckpt
    side[:, 4:8] = words
    put = lambda x: jax.device_put(x, device)
    rdt = np.uint32 if big else np.int32
    if not big:
        return DeviceFm(
            side=put(side),
            cnt=put(d.cnt[:4].astype(rdt)),
            sa=put(d.sa.astype(np.uint32)),
            ftab_top=put(d.ftab_top),
            ftab_bot=put(d.ftab_bot),
            n=put(rdt(n)),
            primary=put(rdt(d.primary)),
            mark=put(np.zeros((1, 4), np.uint32)),
            sa_samp=put(np.zeros(1, np.uint32)),
            off_rate=0,
        )
    # --- sampled-SA structures (big mode) ---
    sa = d.sa
    step = 1 << off_rate
    marked = (sa % step) == 0            # [n] bool, row order
    mark = np.zeros((n_blocks + 1, 4), np.uint32)
    mpad = np.zeros((n_blocks + 1) * DEV_OCC_BLOCK, bool)
    mpad[:n] = marked
    bits = mpad.reshape(-1, 2, 32)       # [blocks, lo/hi word, bit]
    w = (bits.astype(np.uint32) << np.arange(32, dtype=np.uint32)
         ).sum(axis=2, dtype=np.uint64).astype(np.uint32)
    mark[:, 0] = w[:, 0]
    mark[:, 1] = w[:, 1]
    per_blk = mpad.reshape(-1, DEV_OCC_BLOCK).sum(axis=1)
    mark[1:, 2] = np.cumsum(per_blk[:-1]).astype(np.uint32)
    mark[0, 2] = 0
    sa_samp = sa[marked].astype(np.uint32)
    return DeviceFm(
        side=put(side),
        cnt=put(d.cnt[:4].astype(rdt)),
        sa=put(np.zeros(1, np.uint32)),   # full SA not device-resident
        ftab_top=put(d.ftab_top),
        ftab_bot=put(d.ftab_bot),
        n=put(rdt(n)),
        primary=put(rdt(d.primary)),
        mark=put(mark),
        sa_samp=put(sa_samp),
        off_rate=off_rate,
    )


def _row_mask(rem):
    """[B, 4] uint32 masks selecting the first `rem` (< 64) bases of a
    side's 4 packed words. rem: [B] int32."""
    rem_w = jnp.clip(rem[:, None] - jnp.arange(4)[None, :] * 16, 0, 16)
    return jnp.where(
        rem_w >= 16, jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << (2 * rem_w).astype(jnp.uint32)) - jnp.uint32(1))


def occ_batch(fm: DeviceFm, c: jax.Array, rows: jax.Array) -> jax.Array:
    """Batched occ(c, row): #occurrences of c in bwt[0:row].

    c: [B] int32 in 0..3; rows: [B] row dtype -> [B] row dtype (int32, or
    uint32 in big mode — all row math single-dtype, see BIG_THRESHOLD note).
    One side gather.
    """
    rdt = fm.cnt.dtype
    blk = rows // DEV_OCC_BLOCK
    rem = (rows % DEV_OCC_BLOCK).astype(jnp.int32)
    side = fm.side[blk]                                        # [B, 8] u32
    cu = c.astype(jnp.uint32)[:, None]
    js = jnp.arange(4, dtype=jnp.uint32)[None, :]
    base = jnp.sum(jnp.where(js == cu, side[:, :4], jnp.uint32(0)),
                   axis=1).astype(rdt)
    words = side[:, 4:8]                                       # [B, 4]
    pat = cu * jnp.uint32(_PAIR_MASK)
    x = words ^ pat
    nonmatch = (x | (x >> 1)) & jnp.uint32(_PAIR_MASK)
    mask = _row_mask(rem)
    cnt_nonmatch = jnp.sum(
        jax.lax.population_count(nonmatch & mask).astype(jnp.int32), axis=1)
    in_block = rem - cnt_nonmatch
    # the $ hole is packed as char 0 but must not be counted
    corr = ((c == 0) & (fm.primary >= blk * DEV_OCC_BLOCK)
            & (fm.primary < rows)).astype(rdt)
    return base + in_block.astype(rdt) - corr


def occ_all4(fm: DeviceFm, rows: jax.Array) -> jax.Array:
    """occ(c, row) for ALL four characters from one side gather per row.

    rows: [B] -> [B, 4] in the row dtype. The per-character substitution
    search (1mm branching) needs all four counts at the same row; computing
    them from a single gathered side row quarters the gather traffic vs four
    occ_batch calls.
    """
    rdt = fm.cnt.dtype
    blk = rows // DEV_OCC_BLOCK
    rem = (rows % DEV_OCC_BLOCK).astype(jnp.int32)
    side = fm.side[blk]                                        # [B, 8] u32
    base = side[:, :4].astype(rdt)                             # [B, 4]
    words = side[:, 4:8]                                       # [B, 4]
    mask = _row_mask(rem)
    outs = []
    for c in range(4):
        pat = jnp.uint32(c * _PAIR_MASK)
        x = words ^ pat
        nonmatch = (x | (x >> 1)) & jnp.uint32(_PAIR_MASK)
        cnt_nonmatch = jnp.sum(
            jax.lax.population_count(nonmatch & mask).astype(jnp.int32),
            axis=1)
        outs.append(rem - cnt_nonmatch)
    in_block = jnp.stack(outs, axis=1).astype(rdt)             # [B, 4]
    corr = ((fm.primary >= blk * DEV_OCC_BLOCK)
            & (fm.primary < rows)).astype(rdt)
    # the $ hole is packed as char 0 but must not be counted
    return base + in_block - jnp.pad(corr[:, None], ((0, 0), (0, 3)))


def lf_all4(fm: DeviceFm, top: jax.Array, bot: jax.Array):
    """All-four-character LF step: (new_top, new_bot) each [B, 4].

    Empty/invalid input ranges must be masked by the caller."""
    B = top.shape[0]
    both = occ_all4(fm, jnp.concatenate([top, bot]))
    cnt = fm.cnt[None, :4]
    return cnt + both[:B], cnt + both[B:]


def lf_step(fm: DeviceFm, c: jax.Array, top: jax.Array, bot: jax.Array):
    """One batched backward-search step (top and bot occ queries fused into
    a single gather pass). Lanes with c > 3 (N) or an already empty range
    collapse to the empty range (0, 0)."""
    rdt = fm.cnt.dtype
    cc = jnp.minimum(c, 3).astype(jnp.int32)
    top = top.astype(rdt)
    bot = bot.astype(rdt)
    both = occ_batch(fm, jnp.concatenate([cc, cc]),
                     jnp.concatenate([top, bot]))
    B = top.shape[0]
    new_top = fm.cnt[cc] + both[:B]
    new_bot = fm.cnt[cc] + both[B:]
    bad = (c > 3) | (top >= bot)
    zero = jnp.zeros((), rdt)
    new_top = jnp.where(bad, zero, new_top)
    new_bot = jnp.where(bad, zero, new_bot)
    return new_top, new_bot


def resolve_rows_body(fm: DeviceFm, rows: jax.Array, valid: jax.Array,
                      off_rate: int):
    """Device walk-left SA resolution for sampled-SA (big) indexes
    (ref: bt2_idx.h:1607 walkLeft + :1612 getOffset): LF-step each row
    until it hits a marked row (SA value % 2^off_rate == 0 — the primary
    row, SA=0, is marked too, so the BWT hole never gets LF'd), then
    offset = sample[rank(row)] + steps. At most 2^off_rate - 1 steps.

    rows/valid: [B]; returns offsets [B] in the row dtype (garbage where
    ~valid — callers must mask).
    """
    rdt = fm.cnt.dtype
    B = rows.shape[0]
    n_samp = fm.sa_samp.shape[0]
    row0 = jnp.where(valid, rows, 0).astype(rdt)

    def step(_, carry):
        row, done, off, steps = carry
        blk = row // DEV_OCC_BLOCK
        rem = (row % DEV_OCC_BLOCK).astype(jnp.int32)
        mk = fm.mark[blk]                                      # [B, 4] u32
        sh = (rem % 32).astype(jnp.uint32)
        in_lo = rem < 32
        word = jnp.where(in_lo, mk[:, 0], mk[:, 1])
        marked = ((word >> sh) & jnp.uint32(1)) == 1
        below_mask = (jnp.uint32(1) << sh) - jnp.uint32(1)
        m_lo = jnp.where(in_lo, below_mask, jnp.uint32(0xFFFFFFFF))
        m_hi = jnp.where(in_lo, jnp.uint32(0), below_mask)
        rank = (mk[:, 2]
                + (jax.lax.population_count(mk[:, 0] & m_lo)
                   + jax.lax.population_count(mk[:, 1] & m_hi)
                   ).astype(jnp.uint32))
        newly = ~done & marked
        samp = fm.sa_samp[jnp.clip(rank, 0, n_samp - 1)].astype(rdt)
        off = jnp.where(newly, samp + steps, off)
        done = done | marked
        # LF for unfinished rows: char + occ from the same gathered side
        side = fm.side[blk]
        words = side[:, 4:8]
        widx = rem // 16
        wsel = jnp.sum(jnp.where(
            jnp.arange(4)[None, :] == widx[:, None], words,
            jnp.uint32(0)), axis=1)
        c = ((wsel >> (2 * (rem % 16)).astype(jnp.uint32))
             & jnp.uint32(3))                                   # [B] u32
        pat = c[:, None] * jnp.uint32(_PAIR_MASK)
        x = words ^ pat
        nonmatch = (x | (x >> 1)) & jnp.uint32(_PAIR_MASK)
        mask = _row_mask(rem)
        occ_c = rem - jnp.sum(
            jax.lax.population_count(nonmatch & mask).astype(jnp.int32),
            axis=1)
        csel = jnp.arange(4, dtype=jnp.uint32)[None, :] == c[:, None]
        base_c = jnp.sum(jnp.where(csel, side[:, :4], jnp.uint32(0)),
                         axis=1).astype(rdt)
        cnt_c = jnp.sum(jnp.where(csel, fm.cnt[None, :], jnp.zeros((), rdt)),
                        axis=1)
        corr = ((c == 0) & (fm.primary >= blk * DEV_OCC_BLOCK)
                & (fm.primary < row)).astype(rdt)
        nrow = cnt_c + base_c + occ_c.astype(rdt) - corr
        row = jnp.where(done, row, nrow)
        steps = steps + (~done).astype(rdt)
        return row, done, off, steps

    init = (row0, ~valid, jnp.zeros(B, rdt), jnp.zeros(B, rdt))
    _, _, off, _ = jax.lax.fori_loop(0, 1 << off_rate, step, init)
    return off


def _pow2_pad(n: int, lo: int = 256) -> int:
    """Round n up to a power of two (>= lo) — bounds the number of distinct
    compiled shapes: each new shape costs a fresh XLA compile."""
    return max(lo, 1 << max(0, int(n - 1).bit_length()))


def backward_search(fm: DeviceFm, patterns, lengths, use_ftab: bool = True):
    """Batched exact backward search (right-to-left over each pattern).

    patterns: [B, L] uint8 codes (0..3, >3 = N), left-aligned
    lengths:  [B] int32 actual lengths (<= L)
    -> (top, bot): [B] numpy int32; empty hit = (0, 0).

    With `use_ftab`, the search jumps over the rightmost FTAB_CHARS characters
    via the k-mer table (ref: bt2_idx.h ftabLoHi), then LF-steps the rest.
    The batch dimension is padded to a power of two (shape bucketing).
    """
    B0 = patterns.shape[0]
    Bp = _pow2_pad(B0)
    if Bp != B0:
        pat_p = np.zeros((Bp, patterns.shape[1]), np.uint8)
        pat_p[:B0] = patterns
        len_p = np.zeros(Bp, np.int32)
        len_p[:B0] = lengths
        patterns, lengths = pat_p, len_p
    top, bot = _backward_search_impl(fm, jnp.asarray(patterns),
                                     jnp.asarray(lengths), use_ftab)
    return np.asarray(top)[:B0], np.asarray(bot)[:B0]


def backward_search_body(fm: DeviceFm, patterns: jax.Array,
                         lengths: jax.Array, use_ftab: bool = True):
    """Traceable body of the batched exact backward search (also called
    inline from the fused candidate pipeline, align/candgen.py)."""
    B, L = patterns.shape
    k = FTAB_CHARS

    pat = jnp.asarray(patterns).astype(jnp.int32)
    lengths = jnp.asarray(lengths).astype(jnp.int32)
    idx_last = lengths - 1  # position of last char

    def gather_char(step):
        # step counts from the right: step=0 -> last char
        pos = idx_last - step
        safe = jnp.clip(pos, 0, L - 1)
        c = pat[jnp.arange(B), safe]
        return jnp.where(pos >= 0, c, -1)  # -1 marks "past start" (done)

    if use_ftab:
        # Pack rightmost k chars big-endian in text order: chars at
        # positions len-k .. len-1.
        key = jnp.zeros(B, dtype=jnp.int32)
        valid = lengths >= k
        for i in range(k):
            c = gather_char(k - 1 - i)  # text order: leftmost of the k first
            key = key * 4 + jnp.maximum(c, 0)
            valid = valid & (c >= 0) & (c <= 3)
        key = jnp.clip(key, 0, 4 ** k - 1)
        rdt = fm.cnt.dtype
        top0 = jnp.where(valid, fm.ftab_top[key].astype(rdt),
                         jnp.zeros((), rdt))
        bot0 = jnp.where(valid, fm.ftab_bot[key].astype(rdt), fm.n)
        # Lanes that can't use ftab (short/N in last k chars) start from the
        # whole range and will LF through all chars.
        start_step = jnp.where(valid, k, 0)
    else:
        top0 = jnp.zeros(B, dtype=fm.cnt.dtype)
        bot0 = jnp.broadcast_to(fm.n, (B,))
        start_step = jnp.zeros(B, dtype=jnp.int32)

    def body(step, carry):
        top, bot = carry
        c = gather_char(step)
        active = (step >= start_step) & (c >= 0)
        cc = jnp.where(c < 0, 4, c).astype(jnp.int32)  # c=4 -> empty in lf_step
        nt, nb = lf_step(fm, cc, top, bot)
        top = jnp.where(active, nt, top)
        bot = jnp.where(active, nb, bot)
        return top, bot

    top, bot = jax.lax.fori_loop(0, L, body, (top0, bot0))
    # normalize empties
    empty = top >= bot
    zero = jnp.zeros((), top.dtype)
    return jnp.where(empty, zero, top), jnp.where(empty, zero, bot)


_backward_search_impl = jax.jit(backward_search_body,
                                static_argnames=("use_ftab",))


def sa_resolve(fm: DeviceFm, top, count, max_elts: int):
    """Gather up to max_elts SA entries per range: offsets[b, i] = SA[top[b]+i]
    for i < count[b]; invalid slots = -1. Replaces lazy group-walk resolution
    (ref: group_walk.h GWState::advance) with one gather. Batch dim padded to
    a power of two."""
    top = np.asarray(top, np.int32)
    count = np.asarray(count, np.int32)
    B0 = top.shape[0]
    Bp = _pow2_pad(B0)
    if Bp != B0:
        top = np.concatenate([top, np.zeros(Bp - B0, np.int32)])
        count = np.concatenate([count, np.zeros(Bp - B0, np.int32)])
    out = _sa_resolve_impl(fm, jnp.asarray(top), jnp.asarray(count), max_elts)
    return np.asarray(out)[:B0]


@functools.partial(jax.jit, static_argnames=("max_elts",))
def _sa_resolve_impl(fm: DeviceFm, top, count, max_elts: int):
    i = jnp.arange(max_elts, dtype=jnp.int32)[None, :]
    rows = top[:, None] + i
    valid = i < count[:, None]
    offs = fm.sa[jnp.clip(rows, 0, fm.sa.shape[0] - 1)].astype(jnp.int32)
    return jnp.where(valid, offs, -1)


def backward_search_record(fm: DeviceFm, patterns, lengths):
    """Like backward_search, but records the range after every step.

    Returns (tops, bots): [B, L+1] numpy int32 where entry s holds the range
    after matching the length-s suffix of the pattern (s=0 -> the full row
    range). Used by the 1-mismatch search to seed substitution branches
    (ref: aligner_seed.cpp:973 oneMmSearch matches one half exactly first).
    """
    B0 = patterns.shape[0]
    Bp = _pow2_pad(B0)
    if Bp != B0:
        pat_p = np.zeros((Bp, patterns.shape[1]), np.uint8)
        pat_p[:B0] = patterns
        len_p = np.zeros(Bp, np.int32)
        len_p[:B0] = lengths
        patterns, lengths = pat_p, len_p
    tops, bots = _backward_search_record_impl(
        fm, jnp.asarray(patterns), jnp.asarray(lengths))
    return np.asarray(tops)[:B0], np.asarray(bots)[:B0]


def backward_search_record_body(fm: DeviceFm, patterns, lengths):
    """Traceable body (reused by align/candgen.py)."""
    lengths = lengths.astype(jnp.int32)
    B, L = patterns.shape
    pat = patterns.astype(jnp.int32)
    idx_last = lengths - 1

    def body(step, carry):
        top, bot, tops, bots = carry
        pos = idx_last - step
        safe = jnp.clip(pos, 0, L - 1)
        c = pat[jnp.arange(B), safe]
        cc = jnp.where(pos < 0, 4, c)
        nt, nb = lf_step(fm, cc, top, bot)
        active = pos >= 0
        top = jnp.where(active, nt, top)
        bot = jnp.where(active, nb, bot)
        tops = tops.at[:, step + 1].set(top)
        bots = bots.at[:, step + 1].set(bot)
        return top, bot, tops, bots

    rdt = fm.cnt.dtype
    top0 = jnp.zeros(B, rdt)
    bot0 = jnp.broadcast_to(fm.n, (B,))
    tops = jnp.zeros((B, L + 1), rdt).at[:, 0].set(top0)
    bots = jnp.zeros((B, L + 1), rdt).at[:, 0].set(bot0)
    _, _, tops, bots = jax.lax.fori_loop(0, L, body, (top0, bot0, tops, bots))
    return tops, bots


_backward_search_record_impl = jax.jit(backward_search_record_body)


@jax.jit
def _lf_step_flat(fm: DeviceFm, c, top, bot):
    return lf_step(fm, c, top, bot)


def lf_step_padded(fm: DeviceFm, c, top, bot):
    """Host-friendly lf_step with power-of-two padding (dead lanes stay
    empty), so host-compaction loops don't trigger a compile per shape."""
    n0 = len(c)
    n = _pow2_pad(n0, lo=1024)
    if n != n0:
        c = np.concatenate([c, np.full(n - n0, 4, c.dtype)])
        top = np.concatenate([top, np.zeros(n - n0, top.dtype)])
        bot = np.concatenate([bot, np.zeros(n - n0, bot.dtype)])
    t, b = _lf_step_flat(fm, jnp.asarray(c, jnp.int32),
                         jnp.asarray(top, jnp.int32),
                         jnp.asarray(bot, jnp.int32))
    return np.asarray(t)[:n0], np.asarray(b)[:n0]



# ---------------------------------------------------------------------------
# 1-mismatch search (ref: aligner_seed.cpp:973 oneMmSearch): one half of the
# read is matched exactly (recorded backward pass), then every substitution
# branch is tried. Device-side end to end: branch-grid construction,
# substitution step, fixed-size compaction (jnp.nonzero with static size),
# and a single continuation loop, so the whole search makes only O(1)
# host round-trips.
# ---------------------------------------------------------------------------


def one_mm_phase0_body(fm: DeviceFm, pat, lens, hi, tops, bots,
                       w0: int, cw: int, k1: int):
    """Substitution step for branch positions [w0, w0+cw) of every pattern,
    compacted to at most k1 surviving branches.

    pat: [B, L] int8; lens/hi: [B] int32; tops/bots: [B, L+1] int32.
    Returns (cb, cm, pos, top, bot) each [k1] + count (pre-compaction)."""
    B, L = pat.shape
    p = w0 + jax.lax.broadcasted_iota(jnp.int32, (B, cw), 1)
    b = jax.lax.broadcasted_iota(jnp.int32, (B, cw), 0)
    valid = (p < hi[:, None]) & (p < lens[:, None])
    s = jnp.clip(lens[:, None] - 1 - p, 0, L)
    t0 = tops[b, s]
    b0 = bots[b, s]
    valid &= t0 < b0
    orig = pat[b, jnp.clip(p, 0, L - 1)].astype(jnp.int32)
    # expand to 4 substitution chars
    x = jax.lax.broadcasted_iota(jnp.int32, (B, cw, 4), 2)
    ok = valid[:, :, None] & (x != orig[:, :, None])
    flat = lambda a: a.reshape(-1)
    xs = flat(x)
    cbs = flat(jnp.broadcast_to(b[:, :, None], (B, cw, 4)))
    ps = flat(jnp.broadcast_to(p[:, :, None], (B, cw, 4)))
    okf = flat(ok)
    t0f = flat(jnp.broadcast_to(t0[:, :, None], (B, cw, 4)))
    b0f = flat(jnp.broadcast_to(b0[:, :, None], (B, cw, 4)))
    zt = jnp.zeros((), t0f.dtype)
    t0f = jnp.where(okf, t0f, zt)
    b0f = jnp.where(okf, b0f, zt)
    nt, nb = lf_step(fm, xs, t0f, b0f)
    alive = nt < nb
    count = jnp.sum(alive.astype(jnp.int32))
    idx = jnp.nonzero(alive, size=k1, fill_value=len(xs))[0]
    safe = jnp.clip(idx, 0, len(xs) - 1)
    pad = idx >= len(xs)
    zr = jnp.zeros((), nt.dtype)
    return (jnp.where(pad, -1, cbs[safe]),
            jnp.where(pad, -1, ps[safe]),
            jnp.where(pad, -1, ps[safe] - 1),
            jnp.where(pad, zr, nt[safe]),
            jnp.where(pad, zr, nb[safe]),
            count)


_one_mm_phase0 = jax.jit(one_mm_phase0_body,
                         static_argnames=("w0", "cw", "k1"))


def one_mm_phase1_body(fm: DeviceFm, pat, cb, pos, top, bot,
                       n_steps: int):
    """Continue all branches backward to pattern position 0 (masked fori)."""
    def body(_, carry):
        pos_, top_, bot_ = carry
        act = (pos_ >= 0) & (top_ < bot_)
        safe = jnp.clip(pos_, 0, pat.shape[1] - 1)
        c = pat[jnp.clip(cb, 0, pat.shape[0] - 1), safe].astype(jnp.int32)
        nt, nb = lf_step(fm, c, top_, bot_)
        top_ = jnp.where(act, nt, top_)
        bot_ = jnp.where(act, nb, bot_)
        pos_ = jnp.where(act, pos_ - 1, pos_)
        return pos_, top_, bot_
    pos, top, bot = jax.lax.fori_loop(0, n_steps, body, (pos, top, bot))
    return pos, top, bot


_one_mm_phase1 = jax.jit(one_mm_phase1_body, static_argnames=("n_steps",))


@jax.jit
def _exact_from_record(tops, bots, lengths):
    """Full-pattern range from a recorded pass: entry s = lengths[b]."""
    B = tops.shape[0]
    b = jnp.arange(B)
    s = jnp.clip(lengths, 0, tops.shape[1] - 1)
    return jnp.stack([tops[b, s], bots[b, s]])


def one_mm_branch_hits(fm: DeviceFm, patterns, lengths, branch_lo, branch_hi,
                       max_grid: int = 1 << 22, want_exact: bool = False):
    """Find occurrences of each pattern with EXACTLY one substitution at a
    position p in [branch_lo[b], branch_hi[b]) — branch_lo must be 0 in the
    current implementation (both reference cases use 0).

    Returns numpy arrays (read_idx, mm_pos, top, bot) of full 1mm matches;
    with want_exact also returns (exact_top, exact_bot) [B] — the full
    exact-match ranges, free by-products of the recorded backward pass
    (subsumes a separate exactSweep call).
    """
    patterns = np.asarray(patterns)
    lengths = np.asarray(lengths, np.int32)
    B, L = patterns.shape
    hi = np.minimum(np.asarray(branch_hi, np.int32), lengths)
    maxw = int(hi.max(initial=0))
    empty = (np.zeros(0, np.int64),) * 4

    Bp = _pow2_pad(B)
    pat_p = np.zeros((Bp, L), np.int8)
    pat_p[:B] = patterns.astype(np.int8)
    len_p = np.zeros(Bp, np.int32)
    len_p[:B] = lengths
    hi_p = np.zeros(Bp, np.int32)
    hi_p[:B] = hi
    pat_dev = jnp.asarray(pat_p)
    len_dev = jnp.asarray(len_p)
    hi_dev = jnp.asarray(hi_p)
    tops, bots = _backward_search_record_impl(fm, pat_dev, len_dev)

    exact = None
    if want_exact:
        ex = np.asarray(_exact_from_record(tops, bots, len_dev))
        et, eb = ex[0, :B].copy(), ex[1, :B].copy()
        bad = et >= eb
        et[bad] = 0
        eb[bad] = 0
        exact = (et, eb)

    if maxw == 0:
        return (empty, exact) if want_exact else empty

    cw = max(1, min(_pow2_pad(maxw, lo=8), max_grid // (Bp * 4)))
    k1 = _pow2_pad(2 * Bp, lo=4096)
    n_steps = _pow2_pad(maxw, lo=32)
    out = [[], [], [], []]
    w0 = 0
    while w0 < maxw:
        res = _one_mm_phase0(fm, pat_dev, len_dev, hi_dev, tops, bots,
                             w0, cw, k1)
        cb, cm, pos, top, bot, count = res
        posf, topf, botf = _one_mm_phase1(fm, pat_dev, cb, pos, top, bot,
                                          n_steps)
        arr = np.asarray(jnp.stack(
            [posf, topf.astype(jnp.int32), botf.astype(jnp.int32), cb, cm,
             jnp.broadcast_to(count, (k1,))]))
        pos_h, top_h, bot_h, cb_h, cm_h = arr[0], arr[1], arr[2], arr[3], arr[4]
        count_h = int(arr[5, 0])
        if count_h > k1:
            # compaction capacity exceeded (highly repetitive genome):
            # narrow the position window, then grow the capacity — never
            # drop survivors (ref: the reference degrades gracefully on
            # huge SA ranges via RowSampler, aligner_sw_driver.h:179)
            if cw > 1:
                cw = max(1, cw // 2)
            else:
                k1 *= 2
            continue
        good = (cb_h >= 0) & (cb_h < B) & (pos_h < 0) & (top_h < bot_h)
        out[0].append(cb_h[good].astype(np.int64))
        out[1].append(cm_h[good].astype(np.int64))
        out[2].append(top_h[good].astype(np.int64))
        out[3].append(bot_h[good].astype(np.int64))
        w0 += cw
    hits = (tuple(np.concatenate(o) for o in out) if out[0] else empty)
    return (hits, exact) if want_exact else hits
