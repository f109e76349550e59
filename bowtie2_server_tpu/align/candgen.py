"""Device-resident candidate generation + DP + selection — the hot path.

The round-1 pipeline ran each stage as a separate device call and did
candidate bookkeeping (dedup sets, window assembly, per-read selection) in
Python. This module fuses the whole per-batch search into ONE jitted
program (ref: the reference's whole hot loop, bt2_search.cpp:3050-4197
multiseedSearchWorker + aligner_sw_driver.cpp:756 SwDriver::extendSeeds):

  1. recorded backward pass of both strands through the fw FM index
     (ref: aligner_seed.cpp:854 exactSweep) -> exact ranges + per-suffix
     ranges that seed the substitution branches
  2. 1-substitution branch search (ref: aligner_seed.cpp:973 oneMmSearch)
  3. seed rounds (ref: bt2_search.cpp:3824-4089, seedBoostThresh gating)
  4. SA/position resolution of every surviving range — one gather
     (ref: group_walk.h, redesigned away)
  5. candidate dedup on (lane, diagonal) via a 2-key lexicographic sort
     (ref: SwDriver seenDiags, aligner_sw_driver.h:300)
  6. banded affine-gap DP over every interior candidate (ops/sw_banded.py)
  7. per-read best + second-best-distinct-end selection via segment maxes
     (ref: AlnSinkWrap best/secbest bookkeeping, aln_sink.h)

Everything is fixed-shape: branch/element/candidate sets are compacted to
static capacities with overflow counters; the host falls back to the
general (slower, unbounded) path when a counter trips.

The search is written to keep chained (data-dependent) gathers few: each
LF step of an FM walk is one round of dependent gathers over every lane.
The pipeline therefore has two statically-selected shapes:

* the fast shape (every read has enough seeds that any single-position
  mismatch leaves at least one seed intact — nseeds >= ceil(Ls/ival)+1):
  ONE un-recorded FM pass (fw index, both strands, static-column char
  reads from a dual left/right-aligned upload) for the exact ranges; NO
  substitution-branch stage at all — a 1-substitution alignment leaves at
  least one instantiated seed intact, so its diagonal is produced by the
  seed lookup and verified by the DP stage; seed search via the sorted
  k-mer position table (index/kmer.py) instead of per-seed LF chains —
  rolling keys are computed arithmetically (no gathers) and resolved by
  fixed-trip binary search. The mirror-index pass disappears entirely.

* the short-read shape (`cfg.has_short`): the general bidirectional
  machinery — mirror-index recorded pass, both-half substitution branches
  with a continuation loop, FM seed search with per-read truncated seeds.

Transfers per batch are few and packed: ONE packed uint8 upload per
batch carries bases and qualities in both alignments (byte = code<<6 |
min(qual,63); 255 = pad/N), ONE small int32 array carries per-read
metadata (the seed schedule is recomputed on device with exact integer
semantics), and ONE packed int32 download carries candidates, per-read
selections, and overflow counters.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index import kmer as kmod
from ..ops import fm as dfm
from ..ops.sw import NEG_INF, SwConfig
from ..ops.sw_banded import _banded_tile_xla


def _pow2(n: int, lo: int = 1) -> int:
    return max(lo, 1 << max(0, int(n - 1).bit_length()))


class CandGenCfg(NamedTuple):
    """Static (hashable) shape/config parameters of one compiled pipeline."""
    B: int            # reads per batch (padded, per shard)
    L: int            # padded read length
    S: int            # max seeds per strand per round
    R: int            # seed rounds (statically unrolled)
    E: int            # max SA elements resolved per range
    seed_len: int
    K: int            # DP band width
    k1: int           # 1mm surviving-branch capacity per chunk
    chunk_w: int      # 1mm branch positions per chunk (short shape)
    n_chunks: int
    NH: int           # hit-range capacity (level-1 compaction)
    C_pre: int        # resolved-element capacity (pre-dedup)
    C_max: int        # unique-candidate capacity
    sw: SwConfig
    engine: str       # 'xla'; debug: 'nodp', 'cut_*' (scripts/profile_cuts.py)
    has_short: bool = False   # general bidirectional shape (see module doc)
    kmer_mode: str = "sorted"  # 'cuckoo' (2 independent row gathers) or
                               # 'sorted' (binary-search fallback)
    kmer_steps: int = 1       # binary-search trip count of the seed table
    n_hi: int = 16            # key split of the seed table
    n_lo: int = 6
    bbits: int = 20
    tbits: int = 0            # cuckoo bucket bits
    salt: int = 0             # cuckoo hash salt
    RS: int = 0               # reseed-round lane-compaction capacity:
                              # rounds >= 1 run for <1% of reads, so their
                              # lookup lanes are compacted to RS before the
                              # (gather-costly) table probes; 0 = off
    boost_thresh: int = 300  # ref: bt2_search.cpp:4086 seedBoostThresh
    mmtab_t: tuple = ()      # static mm-penalty-by-quality table
    sched: tuple | None = None  # static per-round seed offsets (uniform
                                # batches); None = per-read device schedule
    static_len: int = 0         # the uniform read length when sched is set
    raw_len: int = 0            # >0: packed2 is raw [2, B, raw_len]
                                # (seqs, quals); encode/align on device
    big: bool = False           # big-index mode: uint32 rows + sampled-SA
                                # walk-left resolve + biased diagonals
                                # (ref: the -l / .bt2l build line,
                                # btypes.h TIndexOffU, Makefile:239-246)
    off_rate: int = 0           # SA sampling exponent when big
    seed_mms: int = 0           # -N: in-seed substitutions, fused via the
                                # general shape's per-seed branch search
                                # (ref: aligner_seed.cpp:668 searchSeedBi)
    no_exact_up: bool = False   # --no-exact-upfront (ref: doExactUpFront,
                                # bt2_search.cpp:3454)
    no_1mm_up: bool = False     # --no-1mm-upfront (ref: do1mmUpFront,
                                # bt2_search.cpp:3634)
    pack5: bool = False         # compact 5-row output layout (fewer
                                # result bytes to download): rows
                                # [r0 flags|read|nm|ung, diag,
                                #  score16|bibk16, best_pack, secmult+ctrs]
                                # of width C_max+128, vs the full 7 x C_max
                                # layout. Conditions: L<=256, K<=256,
                                # ndev*B <= 2^18 (see dispatch)


class DeviceIndex(NamedTuple):
    """Device-resident index arrays shared by all batches (a pytree)."""
    fw: dfm.DeviceFm
    mirror: dfm.DeviceFm
    joined: jax.Array        # [n] uint8 packed unambiguous text
    joined_words: jax.Array  # [rows, 8] uint32 — 128 bases / 32 B per row
    run_starts: jax.Array    # [R] int32 unambiguous-run joined starts
    run_ends: jax.Array      # [R] int32 run joined ends


def _pack_joined_words(joined: np.ndarray) -> np.ndarray:
    """2-bit pack into uint32 words (16 bases/word, LE), then reshape to
    [rows, 8]: one row = 128 bases = 32 bytes, the unit of the window
    gathers (one gather index per row instead of one per word)."""
    n = len(joined)
    nrows = (n + 127) // 128 + 3   # +3 pad rows: stage-6 window overhang
    pad = np.zeros(nrows * 128, np.uint32)
    pad[:n] = joined
    words = (pad.reshape(-1, 16) << (2 * np.arange(16, dtype=np.uint32))
             ).sum(axis=1, dtype=np.uint64).astype(np.uint32)
    return words.reshape(-1, 8)


def make_device_index(idx, device=None, big: bool | None = None
                      ) -> DeviceIndex:
    put = lambda x: jax.device_put(x, device)
    if big is None:
        big = idx.n >= dfm.BIG_THRESHOLD
    rdt = np.uint32 if big else np.int32
    run_starts = idx.run_joined_start.astype(rdt)
    run_ends = np.append(idx.run_joined_start[1:], idx.n).astype(rdt)
    return DeviceIndex(
        fw=dfm.to_device(idx.fw, device, big=big),
        mirror=dfm.to_device(idx.mirror, device, big=big),
        joined=put(idx.joined),
        joined_words=put(_pack_joined_words(idx.joined)),
        run_starts=put(run_starts),
        run_ends=put(run_ends),
    )


# ------------------------------------------------------------ device utils -

def _rc_rows(seqs, lens):
    """[B, L] reverse-complement each row within its length (pad 5)."""
    B, L = seqs.shape
    j = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = lens[:, None] - 1 - j
    ok = src >= 0
    g = jnp.take_along_axis(seqs, jnp.clip(src, 0, L - 1).astype(jnp.int32),
                            axis=1)
    comp = jnp.where(g <= 3, 3 - g, g)
    return jnp.where(ok, comp, 5).astype(seqs.dtype)


def _rev_rows(a, lens, fill):
    """[B, L] plain per-row reversal within length."""
    B, L = a.shape
    j = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = lens[:, None] - 1 - j
    ok = src >= 0
    g = jnp.take_along_axis(a, jnp.clip(src, 0, L - 1).astype(jnp.int32),
                            axis=1)
    return jnp.where(ok, g, fill).astype(a.dtype)


def _seg_max(data, ids, B):
    # empty segments fill with the dtype's max-identity (INT32_MIN)
    return jax.ops.segment_max(data, ids, num_segments=B)


def _static_table(table: tuple, idx, dtype=jnp.int32):
    """Table lookup with COMPILE-TIME-constant values: a run of wheres over
    the table's change points instead of a [B, L] per-element gather;
    elementwise selects fuse with their neighbours. Most penalty tables
    are piecewise constant with <= 5 distinct values, so this emits only a
    handful of selects."""
    out = jnp.full(idx.shape, int(table[0]), dtype)
    for q in range(1, len(table)):
        if table[q] != table[q - 1]:
            out = jnp.where(idx >= q, jnp.array(int(table[q]), dtype), out)
    return out


def _rolling_keys(codes4, n_pack: int, shift0: int, reverse: bool):
    """Rolling 2-bit packed keys over [B, L] code rows (VPU only, no
    gathers). Forward: key[j] packs codes[j+shift0 .. j+shift0+n_pack).
    Reverse: key[j] packs codes[j-shift0], codes[j-shift0-1], ... (used for
    reverse-complement windows indexed by their last fw position)."""
    B, L = codes4.shape
    acc = jnp.zeros((B, L), jnp.uint32)
    if not reverse:
        pad = jnp.pad(codes4, ((0, 0), (0, shift0 + n_pack)))
        for t in range(shift0, shift0 + n_pack):
            acc = (acc << 2) | pad[:, t : t + L]
    else:
        m = shift0 + n_pack
        pad = jnp.pad(codes4, ((0, 0), (m, 0)))
        for t in range(shift0, shift0 + n_pack):
            acc = (acc << 2) | pad[:, m - t : m - t + L]
    return acc


# meta word 0 bit layout
_LEN_BITS = 20
_F_ACT_FW = 1 << 20
_F_ACT_RC = 1 << 21
_F_SEED_R0 = 1 << 22
_F_EXACT_ONLY = 1 << 23   # report only perfect-score hits (seed_skip reads)


# ------------------------------------------------------------- fused kernel -

@functools.partial(jax.jit, static_argnames=("cfg",))
def fused_pipeline(didx: DeviceIndex, dkm: kmod.DeviceKmer, cfg: CandGenCfg,
                   packed2, meta, mmtab):
    """One whole search batch on device.

    packed2: [2, B, L] uint8 — byte 255 = pad/N, else code<<6|min(qual,63);
             slot 0 left-aligned, slot 1 right-aligned
    meta:    [B, 5] int32 — [len|flag bits, minsc, seed interval, nrounds,
             perfect score]
    mmtab:   [64] int32 — mismatch penalty per (clamped) quality

    Returns out_pack [6, C_max] int32:
      row 0: (read << 4) | (fw << 2) | (interior << 1) | valid
      row 1: diag
      row 2: interior DP score (NEG_INF otherwise)
      row 3: (bi << 8) | bk
      row 4: [ (best_ci+1)<<2|has_rect<<1|seeds_failed : B
             | sec_score : B ]
      row 5: [ exact_mult : B | ...pad... | counters : last 8 ]
      row 6: ungapped<<16 | nm (center-diagonal stats per candidate)
    """
    B, L, E = cfg.B, cfg.L, cfg.E
    # joined TEXT length (the BWT has one more row than the text)
    n_text = didx.joined.shape[0]
    # Big-index mode: every row/offset value is uint32 and diagonals carry
    # a static +BIAS so they stay non-negative (diag = off - depth can be
    # slightly negative; JAX truncates mixed int32/uint32 ops with x64
    # off, so the whole diagonal pipeline stays in one unsigned dtype).
    rdt = jnp.uint32 if cfg.big else jnp.int32
    BIAS = (cfg.L + cfg.K) if cfg.big else 0
    BIAS_u = jnp.asarray(BIAS, rdt)

    if cfg.engine == "cut_upload":   # H2D + trivial reduce only
        return jnp.broadcast_to(
            packed2.astype(jnp.int32).sum() + meta.sum(), ((5, cfg.C_max + 128) if cfg.pack5 else (7, cfg.C_max)))

    # ---- unpack the transfer-packed batch ----
    m0 = meta[:, 0]
    lens = (m0 & ((1 << _LEN_BITS) - 1)).astype(jnp.int32)
    act_fw = (m0 & _F_ACT_FW) > 0
    act_rc = (m0 & _F_ACT_RC) > 0
    seed_r0_active = (m0 & _F_SEED_R0) > 0
    ex_only = (m0 & _F_EXACT_ONLY) > 0
    minsc = meta[:, 1]
    interval = jnp.maximum(meta[:, 2], 1)
    nrounds = jnp.maximum(meta[:, 3], 1)
    perfect = meta[:, 4]

    if cfg.raw_len:
        # uniform-length batches upload ONE encoded byte per base
        # (code<<6 | qual6, 255 = N) — half the H2D bytes of the dual
        # left/right-aligned layout; the right-aligned copy is pure
        # layout work here (device)
        enc = packed2[0]                           # [B, raw_len] u8
        la = jnp.pad(enc, ((0, 0), (0, L - cfg.raw_len)),
                     constant_values=255)
        ra = jnp.pad(enc, ((0, 0), (L - cfg.raw_len, 0)),
                     constant_values=255)
    else:
        la, ra = packed2[0], packed2[1]
    is_n = la == 255
    fw_seqs = jnp.where(is_n, jnp.uint8(5), la >> 6).astype(jnp.uint8)
    qual6 = jnp.where(is_n, jnp.uint8(0), la & 63).astype(jnp.int32)
    mm_fw = _static_table(cfg.mmtab_t, qual6, jnp.uint8)
    ra_codes = jnp.where(ra == 255, jnp.uint8(5), ra >> 6).astype(jnp.int32)
    la_codes = fw_seqs.astype(jnp.int32)
    comp_la = jnp.where(la_codes <= 3, 3 - la_codes, la_codes)
    comp_ra = jnp.where(ra_codes <= 3, 3 - ra_codes, ra_codes)

    # ---- device-side seed schedule (exact integer port of
    # UnpairedAligner.seed_offsets; ref: bt2_search.cpp:3848-3870,
    # aligner_seed.cpp:523-529). With a batch-uniform schedule
    # (cfg.sched), the per-read arrays are skipped entirely and seed
    # columns become static below. ----
    S, Ls = cfg.S, cfg.seed_len
    if cfg.sched is None:
        s_i = jnp.arange(S, dtype=jnp.int32)[None, :]
        seed_start_l, seed_valid_l = [], []
        for r in range(cfg.R):
            ok = (interval > r) & (r < nrounds)
            off = (interval * r) // nrounds
            ok &= ~((off > 0) & (Ls + off > lens))
            nseeds = jnp.where(
                ok, 1 + jnp.where(lens - off > Ls,
                                  (lens - off - Ls) // interval, 0), 0)
            seed_start_l.append(off[:, None] + s_i * interval[:, None])
            seed_valid_l.append(s_i < nseeds[:, None])
        seed_start = jnp.stack(seed_start_l, axis=1)   # [B, R, S]
        seed_valid = jnp.stack(seed_valid_l, axis=1)

    # the right-aligned upload makes reversal a flip: ra[j] = fw[j-(L-len)]
    # so flip(ra)[j] = fw[len-1-j] — no per-element gathers (ref: the role
    # of Read::patRc, read.h, materialized here by layout instead)
    rc_seqs = jnp.flip(comp_ra, axis=1).astype(jnp.uint8)
    mm_ra = jnp.where(ra == 255, jnp.uint8(0),
                      _static_table(cfg.mmtab_t,
                                    (ra & 63).astype(jnp.int32), jnp.uint8))
    mm_rc = jnp.flip(mm_ra, axis=1)
    both = jnp.concatenate([fw_seqs, rc_seqs])          # [2B, L] lane order
    mm_both = jnp.concatenate([mm_fw, mm_rc])
    lens2 = jnp.concatenate([lens, lens])
    act2 = jnp.concatenate([act_fw, act_rc])
    half2 = lens2 // 2

    # ---- stage 1: recorded backward pass, both strands on the fw index ----
    # GENERAL SHAPE ONLY. Static-column character reads: the fw strand
    # steps right-to-left over the right-aligned layout; the rc strand's
    # char rc[len-1-s] equals comp(fw[s]), a left-aligned static column
    # (ref: exactSweep's fw/rc interleaving for prefetch overlap,
    # aligner_seed.cpp:854-933).
    #
    # In the FAST shape the whole L-step LF chain is dropped (it was the
    # dominant device cost: L sequential gather-latency-bound steps). A
    # full-read exact match puts every instantiated seed on its diagonal,
    # so the k-mer seed lookup of stage 3 necessarily produces that
    # diagonal and the banded DP of stage 6 scores it `perfect` — exact
    # hits and their multiplicity (ref: exactSweep's nelt,
    # bt2_search.cpp:3461) are recovered from the DP scores in stage 7.
    # The only information loss is a seed range clipped at E elements
    # possibly hiding extra exact copies; those reads get the
    # conservative exact_mult = E+1 escape below.
    # range sources: (lane, depth, top, cnt, src) with src 0=fw SA,
    # 1=mirror SA, 2=seed position table
    r_lane, r_depth, r_top, r_cnt, r_src = [], [], [], [], []
    if cfg.has_short:
        def rec_body(step, carry):
            top, bot = carry[0], carry[1]
            c_f = jax.lax.dynamic_slice_in_dim(
                ra_codes, L - 1 - step, 1, 1)[:, 0]
            c_r = jax.lax.dynamic_slice_in_dim(comp_la, step, 1, 1)[:, 0]
            c = jnp.concatenate([c_f, c_r])
            nt, nb = dfm.lf_step(didx.fw, c, top, bot)
            active = step < lens2
            top = jnp.where(active, nt, top)
            bot = jnp.where(active, nb, bot)
            tops = jax.lax.dynamic_update_index_in_dim(
                carry[2], top, step + 1, 1)
            bots = jax.lax.dynamic_update_index_in_dim(
                carry[3], bot, step + 1, 1)
            return top, bot, tops, bots

        top0 = jnp.zeros(2 * B, rdt)
        bot0 = jnp.broadcast_to(didx.fw.n, (2 * B,))
        lane_i = jnp.arange(2 * B)
        tops = jnp.zeros((2 * B, L + 1), rdt).at[:, 0].set(top0)
        bots = jnp.zeros((2 * B, L + 1), rdt).at[:, 0].set(bot0)
        _, _, tops, bots = jax.lax.fori_loop(0, L, rec_body,
                                             (top0, bot0, tops, bots))
        et = tops[lane_i, jnp.clip(lens2, 0, L)]
        eb = bots[lane_i, jnp.clip(lens2, 0, L)]
        exact_ok = act2 & (et < eb)
        exact_cnt = jnp.minimum(
            jnp.where(exact_ok, eb - et, jnp.zeros((), rdt)).astype(
                jnp.uint32), jnp.uint32(1 << 30))
        exact_mult = jnp.minimum(exact_cnt[:B] + exact_cnt[B:],
                                 jnp.uint32(1 << 30)).astype(jnp.int32)
        if not cfg.no_exact_up:
            # --no-exact-upfront drops the dedicated exact ranges (exact
            # hits still surface through the seed ranges, as in the
            # reference where seeds rediscover them)
            r_lane.append(lane_i)
            r_depth.append(jnp.zeros(2 * B, jnp.int32))
            r_top.append(et)
            r_cnt.append(jnp.minimum(
                jnp.where(exact_ok, eb - et, jnp.zeros((), rdt)),
                jnp.asarray(E, rdt)).astype(jnp.int32))
            r_src.append(jnp.zeros(2 * B, jnp.int32))

    # ---- stage 2: substitution branches ----
    if not cfg.has_short:
        # Fast shape: no branch stage at all. Any 1-substitution alignment
        # leaves at least one instantiated seed intact (the fast-shape
        # condition), so its diagonal is produced by the k-mer seed lookup
        # in stage 3 and verified by the DP stage (ref: oneMmSearch's role,
        # aligner_seed.cpp:973, is subsumed by seeds + extend here).
        cnt_fw = jnp.int32(0)
        cnt_mr = jnp.int32(0)
    else:
        # General shape (short reads): both halves with a continuation
        # loop, right halves on the mirror index (ref: oneMmSearch's case
        # split at the read middle, aligner_seed.cpp:973).
        def one_mm(fm, pat, hi, tops_, bots_):
            outs, max_cnt = [], jnp.int32(0)
            for c in range(cfg.n_chunks):
                cb, cm, pos, top, bot, count = dfm.one_mm_phase0_body(
                    fm, pat, lens2, hi, tops_, bots_,
                    c * cfg.chunk_w, cfg.chunk_w, cfg.k1)
                posf, topf, botf = dfm.one_mm_phase1_body(
                    fm, pat, cb, pos, top, bot, L // 2 + 2)
                ok = (cb >= 0) & (posf < 0) & (topf < botf)
                outs.append((cb, topf, botf, ok))
                max_cnt = jnp.maximum(max_cnt, count)
            return outs, max_cnt

        act_1mm = act2 & jnp.asarray(not cfg.no_1mm_up)
        pat_i8 = both.astype(jnp.int8)
        hits_fw, cnt_fw = one_mm(didx.fw, pat_i8,
                                 jnp.where(act_1mm, half2, 0), tops, bots)
        rev2 = _rev_rows(both, lens2, 5)
        tops_m, bots_m = dfm.backward_search_record_body(
            didx.mirror, rev2, lens2)
        hits_mr, cnt_mr = one_mm(didx.mirror, rev2.astype(jnp.int8),
                                 jnp.where(act_1mm, lens2 - half2, 0),
                                 tops_m, bots_m)
        for src, is_m in ((hits_fw, False), (hits_mr, True)):
            for cb, topf, botf, ok in src:
                r_lane.append(jnp.clip(cb, 0, 2 * B - 1))
                r_depth.append(jnp.zeros(cfg.k1, jnp.int32))
                r_top.append(topf)
                r_cnt.append(jnp.minimum(
                    jnp.where(ok, botf - topf, jnp.zeros((), rdt)),
                    jnp.asarray(E, rdt)).astype(jnp.int32))
                r_src.append(jnp.full(cfg.k1, 1 if is_m else 0, jnp.int32))

    # ---- stage 3: seed rounds ----
    round_active = seed_r0_active
    seeds_failed_r0 = jnp.zeros(B, bool)
    # observability counter (ref: SeedSearchMetrics.seedsearch,
    # aligner_seed.h:1396): seed lookups actually performed
    n_seed_ct = jnp.int32(0)
    # a full-read exact copy is in EVERY seed's range, so clipping can hide
    # one only when ALL of a strand's round-0 seed ranges clipped at E
    read_clip = jnp.zeros(B, bool)

    # reseed-compaction overflow watermark (counter slot 8)
    reseed_max = jnp.int32(0)

    if not cfg.has_short:
        # k-mer position table: rolling keys (no gathers) resolved by the
        # cuckoo-hash table (2 independent 32-byte row gathers per lane,
        # index/kmer.py) or the sorted-table binary search fallback.
        # All reads here have len >= Ls.
        def _seed_lookup(qh, ql):
            if cfg.kmer_mode == "cuckoo":
                return kmod.cuckoo_lookup(dkm, qh, ql, cfg.tbits, cfg.salt)
            return kmod.lookup_body(dkm, qh, ql, cfg.n_hi, cfg.bbits,
                                    cfg.kmer_steps)

        def _cut3(*vals):   # sub-stage bisection (scripts/profile_cuts.py)
            acc = jnp.int32(0)
            for v in vals:
                acc = acc + v.astype(jnp.int32).sum()
            return jnp.broadcast_to(acc, ((5, cfg.C_max + 128) if cfg.pack5 else (7, cfg.C_max)))

        n_hi, n_lo = cfg.n_hi, cfg.n_lo
        codes4f = jnp.where(la_codes <= 3, la_codes, 0).astype(jnp.uint32)
        khi_fw = _rolling_keys(codes4f, n_hi, 0, False)
        klo_fw = (_rolling_keys(codes4f, n_lo, n_hi, False)
                  if n_lo else jnp.zeros_like(khi_fw))
        codes4r = jnp.where(ra_codes <= 3, comp_ra, 0).astype(jnp.uint32)
        khi_rc = _rolling_keys(codes4r, n_hi, 0, True)
        klo_rc = (_rolling_keys(codes4r, n_lo, n_hi, True)
                  if n_lo else jnp.zeros_like(khi_rc))
        # N-in-window flags, shared by both strands (the rc seed at
        # start_rc covers fw positions [start_fw, start_fw+Ls))
        ncum = jnp.pad(jnp.cumsum(is_n.astype(jnp.int32), axis=1),
                       ((0, 0), (1, 0)))                        # [B, L+1]
        ncum = jnp.pad(ncum, ((0, 0), (0, Ls)), mode="edge")
        if cfg.engine == "cut_keys":
            return _cut3(khi_fw, klo_fw, khi_rc, klo_rc, ncum)

        for r in range(cfg.R):
            # round 0 also looks up seeds of exact-only (seed_skip) reads —
            # their exact diagonal is on every seed — but they never count
            # toward the reseeding stats below
            lk_active = (round_active | (ex_only & (act_fw | act_rc))
                         if r == 0 else round_active)
            if cfg.sched is not None:
                # batch-uniform schedule: seed columns are compile-time
                # constants -> static slices instead of [B, S] gathers
                offs = cfg.sched[r]
                if not offs:
                    if r == 0:
                        seeds_failed_r0 = seed_r0_active
                    round_active = jnp.zeros(B, bool)
                    continue
                S_r = len(offs)
                len0 = cfg.static_len
                q_hi_f = jnp.stack([khi_fw[:, o] for o in offs], 1)
                q_lo_f = jnp.stack([klo_fw[:, o] for o in offs], 1)
                # rc window indexed by its last fw position q = o + Ls - 1;
                # ra column of fw position k is L - len + k
                q_hi_r = jnp.stack(
                    [khi_rc[:, L - len0 + o + Ls - 1] for o in offs], 1)
                q_lo_r = jnp.stack(
                    [klo_rc[:, L - len0 + o + Ls - 1] for o in offs], 1)
                win_n = jnp.stack(
                    [(ncum[:, o + Ls] - ncum[:, o]) > 0 for o in offs], 1)
                d_fw = jnp.broadcast_to(
                    jnp.array(offs, jnp.int32)[None], (B, S_r))
                d_rc = jnp.broadcast_to(
                    jnp.array([len0 - o - Ls for o in offs],
                              jnp.int32)[None], (B, S_r))
                sv = jnp.broadcast_to(lk_active[:, None], (B, S_r))
                ok_f = sv & act_fw[:, None] & ~win_n
                ok_r = sv & act_rc[:, None] & ~win_n
            else:
                S_r = S
                sv = seed_valid[:, r, :] & lk_active[:, None]    # [B, S]
                d_fw = seed_start[:, r, :]                       # [B, S]
                d_rc = lens[:, None] - d_fw - Ls
                dc = jnp.clip(d_fw, 0, L - 1)
                bsel = jnp.arange(B)[:, None]
                q_hi_f = khi_fw[bsel, dc]
                q_lo_f = klo_fw[bsel, dc]
                # rc window indexed by its last fw position q = d_fw+Ls-1;
                # ra column of fw position k is L - len + k
                qcol = jnp.clip(L - lens[:, None] + d_fw + Ls - 1, 0, L - 1)
                q_hi_r = khi_rc[bsel, qcol]
                q_lo_r = klo_rc[bsel, qcol]
                win_n = (ncum[bsel,
                              jnp.clip(d_fw + Ls, 0, ncum.shape[1] - 1)]
                         - ncum[bsel, dc]) > 0
                ok_f = sv & act_fw[:, None] & ~win_n & (d_fw >= 0)
                ok_r = sv & act_rc[:, None] & ~win_n & (d_rc >= 0)
            q_hi = jnp.concatenate([q_hi_f, q_hi_r]).reshape(-1)
            q_lo = jnp.concatenate([q_lo_f, q_lo_r]).reshape(-1)
            val_all = jnp.concatenate([ok_f, ok_r]).reshape(-1)
            dep_all = jnp.concatenate([d_fw, d_rc]).reshape(-1)
            lane_all = jnp.concatenate([
                jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None],
                                 (B, S_r)),
                jnp.broadcast_to((jnp.arange(B, dtype=jnp.int32)
                                  + B)[:, None], (B, S_r))]).reshape(-1)
            Ntot = q_hi.shape[0]
            if r == 0 or cfg.RS == 0 or cfg.RS >= Ntot:
                start, cnt = _seed_lookup(q_hi, q_lo)
                if r == 0 and cfg.engine == "cut_probe0":
                    return _cut3(start, cnt, val_all, dep_all, lane_all)
                n_seed_ct += jnp.sum(val_all.astype(jnp.int32))
                cnt = jnp.where(val_all, cnt, 0)
                st_lane, st_val = lane_all, val_all
            else:
                # reseed rounds fire for <1% of reads: compact the active
                # lanes to cfg.RS rows before the table probes so the
                # masked majority costs no gathers (overflow -> counter
                # slot 8 -> host capacity escalation)
                n_act = jnp.sum(val_all.astype(jnp.int32))
                reseed_max = jnp.maximum(reseed_max, n_act)
                sel_r = jnp.nonzero(val_all, size=cfg.RS,
                                    fill_value=Ntot)[0]
                ok_c = sel_r < Ntot
                selc = jnp.clip(sel_r, 0, Ntot - 1)
                qmat = jnp.stack(
                    [jax.lax.bitcast_convert_type(q_hi, jnp.int32),
                     jax.lax.bitcast_convert_type(q_lo, jnp.int32),
                     dep_all, lane_all], axis=1)          # [Ntot, 4]
                qr = qmat[selc]                            # [RS, 4] rows
                start, cnt = _seed_lookup(
                    jax.lax.bitcast_convert_type(qr[:, 0], jnp.uint32),
                    jax.lax.bitcast_convert_type(qr[:, 1], jnp.uint32))
                n_seed_ct += n_act
                cnt = jnp.where(ok_c, cnt, 0)
                dep_all = qr[:, 2]
                lane_all = jnp.clip(qr[:, 3], 0, 2 * B - 1)
                st_lane, st_val = lane_all, ok_c
            hit = st_val & (cnt > 0)
            r_lane.append(lane_all)
            r_depth.append(dep_all)
            r_top.append(start.astype(jnp.int32))
            r_cnt.append(jnp.minimum(cnt, E).astype(jnp.int32))
            r_src.append(jnp.full(lane_all.shape[0], 2, jnp.int32))

            read_of = lane_all % B
            if r == 0:
                unclip2 = jax.ops.segment_max(
                    (st_val & (cnt <= E)).astype(jnp.int32), lane_all,
                    num_segments=2 * B) > 0
                any2 = jax.ops.segment_max(
                    st_val.astype(jnp.int32), lane_all,
                    num_segments=2 * B) > 0
                allclip2 = any2 & ~unclip2
                read_clip = allclip2[:B] | allclip2[B:]
            # reseeding stats never include exact-only lanes
            st_ok = st_val & ~ex_only[read_of]
            inst = jax.ops.segment_sum(st_ok.astype(jnp.int32), read_of,
                                       num_segments=B)
            nonz = jax.ops.segment_sum((hit & st_ok).astype(jnp.int32),
                                       read_of, num_segments=B)
            tot = jax.ops.segment_sum(
                jnp.where(st_ok, cnt, 0).astype(jnp.int32), read_of,
                num_segments=B)
            if r == 0:
                seeds_failed_r0 = seed_r0_active & ((inst == 0) | (nonz == 0))
            round_active = round_active & (inst > 0) & (nonz > 0) & \
                (tot >= cfg.boost_thresh * nonz)
            if r == 0 and cfg.engine == "cut_r0":
                return _cut3(round_active, seeds_failed_r0, read_clip,
                             *(x[-1] for x in (r_lane, r_depth, r_top,
                                               r_cnt)))
    else:
        # FM seed search with per-read truncated seeds (general shape)
        sl = jnp.minimum(Ls, lens)                          # [B]
        js = jnp.arange(Ls, dtype=jnp.int32)
        for r in range(cfg.R):
            sv = seed_valid[:, r, :] & round_active[:, None]      # [B, S]
            start_fw = seed_start[:, r, :]                        # [B, S]
            start_rc = lens[:, None] - start_fw - sl[:, None]
            pats, valids, depths, lanes = [], [], [], []
            for is_fw, seqs_, starts, act_s in (
                    (True, fw_seqs, start_fw, act_fw),
                    (False, rc_seqs, start_rc, act_rc)):
                idxg = starts[:, :, None] + js[None, None, :]     # [B, S, k]
                idxc = jnp.clip(idxg, 0, L - 1)
                pat = seqs_[jnp.arange(B)[:, None, None], idxc]
                in_seed = js[None, None, :] < sl[:, None, None]
                has_n = jnp.any((pat > 3) & in_seed, axis=2)
                v = sv & act_s[:, None] & ~has_n & (starts >= 0)
                pat = jnp.where(in_seed, pat, 5)
                pats.append(pat)
                valids.append(v)
                depths.append(starts)
                lanes.append(jnp.broadcast_to(
                    (jnp.arange(B, dtype=jnp.int32)
                     + (0 if is_fw else B))[:, None], (B, S)))
            pat_all = jnp.concatenate(pats).reshape(2 * B * S, Ls)
            val_all = jnp.concatenate(valids).reshape(-1)
            dep_all = jnp.concatenate(depths).reshape(-1)
            lane_all = jnp.concatenate(lanes).reshape(-1)
            slen_all = jnp.repeat(sl, S, total_repeat_length=B * S)
            slen_all = jnp.concatenate([slen_all, slen_all])
            stop, sbot = dfm.backward_search_body(
                didx.fw, pat_all, jnp.where(val_all, slen_all, 0),
                use_ftab=True)
            if cfg.seed_mms >= 1:
                # -N 1 in-seed substitution branches (ref:
                # aligner_seed.cpp:668 searchSeedBi with one mismatch; the
                # bidirectional case split becomes left halves on the fw
                # index, right halves on the mirror index over reversed
                # seed patterns — the same machinery as the full-read 1mm
                # stage, applied per seed). src 0 hits resolve like exact
                # seed ranges; src 3 marks mirror seed ranges whose depth
                # field carries depth+seed_len (stage 4).
                NP = pat_all.shape[0]
                slen_act = jnp.where(val_all, slen_all, 0)
                half_s = slen_all // 2
                cw_s = max(1, min(_pow2(Ls, lo=8),
                                  (1 << 22) // max(NP * 4, 1)))
                n_chunks_s = -(-Ls // cw_s)
                k1s = cfg.k1
                pat_i8s = pat_all.astype(jnp.int8)
                tops_s, bots_s = dfm.backward_search_record_body(
                    didx.fw, pat_all, slen_act)
                rev_pat = _rev_rows(pat_all, slen_all, 5)
                tops_m2, bots_m2 = dfm.backward_search_record_body(
                    didx.mirror, rev_pat, slen_act)

                def seed_one_mm(fm, pats, his, tops_, bots_, mirror,
                                over):
                    for c in range(n_chunks_s):
                        cb, cm, pos1, top1, bot1, cnt1 = \
                            dfm.one_mm_phase0_body(
                                fm, pats, slen_act, his, tops_, bots_,
                                c * cw_s, cw_s, k1s)
                        posf, topf, botf = dfm.one_mm_phase1_body(
                            fm, pats, cb, pos1, top1, bot1, Ls + 2)
                        ok1 = (cb >= 0) & (posf < 0) & (topf < botf)
                        cbc = jnp.clip(cb, 0, NP - 1)
                        r_lane.append(lane_all[cbc])
                        dep1 = dep_all[cbc]
                        if mirror:
                            dep1 = dep1 + slen_all[cbc]
                        r_depth.append(dep1)
                        r_top.append(topf)
                        r_cnt.append(jnp.minimum(
                            jnp.where(ok1, botf - topf,
                                      jnp.zeros((), rdt)),
                            jnp.asarray(E, rdt)).astype(jnp.int32))
                        r_src.append(jnp.full(k1s, 3 if mirror else 0,
                                              jnp.int32))
                        over = jnp.maximum(over, cnt1)
                    return over

                cnt_fw = seed_one_mm(
                    didx.fw, pat_i8s, jnp.where(val_all, half_s, 0),
                    tops_s, bots_s, False, cnt_fw)
                cnt_mr = seed_one_mm(
                    didx.mirror, rev_pat.astype(jnp.int8),
                    jnp.where(val_all, slen_all - half_s, 0),
                    tops_m2, bots_m2, True, cnt_mr)

            n_seed_ct += jnp.sum(val_all.astype(jnp.int32))
            hit = val_all & (stop < sbot)
            zero_r = jnp.zeros((), rdt)
            hits_n = jnp.minimum(jnp.where(hit, sbot - stop, zero_r),
                                 jnp.asarray(1 << 20, rdt))
            r_lane.append(lane_all)
            r_depth.append(dep_all)
            r_top.append(stop)
            r_cnt.append(jnp.minimum(hits_n,
                                     jnp.asarray(E, rdt)).astype(jnp.int32))
            r_src.append(jnp.zeros(lane_all.shape[0], jnp.int32))

            read_of = lane_all % B
            inst = jax.ops.segment_sum(val_all.astype(jnp.int32), read_of,
                                       num_segments=B)
            nonz = jax.ops.segment_sum(hit.astype(jnp.int32), read_of,
                                       num_segments=B)
            tot = jax.ops.segment_sum(hits_n.astype(jnp.int32), read_of,
                                      num_segments=B)
            if r == 0:
                seeds_failed_r0 = seed_r0_active & ((inst == 0) | (nonz == 0))
            round_active = round_active & (inst > 0) & (nonz > 0) & \
                (tot >= cfg.boost_thresh * nonz)

    # ---- stage 4: assemble ranges -> elements -> resolve ----
    # Two-level compaction: most appended ranges are empty (seeds that
    # missed, inactive rounds), so first compact hit ranges (a nonzero over
    # NR), then expand only those to elements (a nonzero over NH*E instead
    # of NR*E — the dominant cumsum shrinks ~4x).
    r_lane = jnp.concatenate(r_lane).astype(jnp.int32)
    r_depth = jnp.concatenate(r_depth).astype(jnp.int32)
    # rows bitcast int32 for the packed row-gather matrix (big mode: the
    # uint32 bit pattern rides through the int32 pack losslessly)
    r_top = jax.lax.bitcast_convert_type(
        jnp.concatenate(r_top).astype(rdt), jnp.int32)
    r_cnt = jnp.concatenate(r_cnt).astype(jnp.int32)
    r_src = jnp.concatenate(r_src)
    NR = r_lane.shape[0]
    NH = cfg.NH

    def _cut(*vals):   # debug engines: stop here, defeat DCE
        acc = jnp.int32(0)
        for v in vals:
            acc = acc + v.astype(jnp.int32).sum()
        return jnp.broadcast_to(acc, ((5, cfg.C_max + 128) if cfg.pack5 else (7, cfg.C_max)))

    if cfg.engine == "cut_seeds":
        return _cut(r_lane, r_depth, r_top, r_cnt, r_src)

    # The hit ranges are packed as [*, 4] int32 matrix ROWS so both
    # compaction levels gather whole rows (1 gather each instead of 4-5).
    hitr = r_cnt > 0
    n_hit = jnp.sum(hitr.astype(jnp.int32))
    hsel = jnp.nonzero(hitr, size=NH, fill_value=NR)[0]
    hidx = jnp.clip(hsel, 0, NR - 1)
    r_mat = jnp.stack(
        [r_lane, r_depth, r_top,
         r_cnt | (r_src << 16) if cfg.has_short else r_cnt], axis=1)
    h_mat = r_mat[hidx]                                    # [NH, 4]
    h_cnt = jnp.where(hsel >= NR, 0, h_mat[:, 3] & 0xFFFF)

    ev = (jnp.arange(E, dtype=jnp.int32)[None, :] < h_cnt[:, None]).reshape(-1)
    n_elts = jnp.sum(ev.astype(jnp.int32))
    sel = jnp.nonzero(ev, size=cfg.C_pre, fill_value=NH * E)[0]
    pad = sel >= NH * E
    ridx = jnp.clip(sel // E, 0, NH - 1)
    e_mat = h_mat[ridx]                                    # [C_pre, 4]
    lane = e_mat[:, 0]
    e_depth = e_mat[:, 1]
    row = (jax.lax.bitcast_convert_type(e_mat[:, 2], rdt)
           + (sel % E).astype(rdt))
    n_keys = dkm.pos.shape[0]
    if cfg.big:
        # sampled-SA walk-left resolution, one pass per direction (ref:
        # walkLeft/getOffset, bt2_idx.h:1607; group_walk.h's laziness is
        # replaced by a fixed 2^off_rate-step masked loop)
        src = e_mat[:, 3] >> 16
        is_m = (src == 1) | (src == 3)
        read = lane % B
        rl = lens[read].astype(rdt)
        row_c = jnp.minimum(row, didx.fw.n - 1)
        off_fw = dfm.resolve_rows_body(
            didx.fw, row_c, ~pad & ~is_m, cfg.off_rate)
        off_mr = dfm.resolve_rows_body(
            didx.mirror, jnp.minimum(row, didx.mirror.n - 1),
            ~pad & is_m, cfg.off_rate)
        off = jnp.where(is_m, off_mr, off_fw)
        n_text_u = jnp.asarray(n_text, rdt)
        # src 1 = full-read mirror range (subtract read length); src 3 =
        # mirror SEED range (depth field already carries depth+seed_len)
        diag = jnp.where(
            src == 1, (n_text_u + BIAS_u) - off - rl,
            jnp.where(src == 3,
                      (n_text_u + BIAS_u) - off - e_depth.astype(rdt),
                      off + BIAS_u - e_depth.astype(rdt)))
        e_ok = ~pad & (diag + rl > BIAS_u)    # biased form of diag > -rl
    elif cfg.has_short:
        src = e_mat[:, 3] >> 16
        is_m = (src == 1) | (src == 3)
        read = lane % B
        rl = lens[read]
        off_fw = didx.fw.sa[
            jnp.clip(row, 0, didx.fw.sa.shape[0] - 1)].astype(jnp.int32)
        off_pos = dkm.pos[jnp.clip(row, 0, n_keys - 1)].astype(jnp.int32)
        off_mr = didx.mirror.sa[
            jnp.clip(row, 0, didx.mirror.sa.shape[0] - 1)].astype(jnp.int32)
        off = jnp.where(is_m, off_mr, jnp.where(src == 2, off_pos,
                                                off_fw))
        # src 1 = full-read mirror range; src 3 = mirror SEED range whose
        # depth field carries depth+seed_len (the -N 1 sub-search)
        diag = jnp.where(src == 1, n_text - off - rl,
                         jnp.where(src == 3, n_text - off - e_depth,
                                   off - e_depth))
        e_ok = ~pad & (diag > -rl)
    else:
        # fast shape: every range is a seed-table range (src == 2)
        off = dkm.pos[jnp.clip(row, 0, n_keys - 1)].astype(jnp.int32)
        diag = off - e_depth
        e_ok = ~pad & (diag > -L)
    if cfg.engine == "cut_resolve":
        return _cut(off, diag, lane, e_ok)

    # ---- stage 5: dedup on (lane, diag) via 2-key sort ----
    key_lane = jnp.where(e_ok, lane, jnp.int32(1 << 30))
    key_diag = diag
    s_lane, s_diag = jax.lax.sort((key_lane, key_diag), num_keys=2)
    prev_lane = jnp.concatenate([jnp.array([-1], jnp.int32), s_lane[:-1]])
    prev_diag = jnp.concatenate([jnp.zeros(1, s_diag.dtype), s_diag[:-1]])
    uniq = (s_lane < (1 << 30)) & ((s_lane != prev_lane)
                                   | (s_diag != prev_diag))
    n_cand = jnp.sum(uniq.astype(jnp.int32))
    csel = jnp.nonzero(uniq, size=cfg.C_max, fill_value=cfg.C_pre)[0]
    cpad = csel >= cfg.C_pre
    cselc = jnp.clip(csel, 0, cfg.C_pre - 1)
    c_lane = jnp.where(cpad, 0, s_lane[cselc])
    c_diag = jnp.where(cpad, jnp.zeros((), s_diag.dtype), s_diag[cselc])
    c_valid = ~cpad
    if cfg.engine == "cut_dedup":
        return _cut(c_lane, c_diag, c_valid, n_cand)

    # ---- stage 6: banded DP over interior candidates ----
    K = cfg.K
    c_read = c_lane % B
    c_fw = c_lane < B
    c_rl = lens[c_read]
    if cfg.big:
        # biased unsigned geometry: run bounds shifted by the same BIAS
        ws = c_diag - jnp.asarray(K // 2, rdt)
        rs_b = didx.run_starts + BIAS_u
        re_b = didx.run_ends + BIAS_u
        run_i = jnp.clip(
            jnp.searchsorted(rs_b, c_diag, side="right") - 1,
            0, rs_b.shape[0] - 1)
        lo = rs_b[run_i]
        hi_run = re_b[run_i]
        interior = c_valid & (ws >= lo) & \
            (ws + c_rl.astype(rdt) + jnp.asarray(K, rdt) <= hi_run)
    else:
        ws = c_diag - K // 2
        run_i = jnp.clip(
            jnp.searchsorted(didx.run_starts, jnp.maximum(c_diag, 0),
                             side="right") - 1,
            0, didx.run_starts.shape[0] - 1)
        lo = didx.run_starts[run_i]
        hi_run = didx.run_ends[run_i]
        interior = c_valid & (ws >= lo) & (ws + c_rl + K <= hi_run)

    Cx = cfg.C_max
    W = L + K
    # reference gather in 32-byte rows (128 bases each — one gather index
    # per row), then two static select levels: 8-way for
    # the word offset inside the first row, 16-way for the base offset
    # inside the word. Replaces nw single-word gathers per candidate.
    nw = W // 16 + 2
    n_rows = didx.joined_words.shape[0]
    nrow_g = -(-(nw + 7) // 8)   # rows to cover word offset 7 + nw words
    if cfg.big:
        wsc = jnp.clip(ws, BIAS_u,
                       jnp.asarray(max(n_text - 1, 1) + BIAS, rdt)) - BIAS_u
    else:
        wsc = jnp.clip(ws, 0, jnp.maximum(n_text - 1, 1))
    r0 = wsc >> 7
    woff = ((wsc >> 4) & 7).astype(jnp.int32)
    sh = (wsc & 15).astype(jnp.int32)
    rgat = didx.joined_words[
        jnp.clip(r0[:, None] + jnp.arange(nrow_g, dtype=rdt)[None, :],
                 jnp.zeros((), rdt), jnp.asarray(n_rows - 1, rdt))]
    # [C, nrow_g, 8]
    words = rgat.reshape(Cx, nrow_g * 8)                # [C, 8*nrow_g]
    wwin = jnp.zeros((Cx, nw), jnp.uint32)
    for t in range(8):
        wwin = jnp.where((woff == t)[:, None], words[:, t : t + nw], wwin)
    unp = jnp.stack([(wwin >> jnp.uint32(2 * t)) & jnp.uint32(3)
                     for t in range(16)], axis=2)       # [C, nw, 16]
    unp = unp.reshape(Cx, nw * 16).astype(jnp.int32)
    band = jnp.zeros((Cx, W), jnp.int32)
    for k in range(16):
        band = band + jnp.where((sh == k)[:, None], unp[:, k : k + W], 0)
    rd_c = both[jnp.clip(c_lane, 0, 2 * B - 1)]          # [C, L]
    mm_c = mm_both[jnp.clip(c_lane, 0, 2 * B - 1)]
    lens_c = jnp.maximum(c_rl, 1)

    rd_t = rd_c.T.astype(jnp.int32)
    mm_t = mm_c.T.astype(jnp.int32)
    band_t = band.T
    if cfg.engine == "cut_band":
        return _cut(rd_t, mm_t, band_t, interior)
    if cfg.engine == "nodp":   # debug: skip DP (stage timing)
        best = (rd_t.sum(0) + band_t.sum(0)).astype(jnp.int32) % 3
        bi = lens_c - 1
        bk = best
    else:
        best, bi, bk = _banded_tile_xla(cfg.sw, K, rd_t, mm_t,
                                        lens_c.astype(jnp.int32), band_t)
    c_end = ws + bi.astype(rdt) + bk.astype(rdt)
    c_score = jnp.where(interior, best, jnp.int32(NEG_INF))

    # center-diagonal ungapped stats (ref: SwAligner::ungappedAlign's
    # role, aligner_sw.cpp): computed here so the host can commit
    # ungapped winners without gathering the reference itself. A winner
    # is certified ungapped iff its DP end sits on the last read row, its
    # start column is the candidate's own diagonal (band center K//2 — a
    # STATIC slice; candidates ARE diagonals, so a genuinely ungapped
    # winner starts there), and the pure diagonal reproduces the DP
    # score. Anything else takes the host traceback path.
    j_l = jnp.arange(L, dtype=jnp.int32)[None, :]
    in_rl = j_l < c_rl[:, None]
    ref_d = band[:, K // 2 : K // 2 + L]
    isn_c = rd_c > 3
    mism = (rd_c != ref_d) & ~isn_c & in_rl
    swc = cfg.sw
    step_sc = jnp.where(isn_c, jnp.int32(-swc.npen),
                        jnp.where(mism, -mm_c.astype(jnp.int32),
                                  jnp.int32(swc.ma)))
    usc = jnp.sum(jnp.where(in_rl, step_sc, 0), axis=1)
    nm_c = jnp.sum((mism | (isn_c & in_rl)).astype(jnp.int32), axis=1)
    ungapped_c = (bi == c_rl - 1) & (bk == K // 2) & (usc == best)
    row6 = jnp.minimum(nm_c, (1 << 16) - 1) | (
        ungapped_c.astype(jnp.int32) << 16)

    # ---- stage 7: per-read selection (best + secbest-distinct-end) ----
    sel_ok = interior & (c_score >= minsc[c_read])
    if not cfg.has_short:
        # seed_skip (exact-only) reads keep hits the reference's up-front
        # stages would find without seeds: perfect full-read matches
        # (exactSweep) AND ungapped full-length hits with <= 1
        # substitution (do1mmUpFront, aligner_seed.cpp:973) — dropping
        # the latter lost mate-rescue anchors (r376-class pairs)
        allow_up = jnp.zeros(sel_ok.shape, bool)
        if not cfg.no_exact_up:
            allow_up |= c_score == perfect[c_read]
        if not cfg.no_1mm_up:
            # exactly-1-substitution full-length hits (oneMmSearch's set;
            # nm==0 full-span hits score `perfect` and ride the exact
            # clause)
            allow_up |= ungapped_c & (nm_c == 1)
        sel_ok &= ~ex_only[c_read] | allow_up
    NEG = jnp.int32(NEG_INF)
    sc = jnp.where(sel_ok, c_score, NEG)
    best_sc = _seg_max(sc, c_read, B)
    is_bs = sel_ok & (c_score == best_sc[c_read])
    if cfg.big:
        # leftmost diagonal via bitwise complement (monotone decreasing
        # over uint32 — the unsigned analog of negation)
        inv_diag = jnp.where(is_bs, ~c_diag, jnp.zeros((), rdt))
        best_nd = _seg_max(inv_diag.astype(jnp.uint32), c_read, B)
        is_bd = is_bs & (~c_diag == best_nd[c_read])
    else:
        ndiag = jnp.where(is_bs, -c_diag, jnp.int32(-(1 << 30)))
        best_nd = _seg_max(ndiag, c_read, B)
        is_bd = is_bs & (-c_diag == best_nd[c_read])
    fwi = jnp.where(is_bd, c_fw.astype(jnp.int32), -1)
    best_fwi = _seg_max(fwi, c_read, B)
    is_bf = is_bd & (c_fw.astype(jnp.int32) == best_fwi[c_read])
    cand_i = jnp.arange(Cx, dtype=jnp.int32)
    best_ci = jnp.maximum(_seg_max(jnp.where(is_bf, cand_i, -1), c_read, B),
                          -1)

    bcl = jnp.clip(best_ci, 0, Cx - 1)
    best_end_r = c_end[bcl]
    best_fw_r = c_fw[bcl]
    sec_ok = sel_ok & ((c_end != best_end_r[c_read])
                       | (c_fw != best_fw_r[c_read]))
    sec_sc = _seg_max(jnp.where(sec_ok, c_score, NEG), c_read, B)
    has_rect = jnp.maximum(
        _seg_max((c_valid & ~interior).astype(jnp.int32), c_read, B), 0)

    if not cfg.has_short:
        # exact hits recovered from DP scores (ref: exactSweep's nelt,
        # bt2_search.cpp:3461): a perfect-score candidate IS a full-read
        # exact match. A clipped seed range may hide further exact copies
        # of a perfectly-matching read -> conservative E+1 escape.
        is_perf = sel_ok & (c_score == perfect[c_read])
        n_perf = jax.ops.segment_sum(is_perf.astype(jnp.int32), c_read,
                                     num_segments=B)
        exact_mult = jnp.where(read_clip & (best_sc == perfect),
                               jnp.int32(E + 1), n_perf).astype(jnp.int32)

    # ---- pack outputs (single D2H array) ----
    best_pack = (((best_ci + 1) << 2)
                 | (jnp.minimum(has_rect, 1) << 1)
                 | seeds_failed_r0.astype(jnp.int32))
    # observability counters for the --met TSV (ref: bt2_search.cpp:1923):
    # slot 5 = seed lookups, slot 6 = interior DP problems, slot 7 =
    # device-certified ungapped winners
    counters = jnp.stack([n_cand, n_elts, cnt_fw, cnt_mr,
                          n_hit, n_seed_ct,
                          jnp.sum(interior.astype(jnp.int32)),
                          jnp.sum((interior & ungapped_c)
                                  .astype(jnp.int32)),
                          reseed_max])
    # big mode: the biased uint32 diagonal bitcasts through the int32 pack
    # (host decode: .view(uint32) - BIAS, BatchResult)
    row1 = (jax.lax.bitcast_convert_type(c_diag, jnp.int32)
            if cfg.big else c_diag)
    if cfg.pack5:
        # Compact layout (see CandGenCfg.pack5):
        # r0: valid | interior<<1 | fw<<2 | read<<4 (18b) | nm<<22 (9b)
        #     | ungapped<<31
        # r1: diag
        # r2: (score clamped +-30000, biased +32768, 16b)
        #     | (bi<<8 | bk)<<16
        # r3: best_pack : B
        # r4: [sec16<<16 | mult16 : B | ... | counters : last 9]
        W = Cx + 128
        r0 = (c_valid.astype(jnp.uint32)
              | (interior.astype(jnp.uint32) << 1)
              | (c_fw.astype(jnp.uint32) << 2)
              | (c_read.astype(jnp.uint32) << 4)
              | (jnp.minimum(nm_c, 511).astype(jnp.uint32) << 22)
              | (ungapped_c.astype(jnp.uint32) << 31))
        r0 = jax.lax.bitcast_convert_type(r0, jnp.int32)
        sc16 = (jnp.clip(c_score, -30000, 30000) + 32768).astype(jnp.int32)
        bibk = (jnp.clip(bi, 0, 255) << 8) | jnp.clip(bk, 0, 255)
        r2 = sc16 | (bibk << 16)
        sec16 = (jnp.clip(sec_sc, -30000, 30000) + 32768).astype(jnp.int32)
        # exact_mult saturates at 65535: every consumer compares against
        # small thresholds (resolve cap, mhits, >1), so saturation only
        # misreads when -M/-k thresholds exceed 65535 (host path anyway)
        secmult = (sec16 << 16) | jnp.minimum(exact_mult, 65535)
        pad = W - Cx
        r0 = jnp.pad(r0, (0, pad))
        r1p = jnp.pad(row1, (0, pad))
        r2 = jnp.pad(r2, (0, pad))
        r3 = jnp.zeros(W, jnp.int32)
        r3 = jax.lax.dynamic_update_slice(r3, best_pack, (0,))
        r4 = jnp.zeros(W, jnp.int32)
        r4 = jax.lax.dynamic_update_slice(r4, secmult, (0,))
        r4 = jax.lax.dynamic_update_slice(r4, counters, (W - 9,))
        return jnp.stack([r0, r1p, r2, r3, r4])
    row0 = ((c_read << 4) | (c_fw.astype(jnp.int32) << 2)
            | (interior.astype(jnp.int32) << 1) | c_valid.astype(jnp.int32))
    row3 = (bi << 8) | jnp.clip(bk, 0, 255)
    # row 4: [best_pack : B | sec_score : B]; row 5: [exact_mult : B |
    # pad | counters : last 9] — fits any C_max >= 2B
    row4 = jnp.zeros(Cx, jnp.int32)
    row4 = jax.lax.dynamic_update_slice(row4, best_pack, (0,))
    row4 = jax.lax.dynamic_update_slice(
        row4, jnp.maximum(sec_sc, NEG), (B,))
    row5 = jnp.zeros(Cx, jnp.int32)
    row5 = jax.lax.dynamic_update_slice(row5, exact_mult, (0,))
    row5 = jax.lax.dynamic_update_slice(row5, counters, (Cx - 9,))
    out = jnp.stack([row0, row1, c_score, row3, row4, row5, row6])
    return out


# ------------------------------------------------------------- multi-chip -

@functools.lru_cache(maxsize=16)
def _sharded_pipeline(cfg: CandGenCfg, mesh):
    """shard_map the fused pipeline over the mesh's 'dp' axis: reads are
    sharded, the index replicated (ref: SURVEY §2.3 — the reference's
    read-level data parallelism over worker threads maps to SPMD read
    shards; bt2_search.cpp:4913-4925). Candidate/read indices are remapped
    to global space on device so the host decode is shard-agnostic."""
    from jax.sharding import PartitionSpec as P

    def local_fn(didx, dkm, packed2, meta, mmtab):
        out = fused_pipeline(didx, dkm, cfg, packed2, meta, mmtab)
        s = jax.lax.axis_index("dp").astype(jnp.int32)
        cvalid = (out[0] & 1) > 0
        # read field starts at bit 4 in both layouts; pack5's field is 18
        # bits so ndev*B <= 2^18 (guaranteed by the dispatch gate)
        out = out.at[0].set(jnp.where(cvalid, out[0] + ((s * cfg.B) << 4),
                                      out[0]))
        # best_ci (stored +1 in the first B slots of the best_pack row)
        # -> global candidate index
        bp_row = 3 if cfg.pack5 else 4
        slots = jnp.arange(out.shape[1]) < cfg.B
        bp = out[bp_row]
        ci1 = bp >> 2
        bp2 = jnp.where(slots & (ci1 > 0),
                        (((ci1 - 1 + s * cfg.C_max) + 1) << 2) | (bp & 3),
                        bp)
        out = out.at[bp_row].set(bp2)
        return out

    return jax.jit(jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), P(), P(None, "dp", None), P("dp", None), P()),
        out_specs=P(None, "dp"),
        check_vma=False))


# --------------------------------------------------------------- host side -

def per_len(fn, lens):
    """Vectorize a scalar function of read length over a batch (few unique
    lengths per batch in practice)."""
    uniq, inv = np.unique(lens, return_inverse=True)
    vals = np.array([fn(int(l)) if l > 0 else fn(1) for l in uniq])
    return vals[inv]


class BatchResult:
    """Decoded outputs of one fused_pipeline run (host numpy)."""
    __slots__ = ("counters", "B0", "c_read", "c_fw", "c_diag", "c_score",
                 "c_end", "c_nm", "c_ungapped",
                 "c_bi", "c_bk", "c_interior", "c_ws", "best_ci", "best_sc",
                 "sec_sc", "exact_mult", "seeds_failed_r0", "has_rect",
                 "overflow")

    def __init__(self, B0, out, cfg, ndev, K):
        self.B0 = B0
        Cl, Bl = cfg.C_max, cfg.B
        if cfg.pack5:
            W = Cl + 128
            bp_l, sm_l, ctr = [], [], []
            cand_l = []
            for s in range(ndev):
                blk = out[:, s * W : (s + 1) * W]
                bp_l.append(blk[3, :Bl])
                sm_l.append(blk[4, :Bl])
                ctr.append(blk[4, W - 9 :])
                cand_l.append(blk[:3, :Cl])
            bp = np.concatenate(bp_l)[:B0]
            secmult = np.concatenate(sm_l)[:B0]
            ctr = np.stack(ctr)
            cand = np.concatenate(cand_l, axis=1)
            r0 = cand[0].view(np.uint32)
            valid = (r0 & 1) > 0
            reads = ((r0 >> 4) & 0x3FFFF).astype(np.int32)
            keep = valid & (reads < B0)
            self.c_read = reads[keep]
            self.c_fw = ((r0 >> 2) & 1).astype(bool)[keep]
            self.c_interior = ((r0 >> 1) & 1).astype(bool)[keep]
            self.c_nm = ((r0 >> 22) & 0x1FF).astype(np.int32)[keep]
            self.c_ungapped = (r0 >> 31).astype(bool)[keep]
            if cfg.big:
                self.c_diag = (cand[1][keep].view(np.uint32)
                               .astype(np.int64) - (cfg.L + cfg.K))
            else:
                self.c_diag = cand[1][keep]
            r2 = cand[2][keep]
            sc = (r2 & 0xFFFF) - 32768
            self.c_score = np.where(sc <= -30000, NEG_INF, sc)
            self.c_bk = (r2 >> 16) & 0xFF
            self.c_bi = (r2 >> 24) & 0xFF
            sec_raw = ((secmult.view(np.uint32) >> 16)
                       .astype(np.int64) - 32768)
            sec = np.where(sec_raw <= -30000, NEG_INF, sec_raw)
            mult = (secmult & 0xFFFF).astype(np.int64)
        else:
            # per-shard blocks along axis 1 (full 7-row layout)
            row0 = out[0]
            bp_l, sec_l, mult_l, ctr = [], [], [], []
            for s in range(ndev):
                r4 = out[4, s * Cl : (s + 1) * Cl]
                r5 = out[5, s * Cl : (s + 1) * Cl]
                bp_l.append(r4[:Bl])
                sec_l.append(r4[Bl : 2 * Bl])
                mult_l.append(r5[:Bl])
                ctr.append(r5[Cl - 9 :])
            bp = np.concatenate(bp_l)[:B0]
            sec = np.concatenate(sec_l)[:B0]
            mult = np.concatenate(mult_l)[:B0]
            ctr = np.stack(ctr)
            valid = (row0 & 1) > 0
            reads = row0 >> 4
            keep = valid & (reads < B0)
            self.c_read = reads[keep]
            self.c_fw = ((row0 >> 2) & 1).astype(bool)[keep]
            self.c_interior = ((row0 >> 1) & 1).astype(bool)[keep]
            if cfg.big:
                # biased uint32 diagonal bitcast through the int32 pack
                self.c_diag = (out[1][keep].view(np.uint32).astype(np.int64)
                               - (cfg.L + cfg.K))
            else:
                self.c_diag = out[1][keep]
            self.c_score = out[2][keep]
            self.c_bi = (out[3] >> 8)[keep]
            self.c_bk = (out[3] & 255)[keep]
            self.c_nm = (out[6] & 0xFFFF)[keep]
            self.c_ungapped = ((out[6] >> 16) & 1).astype(bool)[keep]
        self.counters = ctr
        self.overflow = bool((ctr[:, 0] > cfg.C_max).any()
                             or (ctr[:, 1] > cfg.C_pre).any()
                             or (ctr[:, 2] > cfg.k1).any()
                             or (ctr[:, 3] > cfg.k1).any()
                             or (ctr[:, 4] > cfg.NH).any()
                             or (cfg.RS > 0
                                 and (ctr[:, 8] > cfg.RS).any()))
        self.c_ws = self.c_diag - K // 2
        self.c_end = self.c_ws + self.c_bi + self.c_bk
        # remap best_ci (packed-array index) to compacted space
        remap = np.cumsum(keep) - 1
        bc = (bp >> 2) - 1
        self.best_ci = np.where(
            bc >= 0, remap[np.clip(bc, 0, len(keep) - 1)], -1).astype(np.int32)
        # a best_ci pointing at a dropped candidate (shouldn't happen) -> -1
        self.sec_sc = sec
        self.exact_mult = mult
        self.seeds_failed_r0 = (bp & 1).astype(bool)
        self.has_rect = ((bp >> 1) & 1).astype(bool)
        if len(self.c_read):
            self.best_sc = np.where(
                self.best_ci >= 0,
                self.c_score[np.clip(self.best_ci, 0,
                                     len(self.c_read) - 1)], NEG_INF)
        else:
            self.best_ci = np.full(B0, -1, np.int32)
            self.best_sc = np.full(B0, NEG_INF, np.int64)


_FETCH_POOL = None


def _shared_fetch_pool():
    global _FETCH_POOL
    if _FETCH_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _FETCH_POOL = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="candgen-d2h")
    return _FETCH_POOL


class CandGen:
    """Host driver of the fused device pipeline: padding/bucketing, packed
    transfers, dispatch (async) and fetch (single packed transfer)."""

    def __init__(self, dev_fw, dev_mirror, idx, pol, sw_cfg, engine: str,
                 K: int, device=None, mesh=None):
        self.mesh = mesh
        self._device = device
        self.big = dev_fw.off_rate > 0
        self.off_rate = dev_fw.off_rate
        rdt = np.uint32 if self.big else np.int32
        put = lambda x: jax.device_put(x, device)
        self._sticky = 1   # sticky size_mult after an overflow escalation
        self.didx = DeviceIndex(
            fw=dev_fw, mirror=dev_mirror,
            joined=put(idx.joined),
            joined_words=put(_pack_joined_words(idx.joined)),
            run_starts=put(idx.run_joined_start.astype(rdt)),
            run_ends=put(np.append(idx.run_joined_start[1:],
                                   idx.n).astype(rdt)))
        self._joined_host = idx.joined
        self._cache_base = getattr(idx, "cache_base", None)
        self.pol = pol
        self.sw_cfg = sw_cfg
        self.engine = engine
        self.K = K
        self._mmtab_dev = None
        self._ktabs: dict[int, tuple] = {}
        # D2H runs on its own threads so result downloads overlap device
        # compute; 2 threads cover a depth-3 dispatch pipeline. One
        # process-wide pool: CandGen
        # instances are created per aligner (tests build dozens) and a
        # per-instance pool would leak idle threads until exit.
        self._fetch_pool = _shared_fetch_pool()

    def _mmtab(self, mmtab):
        if self._mmtab_dev is None:
            # index by 6-bit clamped quality (matches scoring.mm_penalties
            # which clamps at 40 anyway)
            self._mmtab_dev = jax.device_put(
                mmtab[:64].astype(np.int32), self._device)
        return self._mmtab_dev

    def _kmer(self, seed_len: int):
        """(device table, host table) for this seed length, cached.

        The cuckoo two-choice table (2 independent row gathers per probe)
        is preferred; the sorted table is the fallback when placement
        fails. Big mode never uses the k-mer position table (the table
        doesn't fit HBM next to the index — seeds go through the FM
        general shape), so it gets a tiny dummy that satisfies the pytree
        signature."""
        hit = self._ktabs.get(seed_len)
        if hit is None:
            src = (self._joined_host if not self.big
                   else np.zeros(seed_len + 1, np.uint8))
            tab = None
            if not self.big:
                # disk cache beside the index: the batched-cuckoo build
                # costs ~4 s/Mbp on this host; loads are ~100 ms
                cb = self._cache_base
                tab = (kmod.load_cuckoo_table(cb, seed_len, joined=src)
                       if cb else None)
                if tab is None:
                    tab = kmod.build_cuckoo_table(src, seed_len)
                    if tab is not None and cb:
                        kmod.save_cuckoo_table(tab, cb, joined=src)
            if tab is not None:
                hit = (kmod.cuckoo_to_device(tab, self._device), tab)
            else:
                stab = kmod.build_kmer_table(src, seed_len)
                hit = (kmod.to_device(stab, self._device), stab)
            self._ktabs[seed_len] = hit
        return hit

    def dispatch(self, seqs, quals, lens, act_fw, act_rc, minsc, mmtab,
                 perfect=None, boost=None, seed_skip=None,
                 size_mult: int = 1):
        """seqs/quals: [B0, L0] uint8/int; lens [B0]. Returns an opaque
        handle (device arrays still in flight) for fetch()."""
        B0, L0 = seqs.shape
        ndev = self.mesh.devices.size if self.mesh is not None else 1
        B_local = _pow2(-(-B0 // ndev), lo=max(256 // ndev, 64))
        Bp = B_local * ndev
        Lp = _pow2(max(L0, 32), lo=32)
        pol = self.pol

        if boost is None:
            boost = np.zeros(B0, bool)
        if seed_skip is None:
            seed_skip = np.zeros(B0, bool)

        # per-read interval with exact host SimpleFunc semantics
        # (ref: simple_func.h C-cast truncation)
        lens_i = np.asarray(lens, np.int64)
        interval = np.maximum(
            1, per_len(pol.interval.f_int, lens)).astype(np.int64)
        boost = np.asarray(boost, bool)
        interval = np.where(
            boost, np.maximum(1, (interval * 1.2 + 0.5).astype(np.int64)),
            interval)
        nrounds = np.where(boost, -(-pol.n_seed_rounds // 2),
                           pol.n_seed_rounds)
        # static max seed count for this batch shape
        nseeds_ub = 1 + np.maximum(0, lens_i - pol.seed_len) // interval
        S = _pow2(int(nseeds_ub.max(initial=1)), lo=4)

        # fast shape iff every active read keeps >=1 intact seed under any
        # single-position substitution (see module doc)
        active = np.asarray(act_fw, bool) | np.asarray(act_rc, bool)
        cover = -(-pol.seed_len // interval)       # ceil(Ls / interval)
        has_short = bool(np.any(active & ((lens_i < pol.seed_len)
                                          | (nseeds_ub < cover + 1))))
        dkm, ktab = self._kmer(pol.seed_len)
        if len(self._joined_host) < pol.seed_len:
            has_short = True
        if self.big:
            # big mode runs the FM general shape (no k-mer table in HBM)
            has_short = True
        if pol.n_seed_mms > 0:
            # -N 1 needs per-seed FM patterns for the substitution branches
            has_short = True

        lens_u = np.unique(lens_i[:B0]) if B0 else lens_i[:0]
        uniform_len = len(lens_u) == 1 and int(lens_u[0]) == L0
        raw_len = 0
        if uniform_len:
            # single-plane encoded upload (1 B/base); right-align on device
            raw_len = L0
            packed = np.full((1, Bp, L0), 255, np.uint8)
            s_a = np.asarray(seqs, np.uint8)
            q6 = np.minimum(np.asarray(quals), 63).astype(np.uint8)
            packed[0, :B0] = np.where(s_a > 3, np.uint8(255),
                                      ((s_a & 3) << 6) | q6)
        else:
            packed = np.full((2, Bp, Lp), 255, np.uint8)
            q6 = np.minimum(np.asarray(quals), 63).astype(np.uint8)
            enc = ((np.asarray(seqs) & 3) << 6) | q6
            enc = np.where(np.asarray(seqs) > 3, 255, enc).astype(np.uint8)
            packed[0, :B0, :L0] = enc
            j = np.arange(L0)
            dest = (Lp - lens_i[:, None]) + j[None, :]
            valid_e = j[None, :] < lens_i[:, None]
            rows_e = np.broadcast_to(np.arange(B0)[:, None], (B0, L0))
            packed[1, rows_e[valid_e], dest[valid_e]] = enc[valid_e]

        meta = np.zeros((Bp, 5), np.int32)
        m0 = lens_i.copy()
        m0 |= np.where(np.asarray(act_fw, bool), _F_ACT_FW, 0)
        m0 |= np.where(np.asarray(act_rc, bool), _F_ACT_RC, 0)
        ss = np.asarray(seed_skip, bool)
        r0 = active & ~ss
        m0 |= np.where(r0, _F_SEED_R0, 0)
        m0 |= np.where(active & ss, _F_EXACT_ONLY, 0)
        meta[:B0, 0] = m0.astype(np.int32)
        meta[:B0, 1] = np.asarray(minsc, np.int32)
        meta[:B0, 2] = interval.astype(np.int32)
        meta[:B0, 3] = nrounds.astype(np.int32)
        if perfect is not None:
            meta[:B0, 4] = np.asarray(perfect, np.int32)

        # batch-uniform seed schedule -> compile-time seed columns (one
        # compiled shape per read-length bucket; saves the [B, S] key
        # gathers and the per-read schedule arithmetic)
        sched = None
        static_len = 0
        if not has_short and B0 > 0:
            u_l = np.unique(lens_i[:B0])
            u_iv = np.unique(interval[:B0])
            u_nr = np.unique(nrounds[:B0])
            if len(u_l) == 1 and len(u_iv) == 1 and len(u_nr) == 1:
                l0, iv, nr = int(u_l[0]), int(u_iv[0]), int(u_nr[0])
                Lsd = pol.seed_len
                rounds = []
                for r in range(pol.n_seed_rounds):
                    ok = (iv > r) and (r < nr)
                    off = (iv * r) // nr
                    if ok and off > 0 and Lsd + off > l0:
                        ok = False
                    if not ok:
                        rounds.append(())
                        continue
                    nseeds = 1 + ((l0 - off - Lsd) // iv
                                  if l0 - off > Lsd else 0)
                    rounds.append(tuple(off + i * iv for i in range(nseeds)))
                sched = tuple(rounds)
                static_len = l0

        GRID = 4 << 20
        Bl = B_local
        cw = min(_pow2(max(Lp // 2, 8), lo=8), max(8, GRID // (2 * Bl * 4)))
        n_chunks = -(-(Lp // 2) // cw)
        # sticky capacity escalation: a workload that overflowed once keeps
        # the larger sets (re-running every batch at 2x would be slower
        # than just sizing for the workload)
        size_mult = max(size_mult, self._sticky)
        # compact output layout whenever its field widths suffice (see
        # CandGenCfg.pack5); it also halves C_max — the bench-shape
        # candidate count runs at ~1/read, so C_max = B covers it with the
        # escalation path as the safety net
        pack5 = (Lp <= 256 and self.K <= 256 and ndev * Bl <= (1 << 18))
        # E scales with -k so the fused shape resolves enough elements per
        # range to honor khits (ref: ReportingParams::mult boosting ROWM,
        # aln_sink.h:264-283); -a and huge -k take the host path
        E_eff = _pow2(max(pol.max_sa_elts, min(pol.khits, 1024)))
        cfg = CandGenCfg(
            B=Bl, L=Lp, S=S, R=pol.n_seed_rounds, E=E_eff,
            seed_len=pol.seed_len, K=self.K,
            k1=_pow2(4 * Bl * size_mult, lo=4096), chunk_w=cw,
            n_chunks=n_chunks,
            # 6*B covers the measured element demand (~5.5/read on the
            # bench shape, ~178k at B=32k) with ~10% headroom; non-pow2
            # static shapes are fine, and the sticky escalation covers
            # heavier workloads. Cuts the stage-4/5 compaction + 2-key
            # dedup sort lanes 25% vs the old 8*B.
            NH=max(6 * Bl * size_mult, 8192),
            C_pre=max(6 * Bl * size_mult, 8192),
            # pack5: ~1 candidate/read is the common case, but batches sit
            # right AT that edge (a few reads with an extra diagonal), so
            # a fixed 1024-lane headroom avoids pathological escalation on
            # +epsilon batches; static non-pow2 shapes compile once per B
            # like any other
            C_max=(_pow2(Bl * size_mult, lo=4096) + 1024 if pack5
                   else _pow2(2 * Bl * size_mult, lo=4096)),
            sw=self.sw_cfg, engine=self.engine,
            has_short=has_short, pack5=pack5,
            kmer_mode=("cuckoo" if isinstance(ktab, kmod.CuckooTable)
                       else "sorted"),
            kmer_steps=getattr(ktab, "search_steps", 1),
            n_hi=ktab.n_hi, n_lo=ktab.n_lo,
            bbits=getattr(ktab, "bbits", 10),
            tbits=getattr(ktab, "tbits", 0),
            salt=getattr(ktab, "salt", 0),
            RS=(0 if has_short
                else _pow2(max(Bl // 4, 2048) * size_mult)),
            mmtab_t=tuple(int(x) for x in np.asarray(mmtab[:64])),
            sched=sched, static_len=static_len, raw_len=raw_len,
            big=self.big, off_rate=self.off_rate,
            seed_mms=min(pol.n_seed_mms, 1),
            boost_thresh=getattr(pol, "boost_thresh", 300),
            no_exact_up=getattr(pol, "no_exact_upfront", False),
            no_1mm_up=getattr(pol, "no_1mm_upfront", False))
        if self.mesh is not None:
            # uncommitted: the sharded program splits reads over the mesh
            args = (jnp.asarray(packed), jnp.asarray(meta),
                    self._mmtab(mmtab))
            out = _sharded_pipeline(cfg, self.mesh)(self.didx, dkm, *args)
        else:
            args = jax.device_put((packed, meta), self._device)
            out = fused_pipeline(self.didx, dkm, cfg, *args,
                                 self._mmtab(mmtab))
        # start the D2H on a dedicated thread now: off the dispatch/wait
        # threads it overlaps the device's work on the next batch
        fut = self._fetch_pool.submit(np.asarray, out)
        return (B0, out, cfg, ndev, fut)

    def fetch(self, handle) -> BatchResult:
        B0, out, cfg, ndev, fut = handle
        return BatchResult(B0, fut.result(), cfg, ndev, self.K)
