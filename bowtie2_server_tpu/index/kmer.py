"""Seed-length k-mer position table — the device replacement for the
seed-round FM searches (ref: aligner_seed.cpp:668 searchSeedBi with -N 0).

An exact-seed FM search costs seed_len chained LF steps x 2 occ gathers
each. A sorted k-mer table answers the same query — "all genome positions where this
seed_len-mer occurs" — in ceil(log2(max_bucket)) single-row gathers:

  key(pos)  = the seed_len bases at joined[pos:pos+seed_len], packed 2-bit
              big-endian into (hi, lo) uint32 halves
  bucket    = top `bbits` bits of hi, direct-addressed to a slice of the
              key-sorted position array
  lookup    = lower/upper bound binary search inside the bucket

The table indexes the same joined text as the FM index, so the hit set is
IDENTICAL to an exact backward search of the seed (including matches that
straddle unambiguous-run boundaries, which downstream run-interval checks
reject in both paths). Memory: 12 bytes/position + 4*2^bbits — fits HBM for
bacterial/fungal genomes; the FM path remains for mammalian-scale indexes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np


class KmerTable(NamedTuple):
    """Host-side sorted k-mer position table."""
    bucket_start: np.ndarray   # [2^bbits + 1] uint32 bucket boundaries
    keys: np.ndarray           # [n_k, 2] uint32 (hi, lo), key-sorted
    pos: np.ndarray            # [n_k] uint32 joined position of each key
    seed_len: int
    n_hi: int                  # bases packed in hi (min(seed_len, 16))
    n_lo: int                  # bases packed in lo (seed_len - n_hi)
    bbits: int                 # bucket bits taken from the top of hi
    search_steps: int          # static binary-search trip count


class DeviceKmer(NamedTuple):
    """Device-resident table arrays (a JAX pytree)."""
    bucket_start: jax.Array    # [2^bbits + 1] uint32
    keys: jax.Array            # [n_k, 2] uint32
    pos: jax.Array             # [n_k] uint32


def pack_keys(codes: np.ndarray, seed_len: int):
    """(hi, lo) uint32 keys of every window start in `codes` (0..3 values).

    hi packs the first n_hi = min(seed_len, 16) bases big-endian in its low
    2*n_hi bits; lo packs the remaining bases in its low 2*n_lo bits.
    Window starts beyond len(codes) - seed_len get arbitrary (unused) keys.

    Logarithmic doubling: w[k][i] packs bases [i, i+2^k), so each level is
    one shift-or over the full array — 4 levels reach 16 bases where the
    naive per-base loop cost 16 passes (~5x wall on multi-Mbp genomes).
    """
    n = len(codes)
    n_hi = min(seed_len, 16)
    n_lo = seed_len - n_hi
    pad = np.zeros(n + seed_len + 16, np.uint32)
    pad[:n] = codes
    w = [pad]                       # w[k]: [*, ] bases [i, i+2^k)
    for k in range(4):
        span = 1 << k
        w.append((w[k] << np.uint32(2 * span))
                 | np.concatenate([w[k][span:],
                                   np.zeros(span, np.uint32)]))

    def span_pack(start: int, length: int) -> np.ndarray:
        """Packed bases [start, start+length) for every window start."""
        out = None
        off = start
        for k in range(4, -1, -1):
            if (length >> k) & 1:
                piece = w[k][off : off + n]
                out = piece if out is None else \
                    ((out << np.uint32(2 << k)) | piece)
                off += 1 << k
        return out if out is not None else np.zeros(n, np.uint32)

    hi = span_pack(0, n_hi)
    lo = span_pack(n_hi, n_lo)
    return hi, lo, n_hi, n_lo


def build_kmer_table(joined: np.ndarray, seed_len: int,
                     bbits: int | None = None) -> KmerTable:
    """Build the sorted table over every window of the joined text."""
    n = len(joined)
    n_k = max(n - seed_len + 1, 0)
    hi, lo, n_hi, n_lo = pack_keys(joined, seed_len)
    hi, lo = hi[:n_k], lo[:n_k]
    if bbits is None:
        # ~4x buckets over keys: shaves the max-bucket size (and so the
        # fixed binary-search trip count, 2 gathers/trip); bucket array
        # capped at 2^24 (64 MB)
        bbits = min(2 * n_hi,
                    max(10, int(np.ceil(np.log2(max(n_k, 2)))) + 2), 24)
    if n_k == 0:
        # sentinel row so device gathers stay well-formed; never matched
        # (callers force the general shape when the table is degenerate)
        return KmerTable(
            bucket_start=np.zeros((1 << 10) + 1, np.uint32),
            keys=np.array([[0xFFFFFFFF, 0xFFFFFFFF]], np.uint32),
            pos=np.zeros(1, np.uint32), seed_len=seed_len,
            n_hi=n_hi, n_lo=n_lo, bbits=10, search_steps=1)
    order = np.lexsort((lo, hi)).astype(np.uint32)
    hi_s = hi[order]
    lo_s = lo[order]
    keys = np.stack([hi_s, lo_s], axis=1)
    bucket = (hi_s >> np.uint32(2 * n_hi - bbits)).astype(np.int64)
    bucket_start = np.zeros((1 << bbits) + 1, np.uint32)
    counts = np.bincount(bucket, minlength=1 << bbits)
    bucket_start[1:] = np.cumsum(counts).astype(np.uint32)
    max_bucket = int(counts.max(initial=0))
    search_steps = max(1, int(np.ceil(np.log2(max_bucket + 1))))
    return KmerTable(bucket_start=bucket_start, keys=keys,
                     pos=order, seed_len=seed_len, n_hi=n_hi, n_lo=n_lo,
                     bbits=bbits, search_steps=search_steps)


def to_device(tab: KmerTable, device=None) -> DeviceKmer:
    put = lambda x: jax.device_put(x, device)
    return DeviceKmer(bucket_start=put(tab.bucket_start),
                      keys=put(tab.keys), pos=put(tab.pos))


# ------------------------------------------------------------ cuckoo table -
#
# The sorted-table binary search costs 2 + 2*steps gathered rows per query
# lane (bucket bounds + a chained lower/upper-bound loop), so the hot-path
# replacement is a bucketized two-choice hash table: every unique seed key
# lives in one of TWO buckets of TWO 16-byte slots each, and a lookup is
# exactly 2 INDEPENDENT 32-byte row gathers + VPU compares — no chained
# steps, no data-dependent trip counts. (ref: the role of the ftab k-mer
# jump table, bt2_idx.h:1476 ftabLoHi, redesigned for gather economy.)

class CuckooTable(NamedTuple):
    """Host-side two-choice bucket hash table over unique seed keys.

    table[t] packs two slots: [hi0, lo0, start0, cnt0, hi1, lo1, start1,
    cnt1] (uint32). cnt == 0 marks an empty slot. (start, cnt) index the
    key-sorted `pos` array exactly like the sorted table's ranges."""
    table: np.ndarray          # [T, 8] uint32
    pos: np.ndarray            # [n_k] uint32 joined position of each key
    seed_len: int
    n_hi: int
    n_lo: int
    tbits: int                 # log2 of the bucket count
    salt: int


class DeviceCuckoo(NamedTuple):
    table: jax.Array           # [T, 8] uint32
    pos: jax.Array             # [n_k] uint32


_H_A = 0x9E3779B1
_H_B = 0x85EBCA77
_H_C = 0xC2B2AE3D
_H_D = 0x27D4EB2F


def _buckets(hi, lo, salt: int, tbits: int, xp):
    """The two bucket indices of a key — identical arithmetic on host
    (numpy) and device (jnp): uint32 wraparound multiply-xor mixes, top
    tbits of the product select the bucket."""
    u = lambda c: xp.uint32(c)
    hi = hi.astype(xp.uint32)
    lo = lo.astype(xp.uint32)
    x1 = ((hi * u(_H_A)) ^ (lo * u(_H_B))) + u(salt & 0xFFFFFFFF)
    x1 = (x1 ^ (x1 >> u(16))) * u(_H_C)
    x2 = ((hi * u(_H_D)) ^ (lo * u(_H_C))) + u((salt * 0x165667B1)
                                               & 0xFFFFFFFF)
    x2 = (x2 ^ (x2 >> u(15))) * u(_H_A)
    sh = u(32 - tbits)
    return (x1 >> sh).astype(xp.int32), (x2 >> sh).astype(xp.int32)


def build_cuckoo_table(joined: np.ndarray, seed_len: int,
                       max_salts: int = 6) -> CuckooTable | None:
    """Build the two-choice table; None if placement fails at every salt
    and table size (callers then keep the sorted-table path)."""
    n = len(joined)
    n_k = max(n - seed_len + 1, 0)
    if n_k == 0:
        return None
    hi, lo, n_hi, n_lo = pack_keys(joined, seed_len)
    hi, lo = hi[:n_k], lo[:n_k]
    order = np.lexsort((lo, hi)).astype(np.uint32)
    hi_s, lo_s = hi[order], lo[order]
    new = np.ones(n_k, bool)
    new[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    ustart = np.nonzero(new)[0].astype(np.uint32)
    ucnt = np.diff(np.append(ustart, n_k)).astype(np.uint32)
    uhi, ulo = hi_s[ustart], lo_s[ustart]
    n_u = len(ustart)

    tbits = max(4, int(np.ceil(np.log2(n_u))))   # <= 0.5 load of 2T slots
    for grow in range(3):
        T = 1 << tbits
        for salt in range(1, max_salts + 1):
            h1, h2 = _buckets(uhi, ulo, salt, tbits, np)
            tbl_key = np.full((T, 2), -1, np.int32)
            pending = np.arange(n_u, dtype=np.int32)
            # Batched random-walk cuckoo insertion: each round scatters
            # every pending key at its emptier bucket (last-write-wins);
            # keys whose BOTH buckets are full evict a RANDOMLY chosen
            # (bucket, slot) — per-(key, round) mixed bits, so lockstep
            # two-cycles cannot form — and the displaced occupant rejoins
            # the pending set. (2 buckets x 2 slots)-cuckoo supports >90%
            # load, so at our <=0.5 load the walk converges in ~64 rounds
            # — the old fail-on-first-full-bucket rule made 12 Mbp
            # genomes cycle every (salt, size) combo for minutes each
            # before falling back to the sorted table.
            for it in range(256):
                if not len(pending):
                    break
                b1, b2 = h1[pending], h2[pending]
                r1 = tbl_key[b1]                        # [P, 2]
                r2 = tbl_key[b2]
                o1 = (r1 >= 0).sum(1)
                o2 = (r2 >= 0).sum(1)
                pick1 = o1 <= o2
                tgt = np.where(pick1, b1, b2)
                occt = np.where(pick1[:, None], r1, r2) >= 0
                full = occt[:, 0] & occt[:, 1]
                rr = (pending.astype(np.uint32) * np.uint32(0x9E3779B1)
                      + np.uint32((it * 0x85EBCA77) & 0xFFFFFFFF))
                rr = ((rr ^ (rr >> np.uint32(15)))
                      * np.uint32(0xC2B2AE3D)) >> np.uint32(13)
                rr = rr.astype(np.int32)
                tgt = np.where(full, np.where((rr & 1) > 0, b1, b2), tgt)
                slot = np.where(occt[:, 0], 1, 0)
                slot = np.where(full, (rr >> 1) & 1, slot).astype(np.int32)
                old = tbl_key[tgt, slot]
                tbl_key[tgt, slot] = pending   # last-write-wins scatter
                landed = tbl_key[tgt, slot] == pending
                disp = old[landed]             # displaced occupants
                pending = np.concatenate(
                    [pending[~landed], disp[disp >= 0]])
            failed = bool(len(pending))
            if not failed:
                table = np.zeros((T, 8), np.uint32)
                for s in range(2):
                    occ_m = tbl_key[:, s] >= 0
                    k = tbl_key[occ_m, s]
                    table[occ_m, 4 * s + 0] = uhi[k]
                    table[occ_m, 4 * s + 1] = ulo[k]
                    table[occ_m, 4 * s + 2] = ustart[k]
                    table[occ_m, 4 * s + 3] = ucnt[k]
                return CuckooTable(table=table, pos=order,
                                   seed_len=seed_len, n_hi=n_hi, n_lo=n_lo,
                                   tbits=tbits, salt=salt)
        tbits += 1
    return None


def cuckoo_cache_path(cache_base: str, seed_len: int) -> str:
    return f"{cache_base}.k{seed_len}.cuckoo.npz"


def save_cuckoo_table(tab: CuckooTable, cache_base: str,
                      joined: np.ndarray | None = None) -> None:
    """Persist the built table next to its index (build costs ~45 s for a
    12 Mbp genome; loads are ~100 ms)."""
    import tempfile, os
    path = cuckoo_cache_path(cache_base, tab.seed_len)
    n, sig = _joined_sig(joined) if joined is not None else (0, 0)
    # atomic: concurrent processes may race on the same index
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, table=tab.table, pos=tab.pos,
                     meta=np.array([tab.seed_len, tab.n_hi, tab.n_lo,
                                    tab.tbits, tab.salt, n, sig], np.int64))
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _joined_sig(joined: np.ndarray) -> tuple[int, int]:
    """Cheap staleness signature: (length, checksum of a strided sample)."""
    sample = joined[:: max(1, len(joined) // 65536)]
    s = int((sample.astype(np.uint64)
             * (np.arange(len(sample), dtype=np.uint64)
                * np.uint64(2654435761) + np.uint64(1))).sum())
    return len(joined), s & 0x7FFFFFFFFFFFFFFF   # int64-safe


def load_cuckoo_table(cache_base: str, seed_len: int,
                      joined: np.ndarray | None = None
                      ) -> CuckooTable | None:
    try:
        z = np.load(cuckoo_cache_path(cache_base, seed_len))
        m = z["meta"]
        if int(m[0]) != seed_len:
            return None
        if joined is not None:
            n, sig = _joined_sig(joined)
            if len(m) < 7 or int(m[5]) != n or int(m[6]) != sig:
                return None   # index rebuilt at this path: stale cache
        return CuckooTable(table=z["table"], pos=z["pos"],
                           seed_len=int(m[0]), n_hi=int(m[1]),
                           n_lo=int(m[2]), tbits=int(m[3]), salt=int(m[4]))
    except (OSError, KeyError, ValueError):
        return None


def cuckoo_to_device(tab: CuckooTable, device=None) -> DeviceCuckoo:
    put = lambda x: jax.device_put(x, device)
    return DeviceCuckoo(table=put(tab.table), pos=put(tab.pos))


def cuckoo_lookup(dkc: DeviceCuckoo, q_hi, q_lo, tbits: int, salt: int):
    """Traceable batched lookup: (start, cnt) int32 row ranges into
    dkc.pos. Exactly 2 independent 32-byte row gathers per query."""
    import jax.numpy as jnp

    q_hi = q_hi.astype(jnp.uint32)
    q_lo = q_lo.astype(jnp.uint32)
    h1, h2 = _buckets(q_hi, q_lo, salt, tbits, jnp)
    r1 = dkc.table[h1]                                   # [Q, 8] uint32
    r2 = dkc.table[h2]
    start = jnp.zeros(q_hi.shape, jnp.uint32)
    cnt = jnp.zeros(q_hi.shape, jnp.uint32)
    for r in (r1, r2):
        for s in (0, 4):
            m = ((r[:, s] == q_hi) & (r[:, s + 1] == q_lo)
                 & (r[:, s + 3] > 0))
            start = jnp.where(m, r[:, s + 2], start)
            cnt = jnp.where(m, r[:, s + 3], cnt)
    return start.astype(jnp.int32), cnt.astype(jnp.int32)


def lookup_body(dkm: DeviceKmer, q_hi, q_lo, n_hi: int, bbits: int,
                steps: int):
    """Traceable batched lookup: (start, cnt) row ranges into dkm.pos for
    each (hi, lo) query key. Invalid queries must be masked by the caller
    (they return some range; gate on your own validity).

    Lower and upper bound run in the same fixed-trip loop: 2 key-row
    gathers per step, `steps` = ceil(log2(max_bucket+1)) from the table.
    """
    import jax.numpy as jnp

    q_hi = q_hi.astype(jnp.uint32)
    q_lo = q_lo.astype(jnp.uint32)
    bucket = (q_hi >> jnp.uint32(2 * n_hi - bbits)).astype(jnp.int32)
    bucket = jnp.clip(bucket, 0, dkm.bucket_start.shape[0] - 2)
    b0 = dkm.bucket_start[bucket].astype(jnp.int32)
    b1 = dkm.bucket_start[bucket + 1].astype(jnp.int32)
    n_k = dkm.keys.shape[0]

    def body(_, carry):
        lo_l, hi_l, lo_u, hi_u = carry
        mid_l = (lo_l + hi_l) >> 1
        mid_u = (lo_u + hi_u) >> 1
        kl_ = dkm.keys[jnp.clip(mid_l, 0, n_k - 1)]     # [Q, 2]
        ku_ = dkm.keys[jnp.clip(mid_u, 0, n_k - 1)]
        less = (kl_[:, 0] < q_hi) | ((kl_[:, 0] == q_hi)
                                     & (kl_[:, 1] < q_lo))
        leq = (ku_[:, 0] < q_hi) | ((ku_[:, 0] == q_hi)
                                    & (ku_[:, 1] <= q_lo))
        open_l = lo_l < hi_l
        open_u = lo_u < hi_u
        lo_l = jnp.where(open_l & less, mid_l + 1, lo_l)
        hi_l = jnp.where(open_l & ~less, mid_l, hi_l)
        lo_u = jnp.where(open_u & leq, mid_u + 1, lo_u)
        hi_u = jnp.where(open_u & ~leq, mid_u, hi_u)
        return lo_l, hi_l, lo_u, hi_u

    lo_l, _, lo_u, _ = jax.lax.fori_loop(
        0, steps, body, (b0, b1, b0, b1))
    return lo_l, jnp.maximum(lo_u - lo_l, 0)
