"""Microbench the fused pipeline's stage primitives at bench shapes."""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from bowtie2_server_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

B, L, S, R, E = 8192, 128, 8, 2, 16
NH, C_pre, C_max = 8 * B, 16 * B, 4 * B
rng = np.random.default_rng(0)


def timeit(name, fn, *args, reps=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    print(f"{name}: {(time.time()-t0)/reps*1e3:.1f}ms")


# 1. two-key sort at C_pre
a = jnp.asarray(rng.integers(0, 1 << 30, C_pre).astype(np.int32))
b = jnp.asarray(rng.integers(0, 1 << 30, C_pre).astype(np.int32))
timeit("sort2 C_pre=131k", jax.jit(
    lambda x, y: jax.lax.sort((x, y), num_keys=2)), a, b)

# 2. nonzero(size) over NH*E = 1M
ev = jnp.asarray(rng.random(NH * E) < 0.02)
timeit("nonzero 1M->C_pre", jax.jit(
    lambda v: jnp.nonzero(v, size=C_pre, fill_value=NH * E)[0]), ev)

# 2b. nonzero over NR ~ 262k -> NH
nr = 2 * B * S * R
hv = jnp.asarray(rng.random(nr) < 0.05)
timeit("nonzero 262k->NH", jax.jit(
    lambda v: jnp.nonzero(v, size=NH, fill_value=nr)[0]), hv)

# 3. kmer binary search at 2BS lanes
from bowtie2_server_tpu.index import kmer as kmod
joined = rng.integers(0, 4, 4_000_000).astype(np.uint8)
tab = kmod.build_kmer_table(joined, 22)
dkm = kmod.to_device(tab)
q = 2 * B * S
qh = jnp.asarray(rng.integers(0, 1 << 32, q, dtype=np.uint64
                              ).astype(np.uint32))
ql = jnp.asarray(rng.integers(0, 1 << 12, q, dtype=np.uint64
                              ).astype(np.uint32))
print(f"kmer steps={tab.search_steps} bbits={tab.bbits}")
timeit("kmer lookup 131k lanes", jax.jit(
    lambda a_, b_: kmod.lookup_body(dkm, a_, b_, tab.n_hi, tab.bbits,
                                    tab.search_steps)), qh, ql)

# 4. band word gather + 16-shift select at C_max
W = L + 32
nw = W // 16 + 2
jw = jnp.asarray(rng.integers(0, 1 << 32, 4_000_000 // 16 + 1,
                              dtype=np.uint64).astype(np.uint32))
ws = jnp.asarray(rng.integers(0, 3_900_000, C_max).astype(np.int32))


def band_gather(jw_, ws_):
    w0 = ws_ >> 4
    sh = ws_ & 15
    wgat = jw_[jnp.clip(w0[:, None] + jnp.arange(nw)[None, :], 0,
                        jw_.shape[0] - 1)]
    unp = jnp.stack([(wgat >> jnp.uint32(2 * t)) & jnp.uint32(3)
                     for t in range(16)], axis=2)
    unp = unp.reshape(C_max, nw * 16).astype(jnp.int32)
    band = jnp.zeros((C_max, W), jnp.int32)
    for k in range(16):
        band = band + jnp.where((sh == k)[:, None], unp[:, k:k + W], 0)
    return band


timeit("band word-gather 32k", jax.jit(band_gather), jw, ws)

# 5. rolling keys
codes = jnp.asarray(rng.integers(0, 4, (B, L)).astype(np.uint32))
from bowtie2_server_tpu.align.candgen import _rolling_keys
timeit("rolling keys 16+6 x2", jax.jit(
    lambda c: (_rolling_keys(c, 16, 0, False), _rolling_keys(c, 6, 16,
                                                             False),
               _rolling_keys(c, 16, 0, True), _rolling_keys(c, 6, 16,
                                                            True))), codes)

# 6. segment ops at C_max
data = jnp.asarray(rng.integers(-100, 100, C_max).astype(np.int32))
ids = jnp.asarray(rng.integers(0, B, C_max).astype(np.int32))
timeit("segment_max x5 at 32k", jax.jit(
    lambda d, i: [jax.ops.segment_max(d + k, i, num_segments=B)
                  for k in range(5)]), data, ids)

# 7. SA gather at C_pre
sa = jnp.asarray(rng.integers(0, 4_000_000, 4_000_001).astype(np.int32))
rows = jnp.asarray(rng.integers(0, 4_000_000, C_pre).astype(np.int32))
timeit("SA gather 131k", jax.jit(lambda s, r: s[r]), sa, rows)

# 8. seed-schedule/unpack/rc prologue at B x L

# 9. fori_loop of L chained lf-ish gathers (the removed exact sweep, approx)
side = jnp.asarray(rng.integers(0, 1 << 32, (125_000, 8),
                                dtype=np.uint64).astype(np.uint32))


def sweep(side_, c0):
    def body(s, carry):
        t, b_ = carry
        blk = jnp.clip((t + s) % 125_000, 0, 124_999)
        row = side_[blk]
        t2 = (t + row[:, 0].astype(jnp.int32) + s) % 4_000_000
        return t2, b_

    return jax.lax.fori_loop(0, L, body, (c0, c0))


c0 = jnp.asarray(rng.integers(0, 4_000_000, 2 * B).astype(np.int32))
timeit("L=128 chained gather loop 16k lanes", jax.jit(sweep), side, c0)
