"""Multi-device scaling (ref: §2.3 of the survey — the reference's only
parallel axis is read-level data parallelism over threads; here it is
read-sharded SPMD over a 1-D 'dp' device mesh with a replicated index).

`device_align_step` is the fused, fully-jittable device step: exact FM
backward search -> first-hit SA resolve -> banded DP score of the implied
diagonal. It is the unit that shards: reads split along the `dp` mesh axis,
the FM index + reference replicated (they fit in one device's memory for
bacterial/fungal genomes), and a reduction merges per-shard aligned
counts.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.fm import DeviceFm, _backward_search_impl, _sa_resolve_impl
from ..ops.sw import SwConfig
from ..ops.sw_banded import _banded_tile_xla


def device_align_step(cfg: SwConfig, K: int, fm: DeviceFm, joined,
                      reads, lens, mmpen):
    """One fused alignment step (jittable): [B, L] reads -> per-read best
    DP score along the top exact/seed diagonal + its joined offset."""
    B, L = reads.shape
    top, bot = _backward_search_impl(fm, reads, lens, use_ftab=False)
    offs = _sa_resolve_impl(fm, top, jnp.minimum(bot - top, 1), 1)[:, 0]
    diag = jnp.where(offs >= 0, offs, 0)
    c_half = K // 2
    cols = diag[:, None] - c_half + jnp.arange(L + K)[None, :]
    band = jnp.where((cols >= 0) & (cols < joined.shape[0]),
                     joined[jnp.clip(cols, 0, joined.shape[0] - 1)], 4)
    rd_t = jnp.transpose(reads).astype(jnp.int32)
    mm_t = jnp.transpose(mmpen).astype(jnp.int32)
    band_t = jnp.transpose(band).astype(jnp.int32)
    best, bi, bk = _banded_tile_xla(cfg, K, rd_t, mm_t,
                                    lens.astype(jnp.int32), band_t)
    return best, offs


def make_sharded_step(mesh: Mesh, cfg: SwConfig, K: int):
    """jit the full step over the mesh: reads sharded on 'dp', index
    replicated, plus an all-reduce of the aligned count."""
    def step(fm, joined, reads, lens, mmpen, minsc):
        best, offs = device_align_step(cfg, K, fm, joined, reads, lens, mmpen)
        n_aligned = jnp.sum((best >= minsc).astype(jnp.int32))
        # a reduction over dp-sharded inputs: the partitioner lowers it to
        # an all-reduce over the mesh
        return best, offs, n_aligned

    repl = NamedSharding(mesh, P())
    shard_b = NamedSharding(mesh, P("dp"))
    return jax.jit(
        step,
        in_shardings=(None, repl, shard_b, shard_b, shard_b, None),
        out_shardings=(shard_b, shard_b, repl),
    )


def dryrun_multichip(n_devices: int) -> None:
    """Build an n-device mesh, jit the full sharded step, run one step on
    tiny shapes (used by the driver on a virtual CPU mesh)."""
    devs = np.array(jax.devices()[:n_devices])
    mesh = Mesh(devs, ("dp",))
    cfg = SwConfig()
    K = 32
    B, L = 8 * n_devices, 32

    # tiny synthetic index
    from ..index.build import build_index
    from ..ops.fm import to_device
    from ..utils import dna
    rng = np.random.default_rng(0)
    text = dna.decode(rng.integers(0, 4, 2048).astype(np.uint8))
    idx = build_index(f">r\n{text}\n", both_directions=False)
    fm = to_device(idx.fw)
    joined = jnp.asarray(idx.joined)

    reads = np.zeros((B, L), np.uint8)
    for b in range(B):
        s = rng.integers(0, idx.n - L)
        reads[b] = idx.joined[s : s + L]
    lens = np.full(B, L, np.int32)
    mmpen = np.full((B, L), 6, np.int32)

    step = make_sharded_step(mesh, cfg, K)
    best, offs, n_aligned = step(fm, joined, jnp.asarray(reads),
                                 jnp.asarray(lens), jnp.asarray(mmpen),
                                 jnp.int32(-100))
    jax.block_until_ready(best)
    assert int(n_aligned) == B, f"{int(n_aligned)} != {B}"
    assert best.shape == (B,)


# ---- the REAL pipeline over a mesh (round 2) -------------------------------
# The fused candidate pipeline (align/candgen.py) runs under shard_map with
# reads sharded on the 'dp' axis and the index replicated; the aligner takes
# a mesh= argument and every batch transparently fans out. These helpers
# build the mesh and drive a full alignment for the driver's dryrun.

def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def dryrun_full_pipeline(n_devices: int) -> None:
    """Drive the REAL UnpairedAligner (exact+1mm+seeds+DP+selection) over an
    n-device mesh and assert the results equal the single-device run."""
    from ..align.pipeline import UnpairedAligner
    from ..index.build import build_index
    from ..io.fastq import make_batch
    from ..utils import dna

    rng = np.random.default_rng(7)
    text = dna.decode(rng.integers(0, 4, 20000).astype(np.uint8))
    idx = build_index(f">chr\n{text}\n")

    B, L = 8 * n_devices, 50
    names, seqs, quals = [], [], []
    for b in range(B):
        s = rng.integers(0, idx.n - L)
        rd = idx.joined[s : s + L].copy()
        if b % 3 == 0:
            rd[rng.integers(0, L)] = rng.integers(0, 4)
        if b % 2 == 0:
            rd = dna.revcomp(rd)
        names.append(f"r{b}")
        seqs.append(dna.decode(rd).encode())
        quals.append(b"I" * L)
    batch = make_batch(names, seqs, quals)

    mesh = make_mesh(n_devices)
    al_mesh = UnpairedAligner(idx, mesh=mesh)
    al_one = UnpairedAligner(idx)
    recs_m = al_mesh.align_batch(batch)
    recs_1 = al_one.align_batch(batch)
    assert len(recs_m) == len(recs_1)
    n_aligned = 0
    for rm, r1 in zip(recs_m, recs_1):
        t_m = (rm.aligned, rm.fw, rm.ref_id, rm.pos, rm.score, rm.cigar,
               rm.md, rm.mapq)
        t_1 = (r1.aligned, r1.fw, r1.ref_id, r1.pos, r1.score, r1.cigar,
               r1.md, r1.mapq)
        assert t_m == t_1, f"{rm.name}: {t_m} != {t_1}"
        n_aligned += rm.aligned
    assert n_aligned >= B * 3 // 4, f"only {n_aligned}/{B} aligned"
