"""Banded DP microbench: cells/s of the banded engine the fused program
uses (the XLA scan `_banded_tile_xla`) at its shape — K=64 band,
C = 32768 + 1024 candidate lanes, 100 bp reads padded to L=128 — on the
default device.

Times each call to `block_until_ready` (median of REPEATS after one
warm-up call) and prints one JSON line with the device and cells/s. There
is no roofline fraction: the DP is int32 compare/select/add work whose
bound on the card is not modelled yet.

Run: python scripts/bench_dp.py [--local] [--L 128]
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

REPEATS = 10
K = 64
C = 32768 + 1024


def make_inputs(C: int, L: int, K: int, seed: int = 3):
    """Planted problems in the fused layout: rd_t/mm_t [L, C], lens [C],
    band_t [L+K, C] int32; 100 bp reads with a few substitutions."""
    rng = np.random.default_rng(seed)
    band = rng.integers(0, 4, (C, L + K)).astype(np.int32)
    n = min(L, 100)
    lens = np.full(C, n, np.int32)
    rd = np.full((C, L), 5, np.int32)
    rd[:, :n] = band[:, K // 2 : K // 2 + n]
    sub = rng.random((C, n)) < 0.03
    rd[:, :n][sub] = rng.integers(0, 4, int(sub.sum()))
    mm = np.full((C, L), 6, np.int32)
    return rd.T.copy(), mm.T.copy(), lens, band.T.copy()


def run(L: int = 128, local: bool = False, quiet: bool = False) -> float:
    """Cells/s of the banded engine on the default device."""
    import functools

    import jax

    from bowtie2_server_tpu.ops.sw import SwConfig
    from bowtie2_server_tpu.ops.sw_banded import _banded_tile_xla

    cfg = SwConfig(ma=2, local=True) if local else SwConfig()
    args = [jax.device_put(a) for a in make_inputs(C, L, K)]
    f = jax.jit(functools.partial(_banded_tile_xla, cfg, K))
    t0 = time.perf_counter()
    jax.block_until_ready(f(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    med = float(np.median(ts))
    if not quiet:
        print(f"# banded xla: {med * 1e3:.3f} ms/call (min "
              f"{min(ts) * 1e3:.3f}, first call {first:.1f} s), "
              f"{C * L * K / med / 1e9:.2f} Gcells/s", file=sys.stderr)
    return C * L * K / med


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--L", type=int, default=128)
    a = ap.parse_args()
    import jax
    d = jax.devices()
    if d[0].platform != "gpu":
        sys.exit(f"bench_dp: no GPU (JAX found {d[0].platform})")
    cps = run(L=a.L, local=a.local)
    print(json.dumps({
        "metric": "dp_banded_cells_per_s", "value": round(cps, 1),
        "unit": "cells/s",
        "shape": {"L": a.L, "K": K, "C": C, "local": a.local},
        "device": {"platform": d[0].platform, "kind": d[0].device_kind,
                   "count": len(d)}}))


if __name__ == "__main__":
    main()
