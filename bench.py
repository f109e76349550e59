"""Benchmark driver: end-to-end unpaired alignment throughput on one device.

Workload: synthetic 4 Mbp genome (E. coli scale), 100 bp reads with 0-3
mutations, 50% reverse-complemented — the shape of BASELINE.json config 3.

Prints the device line (JAX platform, device kind and count, and the
card's name and power limit from nvidia-smi), then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", ...}. A failing leg
fails the run.

Baseline: the reference bowtie2-server fork (server+client pair, 2 worker
threads) measured on a 2-core CPU host at 31,056 reads/s for the same
workload (100k reads / 3.22 s, 2026-08-17). vs_baseline is ours/reference
on a per-device vs 2-core-CPU basis.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REFERENCE_CPU_READS_PER_S = 31056.0  # measured, see module docstring
N_READS = 491_520          # 15 batches: 1 warmup + 14 measured
READ_LEN = 100
GENOME_LEN = 4_000_000
BATCH = 32768


def make_workload(tmp: Path, n_reads: int = N_READS):
    """Seeded workload: writes the genome FASTA (once) and returns
    (fasta, names, seqs, quals, starts, rc) — starts/rc are each read's
    0-based origin on the genome and whether it was reverse-complemented
    (the reads carry substitutions only, so an aligner places them there)."""
    rng = np.random.default_rng(42)
    g = rng.integers(0, 4, GENOME_LEN).astype(np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    fa = tmp / "bench_genome.fa"
    if not fa.exists():
        with open(fa, "w") as f:
            f.write(">benchref\n")
            s = bases[g].tobytes().decode()
            for i in range(0, len(s), 70):
                f.write(s[i : i + 70] + "\n")
    starts = rng.integers(0, GENOME_LEN - READ_LEN, n_reads)
    reads = g[starts[:, None] + np.arange(READ_LEN)]       # [N, L]
    nmut = rng.integers(0, 4, n_reads)
    for k in range(3):                  # 0-3 point mutations per read
        m = nmut > k
        pos = rng.integers(0, READ_LEN, n_reads)
        val = rng.integers(0, 4, n_reads).astype(np.uint8)
        reads[m, pos[m]] = val[m]
    rc = rng.random(n_reads) < 0.5
    reads[rc] = (3 - reads[rc])[:, ::-1]
    arr = bases[reads]
    names = [f"b{i}" for i in range(n_reads)]
    seqs = [row.tobytes() for row in arr]
    quals = [b"I" * READ_LEN] * n_reads
    return fa, names, seqs, quals, starts, rc


def device_line() -> str:
    """JAX's view of the devices plus the card's name and power limit."""
    import jax
    d = jax.devices()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        card = "; ".join(smi.stdout.split("\n")).strip("; ") \
            if smi.returncode == 0 else "nvidia-smi failed"
    except OSError:
        card = "no nvidia-smi"
    return (f"# device: {d[0].platform} {d[0].device_kind} x{len(d)}; "
            f"card: {card}")


def main():
    from bowtie2_server_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    tmp = Path("tmp")
    tmp.mkdir(exist_ok=True)
    print(device_line(), file=sys.stderr)
    fa, names, seqs, quals, _, _ = make_workload(tmp)

    from bowtie2_server_tpu.align.pipeline import UnpairedAligner
    from bowtie2_server_tpu.index.build import build_index
    from bowtie2_server_tpu.index.fm import FmIndex
    from bowtie2_server_tpu.io.fastq import make_batch

    idx_base = tmp / "bench_genome_idx"
    if (Path(str(idx_base) + ".fm.npz")).exists():
        idx = FmIndex.load(idx_base)
    else:
        idx = build_index(fa)
        idx.save(idx_base)
    al = UnpairedAligner(idx)

    batches = [
        make_batch(names[i : i + BATCH], seqs[i : i + BATCH],
                   quals[i : i + BATCH])
        for i in range(0, N_READS, BATCH)
    ]
    # warmup/compile on the first batch
    def count_aligned(recs):
        return (recs.n_aligned() if hasattr(recs, "n_aligned")
                else sum(r.aligned for r in recs))

    recs = al.align_batch(batches[0])
    n_aligned = count_aligned(recs)
    t0 = time.time()
    n = len(batches[0])
    # pipelined: the device works on the next batches while the host
    # finishes batch i
    from collections import deque
    inflight = deque()
    DEPTH = 4
    for b in batches[1:]:
        inflight.append(al.align_async(b))
        n += len(b)
        if len(inflight) >= DEPTH:
            recs = al.align_wait(inflight.popleft())
            n_aligned += count_aligned(recs)
    while inflight:
        recs = al.align_wait(inflight.popleft())
        n_aligned += count_aligned(recs)
    dt = time.time() - t0
    reads_per_s = (n - len(batches[0])) / dt
    d = jax.devices()
    out = {
        "metric": "unpaired_align_reads_per_s_per_chip",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / REFERENCE_CPU_READS_PER_S, 4),
        "device": {"platform": d[0].platform, "kind": d[0].device_kind,
                   "count": len(d)},
    }
    print(f"# aligned {n_aligned}/{n} reads; warm batches {len(batches)-1}, "
          f"{dt:.1f}s", file=sys.stderr)
    # paired throughput rides along in the same JSON line (BASELINE
    # configs 3 + 4)
    if os.environ.get("BENCH_SKIP_PAIRED", "") != "1":
        import bench_paired
        pps = bench_paired.run(quiet=True)
        out["paired_pairs_per_s"] = round(pps, 1)
        out["paired_vs_baseline"] = round(
            pps / bench_paired.REFERENCE_CPU_PAIRS_PER_S, 4)
    # banded DP engine cells/s at the fused shape (scripts/bench_dp.py)
    if os.environ.get("BENCH_SKIP_DP", "") != "1":
        sys.path.insert(0, str(Path(__file__).resolve().parent
                               / "scripts"))
        import bench_dp
        out["dp_banded_cells_per_s"] = round(bench_dp.run(quiet=True), 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
