"""Paired-end benchmark — BASELINE config 4 shape (multi-chromosome
fungal-scale genome, 150 bp FR pairs).

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"}.
Baseline: reference server+client pair on a 2-core CPU host for the same
workload (the documented 2026-08-19 measurement, or REF_PAIRS_PER_S).
"""
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REFERENCE_CPU_PAIRS_PER_S = float(
    os.environ.get("REF_PAIRS_PER_S", "5327"))
# measured 2026-08-19: reference server+client (-p 2) on a 2-core CPU host,
# 40960 synthetic 150bp FR pairs vs the 12 Mbp genome: 7.7 s
N_PAIRS = int(os.environ.get("BENCH_PAIRS", "196608"))  # 12 batches:
# 1 warmup + 11 measured
READ_LEN = 150
CHROMS = 8
CHROM_LEN = 1_500_000          # 12 Mbp total (S. cerevisiae scale)
BATCH = 16384
FRAG_MU, FRAG_SD = 350, 40


def make_workload(tmp: Path, n_pairs: int = N_PAIRS):
    """Seeded FR pairs: writes the genome FASTA (once) and returns
    (fasta, mate1, mate2), each mate as (names, seqs, quals)."""
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    chroms = [rng.integers(0, 4, CHROM_LEN).astype(np.uint8)
              for _ in range(CHROMS)]
    fa = tmp / "bench_yeast.fa"
    if not fa.exists():
        with open(fa, "w") as f:
            for ci, g in enumerate(chroms):
                f.write(f">chr{ci+1}\n")
                s = bases[g].tobytes().decode()
                for i in range(0, len(s), 70):
                    f.write(s[i : i + 70] + "\n")
    ql = b"I" * READ_LEN
    gall = np.stack(chroms)                                  # [C, CHROM_LEN]
    ci = rng.integers(0, CHROMS, n_pairs)
    frag = np.clip(rng.normal(FRAG_MU, FRAG_SD, n_pairs),
                   2 * READ_LEN, 600).astype(np.int64)
    st = (rng.random(n_pairs) * (CHROM_LEN - frag)).astype(np.int64)
    offs = np.arange(READ_LEN)
    m1 = gall[ci[:, None], st[:, None] + offs]               # [N, L]
    m2 = 3 - gall[ci[:, None],
                  (st + frag - READ_LEN)[:, None] + offs][:, ::-1]
    for m in (m1, m2):
        nmut = rng.integers(0, 4, n_pairs)
        for k in range(3):
            sel = nmut > k
            pos = rng.integers(0, READ_LEN, n_pairs)
            val = rng.integers(0, 4, n_pairs).astype(m.dtype)
            m[sel, pos[sel]] = val[sel]
    names = [f"p{i}" for i in range(n_pairs)]
    s1 = [row.tobytes() for row in bases[m1]]
    s2 = [row.tobytes() for row in bases[m2]]
    qs = [ql] * n_pairs
    return fa, (names, s1, qs), (list(names), s2, qs)


def dump_fastq(tmp: Path):
    """Write the workload as FASTQ pair files (for the reference baseline
    measurement)."""
    fa, m1, m2 = make_workload(tmp)
    for tag, (nn, ss, qq) in (("1", m1), ("2", m2)):
        with open(tmp / f"bench_p{tag}.fq", "w") as f:
            for nm, sq, ql in zip(nn, ss, qq):
                f.write(f"@{nm}\n{sq.decode()}\n+\n{ql.decode()}\n")
    print(f"wrote tmp/bench_p1.fq tmp/bench_p2.fq ({len(m1[0])} pairs)")


def main():
    if "--dump-fq" in sys.argv:
        dump_fastq(Path("tmp"))
        return
    run(quiet=False)


def run(quiet: bool = False) -> float:
    """Run the paired workload; returns pairs/s. With quiet, prints only
    the trailing comment (bench.py embeds the number in its own JSON)."""
    from bowtie2_server_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    tmp = Path("tmp")
    tmp.mkdir(exist_ok=True)
    fa, m1, m2 = make_workload(tmp)

    from bowtie2_server_tpu.align.paired import PairedAligner
    from bowtie2_server_tpu.index.build import build_index
    from bowtie2_server_tpu.index.fm import FmIndex
    from bowtie2_server_tpu.io.fastq import make_batch

    idx_base = tmp / "bench_yeast_idx"
    if Path(str(idx_base) + ".fm.npz").exists():
        idx = FmIndex.load(idx_base)
    else:
        idx = build_index(fa)
        idx.save(idx_base)
    pal = PairedAligner(idx)

    b1s = [make_batch(m1[0][i:i + BATCH], m1[1][i:i + BATCH],
                      m1[2][i:i + BATCH])
           for i in range(0, N_PAIRS, BATCH)]
    b2s = [make_batch(m2[0][i:i + BATCH], m2[1][i:i + BATCH],
                      m2[2][i:i + BATCH])
           for i in range(0, N_PAIRS, BATCH)]
    def count_con(pairs):
        if hasattr(pairs, "n_concordant"):
            return pairs.n_concordant()
        return sum(1 for r1, _ in pairs if r1.proper)

    # warmup/compile
    pairs = pal.align_batch(b1s[0], b2s[0])
    n_con = count_con(pairs)
    t0 = time.time()
    n = 0
    # depth-2 pipelining: device works on pair-batch i+1 while the host
    # finishes i (mirrors bench.py's unpaired loop)
    from collections import deque
    inflight = deque()
    for b1, b2 in zip(b1s[1:], b2s[1:]):
        inflight.append((len(b1.names), pal.align_async(b1, b2)))
        if len(inflight) >= 2:
            nb, h = inflight.popleft()
            n_con += count_con(pal.align_wait(h))
            n += nb
    while inflight:
        nb, h = inflight.popleft()
        n_con += count_con(pal.align_wait(h))
        n += nb
    dt = time.time() - t0
    pps = n / dt
    if not quiet:
        print(json.dumps({
            "metric": "paired_align_pairs_per_s_per_chip",
            "value": round(pps, 1), "unit": "pairs/s",
            "vs_baseline": round(pps / REFERENCE_CPU_PAIRS_PER_S, 4)}))
    print(f"# {n_con}/{n + len(b1s[0])} concordant; {n} pairs in {dt:.1f}s",
          file=sys.stderr)
    return pps


if __name__ == "__main__":
    main()
