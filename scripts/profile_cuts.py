"""Device-time bisection of the fused pipeline via cut engines.

Steady-state measurement: keep DEPTH batches in flight and time N waits —
the per-batch wall time then equals max(device program, host prep), which
is the number that actually bounds end-to-end throughput. Report the min
over repeats.
"""
import os
import sys
import time
from collections import deque
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

from bowtie2_server_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from bench import make_workload
from bowtie2_server_tpu.align.pipeline import UnpairedAligner
from bowtie2_server_tpu.index.fm import FmIndex
from bowtie2_server_tpu.io.fastq import make_batch

tmp = Path("tmp")
fa, names, seqs, quals, _, _ = make_workload(tmp)
idx = FmIndex.load(tmp / "bench_genome_idx")
BATCH = int(os.environ.get("CUT_BATCH", "32768"))
NB = int(os.environ.get("CUT_NBATCH", "8"))
DEPTH = 3
batches = [make_batch(names[i:i + BATCH], seqs[i:i + BATCH],
                      quals[i:i + BATCH])
           for i in range(0, NB * BATCH, BATCH)]

engines = os.environ.get(
    "ENGINES", "cut_seeds,cut_resolve,cut_dedup,cut_band,nodp,xla"
).split(",")
for eng in engines:
    al = UnpairedAligner(idx, engine=eng)
    # warm/compile
    h = al.collect_async(batches[0])
    h[4][1].block_until_ready()
    best = 1e9
    for rep in range(3):
        inflight = deque()
        t0 = time.time()
        n_done = 0
        for b in batches:
            inflight.append(al.collect_async(b))
            if len(inflight) >= DEPTH:
                inflight.popleft()[4][1].block_until_ready()
                n_done += 1
        while inflight:
            inflight.popleft()[4][1].block_until_ready()
            n_done += 1
        dt = (time.time() - t0) / n_done
        best = min(best, dt)
    print(f"{eng}: {best * 1e3:.1f} ms/batch "
          f"({BATCH / best:,.0f} reads/s)", flush=True)
