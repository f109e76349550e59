"""Stage-level timing of the fused pipeline on the device.

Times: (a) full dispatch+device, (b) device with engine='nodp' (no DP),
(c) host decode/finish, at a few batch sizes.
"""
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

from bowtie2_server_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from bench import make_workload
from bowtie2_server_tpu.align.pipeline import UnpairedAligner
from bowtie2_server_tpu.index.fm import FmIndex
from bowtie2_server_tpu.io.fastq import make_batch

tmp = Path("tmp")
fa, names, seqs, quals, _, _ = make_workload(tmp)
idx = FmIndex.load(tmp / "bench_genome_idx")

import os
sizes = tuple(int(s) for s in
              os.environ.get("PROF_SIZES", "8192").split(","))
for BATCH in sizes:
    al = UnpairedAligner(idx)
    batch = make_batch(names[:BATCH], seqs[:BATCH], quals[:BATCH])

    # full path warmup
    recs = al.align_batch(batch)
    n_rep = 5

    # (a) device-only: dispatch + block
    h = al.collect_async(batch)
    out = h[4][1]
    out.block_until_ready()
    t0 = time.time()
    for _ in range(n_rep):
        h = al.collect_async(batch)
        h[4][1].block_until_ready()
    t_dev = (time.time() - t0) / n_rep

    # (c) host decode + finish given a ready handle
    t0 = time.time()
    for _ in range(n_rep):
        st = al.collect_wait(h)
        al._finish_fast(st)
    t_host = (time.time() - t0) / n_rep

    # (b) nodp variant
    if os.environ.get("PROF_NODP", "1") == "1":
        al2 = UnpairedAligner(idx)
        al2.candgen.engine = "nodp"
        h2 = al2.collect_async(batch)
        h2[4][1].block_until_ready()
        t0 = time.time()
        for _ in range(n_rep):
            h2 = al2.collect_async(batch)
            h2[4][1].block_until_ready()
        t_nodp = (time.time() - t0) / n_rep
    else:
        t_nodp = t_dev

    print(f"B={BATCH}: device={t_dev*1e3:.1f}ms (dp={1e3*(t_dev-t_nodp):.1f} "
          f"nodp={t_nodp*1e3:.1f}) host={t_host*1e3:.1f}ms "
          f"-> {BATCH/max(t_dev, t_host):.0f} reads/s overlapped")
    res = al.candgen.fetch(h[4])
    print(f"  counters [n_cand n_elts cnt_fw cnt_mr n_hit . . .]: "
          f"{res.counters.tolist()}")
