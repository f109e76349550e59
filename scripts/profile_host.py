"""cProfile the host side of one fused batch (decode + finish)."""
import cProfile
import pstats
import sys
import time
from pathlib import Path

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
BATCH = 32768
al = UnpairedAligner(idx)
batch = make_batch(names[:BATCH], seqs[:BATCH], quals[:BATCH])
al.align_batch(batch)  # warmup

h = al.collect_async(batch)
h[4][1].block_until_ready()

t0 = time.time()
res = al.candgen.fetch(h[4])
t_fetch = time.time() - t0
t0 = time.time()
st = al._build_state(batch, res, h[5])
t_build = time.time() - t0
t0 = time.time()
handled = al._finish_fast(st)
t_fin = time.time() - t0
t0 = time.time()
out = [st.recs[i] for i in range(st.B)]
n_un = int((~handled).sum())
print(f"fetch={t_fetch*1e3:.1f}ms build={t_build*1e3:.1f}ms "
      f"finish={t_fin*1e3:.1f}ms unhandled={n_un}")

pr = cProfile.Profile()
pr.enable()
st = al.collect_wait(h)
al._finish_fast(st)
pr.disable()
stats = pstats.Stats(pr)
stats.sort_stats("cumulative").print_stats(25)
