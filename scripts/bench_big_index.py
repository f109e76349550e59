"""Big-index (.bt2l-scale) end-to-end demonstration: build a synthetic
joined text just past 2^31 bp (the int32 offset ceiling — the regime the
reference serves with its `-l` / BOWTIE_64BIT_INDEX build line, btypes.h,
Makefile:239-246), load it on ONE chip via the uint32-row + sampled-SA
device path, and align a 100k-read batch.

Artifacts are cached under tmp/bigidx/ (raw .npy, ~25 GB) so reruns skip
the ~1-2 h host SA-IS build. Run: python scripts/bench_big_index.py
[--n-reads 100000] [--cpu]

Prints one JSON line with throughput and the measured HBM budget; see
docs/BIGINDEX.md for the recorded numbers.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np

N = (1 << 31) + (1 << 20)          # 2,148,532,224 bp > int32 max
CACHE = Path("tmp/bigidx")
READ_LEN = 100


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def build_or_load():
    from bowtie2_server_tpu.index.build import _build_direction, \
        suffix_array
    from bowtie2_server_tpu.index.fm import FmDirection, FmIndex

    CACHE.mkdir(parents=True, exist_ok=True)
    done = CACHE / "DONE"
    if not done.exists():
        rng = np.random.default_rng(3)
        log(f"generating {N/1e9:.3f} Gbp text")
        g = rng.integers(0, 4, N, dtype=np.int64).astype(np.uint8)
        np.save(CACHE / "joined.npy", g)
        for tag, text in (("fw", g), ("mirror", g[::-1].copy())):
            log(f"SA-IS ({tag}) over {N/1e9:.2f} Gbp ...")
            t0 = time.time()
            sa = suffix_array(text)
            log(f"SA-IS ({tag}) done in {time.time()-t0:.0f}s")
            d = _build_direction(text, sa)
            del sa
            np.save(CACHE / f"{tag}_bwt.npy", d.bwt)
            np.save(CACHE / f"{tag}_occ.npy", d.occ)
            np.save(CACHE / f"{tag}_cnt.npy", d.cnt)
            np.save(CACHE / f"{tag}_sa.npy", d.sa)
            np.save(CACHE / f"{tag}_ftab_top.npy", d.ftab_top)
            np.save(CACHE / f"{tag}_ftab_bot.npy", d.ftab_bot)
            (CACHE / f"{tag}_primary.txt").write_text(str(d.primary))
            del d
        done.write_text("ok")
        log("index cached")

    def load_dir(tag):
        return FmDirection(
            bwt=np.load(CACHE / f"{tag}_bwt.npy", mmap_mode="r"),
            occ=np.load(CACHE / f"{tag}_occ.npy"),
            cnt=np.load(CACHE / f"{tag}_cnt.npy"),
            sa=np.load(CACHE / f"{tag}_sa.npy", mmap_mode="r"),
            primary=int((CACHE / f"{tag}_primary.txt").read_text()),
            ftab_top=np.load(CACHE / f"{tag}_ftab_top.npy"),
            ftab_bot=np.load(CACHE / f"{tag}_ftab_bot.npy"))

    g = np.load(CACHE / "joined.npy", mmap_mode="r")
    return FmIndex(
        fw=load_dir("fw"), mirror=load_dir("mirror"), joined=g,
        run_joined_start=np.array([0], np.int64),
        run_ref_id=np.array([0], np.int32),
        run_ref_off=np.array([0], np.int64),
        ref_full=g, ref_full_start=np.array([0], np.int64),
        ref_lens=np.array([N], np.int64), ref_names=["big"])


def main():
    n_reads = 100_000
    if "--n-reads" in sys.argv:
        n_reads = int(sys.argv[sys.argv.index("--n-reads") + 1])
    import jax
    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    from bowtie2_server_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    idx = build_or_load()
    from bowtie2_server_tpu.align.pipeline import UnpairedAligner
    from bowtie2_server_tpu.io.fastq import make_batch

    log("uploading index to device")
    t0 = time.time()
    al = UnpairedAligner(idx)
    assert al.big, "big mode should auto-trigger past BIG_THRESHOLD"
    log(f"device index ready in {time.time()-t0:.0f}s")

    # reads planted across the whole range incl. past 2^31, 0-2 mutations
    rng = np.random.default_rng(5)
    g = idx.joined
    starts = np.concatenate([
        rng.integers(0, N - READ_LEN, n_reads // 2),
        rng.integers((1 << 31) - 10_000, N - READ_LEN, n_reads // 2),
    ]).astype(np.int64)
    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = []
    for s in starts:
        rd = np.array(g[s : s + READ_LEN])
        for _ in range(rng.integers(0, 3)):
            rd[rng.integers(0, READ_LEN)] = rng.integers(0, 4)
        if rng.random() < 0.5:
            rd = (3 - rd)[::-1]
        seqs.append(bases[rd].tobytes())
    B = 16384
    batches = [make_batch([f"b{i}" for i in range(lo, lo + B)],
                          seqs[lo : lo + B], [b"I" * READ_LEN] * B)
               for lo in range(0, n_reads - B + 1, B)]

    log("warmup/compile batch")
    recs = al.align_batch(batches[0])
    na = recs.n_aligned()
    t0 = time.time()
    n = 0
    for b in batches[1:]:
        recs = al.align_batch(b)
        na += recs.n_aligned()
        n += len(b)
    dt = time.time() - t0
    # HBM budget
    hbm = {}
    for tag, fm in (("fw", al.dev), ("mirror", al.dev_mirror)):
        hbm[tag] = sum(int(np.prod(a.shape)) * a.dtype.itemsize
                       for a in (fm.side, fm.mark, fm.sa_samp)) / 1e9
    cg = al.candgen
    hbm["joined_words"] = (int(np.prod(cg.didx.joined_words.shape)) * 4
                           / 1e9)
    out = {
        "metric": "big_index_reads_per_s_per_chip",
        "genome_bp": N,
        "value": round(n / dt, 1), "unit": "reads/s",
        "aligned": int(na), "total": n + len(batches[0]),
        "hbm_gb": {k: round(v, 2) for k, v in hbm.items()},
    }
    print(json.dumps(out))
    log(f"aligned {na}/{n + len(batches[0])} in {dt:.1f}s warm")


if __name__ == "__main__":
    main()
