#!/usr/bin/env python3
"""End-to-end check of the aligner on one NVIDIA GPU.

Runs the main path through the entry points a user calls, at the sizes of
the repo's benchmarks (bench.py: 4 Mbp bacterial genome, 100 bp reads;
bench_paired.py: 12 Mbp 8-chromosome yeast-scale genome, 150 bp FR pairs):

  0. device     JAX platform/kind/count, nvidia-smi name and power limit;
                no GPU is a failure, never a CPU run
  1. kernels    the banded DP engine of the fused program and the rectangle
                DP engine, on the card, against the numpy references
  2. unpaired   `build` + `align -U` on 65,536 reads: aligned, placement at
                the simulated origin, fused path only, and a 2,048-read
                sample equal to a `--cpu` run
  3. paired     `align -1/-2` on 16,384 pairs: concordance, and a sample
                equal to a `--cpu` run
  4. server     `server` + two concurrent `client` processes: every read
                answered, records equal to phase 2's

Each phase that uses the card runs in its own child process, one after
another (a JAX process reserves most of the card's memory), and the parent
never initialises JAX. Any failing child fails the run. The last line of
standard output is one JSON object naming the device.

`--four-cards` runs only the multi-card server path on a 4-GPU host: the
same 65,536 reads through the server with one mesh over the four cards and
with `--workers 4`, each compared with a one-card run of the same reads.

Built indexes are cached under tmp/smoke/, keyed by the workload's seed.
Run: python chip_smoke.py [--four-cards]
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "tmp" / "smoke"
PY = sys.executable

UNPAIRED_READS = 65536
UNPAIRED_BATCH = 32768
CPU_SAMPLE_EVERY = 32          # 65,536 / 32 = 2,048 reads
PAIRS = 16384
PAIRED_BATCH = 16384
PAIR_SAMPLE_EVERY = 16         # 1,024 pairs
CLIENT_READS = 8192            # per client; the server packs 4,096 reads
DP_PROBLEMS = 32768
RECT_PROBLEMS = 4096
MIN_ALIGNED = 0.99
MIN_PLACED = 0.99
MIN_CONCORDANT = 0.99
# bytes a card must have allocated beyond its index while serving
MIN_WORK_BYTES = 64 << 20


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ SAM helpers --

def sam_records(path) -> list[list[str]]:
    """Alignment records of a SAM file (header lines dropped), each as its
    tab-separated fields."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("@") or not line.strip():
                continue
            out.append(line.rstrip("\n").split("\t"))
    return out


def record_key(fields: list[str]) -> tuple[str, int]:
    """(QNAME, mate bits): unique for primary records of unpaired reads and
    of pairs."""
    return fields[0], int(fields[1]) & 0xC0


def primary_by_key(records) -> dict:
    """Primary records keyed by record_key; a key seen twice is an error
    (one primary record per read or mate)."""
    out = {}
    for r in records:
        if int(r[1]) & 0x900:          # secondary / supplementary
            continue
        k = record_key(r)
        if k in out:
            raise SmokeFailure(f"two primary records for {k}")
        out[k] = r
    return out


def compare_records(got: dict, ref: dict) -> list[str]:
    """Keys of `ref` whose record in `got` is missing or differs in any
    field; one line of explanation each."""
    bad = []
    for k, r in ref.items():
        g = got.get(k)
        if g is None:
            bad.append(f"{k}: missing")
        elif g != r:
            diff = [i for i in range(max(len(g), len(r)))
                    if (g[i:i + 1] != r[i:i + 1])]
            bad.append(f"{k}: fields {diff} differ: {g} != {r}")
    return bad


def placement(prim: dict, starts, rc) -> tuple[int, int]:
    """(aligned, placed) over reads named b<i>: placed means POS is the
    simulated 0-based origin + 1 on the simulated strand."""
    n_al = n_ok = 0
    for (name, _), r in prim.items():
        flag = int(r[1])
        if flag & 4:
            continue
        n_al += 1
        i = int(name[1:])
        if int(r[3]) == int(starts[i]) + 1 and bool(flag & 16) == bool(rc[i]):
            n_ok += 1
    return n_al, n_ok


def concordant(prim: dict) -> int:
    """Pairs whose mate-1 record carries the proper-pair flag."""
    return sum(1 for (_, mate), r in prim.items()
               if mate == 0x40 and int(r[1]) & 0x2)


def parse_paths(stderr: str) -> dict:
    """The CLI's '# first batch ...; batches: fused F, capacity escalations
    E, host path H' line -> {'first': s, 'fused': F, 'escalated': E,
    'host': H}."""
    for line in stderr.splitlines():
        if line.startswith("# first batch"):
            head, tail = line.split("; batches:")
            first = head.split()[-1].rstrip("s")
            vals = [int(p.split()[-1]) for p in tail.split(",")]
            return {"first": float(first) if first != "-" else None,
                    "fused": vals[0], "escalated": vals[1], "host": vals[2]}
    raise SmokeFailure("the CLI printed no path counters")


def write_fastq(path, names, seqs, quals, idx=None) -> None:
    sel = range(len(names)) if idx is None else idx
    with open(path, "w") as f:
        for i in sel:
            f.write(f"@{names[i]}\n{seqs[i].decode()}\n+\n"
                    f"{quals[i].decode()}\n")


# --------------------------------------------------------- process helpers -

def run(cmd, env=None, what="", timeout=900) -> subprocess.CompletedProcess:
    """Run a child to completion; a non-zero exit fails the smoke run."""
    e = dict(os.environ)
    e.update(env or {})
    t0 = time.time()
    p = subprocess.run([str(c) for c in cmd], cwd=ROOT, env=e,
                       capture_output=True, text=True, timeout=timeout)
    if p.returncode != 0:
        raise SmokeFailure(
            f"{what or cmd[:4]} exited {p.returncode} after "
            f"{time.time() - t0:.1f}s\n--- stdout\n{p.stdout[-4000:]}"
            f"\n--- stderr\n{p.stderr[-6000:]}")
    return p


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def cli(*args) -> list:
    return [PY, "-m", "bowtie2_server_tpu", *args]


def card_lines() -> list[str]:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True)
    except OSError as e:
        raise SmokeFailure(f"nvidia-smi: {e}") from e
    if p.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {p.stderr.strip()}")
    return [ln.strip() for ln in p.stdout.splitlines() if ln.strip()]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_index(fa: Path, base: Path) -> None:
    if Path(str(base) + ".fm.npz").exists():
        log(f"# index {base.name}: cached")
        return
    t0 = time.time()
    run(cli("build", fa, base), what="build")
    log(f"# index {base.name}: built in {time.time() - t0:.1f}s")


def unpaired_workload():
    sys.path.insert(0, str(ROOT))
    import bench
    WORK.mkdir(parents=True, exist_ok=True)
    fa, names, seqs, quals, starts, rc = bench.make_workload(
        WORK, n_reads=UNPAIRED_READS)
    base = WORK / "unpaired_s42"
    build_index(fa, base)
    fq = WORK / "unpaired.fq"
    write_fastq(fq, names, seqs, quals)
    return base, fq, (names, seqs, quals, starts, rc)


def align_unpaired(base, fq, sam, env=None):
    t0 = time.time()
    p = run(cli("align", "-x", base, "-U", fq, "-S", sam, "--batch",
                UNPAIRED_BATCH), env=env, what="align -U")
    return time.time() - t0, p.stderr


# ----------------------------------------------------------------- phases --

def child_device() -> None:
    """Phase 0 (child): JAX's view of the devices."""
    import jax
    d = jax.devices()
    print(json.dumps({"platform": d[0].platform, "kind": d[0].device_kind,
                      "count": len(d)}))
    if d[0].platform != "gpu":
        sys.exit(f"no GPU: JAX's default backend is {d[0].platform}")


def phase_device(expect_count: int | None) -> dict:
    p = run([PY, __file__, "--child", "device"], what="device check")
    dev = last_json(p.stdout)
    for line in card_lines():
        log(f"# card: {line}")
    log(f"# jax: platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']}")
    if expect_count is not None and dev["count"] != expect_count:
        raise SmokeFailure(f"expected {expect_count} devices, JAX sees "
                           f"{dev['count']}")
    return dev


def _dp_problems(rng, B, lq, read_len, K):
    """Planted reads of mixed lengths (read_len/2 .. read_len) padded to
    lq, with substitutions, N codes in read and reference, and indels."""
    import numpy as np
    lens = rng.integers(read_len // 2, read_len + 1, B).astype(np.int32)
    lens[: B // 2] = read_len
    band = rng.integers(0, 4, (B, lq + K)).astype(np.uint8)
    band[rng.random(band.shape) < 0.01] = 4
    rd = np.full((B, lq), 5, np.uint8)
    c = K // 2
    pos = np.arange(lq)[None, :]
    src = c + pos + np.where(pos >= (lens // 2)[:, None],
                             rng.integers(-2, 3, B)[:, None], 0)
    planted = np.take_along_axis(band, np.clip(src, 0, lq + K - 1), axis=1)
    rd = np.where(pos < lens[:, None], planted[:, :lq], 5).astype(np.uint8)
    sub = (rng.random((B, lq)) < 0.04) & (pos < lens[:, None])
    rd[sub] = rng.integers(0, 5, int(sub.sum()))
    mm = rng.integers(2, 7, (B, lq)).astype(np.int32)
    return rd, lens, mm, band


def child_kernels() -> None:
    """Phase 1 (child): the DP engines on the card against numpy."""
    from bowtie2_server_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    require_gpu()
    check_kernels(DP_PROBLEMS, RECT_PROBLEMS)


def check_kernels(n_dp: int, n_rect: int) -> None:
    """The banded engine the fused program uses (K=64; 100 bp reads in
    L=128, 150 bp in L=256; end-to-end and local) against the numpy oracle
    on all n_dp problems plus the scalar oracle on a sample, and the
    rectangle engine at mate-rescue shapes against its numpy references.
    Exits non-zero on any mismatch."""
    import numpy as np

    from bowtie2_server_tpu.ops.sw import (SwConfig, sw_align_batch,
                                           sw_align_numpy_batch,
                                           sw_score_numpy)
    from bowtie2_server_tpu.ops.sw_banded import (banded_best_numpy,
                                                  banded_best_numpy_batch,
                                                  sw_banded_batch)
    K = 64
    print(f"# tolerance 0: the DP is int32 add/max/select with no float "
          f"product, so results must be equal (TF32 cannot apply)",
          flush=True)
    rng = np.random.default_rng(2024)
    cfgs = (("e2e", SwConfig()), ("local", SwConfig(ma=2, local=True)))
    for read_len, lq in ((100, 128), (150, 256)):
        rd, lens, mm, band = _dp_problems(rng, n_dp, lq, read_len, K)
        for name, cfg in cfgs:
            t0 = time.time()
            got = sw_banded_batch(rd, lens, mm, band, cfg, K=K)
            t_dev = time.time() - t0
            ref = banded_best_numpy_batch(rd, lens, mm, band, cfg, K)
            bad = int(sum((g != r).sum() for g, r in zip(got, ref)))
            for b in range(0, n_dp, max(1, n_dp // 64)):
                n = int(lens[b])
                exp = banded_best_numpy(rd[b, :n], mm[b, :n],
                                        band[b, : n + K], cfg, K)
                if tuple(int(v[b]) for v in got) != exp:
                    bad += 1
            print(f"# banded xla K={K} L={lq} ({read_len} bp) {name}: "
                  f"{n_dp} problems, first call {t_dev:.1f}s, "
                  f"mismatches {bad}", flush=True)
            if bad:
                sys.exit(f"banded DP mismatch ({name}, L={lq})")
    lq, lc = 150, 512
    for name, cfg in cfgs:
        B = n_rect
        ref_w = rng.integers(0, 4, (B, lc)).astype(np.uint8)
        off = rng.integers(0, lc - lq, B)
        rd = np.take_along_axis(ref_w, off[:, None] + np.arange(lq)[None, :],
                                axis=1)
        sub = rng.random((B, lq)) < 0.05
        rd[sub] = rng.integers(0, 5, int(sub.sum()))
        lens = np.full(B, lq, np.int32)
        wlens = rng.integers(lc // 2, lc + 1, B).astype(np.int32)
        mm = np.full((B, lq), 6, np.int32)
        t0 = time.time()
        got = sw_align_batch(rd, lens, mm, ref_w, wlens, cfg)
        t_dev = time.time() - t0
        ref = sw_align_numpy_batch(rd, lens, mm, ref_w, wlens, cfg)
        bad = int(sum((g != r).sum() for g, r in zip(got, ref)))
        for b in range(0, B, max(1, B // 4)):
            exp = sw_score_numpy(rd[b], mm[b], ref_w[b, : wlens[b]], cfg)
            if tuple(int(v[b]) for v in got) != exp:
                bad += 1
        print(f"# rect xla lq={lq} window={lc} {name}: {B} problems, "
              f"first call {t_dev:.1f}s, mismatches {bad}", flush=True)
        if bad:
            sys.exit(f"rectangle DP mismatch ({name})")


def phase_kernels() -> None:
    p = run([PY, __file__, "--child", "kernels"], what="kernel check",
            timeout=1000)
    for line in p.stdout.splitlines():
        log(line)


def phase_unpaired(card: str):
    base, fq, (names, seqs, quals, starts, rc) = unpaired_workload()
    sam = WORK / "unpaired.sam"
    wall, err = align_unpaired(base, fq, sam)
    paths = parse_paths(err)
    prim = primary_by_key(sam_records(sam))
    if len(prim) != UNPAIRED_READS:
        raise SmokeFailure(f"{len(prim)} primary records for "
                           f"{UNPAIRED_READS} reads")
    n_al, n_ok = placement(prim, starts, rc)
    steady = (UNPAIRED_READS - UNPAIRED_BATCH) / max(
        wall - (paths["first"] or 0.0), 1e-9)
    log(f"# unpaired: {UNPAIRED_READS} reads, aligned {n_al} "
        f"({n_al / UNPAIRED_READS:.4f}), at origin {n_ok} "
        f"({n_ok / max(n_al, 1):.4f}); paths {paths}")
    log(f"# unpaired timing on {card}: wall {wall:.1f}s (process), first "
        f"batch {paths['first']}s (compile), "
        f"{UNPAIRED_READS / wall:.0f} reads/s overall, {steady:.0f} reads/s "
        f"after the first batch")
    if n_al < MIN_ALIGNED * UNPAIRED_READS:
        raise SmokeFailure("too few reads aligned")
    if n_ok < MIN_PLACED * n_al:
        raise SmokeFailure("too few reads placed at their origin")
    if paths["escalated"] or paths["host"] or paths["fused"] != \
            UNPAIRED_READS // UNPAIRED_BATCH:
        raise SmokeFailure(f"left the fused path: {paths}")
    sample = list(range(0, UNPAIRED_READS, CPU_SAMPLE_EVERY))
    sfq, ssam = WORK / "unpaired_sample.fq", WORK / "unpaired_sample_cpu.sam"
    write_fastq(sfq, names, seqs, quals, sample)
    run(cli("align", "--cpu", "-x", base, "-U", sfq, "-S", ssam, "--batch",
            len(sample)), env={"JAX_PLATFORMS": "cpu"},
        what="align -U --cpu (reference)")
    ref = primary_by_key(sam_records(ssam))
    bad = compare_records(prim, ref)
    log(f"# unpaired: {len(ref)}-read sample vs the --cpu run: "
        f"{len(bad)} differ")
    if bad or len(ref) != len(sample):
        raise SmokeFailure("GPU records differ from the CPU run:\n"
                           + "\n".join(bad[:10]))
    return base, prim, (names, seqs, quals)


def phase_paired(card: str) -> None:
    sys.path.insert(0, str(ROOT))
    import bench_paired
    fa, m1, m2 = bench_paired.make_workload(WORK, n_pairs=PAIRS)
    base = WORK / "paired_s7"
    build_index(fa, base)
    f1, f2 = WORK / "paired_1.fq", WORK / "paired_2.fq"
    write_fastq(f1, *m1)
    write_fastq(f2, *m2)
    sam = WORK / "paired.sam"
    t0 = time.time()
    p = run(cli("align", "-x", base, "-1", f1, "-2", f2, "-S", sam,
                "--batch", PAIRED_BATCH), what="align -1/-2")
    wall = time.time() - t0
    paths = parse_paths(p.stderr)
    prim = primary_by_key(sam_records(sam))
    if len(prim) != 2 * PAIRS:
        raise SmokeFailure(f"{len(prim)} primary records for {PAIRS} pairs")
    n_con = concordant(prim)
    log(f"# paired: {PAIRS} pairs, concordant {n_con} "
        f"({n_con / PAIRS:.4f}); paths {paths}; wall {wall:.1f}s on {card}, "
        f"first batch {paths['first']}s")
    if n_con < MIN_CONCORDANT * PAIRS:
        raise SmokeFailure("too few concordant pairs")
    sample = list(range(0, PAIRS, PAIR_SAMPLE_EVERY))
    s1, s2 = WORK / "paired_sample_1.fq", WORK / "paired_sample_2.fq"
    write_fastq(s1, *m1, sample)
    write_fastq(s2, *m2, sample)
    ssam = WORK / "paired_sample_cpu.sam"
    run(cli("align", "--cpu", "-x", base, "-1", s1, "-2", s2, "-S", ssam,
            "--batch", len(sample)), env={"JAX_PLATFORMS": "cpu"},
        what="align -1/-2 --cpu (reference)")
    ref = primary_by_key(sam_records(ssam))
    bad = compare_records(prim, ref)
    log(f"# paired: {len(sample)}-pair sample vs the --cpu run: "
        f"{len(bad)} records differ")
    if bad or len(ref) != 2 * len(sample):
        raise SmokeFailure("GPU paired records differ from the CPU run:\n"
                           + "\n".join(bad[:10]))


def wait_banner(port: int, proc, timeout: float = 600.0) -> float:
    """Poll GET / until the server's banner; the server dying first is a
    failure."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc is not None and proc.poll() is not None:
            raise SmokeFailure(f"server exited early ({proc.returncode})")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                        timeout=5) as r:
                if b"bowtie2 SaaS" in r.read():
                    return time.time() - t0
        except OSError:
            time.sleep(1.0)
    raise SmokeFailure("server never answered GET /")


def run_clients(port: int, index_name: str, fqs, sams) -> float:
    """Concurrent client processes, one per FASTQ; all must succeed."""
    t0 = time.time()
    procs = [subprocess.Popen(
        [str(c) for c in cli("client", "--host", "127.0.0.1", "--port", port,
                             "-x", index_name, "-U", fq, "-S", sam)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for fq, sam in zip(fqs, sams)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode != 0:
            errs.append(f"client exited {p.returncode}: {err[-3000:]}")
    if errs:
        raise SmokeFailure("\n".join(errs))
    return time.time() - t0


def client_inputs(tag: str, n_clients: int, per_client: int, reads):
    names, seqs, quals = reads[:3]
    fqs, sams = [], []
    for c in range(n_clients):
        fq = WORK / f"{tag}_client{c}.fq"
        write_fastq(fq, names, seqs, quals,
                    range(c * per_client, (c + 1) * per_client))
        fqs.append(fq)
        sams.append(WORK / f"{tag}_client{c}.sam")
    return fqs, sams


def check_client_records(sams, ref: dict, n_reads: int, what: str) -> None:
    """The clients' primary records: one per read sent, each equal to the
    reference run's record of that read."""
    got = {}
    for sam in sams:
        got.update(primary_by_key(sam_records(sam)))
    if len(got) != n_reads:
        raise SmokeFailure(f"{what}: {len(got)} records for {n_reads} reads")
    bad = compare_records(got, {k: ref[k] for k in got if k in ref})
    missing = [k for k in got if k not in ref]
    log(f"# {what}: {n_reads} reads answered, {len(bad)} records differ "
        f"from the reference run")
    if bad or missing:
        raise SmokeFailure(f"{what} records differ:\n"
                           + "\n".join(bad[:10] + [str(missing[:10])]))


def phase_server(base: Path, ref_prim: dict, reads) -> None:
    port = free_port()
    log_path = WORK / "server.log"
    with open(log_path, "w") as lf:
        proc = subprocess.Popen(
            [str(c) for c in cli("server", "-x", base, "--port", port)],
            cwd=ROOT, stdout=lf, stderr=subprocess.STDOUT)
    try:
        t_up = wait_banner(port, proc)
        fqs, sams = client_inputs("server", 2, CLIENT_READS, reads)
        dt = run_clients(port, base.name, fqs, sams)
        if proc.poll() is not None:
            raise SmokeFailure(f"server exited early ({proc.returncode})")
        log(f"# server: banner after {t_up:.1f}s; 2 clients x "
            f"{CLIENT_READS} reads in {dt:.1f}s")
        check_client_records(sams, ref_prim, 2 * CLIENT_READS, "server")
    finally:
        alive = proc.poll() is None
        proc.kill()
        proc.wait(timeout=60)
        if not alive:
            log((WORK / "server.log").read_text()[-3000:])


# ------------------------------------------------------------- four cards --

def require_gpu() -> None:
    import jax
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"no GPU: JAX's default backend is "
                 f"{jax.devices()[0].platform}")


def serve_four(workers: int) -> dict:
    """The server in this process on a free port (`workers` device-group
    workers over the visible devices), two client processes sending the
    four-card client inputs, then each device's memory statistics."""
    from bowtie2_server_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import asyncio

    import jax

    from bowtie2_server_tpu.server.bt2srv import Bt2Server

    def mem(key):
        return [(d.memory_stats() or {}).get(key, 0) for d in jax.devices()]

    base = WORK / "unpaired_s42"
    srv = Bt2Server(str(base), n_workers=workers)
    before = mem("bytes_in_use")
    port = free_port()
    th = threading.Thread(target=asyncio.run,
                          args=(srv.serve("127.0.0.1", port),), daemon=True)
    th.start()
    wait_banner(port, None)
    sams = [WORK / f"four_w{workers}_client{c}.sam" for c in range(2)]
    fqs = [WORK / f"four_client{c}.fq" for c in range(2)]
    dt = run_clients(port, base.name, fqs, sams)
    peak = mem("peak_bytes_in_use")
    srv.close()
    return {"workers": workers, "seconds": dt, "bytes_before": before,
            "peak_bytes": peak, "sams": [str(s) for s in sams]}


def check_four(res: dict, ref: dict) -> None:
    """The records of one four-card server run equal the one-card run's,
    and every card allocated working memory beyond its index."""
    mode = ("one mesh over 4 cards" if res["workers"] == 1
            else f"--workers {res['workers']}, one card each")
    check_client_records([Path(s) for s in res["sams"]], ref,
                         UNPAIRED_READS, f"server ({mode})")
    grew = [pk - b0 for pk, b0 in zip(res["peak_bytes"],
                                      res["bytes_before"])]
    log(f"# {mode}: {UNPAIRED_READS} reads in {res['seconds']:.1f}s; "
        f"per-card peak bytes above the loaded index {grew}")
    if len(grew) != 4 or min(grew) < MIN_WORK_BYTES:
        raise SmokeFailure(f"{mode}: a card shows no work: {grew}")


def four_cards() -> dict:
    dev = phase_device(4)
    base, fq, reads = unpaired_workload()
    per = UNPAIRED_READS // 2
    client_inputs("four", 2, per, reads)
    ref_sam = WORK / "four_onecard.sam"
    wall, _ = align_unpaired(base, fq, ref_sam,
                             env={"CUDA_VISIBLE_DEVICES": "0"})
    ref = primary_by_key(sam_records(ref_sam))
    log(f"# one-card reference: {len(ref)} records in {wall:.1f}s")
    for workers in (1, 4):
        p = run([PY, __file__, "--child", "server4", "--workers", workers],
                what=f"four-card server, --workers {workers}", timeout=1100)
        check_four(last_json(p.stdout), ref)
    return dev


# ------------------------------------------------------------------- main --

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card server path (4 GPUs)")
    ap.add_argument("--child", choices=("device", "kernels", "server4"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--workers", type=int, default=1, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child == "device":
        child_device()
        return 0
    if a.child == "kernels":
        child_kernels()
        return 0
    if a.child == "server4":
        require_gpu()
        print(json.dumps(serve_four(a.workers)))
        return 0
    if not (ROOT / "bowtie2_server_tpu").is_dir():
        print("chip_smoke: the bowtie2_server_tpu package is not beside "
              "this script", file=sys.stderr)
        return 2
    t0 = time.time()
    try:
        if a.four_cards:
            dev = four_cards()
        else:
            dev = phase_device(1)
            card = card_lines()[0]
            phase_kernels()
            base, prim, reads = phase_unpaired(card)
            phase_paired(card)
            phase_server(base, prim, reads)
    except (SmokeFailure, subprocess.TimeoutExpired) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"# all phases passed in {time.time() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
