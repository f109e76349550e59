"""Multi-worker pack dispatch: device groups + per-connection fairness +
deterministic per-connection merge (ref: pat.cpp:2016-2086 shared worker
pool over per-connection queues; SURVEY §2.3 row 3)."""
import threading
import time

import numpy as np
import pytest

from bowtie2_server_tpu.server.dispatch import (AlignDispatcher,
                                                make_device_groups)


def test_round_robin_fairness():
    """A connection with many queued packs cannot starve a later one:
    with one worker, packs interleave across connections."""
    order = []
    lock = threading.Lock()

    def work(_worker, tag):
        with lock:
            order.append(tag)
        time.sleep(0.01)
        return tag

    d = AlignDispatcher([object()])
    futs = []
    # connection 1 floods 6 packs, then connection 2 queues 2
    for k in range(6):
        futs.append(d.submit(1, work, ("c1", k)))
    for k in range(2):
        futs.append(d.submit(2, work, ("c2", k)))
    for f in futs:
        f.result(timeout=10)
    d.shutdown()
    # c2's first pack must NOT wait for all six c1 packs
    c2_first = order.index(("c2", 0))
    assert c2_first < 5, order


def test_per_connection_order_and_results():
    def work(_w, tag):
        time.sleep(0.002 * (tag[1] % 3))
        return tag

    d = AlignDispatcher([object(), object()])
    futs = {c: [d.submit(c, work, (c, k)) for k in range(8)]
            for c in (1, 2, 3)}
    for c, fl in futs.items():
        got = [f.result(timeout=10) for f in fl]
        assert got == [(c, k) for k in range(8)]
    d.shutdown()


def test_worker_exception_propagates():
    def boom(_w):
        raise ValueError("pack failed")

    d = AlignDispatcher([object()])
    with pytest.raises(ValueError):
        d.submit(1, boom).result(timeout=10)
    d.shutdown()


def test_device_groups_partition():
    import jax
    groups = make_device_groups(2)   # 8 virtual CPU devices -> 2 groups
    assert len(groups) == 2
    devs = set()
    for g in groups:
        assert g is not None and g.devices.size == 4
        devs |= set(g.devices.flat)
    assert len(devs) == 8


def test_two_worker_groups_align_identically():
    """Two device-group workers over the 8-device CPU mesh produce the
    same SAM bytes for the same pack — the deterministic merge invariant."""
    from bowtie2_server_tpu.index.build import build_index
    from bowtie2_server_tpu.align.pipeline import UnpairedAligner
    from bowtie2_server_tpu.align.paired import PairedAligner
    from bowtie2_server_tpu.server.bt2srv import Bt2Server

    idx = build_index("/root/reference/example/reference/lambda_virus.fa")
    groups = make_device_groups(2)
    workers = []
    for mesh in groups:
        up = UnpairedAligner(idx, mesh=mesh)
        pal = PairedAligner(idx)
        pal.up = up
        workers.append((up, pal))
    # one real pack of reads from the bundled example
    from bowtie2_server_tpu.io.fastq import iter_fastq
    batch = next(iter_fastq("/root/reference/example/reads/longreads.fq",
                            batch_size=256))
    rows = [(batch.names[i] + "/1", batch.raw_seq[i], batch.raw_qual[i],
             None, None, None) for i in range(len(batch))]
    outs = []
    d = AlignDispatcher(workers)
    for c, w in enumerate(workers):
        outs.append(d.submit(c, Bt2Server._align_pack, rows,
                             idx.ref_names).result(timeout=600))
    d.shutdown()
    assert outs[0] == outs[1]
    assert outs[0].count(b"@CO END READ") == len(rows)


@pytest.mark.parametrize("n_workers,per", [(8, 1), (4, 2), (1, 8)])
def test_device_groups_shapes(n_workers, per):
    """One-device groups are the Device itself (a worker of its own);
    larger groups are disjoint 'dp' meshes; one worker meshes every
    device."""
    import jax
    from jax.sharding import Mesh
    groups = make_device_groups(n_workers)
    assert len(groups) == n_workers
    seen = []
    for g in groups:
        if per == 1:
            assert isinstance(g, jax.Device)
            seen.append(g)
        else:
            assert isinstance(g, Mesh) and g.axis_names == ("dp",)
            assert g.devices.size == per
            seen.extend(g.devices.flat)
    assert len(set(seen)) == len(seen) == 8


def _tiny_index_base(tmp_path):
    from bowtie2_server_tpu.index.build import build_index
    from bowtie2_server_tpu.utils import dna
    rng = np.random.default_rng(11)
    genome = dna.decode(rng.integers(0, 4, 20000).astype(np.uint8))
    idx = build_index(f">g\n{genome}\n")
    base = tmp_path / "g"
    idx.save(base)
    return base, idx


def test_workers_each_get_their_own_device(tmp_path):
    """--workers 8 on 8 devices: each worker's index lives on its own
    device, and a pack aligned by worker k runs its fused program there
    with the same records as worker 0."""
    import jax
    from bowtie2_server_tpu.io.fastq import make_batch
    from bowtie2_server_tpu.server.bt2srv import Bt2Server
    from bowtie2_server_tpu.utils import dna
    base, idx = _tiny_index_base(tmp_path)
    srv = Bt2Server(str(base), n_workers=8)
    try:
        workers = srv._dispatch._workers
        devs = jax.devices()
        for k, (up, pal) in enumerate(workers):
            assert up is pal.up and up.device == devs[k]
            assert up.dev.side.devices() == {devs[k]}
            assert up.candgen.didx.joined_words.devices() == {devs[k]}
        rng = np.random.default_rng(3)
        starts = rng.integers(0, idx.n - 60, 64)
        seqs = [dna.decode(idx.joined[s:s + 60]).encode() for s in starts]
        batch = make_batch([f"r{i}" for i in range(64)], seqs,
                           [b"I" * 60] * 64)
        up3 = workers[3][0]
        h = up3.candgen.dispatch(batch.seqs, batch.quals, batch.lens,
                                 np.ones(64, bool), np.ones(64, bool),
                                 np.full(64, -100, np.int32),
                                 up3.sc.mm_penalties())
        assert h[1].devices() == {devs[3]}
        r0 = workers[0][0].align_batch(batch)
        r3 = up3.align_batch(batch)
        assert [(a.pos, a.fw, a.score, a.cigar) for a in r0] == \
            [(b.pos, b.fw, b.score, b.cigar) for b in r3]
        assert sum(a.aligned for a in r0) == 64
    finally:
        srv.close()


def test_single_worker_mesh_places_index_once_replicated(tmp_path):
    """The default server worker on a multi-device host meshes every
    device and places the index on it once, replicated."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec
    from bowtie2_server_tpu.server.bt2srv import Bt2Server
    base, _ = _tiny_index_base(tmp_path)
    srv = Bt2Server(str(base), n_workers=1)
    try:
        (up, pal), = srv._dispatch._workers
        assert up.candgen.mesh is not None and up.device is None
        for arr in (up.dev.side, up.dev_mirror.sa,
                    up.candgen.didx.joined_words):
            sh = arr.sharding
            assert isinstance(sh, NamedSharding)
            assert sh.spec == PartitionSpec()
            assert arr.devices() == set(jax.devices())
    finally:
        srv.close()
