"""Smith-Waterman engines vs the scalar numpy oracle."""
import numpy as np
import pytest

from bowtie2_server_tpu.ops.sw import (
    NEG_INF, SwConfig, sw_align_batch, sw_score_numpy)

E2E = SwConfig()
LOCAL = SwConfig(ma=2, local=True)


def random_problem(rng, lq, lc, cfg, mutate=True):
    ref = rng.integers(0, 4, lc).astype(np.uint8)
    start = int(rng.integers(0, max(1, lc - lq)))
    rd = ref[start : start + lq].copy()
    if len(rd) < lq:
        rd = np.concatenate([rd, rng.integers(0, 4, lq - len(rd)).astype(np.uint8)])
    if mutate:
        for _ in range(rng.integers(0, 4)):
            p = int(rng.integers(0, lq))
            rd[p] = rng.integers(0, 4)
        if rng.random() < 0.4 and lq > 12:  # small indel
            p = int(rng.integers(5, lq - 5))
            if rng.random() < 0.5:
                rd = np.concatenate([rd[:p], rd[p + 1 :], rng.integers(0, 4, 1).astype(np.uint8)])
            else:
                rd = np.concatenate([rd[:p], rng.integers(0, 4, 1).astype(np.uint8), rd[p:]])[:lq]
    mmpen = np.full(lq, 6, np.int32)
    return rd, mmpen, ref


@pytest.mark.parametrize("engine", ["xla"])
@pytest.mark.parametrize("cfg", [E2E, LOCAL], ids=["e2e", "local"])
def test_sw_matches_oracle(engine, cfg, rng):
    B, lq, lc = 48, 24, 40
    rds, mms, refs = [], [], []
    for _ in range(B):
        rd, mm, ref = random_problem(rng, lq, lc, cfg)
        rds.append(rd); mms.append(mm); refs.append(ref)
    rd = np.stack(rds); mm = np.stack(mms); ref = np.stack(refs)
    lens = np.full(B, lq, np.int32)
    reflens = np.full(B, lc, np.int32)
    best, bi, bj = sw_align_batch(rd, lens, mm, ref, reflens, cfg)
    for b in range(B):
        eb, ei, ej = sw_score_numpy(rd[b], mm[b], ref[b], cfg)
        assert best[b] == eb, f"problem {b}: {best[b]} != oracle {eb}"
        assert (bi[b], bj[b]) == (ei, ej), f"problem {b} cell"


@pytest.mark.parametrize("engine", ["xla"])
def test_sw_variable_lengths(engine, rng):
    cfg = E2E
    B, lq_max, lc_max = 16, 32, 48
    rd = np.full((B, lq_max), 5, np.uint8)
    mm = np.zeros((B, lq_max), np.int32)
    ref = np.full((B, lc_max), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    reflens = np.zeros(B, np.int32)
    probs = []
    for b in range(B):
        lq = int(rng.integers(10, lq_max + 1))
        lc = int(rng.integers(lq, lc_max + 1))
        r, m, rf = random_problem(rng, lq, lc, cfg)
        rd[b, :lq] = r; mm[b, :lq] = m; ref[b, :lc] = rf
        lens[b] = lq; reflens[b] = lc
        probs.append((r, m, rf))
    best, bi, bj = sw_align_batch(rd, lens, mm, ref, reflens, cfg)
    for b, (r, m, rf) in enumerate(probs):
        eb, ei, ej = sw_score_numpy(r, m, rf, cfg)
        assert (best[b], bi[b], bj[b]) == (eb, ei, ej), f"problem {b}"


def test_sw_perfect_match_scores_zero(rng):
    ref = rng.integers(0, 4, 60).astype(np.uint8)
    rd = ref[10:40].copy()
    mm = np.full(30, 6, np.int32)
    best, bi, bj = sw_align_batch(
        rd[None], np.array([30]), mm[None], ref[None], np.array([60]), E2E)
    assert best[0] == 0
    assert bi[0] == 29 and bj[0] == 39


def test_sw_n_chars_get_n_penalty():
    ref = np.array([0, 1, 2, 3] * 8, np.uint8)
    rd = ref[4:20].copy()
    rd[8] = 4  # N in read
    mm = np.full(16, 6, np.int32)
    best, _, _ = sw_align_batch(
        rd[None], np.array([16]), mm[None], ref[None], np.array([32]), E2E)
    assert best[0] == -E2E.npen


def test_sw_gap_scoring():
    # read = ref with one base deleted -> one read gap: -(open) = -8
    cfg = SwConfig(gapbar=4)
    ref = np.array([0, 1, 2, 3, 0, 0, 1, 1, 2, 2, 3, 3, 0, 2, 1, 3, 0, 1, 2, 3],
                   np.uint8)
    rd = np.concatenate([ref[:10], ref[11:20]])  # delete ref[10]
    mm = np.full(19, 6, np.int32)
    best, _, _ = sw_align_batch(
        rd[None], np.array([19]), mm[None], ref[None], np.array([20]), cfg)
    oracle = sw_score_numpy(rd, mm, ref, cfg)
    assert best[0] == oracle[0]
    assert best[0] == -cfg.rdg_open


def test_sw_all_mismatch_read():
    # read of A's vs ref of T's: engines agree with oracle even in the
    # pathological case (gapped paths can beat all-mismatch here)
    rd = np.zeros(16, np.uint8)           # AAAA...
    ref = np.full(20, 3, np.uint8)        # TTTT...
    mm = np.full(16, 6, np.int32)
    best, _, _ = sw_align_batch(
        rd[None], np.array([16]), mm[None], ref[None], np.array([20]), E2E)
    oracle = sw_score_numpy(rd, mm, ref, E2E)
    assert best[0] == oracle[0]
    assert best[0] <= -60  # still a terrible alignment


def test_sw_runs_on_the_given_device(rng):
    """device= places the DP on that device (a server worker's own
    card) with results equal to the default device's."""
    import jax
    B, lq, lc = 8, 20, 36
    probs = [random_problem(rng, lq, lc, E2E) for _ in range(B)]
    rd, mm, ref = (np.stack([p[i] for p in probs]) for i in range(3))
    lens, reflens = np.full(B, lq, np.int32), np.full(B, lc, np.int32)
    dev = jax.devices()[-1]
    got = sw_align_batch(rd, lens, mm, ref, reflens, E2E, device=dev)
    exp = sw_align_batch(rd, lens, mm, ref, reflens, E2E)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)
