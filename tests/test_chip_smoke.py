"""chip_smoke.py's CPU-testable parts: SAM comparison, origin and
concordance checks, the CLI's path-counter line, the DP checks at a tiny
size, and failing without a GPU."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def rec(name, flag, pos, *rest):
    return [name, str(flag), "chr", str(pos), "42", "10M", *rest]


def write_sam(path, records, header=True):
    with open(path, "w") as f:
        if header:
            f.write("@HD\tVN:1.0\n@SQ\tSN:chr\tLN:100\n")
        for r in records:
            f.write("\t".join(r) + "\n")


def test_sam_records_drop_headers(tmp_path):
    p = tmp_path / "a.sam"
    write_sam(p, [rec("b0", 0, 5), rec("b1", 16, 9)])
    assert [r[0] for r in cs.sam_records(p)] == ["b0", "b1"]


def test_primary_by_key_skips_secondary_and_keys_mates():
    recs = [rec("p0", 99, 5), rec("p0", 147, 50), rec("p0", 256 | 99, 7),
            rec("b1", 0, 3)]
    prim = cs.primary_by_key(recs)
    assert set(prim) == {("p0", 0x40), ("p0", 0x80), ("b1", 0)}


def test_primary_by_key_rejects_two_primaries():
    with pytest.raises(cs.SmokeFailure):
        cs.primary_by_key([rec("b0", 0, 5), rec("b0", 16, 9)])


def test_compare_records_reports_missing_and_changed_fields():
    ref = cs.primary_by_key([rec("b0", 0, 5, "AS:i:0"),
                             rec("b1", 0, 7, "AS:i:-6"),
                             rec("b2", 4, 0)])
    got = cs.primary_by_key([rec("b0", 0, 5, "AS:i:0"),
                             rec("b1", 0, 8, "AS:i:-6")])
    bad = cs.compare_records(got, ref)
    assert len(bad) == 2
    assert any("b2" in b and "missing" in b for b in bad)
    assert any("b1" in b and "[3]" in b for b in bad)
    assert cs.compare_records(ref, ref) == []


def test_placement_checks_origin_and_strand():
    starts = np.array([4, 6, 10, 0])
    rc = np.array([False, True, False, False])
    prim = cs.primary_by_key([rec("b0", 0, 5), rec("b1", 16, 7),
                              rec("b2", 16, 11), rec("b3", 4, 0)])
    # b0, b1 placed; b2 on the wrong strand; b3 unaligned
    assert cs.placement(prim, starts, rc) == (3, 2)


def test_concordant_counts_proper_mate1():
    prim = cs.primary_by_key([rec("p0", 99, 5), rec("p0", 147, 50),
                              rec("p1", 65, 5), rec("p1", 129, 50)])
    assert cs.concordant(prim) == 1


def test_parse_paths_reads_cli_line():
    err = ("# 65536 reads in 40.0s = 1638 reads/s\n"
           "# first batch 31.2s; batches: fused 2, capacity escalations 0,"
           " host path 0\n")
    assert cs.parse_paths(err) == {"first": 31.2, "fused": 2,
                                   "escalated": 0, "host": 0}
    with pytest.raises(cs.SmokeFailure):
        cs.parse_paths("# nothing here\n")


def test_cli_prints_path_counters(tmp_path, capsys):
    """The align CLI reports first-batch time and fused/escalated/host
    batch counts on stderr, in the form chip_smoke parses."""
    from bowtie2_server_tpu.__main__ import main
    from bowtie2_server_tpu.utils import dna
    rng = np.random.default_rng(5)
    g = dna.decode(rng.integers(0, 4, 5000).astype(np.uint8))
    fq = tmp_path / "r.fq"
    starts = rng.integers(0, 5000 - 50, 40)
    with open(fq, "w") as f:
        for i, s in enumerate(starts):
            f.write(f"@b{i}\n{g[s:s + 50]}\n+\n{'I' * 50}\n")
    main(["align", "--cpu", "--ref-string", g, "-U", str(fq), "-S",
          str(tmp_path / "o.sam"), "--batch", "16"])
    paths = cs.parse_paths(capsys.readouterr().err)
    assert paths["fused"] == 3 and paths["escalated"] == 0
    assert paths["host"] == 0 and paths["first"] is not None
    n_al, n_ok = cs.placement(cs.primary_by_key(
        cs.sam_records(tmp_path / "o.sam")), starts, np.zeros(40, bool))
    assert n_al == n_ok == 40


def test_kernel_checks_pass_on_cpu_engines():
    """Phase 1's comparisons, at a tiny size, on the CPU engines."""
    cs.check_kernels(64, 8)


def test_no_gpu_fails_without_result():
    p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stdout + p.stderr


def test_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == "" or not p.stdout.strip().startswith("{")
    with pytest.raises(json.JSONDecodeError):
        json.loads(p.stdout.strip().splitlines()[-1] if p.stdout.strip()
                   else "")
