"""chip_smoke.py: its numpy reference and its refusal to run without a
GPU.  The GPU run itself is `python chip_smoke.py` on a machine with a
card (README "Running it")."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_reference_matches_the_build(tmp_path):
    """The smoke's numpy count over all reads agrees with a build by
    KmerTable.from_reads of the same FASTQ, on totals and on every
    sampled key's cov and fw/bw edges; its Merqury numbers agree with
    the table's probe of the assembly."""
    from kreeq_tpu.core.table import KmerTable

    rng = np.random.default_rng(5)
    g = chip_smoke.make_genome(rng, 20_000)
    reads = chip_smoke.make_reads(rng, g, 2_000)
    chip_smoke.write_fastq(str(tmp_path / "r.fq"), reads, 0)
    contigs = [("c0", g[:9_000]), ("c1", g[9_000:])]
    ref = chip_smoke.Reference(reads, contigs, np.random.default_rng(6), 2)
    table = KmerTable.from_reads([str(tmp_path / "r.fq")], chip_smoke.K)
    assert "exact" in chip_smoke.check_build(table, ref)
    assert (ref.sample_cov > 0).any() and (ref.sample_cov == 0).any()

    found, cov, _fw, _bw = table.probe(np.concatenate(ref.asm_keys))
    missing, total, _qv = ref.merqury()
    assert total == len(found)
    assert missing == int((~found).sum())
    assert np.array_equal(np.concatenate(ref.asm_cov), cov)


def test_reference_sees_planted_substitutions():
    """Each planted substitution takes the assembly k-mers over it out
    of error-free reads."""
    rng = np.random.default_rng(1)
    g = chip_smoke.make_genome(rng, 30_000)
    reads = np.stack([g[s:s + chip_smoke.READ_LEN] for s in
                      rng.integers(0, len(g) - 150, 4_000)])
    contigs, planted = chip_smoke.make_assembly(rng, g)
    ref = chip_smoke.Reference(reads, contigs, np.random.default_rng(2), 2)
    for ci, pos, _g, _a in planted:
        lo = max(pos - chip_smoke.K + 1, 0)
        assert (ref.asm_cov[ci][lo:pos + 1] == 0).all()


@pytest.mark.parametrize("k", [21, 31])
def test_canonical_keys_match_a_per_kmer_loop(k):
    """The smoke's vectorised canonical keys equal min(forward, reverse
    complement) packed one k-mer at a time, first base in the low
    bits."""
    rng = np.random.default_rng(k)
    rows = rng.integers(0, 4, (3, 60), dtype=np.uint8)
    keys, isfw = chip_smoke.canonical_keys(rows, k)
    for r in range(rows.shape[0]):
        for i in range(rows.shape[1] - k + 1):
            kmer = [int(c) for c in rows[r, i:i + k]]
            fw = sum(c << (2 * j) for j, c in enumerate(kmer))
            rc = sum((3 - c) << (2 * j)
                     for j, c in enumerate(reversed(kmer)))
            assert int(keys[r, i]) == min(fw, rc)
            assert bool(isfw[r, i]) == (fw <= rc)


def test_fastq_reads_back_through_the_cli_reader(tmp_path):
    """write_fastq's fixed-width records parse back, by the reader the
    CLI uses, to the reads that were written."""
    from kreeq_tpu.io.fastx import iter_reads

    rng = np.random.default_rng(3)
    g = chip_smoke.make_genome(rng, 5_000)
    reads = chip_smoke.make_reads(rng, g, 300, batch=128)
    path = str(tmp_path / "r.fq")
    chip_smoke.write_fastq(path, reads, 123_456)
    back = [np.frombuffer(s.encode(), np.uint8) if isinstance(s, str)
            else chip_smoke.BASES[np.asarray(s)] for s in iter_reads(path)]
    assert len(back) == len(reads)
    for got, want in zip(back, reads):
        assert np.array_equal(got, chip_smoke.BASES[want])
    with open(path) as fh:
        assert fh.readline() == "@r000123456\n"


def test_recall_counts_exact_calls_only(tmp_path):
    """A planted substitution counts as recalled only when a record
    sits at its 1-based position with REF the assembly's base and ALT
    the genome's."""
    smoke = chip_smoke.Smoke.__new__(chip_smoke.Smoke)
    smoke.work = str(tmp_path)
    # (contig, 0-based pos, genome base, assembly base); A=0 C=1 G=2 T=3
    smoke.planted = [(0, 99, 1, 3), (0, 199, 0, 2), (0, 299, 2, 1),
                     (1, 99, 0, 1)]
    (tmp_path / "x.vcf").write_text(
        "##fileformat=VCFv4.2\n"
        "ctg0\t100\t.\tT\tC\t0\tPASS\t.\tGT:GQ\t1/1:0\n"  # exact
        "ctg0\t200\t.\tG\tC\t0\tPASS\t.\tGT:GQ\t1/1:0\n"  # wrong ALT
        "ctg0\t301\t.\tC\tG\t0\tPASS\t.\tGT:GQ\t1/1:0\n"  # off by one
        "ctg1\t100\t.\tC\tA\t0\tPASS\t.\tGT:GQ\t1/1:0\n")  # ctg1
    assert smoke.recall("x.vcf") == \
        "4 records, recall of planted substitutions 1/3"


@pytest.mark.parametrize("alone", [False, True])
def test_no_gpu_no_result(tmp_path, alone):
    """Without a GPU (here: the CPU platform), and in a directory that
    holds nothing of the repo but the script, the smoke exits non-zero
    and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script), "--genome-mbp",
                          "0.05", "--workdir", str(tmp_path / "w")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "FAIL: no GPU" in out.stderr
