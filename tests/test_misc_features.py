"""Feature locks for paths not covered by the golden corpus."""

import contextlib
import io
import os
import shlex

import pytest

from .conftest import REFERENCE, reference_available

pytestmark = pytest.mark.skipif(not reference_available(),
                                reason="reference corpus not present")


def _run(cmd, cwd=REFERENCE):
    from kreeq_tpu.cli.main import run

    old = os.getcwd()
    buf = io.StringIO()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(buf):
            run(shlex.split(cmd))
    finally:
        os.chdir(old)
    return buf.getvalue()


def test_subgraph_bed_include(tmp_path):
    """-p restricts the subgraph to BED spans (fewer k-mers kept)."""
    bed = tmp_path / "roi.bed"
    bed.write_text("sequence1\t5\t30\n")  # begin>0: the reference skips spans starting at 0
    full = _run("kreeq subgraph -d testFiles/test1.kreeq "
                "-f testFiles/random1.fasta --search-depth 0 --no-collapse")
    sub = _run("kreeq subgraph -d testFiles/test1.kreeq "
               "-f testFiles/random1.fasta --search-depth 0 --no-collapse "
               f"-p {bed}")

    def distinct(out):
        for line in out.splitlines():
            if line.startswith("Distinct"):
                return int(line.split()[-1])

    assert distinct(sub) < distinct(full)
    assert distinct(sub) > 0


def test_decompressor_expand(tmp_path):
    """--expand reproduces the sliding-window per-base table."""
    from kreeq_tpu.cli.decompressor import run as drun

    buf = io.StringIO()
    old = os.getcwd()
    try:
        os.chdir(REFERENCE)
        with contextlib.redirect_stdout(buf):
            drun(["kreeq-decompressor", "inflate", "-i",
                  "testFiles/decompressor2.bkwig", "--expand"])
    finally:
        os.chdir(old)
    lines = buf.getvalue().splitlines()
    # 50 bases of sequence1, each row: header,absPos,k covs,k fw,k bw
    assert len(lines) == 50
    first = lines[0].split(",")
    assert first[0] == "sequence1" and first[1] == "0"
    assert len(first) == 2 + 3 * 21


def test_union_three_databases():
    out = _run("kreeq union -d testFiles/test1.kreeq testFiles/test2.kreeq "
               "testFiles/random5.kreeq")
    assert "DBG Summary statistics:" in out
    tot = int([l for l in out.splitlines()
               if l.startswith("Total kmers")][0].split()[-1])
    assert tot > 1572  # more than the two-DB union golden


def test_union_writes_database(tmp_path):
    _run("kreeq union -d testFiles/test1.kreeq testFiles/test2.kreeq "
         f"-o {tmp_path}/u.kreeq")
    from kreeq_tpu.io.kreeqdb import read_kreeq

    db = read_kreeq(str(tmp_path / "u.kreeq"))
    st = db.stats()
    assert (st.total, st.unique, st.distinct,
            st.edges) == (1572, 13, 115, 196)  # test.35 golden numbers


def test_iupac_kmers_never_probe_found(tmp_path):
    """A k-mer containing a non-ACGT IUPAC base (other than N, which is
    split out of segments entirely) must never probe as found, even when
    the reads contain its A-substituted twin: the reference hashes the
    raw code>3 byte into a key that misses the DB, so aliasing the
    masked codes to 'A' would wrongly suppress the anomaly (and seed
    variant searches from phantom sources)."""
    left = "ACGGTTCAGCATGCGTTAGCATCGGATCCA"   # 30 bases
    right = "GTTCAACGGTCAGGCATTCCGAATGCCTT"   # 29 bases
    (tmp_path / "reads.fastq").write_text(
        "".join(f"@r{i}\n{left}A{right}\n+\n{'I' * 60}\n" for i in range(4)))
    (tmp_path / "asm.fasta").write_text(f">seqN\n{left}R{right}\n")
    _run("kreeq validate -f asm.fasta -r reads.fastq "
         "--detect-anomalies anom.bed -o out.vcf", cwd=tmp_path)
    # k=21, R at index 30: k-mer starts 10..30 contain it and must all
    # be anomalous (merged 1-based range 11..31)
    assert (tmp_path / "anom.bed").read_text() == "seqN\t11\t31\n"
    # the variant caller still legitimately corrects the R via a search
    # seeded at the last VALID k-mer (c=9), reconnecting through the
    # read graph to the first valid target past the R — but no searches
    # are seeded from phantom (A-aliased) invalid source k-mers
    records = [l.split("\t") for l in
               (tmp_path / "out.vcf").read_text().splitlines()
               if l and not l.startswith("#")]
    assert [(r[0], r[1], r[3], r[4]) for r in records] == [
        ("seqN", "31", "R", "A")]


def test_stdin_reads(monkeypatch):
    """`cat reads.fastq | kreeq validate -r -` matches the file path run
    (reference StreamObj pipe support; gfalibs stream-obj.h)."""
    import io as _io
    import sys

    data = open(os.path.join(REFERENCE, "testFiles/random1.fastq"),
                "rb").read()

    class Stdin:
        buffer = _io.BytesIO(data)

    monkeypatch.setattr(sys, "stdin", Stdin())
    out = _run("kreeq validate -f testFiles/random1.fasta -r -")
    want = _run("kreeq validate -f testFiles/random1.fasta "
                "-r testFiles/random1.fastq")
    assert out == want and "QV" in out


def test_stdin_assembly_gz(monkeypatch):
    """`-f -` reads a (gzipped) assembly from stdin."""
    import gzip as _gzip
    import io as _io
    import sys

    raw = open(os.path.join(REFERENCE, "testFiles/random1.fasta"),
               "rb").read()

    class Stdin:
        buffer = _io.BytesIO(_gzip.compress(raw))

    monkeypatch.setattr(sys, "stdin", Stdin())
    out = _run("kreeq validate -f - -r testFiles/random1.fastq")
    want = _run("kreeq validate -f testFiles/random1.fasta "
                "-r testFiles/random1.fastq")
    assert out == want


def _run_expect_exit(cmd, cwd, capsys):
    from kreeq_tpu.cli.main import run

    old = os.getcwd()
    try:
        os.chdir(cwd)
        with pytest.raises(SystemExit) as exc:
            run(shlex.split(cmd))
    finally:
        os.chdir(old)
    code = exc.value.code if exc.value.code is not None else 0
    return code, capsys.readouterr().err


def test_union_mismatched_k_fatal(tmp_path, capsys):
    """Reference: src/input.cpp:137-140."""
    for name, k in (("a.kreeq", 21), ("b.kreeq", 22)):
        d = tmp_path / name
        d.mkdir()
        (d / ".index").write_text(f"{k}\n128\n")
    code, err = _run_expect_exit(
        "kreeq union -d a.kreeq b.kreeq", tmp_path, capsys)
    assert code == 1
    assert err == "Cannot merge databases with different kmer length.\n"


def test_union_invalid_k_fatal(tmp_path, capsys):
    """Reference: src/input.cpp:142-145 (k==0 or k>32)."""
    for name in ("a.kreeq", "b.kreeq"):
        d = tmp_path / name
        d.mkdir()
        (d / ".index").write_text("33\n128\n")
    code, err = _run_expect_exit(
        "kreeq union -d a.kreeq b.kreeq", tmp_path, capsys)
    assert code == 1
    assert err == "Invalid kmer length.\n"


def test_missing_file_fatal(tmp_path, capsys):
    """Reference: gfalibs ifFileExists (called at src/main.cpp:140)."""
    code, err = _run_expect_exit(
        "kreeq validate -f nope.fasta -r also_nope.fastq", tmp_path, capsys)
    assert code == 1
    assert "does not exist" in err


def test_bad_mode_fatal(tmp_path, capsys):
    """Reference: src/main.cpp:70-72."""
    code, err = _run_expect_exit("kreeq bogus -f x -r y", tmp_path, capsys)
    assert code == 1
    assert err == "mode bogus does not exist. Terminating\n"


def test_anomalies_snapshot(tmp_path):
    """detect_anomalies output locked as a regression snapshot
    (semantically faithful to reference src/variants.cpp:406-456; the
    shipped legacy fixture was generated from unknown older inputs)."""
    out = tmp_path / "anom.bed"
    _run("kreeq validate -f testFiles/to_correct.fasta "
         "-r testFiles/to_correct.fastq "
         f"--detect-anomalies {out}")
    lines = out.read_text().splitlines()
    assert lines[0] == "sequence2\t4\t25"
    assert lines[1] == "sequence2\t44\t65"
    assert "sequence15\t26\t46" in lines or len(lines) > 20


def test_warmup_mode(capsys):
    """`kreeq warmup --small` compiles the (tiny) shape grid and
    reports the program count (cold-start mitigation path)."""
    from kreeq_tpu.cli.main import run

    rc = run(["kreeq", "warmup", "--small"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "programs compiled/cached" in out


def test_verbose_heartbeat_bounded(monkeypatch, capsys):
    """The verbose heartbeat (watchdog liveness during silent XLA
    compiles) emits while idle, stands down after the max-silent bound
    so a genuine wedge still trips log-growth watchdogs, and re-arms on
    the next real message."""
    import importlib
    import time as _time

    monkeypatch.setenv("KREEQ_TPU_HEARTBEAT_S", "0.2")
    monkeypatch.setenv("KREEQ_TPU_HEARTBEAT_MAX_SILENT_S", "0.7")
    from kreeq_tpu.utils import log as _log

    log = importlib.reload(_log)
    try:
        log.set_flags(verbose=True)
        log.verbose("real")
        _time.sleep(1.3)  # a few beats, then past the bound
        err = capsys.readouterr().err
        assert "heartbeat: alive" in err
        assert "standing down" in err
        assert not log._hb_thread.is_alive()

        log.verbose("real again")  # re-arms
        _time.sleep(0.5)
        err = capsys.readouterr().err
        assert "heartbeat: alive" in err
        assert log._hb_thread.is_alive()
    finally:
        log.set_flags(verbose=False)  # silence the reloaded module
        importlib.reload(_log)        # restore shared module state
