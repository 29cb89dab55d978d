"""Out-of-core table windowing (KREEQ_TPU_MAX_TABLE_ROWS cap).

The reference runs any DB size on bounded RAM by paging map-range
windows and rescanning (reference: src/kreeq.cpp:59-76,
src/graph-builder.cpp:213-216).  The device analog partitions the sorted
table by key range; one window is device-resident at a time, queries
are probed per window, and results combine across windows.  Forced
tiny caps must be observably identical to the unwindowed path.
"""

import io
import os

import numpy as np
import pytest


def _mk_inputs(tmp_path, n=5000, k=21, seed=0):
    rng = np.random.default_rng(seed)
    genome_seq = "".join(rng.choice(list("ACGT"), size=n))
    reads = [genome_seq[i:i + 150] for i in range(0, n - 200, 40)]
    rp = str(tmp_path / "r.fasta")
    with open(rp, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">r{i}\n{r}\n")
    asm = list(genome_seq[:n - 1000])
    for pos in (500, 1500, 2600, 3333):
        asm[pos] = "ACGT"[("ACGT".index(asm[pos]) + 1) % 4]
    ap = str(tmp_path / "a.fasta")
    with open(ap, "w") as fh:
        fh.write(">a\n" + "".join(asm) + "\n")
    return ap, rp


def test_probe_windowed_matches(tmp_path):
    from kreeq_tpu.core.table import KmerTable

    ap, rp = _mk_inputs(tmp_path)
    table = KmerTable.from_reads([rp], 21)
    assert table.window_ranges() is None

    rng = np.random.default_rng(1)
    qkeys = np.concatenate([
        table.keys[rng.integers(0, len(table), 300)],  # hits
        rng.integers(0, 1 << 42, 300).astype(np.uint64),  # mostly misses
    ])
    base = table.probe(qkeys)

    os.environ["KREEQ_TPU_MAX_TABLE_ROWS"] = "37"  # force many windows
    try:
        ranges = table.window_ranges()
        assert ranges is not None and len(ranges) >= 3
        # ranges tile [0, n) exactly
        assert ranges[0][0] == 0 and ranges[-1][1] == len(table)
        for (a, b), (c, d) in zip(ranges, ranges[1:]):
            assert b == c and a < b
        win = table.probe(qkeys)
    finally:
        del os.environ["KREEQ_TPU_MAX_TABLE_ROWS"]

    for b, w in zip(base, win):
        assert np.array_equal(np.asarray(b), np.asarray(w))
    assert base[0][:300].all()  # the planted hits were found


def test_validate_windowed_table_matches(tmp_path):
    """Full validate (tracks + QV totals) under a forced 4-window cap
    equals unwindowed."""
    from kreeq_tpu.config import UserInput
    from kreeq_tpu.core.dbg import DBG
    from kreeq_tpu.core.table import KmerTable
    from kreeq_tpu.io.fastx import load_genome
    from kreeq_tpu.io.sequence import Genome

    ap, rp = _mk_inputs(tmp_path)

    def run():
        ui = UserInput(mode=0, in_sequence=ap, in_reads=[rp])
        table = KmerTable.from_reads([rp], 21)
        dbg = DBG(ui, table)
        g = Genome()
        load_genome(ap, g)
        dbg.load_genome(g)
        out = io.StringIO()
        dbg.validate_sequences(out=out)
        tracks = [(t.cov.tobytes(), t.right.tobytes(), t.left.tobytes(),
                   t.isfw.tobytes()) for t in dbg.tracks]
        return (dbg.tot_missing, dbg.tot_edge_missing, dbg.tot_kcount,
                tracks, out.getvalue())

    base = run()
    os.environ["KREEQ_TPU_MAX_TABLE_ROWS"] = "1024"
    try:
        win = run()
    finally:
        del os.environ["KREEQ_TPU_MAX_TABLE_ROWS"]
    assert base == win
    assert base[0] > 0


@pytest.mark.skipif(
    not os.path.isdir("/root/reference/validateFiles"),
    reason="reference corpus unavailable")
@pytest.mark.parametrize("num", [0, 47, 50])
def test_golden_windowed(num):
    """Golden stdout is byte-identical under a forced tiny table cap
    (windowed DB) — the surrogate for 'any DB size on bounded memory'.
    Covers validate QV (test.0), subgraph traversal (test.47) and
    variant calling (test.50, modulo its pinned known-diff line)."""
    from .test_golden import KNOWN_DIFF, load_tst, run_cli

    tst = f"/root/reference/validateFiles/test.{num}.tst"
    cmd, expected = load_tst(tst)
    os.environ["KREEQ_TPU_MAX_TABLE_ROWS"] = "16"
    try:
        actual = run_cli(cmd)
    finally:
        del os.environ["KREEQ_TPU_MAX_TABLE_ROWS"]
    got = actual.rstrip("\n").splitlines()
    want = expected.rstrip("\n").splitlines()
    known = KNOWN_DIFF.get(num, {})
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == (known.get(i, w)), f"line {i}: {g!r} != {w!r}"


def test_host_merge_matches_device(tmp_path):
    """Forced-host tree merges (KREEQ_TPU_HOST_MERGE_ROWS) must build
    a bitwise-identical table — the out-of-core build path for tables
    whose merges would exceed HBM."""
    from kreeq_tpu.core.table import KmerTable

    ap, rp = _mk_inputs(tmp_path)
    base = KmerTable.from_reads([rp], 21)
    os.environ["KREEQ_TPU_HOST_MERGE_ROWS"] = "8"
    try:
        host = KmerTable.from_reads([rp], 21)
    finally:
        del os.environ["KREEQ_TPU_HOST_MERGE_ROWS"]
    assert np.array_equal(base.keys, host.keys)
    assert np.array_equal(base.cov, host.cov)
    assert np.array_equal(base.fw, host.fw)
    assert np.array_equal(base.bw, host.bw)


def test_host_merge_union_saturates():
    """host_merge_sorted saturates overlapping counters at LARGEST
    exactly like the device merge (reference u32 clamp,
    src/graph-builder.cpp:196-204)."""
    from kreeq_tpu.core.table import KmerTable, host_merge_sorted

    ak = np.array([5, 10, 20], np.uint64)
    ac = np.array([0xFFFFFFFE, 7, 1], np.uint32)
    af = np.tile(np.array([1, 0, 0, 0], np.uint32), (3, 1))
    ab = np.zeros((3, 4), np.uint32)
    bk = np.array([1, 10, 30], np.uint64)
    bc = np.array([2, 0xFFFFFFFF, 3], np.uint32)
    bf = np.tile(np.array([0, 2, 0, 0], np.uint32), (3, 1))
    bb = np.ones((3, 4), np.uint32)
    mk, mc, mf, mb = host_merge_sorted(ak, ac, af, ab, bk, bc, bf, bb)
    assert mk.tolist() == [1, 5, 10, 20, 30]
    assert mc.tolist() == [2, 0xFFFFFFFE, 0xFFFFFFFF, 1, 3]  # saturated
    assert mf[2].tolist() == [1, 2, 0, 0]

    # cross-check against the device union on the same data
    ta = KmerTable(21, ak, ac, af, ab)
    tb = KmerTable(21, bk, bc, bf, bb)
    tu = ta.merge(tb)
    assert np.array_equal(tu.keys, mk)
    assert np.array_equal(tu.cov, mc)
    assert np.array_equal(tu.fw, mf)
    assert np.array_equal(tu.bw, mb)
