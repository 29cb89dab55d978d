"""Multi-device SPMD pipeline tests (8 virtual CPU devices)."""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def mesh():
    import jax

    from kreeq_tpu.parallel.sharded import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    return make_mesh()


def _oracle(reads, asms, k):
    CM = {"A": 0, "C": 1, "G": 2, "T": 3}

    def canon(sub):
        vals = [CM[c] for c in sub]
        fw = sum(v << (2 * i) for i, v in enumerate(vals))
        rc = sum((3 - v) << (2 * i) for i, v in enumerate(reversed(vals)))
        return min(fw, rc)

    db = set()
    for r in reads:
        for p in range(len(r) - k + 1):
            db.add(canon(r[p:p + k]))
    tot = miss = 0
    for a in asms:
        for p in range(len(a) - k + 1):
            tot += 1
            if canon(a[p:p + k]) not in db:
                miss += 1
    return tot, miss


def test_sharded_pipeline_matches_oracle(mesh):
    import jax.numpy as jnp

    from kreeq_tpu.constants import seq_to_codes
    from kreeq_tpu.parallel.sharded import full_pipeline_fn

    n = mesh.devices.size
    k = 21
    chunk = 256
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), size=600))
    reads, asms = [], []
    read_codes = np.full((n, chunk), 4, np.uint8)
    asm_codes = np.full((n, chunk), 4, np.uint8)
    for d in range(n):
        r = genome[d * 60:d * 60 + 180]
        # the assembly diverges from the reads in places -> real misses
        a = list(genome[d * 55:d * 55 + 170])
        if d % 2 == 0 and len(a) > 90:
            a[90] = "ACGT"[(CMIDX := (ord(a[90]) + 1) % 4)]  # noqa: F841
        a = "".join(a)
        reads.append(r)
        asms.append(a)
        read_codes[d, :len(r)] = seq_to_codes(r)
        asm_codes[d, :len(a)] = seq_to_codes(a)

    step = full_pipeline_fn(mesh, k)
    _qf, _qc, tot, miss, _em, drop = step(jnp.asarray(read_codes),
                                          jnp.asarray(asm_codes))
    otot, omiss = _oracle(reads, asms, k)
    assert int(np.asarray(tot)[0]) == otot
    assert int(np.asarray(miss)[0]) == omiss
    assert omiss > 0  # the divergence actually exercised the miss path
    assert int(np.asarray(drop)[0]) == 0


def test_skewed_keys_drop_loudly_and_retry_exactly(mesh):
    """Adversarial skew (one repeated k-mer, all records owned by one
    shard) must overflow the capacity-factor bins LOUDLY — reported in
    the dropped counter, never silently — and the full-size-bin retry
    path must recover the exact counts."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import SENTINEL
    from kreeq_tpu.parallel.sharded import sharded_count_fn

    n = mesh.devices.size
    k = 15
    chunk = 4096  # large enough that 2x-fair-share bins can't hold a
    # single-owner chunk (capacity ~ 2*chunk/n << chunk)
    read_codes = np.zeros((n, chunk), np.uint8)  # poly-A: one key

    count = sharded_count_fn(mesh, k)
    _tk, _tc, _tf, _tb, _nv, drop = count(jnp.asarray(read_codes))
    assert int(np.asarray(drop)[0]) > 0  # overflow is accounted, loud

    full = sharded_count_fn(mesh, k, full_bins=True)
    tkeys, tcov, _f, _b, nv, drop = full(jnp.asarray(read_codes))
    assert int(np.asarray(drop)[0]) == 0
    tkeys, tcov = np.asarray(tkeys), np.asarray(tcov)
    real = tkeys != np.uint64(SENTINEL)
    assert real.sum() == 1  # poly-A has exactly one canonical k-mer
    assert int(tcov[real][0]) == n * (chunk - k + 1)


def test_from_reads_sharded_skew_retry(mesh, tmp_path):
    """KmerTable.from_reads on a skewed input retries overflowing
    blocks with full bins and matches the single-device build."""
    from kreeq_tpu.core.table import KmerTable

    rng = np.random.default_rng(11)
    seqs = ["A" * 3000 for _ in range(6)]
    seqs += ["".join(rng.choice(list("ACGT"), size=500)) for _ in range(4)]
    p = tmp_path / "skew.fasta"
    p.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))

    want = KmerTable.from_reads([str(p)], 15)
    got = KmerTable.from_reads([str(p)], 15, chunk=4096, mesh=mesh)
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.cov, want.cov)
    assert np.array_equal(got.fw, want.fw)
    assert np.array_equal(got.bw, want.bw)


def test_sharded_tables_match_host_table(mesh):
    import jax.numpy as jnp

    from kreeq_tpu.core.table import KmerTable
    from kreeq_tpu.ops.kmers import SENTINEL
    from kreeq_tpu.parallel.sharded import sharded_count_fn
    from kreeq_tpu.constants import seq_to_codes

    n = mesh.devices.size
    k = 15
    chunk = 128
    rng = np.random.default_rng(3)
    reads = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(n)]
    read_codes = np.full((n, chunk), 4, np.uint8)
    for d, r in enumerate(reads):
        read_codes[d, :len(r)] = seq_to_codes(r)

    count = sharded_count_fn(mesh, k)
    tkeys, tcov, _tfw, _tbw, nvalid, drop = count(jnp.asarray(read_codes))
    assert int(np.asarray(drop)[0]) == 0
    tkeys = np.asarray(tkeys)
    tcov = np.asarray(tcov)

    from kreeq_tpu.parallel.sharded import owner_of

    got = {}
    for d in range(n):
        for key, cov in zip(tkeys[d], tcov[d]):
            if key != int(np.uint64(SENTINEL)):
                assert int(owner_of(np.uint64(key), n)) == d  # ownership
                got[int(key)] = got.get(int(key), 0) + int(cov)

    import tempfile

    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i, r in enumerate(reads):
            p = f"{td}/r{i}.fasta"
            with open(p, "w") as fh:
                fh.write(f">r{i}\n{r}\n")
            paths.append(p)
        want = KmerTable.from_reads(paths, k)
        # explicit-mesh build must agree with the single-device build
        sharded = KmerTable.from_reads(paths, k, chunk=256, mesh=mesh)
    assert got == {int(want.keys[i]): int(want.cov[i])
                   for i in range(len(want))}
    assert np.array_equal(sharded.keys, want.keys)
    assert np.array_equal(sharded.cov, want.cov)
    assert np.array_equal(sharded.fw, want.fw)
    assert np.array_equal(sharded.bw, want.bw)


def test_sharded_union_merge_matches_single_device(mesh):
    """merge_sharded (key-range partition + per-shard saturating
    merges) must equal the single-device merge, including u32
    saturation on keys present in both tables."""
    from kreeq_tpu.core.table import KmerTable

    rng = np.random.default_rng(21)
    k = 21

    def mk_table(nkeys, seed):
        r = np.random.default_rng(seed)
        keys = np.unique(r.integers(0, 1 << 42, nkeys, dtype=np.uint64))
        cov = r.integers(1, 1 << 31, len(keys), dtype=np.uint32)
        fw = r.integers(0, 1 << 31, (len(keys), 4), dtype=np.uint32)
        bw = r.integers(0, 1 << 31, (len(keys), 4), dtype=np.uint32)
        return KmerTable(k, keys, cov, fw, bw)

    a = mk_table(5000, 1)
    b = mk_table(3000, 2)
    # force overlap (saturating adds: 2^31-scale values sum within u32
    # range normally; plant a few saturating rows explicitly)
    b.keys[:500] = a.keys[1000:1500]
    order = np.argsort(b.keys, kind="stable")
    b = KmerTable(k, b.keys[order], b.cov[order], b.fw[order],
                  b.bw[order])
    i = np.searchsorted(b.keys, a.keys[1000])
    b.cov[i] = np.uint32(0xFFFFFFF0)  # forces saturation with a's cov

    want = a.merge(b)  # single-device path (small input, no force)
    got = a.merge_sharded(b, mesh)
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.cov, want.cov)
    assert np.array_equal(got.fw, want.fw)
    assert np.array_equal(got.bw, want.bw)
    assert rng is not None


@pytest.mark.slow
def test_sharded_probe_scale_fast_path(mesh):
    """~8M keys/device on the virtual 8-device mesh.

    Asserts the capacity-factor fast path holds (zero dropped records
    in count AND probe — no full-bin retry needed) and that the routed
    probe's per-position answers exactly match a host oracle over the
    concatenated shard tables."""
    import time

    import jax
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import SENTINEL, kmer_positions
    from kreeq_tpu.parallel.sharded import (probe_bits,
                                            sharded_bucket_fn,
                                            sharded_count_fn,
                                            sharded_probe_fn)

    n = mesh.devices.size
    k = 31
    read_chunk = 1 << 23   # ~8.4M positions/device -> ~8M keys/shard
    asm_chunk = 1 << 21
    rng = np.random.default_rng(5)
    read_codes = rng.integers(0, 4, (n, read_chunk)).astype(np.uint8)
    # assembly rows resample read windows (hits) + fresh noise (misses)
    asm_codes = np.empty((n, asm_chunk), np.uint8)
    for d in range(n):
        asm_codes[d, :asm_chunk // 2] = \
            read_codes[(d + 1) % n, :asm_chunk // 2]
        asm_codes[d, asm_chunk // 2:] = \
            rng.integers(0, 4, asm_chunk - asm_chunk // 2)

    count = sharded_count_fn(mesh, k)
    tkeys, tcov, tfw, tbw, nvalid, drop = count(jnp.asarray(read_codes))
    jax.block_until_ready(tkeys)
    assert int(np.asarray(drop)[0]) == 0  # count fast path held
    rows = tkeys.shape[-1]
    nv = np.asarray(nvalid)
    assert nv.min() >= (1 << 23) * 0.9 / 1.05, (
        f"expected ~8M keys/device, got min {nv.min()}")

    bits = probe_bits(rows, k)
    starts = sharded_bucket_fn(mesh, k, bits)(tkeys)
    probe = sharded_probe_fn(mesh, k, bits)
    t0 = time.perf_counter()
    qfound, qcov, tot, miss, emiss, pdrop = probe(
        tkeys, tcov, tfw, tbw, starts, jnp.asarray(asm_codes))
    jax.block_until_ready(qfound)
    dt = time.perf_counter() - t0
    assert int(np.asarray(pdrop)[0]) == 0  # probe fast path held
    print(f"\nsharded probe: {n}x{asm_chunk - k + 1} queries vs "
          f"{nv.sum()} keys in {dt:.2f}s (virtual CPU mesh)")

    # host oracle over the concatenated shard tables
    hk = np.asarray(tkeys).reshape(-1)
    hc = np.asarray(tcov).reshape(-1)
    real = hk != np.uint64(SENTINEL)
    hk, hc = hk[real], hc[real]
    order = np.argsort(hk, kind="stable")
    hk, hc = hk[order], hc[order]
    qf = np.asarray(qfound)
    qc = np.asarray(qcov)
    for d in range(n):
        keys, _isfw, _e, valid = kmer_positions(
            jnp.asarray(asm_codes[d]), k)
        keys, valid = np.asarray(keys), np.asarray(valid)
        i = np.clip(np.searchsorted(hk, keys), 0, len(hk) - 1)
        found = (hk[i] == keys) & valid
        assert np.array_equal(qf[d], found)
        assert np.array_equal(qc[d], np.where(found, hc[i], 0))
    assert int(np.asarray(miss)[0]) > 0  # noise produced real misses
