"""Device ops against numpy references written here.

Each test runs one op of the build/validate path (count, probe, QV
classification, merge, context selection, prefix sums) on seeded
inputs and compares it with a direct numpy re-statement of the same
semantics: per-window loops for extraction, np.unique for counting, a
dict for lookups.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

BAD = 4
SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
LARGEST = 0xFFFFFFFF
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def np_kmers(codes, k):
    """Per-position (key, isfw, edge bits, valid), straight from the
    definitions: key = OR_i code[p+i] << 2i, reverse complement, and
    canonical = min; edge bit w = fw edge to base w, 4+w = bw edge."""
    codes = np.asarray(codes, np.uint8)
    p = len(codes) - k + 1
    c = (codes & 3).astype(np.uint64)
    fw = np.zeros(p, np.uint64)
    rc = np.zeros(p, np.uint64)
    valid = np.ones(p, bool)
    for i in range(k):
        fw |= c[i:i + p] << np.uint64(2 * i)
        rc |= (np.uint64(3) - c[i:i + p]) << np.uint64(2 * (k - 1 - i))
        valid &= codes[i:i + p] <= 3
    isfw = fw <= rc
    keys = np.where(isfw, fw, rc)
    prev = np.concatenate([[BAD], codes[:p - 1]]).astype(np.int64)
    nxt = np.concatenate([codes[k:], [BAD]]).astype(np.int64)
    prev_ok, next_ok = prev <= 3, nxt <= 3
    pc, nc = prev & 3, nxt & 3
    e_fw = (np.where(next_ok, 1 << nc, 0)
            | np.where(prev_ok, 1 << (4 + pc), 0))
    e_rc = (np.where(prev_ok, 1 << (3 - pc), 0)
            | np.where(next_ok, 1 << (7 - nc), 0))
    edges = np.where(isfw, e_fw, e_rc)
    return keys, isfw, edges, valid


def np_count(codes, k):
    """Sorted unique table (keys, cov, fw[.,4], bw[.,4]) of the valid
    k-mers of `codes`."""
    keys, _isfw, edges, valid = np_kmers(codes, k)
    keys, edges = keys[valid], edges[valid]
    u, inv = np.unique(keys, return_inverse=True)
    cov = np.bincount(inv, minlength=len(u)).astype(np.uint32)

    def col(bit):
        return np.bincount(inv, weights=(edges >> bit) & 1,
                           minlength=len(u)).astype(np.uint32)

    fw = np.stack([col(w) for w in range(4)], axis=1)
    bw = np.stack([col(4 + w) for w in range(4)], axis=1)
    return u, cov, fw, bw


def np_classify(table, codes, k, cutoff):
    """The per-position QV classification (valid, missing,
    edge_missing, cov, isfw, right, left) by dict lookups."""
    tkeys, tcov, tfw, tbw = table
    rows = {int(key): i for i, key in enumerate(tkeys)}
    codes = np.asarray(codes, np.uint8)
    n = len(codes)
    keys, isfw, _edges, valid = np_kmers(codes, k)
    p = len(keys)
    out = {name: np.zeros(p, dt) for name, dt in (
        ("missing", bool), ("edge_missing", bool), ("cov", np.uint32),
        ("right", np.uint32), ("left", np.uint32))}
    for i in range(p):
        row = rows.get(int(keys[i])) if valid[i] else None
        has_next = i + k < n and codes[i + k] <= 3
        has_prev = i > 0 and codes[i - 1] <= 3
        cov = right = left = 0
        if row is not None:
            cov = int(tcov[row])
            if has_next:
                nc = codes[i + k]
                right = tfw[row, nc] if isfw[i] else tbw[row, 3 - nc]
            if has_prev:
                pc = codes[i - 1]
                left = tbw[row, pc] if isfw[i] else tfw[row, 3 - pc]
        missing = cov == 0 or cov < cutoff
        edge_missing = (valid[i] and not missing
                        and has_prev and left == 0
                        and has_next and right == 0)
        out["missing"][i] = missing
        out["edge_missing"][i] = edge_missing
        out["cov"][i] = cov
        out["right"][i] = 0 if missing else right
        out["left"][i] = 0 if missing else left
    return (valid, out["missing"], out["edge_missing"], out["cov"], isfw,
            out["right"], out["left"])


def np_lookup(table, qkeys):
    tkeys, tcov, tfw, tbw = table
    rows = {int(key): i for i, key in enumerate(tkeys) if key != SENT}
    q = len(qkeys)
    found = np.zeros(q, bool)
    cov = np.zeros(q, np.uint32)
    fw = np.zeros((q, 4), np.uint32)
    bw = np.zeros((q, 4), np.uint32)
    for i, key in enumerate(qkeys):
        row = rows.get(int(key)) if key != SENT else None
        if row is not None:
            found[i] = True
            cov[i], fw[i], bw[i] = tcov[row], tfw[row], tbw[row]
    return found, cov, fw, bw


def np_merge(a, b):
    """Union of two sorted unique tables with u32-saturating adds."""
    keys = np.concatenate([a[0], b[0]])
    real = keys != SENT
    u, inv = np.unique(keys[real], return_inverse=True)

    def add(xa, xb):
        x = np.concatenate([xa, xb])[real].astype(np.uint64)
        acc = np.zeros((len(u),) + x.shape[1:], np.uint64)
        np.add.at(acc, inv, x)
        return np.minimum(acc, LARGEST).astype(np.uint32)

    return u, add(a[1], b[1]), add(a[2], b[2]), add(a[3], b[3])


def _bucket_probe(k, tkeys, cov, fw, bw, q):
    """probe_bucketed with the bucket index the table itself builds."""
    import jax.numpy as jnp

    from kreeq_tpu.core.table import KmerTable
    from kreeq_tpu.ops import kmers as K

    real = int((tkeys != SENT).sum())
    table = KmerTable(k, tkeys[:real], cov[:real], fw[:real], bw[:real])
    starts, bits, rounds = table.bucket_index()
    tk, tc, tf, tb = table.device_arrays()
    return K.probe_bucketed(tk, tc, tf, tb, starts, jnp.asarray(q), k,
                            bits, rounds)


def _merge_probe(k, tkeys, cov, fw, bw, q):
    import jax.numpy as jnp

    from kreeq_tpu.ops import kmers as K

    return K.probe_merge(jnp.asarray(tkeys), jnp.asarray(cov),
                         jnp.asarray(fw), jnp.asarray(bw), jnp.asarray(q))


PROBES = {"merge": _merge_probe, "bucketed": _bucket_probe}


def _assert_probe(got, want):
    for name, a, b in zip(("found", "cov", "fw", "bw"), got, want):
        assert np.array_equal(np.asarray(a), b), name


@pytest.mark.parametrize("seed,n,nbases,badp,k", [
    (0, 20000, 4, 0.02, 21),
    (1, 12000, 2, 0.0, 21),   # low-entropy -> duplicate k-mers
    (2, 8000, 4, 0.0, 31),
    (3, 6000, 2, 0.1, 15),
    (4, 5000, 4, 0.01, 32),   # full-width keys
])
def test_count_sorted_matches_numpy(seed, n, nbases, badp, k):
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import count_sorted, kmer_positions

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, nbases, n).astype(np.uint8)
    codes[rng.random(n) < badp] = BAD
    keys, _isfw, edges, valid = kmer_positions(jnp.asarray(codes), k)
    got = [np.asarray(x) for x in count_sorted(keys, edges, valid)]
    want = np_count(codes, k)
    m = len(want[0])
    assert int(got[4]) == m
    for name, a, b in zip(("keys", "cov", "fw", "bw"), got[:4], want):
        assert np.array_equal(a[:m], b), name
    # the padded tail is SENTINEL keys with zero payload
    assert (got[0][m:] == SENT).all()
    for a in got[1:4]:
        assert not a[m:].any()


def _rand_table(rng, t, kbits=42):
    tkeys = np.unique(rng.integers(0, 1 << kbits, t).astype(np.uint64))
    t = len(tkeys)
    cov = rng.integers(0, 1 << 32, t, dtype=np.uint64).astype(np.uint32)
    fw = rng.integers(0, 1 << 32, (t, 4), dtype=np.uint64).astype(np.uint32)
    bw = rng.integers(0, 1 << 32, (t, 4), dtype=np.uint64).astype(np.uint32)
    return tkeys, cov, fw, bw


@pytest.mark.parametrize("method", sorted(PROBES))
@pytest.mark.parametrize("seed,t,q,hit_frac", [
    (0, 2000, 700, 0.5),    # mixed hits/misses, unaligned sizes
    (1, 5, 1500, 0.9),      # tiny table, duplicate-heavy queries
    (2, 4000, 3, 0.3),      # tiny query batch
    (3, 3000, 1024, 0.0),   # all-miss
    (4, 3000, 1024, 1.0),   # all-hit
])
def test_probe_matches_dict(method, seed, t, q, hit_frac):
    rng = np.random.default_rng(seed)
    table = _rand_table(rng, t)
    nhit = int(q * hit_frac)
    qk = np.concatenate([
        rng.choice(table[0], nhit),
        rng.integers(0, 1 << 42, q - nhit).astype(np.uint64),
    ])
    rng.shuffle(qk)
    if q >= 3:  # sentinel (invalid) queries must come back not-found
        qk[q // 2] = SENT
    _assert_probe(PROBES[method](21, *table, qk), np_lookup(table, qk))


@pytest.mark.parametrize("method", sorted(PROBES))
def test_probe_sentinel_padded_table(method):
    """count_sorted-style tables carry a SENTINEL-padded tail; padding
    must never match, not even a SENTINEL query."""
    rng = np.random.default_rng(7)
    tkeys, cov, fw, bw = _rand_table(rng, 900)
    pad = 1024 - len(tkeys)
    table = (np.concatenate([tkeys, np.full(pad, SENT, np.uint64)]),
             np.concatenate([cov, np.zeros(pad, np.uint32)]),
             np.concatenate([fw, np.zeros((pad, 4), np.uint32)]),
             np.concatenate([bw, np.zeros((pad, 4), np.uint32)]))
    qk = np.concatenate([rng.choice(tkeys, 300),
                         rng.integers(0, 1 << 42, 200).astype(np.uint64),
                         np.full(8, SENT, np.uint64)])
    rng.shuffle(qk)
    got = PROBES[method](21, *table, qk)
    assert int(np.asarray(got[0]).sum()) > 0
    _assert_probe(got, np_lookup(table, qk))


@pytest.mark.parametrize("method", sorted(PROBES))
def test_probe_skewed_spans(method):
    """Clustered queries against a clustered table: one dense key
    range, one sparse range, and queries that hit neither."""
    rng = np.random.default_rng(11)
    dense = np.arange(0, 20000, dtype=np.uint64)
    sparse = rng.integers(1 << 40, 1 << 42, 500).astype(np.uint64)
    tkeys = np.unique(np.concatenate([dense, sparse]))
    t = len(tkeys)
    table = (tkeys, rng.integers(1, 100, t).astype(np.uint32),
             rng.integers(0, 100, (t, 4)).astype(np.uint32),
             rng.integers(0, 100, (t, 4)).astype(np.uint32))
    qk = np.concatenate([
        rng.integers(0, 20000, 300).astype(np.uint64),
        rng.integers(1 << 43, 1 << 44, 800).astype(np.uint64),
    ])
    rng.shuffle(qk)
    _assert_probe(PROBES[method](22, *table, qk), np_lookup(table, qk))


@pytest.mark.parametrize("method", sorted(PROBES))
def test_probe_empty_query_batch(method):
    rng = np.random.default_rng(3)
    table = _rand_table(rng, 100)
    f, c, w, b = PROBES[method](21, *table, np.zeros(0, np.uint64))
    assert f.shape == (0,) and c.shape == (0,) and w.shape == (0, 4)


def test_probe_empty_table():
    """An empty table answers every query not-found (KmerTable.probe
    never dispatches a zero-row device table)."""
    from kreeq_tpu.core.table import KmerTable

    qk = np.random.default_rng(3).integers(0, 1 << 42, 5).astype(np.uint64)
    found, cov, fw, bw = KmerTable.empty(21).probe(qk)
    assert found.shape == (5,) and not found.any()
    assert not cov.any() and fw.shape == (5, 4) and not bw.any()


def _genome_and_query(seed, n, badp, k):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, n).astype(np.uint8)
    codes = rng.integers(0, 4, n // 2).astype(np.uint8)
    # splice in genome windows (hits) and BAD bases (invalid windows)
    codes[: n // 4] = genome[: n // 4]
    codes[rng.random(n // 2) < badp] = BAD
    return np_count(genome, k), codes


def _validate(table, codes, k, cutoff, use_merge):
    import jax.numpy as jnp

    from kreeq_tpu.core.table import KmerTable
    from kreeq_tpu.ops.validate import validate_positions

    kt = KmerTable(k, *table)
    starts, bits, rounds = kt.bucket_index()
    return validate_positions(*kt.device_arrays(), starts,
                              jnp.asarray(codes), k, cutoff, bits, rounds,
                              use_merge)


@pytest.mark.parametrize("use_merge", [True, False])
@pytest.mark.parametrize("seed,n,badp,k", [
    (0, 9000, 0.02, 21),
    (1, 5000, 0.0, 31),
    (2, 4000, 0.1, 15),
    (3, 3000, 0.0, 32),   # full-width keys
])
def test_validate_positions_matches_numpy(use_merge, seed, n, badp, k):
    table, codes = _genome_and_query(seed, n, badp, k)
    got = _validate(table, codes, k, 0, use_merge)
    want = np_classify(table, codes, k, 0)
    names = ("valid", "missing", "edge_missing", "cov", "isfw", "right",
             "left")
    for name, a, b in zip(names, got, want):
        assert np.array_equal(np.asarray(a), b), name


@pytest.mark.parametrize("seed,n,badp,k,cutoff", [
    (0, 20000, 0.02, 21, 0),
    (1, 12000, 0.0, 31, 0),
    (2, 9000, 0.05, 21, 2),     # cutoff > 0: cov threshold
    (3, 7000, 0.0, 15, 300),    # cutoff above every cov: all missing
])
def test_qv_window_sums_match_numpy(seed, n, badp, k, cutoff):
    """The sums-only QV path (validate_positions + qv_window_sums) over
    windows [lead, hi), including the seam mask."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.validate import qv_window_sums

    table, codes = _genome_and_query(seed, n, badp, k)
    res = _validate(table, codes, k, cutoff, True)
    _valid, missing, edge_missing = np_classify(table, codes, k,
                                                cutoff)[:3]
    p = len(missing)
    for lead, hi in ((0, p), (1, p - 1), (5, p // 2)):
        got = qv_window_sums(res[1], res[2], jnp.uint32(lead),
                             jnp.uint32(hi))
        want = (int(missing[lead:hi].sum()),
                int(edge_missing[lead:hi].sum()))
        assert tuple(int(x) for x in np.asarray(got)) == want, (lead, hi)


def test_qv_sums_empty_table():
    """DBG validates against a one-row SENTINEL table when the DB is
    empty: every valid window is missing, none edge-missing."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.validate import qv_window_sums, validate_positions

    k = 21
    codes = np.random.default_rng(7).integers(0, 4, 200).astype(np.uint8)
    p = codes.shape[0] - k + 1
    res = validate_positions(
        jnp.full(1, SENT), jnp.zeros(1, jnp.uint32),
        jnp.zeros((1, 4), jnp.uint32), jnp.zeros((1, 4), jnp.uint32),
        jnp.zeros((1 << 8) + 1, jnp.int32), jnp.asarray(codes), k, 0, 8,
        1, False)
    sums = np.asarray(qv_window_sums(res[1], res[2], jnp.uint32(0),
                                     jnp.uint32(p)))
    assert sums.tolist() == [p, 0]


def _rand_merge_table(rng, n, kbits=40):
    return _rand_table(rng, n, kbits)


@pytest.mark.parametrize("na,nb,seed", [
    (1500, 900, 1),     # disjoint-ish
    (5, 3000, 8),       # tiny vs big
    (400, 400, 10),     # dense duplicate ratio
    (3000, 3000, 13),   # big
])
def test_merge_sorted_matches_numpy(na, nb, seed):
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import merge_sorted

    rng = np.random.default_rng(seed)
    a = _rand_merge_table(rng, na)
    b = _rand_merge_table(rng, nb, kbits=14 if na == nb else 40)
    got = merge_sorted(*(jnp.asarray(x) for x in (*a, *b)))
    want = np_merge(a, b)
    m = len(want[0])
    assert int(got[4]) == m
    for name, x, y in zip("kcfb", got[:4], want):
        assert np.array_equal(np.asarray(x)[:m], y), name


def test_merge_sorted_saturation_and_padding():
    """Overlapping keys near LARGEST must saturate exactly; SENTINEL
    input padding (pow2 table buffers) must not leak."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import merge_sorted

    rng = np.random.default_rng(3)
    ka, ca, fa, ba = _rand_merge_table(rng, 800)
    kb = np.unique(np.concatenate(
        [ka[::3], rng.integers(0, 1 << 40, 500).astype(np.uint64)]))
    t = len(kb)
    cb = np.full(t, 0xFFFFFFF0, np.uint32)
    fb = rng.integers(0, 1 << 31, (t, 4), dtype=np.uint64).astype(np.uint32)
    bb = rng.integers(0, 1 << 31, (t, 4), dtype=np.uint64).astype(np.uint32)

    def padto(arrs, size):
        k, c, f, b = arrs
        pad = size - len(k)
        return (np.concatenate([k, np.full(pad, SENT, np.uint64)]),
                np.concatenate([c, np.zeros(pad, np.uint32)]),
                np.concatenate([f, np.zeros((pad, 4), np.uint32)]),
                np.concatenate([b, np.zeros((pad, 4), np.uint32)]))

    a = padto((ka, ca, fa, ba), 1024)
    b = padto((kb, cb, fb, bb), 2048)
    got = merge_sorted(*(jnp.asarray(x) for x in (*a, *b)))
    want = np_merge(a, b)
    m = len(want[0])
    assert int(got[4]) == m
    assert (np.asarray(got[1])[:m] == LARGEST).sum() > 0
    for name, x, y in zip("kcfb", got[:4], want):
        assert np.array_equal(np.asarray(x)[:m], y), name
    assert (np.asarray(got[0])[m:] == SENT).all()


@pytest.mark.parametrize("seed,k", [(0, 21), (1, 15), (2, 32)])
def test_select_by_ctx_matches_numpy(seed, k):
    """The windowed validate's column selection: right/left are the
    edge counters _extract_ctx's context picks, per orientation."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.validate import _extract_ctx, select_by_ctx

    table, codes = _genome_and_query(seed, 3000, 0.02, k)
    keys, _isfw, _valid, ctx = _extract_ctx(jnp.asarray(codes), k)
    found, cov, fw, bw = np_lookup(table, np.asarray(keys))
    got = select_by_ctx(jnp.asarray(found), jnp.asarray(cov),
                        jnp.asarray(fw), jnp.asarray(bw), ctx)
    nkeys, isfw, _edges, _v = np_kmers(codes, k)
    n = len(codes)
    idx = np.arange(len(nkeys))
    nc = np.concatenate([codes[k:], [BAD]]) & 3
    pc = np.concatenate([[BAD], codes[:-k]]) & 3
    right = np.where(isfw, fw[idx, nc], bw[idx, 3 - nc])
    left = np.where(isfw, bw[idx, pc], fw[idx, 3 - pc])
    assert n - k + 1 == len(nkeys)
    for name, a, b in zip(("found", "cov", "right", "left"), got,
                          (found, cov, right, left)):
        assert np.array_equal(np.asarray(a), b), name


@pytest.mark.parametrize("rows,cols,seed", [(5000, 9, 0), (1 << 16, 3, 1)])
def test_prefix_sum01_exact(rows, cols, seed):
    """The blocked matmul prefix sum equals an integer cumsum."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import _prefix_sum01

    m = (np.random.default_rng(seed).random((rows, cols)) < 0.7)
    got = np.asarray(_prefix_sum01(jnp.asarray(m.astype(np.int32))))
    assert np.array_equal(got, np.cumsum(m, axis=0, dtype=np.int32))


def _cache_dir(env_extra):
    env = {key: v for key, v in os.environ.items()
           if key not in ("JAX_COMPILATION_CACHE_DIR",
                          "KREEQ_TPU_NO_COMPILE_CACHE")}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "import kreeq_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_compile_cache_follows_env(tmp_path):
    want = str(tmp_path / "x")
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": want}) == want


def test_compile_cache_default_in_checkout():
    got = _cache_dir({})
    assert got == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_max_device_rows_cpu_sizes_from_host_memory(monkeypatch):
    from kreeq_tpu.core.table import KmerTable

    monkeypatch.delenv("KREEQ_TPU_MAX_TABLE_ROWS", raising=False)
    mem = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert KmerTable.max_device_rows() == max(int(mem * 0.45) // 44,
                                              1 << 20)


def test_max_device_rows_unknown_accelerator_raises(monkeypatch):
    import jax

    from kreeq_tpu.core.table import KmerTable

    class Dev:
        platform = "gpu"
        device_kind = "unknown accelerator"

        def memory_stats(self):
            return None

    monkeypatch.delenv("KREEQ_TPU_MAX_TABLE_ROWS", raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    with pytest.raises(RuntimeError, match="no memory limit"):
        KmerTable.max_device_rows()
