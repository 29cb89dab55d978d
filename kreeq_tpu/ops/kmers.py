"""Device kernels: canonical k-mer extraction, counting, probing.

These replace the reference's two hot loops:
per-base hashing into 128 hash-map partitions (reference:
src/graph-builder.cpp:75-113, 160-205) and the per-base probe
(reference: src/kreeq.cpp:143-219).

Architecture (idiomatic XLA, not a translation):
  * sequences arrive as fixed-size uint8 code chunks (BAD=4 separates
    reads and marks non-ACGT bases),
  * every position's canonical key is computed by k fully-vectorized
    shifted ORs (key = OR_i code[p+i] << 2i; canonical = min(fw, rc),
    isFw = fw <= rc — encoding validated against testFiles/test1.kreeq),
  * the "hash map" is a sorted array: counting = sort + run-detection +
    blocked prefix sums compacted by one flag-sort + row gather
    (per-run totals by adjacent difference); probing = bucketed
    bisection (a per-table bucket index caps lookups at
    log2(largest bucket) gather rounds) or a sort-merge join.

All shapes are static.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import BAD

# Sentinel key sorting after every real key.  Canonical keys are
# min(fw, rc) so even for k == 32 the all-ones pattern (TTT...T, whose
# reverse complement AAA...A packs to 0) can never be a canonical key.
SENTINEL = jnp.uint64(0xFFFFFFFFFFFFFFFF)
LARGEST = jnp.uint64(0xFFFFFFFF)


@partial(jax.jit, static_argnums=(1,))
def kmer_positions(codes: jax.Array, k: int):
    """Compute per-position canonical keys, orientation, edge bits, validity.

    codes: uint8[N] (values 0-3 bases, BAD elsewhere).
    Returns (keys u64[P], isfw bool[P], edges u8[P], valid bool[P]) with
    P = N - k + 1.

    Edge-bit layout (internal; unlike the reference's MSB-first edgeBit,
    reference include/kreeq.h:6-18): bit w = fw edge to base w, bit 4+w
    = bw edge to base w.  Semantics mirror reference
    src/graph-builder.cpp:100-110 (validated against test1.kreeq).
    """
    n = codes.shape[0]
    p = n - k + 1
    # block packing: 16 bases per u32 word once, then each position
    # assembles its window from three words — O(N) total work instead
    # of the naive O(kN) shifted-OR loop
    npad = (-n) % 16 + 32
    cpad = jnp.concatenate([codes, jnp.full((npad,), BAD, jnp.uint8)])
    blocks = cpad.reshape(-1, 16).astype(jnp.uint32) & 3
    w = jnp.zeros((blocks.shape[0],), jnp.uint32)
    for i in range(16):
        w = w | (blocks[:, i] << jnp.uint32(2 * i))
    w64 = w.astype(jnp.uint64)
    w0 = jnp.repeat(w64, 16)[:p]
    w1 = jnp.repeat(w64[1:], 16)[:p]
    w2 = jnp.repeat(w64[2:], 16)[:p]
    w01 = w0 | (w1 << jnp.uint64(32))
    r2 = (jnp.arange(p, dtype=jnp.uint64) & jnp.uint64(15)) * jnp.uint64(2)
    mask = jnp.uint64((1 << (2 * k)) - 1)
    hi_part = jnp.where(r2 == 0, jnp.uint64(0),
                        w2 << (jnp.uint64(64) - r2))
    fw = ((w01 >> r2) | hi_part) & mask

    # revcomp = complement (xor) + 2-bit-pair reversal of the 2k bits
    x = ((~fw) & mask) << jnp.uint64(64 - 2 * k)
    for sh, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                  (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        x = (((x & jnp.uint64(m)) << jnp.uint64(sh))
             | ((x >> jnp.uint64(sh)) & jnp.uint64(m)))
    rc = ((x << jnp.uint64(32)) | (x >> jnp.uint64(32))) & mask

    isfw = fw <= rc
    keys = jnp.where(isfw, fw, rc)

    # validity: no BAD code inside the window.  Sliding-window OR by
    # doubling (OR is idempotent, so the final overlapping combine is
    # exact) — ~log2(k) elementwise passes.
    y = codes > 3
    m = 1
    while m < k:
        sh = min(m, k - m)
        y = y | jnp.concatenate([y[sh:], jnp.zeros((sh,), bool)])
        m += sh
    valid = ~y[:p]

    # neighbours (BAD when outside the chunk)
    prev = jnp.concatenate([jnp.full((1,), BAD, jnp.uint8), codes[: p - 1]])
    nxt = jnp.concatenate([codes[k:], jnp.full((1,), BAD, jnp.uint8)])
    prev_ok = prev <= 3
    next_ok = nxt <= 3
    one = jnp.uint8(1)
    zero = jnp.uint8(0)
    pc = (prev & 3).astype(jnp.uint8)
    nc = (nxt & 3).astype(jnp.uint8)
    e_fw = (jnp.where(next_ok, one << nc, zero)
            | jnp.where(prev_ok, one << (4 + pc), zero)).astype(jnp.uint8)
    e_rc = (jnp.where(prev_ok, one << (3 - pc), zero)
            | jnp.where(next_ok, one << (4 + 3 - nc), zero)).astype(jnp.uint8)
    edges = jnp.where(isfw, e_fw, e_rc)
    return keys, isfw, edges, valid


_PFX_BLOCK = 512


def _prefix_sum01(m):
    """Exact inclusive prefix sum along axis 0 of 0/1 integer columns.

    Blocked: within-block inclusive sums are one lower-triangular f32
    matmul, block offsets are a small i32 cumsum.  The matmul is exact
    only at full f32 precision (block sums <= 512 < 2^24), so it pins
    HIGHEST: the default GPU precision rounds operands to TF32.
    Returns int32.
    """
    B = _PFX_BLOCK
    n0, c = m.shape
    pad = (-n0) % B
    mp = jnp.pad(m, ((0, pad), (0, 0))) if pad else m
    nb = mp.shape[0] // B
    x = mp.reshape(nb, B, c).astype(jnp.float32)
    tri = jnp.tril(jnp.ones((B, B), jnp.float32))
    within = jnp.einsum("ij,bjc->bic", tri, x,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=jnp.float32)
    bsums = mp.reshape(nb, B, c).astype(jnp.int32).sum(axis=1)
    offs = jnp.cumsum(bsums, axis=0) - bsums  # exclusive block offsets
    out = within.astype(jnp.int32) + offs[:, None, :]
    return out.reshape(nb * B, c)[:n0]


def _compact_order(flag):
    """Permutation putting flagged positions first, in position order.

    One single-operand u32 sort in place of a row scatter.  Position
    rides in the low 31 bits of the sort key, so ties cannot reorder.
    """
    p = flag.shape[0]
    iota = jnp.arange(p, dtype=jnp.uint32)
    sk = jnp.where(flag, iota, iota | jnp.uint32(0x80000000))
    ssk = jax.lax.sort(sk)
    return (ssk & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)


def _sort_keys_edges(skeys, e32):
    """Sort (key, 8 edge bits) records: u32/u64 2-key representation.

    The order is expressed as a 2-key sort of (u32 hi24,
    u64 lo38|edges8).  Ties on the key sort by edge bits, which is
    harmless: run totals are order-independent within a run.  Valid
    for every k <= 32.
    """
    hi = (skeys >> jnp.uint64(38)).astype(jnp.uint32)
    lo = ((skeys & jnp.uint64((1 << 38) - 1)) << jnp.uint64(8)) | e32
    shi, slo = jax.lax.sort((hi, lo), num_keys=2)
    keys = (shi.astype(jnp.uint64) << jnp.uint64(38)) \
        | (slo >> jnp.uint64(8))
    return keys, (slo & jnp.uint64(0xFF)).astype(jnp.uint32)


@jax.jit
def count_sorted(keys: jax.Array, edges: jax.Array, valid: jax.Array):
    """Aggregate (key, edgebits) records into a sorted unique table.

    Replaces the reference's per-record hash-map update loop (reference:
    src/graph-builder.cpp:160-205) with sort + cumsum-difference run
    sums.  Returns padded arrays (ukeys u64[P] sorted with SENTINEL
    padding, cov u32[P], fw u32[P,4], bw u32[P,4]) plus n (u32 scalar).

    All 9 run sums plus both key halves ride ONE permutation:
    inclusive cumulative rows (blocked prefix sum, `_prefix_sum01`) are
    compacted to the front at run ends by a single u32 sort + row
    gather (`_compact_order`), and per-run totals are adjacent
    differences of the compacted rows.  The permutation payload is
    padded to 16 columns and gathered with unique_indices=True.
    """
    p = keys.shape[0]
    skeys = jnp.where(valid, keys, SENTINEL)
    e32 = jnp.where(valid, edges, 0).astype(jnp.uint64)
    skeys, sedges = _sort_keys_edges(skeys, e32)

    boundary = skeys[1:] != skeys[:-1]
    starts = jnp.concatenate([jnp.ones((1,), bool), boundary])
    ends = jnp.concatenate([boundary, jnp.ones((1,), bool)])
    real = skeys != SENTINEL
    n = jnp.sum((starts & real).astype(jnp.uint32))
    flag = ends & real

    # columns: cov, fw0..3, bw0..3 — inclusive cumulative rows; run
    # totals are adjacent differences after compaction.  Sentinel rows
    # sort last, so their contributions never reach a real run's row.
    cols = [jnp.ones((p, 1), jnp.int32)]
    se = sedges.astype(jnp.int32)
    cols += [((se >> w) & 1)[:, None] for w in range(8)]
    c = _prefix_sum01(jnp.concatenate(cols, axis=1)).astype(jnp.uint32)

    # key halves pre-masked so non-compacted tail rows read as SENTINEL
    ffff = jnp.uint32(0xFFFFFFFF)
    key_lo = jnp.where(flag, (skeys & jnp.uint64(0xFFFFFFFF))
                       .astype(jnp.uint32), ffff)
    key_hi = jnp.where(flag, (skeys >> jnp.uint64(32))
                       .astype(jnp.uint32), ffff)
    payload = jnp.concatenate(
        [c, key_lo[:, None], key_hi[:, None],
         jnp.zeros((p, 5), jnp.uint32)], axis=1)  # [P, 16]

    out = jnp.take(payload, _compact_order(flag), axis=0,
                   unique_indices=True)

    ukeys = (out[:, 9].astype(jnp.uint64)
             | (out[:, 10].astype(jnp.uint64) << jnp.uint64(32)))
    cc = out[:, :9]
    totals = cc - jnp.concatenate([jnp.zeros((1, 9), jnp.uint32),
                                   cc[:-1]], axis=0)
    totals = jnp.where((ukeys != SENTINEL)[:, None], totals, 0)
    cov = totals[:, 0]
    fw = totals[:, 1:5]
    bw = totals[:, 5:9]
    return ukeys, cov, fw, bw, n


@jax.jit
def merge_sorted(keys_a, cov_a, fw_a, bw_a, keys_b, cov_b, fw_b, bw_b):
    """Merge two sorted unique tables with saturating u32 adds.

    Device-native replacement for the reference's submap-parallel union
    (reference: src/graph-builder.cpp:297-432); saturation bound LARGEST
    per reference include/kreeq.h:68.

    Payloads ride the sorts as packed u64 operands instead of being
    fetched by row gathers afterwards.  Equal keys across inputs land adjacent in either order (the
    saturating add is commutative, so no passenger index is needed).
    """
    keys = jnp.concatenate([keys_a, keys_b])
    p = keys.shape[0]
    hi = (keys >> jnp.uint64(32)).astype(jnp.uint32)
    lo = keys.astype(jnp.uint32)

    def pack2(x, y):
        return x.astype(jnp.uint64) | (y.astype(jnp.uint64)
                                       << jnp.uint64(32))

    cov = jnp.concatenate([cov_a, cov_b])
    fw = jnp.concatenate([fw_a, fw_b])
    bw = jnp.concatenate([bw_a, bw_b])
    p0 = pack2(cov, fw[:, 0])
    p1 = pack2(fw[:, 1], fw[:, 2])
    p2 = pack2(fw[:, 3], bw[:, 0])
    p3 = pack2(bw[:, 1], bw[:, 2])
    p4 = bw[:, 3]
    hi, lo, p0, p1, p2, p3, p4 = jax.lax.sort(
        (hi, lo, p0, p1, p2, p3, p4), num_keys=2)
    keys = (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo

    starts = jnp.concatenate([jnp.ones((1,), bool), keys[1:] != keys[:-1]])
    real = keys != SENTINEL
    flag = starts & real
    n = jnp.sum(flag.astype(jnp.uint32))

    # each key appears at most twice (once per input table); add the
    # successor's packed halves with per-half saturation
    nxt_same = jnp.concatenate([keys[1:] == keys[:-1],
                                jnp.zeros((1,), bool)])

    def nxt(a):
        return jnp.concatenate([a[1:], jnp.zeros_like(a[:1])])

    m32 = jnp.uint64(0xFFFFFFFF)

    def satadd2(x, y):
        lo_s = jnp.minimum((x & m32) + (y & m32), m32)
        hi_s = jnp.minimum((x >> jnp.uint64(32)) + (y >> jnp.uint64(32)),
                           m32)
        return lo_s | (hi_s << jnp.uint64(32))

    p0 = jnp.where(nxt_same, satadd2(p0, nxt(p0)), p0)
    p1 = jnp.where(nxt_same, satadd2(p1, nxt(p1)), p1)
    p2 = jnp.where(nxt_same, satadd2(p2, nxt(p2)), p2)
    p3 = jnp.where(nxt_same, satadd2(p3, nxt(p3)), p3)
    p4 = jnp.minimum(jnp.where(nxt_same,
                               p4.astype(jnp.uint64)
                               + nxt(p4).astype(jnp.uint64),
                               p4.astype(jnp.uint64)),
                     m32).astype(jnp.uint32)

    # compaction: dead rows (duplicate seconds + SENTINEL pads) get
    # all-ones keys and sort to the tail — a second payload-carrying
    # sort instead of a flag-sort + [p,16] row gather
    ffff = jnp.uint32(0xFFFFFFFF)
    z64 = jnp.uint64(0)
    hi2 = jnp.where(flag, hi, ffff)
    lo2 = jnp.where(flag, lo, ffff)
    p0 = jnp.where(flag, p0, z64)
    p1 = jnp.where(flag, p1, z64)
    p2 = jnp.where(flag, p2, z64)
    p3 = jnp.where(flag, p3, z64)
    p4 = jnp.where(flag, p4, jnp.uint32(0))
    hi2, lo2, p0, p1, p2, p3, p4 = jax.lax.sort(
        (hi2, lo2, p0, p1, p2, p3, p4), num_keys=2)
    okeys = (hi2.astype(jnp.uint64) << jnp.uint64(32)) \
        | lo2.astype(jnp.uint64)
    ocov = (p0 & m32).astype(jnp.uint32)
    ofw = jnp.stack([(p0 >> jnp.uint64(32)).astype(jnp.uint32),
                     (p1 & m32).astype(jnp.uint32),
                     (p1 >> jnp.uint64(32)).astype(jnp.uint32),
                     (p2 & m32).astype(jnp.uint32)], axis=1)
    obw = jnp.stack([(p2 >> jnp.uint64(32)).astype(jnp.uint32),
                     (p3 & m32).astype(jnp.uint32),
                     (p3 >> jnp.uint64(32)).astype(jnp.uint32),
                     p4], axis=1)
    return okeys, ocov, ofw, obw, n


@jax.jit
def probe_merge(tkeys, cov, fw, bw, qkeys):
    """Batched lookup as a gather-free sort-merge join.

    Sorts [table keys ++ query keys] once with table rows first among
    equals, carries the last table row index forward with cummax, then
    restores query order with ONE single-operand u64 sort and fetches
    payloads with one wide unique-order row gather.  Both sorts use the
    fast representations (2-key u32/u64 with tag+index packed into the
    low bits; see _sort_keys_edges).  Cost scales with t + q, so
    KmerTable.probe selects this join only when the table is not much
    larger than the batch.  Output matches probe_sorted.
    """
    t = tkeys.shape[0]
    q = qkeys.shape[0]
    # bit budget: lo(u64) = key_lo | tag | src.  src_bits covers both
    # array lengths; key high bits go to the u32 primary sort key
    # (keys have <= 64 bits, and key_lo_bits >= 32 holds whenever
    # src_bits <= 31, so the hi part always fits u32).
    src_bits = max(int(np.ceil(np.log2(max(t, q) + 1))), 1)
    key_lo_bits = 63 - src_bits
    allk = jnp.concatenate([tkeys, qkeys])
    tag = jnp.concatenate([jnp.zeros((t,), jnp.uint64),
                           jnp.ones((q,), jnp.uint64)])
    src = jnp.concatenate([jnp.arange(t, dtype=jnp.uint64),
                           jnp.arange(q, dtype=jnp.uint64)])
    hi = (allk >> jnp.uint64(key_lo_bits)).astype(jnp.uint32)
    lo = ((allk & jnp.uint64((1 << key_lo_bits) - 1))
          << jnp.uint64(64 - key_lo_bits)) \
        | (tag << jnp.uint64(src_bits)) | src
    shi, slo = jax.lax.sort((hi, lo), num_keys=2)
    skey = (shi.astype(jnp.uint64) << jnp.uint64(key_lo_bits)) \
        | (slo >> jnp.uint64(64 - key_lo_bits))
    is_t = (slo & jnp.uint64(1 << src_bits)) == 0
    ssrc = (slo & jnp.uint64((1 << src_bits) - 1)).astype(jnp.int32)
    last_tbl = jax.lax.cummax(jnp.where(is_t, ssrc, -1))
    carried = jax.lax.cummax(jnp.where(is_t, skey, 0))
    found_row = (~is_t) & (last_tbl >= 0) & (carried == skey)

    # restore query order: queries (unique srcs) sort to the front of
    # one u64 array carrying (src, table row, found)
    idx_bits = max(int(np.ceil(np.log2(t + 1))), 1)
    v = jnp.where(
        is_t, SENTINEL,
        (ssrc.astype(jnp.uint64) << jnp.uint64(idx_bits + 1))
        | (jnp.maximum(last_tbl, 0).astype(jnp.uint64) << jnp.uint64(1))
        | found_row.astype(jnp.uint64))
    sv = jax.lax.sort(v)[:q]
    idx = ((sv >> jnp.uint64(1))
           & jnp.uint64((1 << idx_bits) - 1)).astype(jnp.int32)
    # SENTINEL queries (invalid k-mers) are never "found", even when
    # the table carries SENTINEL padding rows
    found = (sv & jnp.uint64(1)).astype(bool) & (qkeys != SENTINEL)
    rows = jnp.concatenate(
        [cov[:, None], fw, bw, jnp.zeros((t, 7), jnp.uint32)], axis=1)
    r = jnp.where(found[:, None], rows[idx], jnp.uint32(0))
    return found, r[:, 0], r[:, 1:5], r[:, 5:9]


@jax.jit
def combine_probe(f1, c1, fw1, bw1, f2, c2, fw2, bw2):
    """Combine probe results from two DISJOINT table windows (at most
    one side can find any query) — the accumulator of out-of-core
    window paging (KmerTable.probe_device; reference analog:
    src/kreeq.cpp:59-76 map-range rescans)."""
    return (f1 | f2,
            jnp.where(f2, c2, c1),
            jnp.where(f2[:, None], fw2, fw1),
            jnp.where(f2[:, None], bw2, bw1))


@jax.jit
def probe_sorted(tkeys, cov, fw, bw, qkeys):
    """Batched membership + payload gather against a sorted table.

    Replaces the reference's per-base hash probe (reference:
    src/kreeq.cpp:143-219 evaluateSegment inner loop).  tkeys is sorted
    with SENTINEL padding.  Returns (found bool[Q], cov u32[Q],
    fw u32[Q,4], bw u32[Q,4]).
    """
    idx = jnp.searchsorted(tkeys, qkeys)
    idx = jnp.minimum(idx, tkeys.shape[0] - 1)
    found = (tkeys[idx] == qkeys) & (qkeys != SENTINEL)
    z32 = jnp.uint32(0)
    qcov = jnp.where(found, cov[idx], z32)
    qfw = jnp.where(found[:, None], fw[idx], z32)
    qbw = jnp.where(found[:, None], bw[idx], z32)
    return found, qcov, qfw, qbw



@partial(jax.jit, static_argnums=(1, 2))
def build_bucket_index(tkeys, k: int, bits: int):
    """Bucket starts over the top `bits` of the 2k-bit key space.

    One searchsorted of 2^bits probes against the table, done once per
    table: every subsequent probe then bisects only within its bucket.
    """
    edges = (jnp.arange(1 << bits, dtype=jnp.uint64)
             << jnp.uint64(2 * k - bits))
    starts = jnp.searchsorted(tkeys, edges).astype(jnp.int32)
    return jnp.concatenate(
        [starts, jnp.full((1,), tkeys.shape[0], jnp.int32)])


@partial(jax.jit, static_argnums=(6, 7, 8))
def probe_bucketed(tkeys, cov, fw, bw, starts, qkeys, k: int, bits: int,
                   rounds: int):
    """Bucketed bisection probe: ~log2(max bucket) HBM gather rounds
    instead of log2(table) (searchsorted) or a full table re-sort
    (probe_merge).  `rounds` must be >= ceil(log2(largest bucket + 1));
    the table side computes it exactly.  Output matches probe_sorted.

    The result row (key halves + cov + fw + bw) is fetched as ONE
    [T,11] contiguous row gather — the final key check rides along.
    """
    shift = jnp.uint64(2 * k - bits)
    b = (qkeys >> shift).astype(jnp.int32)
    b = jnp.clip(b, 0, (1 << bits) - 1)
    lo = starts[b]
    hi = starts[b + 1]
    for _ in range(rounds):
        mid = (lo + hi) >> 1
        take = tkeys[jnp.minimum(mid, tkeys.shape[0] - 1)] < qkeys
        lo = jnp.where(take & (lo < hi), mid + 1, lo)
        hi = jnp.where(take | (lo >= hi), hi, mid)
    idx = jnp.minimum(lo, tkeys.shape[0] - 1)

    rows = jnp.concatenate(
        [(tkeys & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)[:, None],
         (tkeys >> jnp.uint64(32)).astype(jnp.uint32)[:, None],
         cov[:, None], fw, bw], axis=1)  # [T, 11]
    r = rows[idx]
    q_lo = (qkeys & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    q_hi = (qkeys >> jnp.uint64(32)).astype(jnp.uint32)
    found = (r[:, 0] == q_lo) & (r[:, 1] == q_hi) & (qkeys != SENTINEL)
    r = jnp.where(found[:, None], r, jnp.uint32(0))
    return found, r[:, 2], r[:, 3:7], r[:, 7:11]

@partial(jax.jit, static_argnums=(6, 7))
def probe_bucketed_dyn(tkeys, cov, fw, bw, starts, qkeys, k: int,
                       bits: int):
    """Bucketed bisection with a data-dependent round count.

    Same output as probe_bucketed, but the bisection runs under
    lax.while_loop until every query's bracket collapses, so no static
    `rounds` bound is needed — safe for adversarially skewed tables
    (e.g. inside SPMD shard programs, where the host cannot inspect the
    per-shard bucket histogram without a readback).  Typical trip count
    is ~3 with the one-bit-past-table-size bucket index.
    """
    shift = jnp.uint64(2 * k - bits)
    b = (qkeys >> shift).astype(jnp.int32)
    b = jnp.clip(b, 0, (1 << bits) - 1)
    lo0 = starts[b]
    hi0 = starts[b + 1]

    def cond(state):
        lo, hi = state
        return jnp.any(lo < hi)

    def body(state):
        lo, hi = state
        mid = (lo + hi) >> 1
        take = tkeys[jnp.minimum(mid, tkeys.shape[0] - 1)] < qkeys
        lo = jnp.where(take & (lo < hi), mid + 1, lo)
        hi = jnp.where(take | (lo >= hi), hi, mid)
        return lo, hi

    lo, _hi = jax.lax.while_loop(cond, body, (lo0, hi0))
    idx = jnp.minimum(lo, tkeys.shape[0] - 1)

    rows = jnp.concatenate(
        [(tkeys & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)[:, None],
         (tkeys >> jnp.uint64(32)).astype(jnp.uint32)[:, None],
         cov[:, None], fw, bw], axis=1)  # [T, 11]
    r = rows[idx]
    q_lo = (qkeys & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    q_hi = (qkeys >> jnp.uint64(32)).astype(jnp.uint32)
    found = (r[:, 0] == q_lo) & (r[:, 1] == q_hi) & (qkeys != SENTINEL)
    r = jnp.where(found[:, None], r, jnp.uint32(0))
    return found, r[:, 2], r[:, 3:7], r[:, 7:11]


# ---------------------------------------------------------------------------
# host-side packing


def pack_reads(seqs, k: int, chunk: int):
    """Pack read code arrays into BAD-separated uint8 chunks.

    Reads are never split across chunks (edge context must stay intact;
    the reference processes whole read batches for the same reason,
    reference: src/graph-builder.cpp:75-91).  Reads longer than the
    chunk size are emitted as dedicated right-sized chunks (padded to a
    power of two to bound recompilation).
    """
    from ..constants import seq_to_codes

    buf = np.full(chunk, BAD, dtype=np.uint8)
    pos = 0
    for seq in seqs:
        codes = seq_to_codes(seq) if isinstance(seq, str) else seq
        m = len(codes)
        if m > chunk - 1:
            if pos > 0:
                yield buf
                buf = np.full(chunk, BAD, dtype=np.uint8)
                pos = 0
            big = 1 << int(np.ceil(np.log2(m + 1)))
            bigbuf = np.full(big, BAD, dtype=np.uint8)
            bigbuf[:m] = codes
            yield bigbuf
            continue
        if pos + m + 1 > chunk:
            yield buf
            buf = np.full(chunk, BAD, dtype=np.uint8)
            pos = 0
        buf[pos:pos + m] = codes
        pos += m + 1  # one BAD separator
    if pos > 0:
        # trim the final partial buffer to a power-of-two bucket so tiny
        # workloads don't pay for a full chunk-sized sort
        size = 64
        while size < pos:
            size *= 2
        yield buf[:size]
