"""Multi-device sharded counting and probing (SPMD over a Mesh).

Device-mesh re-expression of the reference's scaling story:

  * the reference shards its table 128 ways by `key % mapCount` inside
    one process (reference: include/kreeq.h:139-148) and scales across
    machines by building separate DBs and merging them through the
    filesystem with `kreeq union` (reference: README.md:31-39,
    src/graph-builder.cpp:297-351);
  * here the table is sharded `key % n_devices` across a device mesh:
    every device extracts k-mers from its local read chunk, records are
    routed to their owner shard with all_to_all, and each
    owner builds its sorted sub-table locally.  Probes route the same
    way and return by the inverse exchange; QV totals reduce with psum.

Routing uses capacity-factor bins (the reference routes exactly the
records that exist, src/graph-builder.cpp:95-112; static shapes need a
bound instead): each per-owner bin holds CAPACITY x the fair share
p/n.  Overflow is never silent — the dropped-record count is psum'd
and returned, and callers retry the block with full-size bins (which
cannot drop) when it is non-zero.  For uniformly hashed k-mer keys the
fast path overflows with negligible probability; only adversarial skew
(e.g. one repeated k-mer) pays the retry.

Shards are disjoint by construction, so multi-host DB union is a
per-shard sorted merge with no data movement between shards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.kmers import (SENTINEL, build_bucket_index, count_sorted,
                         kmer_positions, probe_bucketed_dyn, probe_merge)

AXIS = "shard"

# per-owner bin capacity = CAPACITY x fair share.  2x keeps the routed
# payload ~2 x chunk/n per device (vs n x chunk with full bins) while
# making overflow a <1e-12 event for hashed keys at realistic chunk
# sizes (Chernoff: P[Bin(p, 1/n) > 2p/n] ~ exp(-p/(3n))).
CAPACITY = 2.0


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (AXIS,))


def _bin_capacity(p: int, n: int, full: bool) -> int:
    """Static per-owner bin size for routing p records to n owners."""
    if full or n == 1:
        return p
    cap = int(np.ceil(CAPACITY * p / n))
    cap = (cap + 127) & ~127  # multiple of 128 for clean tiling
    return min(max(cap, 128), p)


# Fibonacci multiplicative mix for shard ownership.  The reference
# partitions by `key % mapCount` (src/kreeq.cpp:146) — fine for hash
# MAP sizing, but canonical k-mer keys are structurally skewed in
# their low bits: a k-mer ending in T has a revcomp starting with A
# (high bits 00) that nearly always wins min(fw, rc), so canonical
# keys rarely end in T/G and `key % n` loads shards up to ~10x apart
# (measured on random 31-mers).  A multiplicative mix makes ownership
# uniform so the 2x capacity-factor bins hold.
_OWNER_MIX = 0x9E3779B97F4A7C15


def owner_of(keys, n: int):
    """Owner shard of each canonical key (device or numpy arrays)."""
    if isinstance(keys, np.ndarray) or np.isscalar(keys):
        # the u64 wraparound IS the mix — scope the overflow warning
        # out so real overflow bugs elsewhere stay loud
        with np.errstate(over="ignore"):
            return (np.uint64(keys) * np.uint64(_OWNER_MIX)
                    >> np.uint64(40)) % np.uint64(n)
    mixed = (keys * jnp.uint64(_OWNER_MIX)) >> jnp.uint64(40)
    return (mixed % jnp.uint64(n)).astype(jnp.int32)


def _bucket_by_owner(keys, payload, valid, n: int, bucket: int):
    """Scatter records into [n, bucket] per-owner bins (local op).

    Returns (keys[n,bucket], payload[n,bucket], pos[n,bucket], dropped)
    where `dropped` counts records beyond a bin's capacity — callers
    must surface it (never silently accept a drop).  Invalid slots
    carry SENTINEL keys.
    """
    p = keys.shape[0]
    mixed = (keys * jnp.uint64(_OWNER_MIX)) >> jnp.uint64(40)
    owner = jnp.where(valid, (mixed % jnp.uint64(n)).astype(jnp.int32), n)
    order = jnp.argsort(owner, stable=True)
    owner_s = owner[order]
    keys_s = jnp.where(valid[order], keys[order], SENTINEL)
    payload_s = jnp.where(valid[order], payload[order], 0)
    pos_s = jnp.where(valid[order], order.astype(jnp.int32), -1)

    start = jnp.searchsorted(owner_s, jnp.arange(n, dtype=jnp.int32))
    rank = jnp.arange(p, dtype=jnp.int32) - start[
        jnp.clip(owner_s, 0, n - 1)]
    in_bin = (owner_s < n) & (rank < bucket)
    dropped = jnp.sum(((owner_s < n) & (rank >= bucket))
                      .astype(jnp.int32))
    flat_idx = jnp.where(in_bin, owner_s * bucket + rank, n * bucket)

    out_keys = jnp.full((n * bucket + 1,), SENTINEL, jnp.uint64)
    out_keys = out_keys.at[flat_idx].set(keys_s, mode="drop")[:-1]
    out_payload = jnp.zeros((n * bucket + 1,), payload_s.dtype)
    out_payload = out_payload.at[flat_idx].set(payload_s, mode="drop")[:-1]
    out_pos = jnp.full((n * bucket + 1,), -1, jnp.int32)
    out_pos = out_pos.at[flat_idx].set(pos_s, mode="drop")[:-1]
    return (out_keys.reshape(n, bucket), out_payload.reshape(n, bucket),
            out_pos.reshape(n, bucket), dropped)


def sharded_count_fn(mesh: Mesh, k: int, full_bins: bool = False):
    """Build the jitted SPMD counting step.

    Input: codes uint8[n*chunk] (sharded on devices).  Output: per-shard
    sorted tables (keys/cov/fw/bw stacked on the device axis), n_valid,
    and the psum'd dropped-record count (0 on the full_bins variant by
    construction; callers retry with full_bins=True when non-zero).
    """
    n = mesh.devices.size

    def local_step(codes):  # codes: [1, chunk] on each device
        codes = codes[0]
        chunk = codes.shape[0]
        p = chunk - k + 1
        keys, _isfw, edges, valid = kmer_positions(codes, k)
        bucket = _bin_capacity(p, n, full_bins)
        bkeys, bedges, _, dropped = _bucket_by_owner(
            keys, edges, valid, n, bucket)
        # route records to their owner shard
        rkeys = jax.lax.all_to_all(bkeys, AXIS, 0, 0, tiled=False)
        redges = jax.lax.all_to_all(bedges, AXIS, 0, 0, tiled=False)
        rkeys = rkeys.reshape(-1)
        redges = redges.reshape(-1)
        ukeys, cov, fw, bw, nvalid = count_sorted(
            rkeys, redges, rkeys != SENTINEL)
        all_dropped = jax.lax.psum(dropped, AXIS)
        return (ukeys[None], cov[None], fw[None], bw[None],
                nvalid[None], all_dropped[None])

    from jax import shard_map

    fn = shard_map(local_step, mesh=mesh,
                   in_specs=(P(AXIS),),
                   out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                              P(AXIS)))
    return jax.jit(fn)


def sharded_bucket_fn(mesh: Mesh, k: int, bits: int):
    """Per-shard bucket-index builder (one searchsorted per table).

    Run once per built table so repeated probe steps skip the index
    cost; pass the result to sharded_probe_fn.
    """

    def local_step(tkeys):
        return build_bucket_index(tkeys[0], k, bits)[None]

    from jax import shard_map

    fn = shard_map(local_step, mesh=mesh, in_specs=(P(AXIS),),
                   out_specs=P(AXIS))
    return jax.jit(fn)


def probe_bits(table_rows: int, k: int) -> int:
    """Bucket-index width for a per-shard table of `table_rows` slots
    (matches KmerTable.bucket_index's one-bit-past-table-size rule)."""
    import math

    n = max(table_rows, 2)
    return min(max(8, math.ceil(math.log2(n)) + 1), 24, 2 * k)


def sharded_probe_fn(mesh: Mesh, k: int, bits: int, cutoff: int = 0,
                     full_bins: bool = False):
    """Build the jitted SPMD probe step.

    Inputs: per-shard tables + bucket starts (sharded_count_fn /
    sharded_bucket_fn outputs) and a device-sharded query code array.
    Output: per-position (found, cov) in the original query layout,
    psum'd QV counters, and the psum'd dropped-query count (callers
    retry with full_bins=True when non-zero).

    The per-shard lookup is the bucketed bisection
    (ops/kmers.probe_bucketed_dyn): ~3 HBM gather rounds against the
    shard sub-table instead of log2(table) searchsorted rounds, with a
    data-dependent while_loop bound so skewed shards stay exact.
    """
    n = mesh.devices.size

    def local_step(tkeys, tcov, tfw, tbw, tstarts, codes):
        codes = codes[0]
        tkeys, tcov, tfw, tbw = tkeys[0], tcov[0], tfw[0], tbw[0]
        tstarts = tstarts[0]
        chunk = codes.shape[0]
        p = chunk - k + 1
        keys, isfw, _edges, valid = kmer_positions(codes, k)
        bucket = _bin_capacity(p, n, full_bins)
        bkeys, _bp, bpos, dropped = _bucket_by_owner(
            keys, jnp.zeros_like(keys, jnp.uint32), valid, n, bucket)
        rkeys = jax.lax.all_to_all(bkeys, AXIS, 0, 0)
        flat = rkeys.reshape(-1)
        if tkeys.shape[0] <= 6 * flat.shape[0]:
            # gather-free sort-merge join (see KmerTable.probe): wins
            # when the shard sub-table isn't much larger than the
            # routed batch, and has no data-dependent control flow
            found, cov, fw, bw = probe_merge(tkeys, tcov, tfw, tbw,
                                             flat)
        else:
            found, cov, fw, bw = probe_bucketed_dyn(
                tkeys, tcov, tfw, tbw, tstarts, flat, k, bits)
        # answers return by the inverse exchange
        def back(x):
            shaped = x.reshape(n, bucket, *x.shape[1:])
            return jax.lax.all_to_all(shaped, AXIS, 0, 0)

        rfound = back(found.astype(jnp.uint8))
        rcov = back(cov)
        rfw = back(fw)
        rbw = back(bw)
        # scatter answers back to original query positions
        pos = bpos.reshape(-1)
        tgt = jnp.where(pos >= 0, pos, p)

        def unscatter(v):
            out = jnp.zeros((p + 1,) + v.shape[2:], v.dtype)
            return out.at[tgt].set(v.reshape(n * bucket, *v.shape[2:]),
                                   mode="drop")[:p]

        qfound = unscatter(rfound).astype(bool) & valid
        qcov = unscatter(rcov)
        qfw = unscatter(rfw)
        qbw = unscatter(rbw)

        # per-base QV classification (reference: src/kreeq.cpp:143-219)
        nxt = jnp.concatenate([codes[k:], jnp.full((1,), 4, jnp.uint8)])
        prv = jnp.concatenate([jnp.full((1,), 4, jnp.uint8),
                               codes[: p - 1]])
        has_next = nxt <= 3
        has_prev = prv <= 3
        nc = (nxt & 3).astype(jnp.int32)
        pc = (prv & 3).astype(jnp.int32)

        # column selection by one-hot select+reduce over the 4 lanes
        lanes = jnp.arange(4, dtype=jnp.int32)[None, :]

        def pick(mat, idx):
            return jnp.where(lanes == idx[:, None], mat,
                             jnp.uint32(0)).sum(axis=1, dtype=jnp.uint32)

        right = pick(jnp.where(isfw[:, None], qfw, qbw),
                     jnp.where(isfw, nc, 3 - nc))
        left = pick(jnp.where(isfw[:, None], qbw, qfw),
                    jnp.where(isfw, pc, 3 - pc))
        qcov = jnp.where(qfound, qcov, 0)
        missing = valid & ((qcov == 0) | (qcov < jnp.uint32(cutoff)))
        no_right = has_next & (jnp.where(qfound & has_next, right, 0) == 0)
        no_left = has_prev & (jnp.where(qfound & has_prev, left, 0) == 0)
        edge_missing = valid & ~missing & no_left & no_right

        # int32 psum: per-step counts are < 2^31; accumulate on the
        # host
        tot = jax.lax.psum(jnp.sum(valid.astype(jnp.int32)), AXIS)
        miss = jax.lax.psum(jnp.sum(missing.astype(jnp.int32)), AXIS)
        emiss = jax.lax.psum(jnp.sum(edge_missing.astype(jnp.int32)),
                             AXIS)
        all_dropped = jax.lax.psum(dropped, AXIS)
        return (qfound[None], qcov[None], tot[None], miss[None],
                emiss[None], all_dropped[None])

    from jax import shard_map

    fn = shard_map(local_step, mesh=mesh,
                   in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                             P(AXIS)),
                   out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                              P(AXIS)))
    return jax.jit(fn)


def full_pipeline_fn(mesh: Mesh, k: int, table_rows: int | None = None):
    """Count reads and validate an assembly in one jitted SPMD step —
    the framework's 'training step' for multi-chip dry runs.

    Asserts the capacity-factor routing did not drop records (retry
    orchestration lives in KmerTable._from_reads_sharded; the one-shot
    pipeline instead surfaces drops in its outputs).
    """
    count = sharded_count_fn(mesh, k)

    def step(read_codes, asm_codes):
        tkeys, tcov, tfw, tbw, _n, count_drop = count(read_codes)
        bits = probe_bits(tkeys.shape[-1], k)
        starts = sharded_bucket_fn(mesh, k, bits)(tkeys)
        probe = sharded_probe_fn(mesh, k, bits)
        out = probe(tkeys, tcov, tfw, tbw, starts, asm_codes)
        return out[:-1] + (out[-1] + count_drop,)

    return jax.jit(step)


def sharded_merge_fn(mesh: Mesh):
    """Build the jitted SPMD union-merge step.

    Device-mesh `kreeq union` at scale (reference workload:
    src/graph-builder.cpp:297-432, submap-parallel mergeMaps): the two
    input tables are key-range partitioned on the host (both are
    sorted, so a shard's slice pair is contiguous), each device merges
    its slice pair locally with the saturating sorted merge, and the
    concatenation of per-shard results — disjoint, ascending ranges —
    is the merged table with no inter-device data movement at all.

    Inputs: [n, rows] per-shard SENTINEL-padded slices of each table
    (stacked on the device axis).  Outputs: [n, 2*rows] merged
    SENTINEL-padded rows + [n] real-row counts.
    """
    from ..ops.kmers import merge_sorted

    def local_step(ak, ac, af, ab, bk, bc, bf, bb):
        mk, mc, mf, mb, nm = merge_sorted(ak[0], ac[0], af[0], ab[0],
                                          bk[0], bc[0], bf[0], bb[0])
        return mk[None], mc[None], mf[None], mb[None], nm[None]

    from jax import shard_map

    specs = (P(AXIS),) * 8
    fn = shard_map(local_step, mesh=mesh, in_specs=specs,
                   out_specs=(P(AXIS),) * 5)
    return jax.jit(fn)
