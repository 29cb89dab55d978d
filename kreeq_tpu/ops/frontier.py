"""Device-side neighbour expansion for subgraph searches.

The three subgraph passes (`traversal` BFS rounds, the best-first
boundary prefilter, `remove_missing_edges`) all start the same way:
compute every node's eight canonical neighbour keys, keep slots whose
edge counter passes the cutoff AND whose neighbour is not already in
the subgraph, then act on the (typically few) survivors.  On host
numpy that scan is O(8n) searchsorted work and dominates
chromosome-scale runs; here it runs as one device program: a 2-key
u32/u64 sort-merge membership join plus one compaction sort — no
searchsorted gather rounds, no row scatters.

Replaces the scan loops of reference src/subgraph.cpp:329-356
(traversalPass), :460-505 (DBGtoVariants depth-0 scan), :599-628
(removeMissingEdges); the reference does per-neighbour hash-map finds.

Layout contract (shared with core.keys.neighbors8_np): slot j of node
i is neighbour fw0,bw0,fw1,bw1,...  Flat index = i*8 + j, ascending =
the reference's exact scan order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

SENTINEL = jnp.uint64(0xFFFFFFFFFFFFFFFF)

_IDX_BITS = 23  # flat index budget: frontiers are slabbed to <= 2^20 nodes
_TAG_BIT = jnp.uint64(1 << _IDX_BITS)
_LO_VAL_BITS = 64 - _IDX_BITS - 1  # 40 value bits ride the lo word


def _revcomp(keys, k: int):
    m = jnp.uint64((1 << (2 * k)) - 1)
    x = ((~keys) & m) << jnp.uint64(64 - 2 * k)
    for sh, mm in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                   (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        mm = jnp.uint64(mm)
        x = ((x & mm) << jnp.uint64(sh)) | ((x >> jnp.uint64(sh)) & mm)
    return ((x << jnp.uint64(32)) | (x >> jnp.uint64(32))) & m


def _neighbors8(keys, k: int):
    """Canonical neighbour keys [n, 8] in fw0,bw0,..,fw3,bw3 order."""
    rc = _revcomp(keys, k)
    m = jnp.uint64((1 << (2 * k)) - 1)
    bases = jnp.arange(4, dtype=jnp.uint64)[None, :]
    comp = jnp.uint64(3) - bases
    top = jnp.uint64(2 * (k - 1))
    raw_fw = (keys[:, None] >> jnp.uint64(2)) | (bases << top)
    rc_fw = ((rc[:, None] << jnp.uint64(2)) & m) | comp
    raw_bw = ((keys[:, None] << jnp.uint64(2)) & m) | bases
    rc_bw = (rc[:, None] >> jnp.uint64(2)) | (comp << top)
    fw_c = jnp.minimum(raw_fw, rc_fw)
    bw_c = jnp.minimum(raw_bw, rc_bw)
    return jnp.stack([fw_c, bw_c], axis=2).reshape(keys.shape[0], 8)


def _survivors_core(keys, fw, bw, sub_sorted, k: int, cutoff, cap: int,
                    dedup: bool):
    """Traced body shared by _survivors and the fused expand round.
    With dedup=True, only the FIRST scan-order occurrence of each
    candidate value survives (duplicate slots die before the restore
    sort), preserving the reference's first-wins insertion order."""
    n = keys.shape[0]
    n8 = n * 8
    if n8 > (1 << _IDX_BITS):  # max flat index n8-1 must fit _IDX_BITS
        raise ValueError("frontier slab too large; split at 2^20 nodes")
    cand = _neighbors8(keys, k)
    elig = jnp.stack([fw > cutoff, bw > cutoff], axis=2).reshape(n, 8)
    elig = elig & (keys != SENTINEL)[:, None]
    candf = jnp.where(elig.reshape(n8), cand.reshape(n8), SENTINEL)

    msub = sub_sorted.shape[0]
    vals = jnp.concatenate([sub_sorted, candf])
    tag = jnp.concatenate([jnp.zeros((msub,), jnp.uint64),
                           jnp.ones((n8,), jnp.uint64)])
    idx = jnp.concatenate([jnp.zeros((msub,), jnp.uint64),
                           jnp.arange(n8, dtype=jnp.uint64)])
    hi = (vals >> jnp.uint64(_LO_VAL_BITS)).astype(jnp.uint32)
    lo = ((vals & jnp.uint64((1 << _LO_VAL_BITS) - 1))
          << jnp.uint64(_IDX_BITS + 1)) | (tag << jnp.uint64(_IDX_BITS)) \
        | idx
    shi, slo = jax.lax.sort((hi, lo), num_keys=2)
    sval = (shi.astype(jnp.uint64) << jnp.uint64(_LO_VAL_BITS)) \
        | (slo >> jnp.uint64(_IDX_BITS + 1))
    is_cand = (slo & _TAG_BIT) != 0
    sidx = (slo & jnp.uint64((1 << _IDX_BITS) - 1)).astype(jnp.uint32)

    # last sub value carried forward; +1 so "no sub row yet" (0) never
    # matches (a canonical key can never be 2^64-1, so no overflow)
    carried = jax.lax.cummax(jnp.where(is_cand, jnp.uint64(0),
                                       sval + jnp.uint64(1)))
    member = is_cand & (carried == sval + jnp.uint64(1))
    ok = is_cand & ~member & (sval != SENTINEL)
    if dedup:
        # equal candidate values sort adjacently (idx ascending), so
        # any ok row following an equal ok row is a later occurrence
        prev_ok = jnp.concatenate([jnp.zeros((1,), bool), ok[:-1]])
        prev_sval = jnp.concatenate([jnp.zeros((1,), jnp.uint64),
                                     sval[:-1]])
        ok = ok & ~(prev_ok & (prev_sval == sval))
    count = jnp.sum(ok.astype(jnp.uint32))

    rk = jnp.where(ok, sidx, jnp.uint32(0xFFFFFFFF))
    srk, svals_o, _ = jax.lax.sort((rk, sval, slo), num_keys=1)
    out_vals = jnp.where(srk[:cap] != jnp.uint32(0xFFFFFFFF),
                         svals_o[:cap], SENTINEL)
    return count, out_vals, srk[:cap]


def _round_body(keys, fw, bw, sub_sorted, k: int, cutoff, cap: int,
                bits: int, tkeys, tcov, tfw, tbw, tstarts):
    """Traced body of one BFS round: survivor scan + first-wins dedup
    + table probe + next-frontier masking.  Shared by the one-round
    program (_expand_round) and the multi-round scan
    (_expand_rounds_scan)."""
    from .kmers import probe_bucketed_dyn

    count, vals, _idx = _survivors_core(keys, fw, bw, sub_sorted, k,
                                        cutoff, cap, dedup=True)
    found, cov, pfw, pbw = probe_bucketed_dyn(
        tkeys, tcov, tfw, tbw, tstarts, vals, k, bits)
    nkeys = jnp.where(found, vals, SENTINEL)
    nfw = jnp.where(found[:, None], pfw, 0)
    nbw = jnp.where(found[:, None], pbw, 0)

    u64 = jnp.uint64

    def pack2(a, b):
        return a.astype(u64) | (b.astype(u64) << u64(32))

    hdr = jnp.zeros((1, 6), u64).at[0, 0].set(count.astype(u64))
    rows = jnp.stack(
        [vals, pack2(cov, found.astype(jnp.uint32)),
         pack2(pfw[:, 0], pfw[:, 1]), pack2(pfw[:, 2], pfw[:, 3]),
         pack2(pbw[:, 0], pbw[:, 1]), pack2(pbw[:, 2], pbw[:, 3])],
        axis=1)
    packed = jnp.concatenate([hdr, rows], axis=0)
    return packed, nkeys, nfw, nbw


@partial(jax.jit, static_argnums=(4, 6, 7))
def _expand_round(keys, fw, bw, sub_sorted, k: int, cutoff,
                  cap: int, bits: int, tkeys=None, tcov=None, tfw=None,
                  tbw=None, tstarts=None):
    """ONE device program per BFS round.

    Returns (packed, nkeys, nfw, nbw) where `packed` is a [cap+1, 6]
    u64 matrix holding ALL the host bookkeeping for the round in ONE
    blocking readback instead of one per stage.  Row 0 =
    [survivor count, 0...]; row 1+i = [key, cov | found<<32, fw01,
    fw23, bw01, bw23] of candidate i in scan order (key = SENTINEL
    past the count).  The next-frontier outputs depend only on device
    state, so callers can dispatch ALL rounds before draining any."""
    return _round_body(keys, fw, bw, sub_sorted, k, cutoff, cap, bits,
                       tkeys, tcov, tfw, tbw, tstarts)


@partial(jax.jit, static_argnums=(4, 6, 7, 8))
def _expand_rounds_scan(keys, fw, bw, sub_sorted, k: int, cutoff,
                        cap: int, bits: int, nrounds: int,
                        tkeys=None, tcov=None, tfw=None, tbw=None,
                        tstarts=None):
    """`nrounds` BFS rounds fused into ONE device program (lax.scan).

    Fusing R rounds per dispatch divides the per-dispatch overhead of
    chained _expand_round programs by R.  The frontier carry is the
    fixed [cap]-shaped masked frontier (exactly what _expand_round
    already returns), sub_sorted stays constant across rounds (same
    semantics as the per-round path: within-round first-wins dedup
    only — re-discoveries across rounds are dropped by the host dict,
    reference scan order preserved).

    Returns (packs [nrounds, cap+1, 6], final (keys, fw, bw)) — the
    final carry feeds the next fused batch."""

    def body(carry, _):
        keys, fw, bw = carry
        packed, nk, nf, nb = _round_body(
            keys, fw, bw, sub_sorted, k, cutoff, cap, bits,
            tkeys, tcov, tfw, tbw, tstarts)
        return (nk, nf, nb), packed

    carry, packs = jax.lax.scan(body, (keys, fw, bw), None,
                                length=nrounds)
    return packs, carry


@partial(jax.jit, static_argnums=(4, 6))
def _survivors(keys, fw, bw, sub_sorted, k: int, cutoff, cap: int):
    """(count, vals[cap], idx[cap]): surviving neighbour slots.

    A slot survives when its edge counter > cutoff and its canonical
    neighbour key is NOT in sub_sorted.  Survivors are returned packed
    to the front in flat scan order; dead tail entries read
    (SENTINEL, 0xFFFFFFFF).  `count` is the true survivor total — if
    count > cap the caller must retry with a larger cap.

    Membership + compaction are two sorts, not searchsorted: [sub keys ++ neighbour keys] sorts once by
    (value, sub-first); a cummax carries the last sub value so equal
    neighbour rows test membership; one 3-operand sort restores scan
    order with dead rows last.
    """
    return _survivors_core(keys, fw, bw, sub_sorted, k, cutoff, cap,
                           dedup=False)


_SLAB = 1 << 20


def use_device(n_nodes: int) -> bool:
    """Gate: device expansion pays off only for big scans (each round
    costs a device dispatch) and only on an accelerator backend (on the
    CPU backend lax.sort loses to the numpy searchsorted scan).
    KREEQ_TPU_FRONTIER_MIN overrides the node threshold (0 = always,
    including on CPU — the parity tests force both paths with it)."""
    import os

    env = os.environ.get("KREEQ_TPU_FRONTIER_MIN")
    if env is not None:
        return n_nodes >= int(env)
    if jax.default_backend() == "cpu":
        return False
    return n_nodes >= (1 << 15)


def survivors_dev(keys_d, fw_d, bw_d, sub_pad_d, k: int, cutoff: int):
    """Device-resident driver: inputs are device arrays already padded
    to a power of two (SENTINEL keys in dead slots), sub_pad_d is the
    SENTINEL-padded sorted subgraph key set.  Returns surviving
    neighbour values (host numpy, flat scan order) — the only readback;
    the frontier arrays themselves never leave the device."""
    n = keys_d.shape[0]
    if n == 0:
        return np.zeros(0, np.uint64)
    all_vals = []
    for s0 in range(0, n, _SLAB):
        kp = keys_d[s0:s0 + _SLAB]
        fp = fw_d[s0:s0 + _SLAB]
        bp = bw_d[s0:s0 + _SLAB]
        cap = 1 << 14
        while True:
            cap = min(cap, kp.shape[0] * 8)
            cnt, vals, _idx = _survivors(kp, fp, bp, sub_pad_d, k,
                                         np.uint32(cutoff), cap)
            cnt = int(cnt)
            if cnt <= cap:
                break
            cap = 1 << int(np.ceil(np.log2(cnt)))
        all_vals.append(np.asarray(vals[:cnt]))
    return np.concatenate(all_vals) if len(all_vals) > 1 else all_vals[0]


def survivors_np(keys, fw, bw, sub_sorted, k: int, cutoff: int):
    """Host driver: pad/slab inputs, retry on cap overflow.

    keys u64[n] (frontier/subgraph nodes), fw/bw u32[n,4] edge
    counters, sub_sorted ascending u64 subgraph key set.  Returns
    (vals u64[c], flat_idx int64[c]) of surviving slots in flat scan
    order (flat = node_row*8 + slot, fw0,bw0,..,fw3,bw3).
    """
    n = keys.shape[0]
    if n == 0:
        return (np.zeros(0, np.uint64), np.zeros(0, np.int64))
    spad = max(64, 1 << int(np.ceil(np.log2(max(sub_sorted.size, 1)))))
    sbuf = np.full(spad, 0xFFFFFFFFFFFFFFFF, np.uint64)
    sbuf[:sub_sorted.size] = sub_sorted
    all_vals, all_idx = [], []
    for s0 in range(0, n, _SLAB):
        part = slice(s0, min(s0 + _SLAB, n))
        kp, fp, bp = keys[part], fw[part], bw[part]
        npad = max(64, 1 << int(np.ceil(np.log2(kp.shape[0]))))
        if npad != kp.shape[0]:
            kp = np.concatenate([kp, np.full(npad - kp.shape[0],
                                             0xFFFFFFFFFFFFFFFF,
                                             np.uint64)])
            zp = np.zeros((npad - fp.shape[0], 4), np.uint32)
            fp = np.concatenate([fp, zp])
            bp = np.concatenate([bp, zp])
        cap = 1 << 14
        while True:
            cap = min(cap, npad * 8)
            cnt, vals, idx = _survivors(kp, fp, bp, sbuf, k,
                                        np.uint32(cutoff), cap)
            cnt = int(cnt)
            if cnt <= cap:
                break
            cap = 1 << int(np.ceil(np.log2(cnt)))
        vals = np.asarray(vals[:cnt])
        idx = np.asarray(idx[:cnt]).astype(np.int64) + s0 * 8
        all_vals.append(vals)
        all_idx.append(idx)
    return np.concatenate(all_vals), np.concatenate(all_idx)
