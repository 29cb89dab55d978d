"""Fused assembly-validation kernel: probe + per-base QV classification.

Vectorized re-expression of the reference's evaluateSegment
(reference: src/kreeq.cpp:110-229): for every k-mer position of a
segment, look its canonical key up in the table, then classify it as
missing (cov == 0 or cov < covCutOff) or edge-missing (both the left
and right edge counters for the actual neighbour bases are zero).

Output per position: cov, isFw, right-edge count, left-edge count —
the right/left orientation-normalized pair is what the reference stores
as DBGbase.fw/bw after its isFw shuffle (reference:
src/kreeq.cpp:177-210 with the printTable swap at
src/kreeq-output.cpp:197-207).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .kmers import kmer_positions, probe_bucketed, probe_merge


def _classify(codes, k: int, cutoff: int, isfw, valid, found, cov, fw,
              bw):
    """Per-base QV classification given probe results."""
    n = codes.shape[0]
    p = n - k + 1
    found = found & valid

    nxt = jnp.concatenate([codes[k:], jnp.full((1,), 4, jnp.uint8)])
    prv = jnp.concatenate([jnp.full((1,), 4, jnp.uint8), codes[: p - 1]])
    has_next = nxt <= 3
    has_prev = prv <= 3
    nc = (nxt & 3).astype(jnp.int32)
    pc = (prv & 3).astype(jnp.int32)

    # column selection by one-hot select+reduce over the 4 lanes
    lanes = jnp.arange(4, dtype=jnp.int32)[None, :]

    def pick(mat, idx):
        return jnp.where(lanes == idx[:, None], mat, jnp.uint32(0)).sum(
            axis=1, dtype=jnp.uint32)

    right = pick(jnp.where(isfw[:, None], fw, bw),
                 jnp.where(isfw, nc, 3 - nc))
    left = pick(jnp.where(isfw[:, None], bw, fw),
                jnp.where(isfw, pc, 3 - pc))
    right = jnp.where(found & has_next, right, 0)
    left = jnp.where(found & has_prev, left, 0)

    cov = jnp.where(found, cov, 0)
    # no `valid` guard: windows containing non-ACGT bases (IUPAC codes;
    # N runs are split into segments upstream) have found=False, so
    # cov==0 marks them missing — matching the reference, whose garbage
    # hash for such windows can only miss the DB
    missing = (cov == 0) | (cov < jnp.uint32(cutoff))
    no_right = has_next & (right == 0)
    no_left = has_prev & (left == 0)
    edge_missing = valid & ~missing & no_left & no_right
    # the reference fills edge tracks only on the non-missing branch
    # (src/kreeq.cpp:176-210)
    right = jnp.where(missing, 0, right)
    left = jnp.where(missing, 0, left)
    return valid, missing, edge_missing, cov, isfw, right, left


@partial(jax.jit, static_argnums=(6, 7, 8, 9, 10))
def validate_positions(tkeys, tcov, tfw, tbw, starts, codes, k: int,
                       cutoff: int, bits: int, rounds: int,
                       use_merge: bool = False):
    """codes: uint8[N] one segment (BAD-padded to a bucket size).

    Returns per-position arrays of length P = N - k + 1:
      valid, missing, edge_missing (bool), cov u32, isfw bool,
      right u32, left u32.

    use_merge selects the gather-free sort-merge probe, which wins
    whenever the table is not much larger than the window (the caller
    decides — see KmerTable.probe for the heuristic).
    """
    keys, isfw, _edges, valid = kmer_positions(codes, k)
    if use_merge:
        found, cov, fw, bw = probe_merge(tkeys, tcov, tfw, tbw, keys)
    else:
        found, cov, fw, bw = probe_bucketed(tkeys, tcov, tfw, tbw,
                                            starts, keys, k, bits,
                                            rounds)
    return _classify(codes, k, cutoff, isfw, valid, found, cov, fw, bw)


@jax.jit
def qv_window_sums(missing, edge_missing, lead, hi):
    """Window-masked QV sums of a classification result: i64[2] =
    (#missing, #edge-missing) over positions lead <= i < hi."""
    idx = jnp.arange(missing.shape[0], dtype=jnp.uint32)
    inwin = (idx >= lead) & (idx < hi)
    return jnp.stack(
        [jnp.sum((missing & inwin).astype(jnp.int64)),
         jnp.sum((edge_missing & inwin).astype(jnp.int64))])


@partial(jax.jit, static_argnums=(1,))
def _extract_ctx(codes, k: int):
    """Extraction + the per-position selection context for
    select_by_ctx: ctx bits 0-3 = right vals-row (1-4 fw, 5-8 bw),
    bits 4-7 = left vals-row — the same column choice _classify's
    pick() makes (right = isfw ? fw[nc] : bw[3-nc], left = isfw ?
    bw[pc] : fw[3-pc], reference: src/kreeq.cpp:177-210)."""
    keys, isfw, _edges, valid = kmer_positions(codes, k)
    p = keys.shape[0]
    nxt = jnp.concatenate([codes[k:], jnp.full((1,), 4, jnp.uint8)])
    prv = jnp.concatenate([jnp.full((1,), 4, jnp.uint8), codes[: p - 1]])
    nc = (nxt & 3).astype(jnp.int32)
    pc = (prv & 3).astype(jnp.int32)
    row_r = jnp.where(isfw, 1 + nc, 5 + (3 - nc))
    row_l = jnp.where(isfw, 5 + pc, 1 + (3 - pc))
    ctx = (row_r | (row_l << 4)).astype(jnp.uint32)
    return keys, isfw, valid, ctx


@partial(jax.jit, static_argnums=(2, 3))
def _classify_sel(codes, sel, k: int, cutoff: int, isfw=None, valid=None):
    """_classify semantics over a context-selected probe result
    (found, cov, right, left already column-selected)."""
    found, cov, right, left = sel
    n = codes.shape[0]
    p = n - k + 1
    found = found & valid
    nxt = jnp.concatenate([codes[k:], jnp.full((1,), 4, jnp.uint8)])
    prv = jnp.concatenate([jnp.full((1,), 4, jnp.uint8), codes[: p - 1]])
    has_next = nxt <= 3
    has_prev = prv <= 3
    right = jnp.where(found & has_next, right, 0)
    left = jnp.where(found & has_prev, left, 0)
    cov = jnp.where(found, cov, 0)
    missing = (cov == 0) | (cov < jnp.uint32(cutoff))
    no_right = has_next & (right == 0)
    no_left = has_prev & (left == 0)
    edge_missing = valid & ~missing & no_left & no_right
    right = jnp.where(missing, 0, right)
    left = jnp.where(missing, 0, left)
    return valid, missing, edge_missing, cov, isfw, right, left


@jax.jit
def select_by_ctx(found, cov, fw, bw, ctx):
    """Apply _extract_ctx's selection context to a probe result:
    (found, cov, right, left) with right/left the edge counters the
    context picks (row 0 = cov, 1-4 = fw, 5-8 = bw)."""
    row_r = (ctx & 0xF).astype(jnp.int32)
    row_l = ((ctx >> 4) & 0xF).astype(jnp.int32)
    cols = jnp.concatenate([cov[:, None], fw, bw], axis=1)  # [q, 9]
    lanes = jnp.arange(9, dtype=jnp.int32)[None, :]

    def pick(idx):
        return jnp.where(lanes == idx[:, None], cols,
                         jnp.uint32(0)).sum(axis=1, dtype=jnp.uint32)

    return found, cov, pick(row_r), pick(row_l)
