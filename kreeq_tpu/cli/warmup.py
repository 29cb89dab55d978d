"""`kreeq warmup`: pre-compile the standard shape grid into the
persistent compilation cache.

A cold CLI run compiles every XLA program it uses.  All hot programs
have shape-bucketed inputs (pow2 chunk sizes, pow2 table buckets, fixed
validate windows), so one warmup pass compiles the set a standard
`validate` run needs; subsequent cold processes hit the
persistent cache (kreeq_tpu/__init__.py wires jax_compilation_cache_dir)
and skip straight to execution.

Usage: kreeq warmup [-k <len>] [--chunk N] [--window N] [--small]
"""

from __future__ import annotations

import sys
import time
from typing import List


def _compile_set(k: int, chunk: int, window: int, small: bool) -> int:
    import numpy as np

    import jax
    import jax.numpy as jnp

    from ..ops import kmers as K
    from ..ops.validate import validate_positions
    from ..utils import log

    rng = np.random.default_rng(0)
    n_compiled = 0

    def tick(name, fn):
        nonlocal n_compiled
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        n_compiled += 1
        log.verbose(f"warmup: {name} ({dt:.1f}s)")
        return out

    # 1. extraction + count at the standard chunk
    codes = jnp.asarray(rng.integers(0, 4, chunk).astype(np.uint8))

    def count():
        keys, _i, edges, valid = K.kmer_positions(codes, k)
        return K.count_sorted(keys, edges, valid)

    tkeys, cov, fw, bw, n = tick(f"count @{chunk}", count)

    # 2. merge shapes: equal pow2 pairs up the build tree
    sizes = [1 << i for i in range(20, 24)] if not small else [1 << 12]
    for s in sizes:
        if s > tkeys.shape[0]:
            break
        a = (tkeys[:s], cov[:s], fw[:s], bw[:s])
        tick(f"merge {s}+{s}", lambda a=a: K.merge_sorted(*a, *a))

    # 3. validate windows against pow2 table buckets around the chunk
    wbuf = jnp.asarray(rng.integers(0, 4, window + k + 1)
                       .astype(np.uint8))
    buckets = ([3 << 21, 1 << 23, 3 << 22, 1 << 24] if not small
               else [1 << 12])
    for b in buckets:
        t = min(b, tkeys.shape[0])
        tk = tkeys[:t]
        tc, tf, tb = cov[:t], fw[:t], bw[:t]
        bits = min(max(8, int(np.ceil(np.log2(max(t, 2)))) + 1), 24,
                   2 * k)
        starts = K.build_bucket_index(tk, k, bits)
        counts = np.diff(np.asarray(starts))
        rounds = max(1, int(np.ceil(np.log2(counts.max() + 1))))
        use_merge = t <= 6 * (window + 2)
        tick(f"probe t={t}",
             lambda: validate_positions(tk, tc, tf, tb, starts, wbuf,
                                        k, 0, bits, rounds, use_merge))

    # 4. the variants fused scan-probe (`-o vcf` / `-o gfa` paths) at
    # the production window: extraction + sentinels + probe + depth-0
    # candidate scan in one program.
    # (Traversal's frontier programs are deliberately NOT warmed: their
    # shapes depend on run-specific subgraph/frontier pow2 sizes.)
    from ..core.variants import _scan_probe_fn, _variants_window_cap

    vwin = _variants_window_cap() if not small else (1 << 10)
    nbase = vwin + 2 * k + 12  # core + max_span/k+max_span+1 halos
    vpad = max(64, 1 << int(np.ceil(np.log2(nbase))))
    vbuf = jnp.asarray(rng.integers(0, 4, vpad).astype(np.uint8))
    scan_probe = _scan_probe_fn()
    for b in (buckets if not small else buckets[:1]):
        t = min(b, tkeys.shape[0])
        tk = tkeys[:t]
        tc, tf, tb = cov[:t], fw[:t], bw[:t]
        use_merge = t <= 6 * (vpad - k + 1)
        if use_merge:
            bits_v, rounds_v = 8, 1
            starts_v = jnp.zeros((1 << bits_v) + 1, jnp.int32)
        else:
            bits_v = min(max(8, int(np.ceil(np.log2(max(t, 2)))) + 1),
                         24, 2 * k)
            starts_v = K.build_bucket_index(tk, k, bits_v)
            counts_v = np.diff(np.asarray(starts_v))
            rounds_v = max(1, int(np.ceil(np.log2(counts_v.max() + 1))))
        tick(f"variants-scan t={t}",
             lambda: scan_probe(tk, tc, tf, tb, starts_v, vbuf,
                                jnp.uint32(0), k, use_merge, bits_v,
                                rounds_v))
    return n_compiled


def run(argv: List[str]) -> int:
    from ..utils import log

    k = 21
    chunk = 1 << 23
    window = 1 << 22
    small = False
    i = 2
    while i < len(argv):
        a = argv[i]
        if a == "-k":
            i += 1
            k = int(argv[i])
        elif a == "--chunk":
            i += 1
            chunk = int(argv[i])
        elif a == "--window":
            i += 1
            window = int(argv[i])
        elif a == "--small":
            small = True  # tiny shapes: CI smoke of the warmup path
        elif a in ("-v", "--verbose"):
            log.set_flags(True, False)
        else:
            sys.stderr.write(f"warmup: unknown option {a}\n")
            return 1
        i += 1
    if small:
        chunk, window = 1 << 14, 1 << 12
    log.set_flags(True, False)
    t0 = time.perf_counter()
    n = _compile_set(k, chunk, window, small)
    print(f"warmup: {n} programs compiled/cached in "
          f"{time.perf_counter() - t0:.1f}s (k={k}, chunk={chunk}, "
          f"window={window})")
    return 0
