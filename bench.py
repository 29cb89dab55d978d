"""Plain-layer timings on one accelerator: count, merge, QV probe.

Times the device layers of the build and validate paths at their
production shapes (k = 21, the CLI default), warm, each call ending
in `block_until_ready`:

  * count: kmer_positions + count_sorted over one 8M-base chunk;
  * merge: merge_sorted of two 8M-row count tables;
  * qv_sums / track: validate_positions over one 4M-position validate
    window against an 8M-row table, by the sort-merge join and by the
    bucketed bisection, then the QV window sums (qv_sums) or the
    per-base track readback (track).

Each layer's time stands beside an estimate of its share of the
card's memory bandwidth (est_hbm_share): the bytes the layer must read
and write once, counted by hand below, over the data-sheet peak in
PEAK_BYTES_PER_S, over the time.  It is not read from a trace.  The
optimized HLO of each program (and of the subgraph frontier's survivor
scan) is searched for its sorts, to say which lower to a library radix
sort and which to XLA's own comparison sort.

Prints the card's name and power limit, then one JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "extra": {...}}
The headline metric is the count rate on the CPU oracle's workload
(one 8M-base chunk of uniform bases at k = 31), and vs_baseline
divides it by that oracle (tools/cpu_oracle/oracle.cpp, BASELINE.md
"Measured CPU oracle baseline"): 29.3 M k-mers counted/s on a 4-core
host.

Exits non-zero without a result when JAX finds no accelerator.
Usage: python bench.py
"""

import json
import re
import statistics
import subprocess
import sys
import time

# reference-style CPU oracle, 4-core host, k = 31 (BASELINE.md)
ORACLE_COUNT = 29.3e6
ORACLE_K = 31

# published HBM bandwidth by device_kind (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

K = 21
CHUNK = 1 << 23  # build chunk (KmerTable.from_reads default)
WINDOW = 1 << 22  # DBG.VALIDATE_WINDOW
ROW_BYTES = 44  # u64 key + 9 x u32 payload
REPS = 7


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "not available"


def sort_lowering(fn, *args, **kw) -> dict:
    """Sorts in the optimized HLO of fn(*args): library radix-sort
    custom calls vs XLA's own `sort` instructions."""
    lines = fn.lower(*args, **kw).compile().as_text().splitlines()
    radix = [ln.strip() for ln in lines
             if 'custom_call_target="__cub$DeviceRadixSort"' in ln]
    xla = [ln.strip() for ln in lines if re.search(r"\ssort\(", ln)]
    return {"radix_custom_calls": len(radix), "xla_sort_ops": len(xla),
            "hlo": [ln[:200] for ln in radix + xla]}


def timed(fn, *args):
    """Median wall seconds of fn(*args) over REPS warm calls; fn must
    return device arrays or host values."""
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import kreeq_tpu  # noqa: F401  (x64)
    from kreeq_tpu.ops import kmers as Km
    from kreeq_tpu.ops.frontier import _survivors
    from kreeq_tpu.ops.validate import qv_window_sums, validate_positions

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("bench.py: no accelerator found", file=sys.stderr)
        return 1
    if dev.device_kind not in PEAK_BYTES_PER_S:
        print(f"bench.py: no peak bandwidth for {dev.device_kind!r}",
              file=sys.stderr)
        return 1
    peak = PEAK_BYTES_PER_S[dev.device_kind]
    print(f"card: {card_line()}", flush=True)

    rng = np.random.default_rng(0)
    extra = {"device": {"platform": dev.platform,
                        "kind": dev.device_kind,
                        "count": len(jax.devices())},
             "k": K, "chunk_bases": CHUNK, "window_positions": WINDOW,
             "reps": REPS}

    def report(name, dt, times, nbytes):
        extra[name] = {"median_ms": dt * 1e3,
                       "all_ms": [t * 1e3 for t in times],
                       "min_bytes": nbytes,
                       "est_hbm_share": nbytes / peak / dt}

    def count_at(k):
        @jax.jit
        def count_step(codes):
            keys, _isfw, edges, valid = Km.kmer_positions(codes, k)
            return Km.count_sorted(keys, edges, valid)
        return count_step

    count_step = count_at(K)
    chunks = [jnp.asarray(rng.integers(0, 4, CHUNK).astype(np.uint8))
              for _ in range(2)]
    p = CHUNK - K + 1
    dt, times = timed(count_step, chunks[0])
    # codes in, table rows out
    report("count", dt, times, CHUNK + p * ROW_BYTES)
    extra["count"]["sorts"] = sort_lowering(count_step, chunks[0])

    # the headline: the oracle's workload
    dt, times = timed(count_at(ORACLE_K), chunks[0])
    p31 = CHUNK - ORACLE_K + 1
    report(f"count_k{ORACLE_K}", dt, times, CHUNK + p31 * ROW_BYTES)
    count_rate = p31 / dt

    ta = count_step(chunks[0])
    tb = count_step(chunks[1])
    extra["table_rows"] = [int(ta[4]), int(tb[4])]
    dt, times = timed(Km.merge_sorted, *ta[:4], *tb[:4])
    report("merge", dt, times, 3 * p * ROW_BYTES)
    extra["merge"]["sorts"] = sort_lowering(Km.merge_sorted, *ta[:4],
                                            *tb[:4])

    # validate: a window drawn from the table's own chunk (hit-heavy,
    # the assembly-QC case) against the 8M-row table
    tkeys, tcov, tfw, tbw, n = ta
    n = int(n)
    buf = jnp.asarray(np.asarray(chunks[0])[:WINDOW + K + 1])
    npos = WINDOW + 2
    bits = min(int(np.ceil(np.log2(n))) + 1, 24, 2 * K)
    starts = jnp.minimum(Km.build_bucket_index(tkeys, K, bits), n)
    rounds = max(1, int(np.ceil(np.log2(np.diff(np.asarray(starts))
                                        .max() + 1))))
    extra["probe_join_rule"] = (
        "merge" if tkeys.shape[0] <= 6 * buf.shape[0] else "bucketed")
    lead, hi = jnp.uint32(1), jnp.uint32(1 + WINDOW)
    for join, use_merge in (("merge", True), ("bucketed", False)):
        args = (tkeys, tcov, tfw, tbw, starts, buf, K, 0, bits, rounds,
                use_merge)

        def qv(*a):
            res = validate_positions(*a)
            return np.asarray(qv_window_sums(res[1], res[2], lead, hi))

        def track(*a):
            res = validate_positions(*a)
            return [np.asarray(x) for x in res[3:]]

        dt, times = timed(qv, *args)
        # table read once, window codes in
        report(f"qv_sums_{join}", dt, times,
               int(tkeys.shape[0]) * ROW_BYTES + buf.shape[0])
        dt, times = timed(track, *args)
        # plus four per-position tracks out
        report(f"track_{join}", dt, times,
               int(tkeys.shape[0]) * ROW_BYTES + buf.shape[0]
               + npos * 13)
        extra[f"qv_sums_{join}"]["sorts"] = sort_lowering(
            validate_positions, *args)

    # the subgraph frontier's membership + compaction sorts
    m = 1 << 16
    extra["frontier_sorts"] = sort_lowering(
        _survivors, tkeys[:m], tfw[:m], tbw[:m], tkeys[:m], K,
        jnp.uint32(0), m)

    stats = dev.memory_stats() or {}
    extra["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    print(json.dumps({
        "metric": "read kmers counted/s/chip",
        "value": count_rate,
        "unit": "kmers/s",
        "vs_baseline": count_rate / ORACLE_COUNT,
        "extra": extra}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
