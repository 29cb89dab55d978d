#!/usr/bin/env python3
"""End-to-end smoke of kreeq on the GPU: build -> QV -> tracks -> union
-> variants -> subgraph, through the CLI, on a small-eukaryote read set.

Writes a seeded read set and assembly (by default a 12 Mbp genome with
planted repeat families; 30x of 150 bp reads from both strands with
0.5% substitutions, in two FASTQ files, about 312 M read k-mers; contigs
of 2 Mbp equal to the genome but for one planted substitution per
100 kbp; k = 21), then runs each phase as its own `bin/kreeq` or
`bin/kreeq-decompressor` process, one at a time on the card, and
checks it:

  1. build     `validate -r r1.fq r2.fq -o all.kreeq`: the total k-mer
               count, and cov and fw/bw edges of a 100k-key sample
               (half present, half absent), equal a numpy count over
               all reads;
  2. QV        `validate -f asm.fa -d all.kreeq`: the Merqury line
               equals the numpy reference, and the whole report equals
               the same command on the CPU;
  3. tracks    `-o out.bkwig`, then `kreeq-decompressor lookup` on
               sampled regions: per-base coverage equals the numpy
               reference;
  4. union     `kreeq union` of r1.kreeq and r2.kreeq equals all.kreeq
               key for key;
  5. variants  `-o out.vcf` on one contig, with the defaults and with
               TUNED (`-c 3 --search-depth 50`), each byte-identical
               to its CPU run; recall of the planted substitutions
               (position, REF and ALT) is reported;
  6. subgraph  `subgraph` on a 100 kbp slice, traversal and best-first,
               each byte-identical to its CPU run.

This process never opens the card.  It writes the data and computes
the numpy reference (which imports nothing of kreeq_tpu.ops) while the
CLI children run; the CPU comparison runs are children with
JAX_PLATFORMS=cpu.  One card is pinned with CUDA_VISIBLE_DEVICES.
With --cards 4 it runs only phases 1 and 2, on four cards in one
process (the sharded build), and compares them with the numpy
reference and with a one-card run of the same data.

Prints the card's name and power limit first, then one line per phase
with its wall time and peak device bytes, and last one JSON line
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Any failed check, or no GPU, ends the run with a non-zero exit and no
such line.

Usage: python chip_smoke.py [--cards 1|4] [--genome-mbp N] [--seed S]
                            [--workdir DIR]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KREEQ = os.path.join(HERE, "bin", "kreeq")
DECOMPRESSOR = os.path.join(HERE, "bin", "kreeq-decompressor")
BASE_ENV = dict(os.environ)  # the children's environment, untouched

K = 21
READ_LEN = 150
COVERAGE = 30
ERROR_RATE = 0.005
CONTIG = 2_000_000
SUB_EVERY = 100_000
SLICE = 100_000
# the variants phase's second run, as users tune it at 30x: a coverage
# cutoff that drops most error k-mers, and a search deep enough to
# walk past a substitution's k missing k-mers
TUNED = ["-c", "3", "--search-depth", "50"]
SAMPLE = 50_000  # present keys; as many absent ones
REGIONS = 16  # decompressor lookups
REGION_LEN = 2_000
DEADLINE_S = 1150  # whole run, compilation included
BASES = np.frombuffer(b"ACGT", np.uint8)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------
# children

class Children:
    """Every process this run starts, so that all are stopped on exit."""

    def __init__(self, workdir, deadline, cards):
        self.workdir = workdir
        self.deadline = deadline
        self.cards = cards
        self.procs = []
        self.lock = threading.Lock()

    def env(self, cpu, cards=None):
        env = dict(BASE_ENV)
        if cpu:
            env["JAX_PLATFORMS"] = "cpu"
            env["CUDA_VISIBLE_DEVICES"] = ""
            return env
        visible = env.get("CUDA_VISIBLE_DEVICES", "")
        ids = [x for x in visible.split(",") if x] or \
            [str(i) for i in range(4)]
        env["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:cards or self.cards])
        return env

    def run(self, argv, cpu=False, cards=None):
        """Run argv to its end; (stdout, stderr, seconds)."""
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=self.workdir,
                                env=self.env(cpu, cards),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        with self.lock:
            self.procs.append(proc)
        try:
            out, err = proc.communicate(
                timeout=max(self.deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise SmokeFailure(f"{' '.join(argv[-6:])}: out of time")
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SmokeFailure(f"{' '.join(argv[-6:])}: exit "
                               f"{proc.returncode}\n{err[-4000:]}")
        return out, err, dt

    def kreeq(self, args, cpu=False, cards=None):
        """One `bin/kreeq` process; (stdout, seconds, peak device
        bytes per visible device)."""
        out, err, dt = self.run([sys.executable, os.path.abspath(__file__),
                                 "--run-cli", KREEQ, *args], cpu, cards)
        peaks = None
        for line in err.splitlines():
            if line.startswith("SMOKE_PEAK_BYTES="):
                peaks = json.loads(line.split("=", 1)[1])
        return out, dt, peaks

    def stop_all(self):
        with self.lock:
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def run_cli(argv):
    """Child mode: run a bin/ entry point as its own __main__ and report
    the peak device bytes of every visible device at exit."""
    import atexit
    import runpy

    import jax
    from jax._src import xla_bridge

    def report():
        if not xla_bridge.backends_are_initialized():
            return
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                 for d in jax.local_devices()]
        sys.stderr.write(f"SMOKE_PEAK_BYTES={json.dumps(peaks)}\n")

    # registered after jax's own exit handler, so it runs before the
    # backends are torn down
    atexit.register(report)
    sys.argv = list(argv)
    runpy.run_path(argv[0], run_name="__main__")


def probe_device():
    """Child mode: the device as JAX reports it."""
    import jax

    devs = jax.devices()
    print(json.dumps({"platform": devs[0].platform,
                      "kind": devs[0].device_kind, "count": len(devs)}))


# ---------------------------------------------------------------------
# seeded data

def make_genome(rng, n):
    """Uniform bases plus 8 repeat families: units of 0.3-6 kbp, each
    pasted 20-60 times per 20 Mbp (at least twice) with 1% divergence,
    about 5% of the genome."""
    g = rng.integers(0, 4, n, dtype=np.uint8)
    for _ in range(8):
        unit = rng.integers(0, 4, int(rng.integers(300, 6000)),
                            dtype=np.uint8)[:n // 100]
        copies = max(2, int(rng.integers(20, 60) * n / 20e6))
        for _ in range(copies):
            pos = int(rng.integers(0, n - len(unit)))
            copy = unit.copy()
            mut = rng.random(len(copy)) < 0.01
            copy[mut] = (copy[mut] + rng.integers(1, 4, int(mut.sum()),
                                                  dtype=np.uint8)) % 4
            g[pos:pos + len(copy)] = copy
    return g


def make_reads(rng, g, n_reads, batch=250_000):
    """Reads [n, READ_LEN] of codes: uniform starts, both strands,
    ERROR_RATE substitutions."""
    reads = np.empty((n_reads, READ_LEN), np.uint8)
    offs = np.arange(READ_LEN)
    for lo in range(0, n_reads, batch):
        b = min(batch, n_reads - lo)
        starts = rng.integers(0, len(g) - READ_LEN + 1, b)
        r = g[starts[:, None] + offs]
        rev = rng.random(b) < 0.5
        r[rev] = 3 - r[rev, ::-1]
        err = rng.random((b, READ_LEN)) < ERROR_RATE
        r[err] = (r[err] + rng.integers(1, 4, int(err.sum()),
                                        dtype=np.uint8)) % 4
        reads[lo:lo + b] = r
    return reads


def write_fastq(path, reads, first_id, batch=200_000):
    """Fixed-width records: '@r<9 digits>', sequence, '+', quality."""
    n, ln = reads.shape
    width = 11 + ln + 3 + ln + 1
    with open(path, "wb") as fh:
        for lo in range(0, n, batch):
            r = reads[lo:lo + batch]
            b = len(r)
            rec = np.empty((b, width), np.uint8)
            rec[:, 0] = ord("@")
            rec[:, 1] = ord("r")
            ids = np.arange(first_id + lo, first_id + lo + b)
            for j in range(9):
                rec[:, 2 + j] = ord("0") + (ids // 10 ** (8 - j)) % 10
            rec[:, 11] = ord("\n")
            rec[:, 12:12 + ln] = BASES[r]
            rec[:, 12 + ln:15 + ln] = np.frombuffer(b"\n+\n", np.uint8)
            rec[:, 15 + ln:15 + 2 * ln] = ord("I")
            rec[:, -1] = ord("\n")
            fh.write(rec.tobytes())


def write_fasta(path, records):
    with open(path, "wb") as fh:
        for name, codes in records:
            fh.write(b">" + name.encode() + b"\n" + BASES[codes].tobytes()
                     + b"\n")


def make_assembly(rng, g):
    """Contigs of CONTIG bases; one substitution planted per SUB_EVERY
    bases, away from contig ends.  Returns ([(name, codes)],
    [(contig, pos, genome base, assembly base)])."""
    contigs, planted = [], []
    for ci, lo in enumerate(range(0, len(g), CONTIG)):
        codes = g[lo:lo + CONTIG].copy()
        for j in range(max(len(codes) // SUB_EVERY, 1)):
            span = min(SUB_EVERY, len(codes))
            pos = j * span + int(rng.integers(K, span - K))
            alt = (int(codes[pos]) + int(rng.integers(1, 4))) % 4
            planted.append((ci, pos, int(codes[pos]), alt))
            codes[pos] = alt
        contigs.append((f"ctg{ci}", codes))
    return contigs, planted


# ---------------------------------------------------------------------
# numpy reference (independent of kreeq_tpu.ops)

def canonical_keys(rows, k):
    """Canonical 2-bit keys (first base in the low bits, A=0 C=1 G=2
    T=3, canonical = min(forward, reverse complement)) and orientation
    of every k-mer of each row of `rows` [b, n]."""
    c = rows.astype(np.uint64)
    p = c.shape[1] - k + 1
    fw = np.zeros((c.shape[0], p), np.uint64)
    rc = np.zeros((c.shape[0], p), np.uint64)
    for i in range(k):
        fw |= c[:, i:i + p] << np.uint64(2 * i)
        rc |= (np.uint64(3) - c[:, i:i + p]) << np.uint64(2 * (k - 1 - i))
    isfw = fw <= rc
    return np.where(isfw, fw, rc), isfw


def count_over_reads(reads, queries, sampled, k, workers):
    """For sorted unique `queries`: the number of read k-mers equal to
    each (cov), and for the queries flagged in `sampled` their fw/bw
    edge counts ([n_sampled, 8]: fw to A,C,G,T then bw from A,C,G,T),
    counted over every k-mer of every read."""
    nq = len(queries)
    srank = np.cumsum(sampled) - 1  # query index -> sample row
    nsamp = int(sampled.sum())
    n, ln = reads.shape
    batch = 20_000

    def work(w):
        cov = np.zeros(nq, np.int64)
        edges = np.zeros(nsamp * 8, np.int64)
        for lo in range(w * batch, n, workers * batch):
            r = reads[lo:lo + batch]
            keys, isfw = canonical_keys(r, k)
            idx = np.minimum(np.searchsorted(queries, keys), nq - 1)
            hit = queries[idx] == keys
            cov += np.bincount(idx[hit], minlength=nq)
            rows, cols = np.nonzero(hit & sampled[idx])
            if rows.size == 0:
                continue
            prev_ok = cols > 0
            next_ok = cols + k < ln
            pc = r[rows, np.maximum(cols - 1, 0)].astype(np.int64)
            nc = r[rows, np.minimum(cols + k, ln - 1)].astype(np.int64)
            fwd = isfw[rows, cols]
            # forward-oriented k-mer: fw edge to the next base, bw edge
            # from the previous one; reverse: complemented and swapped
            fw_slot = np.where(fwd, nc, 3 - pc)
            fw_ok = np.where(fwd, next_ok, prev_ok)
            bw_slot = np.where(fwd, pc, 3 - nc)
            bw_ok = np.where(fwd, prev_ok, next_ok)
            srow = srank[idx[rows, cols]] * 8
            edges += np.bincount(srow[fw_ok] + fw_slot[fw_ok],
                                 minlength=nsamp * 8)
            edges += np.bincount(srow[bw_ok] + 4 + bw_slot[bw_ok],
                                 minlength=nsamp * 8)
        return cov, edges

    cov = np.zeros(nq, np.int64)
    edges = np.zeros(nsamp * 8, np.int64)
    with ThreadPoolExecutor(workers) as ex:
        for c, e in ex.map(work, range(workers)):
            cov += c
            edges += e
    return cov, edges.reshape(nsamp, 8)


class Reference:
    """The numpy answers every phase is checked against."""

    def __init__(self, reads, contigs, rng, workers):
        self.total = reads.shape[0] * (reads.shape[1] - K + 1)
        self.asm_keys = [canonical_keys(codes[None, :], K)[0][0]
                         for _name, codes in contigs]
        # sample: keys of random read positions (present) and random
        # canonical keys (absent, barring a 1e-5 chance each)
        rows = rng.integers(0, reads.shape[0], SAMPLE)
        cols = rng.integers(0, reads.shape[1] - K + 1, SAMPLE)
        present = canonical_keys(
            reads[rows[:, None], cols[:, None] + np.arange(K)], K)[0][:, 0]
        rnd = rng.integers(0, 4, (SAMPLE, K), dtype=np.uint8)
        absent = canonical_keys(rnd, K)[0][:, 0]
        self.sample = np.unique(np.concatenate([present, absent]))
        queries = np.unique(np.concatenate(self.asm_keys + [self.sample]))
        sampled = np.isin(queries, self.sample)
        cov, edges = count_over_reads(reads, queries, sampled, K, workers)
        self.sample_cov = cov[sampled]
        self.sample_edges = edges
        self.asm_cov = [cov[np.searchsorted(queries, keys)]
                        for keys in self.asm_keys]

    def merqury(self):
        missing = sum(int((c == 0).sum()) for c in self.asm_cov)
        total = sum(len(c) for c in self.asm_cov)
        err = 1 - (1 - missing / total) ** (1 / K)
        qv = -10 * np.log10(err) if err > 0 else float("inf")
        return missing, total, qv

    def track(self, ci):
        """Per-base coverage track of contig ci: the count of the k-mer
        starting at each base, zero where no k-mer starts."""
        cov = self.asm_cov[ci]
        out = np.zeros(len(cov) + K - 1, np.int64)
        out[:len(cov)] = cov
        return out


# ---------------------------------------------------------------------
# readers of the CLI's outputs

def read_db(path):
    from kreeq_tpu.io.kreeqdb import read_kreeq

    return read_kreeq(path)


def fmt_double(x):
    return "inf" if np.isinf(x) else f"{x:g}"


def qv_line(stdout, method):
    for line in stdout.splitlines():
        f = line.split("\t")
        if len(f) == 6 and f[5] == method:
            return f
    raise SmokeFailure(f"no {method} QV line in:\n{stdout[-2000:]}")


def check_build(db, ref):
    total = int(db.cov.astype(np.uint64).sum())
    check(total == ref.total,
          f"total k-mers {total} != reference {ref.total}")
    i = np.minimum(np.searchsorted(db.keys, ref.sample), len(db.keys) - 1)
    found = db.keys[i] == ref.sample
    cov = np.where(found, db.cov[i], 0)
    edges = np.where(found[:, None],
                     np.concatenate([db.fw[i], db.bw[i]], axis=1), 0)
    bad = np.nonzero((cov != ref.sample_cov)
                     | (edges != ref.sample_edges).any(axis=1))[0]
    check(bad.size == 0,
          f"{bad.size} sampled keys differ, first key "
          f"{int(ref.sample[bad[0]]) if bad.size else 0}")
    present = int((ref.sample_cov > 0).sum())
    return (f"total k-mers {total} exact; {len(ref.sample)} sampled keys "
            f"exact ({present} present, {len(ref.sample) - present} "
            f"absent); {len(db.keys)} rows")


def check_qv(stdout, ref):
    f = qv_line(stdout, "Merqury")
    missing, total, qv = ref.merqury()
    check((int(f[0]), int(f[1]), f[2]) == (missing, total, fmt_double(qv)),
          f"Merqury line {f[:3]} != reference "
          f"{(missing, total, fmt_double(qv))}")
    kf = qv_line(stdout, "Kreeq")
    return (f"Merqury missing {missing}/{total} QV {f[2]} exact; "
            f"Kreeq missing {kf[0]} QV {kf[2]}")


def parse_lookup(stdout):
    """{(header, start, end): cov column} from decompressor lookup."""
    blocks, key, vals = {}, None, []
    for line in stdout.splitlines():
        if not line:
            if key is not None:
                blocks[key] = np.array(vals, np.int64)
            key, vals = None, []
        elif key is None and ":" in line:
            hdr, rng = line.rsplit(":", 1)
            a, b = rng.split("-")
            key = (hdr, int(a), int(b))
        elif key is not None:
            vals.append(int(line.split(",")[0]))
    if key is not None:
        blocks[key] = np.array(vals, np.int64)
    return blocks


# ---------------------------------------------------------------------
# phases

class Smoke:
    def __init__(self, args):
        self.args = args
        self.t0 = time.monotonic()
        self.work = args.workdir or tempfile.mkdtemp(prefix=".smoke-",
                                                     dir=HERE)
        os.makedirs(self.work, exist_ok=True)
        self.kids = Children(self.work, self.t0 + DEADLINE_S, args.cards)
        self.cpu_jobs = []  # (name, thread), run one after another

    def path(self, name):
        return os.path.join(self.work, name)

    def say(self, msg):
        print(msg, flush=True)

    def phase_line(self, name, seconds, peaks, detail):
        peak = "not measured" if not peaks or peaks[0] is None else \
            ", ".join(str(p) for p in peaks)
        self.say(f"phase {name}: {seconds:.1f} s wall, peak device bytes "
                 f"[{peak}]; {detail}")

    def device(self):
        out, _err, _dt = self.kids.run(
            [sys.executable, os.path.abspath(__file__), "--probe"])
        dev = json.loads(out.strip().splitlines()[-1])
        check(dev["platform"] == "gpu",
              f"no GPU: JAX reports platform {dev['platform']!r}")
        check(dev["count"] == self.args.cards,
              f"{dev['count']} cards visible, {self.args.cards} asked")
        return dev

    def data(self):
        a = self.args
        rng = np.random.default_rng(a.seed)
        n = int(a.genome_mbp * 1_000_000)
        g = make_genome(rng, n)
        n_reads = n * COVERAGE // READ_LEN
        reads = make_reads(rng, g, n_reads)
        half = n_reads // 2
        write_fastq(self.path("r1.fq"), reads[:half], 0)
        write_fastq(self.path("r2.fq"), reads[half:], half)
        contigs, planted = make_assembly(rng, g)
        write_fasta(self.path("asm.fa"), contigs)
        write_fasta(self.path("one.fa"), contigs[:1])
        c = contigs[min(1, len(contigs) - 1)][1]
        ln = min(SLICE, len(c) // 2)
        write_fasta(self.path("slice.fa"), [("slice", c[:ln])])
        self.say(f"sizes: genome {n} bp, k {K}, {n_reads} reads x "
                 f"{READ_LEN} bp ({n_reads * READ_LEN} bases, "
                 f"{COVERAGE}x, {ERROR_RATE:.1%} substitutions), "
                 f"{len(contigs)} contigs, {len(planted)} planted "
                 f"substitutions, subgraph slice {ln} bp")
        self.reads, self.contigs, self.planted = reads, contigs, planted

    def start_reference(self):
        workers = max(1, min(12, (os.cpu_count() or 2) - 2))
        self.ref_result = {}

        def job():
            try:
                self.ref_result["ref"] = Reference(
                    self.reads, self.contigs,
                    np.random.default_rng([self.args.seed, 1]), workers)
            except BaseException as exc:  # re-raised in the main thread
                self.ref_result["error"] = exc

        self.ref_thread = threading.Thread(target=job, daemon=True)
        self.ref_thread.start()

    def reference(self):
        self.ref_thread.join(max(self.t0 + DEADLINE_S - time.monotonic(),
                                 1))
        check(not self.ref_thread.is_alive(), "numpy reference: out of time")
        if "error" in self.ref_result:
            raise self.ref_result["error"]
        return self.ref_result["ref"]

    def start_cpu(self, name, args):
        """A CPU run of `kreeq args` in the background, in turn with the
        other CPU runs; result read by cpu_result(name)."""
        prev = self.cpu_jobs[-1][1] if self.cpu_jobs else None
        holder = {}

        def job():
            if prev is not None:
                prev.join()
            try:
                holder["out"] = self.kids.kreeq(args, cpu=True)[0]
            except BaseException as exc:
                holder["error"] = exc

        t = threading.Thread(target=job, daemon=True)
        t.holder = holder
        t.start()
        self.cpu_jobs.append((name, t))

    def cpu_result(self, name):
        t = dict(self.cpu_jobs)[name]
        t.join(max(self.t0 + DEADLINE_S - time.monotonic(), 1))
        check(not t.is_alive(), f"CPU run {name}: out of time")
        if "error" in t.holder:
            raise t.holder["error"]
        return t.holder["out"]

    # -- one card ------------------------------------------------------

    def run_one_card(self):
        kq = self.kids.kreeq
        out, dt, peaks = kq(["validate", "-r", "r1.fq", "r2.fq", "-o",
                             "all.kreeq"])
        ref = self.reference()
        db = read_db(self.path("all.kreeq"))
        self.phase_line("build", dt, peaks, check_build(db, ref))

        qv_args = ["validate", "-f", "asm.fa", "-d", "all.kreeq"]
        vcf_args = ["validate", "-f", "one.fa", "-d", "all.kreeq", "-o"]
        sub_args = ["subgraph", "-d", "all.kreeq", "-f", "slice.fa", "-o"]
        tuned_args = vcf_args[:1] + TUNED + vcf_args[1:]
        self.start_cpu("qv", qv_args)
        self.start_cpu("default", vcf_args + ["cpu.default.vcf"])
        self.start_cpu("tuned", tuned_args + ["cpu.tuned.vcf"])
        for alg in ("traversal", "best-first"):
            self.start_cpu(alg, sub_args + [f"cpu.{alg}.gfa",
                                            "--traversal-algorithm", alg])

        qv_out, dt, peaks = kq(qv_args)
        self.phase_line("QV", dt, peaks, check_qv(qv_out, ref))

        out, dt, peaks = kq(qv_args + ["-o", "out.bkwig"])
        check_qv(out, ref)
        detail_t, dt_l = self.check_tracks(ref)
        self.phase_line("tracks", dt + dt_l, peaks, detail_t)

        dts, pk = [], []
        for name in ("r1", "r2"):
            _o, d, p = kq(["validate", "-r", f"{name}.fq", "-o",
                           f"{name}.kreeq"])
            dts.append(d)
            pk.append(p)
        _o, d, p = kq(["union", "-d", "r1.kreeq", "r2.kreeq", "-o",
                       "union.kreeq"])
        dts.append(d)
        pk.append(p)
        union = read_db(self.path("union.kreeq"))
        for name in ("keys", "cov", "fw", "bw"):
            check(np.array_equal(getattr(union, name), getattr(db, name)),
                  f"union {name} differ from all.kreeq")
        self.phase_line("union", sum(dts), max_peaks(pk),
                        f"r1+r2 builds {dts[0]:.1f}+{dts[1]:.1f} s, "
                        f"union {dts[2]:.1f} s; {len(union.keys)} rows "
                        "equal all.kreeq key for key")
        del union

        for name, args, label in (("default", vcf_args, "variants"),
                                  ("tuned", tuned_args, "variants "
                                   + " ".join(TUNED))):
            vcf = f"gpu.{name}.vcf"
            out, dt, peaks = kq(args + [vcf])
            cpu_out = self.cpu_result(name)
            check(out == cpu_out, f"{label}: stdout differs from the CPU run")
            check(same_file(self.path(vcf), self.path(f"cpu.{name}.vcf")),
                  f"{label}: VCF differs from the CPU run")
            self.phase_line(label, dt, peaks, "VCF byte-identical to "
                            f"CPU; {self.recall(vcf)}")

        for alg in ("traversal", "best-first"):
            out, dt, peaks = kq(sub_args + [f"gpu.{alg}.gfa",
                                            "--traversal-algorithm", alg])
            cpu_out = self.cpu_result(alg)
            check(out == cpu_out, f"subgraph {alg} stdout differs from CPU")
            gfa = self.path(f"gpu.{alg}.gfa")
            check(same_file(gfa, self.path(f"cpu.{alg}.gfa")),
                  f"subgraph {alg} GFA differs from the CPU run")
            self.phase_line(f"subgraph {alg}", dt, peaks,
                            f"GFA byte-identical to CPU "
                            f"({os.path.getsize(gfa)} bytes)")

        cpu_qv = self.cpu_result("qv")
        check(qv_out == cpu_qv, "QV report differs from the CPU run:\n"
              f"{qv_out[-600:]}\n---\n{cpu_qv[-600:]}")
        self.say("phase QV: report (Merqury and Kreeq lines) identical "
                 "to the CPU run")

    def check_tracks(self, ref):
        rng = np.random.default_rng([self.args.seed, 2])
        regions = []
        for _ in range(REGIONS):
            ci = int(rng.integers(0, len(self.contigs)))
            ln = len(self.contigs[ci][1])
            span = min(REGION_LEN, ln // 2)
            b = int(rng.integers(2, ln - span))
            regions.append((ci, b, b + span))
        argv = [sys.executable, DECOMPRESSOR, "lookup", "-i", "out.bkwig"]
        argv += [f"ctg{ci}:{b}-{e}" for ci, b, e in regions]
        out, _err, dt = self.kids.run(argv, cpu=True)
        blocks = parse_lookup(out)
        for ci, b, e in regions:
            got = blocks.get((f"ctg{ci}", b, e))
            check(got is not None, f"no lookup output for ctg{ci}:{b}-{e}")
            want = ref.track(ci)[b - 1:e - 1]
            check(np.array_equal(got, want),
                  f"ctg{ci}:{b}-{e} coverage differs from the reference")
        return (f"{len(regions)} regions x {REGION_LEN} bp per-base "
                f"coverage exact (lookup {dt:.1f} s)"), dt

    def recall(self, vcf):
        """Records, and planted substitutions of contig 0 called exactly:
        at their position, REF the assembly's base, ALT the genome's."""
        calls, n = set(), 0
        with open(self.path(vcf)) as fh:
            for line in fh:
                if not line.startswith("#"):
                    f = line.split("\t")
                    calls.add((f[0], int(f[1]), f[3], f[4]))
                    n += 1
        planted = [("ctg0", pos + 1, chr(BASES[alt]), chr(BASES[g]))
                   for ci, pos, g, alt in self.planted if ci == 0]
        hit = sum(p in calls for p in planted)
        return (f"{n} records, recall of planted substitutions "
                f"{hit}/{len(planted)}")

    # -- four cards ----------------------------------------------------

    def run_four_cards(self):
        kq = self.kids.kreeq
        build = ["validate", "-r", "r1.fq", "r2.fq", "-o"]
        out, dt, peaks = kq(build + ["all4.kreeq"])
        ref = self.reference()
        db4 = read_db(self.path("all4.kreeq"))
        self.phase_line("build (4 cards)", dt, peaks, check_build(db4, ref))
        qv_args = ["validate", "-f", "asm.fa", "-d"]
        qv4, dt, peaks = kq(qv_args + ["all4.kreeq"])
        self.phase_line("QV (4 cards)", dt, peaks, check_qv(qv4, ref))

        out, dt, peaks = kq(build + ["all1.kreeq"], cards=1)
        db1 = read_db(self.path("all1.kreeq"))
        for name in ("keys", "cov", "fw", "bw"):
            check(np.array_equal(getattr(db4, name), getattr(db1, name)),
                  f"4-card table {name} differs from the 1-card table")
        self.phase_line("build (1 card)", dt, peaks,
                        f"{len(db1.keys)} rows equal the 4-card table")
        qv1, dt, peaks = kq(qv_args + ["all1.kreeq"], cards=1)
        check(qv1 == qv4, "4-card QV report differs from the 1-card one")
        self.phase_line("QV (1 card)", dt, peaks,
                        "report identical to the 4-card run")

    def run(self):
        self.say(f"card: {card_line()}")
        dev = self.device()
        from kreeq_tpu import native

        lib = native.get_lib()
        self.say("native C++ ingest: " + ("loaded" if lib is not None else
                                          "not loaded (Python fallback)"))
        t = time.perf_counter()
        self.data()
        self.say(f"data written in {time.perf_counter() - t:.1f} s to "
                 f"{self.work}")
        self.start_reference()
        if self.args.cards == 4:
            self.run_four_cards()
        else:
            self.run_one_card()
        self.say(f"all phases passed in {time.monotonic() - self.t0:.1f} s")
        return dev


def max_peaks(peaks):
    valid = [p for p in peaks if p and p[0] is not None]
    if not valid:
        return None
    return [max(col) for col in zip(*valid)]


def same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "not available (no nvidia-smi)"


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--run-cli":
        return run_cli(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--probe":
        return probe_device()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    # the largest size whose cold run fits DEADLINE_S with margin on
    # one H100 (PERF.md)
    ap.add_argument("--genome-mbp", type=float, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="data and outputs (default: a fresh .smoke-* "
                         "directory beside this script, removed at the "
                         "end)")
    args = ap.parse_args()
    # this process reads DBs with numpy only and never opens the card
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, HERE)
    smoke = Smoke(args)
    try:
        dev = smoke.run()
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr, flush=True)
        return 1
    finally:
        smoke.kids.stop_all()
        if args.workdir is None:
            shutil.rmtree(smoke.work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
