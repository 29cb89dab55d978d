"""Placement compatibility of written .kreeq archives with phmap.

phmap_load restores ctrl/slots raw; the reference binary then probes
with H1/H2 of phmap_mix(std::hash(key)).  These tests simulate that
find() byte-for-byte (raw group loads over the serialized ctrl bytes,
triangular probing) and require every written key to be locatable —
first validating the simulator itself against the reference's own DB
dumps (ground truth: those load in the reference binary).
"""

import glob
import os
import struct

import numpy as np
import pytest

from kreeq_tpu.io.kreeqdb import (SLOT_U32, SLOT_U8, phmap_mix,
                                  phmap_subidx, read_kreeq, write_kreeq)

from .conftest import reference_available

REFERENCE = os.environ.get("KREEQ_REFERENCE", "/root/reference")


def iter_submaps(data: bytes, slot_size: int):
    off = 0
    (subcnt,) = struct.unpack_from("<Q", data, off)
    off += 8
    for s in range(subcnt):
        ver, size, cap = struct.unpack_from("<QQQ", data, off)
        off += 24
        if size == 0:
            continue
        ctrl = np.frombuffer(data[off:off + cap + 17], np.uint8)
        off += cap + 17
        slots = data[off:off + cap * slot_size]
        off += cap * slot_size + 8
        yield s, size, cap, ctrl, slots


def find_simulated(key: int, ctrl: np.ndarray, slots: bytes, cap: int,
                   slot_size: int) -> bool:
    """The reference's find() over raw serialized bytes: 16-byte group
    loads at the raw ctrl offset (clone bytes handle wrap), H2 match ->
    key compare, abort on any EMPTY in the group."""
    h = int(phmap_mix(np.array([key], np.uint64))[0])
    h1, h2 = h >> 7, h & 0x7F
    offset = h1 & cap
    index = 0
    for _ in range(cap + 16):
        group = ctrl[offset:offset + 16]  # raw load, never OOB (cap+17)
        for j in range(16):
            b = int(group[j])
            if b == h2:
                p = (offset + j) & cap
                (k2,) = struct.unpack_from("<Q", slots, p * slot_size)
                if k2 == key:
                    return True
            if b == 0x80:  # EMPTY anywhere in group => not present
                return False
        index += 16
        offset = (offset + index) & cap
    return False


def check_archive(path: str, slot_size: int) -> int:
    with open(path, "rb") as fh:
        data = fh.read()
    checked = 0
    for s, size, cap, ctrl, slots in iter_submaps(data, slot_size):
        stored = [i for i in range(cap) if ctrl[i] & 0x80 == 0]
        assert len(stored) == size
        for i in stored:
            (key,) = struct.unpack_from("<Q", slots, i * slot_size)
            h = int(phmap_mix(np.array([key], np.uint64))[0])
            assert int(phmap_subidx(np.array([h], np.uint64))[0]) == s, \
                f"key {key:#x} serialized into wrong submap {s}"
            assert find_simulated(key, ctrl, slots, cap, slot_size), \
                f"key {key:#x} not findable at submap {s} cap {cap}"
            checked += 1
        # clone bytes must mirror for raw group loads
        for i in stored:
            clone = ((i - 15) & cap) + (15 & cap)
            assert ctrl[clone] == ctrl[i]
    return checked


@pytest.mark.skipif(not reference_available(), reason="no reference corpus")
def test_simulator_against_reference_dumps():
    """Ground truth: the reference's own DBs load in its binary, so the
    simulator must locate every key in them."""
    total = 0
    for db in ("test1.kreeq", "test2.kreeq"):
        for path in glob.glob(
                os.path.join(REFERENCE, "testFiles", db, ".map.*.bin")):
            slot = SLOT_U32 if path.endswith(".hc.bin") else SLOT_U8
            total += check_archive(path, slot)
    assert total > 100


@pytest.mark.skipif(not reference_available(), reason="no reference corpus")
def test_written_db_is_probe_consistent(tmp_path):
    db = read_kreeq(os.path.join(REFERENCE, "testFiles", "test1.kreeq"))
    out = tmp_path / "w.kreeq"
    write_kreeq(str(out), db)
    total = 0
    for path in glob.glob(str(out / ".map.*.bin")):
        slot = SLOT_U32 if path.endswith(".hc.bin") else SLOT_U8
        total += check_archive(path, slot)
    assert total == len(db.keys)


def test_written_db_large_submaps_probe_consistent(tmp_path):
    """Force multi-group submaps (cap >= 31) so probing/wrap paths are
    exercised, not just single-group tables."""
    from kreeq_tpu.core.table import KmerTable

    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 1 << 42, 60000).astype(np.uint64))
    n = len(keys)
    cov = rng.integers(1, 300, n).astype(np.uint32)  # some overflow to hc
    fw = rng.integers(0, 5, (n, 4)).astype(np.uint32)
    bw = rng.integers(0, 5, (n, 4)).astype(np.uint32)
    table = KmerTable(21, np.sort(keys), cov, fw, bw)
    out = tmp_path / "big.kreeq"
    write_kreeq(str(out), table)
    total = 0
    for path in glob.glob(str(out / ".map.*.bin")):
        slot = SLOT_U32 if path.endswith(".hc.bin") else SLOT_U8
        total += check_archive(path, slot)
    # u8 entries (all n) + hc entries (overflowed records)
    n_hc = int((cov >= 255).sum())
    assert total == n + n_hc
    rt = read_kreeq(str(out))
    np.testing.assert_array_equal(rt.keys, table.keys)
    np.testing.assert_array_equal(rt.cov, table.cov)


def test_python_fallback_placement_matches_native(tmp_path):
    from kreeq_tpu.io.kreeqdb import _place_python
    from kreeq_tpu.native import phmap_place

    rng = np.random.default_rng(3)
    hs = phmap_mix(rng.integers(0, 1 << 60, 500).astype(np.uint64))
    cap = 1023
    native = phmap_place(hs, cap)
    if native is None:
        pytest.skip("native library unavailable")
    np.testing.assert_array_equal(native, _place_python(hs, cap))
