// Native runtime pieces: sequence ingest and DB archive parsing.
//
// The reference's ingest path is C++ (gfalibs StreamObj + kcount,
// reference: src/input.cpp:188-308); this provides the device build's
// equivalent: FASTA/FASTQ (plain or gzip) -> 2-bit code arrays ready
// for device packing, and phmap binary-archive parsing for `.kreeq`
// databases.  Exposed with a plain C ABI for ctypes.

#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Parsed {
    std::vector<uint8_t> codes;     // concatenated per-sequence codes
    std::vector<uint64_t> offsets;  // start offset of each sequence
};

uint8_t code_table[256];

struct TableInit {
    TableInit() {
        memset(code_table, 4, sizeof(code_table));
        const char *bases = "ACGT";
        for (int i = 0; i < 4; ++i) {
            code_table[(unsigned char)bases[i]] = i;
            code_table[(unsigned char)(bases[i] + 32)] = i;
        }
    }
} table_init;

}  // namespace

extern "C" {

// Parse a FASTA/FASTQ file (gzip-transparent).  Returns an opaque
// handle; query sizes/pointers with the accessors below.
void *kn_parse_fastx(const char *path) {
    gzFile fh = gzopen(path, "rb");
    if (!fh) return nullptr;
    gzbuffer(fh, 1 << 20);

    Parsed *out = new Parsed();
    out->codes.reserve(1 << 20);

    std::vector<char> line(1 << 16);
    int first = gzgetc(fh);
    if (first < 0) {
        gzclose(fh);
        return out;  // empty file
    }
    bool fastq = (first == '@');
    gzungetc(first, fh);

    int state = 0;  // FASTA: 0=want header, 1=sequence
                    // FASTQ line cycle: 0 header, 1 seq, 2 plus, 3 qual
    bool line_start = true;  // long lines span several gzgets chunks
    while (gzgets(fh, line.data(), (int)line.size())) {
        size_t len = strlen(line.data());
        bool eol = len > 0 && line[len - 1] == '\n';
        while (len > 0 && (line[len - 1] == '\n' || line[len - 1] == '\r'))
            --len;
        if (fastq) {
            if (state == 0) {
                if (line_start) out->offsets.push_back(out->codes.size());
            } else if (state == 1) {
                size_t base = out->codes.size();
                out->codes.resize(base + len);
                for (size_t i = 0; i < len; ++i)
                    out->codes[base + i] =
                        code_table[(unsigned char)line[i]];
            }
            if (eol) state = (state + 1) & 3;
        } else {
            if (len > 0 && line[0] == '>' && state != 2 && line_start) {
                out->offsets.push_back(out->codes.size());
                state = eol ? 1 : 2;  // 2 = skipping long header
            } else if (state == 2) {
                if (eol) state = 1;  // rest of a long header line
            } else if (state == 1) {
                size_t base = out->codes.size();
                out->codes.resize(base + len);
                for (size_t i = 0; i < len; ++i)
                    out->codes[base + i] =
                        code_table[(unsigned char)line[i]];
            }
        }
        line_start = eol;
    }
    gzclose(fh);
    return out;
}

uint64_t kn_num_seqs(void *h) { return ((Parsed *)h)->offsets.size(); }
uint64_t kn_num_codes(void *h) { return ((Parsed *)h)->codes.size(); }
const uint8_t *kn_codes(void *h) { return ((Parsed *)h)->codes.data(); }
const uint64_t *kn_offsets(void *h) {
    return ((Parsed *)h)->offsets.data();
}
void kn_free(void *h) { delete (Parsed *)h; }

// ---------------------------------------------------------------------
// phmap binary-archive parsing (layout documented in
// kreeq_tpu/io/kreeqdb.py; validated against testFiles/test1.kreeq).

struct PhmapParsed {
    std::vector<uint64_t> keys;
    std::vector<uint32_t> vals;  // 9 per key: fw[4], bw[4], cov
};

static const uint64_t kPhmapVersion = 0xFFFFFFFFFFFFFFF5ULL;

void *kn_parse_phmap(const uint8_t *data, uint64_t size, int wide) {
    // wide=0: u8 records (slot 24B); wide=1: u32 records (slot 48B)
    const uint64_t slot = wide ? 48 : 24;
    uint64_t off = 0;
    if (size < 8) return nullptr;
    uint64_t subcnt;
    memcpy(&subcnt, data, 8);
    off = 8;
    PhmapParsed *out = new PhmapParsed();
    for (uint64_t s = 0; s < subcnt; ++s) {
        if (off + 24 > size) { delete out; return nullptr; }
        uint64_t ver, cnt, cap;
        memcpy(&ver, data + off, 8);
        memcpy(&cnt, data + off + 8, 8);
        memcpy(&cap, data + off + 16, 8);
        off += 24;
        if (ver != kPhmapVersion) { delete out; return nullptr; }
        if (cnt == 0) continue;
        uint64_t nctrl = cap + 17;
        if (off + nctrl + cap * slot + 8 > size) {
            delete out;
            return nullptr;
        }
        const uint8_t *ctrl = data + off;
        const uint8_t *slots = data + off + nctrl;
        for (uint64_t i = 0; i < cap; ++i) {
            if (ctrl[i] & 0x80) continue;
            const uint8_t *rec = slots + i * slot;
            uint64_t key;
            memcpy(&key, rec, 8);
            out->keys.push_back(key);
            if (wide) {
                uint32_t v[9];
                memcpy(v, rec + 8, 36);
                out->vals.insert(out->vals.end(), v, v + 9);
            } else {
                for (int j = 0; j < 9; ++j)
                    out->vals.push_back(rec[8 + j]);
            }
        }
        off += nctrl + cap * slot + 8;
    }
    if (off != size) { delete out; return nullptr; }
    return out;
}

// SwissTable slot placement for phmap-compatible writes: replays
// find_first_non_full (group-of-16 triangular probing) so a table
// written with these positions is probe-consistent for the reference's
// own find() after phmap_load (raw ctrl/slot restore).  hs are the
// *mixed* hashes (phmap_mix of std::hash, computed by the caller); cap
// is 2^n - 1; pos_out receives the slot index of each key.  Returns 0
// on success, -1 if the table over-fills (caller sized cap wrong).
int kn_phmap_place(const uint64_t *hs, uint64_t n, uint64_t cap,
                   uint32_t *pos_out) {
    std::vector<uint8_t> ctrl(cap + 17, 0x80);  // kEmpty
    ctrl[cap] = 0xFF;                           // kSentinel
    for (uint64_t i = 0; i < n; ++i) {
        uint64_t h1 = hs[i] >> 7;
        uint64_t offset = h1 & cap, index = 0;
        int64_t found = -1;
        for (uint64_t probes = 0; probes <= cap && found < 0;
             probes += 16) {
            for (uint64_t j = 0; j < 16; ++j) {
                uint64_t p = (offset + j) & cap;
                if (ctrl[p] == 0x80) {
                    found = (int64_t)p;
                    break;
                }
            }
            index += 16;
            offset = (offset + index) & cap;
        }
        if (found < 0) return -1;
        ctrl[found] = (uint8_t)(hs[i] & 0x7F);
        pos_out[i] = (uint32_t)found;
    }
    return 0;
}

uint64_t kn_phmap_count(void *h) { return ((PhmapParsed *)h)->keys.size(); }
const uint64_t *kn_phmap_keys(void *h) {
    return ((PhmapParsed *)h)->keys.data();
}
const uint32_t *kn_phmap_vals(void *h) {
    return ((PhmapParsed *)h)->vals.data();
}
void kn_phmap_free(void *h) { delete (PhmapParsed *)h; }

}  // extern "C"
