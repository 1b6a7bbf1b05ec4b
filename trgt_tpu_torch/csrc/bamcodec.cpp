// Native BGZF/BAM codec for the host I/O pipeline.
//
// Replaces the role htslib's C code plays in the reference (BAM/BGZF
// encode/decode; ref: rust-htslib usage at src/commands/genotype.rs:46,
// src/trgt/writers/write_bam.rs:37) without depending on htslib itself:
// a small zlib-based implementation of the BGZF framing from SAM spec
// §4.1 plus BAM record field decoding, exposed through a C ABI consumed
// via ctypes (trgt_tpu/io/native.py).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <utility>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------- memory helpers ----------------

void trgt_buf_free(uint8_t *p) { free(p); }

// ---------------- BGZF decode ----------------

// Find BSIZE in the gzip FEXTRA field. Returns total block size or -1.
static int64_t block_size_at(const uint8_t *p, size_t avail) {
    if (avail < 18) return -1;
    if (p[0] != 0x1f || p[1] != 0x8b || p[2] != 8 || !(p[3] & 4)) return -1;
    uint16_t xlen = p[10] | (p[11] << 8);
    size_t pos = 12, end = 12 + xlen;
    if (end > avail) return -1;
    while (pos + 4 <= end) {
        uint8_t si1 = p[pos], si2 = p[pos + 1];
        uint16_t slen = p[pos + 2] | (p[pos + 3] << 8);
        if (si1 == 66 && si2 == 67 && slen == 2) {
            uint16_t bsize = p[pos + 4] | (p[pos + 5] << 8);
            return (int64_t)bsize + 1;
        }
        pos += 4 + slen;
    }
    return -1;
}

// Decompress a concatenation of BGZF blocks. Returns 0 on success.
int trgt_bgzf_decompress(const uint8_t *comp, size_t comp_size,
                         uint8_t **out, size_t *out_size) {
    std::vector<uint8_t> result;
    result.reserve(comp_size * 3);
    size_t pos = 0;
    while (pos + 28 <= comp_size) {
        int64_t bsize = block_size_at(comp + pos, comp_size - pos);
        if (bsize < 0) return -1;
        if (pos + bsize > comp_size) return -2;
        uint16_t xlen = comp[pos + 10] | (comp[pos + 11] << 8);
        const uint8_t *cdata = comp + pos + 12 + xlen;
        size_t cdata_len = bsize - 12 - xlen - 8;
        uint32_t isize;
        memcpy(&isize, comp + pos + bsize - 4, 4);
        size_t off = result.size();
        result.resize(off + isize);
        if (isize > 0) {
            z_stream zs;
            memset(&zs, 0, sizeof(zs));
            if (inflateInit2(&zs, -15) != Z_OK) return -3;
            zs.next_in = const_cast<uint8_t *>(cdata);
            zs.avail_in = (uInt)cdata_len;
            zs.next_out = result.data() + off;
            zs.avail_out = isize;
            int ret = inflate(&zs, Z_FINISH);
            inflateEnd(&zs);
            if (ret != Z_STREAM_END) return -4;
        }
        pos += bsize;
    }
    *out = (uint8_t *)malloc(result.size() ? result.size() : 1);
    memcpy(*out, result.data(), result.size());
    *out_size = result.size();
    return 0;
}

// Read + decompress an entire BGZF file.
int trgt_bgzf_read_file(const char *path, uint8_t **out, size_t *out_size) {
    FILE *fp = fopen(path, "rb");
    if (!fp) return -1;
    fseek(fp, 0, SEEK_END);
    long size = ftell(fp);
    fseek(fp, 0, SEEK_SET);
    std::vector<uint8_t> comp(size);
    if (fread(comp.data(), 1, size, fp) != (size_t)size) {
        fclose(fp);
        return -2;
    }
    fclose(fp);
    return trgt_bgzf_decompress(comp.data(), size, out, out_size);
}

// ---------------- BGZF encode ----------------

// Compress data into BGZF blocks (max 65280 bytes payload per block),
// appending the 28-byte EOF marker when add_eof != 0.
int trgt_bgzf_compress(const uint8_t *data, size_t size, int level,
                       int add_eof, uint8_t **out, size_t *out_size) {
    static const uint8_t EOF_BLOCK[28] = {
        0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff,
        0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
        0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00};
    const size_t MAX_BLOCK = 65280;
    std::vector<uint8_t> result;
    result.reserve(size / 2 + 64);
    size_t pos = 0;
    while (pos < size || (size == 0 && pos == 0)) {
        size_t chunk = size - pos < MAX_BLOCK ? size - pos : MAX_BLOCK;
        // deflate raw
        uLong bound = compressBound(chunk) + 64;
        std::vector<uint8_t> cdata(bound);
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                         Z_DEFAULT_STRATEGY) != Z_OK)
            return -1;
        zs.next_in = const_cast<uint8_t *>(data + pos);
        zs.avail_in = (uInt)chunk;
        zs.next_out = cdata.data();
        zs.avail_out = (uInt)bound;
        int ret = deflate(&zs, Z_FINISH);
        size_t clen = bound - zs.avail_out;
        deflateEnd(&zs);
        if (ret != Z_STREAM_END) return -2;

        uint32_t crc = crc32(0L, Z_NULL, 0);
        crc = crc32(crc, data + pos, (uInt)chunk);
        uint32_t bsize = (uint32_t)(clen + 26);
        size_t off = result.size();
        result.resize(off + bsize);
        uint8_t *b = result.data() + off;
        const uint8_t header[12] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0,
                                    0,    0xff, 6, 0};
        memcpy(b, header, 12);
        b[12] = 66; b[13] = 67; b[14] = 2; b[15] = 0;
        uint16_t bs16 = (uint16_t)(bsize - 1);
        memcpy(b + 16, &bs16, 2);
        memcpy(b + 18, cdata.data(), clen);
        memcpy(b + 18 + clen, &crc, 4);
        uint32_t isize = (uint32_t)chunk;
        memcpy(b + 22 + clen, &isize, 4);
        pos += chunk;
        if (size == 0) break;
    }
    if (add_eof) {
        size_t off = result.size();
        result.resize(off + 28);
        memcpy(result.data() + off, EOF_BLOCK, 28);
    }
    *out = (uint8_t *)malloc(result.size() ? result.size() : 1);
    memcpy(*out, result.data(), result.size());
    *out_size = result.size();
    return 0;
}

// ---------------- BAM record decode ----------------

static const char SEQ_NT16[17] = "=ACMGRSVTWYHKDBN";

// Decode 4-bit packed sequence to ASCII.
void trgt_decode_seq(const uint8_t *packed, int32_t l_seq, char *out) {
    for (int32_t i = 0; i < l_seq; i++) {
        uint8_t b = packed[i >> 1];
        out[i] = SEQ_NT16[(i & 1) ? (b & 0xF) : (b >> 4)];
    }
}

// ---------------- batched read extraction ----------------
//
// Fused fetch → filter → decode → MM/ML methylation → SNP offsets →
// region clip, mirroring the Python twin (trgt_tpu/engine/workflow.py
// extract_reads + trgt_tpu/reads/{hifi_read,clip}.py; reference logic at
// src/trgt/workflows/tr.rs:268-361, src/trgt/reads/read.rs:101-141,
// clip_region.rs:19-190, snp.rs:51-78). One call per locus, over the
// records its block-addressed walk gathered (trgt_reader_extract below);
// serialized records are deserialized into HiFiRead on the Python side.

namespace {

struct Blob {
    std::vector<uint8_t> v;
    void u8(uint8_t x) { v.push_back(x); }
    void u16(uint16_t x) { raw(&x, 2); }
    void i32(int32_t x) { raw(&x, 4); }
    void u32(uint32_t x) { raw(&x, 4); }
    void i64(int64_t x) { raw(&x, 8); }
    void f32(float x) { raw(&x, 4); }
    void raw(const void *p, size_t n) {
        const uint8_t *b = (const uint8_t *)p;
        v.insert(v.end(), b, b + n);
    }
};

// op consumes reference: M(0) D(2) N(3) =(7) X(8)
inline bool op_ref(uint32_t op) {
    return op == 0 || op == 2 || op == 3 || op == 7 || op == 8;
}
// op consumes query: M(0) I(1) S(4) =(7) X(8)
inline bool op_query(uint32_t op) {
    return op == 0 || op == 1 || op == 4 || op == 7 || op == 8;
}

struct AuxVal {
    bool found = false;
    char typ = 0;
    const uint8_t *p = nullptr;   // payload start
    size_t len = 0;               // payload length (Z: excl. NUL)
    char sub = 0;                 // B subtype
    uint32_t count = 0;           // B count
};

// Walk the aux region looking for a 2-char tag. Returns found=false on
// miss or malformed data.
AuxVal find_aux(const uint8_t *aux, size_t n, const char tag[2]) {
    AuxVal out;
    size_t pos = 0;
    while (pos + 3 <= n) {
        const uint8_t *t = aux + pos;
        char typ = (char)aux[pos + 2];
        pos += 3;
        size_t len = 0;
        switch (typ) {
            case 'A': case 'c': case 'C': len = 1; break;
            case 's': case 'S': len = 2; break;
            case 'i': case 'I': case 'f': len = 4; break;
            case 'Z': case 'H': {
                size_t e = pos;
                while (e < n && aux[e]) e++;
                len = e - pos;
                if (t[0] == tag[0] && t[1] == tag[1]) {
                    out.found = true; out.typ = typ;
                    out.p = aux + pos; out.len = len;
                    return out;
                }
                pos = e + 1;
                continue;
            }
            case 'B': {
                if (pos + 5 > n) return out;
                char sub = (char)aux[pos];
                uint32_t count;
                memcpy(&count, aux + pos + 1, 4);
                size_t esz = (sub == 'c' || sub == 'C') ? 1
                           : (sub == 's' || sub == 'S') ? 2 : 4;
                if (t[0] == tag[0] && t[1] == tag[1]) {
                    out.found = true; out.typ = 'B'; out.sub = sub;
                    out.count = count; out.p = aux + pos + 5;
                    out.len = (size_t)count * esz;
                    return out;
                }
                pos += 5 + (size_t)count * esz;
                continue;
            }
            default: return out;  // unknown type: stop scanning
        }
        if (t[0] == tag[0] && t[1] == tag[1]) {
            out.found = true; out.typ = typ; out.p = aux + pos;
            out.len = len;
            return out;
        }
        pos += len;
    }
    return out;
}

inline int64_t aux_int(const AuxVal &a) {
    switch (a.typ) {
        case 'c': return *(const int8_t *)a.p;
        case 'C': return *(const uint8_t *)a.p;
        case 's': { int16_t v; memcpy(&v, a.p, 2); return v; }
        case 'S': { uint16_t v; memcpy(&v, a.p, 2); return v; }
        case 'i': { int32_t v; memcpy(&v, a.p, 4); return v; }
        case 'I': { uint32_t v; memcpy(&v, a.p, 4); return v; }
    }
    return INT64_MIN;
}

inline int64_t b_elem(const AuxVal &a, uint32_t i) {
    switch (a.sub) {
        case 'c': return ((const int8_t *)a.p)[i];
        case 'C': return ((const uint8_t *)a.p)[i];
        case 's': { int16_t v; memcpy(&v, a.p + 2 * i, 2); return v; }
        case 'S': { uint16_t v; memcpy(&v, a.p + 2 * i, 2); return v; }
        case 'i': { int32_t v; memcpy(&v, a.p + 4 * i, 4); return v; }
        case 'I': { uint32_t v; memcpy(&v, a.p + 4 * i, 4); return v; }
        case 'f': { float v; memcpy(&v, a.p + 4 * i, 4); return (int64_t)v; }
    }
    return 0;
}

inline char complement(char c) {
    switch (c) {
        case 'A': return 'T'; case 'C': return 'G';
        case 'G': return 'C'; case 'T': return 'A';
        case 'U': return 'A'; default: return 'N';
    }
}

// MM/ML → per-CpG meth profile; mirrors trgt_tpu/reads/hifi_read.py
// (_mods_from_mm_ml + extract_meth). Returns true if profile present
// (meth filled), false for "None".
bool decode_meth(const AuxVal &mm, const AuxVal &ml, const char *bases,
                 int32_t l_seq, bool reverse, std::vector<uint8_t> &meth) {
    if (!mm.found || mm.typ != 'Z' || mm.len == 0) return false;
    // mods: (stored_pos, canonical, qual) — only C mods are projected
    std::vector<std::pair<int32_t, int32_t>> cmods;  // (pos, qual)
    size_t ml_index = 0;
    bool ok = false, any_out = false;
    const char *s = (const char *)mm.p;
    size_t n = mm.len;
    while (n > 0 && s[n - 1] == ';') n--;
    size_t item_beg = 0;
    std::vector<int32_t> canon_positions;
    for (size_t i = 0; i <= n; i++) {
        if (i < n && s[i] != ';') continue;
        size_t item_end = i;
        if (item_end > item_beg) {
            // head = up to first ','
            size_t head_end = item_beg;
            while (head_end < item_end && s[head_end] != ',') head_end++;
            size_t hl = head_end - item_beg;
            const char *h = s + item_beg;
            // ^([ACGTUN])([-+])([a-zA-Z]+|[0-9]+)([.?]?)$
            if (hl < 3) return false;
            char canonical = h[0];
            if (!strchr("ACGTUN", canonical)) return false;
            if (h[1] != '+' && h[1] != '-') return false;
            size_t mod_beg = 2, mod_end = hl;
            if (h[hl - 1] == '.' || h[hl - 1] == '?') mod_end = hl - 1;
            if (mod_end <= mod_beg) return false;
            bool alldig = true, allalpha = true;
            for (size_t k = mod_beg; k < mod_end; k++) {
                if (!isdigit((unsigned char)h[k])) alldig = false;
                if (!isalpha((unsigned char)h[k])) allalpha = false;
            }
            if (!alldig && !allalpha) return false;
            size_t n_mods = alldig ? 1 : (mod_end - mod_beg);
            // canonical-base positions in ORIGINAL read orientation
            canon_positions.clear();
            if (reverse) {
                char comp = complement(canonical);
                for (int32_t k = 0; k < l_seq; k++)
                    if (bases[l_seq - 1 - k] == comp)
                        canon_positions.push_back(k);
            } else {
                for (int32_t k = 0; k < l_seq; k++)
                    if (bases[k] == canonical || canonical == 'N')
                        canon_positions.push_back(k);
            }
            // deltas
            int64_t idx = -1;
            size_t p = head_end;
            while (p < item_end) {
                p++;  // skip ','
                int64_t delta = 0;
                bool got = false;
                while (p < item_end && isdigit((unsigned char)s[p])) {
                    delta = delta * 10 + (s[p] - '0');
                    p++; got = true;
                }
                if (!got) return false;
                idx += delta + 1;
                if (idx >= (int64_t)canon_positions.size()) break;
                int32_t orig = canon_positions[idx];
                int32_t stored = reverse ? (l_seq - 1 - orig) : orig;
                for (size_t m = 0; m < n_mods; m++) {
                    int64_t qual = (ml.found && ml_index < ml.count)
                                       ? b_elem(ml, (uint32_t)ml_index) : 0;
                    ml_index++;
                    if (canonical == 'C')
                        cmods.push_back({stored, (int32_t)qual});
                    any_out = true;
                }
                ok = true;
            }
        }
        item_beg = i + 1;
    }
    (void)ok; (void)any_out;  // empty mods → projection yields None below
    // CpG sites of the stored sequence
    std::vector<int32_t> cpg_idx;  // projection target per profile slot
    for (int32_t k = 0; k + 1 < l_seq; k++)
        if (bases[k] == 'C' && bases[k + 1] == 'G')
            cpg_idx.push_back(k + (reverse ? 1 : 0));
    size_t num_cpgs = cpg_idx.size();
    std::vector<uint8_t> ans(num_cpgs, 0);
    std::sort(cmods.begin(), cmods.end());
    size_t ind = 0;
    for (auto &pq : cmods) {
        while (ind < num_cpgs && cpg_idx[ind] < pq.first) ind++;
        if (ind < num_cpgs && pq.first == cpg_idx[ind]) {
            ans[ind] = (uint8_t)pq.second;
            ind++;
        }
    }
    if (ind == 0) return false;
    if (reverse) std::reverse(ans.begin(), ans.end());
    meth = std::move(ans);
    return true;
}

}  // namespace

// Extract + clip reads from a decompressed BAM buffer walk.
//
// buf[start..walk_end): record stream. Filters: tid/pos window
// [beg, end), unmapped / secondary / supplementary flags, rq >= min_rq.
// region_{start,end}: locus region (offset + SNP bookkeeping);
// clip_{lo,hi}: clip window (region ± 2×flank). n_pass counts reads
// passing flag+rq filters (reservoir total); n_filt counts rq-filtered.
// Serialized format (little-endian) per record — see Python
// deserializer trgt_tpu/reads/native_extract.py.
int trgt_extract_reads(const uint8_t *buf, size_t size, size_t start,
                       size_t walk_end, int32_t tid, int32_t beg,
                       int32_t end, int32_t region_start,
                       int32_t region_end, int32_t clip_lo,
                       int32_t clip_hi, double min_rq, uint8_t **out,
                       size_t *out_size, int64_t *n_pass,
                       int64_t *n_filt) {
    Blob blob;
    *n_pass = 0;
    *n_filt = 0;
    if (walk_end > size) walk_end = size;
    size_t pos = start;
    std::vector<char> seq;
    std::vector<uint8_t> meth;
    std::vector<uint32_t> clipped_ops;
    std::vector<int32_t> mism;
    while (pos + 4 <= size && pos < walk_end) {
        int32_t block_size;
        memcpy(&block_size, buf + pos, 4);
        if (block_size < 32 || pos + 4 + (size_t)block_size > size)
            return -1;
        const uint8_t *rec = buf + pos + 4;
        pos += 4 + block_size;
        int32_t ref_id, rpos;
        memcpy(&ref_id, rec, 4);
        memcpy(&rpos, rec + 4, 4);
        uint8_t l_read_name = rec[8];
        uint8_t mapq = rec[9];
        uint16_t n_cigar, flag;
        memcpy(&n_cigar, rec + 12, 2);
        memcpy(&flag, rec + 14, 2);
        int32_t l_seq;
        memcpy(&l_seq, rec + 16, 4);
        if (ref_id != tid || rpos >= end) break;
        if (flag & 0x4) continue;                    // unmapped
        const uint8_t *cig = rec + 32 + l_read_name;
        // reference end
        int64_t ref_end = rpos;
        for (uint16_t k = 0; k < n_cigar; k++) {
            uint32_t v;
            memcpy(&v, cig + 4 * k, 4);
            if (op_ref(v & 0xF)) ref_end += v >> 4;
        }
        if (ref_end <= beg) continue;                // no overlap
        if (flag & (0x100 | 0x800)) continue;        // secondary/suppl.
        const uint8_t *packed = cig + 4 * n_cigar;
        const uint8_t *quals = packed + (l_seq + 1) / 2;
        const uint8_t *aux = quals + l_seq;
        size_t aux_len = (rec + block_size) - aux;
        AuxVal rq = find_aux(aux, aux_len, "rq");
        float rq_val = 1.0f;
        bool has_rq = rq.found && rq.typ == 'f';
        if (has_rq) memcpy(&rq_val, rq.p, 4);
        // compare in double like the Python twin (float(rq) < min_rq)
        if ((double)(has_rq ? rq_val : 1.0f) < min_rq) {
            (*n_filt)++;
            continue;
        }
        (*n_pass)++;

        // ---- clip to [clip_lo, clip_hi) (clip_region.rs:105-190) ----
        // (clip window ⊇ fetch window, so overlap is guaranteed; keep
        // the serialized stream aligned with n_pass if it ever isn't)
        if (ref_end <= clip_lo || clip_hi <= rpos) { (*n_pass)--; continue; }
        int64_t ref_pos = rpos;
        int64_t query_pos = 0;
        clipped_ops.clear();
        uint32_t i = 0;
        auto opv = [&](uint32_t k) {
            uint32_t v; memcpy(&v, cig + 4 * k, 4); return v;
        };
        while (i < n_cigar) {
            uint32_t v = opv(i);
            int64_t rl = op_ref(v & 0xF) ? (v >> 4) : 0;
            if (ref_pos + rl > clip_lo) break;
            ref_pos += rl;
            if (op_query(v & 0xF)) query_pos += v >> 4;
            i++;
        }
        int64_t clipped_ref_start = ref_pos;
        int64_t clipped_query_start = query_pos;
        if (ref_pos < clip_lo && i < n_cigar) {
            uint32_t v = opv(i);
            uint32_t opc = v & 0xF;
            int64_t op_len = v >> 4;
            int64_t ref_outside = clip_lo - ref_pos;
            int64_t clipped_len = (ref_pos + op_len <= clip_hi)
                                      ? op_len - ref_outside
                                      : (int64_t)clip_hi - clip_lo;
            clipped_ops.push_back(((uint32_t)clipped_len << 4) | opc);
            clipped_ref_start += ref_outside;
            if (op_query(opc)) clipped_query_start += ref_outside;
            ref_pos += op_len;
            if (op_query(opc)) query_pos += op_len;
            i++;
        }
        while (i < n_cigar) {
            uint32_t v = opv(i);
            uint32_t opc = v & 0xF;
            int64_t rl = op_ref(opc) ? (v >> 4) : 0;
            if (ref_pos + rl > clip_hi) break;
            clipped_ops.push_back(v);
            ref_pos += rl;
            if (op_query(opc)) query_pos += v >> 4;
            i++;
        }
        if (i < n_cigar && ref_pos < clip_hi) {
            uint32_t v = opv(i);
            clipped_ops.push_back(
                ((uint32_t)(clip_hi - ref_pos) << 4) | (v & 0xF));
        }
        int64_t clip_q_len = 0;
        for (uint32_t cv : clipped_ops)
            if (op_query(cv & 0xF)) clip_q_len += cv >> 4;
        int64_t clipped_query_end = clipped_query_start + clip_q_len;

        // ---- decode full sequence (needed for meth + slicing) ----
        seq.resize(l_seq);
        for (int32_t k = 0; k < l_seq; k++) {
            uint8_t b = packed[k >> 1];
            seq[k] = SEQ_NT16[(k & 1) ? (b & 0xF) : (b >> 4)];
        }
        bool reverse = (flag & 0x10) != 0;

        // ---- methylation ----
        AuxVal mm = find_aux(aux, aux_len, "MM");
        if (!mm.found) mm = find_aux(aux, aux_len, "Mm");
        AuxVal ml = find_aux(aux, aux_len, "ML");
        if (!ml.found) ml = find_aux(aux, aux_len, "Ml");
        meth.clear();
        bool has_meth =
            decode_meth(mm, ml, seq.data(), l_seq, reverse, meth);
        // clip meth to [clipped_query_start, clipped_query_end)
        std::vector<uint8_t> meth_clip;
        if (has_meth) {
            size_t mi = 0;
            for (int32_t k = 0; k + 1 < l_seq; k++) {
                if (seq[k] == 'C' && seq[k + 1] == 'G') {
                    if (k >= clipped_query_start && k < clipped_query_end
                        && mi < meth.size())
                        meth_clip.push_back(meth[mi]);
                    mi++;
                }
            }
        }

        // ---- SNP mismatch offsets (full cigar, X ops outside region,
        //      region intersect INCLUSIVE both ends) ----
        mism.clear();
        {
            int64_t sref = rpos;
            for (uint16_t k = 0; k < n_cigar; k++) {
                uint32_t v = opv(k);
                uint32_t opc = v & 0xF;
                int64_t len = v >> 4;
                if (opc == 8 &&
                    !(region_start <= sref && sref <= region_end)) {
                    int64_t diff = (sref < region_start)
                                       ? sref - region_start
                                       : sref - region_end;
                    for (int64_t m = 0; m < len; m++)
                        mism.push_back((int32_t)(diff + m));
                }
                if (op_ref(opc)) sref += len;
            }
        }

        // ---- HP tag ----
        AuxVal hp = find_aux(aux, aux_len, "HP");
        int64_t hp_val = hp.found ? aux_int(hp) : INT64_MIN;

        // ---- serialize ----
        const char *qname = (const char *)(rec + 32);
        uint32_t qlen = l_read_name > 0 ? l_read_name - 1 : 0;
        blob.u32(qlen);
        blob.raw(qname, qlen);
        blob.u16(flag);
        blob.u8(mapq);
        blob.u8(has_rq ? 1 : 0);
        blob.f32(rq_val);
        blob.i32(hp_val == INT64_MIN ? INT32_MIN : (int32_t)hp_val);
        blob.i64(clipped_ref_start);
        blob.i32((int32_t)(rpos - region_start));       // start_offset
        blob.i32((int32_t)(ref_end - region_end));      // end_offset
        blob.u32((uint32_t)clip_q_len);
        blob.raw(seq.data() + clipped_query_start, clip_q_len);
        blob.raw(quals + clipped_query_start, clip_q_len);
        if (has_meth) {
            blob.i32((int32_t)meth_clip.size());
            blob.raw(meth_clip.data(), meth_clip.size());
        } else {
            blob.i32(-1);
        }
        blob.u32((uint32_t)clipped_ops.size());
        blob.raw(clipped_ops.data(), clipped_ops.size() * 4);
        blob.i32((int32_t)mism.size());
        blob.raw(mism.data(), mism.size() * 4);
    }
    *out = (uint8_t *)malloc(blob.v.size() ? blob.v.size() : 1);
    memcpy(*out, blob.v.data(), blob.v.size());
    *out_size = blob.v.size();
    return 0;
}

// Scan BAM records in a decompressed buffer starting at `offset`.
// For each record, write (offset, block_size, ref_id, pos, flag, mapq)
// into the int64 output table (6 columns). Returns record count, or -1.
int64_t trgt_bam_scan(const uint8_t *buf, size_t size, size_t offset,
                      int64_t *table, int64_t max_records) {
    int64_t count = 0;
    size_t pos = offset;
    while (pos + 4 <= size && count < max_records) {
        int32_t block_size;
        memcpy(&block_size, buf + pos, 4);
        if (block_size < 32 || pos + 4 + block_size > size) break;
        const uint8_t *rec = buf + pos + 4;
        int32_t ref_id, rpos;
        memcpy(&ref_id, rec, 4);
        memcpy(&rpos, rec + 4, 4);
        uint8_t mapq = rec[9];
        uint16_t flag;
        memcpy(&flag, rec + 14, 2);
        table[count * 6 + 0] = (int64_t)pos;
        table[count * 6 + 1] = block_size;
        table[count * 6 + 2] = ref_id;
        table[count * 6 + 3] = rpos;
        table[count * 6 + 4] = flag;
        table[count * 6 + 5] = mapq;
        count++;
        pos += 4 + block_size;
    }
    return count;
}

// ---------------- CRAM rANS4x8 decode ----------------
//
// Native fast path for the CRAM input stack (the reference reads CRAM
// through htslib's C rANS codec; ref: src/commands/genotype.rs:46).
// Mirrors trgt_tpu/io/cram.py rans_decode (spec section 13) exactly —
// including renormalization that stops at end-of-input — so the Python
// implementation stays the behavioural twin.

static const uint32_t RANS_LOW = 1u << 23;
static const uint32_t RANS_TF = 4096;  // TOTFREQ

struct RansCursor {
    const uint8_t *d;
    size_t pos, size;
    int ok;
    uint8_t u8() {
        if (pos >= size) { ok = 0; return 0; }
        return d[pos++];
    }
    int32_t i32() {
        if (pos + 4 > size) { ok = 0; return 0; }
        int32_t v;
        memcpy(&v, d + pos, 4);
        pos += 4;
        return v;
    }
};

// Frequency table for one context: freq[s], cumulative cum[s], and a
// 4096-entry slot→symbol lookup.
struct RansTable {
    uint16_t freq[256];
    uint16_t cum[256];
    uint8_t lookup[RANS_TF];
};

static int read_freq(RansCursor &c) {
    int f = c.u8();
    if (f >= 0x80) f = ((f & 0x7F) << 8) | c.u8();
    return f;
}

// RLE symbol stream step (spec 13.4): advance (j, rle) to the next
// symbol; returns 0 when the stream terminates.
static inline int rle_next(RansCursor &c, int &j, int &rle) {
    if (rle > 0) {
        rle--;
        j++;
        return 1;
    }
    int nxt = c.u8();
    if (nxt == j + 1) {
        j = nxt;
        rle = c.u8();
        return 1;
    }
    j = nxt;
    return j != 0;
}

static int read_table0(RansCursor &c, RansTable &t) {
    memset(t.freq, 0, sizeof(t.freq));
    memset(t.cum, 0, sizeof(t.cum));
    memset(t.lookup, 0, sizeof(t.lookup));
    int j = c.u8(), rle = 0;
    do {
        t.freq[j & 0xFF] = (uint16_t)read_freq(c);
    } while (c.ok && rle_next(c, j, rle));
    if (!c.ok) return 0;
    uint32_t acc = 0;
    for (int s = 0; s < 256; s++) {
        t.cum[s] = (uint16_t)acc;
        uint32_t hi = acc + t.freq[s];
        for (uint32_t i = acc; i < hi && i < RANS_TF; i++)
            t.lookup[i] = (uint8_t)s;
        acc = hi;
    }
    // a valid table's frequencies sum to exactly TOTFREQ (spec 13.3);
    // anything else leaves lookup slots unset (they would silently
    // decode as symbol 0) or overflows cum — reject as malformed, like
    // the Python twin's KeyError on an uncovered slot
    return acc == RANS_TF;
}

static inline void rans_advance(uint32_t &x, const RansTable &t, uint8_t s,
                                const uint8_t *d, size_t &pos, size_t size) {
    x = t.freq[s] * (x >> 12) + (x & (RANS_TF - 1)) - t.cum[s];
    while (x < RANS_LOW && pos < size) x = (x << 8) | d[pos++];
}

// Decode a rANS4x8 payload (orders 0 and 1). *out is malloc'd; caller
// frees with trgt_buf_free. Returns 0 on success.
int trgt_rans_decode(const uint8_t *data, size_t size,
                     uint8_t **out, size_t *out_size) {
    RansCursor c{data, 0, size, 1};
    int order = c.u8();
    (void)c.i32();  // compressed size
    int32_t osz = c.i32();
    if (!c.ok || osz < 0) return -1;
    uint8_t *o = (uint8_t *)malloc(osz ? osz : 1);
    if (!o) return -1;
    if (order == 0) {
        RansTable *t = new RansTable();
        if (!read_table0(c, *t)) { delete t; free(o); return -1; }
        uint32_t st[4];
        for (int i = 0; i < 4; i++) st[i] = (uint32_t)c.i32();
        if (!c.ok) { delete t; free(o); return -1; }
        size_t pos = c.pos;
        for (int32_t i = 0; i < osz; i++) {
            uint32_t &x = st[i & 3];
            uint8_t s = t->lookup[x & (RANS_TF - 1)];
            o[i] = s;
            rans_advance(x, *t, s, data, pos, size);
        }
        delete t;
    } else if (order == 1) {
        // per-context tables; contexts enumerated by an outer RLE.
        // Unlisted contexts stay invalid: decoding through one means the
        // stream is malformed (the Python twin's empty lookup dict
        // raises KeyError there), so fail instead of emitting garbage.
        RansTable *tabs = new RansTable[256];
        bool valid[256];
        for (int i = 0; i < 256; i++) {
            memset(tabs[i].freq, 0, sizeof(tabs[i].freq));
            memset(tabs[i].cum, 0, sizeof(tabs[i].cum));
            memset(tabs[i].lookup, 0, sizeof(tabs[i].lookup));
            valid[i] = false;
        }
        int j = c.u8(), rle = 0;
        do {
            if (!read_table0(c, tabs[j & 0xFF])) c.ok = 0;
            else valid[j & 0xFF] = true;
        } while (c.ok && rle_next(c, j, rle));
        if (!c.ok) { delete[] tabs; free(o); return -1; }
        uint32_t st[4];
        for (int i = 0; i < 4; i++) st[i] = (uint32_t)c.i32();
        if (!c.ok) { delete[] tabs; free(o); return -1; }
        size_t pos = c.pos;
        int32_t isz4 = osz >> 2;
        uint8_t ctx[4] = {0, 0, 0, 0};
        int64_t offs[4] = {0, isz4, 2 * (int64_t)isz4, 3 * (int64_t)isz4};
        int fail = 0;
        for (int32_t i = 0; i < isz4 && !fail; i++) {
            for (int j = 0; j < 4; j++) {
                if (!valid[ctx[j]]) { fail = 1; break; }
                uint32_t &x = st[j];
                const RansTable &t = tabs[ctx[j]];
                uint8_t s = t.lookup[x & (RANS_TF - 1)];
                o[offs[j] + i] = s;
                rans_advance(x, t, s, data, pos, size);
                ctx[j] = s;
            }
        }
        for (int32_t i = 4 * isz4; i < osz && !fail; i++) {
            if (!valid[ctx[3]]) { fail = 1; break; }
            uint32_t &x = st[3];
            const RansTable &t = tabs[ctx[3]];
            uint8_t s = t.lookup[x & (RANS_TF - 1)];
            o[i] = s;
            rans_advance(x, t, s, data, pos, size);
            ctx[3] = s;
        }
        delete[] tabs;
        if (fail) { free(o); return -1; }
    } else {
        free(o);
        return -1;
    }
    *out = o;
    *out_size = (size_t)osz;
    return 0;
}

// ---------------- banded affine alignment ----------------
//
// Native twin of trgt_tpu/kernels/align_banded.py (the O(n*s) analog
// of WFA2-lib's wavefronts for the consensus-repair workload, ref:
// src/utils/align.rs affine 2,5,1; src/wfaligner.rs:5-10). Exactly the
// same recurrences, band parametrization, optimality certificate, and
// tie-break rules as the Python implementation — the numpy twin stays
// the behavioural reference (tests/test_native_align.py fuzz-compares
// them), this is the speed path (the numpy version pays per-DP-row
// Python overhead, ~10k rows for expansion alleles).
//
// Band: diagonal offsets j-i in [min(0,T-P)-W, max(0,T-P)+W]; lane
// k = j - i - lo. Traceback bits per cell: HT (2 bits: 0=diag,1=E,2=F),
// ET, FT packed into one byte.

static const int64_t ALN_INF = (int64_t)1 << 40;

// rc: 0 = certified optimum (score/cigar exact vs the full DP),
//     1 = certificate failed (score_out = banded score upper bound),
//    -1 = allocation failure / bad args.
// ops_out receives CIGAR op chars ('=','X','I','D') in FORWARD order;
// ops_cap must be >= P + T. *ops_len is the op count.
int trgt_banded_align(const uint8_t *pat, int64_t P, const uint8_t *txt,
                      int64_t T, int64_t mism, int64_t gapo, int64_t gape,
                      int64_t tb, int64_t te, int64_t W,
                      int64_t *score_out, uint8_t *ops_out,
                      int64_t ops_cap, int64_t *ops_len) {
    if (P <= 0 || T <= 0 || gape <= 0 || ops_cap < P + T) return -1;
    const int64_t lo = (T - P < 0 ? T - P : 0) - W;
    const int64_t hi = (T - P > 0 ? T - P : 0) + W;
    const int64_t Wb = hi - lo + 1;
    int64_t *H_prev = (int64_t *)malloc(sizeof(int64_t) * Wb);
    int64_t *E_prev = (int64_t *)malloc(sizeof(int64_t) * Wb);
    int64_t *H_row = (int64_t *)malloc(sizeof(int64_t) * Wb);
    int64_t *E_row = (int64_t *)malloc(sizeof(int64_t) * Wb);
    uint8_t *tbk = (uint8_t *)malloc((size_t)(P + 1) * Wb);
    if (!H_prev || !E_prev || !H_row || !E_row || !tbk) {
        free(H_prev); free(E_prev); free(H_row); free(E_row); free(tbk);
        return -1;
    }
    // row 0: H[0,j] = gapo + gape*j ('I' run opened at column 1);
    // HT=2 for j>0, FT(extend)=1 for j>1 — matching the numpy twin
    for (int64_t k = 0; k < Wb; k++) {
        int64_t j = lo + k;
        uint8_t b = 0;
        if (j < 0 || j > T) {
            H_prev[k] = ALN_INF;
        } else if (j == 0) {
            H_prev[k] = 0;
        } else {
            H_prev[k] = gapo + gape * j;
            b = 2;                       // HT=F
            if (j > 1) b |= 8;           // FT=extend
        }
        E_prev[k] = ALN_INF;
        tbk[k] = b;
    }
    for (int64_t i = 1; i <= P; i++) {
        uint8_t *tb_row = tbk + (size_t)i * Wb;
        const int64_t pc = pat[i - 1];
        const int64_t k0 = -(i + lo);    // lane of column j == 0
        int64_t f_prev = ALN_INF;        // F[k-1]
        int64_t hnof_prev = ALN_INF;     // h_no_f[k-1]
        for (int64_t k = 0; k < Wb; k++) {
            const int64_t j = i + lo + k;
            uint8_t bits;
            int64_t E_k, H_k;
            if (j < 0 || j > T) {
                E_k = ALN_INF;
                H_k = ALN_INF;
                bits = 0;
                f_prev = ALN_INF;        // out-of-range: no F chain
                hnof_prev = ALN_INF;
            } else {
                // E: from (i-1, j) = lane k+1 of the previous row
                const int64_t H_up = (k + 1 < Wb) ? H_prev[k + 1]
                                                  : ALN_INF;
                const int64_t E_up = (k + 1 < Wb) ? E_prev[k + 1]
                                                  : ALN_INF;
                int64_t e_open = (H_up >= ALN_INF) ? ALN_INF
                                 : H_up + gapo + gape;
                int64_t e_ext = (E_up >= ALN_INF) ? ALN_INF
                                : E_up + gape;
                uint8_t et = (e_ext < e_open) ? 1 : 0;  // tie -> open
                E_k = et ? e_ext : e_open;
                if (k == k0) {           // origin-anchored run only
                    E_k = tb + gape * i;
                    et = (i > 1) ? 1 : 0;
                }
                // diagonal: (i-1, j-1) is the SAME lane k
                int64_t diag = ALN_INF;
                if (j >= 1 && H_prev[k] < ALN_INF)
                    diag = H_prev[k] + ((txt[j - 1] == pc) ? 0 : mism);
                int64_t h_no_f = diag < E_k ? diag : E_k;
                // F: within-row chain; openings use h_no_f (opening
                // from an F cell is never better than extending)
                int64_t f_open = (hnof_prev >= ALN_INF) ? ALN_INF
                                 : hnof_prev + gapo + gape;
                int64_t f_ext = (f_prev >= ALN_INF) ? ALN_INF
                                : f_prev + gape;
                int64_t F_k = f_open < f_ext ? f_open : f_ext;
                uint8_t ft = (F_k < f_open) ? 1 : 0;    // strict: extend
                // H: first minimum in [diag, E, F] order
                uint8_t ht;
                if (diag <= E_k && diag <= F_k) {
                    H_k = diag; ht = 0;
                } else if (E_k <= F_k) {
                    H_k = E_k; ht = 1;
                } else {
                    H_k = F_k; ht = 2;
                }
                if (k == k0) {
                    H_k = E_k; ht = 1;
                }
                if (H_k > ALN_INF) H_k = ALN_INF;
                if (E_k > ALN_INF) E_k = ALN_INF;
                bits = (uint8_t)(ht | (et << 2) | (ft << 3));
                f_prev = F_k;
                hnof_prev = h_no_f;
            }
            E_row[k] = E_k;
            H_row[k] = H_k;
            tb_row[k] = bits;
        }
        int64_t *tmp = H_prev; H_prev = H_row; H_row = tmp;
        tmp = E_prev; E_prev = E_row; E_row = tmp;
    }
    const int64_t k_end = T - P - lo;
    int64_t score = H_prev[k_end];
    int64_t layer = tbk[(size_t)P * Wb + k_end] & 3;
    const int64_t end_d = (E_prev[k_end] >= ALN_INF) ? ALN_INF
                          : E_prev[k_end] - gapo + te;
    if (end_d < score) { score = end_d; layer = 1; }
    *score_out = score;
    // certificate (see align_banded.py docstring); a band that covers
    // every diagonal of the matrix IS the full DP — always exact
    const int64_t c_d = (tb < te ? tb : te) < gapo ? (tb < te ? tb : te)
                        : gapo;
    const int64_t dT = T - P >= 0 ? T - P : P - T;
    const bool full_cover = (lo <= -P) && (hi >= T);
    if (!full_cover && score >= gapo + c_d + gape * (2 * W + 2 + dT)) {
        free(H_prev); free(E_prev); free(H_row); free(E_row); free(tbk);
        return 1;
    }
    // traceback (identical rules to the twins)
    int64_t i = P, k = k_end, n_ops = 0;
    while (i > 0 || (i + lo + k) > 0) {
        const int64_t j = i + lo + k;
        if (n_ops >= ops_cap) break;     // cannot happen; guard anyway
        const uint8_t bits = tbk[(size_t)i * Wb + k];
        if (i > 0 && j > 0 && layer == 0) {
            ops_out[n_ops++] = (pat[i - 1] == txt[j - 1]) ? '=' : 'X';
            i -= 1;
            layer = tbk[(size_t)i * Wb + k] & 3;
        } else if (layer == 1) {
            const uint8_t ext = (bits >> 2) & 1;
            ops_out[n_ops++] = 'D';
            i -= 1;
            k += 1;
            layer = ext ? 1 : (tbk[(size_t)i * Wb + k] & 3);
        } else {
            const uint8_t ext = (bits >> 3) & 1;
            ops_out[n_ops++] = 'I';
            k -= 1;
            layer = ext ? 2 : (tbk[(size_t)i * Wb + k] & 3);
        }
        if (k < 0 || k >= Wb) {          // left the band: impossible
            free(H_prev); free(E_prev); free(H_row); free(E_row);
            free(tbk);
            return -1;
        }
    }
    // forward order
    for (int64_t a = 0, b = n_ops - 1; a < b; a++, b--) {
        uint8_t t = ops_out[a]; ops_out[a] = ops_out[b]; ops_out[b] = t;
    }
    *ops_len = n_ops;
    free(H_prev); free(E_prev); free(H_row); free(E_row); free(tbk);
    return 0;
}

// Native twin of trgt_tpu/kernels/align_host.align_ends_free_text
// (span-locater mode: pattern global, text free at both ends; ref:
// src/trgt/genotype/span_locater.rs:14-27, span recovery semantics
// src/wfaligner.rs:864-908). Full-matrix DP — the text-free start makes
// banding inapplicable — but flank patterns are ~250bp so P·T stays
// small; the win over the numpy twin is the per-row Python overhead.
// out[6] = {score, n_matches, p_start, p_end, t_start, t_end}.
int trgt_endsfree_align(const uint8_t *pat, int64_t P, const uint8_t *txt,
                        int64_t T, int64_t mism, int64_t gapo,
                        int64_t gape, int64_t *out) {
    if (P <= 0 || T <= 0) return -1;
    const int64_t Wc = T + 1;
    int64_t *H_prev = (int64_t *)malloc(sizeof(int64_t) * Wc);
    int64_t *E_prev = (int64_t *)malloc(sizeof(int64_t) * Wc);
    int64_t *H_row = (int64_t *)malloc(sizeof(int64_t) * Wc);
    int64_t *E_row = (int64_t *)malloc(sizeof(int64_t) * Wc);
    uint8_t *tbk = (uint8_t *)malloc((size_t)(P + 1) * Wc);
    if (!H_prev || !E_prev || !H_row || !E_row || !tbk) {
        free(H_prev); free(E_prev); free(H_row); free(E_row); free(tbk);
        return -1;
    }
    for (int64_t j = 0; j <= T; j++) {    // free text start
        H_prev[j] = 0;
        E_prev[j] = ALN_INF;
        tbk[j] = 0;
    }
    for (int64_t i = 1; i <= P; i++) {
        uint8_t *tb_row = tbk + (size_t)i * Wc;
        const int64_t pc = pat[i - 1];
        int64_t f_prev = ALN_INF, hnof_prev = ALN_INF;
        for (int64_t j = 0; j <= T; j++) {
            int64_t e_open = (H_prev[j] >= ALN_INF) ? ALN_INF
                             : H_prev[j] + gapo + gape;
            int64_t e_ext = (E_prev[j] >= ALN_INF) ? ALN_INF
                            : E_prev[j] + gape;
            uint8_t et = (e_ext < e_open) ? 1 : 0;
            int64_t E_j = et ? e_ext : e_open;
            if (j == 0) {
                E_j = gapo + gape * i;
                et = (i > 1) ? 1 : 0;
            }
            int64_t diag = ALN_INF;
            if (j >= 1 && H_prev[j - 1] < ALN_INF)
                diag = H_prev[j - 1] + ((txt[j - 1] == pc) ? 0 : mism);
            int64_t h_no_f = diag < E_j ? diag : E_j;
            int64_t f_open = (hnof_prev >= ALN_INF) ? ALN_INF
                             : hnof_prev + gapo + gape;
            int64_t f_ext = (f_prev >= ALN_INF) ? ALN_INF
                            : f_prev + gape;
            int64_t F_j = f_open < f_ext ? f_open : f_ext;
            uint8_t ft = (F_j < f_open) ? 1 : 0;
            uint8_t ht;
            int64_t H_j;
            if (diag <= E_j && diag <= F_j) { H_j = diag; ht = 0; }
            else if (E_j <= F_j) { H_j = E_j; ht = 1; }
            else { H_j = F_j; ht = 2; }
            if (j == 0) { H_j = E_j; ht = 1; }
            if (H_j > ALN_INF) H_j = ALN_INF;
            if (E_j > ALN_INF) E_j = ALN_INF;
            H_row[j] = H_j;
            E_row[j] = E_j;
            tb_row[j] = (uint8_t)(ht | (et << 2) | (ft << 3));
            f_prev = F_j;
            hnof_prev = h_no_f;
        }
        int64_t *tmp = H_prev; H_prev = H_row; H_row = tmp;
        tmp = E_prev; E_prev = E_row; E_row = tmp;
    }
    int64_t j_end = 0, score = H_prev[0];
    for (int64_t j = 1; j <= T; j++)      // first minimum wins
        if (H_prev[j] < score) { score = H_prev[j]; j_end = j; }
    // traceback from (P, j_end) to row 0; span = first..last M/X column
    int64_t i = P, j = j_end;
    int64_t layer = tbk[(size_t)P * Wc + j] & 3;
    int64_t n_matches = 0;
    int64_t p_start = -1, p_end = -1, t_start = -1, t_end = -1;
    while (i > 0) {
        const uint8_t bits = tbk[(size_t)i * Wc + j];
        if (j > 0 && layer == 0) {
            if (pat[i - 1] == txt[j - 1]) n_matches++;
            if (p_end < 0) { p_end = i; t_end = j; }
            p_start = i - 1;
            t_start = j - 1;
            i -= 1; j -= 1;
            layer = tbk[(size_t)i * Wc + j] & 3;
        } else if (layer == 1) {
            const uint8_t ext = (bits >> 2) & 1;
            i -= 1;
            layer = ext ? 1 : (tbk[(size_t)i * Wc + j] & 3);
        } else {
            const uint8_t ext = (bits >> 3) & 1;
            j -= 1;
            layer = ext ? 2 : (tbk[(size_t)i * Wc + j] & 3);
        }
    }
    out[0] = score;
    if (p_end < 0) {
        out[1] = out[2] = out[3] = out[4] = out[5] = 0;
    } else {
        out[1] = n_matches;
        out[2] = p_start; out[3] = p_end;
        out[4] = t_start; out[5] = t_end;
    }
    free(H_prev); free(E_prev); free(H_row); free(E_row); free(tbk);
    return 0;
}

// Diagonal-banded variant of trgt_endsfree_align: identical recurrences
// and tie rules, evaluated only on cells with j - i in [dlo, dhi]. The
// caller (kernels/span_window.py) certifies post-hoc that every optimal
// alignment lies inside the band, which makes score/matches/span/ties
// bit-identical to the full DP; uncertified results are discarded and
// recomputed full. Cells per problem drop from O(P*T) to O(P*W),
// W = band width — the O(n*s)-class answer to WFA's wavefronts
// (ref: src/wfaligner.rs:5-10) for the span-locater workload
// (ref: src/trgt/genotype/span_locater.rs:14-27).
// rc: 0 ok; 1 = no valid end cell in band; 2 = traceback left the band
// (uncertifiable; caller recomputes full); -1 = args/alloc.
int trgt_endsfree_banded(const uint8_t *pat, int64_t P, const uint8_t *txt,
                         int64_t T, int64_t mism, int64_t gapo,
                         int64_t gape, int64_t dlo, int64_t dhi,
                         int64_t *out) {
    if (P <= 0 || T <= 0 || dhi < dlo) return -1;
    const int64_t W = dhi - dlo + 1;
    int64_t *H_prev = (int64_t *)malloc(sizeof(int64_t) * W);
    int64_t *E_prev = (int64_t *)malloc(sizeof(int64_t) * W);
    int64_t *H_row = (int64_t *)malloc(sizeof(int64_t) * W);
    int64_t *E_row = (int64_t *)malloc(sizeof(int64_t) * W);
    uint8_t *tbk = (uint8_t *)malloc((size_t)(P + 1) * W);
    if (!H_prev || !E_prev || !H_row || !E_row || !tbk) {
        free(H_prev); free(E_prev); free(H_row); free(E_row); free(tbk);
        return -1;
    }
    for (int64_t b = 0; b < W; b++) {     // row 0: free text start
        const int64_t j = dlo + b;
        H_prev[b] = (j >= 0 && j <= T) ? 0 : ALN_INF;
        E_prev[b] = ALN_INF;
        tbk[b] = 0;
    }
    for (int64_t i = 1; i <= P; i++) {
        uint8_t *tb_row = tbk + (size_t)i * W;
        const int64_t pc = pat[i - 1];
        int64_t f_prev = ALN_INF, hnof_prev = ALN_INF;
        for (int64_t b = 0; b < W; b++) {
            const int64_t j = i + dlo + b;
            if (j < 0 || j > T) {
                H_row[b] = ALN_INF;
                E_row[b] = ALN_INF;
                tb_row[b] = 0;
                f_prev = ALN_INF;
                hnof_prev = ALN_INF;
                continue;
            }
            // E refs (i-1, j): band index b+1 in the previous row
            int64_t hp = (b + 1 < W) ? H_prev[b + 1] : ALN_INF;
            int64_t ep = (b + 1 < W) ? E_prev[b + 1] : ALN_INF;
            int64_t e_open = (hp >= ALN_INF) ? ALN_INF : hp + gapo + gape;
            int64_t e_ext = (ep >= ALN_INF) ? ALN_INF : ep + gape;
            uint8_t et = (e_ext < e_open) ? 1 : 0;
            int64_t E_j = et ? e_ext : e_open;
            if (j == 0) {
                E_j = gapo + gape * i;
                et = (i > 1) ? 1 : 0;
            }
            // diag refs (i-1, j-1): band index b in the previous row
            int64_t diag = ALN_INF;
            if (j >= 1 && H_prev[b] < ALN_INF)
                diag = H_prev[b] + ((txt[j - 1] == pc) ? 0 : mism);
            int64_t h_no_f = diag < E_j ? diag : E_j;
            int64_t f_open = (hnof_prev >= ALN_INF) ? ALN_INF
                             : hnof_prev + gapo + gape;
            int64_t f_ext = (f_prev >= ALN_INF) ? ALN_INF
                            : f_prev + gape;
            int64_t F_j = f_open < f_ext ? f_open : f_ext;
            uint8_t ft = (F_j < f_open) ? 1 : 0;
            uint8_t ht;
            int64_t H_j;
            if (diag <= E_j && diag <= F_j) { H_j = diag; ht = 0; }
            else if (E_j <= F_j) { H_j = E_j; ht = 1; }
            else { H_j = F_j; ht = 2; }
            if (j == 0) { H_j = E_j; ht = 1; }
            if (H_j > ALN_INF) H_j = ALN_INF;
            if (E_j > ALN_INF) E_j = ALN_INF;
            H_row[b] = H_j;
            E_row[b] = E_j;
            tb_row[b] = (uint8_t)(ht | (et << 2) | (ft << 3));
            f_prev = F_j;
            hnof_prev = h_no_f;
        }
        int64_t *tmp = H_prev; H_prev = H_row; H_row = tmp;
        tmp = E_prev; E_prev = E_row; E_row = tmp;
    }
    // first minimum over valid row-P cells wins — band indices ascend
    // with j, so this reproduces the full DP's first-argmin end column
    int64_t j_end = -1, score = ALN_INF;
    for (int64_t b = 0; b < W; b++) {
        const int64_t j = P + dlo + b;
        if (j < 0 || j > T) continue;
        if (H_prev[b] < score) { score = H_prev[b]; j_end = j; }
    }
    if (j_end < 0 || score >= ALN_INF) {
        free(H_prev); free(E_prev); free(H_row); free(E_row); free(tbk);
        return 1;
    }
    int64_t i = P, j = j_end;
    int64_t layer = tbk[(size_t)P * W + (j - P - dlo)] & 3;
    int64_t n_matches = 0;
    int64_t p_start = -1, p_end = -1, t_start = -1, t_end = -1;
    int rc = 0;
    while (i > 0) {
        const int64_t b = j - i - dlo;
        if (b < 0 || b >= W) { rc = 2; break; }
        const uint8_t bits = tbk[(size_t)i * W + b];
        if (j > 0 && layer == 0) {
            if (pat[i - 1] == txt[j - 1]) n_matches++;
            if (p_end < 0) { p_end = i; t_end = j; }
            p_start = i - 1;
            t_start = j - 1;
            i -= 1; j -= 1;
            layer = -1;                      // re-read at the new cell
        } else if (layer == 1) {
            const uint8_t ext = (bits >> 2) & 1;
            i -= 1;
            layer = ext ? 1 : -1;
        } else {
            const uint8_t ext = (bits >> 3) & 1;
            j -= 1;
            layer = ext ? 2 : -1;
        }
        if (layer == -1 && i > 0) {
            const int64_t nb = j - i - dlo;
            if (nb < 0 || nb >= W) { rc = 2; break; }
            layer = tbk[(size_t)i * W + nb] & 3;
        }
    }
    out[0] = score;
    if (p_end < 0) {
        out[1] = out[2] = out[3] = out[4] = out[5] = 0;
    } else {
        out[1] = n_matches;
        out[2] = p_start; out[3] = p_end;
        out[4] = t_start; out[5] = t_end;
    }
    free(H_prev); free(E_prev); free(H_row); free(E_row); free(tbk);
    return rc;
}

// ---------------- BAMlet record encoder ----------------
//
// Builds one complete spanning-read BAM record (block_size prefix +
// fixed fields + qname + cigar + 4-bit seq + quals + the BAMlet aux
// schema TR/rq/[MC]/[MO]/[HP]/SO/EO/AL/FL, ref:
// src/trgt/writers/write_bam.rs:113-140) in a caller buffer. The
// Python twin is io/bam_write.write_record + engine/runner's aux list;
// byte equality is enforced by tests/test_native.py. The per-record
// Python encode path was the writer thread's dominant cost at the
// 10^4-locus scale (benchmarks/scale10k.py).

static inline int bam_reg2bin(int64_t beg, int64_t end) {
    end -= 1;
    if (beg >> 14 == end >> 14) return ((1 << 15) - 1) / 7 + (beg >> 14);
    if (beg >> 17 == end >> 17) return ((1 << 12) - 1) / 7 + (beg >> 17);
    if (beg >> 20 == end >> 20) return ((1 << 9) - 1) / 7 + (beg >> 20);
    if (beg >> 23 == end >> 23) return ((1 << 6) - 1) / 7 + (beg >> 23);
    if (beg >> 26 == end >> 26) return ((1 << 3) - 1) / 7 + (beg >> 26);
    return 0;
}

// ASCII -> 4-bit nibble ("=ACMGRSVTWYHKDBN", case-insensitive, else N)
static uint8_t nt16_of(uint8_t c) {
    static uint8_t tab[256];
    static bool init = false;
    if (!init) {
        const char *codes = "=ACMGRSVTWYHKDBN";
        for (int i = 0; i < 256; i++) tab[i] = 15;
        for (int i = 0; i < 16; i++) {
            tab[(uint8_t)codes[i]] = i;
            tab[(uint8_t)tolower(codes[i])] = i;
        }
        init = true;
    }
    return tab[c];
}

// Returns total bytes written (block_size int32 + record), or -1 if
// out_cap is too small.
int64_t trgt_bamlet_record(
    const char *qname, int64_t flag, int64_t ref_id, int64_t pos,
    int64_t mapq, const uint32_t *cigar, int64_t n_cigar,
    const uint8_t *seq, int64_t l_seq, const uint8_t *qual,
    const char *tr_id, double rq,
    const uint8_t *mc, int64_t mc_len,          // -1 = absent
    const int32_t *mo, int64_t mo_len,          // -1 = absent
    int64_t hp,                                 // -1 = absent
    int64_t so, int64_t eo, int64_t al, int64_t flank_len,
    uint8_t *out, int64_t out_cap) {
    const int64_t qname_len = (int64_t)strlen(qname) + 1;
    const int64_t tr_len = (int64_t)strlen(tr_id) + 1;
    int64_t ref_span = 0;
    for (int64_t i = 0; i < n_cigar; i++) {
        const uint32_t op = cigar[i] & 0xF;     // MIDNSHP=X
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
            ref_span += cigar[i] >> 4;
    }
    int64_t need = 4 + 32 + qname_len + 4 * n_cigar + (l_seq + 1) / 2 +
                   l_seq + (3 + tr_len) + 7 +
                   (mc_len >= 0 ? 8 + mc_len : 0) +
                   (mo_len >= 0 ? 8 + 4 * mo_len : 0) +
                   (hp >= 0 ? 4 : 0) + 3 * 7 + (8 + 8);
    if (need > out_cap) return -1;
    uint8_t *p = out + 4;                       // block_size patched last
    const int bin_v = bam_reg2bin(pos, pos + (n_cigar ? (ref_span > 0 ?
                                  ref_span : 1) : 1));
    auto put_i32 = [&](int32_t v) { memcpy(p, &v, 4); p += 4; };
    auto put_u32 = [&](uint32_t v) { memcpy(p, &v, 4); p += 4; };
    put_i32((int32_t)ref_id);
    put_i32((int32_t)pos);
    *p++ = (uint8_t)qname_len;
    *p++ = (uint8_t)mapq;
    uint16_t bin16 = (uint16_t)bin_v;
    memcpy(p, &bin16, 2); p += 2;
    uint16_t nc16 = (uint16_t)n_cigar;
    memcpy(p, &nc16, 2); p += 2;
    uint16_t fl16 = (uint16_t)flag;
    memcpy(p, &fl16, 2); p += 2;
    put_u32((uint32_t)l_seq);
    put_i32(-1); put_i32(-1); put_i32(0);       // mate ref/pos, tlen
    memcpy(p, qname, qname_len); p += qname_len;
    memcpy(p, cigar, 4 * n_cigar); p += 4 * n_cigar;
    for (int64_t i = 0; i + 1 < l_seq; i += 2)
        *p++ = (uint8_t)((nt16_of(seq[i]) << 4) | nt16_of(seq[i + 1]));
    if (l_seq % 2) *p++ = (uint8_t)(nt16_of(seq[l_seq - 1]) << 4);
    memcpy(p, qual, l_seq); p += l_seq;
    // aux: TR:Z
    *p++ = 'T'; *p++ = 'R'; *p++ = 'Z';
    memcpy(p, tr_id, tr_len); p += tr_len;
    // rq:f
    *p++ = 'r'; *p++ = 'q'; *p++ = 'f';
    float rqf = (float)rq;
    memcpy(p, &rqf, 4); p += 4;
    if (mc_len >= 0) {                          // MC:B:C
        *p++ = 'M'; *p++ = 'C'; *p++ = 'B'; *p++ = 'C';
        put_u32((uint32_t)mc_len);
        memcpy(p, mc, mc_len); p += mc_len;
    }
    if (mo_len >= 0) {                          // MO:B:i
        *p++ = 'M'; *p++ = 'O'; *p++ = 'B'; *p++ = 'i';
        put_u32((uint32_t)mo_len);
        memcpy(p, mo, 4 * mo_len); p += 4 * mo_len;
    }
    if (hp >= 0) {                              // HP:C
        *p++ = 'H'; *p++ = 'P'; *p++ = 'C';
        *p++ = (uint8_t)hp;
    }
    auto put_tag_i = [&](char a, char b, int32_t v) {
        *p++ = (uint8_t)a; *p++ = (uint8_t)b; *p++ = 'i';
        memcpy(p, &v, 4); p += 4;
    };
    put_tag_i('S', 'O', (int32_t)so);
    put_tag_i('E', 'O', (int32_t)eo);
    put_tag_i('A', 'L', (int32_t)al);
    // FL:B:I x2
    *p++ = 'F'; *p++ = 'L'; *p++ = 'B'; *p++ = 'I';
    put_u32(2);
    put_u32((uint32_t)flank_len);
    put_u32((uint32_t)flank_len);
    const int32_t block = (int32_t)(p - out - 4);
    memcpy(out, &block, 4);
    return p - out;
}

// ---------------- HMM Viterbi (host twin) ----------------
//
// Native twin of trgt_tpu/hmm/model.Hmm.label (ref: the reference
// Viterbi at src/hmm/hmm_model.rs:54-156): dense in-edge tables, silent
// states resolved level-by-level within a column, '#'-sentinel query
// already encoded by the caller. Double-precision adds match numpy
// bit-for-bit; ties take the FIRST maximal in-edge (strict >), like
// np.argmax / the reference's iteration order.
//
// rc: 0 ok, 1 = traceback failed (no valid path), -1 = alloc/args.
int trgt_hmm_label(int64_t S, int64_t E, int64_t L,
                   const int32_t *in_idx, const double *in_lp,
                   const double *em,           // (S, 5)
                   const uint8_t *silent, const uint8_t *has_edges,
                   int64_t n_levels, const int32_t *level_off,
                   const int32_t *level_states,
                   const int32_t *sym,         // (L,) 0..4
                   int32_t *out_path, int64_t out_cap,
                   int64_t *out_len) {
    if (S <= 0 || L <= 0 || E <= 0) return -1;
    const double NEGI = -INFINITY;
    double *scores = (double *)malloc(sizeof(double) * (size_t)L * S);
    int32_t *preds = (int32_t *)malloc(sizeof(int32_t) * (size_t)L * S);
    uint8_t *valid = (uint8_t *)calloc((size_t)L * S, 1);
    if (!scores || !preds || !valid) {
        free(scores); free(preds); free(valid);
        return -1;
    }
    double *col = scores;            // row views
    int32_t *colp = preds;
    uint8_t *colv = valid;
    // position 0: edge-less emitting states seed with their emission
    for (int64_t s = 0; s < S; s++) {
        col[s] = NEGI;
        colp[s] = 0;
        if (!silent[s] && !has_edges[s]) {
            double e0 = em[s * 5 + sym[0]];
            if (e0 != NEGI) {
                col[s] = e0;
                colp[s] = (int32_t)s;
                colv[s] = 1;
            }
        }
    }
    for (int64_t lv = 0; lv < n_levels; lv++) {
        for (int32_t q = level_off[lv]; q < level_off[lv + 1]; q++) {
            const int64_t s = level_states[q];
            double best = NEGI;
            int64_t bp = -1;
            for (int64_t e = 0; e < E; e++) {
                const double lp = in_lp[s * E + e];
                const int32_t p = in_idx[s * E + e];
                const double v = col[p] + lp;
                if (v > best) { best = v; bp = p; }
            }
            if (bp >= 0) {
                col[s] = best;
                colp[s] = (int32_t)bp;
                colv[s] = 1;
            }
        }
    }
    for (int64_t i = 1; i < L; i++) {
        const double *prev = scores + (size_t)(i - 1) * S;
        col = scores + (size_t)i * S;
        colp = preds + (size_t)i * S;
        colv = valid + (size_t)i * S;
        const int64_t symi = sym[i];
        for (int64_t s = 0; s < S; s++) {
            double best = NEGI;
            int64_t be = 0;
            for (int64_t e = 0; e < E; e++) {
                const double v = prev[in_idx[s * E + e]]
                                 + in_lp[s * E + e];
                if (v > best) { best = v; be = e; }
            }
            const int32_t bp = in_idx[s * E + be];
            double c = silent[s] ? NEGI : best + em[s * 5 + symi];
            col[s] = c;
            colp[s] = bp;
            colv[s] = (!silent[s] && has_edges[s] && c > NEGI) ? 1 : 0;
        }
        for (int64_t lv = 0; lv < n_levels; lv++) {
            for (int32_t q = level_off[lv]; q < level_off[lv + 1]; q++) {
                const int64_t s = level_states[q];
                double best = NEGI;
                int64_t bp = -1;
                for (int64_t e = 0; e < E; e++) {
                    const double v = col[in_idx[s * E + e]]
                                     + in_lp[s * E + e];
                    if (v > best) { best = v; bp = in_idx[s * E + e]; }
                }
                if (bp >= 0) {
                    col[s] = best;
                    colp[s] = (int32_t)bp;
                    colv[s] = 1;
                }
            }
        }
    }
    // traceback (ref: hmm_model.rs:125-142)
    int64_t state = S - 1, index = L - 1, n = 0;
    while (state != 0) {
        if (n >= out_cap || index < 0 ||
            !valid[(size_t)index * S + state]) {
            free(scores); free(preds); free(valid);
            return 1;
        }
        out_path[n++] = (int32_t)state;
        const int32_t prev_state = preds[(size_t)index * S + state];
        if (!silent[state]) index -= 1;
        state = prev_state;
    }
    if (n >= out_cap) {
        free(scores); free(preds); free(valid);
        return 1;
    }
    out_path[n++] = 0;
    for (int64_t a = 0, b = n - 1; a < b; a++, b--) {
        int32_t t = out_path[a]; out_path[a] = out_path[b];
        out_path[b] = t;
    }
    *out_len = n;
    free(scores); free(preds); free(valid);
    return 0;
}

}  // extern "C"

// ---------------- block-addressed BAM reader ----------------
//
// A locus's record walk reads the BAM through a cache of inflated BGZF
// blocks, keyed by the block's file offset and filled on demand. From
// each BAI chunk's begin virtual offset (io/bam.py `chunks_for` clips it
// to the linear index's floor) the walk inflates a block only when it
// reaches it, and it stops at the chunk's end, at another tid, or at the
// first record at or past the window's end: no block past that point is
// inflated. A record that crosses blocks is put together from them. The
// records gathered go through trgt_extract_reads as one buffer, so the
// per-record logic is the same. The cache is a least-recently-used list
// bounded in inflated bytes, owned by one reader (one per BamReader, so
// one per pool worker and per extraction thread); a mutex keeps two
// threads off one reader.

#include <chrono>
#include <fcntl.h>
#include <list>
#include <memory>
#include <mutex>
#include <new>
#include <unistd.h>
#include <unordered_map>

namespace {

// the largest BGZF block, compressed or inflated (SAM spec §4.1)
const size_t BGZF_MAX_BLOCK = 65536;

struct Block {
    uint64_t coffset;           // file offset of the block
    uint64_t next;              // file offset of the block after it
    std::vector<uint8_t> data;  // its inflated bytes
};

using BlockPtr = std::shared_ptr<const Block>;

struct BlockReader {
    int fd = -1;
    size_t capacity = 0;        // inflated bytes the cache may hold
    size_t held = 0;
    std::list<BlockPtr> lru;    // most recently used first
    std::unordered_map<uint64_t, std::list<BlockPtr>::iterator> where;
    std::vector<uint8_t> comp;  // one compressed block
    std::vector<uint8_t> recs;  // the walk's records, length-prefixed
    z_stream zs;
    std::mutex mu;
    // the walk's blocks inflated, blocks the cache served, inflated
    // bytes, and nanoseconds spent reading and inflating
    int64_t stats[4];
};

// Reads and inflates the block at `coffset` into the cache. 1: done;
// 0: end of file; negative: a read or format error.
int load_block(BlockReader &r, uint64_t coffset, BlockPtr &out) {
    auto t0 = std::chrono::steady_clock::now();
    size_t n = 0;
    while (n < BGZF_MAX_BLOCK) {
        ssize_t got = pread(r.fd, r.comp.data() + n, BGZF_MAX_BLOCK - n,
                            (off_t)(coffset + n));
        if (got < 0) return -1;
        if (got == 0) break;
        n += (size_t)got;
    }
    if (n == 0) return 0;
    int64_t bsize = block_size_at(r.comp.data(), n);
    if (bsize < 0 || (size_t)bsize > n) return -2;
    uint16_t xlen = r.comp[10] | (r.comp[11] << 8);
    if ((size_t)bsize < 12 + (size_t)xlen + 8) return -2;
    uint32_t isize;
    memcpy(&isize, r.comp.data() + bsize - 4, 4);
    if (isize > BGZF_MAX_BLOCK) return -2;
    auto blk = std::make_shared<Block>();
    blk->coffset = coffset;
    blk->next = coffset + (uint64_t)bsize;
    blk->data.resize(isize);
    if (isize > 0) {
        if (inflateReset(&r.zs) != Z_OK) return -3;
        r.zs.next_in = r.comp.data() + 12 + xlen;
        r.zs.avail_in = (uInt)(bsize - 12 - xlen - 8);
        r.zs.next_out = blk->data.data();
        r.zs.avail_out = isize;
        if (inflate(&r.zs, Z_FINISH) != Z_STREAM_END) return -4;
    }
    r.lru.push_front(blk);
    r.where[coffset] = r.lru.begin();
    r.held += isize;
    while (r.held > r.capacity && r.lru.size() > 1) {
        const BlockPtr &old = r.lru.back();
        r.held -= old->data.size();
        r.where.erase(old->coffset);
        r.lru.pop_back();
    }
    r.stats[0]++;
    r.stats[2] += isize;
    r.stats[3] += std::chrono::duration_cast<std::chrono::nanoseconds>(
                      std::chrono::steady_clock::now() - t0).count();
    out = std::move(blk);
    return 1;
}

// The block at `coffset`, from the cache or the file (load_block's codes).
int get_block(BlockReader &r, uint64_t coffset, BlockPtr &out) {
    auto it = r.where.find(coffset);
    if (it == r.where.end()) return load_block(r, coffset, out);
    r.lru.splice(r.lru.begin(), r.lru, it->second);
    r.stats[1]++;
    out = *it->second;
    return 1;
}

// A virtual offset (c, u) in the walk. Past a block's last byte it
// moves to (next block, 0) at once, so that it compares with a chunk's
// end as that offset does; `blk` is block c once the walk has read from
// it, so a block is looked up once for each run of reads from it.
struct Cursor {
    BlockPtr blk;
    uint64_t c = 0;
    uint32_t u = 0;

    void seek(uint64_t voffset) {
        uint64_t c_new = voffset >> 16;
        if (!blk || blk->coffset != c_new) blk.reset();
        c = c_new;
        u = (uint32_t)(voffset & 0xFFFF);
    }

    bool before(uint64_t voffset) const {
        uint64_t ce = voffset >> 16;
        return c < ce || (c == ce && u < (voffset & 0xFFFF));
    }

    // Copies n bytes to dst. 1: done; 0: end of file before the first
    // byte; negative: an error, or the file ended inside the n bytes.
    int read(BlockReader &r, uint8_t *dst, size_t n) {
        bool started = false;
        while (n > 0) {
            if (!blk) {
                int rc = get_block(r, c, blk);
                if (rc == 0) return started ? -5 : 0;
                if (rc < 0) return rc;
            }
            size_t size = blk->data.size();
            if (u > size) return -6;
            size_t take = std::min(n, size - u);
            memcpy(dst, blk->data.data() + u, take);
            dst += take;
            n -= take;
            u += (uint32_t)take;
            started = started || take > 0;
            if (u == size) {
                c = blk->next;
                u = 0;
                blk.reset();
            }
        }
        return 1;
    }
};

}  // namespace

extern "C" {

// A reader of the BAM at `path` whose cache holds up to `cache_bytes`
// inflated bytes (at least the block in use); NULL if it cannot open.
void *trgt_reader_open(const char *path, size_t cache_bytes) {
    int fd = open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return nullptr;
    BlockReader *r = new (std::nothrow) BlockReader();
    if (r == nullptr) {
        close(fd);
        return nullptr;
    }
    memset(&r->zs, 0, sizeof(r->zs));
    if (inflateInit2(&r->zs, -15) != Z_OK) {
        close(fd);
        delete r;
        return nullptr;
    }
    r->fd = fd;
    r->capacity = cache_bytes;
    r->comp.resize(BGZF_MAX_BLOCK);
    return r;
}

void trgt_reader_close(void *handle) {
    BlockReader *r = (BlockReader *)handle;
    if (r == nullptr) return;
    inflateEnd(&r->zs);
    close(r->fd);
    delete r;
}

// One locus's walk over `n_chunks` (begin, end) virtual-offset pairs,
// sorted and disjoint, then trgt_extract_reads over the records found:
// the same blob, n_pass and n_filt as that function gives over them.
// stats: blocks inflated, blocks the cache served (each block counted
// once a walk), inflated bytes, nanoseconds reading and inflating.
int trgt_reader_extract(void *handle, const uint64_t *chunks,
                        size_t n_chunks, int32_t tid, int32_t beg,
                        int32_t end, int32_t region_start,
                        int32_t region_end, int32_t clip_lo,
                        int32_t clip_hi, double min_rq, uint8_t **out,
                        size_t *out_size, int64_t *n_pass, int64_t *n_filt,
                        int64_t *stats) {
    BlockReader &r = *(BlockReader *)handle;
    std::lock_guard<std::mutex> lock(r.mu);
    memset(r.stats, 0, sizeof(r.stats));
    r.recs.clear();
    Cursor cur;
    bool done = false;
    for (size_t k = 0; k < n_chunks && !done; k++) {
        cur.seek(chunks[2 * k]);
        while (cur.before(chunks[2 * k + 1])) {
            // block_size, refID, pos: enough to know whether to stop
            size_t at = r.recs.size();
            r.recs.resize(at + 12);
            int rc = cur.read(r, r.recs.data() + at, 12);
            if (rc == 0) {
                r.recs.resize(at);
                done = true;
                break;
            }
            if (rc < 0) return rc;
            int32_t block_size, ref_id, pos;
            memcpy(&block_size, r.recs.data() + at, 4);
            memcpy(&ref_id, r.recs.data() + at + 4, 4);
            memcpy(&pos, r.recs.data() + at + 8, 4);
            if (block_size < 32) return -7;
            if (ref_id != tid || pos >= end) {
                // sorted by position: every later record is past too
                r.recs.resize(at);
                done = true;
                break;
            }
            r.recs.resize(at + 4 + (size_t)block_size);
            rc = cur.read(r, r.recs.data() + at + 12,
                          (size_t)block_size - 8);
            if (rc != 1) return rc < 0 ? rc : -5;
        }
    }
    memcpy(stats, r.stats, sizeof(r.stats));
    return trgt_extract_reads(r.recs.data(), r.recs.size(), 0,
                              r.recs.size(), tid, beg, end, region_start,
                              region_end, clip_lo, clip_hi, min_rq, out,
                              out_size, n_pass, n_filt);
}

}  // extern "C"
