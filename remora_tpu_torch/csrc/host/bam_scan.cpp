// Fast BAM index scan: BGZF-decompress and walk all records, extracting
// just what the read-id index needs (offset into the decompressed
// stream, read name, flag, optional parent-id 'pi' tag, presence of
// required tags). Replaces the per-record Python decode for the initial
// whole-file pass (reference analog: the pysam tell() loop in
// src/remora/io.py:255-308).
//
// ABI: bam_scan_index() fills malloc'd arrays; bam_scan_free releases.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

struct RecMeta {
    int64_t offset;
    uint16_t flag;
    uint32_t name_off;  // into the name blob (NUL-terminated)
    uint32_t pi_off;    // into blob, or UINT32_MAX
    uint8_t has_req;
};

bool bgzf_decompress_all(const uint8_t* data, size_t size,
                         std::vector<uint8_t>& out) {
    size_t pos = 0;
    out.reserve(size * 3);
    while (pos + 18 <= size) {
        if (data[pos] != 0x1f || data[pos + 1] != 0x8b) return false;
        uint16_t xlen;
        std::memcpy(&xlen, data + pos + 10, 2);
        size_t extra_end = pos + 12 + xlen;
        size_t p = pos + 12;
        uint32_t bsize = 0;
        while (p + 4 <= extra_end) {
            uint8_t si1 = data[p], si2 = data[p + 1];
            uint16_t slen;
            std::memcpy(&slen, data + p + 2, 2);
            if (si1 == 66 && si2 == 67) {
                uint16_t bs;
                std::memcpy(&bs, data + p + 4, 2);
                bsize = bs + 1;
            }
            p += 4 + slen;
        }
        if (bsize == 0) return false;
        uint32_t isize;
        std::memcpy(&isize, data + pos + bsize - 4, 4);
        size_t out_pos = out.size();
        out.resize(out_pos + isize);
        if (isize > 0) {
            z_stream zs{};
            if (inflateInit2(&zs, -15) != Z_OK) return false;
            zs.next_in = const_cast<uint8_t*>(data + extra_end);
            zs.avail_in = (uInt)(bsize - (extra_end - pos) - 8);
            zs.next_out = out.data() + out_pos;
            zs.avail_out = isize;
            int rc = inflate(&zs, Z_FINISH);
            inflateEnd(&zs);
            if (rc != Z_STREAM_END) return false;
        }
        pos += bsize;
    }
    return true;
}

// scan aux tags for 'pi' (string) and required 2-char tags
void scan_tags(const uint8_t* buf, size_t p, size_t end,
               const char* req_tags, int n_req, std::string& pi_out,
               bool& has_req) {
    int req_found = 0;
    pi_out.clear();
    while (p + 3 <= end) {
        char t0 = buf[p], t1 = buf[p + 1];
        uint8_t tc = buf[p + 2];
        p += 3;
        for (int i = 0; i < n_req; ++i) {
            if (req_tags[2 * i] == t0 && req_tags[2 * i + 1] == t1)
                req_found |= (1 << i);
        }
        size_t adv = 0;
        switch (tc) {
            case 'A': case 'c': case 'C': adv = 1; break;
            case 's': case 'S': adv = 2; break;
            case 'i': case 'I': case 'f': adv = 4; break;
            case 'Z': case 'H': {
                size_t z = p;
                while (z < end && buf[z] != 0) ++z;
                if (t0 == 'p' && t1 == 'i' && tc == 'Z') {
                    pi_out.assign((const char*)buf + p, z - p);
                }
                adv = z - p + 1;
                break;
            }
            case 'B': {
                if (p + 5 > end) return;
                uint8_t sub = buf[p];
                uint32_t cnt;
                std::memcpy(&cnt, buf + p + 1, 4);
                size_t esz = 1;
                if (sub == 's' || sub == 'S') esz = 2;
                else if (sub == 'i' || sub == 'I' || sub == 'f') esz = 4;
                adv = 5 + (size_t)cnt * esz;
                break;
            }
            default: return;  // unknown: bail on this record's tags
        }
        p += adv;
    }
    has_req = req_found == (1 << n_req) - 1;
}

}  // namespace

extern "C" {

struct ScanResult {
    int64_t n_records;
    int64_t* offsets;
    uint16_t* flags;
    uint32_t* name_offs;
    uint32_t* pi_offs;  // UINT32_MAX when absent
    uint8_t* has_req;
    char* name_blob;
    int64_t blob_size;
    int64_t body_start;
};

// Returns 0 on success. req_tags: concatenated 2-char tag names.
int bam_scan_index(const uint8_t* data, int64_t size, const char* req_tags,
                   int32_t n_req, ScanResult* res) {
    std::vector<uint8_t> buf;
    if (!bgzf_decompress_all(data, (size_t)size, buf)) return -1;
    if (buf.size() < 12 || std::memcmp(buf.data(), "BAM\x01", 4) != 0)
        return -2;
    int32_t l_text;
    std::memcpy(&l_text, buf.data() + 4, 4);
    size_t p = 8 + (size_t)l_text;
    int32_t n_ref;
    std::memcpy(&n_ref, buf.data() + p, 4);
    p += 4;
    for (int32_t i = 0; i < n_ref; ++i) {
        int32_t l_name;
        std::memcpy(&l_name, buf.data() + p, 4);
        p += 4 + (size_t)l_name + 4;
    }
    res->body_start = (int64_t)p;

    std::vector<RecMeta> recs;
    std::string blob;
    std::string pi;
    while (p + 4 <= buf.size()) {
        int32_t block_size;
        std::memcpy(&block_size, buf.data() + p, 4);
        if (block_size <= 0 || p + 4 + (size_t)block_size > buf.size()) break;
        const uint8_t* rec = buf.data() + p + 4;
        RecMeta m;
        m.offset = (int64_t)p;
        std::memcpy(&m.flag, rec + 14, 2);
        uint8_t l_read_name = rec[8];
        uint16_t n_cigar;
        std::memcpy(&n_cigar, rec + 12, 2);
        int32_t l_seq;
        std::memcpy(&l_seq, rec + 16, 4);
        m.name_off = (uint32_t)blob.size();
        blob.append((const char*)rec + 32, l_read_name - 1);
        blob.push_back('\0');
        size_t tag_start = 32 + l_read_name + 4ull * n_cigar +
                           ((size_t)l_seq + 1) / 2 + (size_t)l_seq;
        bool has_req = (n_req == 0);
        m.pi_off = UINT32_MAX;
        if (tag_start < (size_t)block_size) {
            bool hr;
            scan_tags(rec, tag_start, (size_t)block_size, req_tags, n_req,
                      pi, hr);
            has_req = hr || (n_req == 0);
            if (!pi.empty()) {
                m.pi_off = (uint32_t)blob.size();
                blob.append(pi);
                blob.push_back('\0');
            }
        }
        m.has_req = has_req ? 1 : 0;
        recs.push_back(m);
        p += 4 + (size_t)block_size;
    }

    int64_t n = (int64_t)recs.size();
    res->n_records = n;
    res->offsets = (int64_t*)std::malloc(sizeof(int64_t) * n);
    res->flags = (uint16_t*)std::malloc(sizeof(uint16_t) * n);
    res->name_offs = (uint32_t*)std::malloc(sizeof(uint32_t) * n);
    res->pi_offs = (uint32_t*)std::malloc(sizeof(uint32_t) * n);
    res->has_req = (uint8_t*)std::malloc(sizeof(uint8_t) * n);
    res->name_blob = (char*)std::malloc(blob.size());
    res->blob_size = (int64_t)blob.size();
    for (int64_t i = 0; i < n; ++i) {
        res->offsets[i] = recs[i].offset;
        res->flags[i] = recs[i].flag;
        res->name_offs[i] = recs[i].name_off;
        res->pi_offs[i] = recs[i].pi_off;
        res->has_req[i] = recs[i].has_req;
    }
    std::memcpy(res->name_blob, blob.data(), blob.size());
    return 0;
}

void bam_scan_free(ScanResult* res) {
    std::free(res->offsets);
    std::free(res->flags);
    std::free(res->name_offs);
    std::free(res->pi_offs);
    std::free(res->has_req);
    std::free(res->name_blob);
}

}  // extern C
