// Native FASTQ batch reader.
//
// Host-I/O hot path of the engine: parses 4-line FASTQ records (plain or
// gzip via zlib) and encodes bases/qualities directly into caller-owned
// fixed-shape batch buffers — the role the reference delegates to its Rust
// stream filter's I/O layer (filter/filter_bin/src/helper.rs:14-51). The
// Python fallback (io/fastq.py) implements identical record semantics;
// this path exists so 5 Gbp inputs don't bottleneck on the Python parser
// once the device kernels are fast.
//
// C ABI for ctypes:
//   void* mfx_fastq_open(const char* path);
//   long  mfx_fastq_next_batch(void* h, signed char* seqs,
//                              signed char* quals, int* lens,
//                              long batch, long maxlen, long limit_bases);
//         -> number of records written (0 = EOF / base limit reached)
//   long  mfx_fastq_bases_read(void* h);
//   void  mfx_fastq_close(void* h);
//
// seqs is pre-filled by the caller with the pad code (4); bases are
// encoded A=0 C=1 G=2 T/U=3, other=4; quals hold the raw phred+33 bytes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <zlib.h>

namespace {

struct Reader {
    gzFile gz = nullptr;
    int64_t bases = 0;
    bool eof = false;
    // buffered line reader
    char* buf = nullptr;
    size_t cap = 0, len = 0, pos = 0;
};

signed char ENC[256];

struct EncInit {
    EncInit() {
        memset(ENC, 4, sizeof(ENC));
        ENC[(int)'A'] = ENC[(int)'a'] = 0;
        ENC[(int)'C'] = ENC[(int)'c'] = 1;
        ENC[(int)'G'] = ENC[(int)'g'] = 2;
        ENC[(int)'T'] = ENC[(int)'t'] = 3;
        ENC[(int)'U'] = ENC[(int)'u'] = 3;
    }
} enc_init;

// Returns pointer to the next line (not NUL-terminated) and its length
// (without trailing \n / \r). Returns nullptr at EOF.
const char* next_line(Reader* r, size_t* out_len) {
    if (r->pos >= r->len) {
        if (r->eof) return nullptr;
        if (!r->buf) {
            r->cap = 1 << 20;
            r->buf = (char*)malloc(r->cap);
        }
        int got = gzread(r->gz, r->buf, (unsigned)r->cap);
        if (got <= 0) {
            r->eof = true;
            return nullptr;
        }
        r->len = (size_t)got;
        r->pos = 0;
    }
    size_t start = r->pos;
    const char* nl = (const char*)memchr(r->buf + r->pos, '\n', r->len - r->pos);
    if (nl == nullptr) {
        // line spans the buffer boundary: compact + refill
        size_t tail = r->len - start;
        memmove(r->buf, r->buf + start, tail);
        r->len = tail;
        r->pos = 0;
        for (;;) {
            if (r->len + (1 << 16) > r->cap) {
                r->cap *= 2;
                r->buf = (char*)realloc(r->buf, r->cap);
            }
            int got = gzread(r->gz, r->buf + r->len, (unsigned)(r->cap - r->len));
            if (got <= 0) {
                r->eof = true;
                if (r->len == 0) return nullptr;
                size_t n = r->len;
                r->pos = r->len;
                while (n > 0 && (r->buf[n - 1] == '\n' || r->buf[n - 1] == '\r')) n--;
                *out_len = n;
                return r->buf;
            }
            r->len += (size_t)got;
            const char* nl2 = (const char*)memchr(r->buf, '\n', r->len);
            if (nl2 != nullptr) {
                size_t n = (size_t)(nl2 - r->buf);
                r->pos = n + 1;
                while (n > 0 && r->buf[n - 1] == '\r') n--;
                *out_len = n;
                return r->buf;
            }
        }
    }
    size_t n = (size_t)(nl - (r->buf + start));
    r->pos = start + n + 1;
    while (n > 0 && r->buf[start + n - 1] == '\r') n--;
    *out_len = n;
    return r->buf + start;
}

}  // namespace

extern "C" {

void* mfx_fastq_open(const char* path) {
    gzFile gz = gzopen(path, "rb");
    if (!gz) return nullptr;
    gzbuffer(gz, 1 << 20);
    Reader* r = new Reader();
    r->gz = gz;
    return r;
}

long mfx_fastq_next_batch(void* handle, signed char* seqs, signed char* quals,
                          int* lens, long batch, long maxlen, long limit_bases) {
    Reader* r = (Reader*)handle;
    long n = 0;
    size_t ln;
    while (n < batch) {
        if (limit_bases > 0 && r->bases >= limit_bases) break;
        const char* name = next_line(r, &ln);
        if (!name) break;
        const char* seq = next_line(r, &ln);
        if (!seq) break;
        size_t seq_len = ln;
        long L = (long)seq_len < maxlen ? (long)seq_len : maxlen;
        signed char* srow = seqs + n * maxlen;
        for (long i = 0; i < L; i++) srow[i] = ENC[(unsigned char)seq[i]];
        next_line(r, &ln);  // '+'
        const char* qual = next_line(r, &ln);
        if (qual) {
            signed char* qrow = quals + n * maxlen;
            long QL = (long)ln < L ? (long)ln : L;
            memcpy(qrow, qual, (size_t)QL);
        }
        lens[n] = (int)L;
        r->bases += L;
        n++;
    }
    return n;
}

long mfx_fastq_bases_read(void* handle) { return ((Reader*)handle)->bases; }

void mfx_fastq_close(void* handle) {
    Reader* r = (Reader*)handle;
    if (r->gz) gzclose(r->gz);
    free(r->buf);
    delete r;
}

}  // extern "C"
