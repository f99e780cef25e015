// Native u64 dedup set (open addressing, linear probing).
//
// Backs the PE-duplicate filter (reference filter_bin PE dedup via a Rust
// HashSet of u64 read hashes): at 5 Gbp scale the set holds tens of
// millions of entries, far beyond what a Python set handles gracefully.
//
// C ABI:
//   void* mfx_dedup_new(long expected);
//   long  mfx_dedup_check_add(void* h, const unsigned long long* keys,
//                             const unsigned char* active, long n,
//                             unsigned char* out_unique);
//         -> number of duplicates found; out_unique[i]=1 if key i was new
//   long  mfx_dedup_size(void* h);
//   void  mfx_dedup_free(void* h);

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Set {
    uint64_t* slots;   // 0 = empty (keys are pre-mixed so 0 is vanishing)
    uint64_t mask;
    int64_t count;
    int64_t capacity;
};

uint64_t mix(uint64_t x) {
    // splitmix64 finalizer
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

void grow(Set* s) {
    int64_t ncap = s->capacity * 2;
    uint64_t* nslots = (uint64_t*)calloc((size_t)ncap, sizeof(uint64_t));
    uint64_t nmask = (uint64_t)ncap - 1;
    for (int64_t i = 0; i < s->capacity; i++) {
        uint64_t v = s->slots[i];
        if (!v) continue;
        uint64_t j = v & nmask;
        while (nslots[j]) j = (j + 1) & nmask;
        nslots[j] = v;
    }
    free(s->slots);
    s->slots = nslots;
    s->capacity = ncap;
    s->mask = nmask;
}

}  // namespace

extern "C" {

void* mfx_dedup_new(long expected) {
    Set* s = new Set();
    int64_t cap = 1024;
    while (cap < expected * 2) cap <<= 1;
    s->slots = (uint64_t*)calloc((size_t)cap, sizeof(uint64_t));
    s->capacity = cap;
    s->mask = (uint64_t)cap - 1;
    s->count = 0;
    return s;
}

long mfx_dedup_check_add(void* handle, const unsigned long long* keys,
                         const unsigned char* active, long n,
                         unsigned char* out_unique) {
    Set* s = (Set*)handle;
    long dups = 0;
    for (long i = 0; i < n; i++) {
        out_unique[i] = 1;
        if (active && !active[i]) continue;
        uint64_t v = mix((uint64_t)keys[i]);
        if (!v) v = 1;  // reserve 0 for empty
        uint64_t j = v & s->mask;
        for (;;) {
            uint64_t cur = s->slots[j];
            if (cur == v) {
                out_unique[i] = 0;
                dups++;
                break;
            }
            if (cur == 0) {
                s->slots[j] = v;
                s->count++;
                if (s->count * 4 > s->capacity * 3) grow(s);
                break;
            }
            j = (j + 1) & s->mask;
        }
    }
    return dups;
}

long mfx_dedup_size(void* handle) { return ((Set*)handle)->count; }

void mfx_dedup_free(void* handle) {
    Set* s = (Set*)handle;
    free(s->slots);
    delete s;
}

}  // extern "C"
