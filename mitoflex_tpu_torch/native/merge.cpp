// Linear merge of two SORTED multiword (key, count) runs with per-key
// combination (sum or max) — the host side of the k-mer LSM spill path.
//
// Replaces numpy's concat + stable argsort + reduceat (~4 M rows/s on
// void records) with a single O(n) scan; the device LSM handles tables
// up to its HBM cap, this handles the multi-Gbp tail spilled to host
// (reference analog: megahit_core's external-memory k-mer sorting,
// the reference's assemble/assemble_wrapper.py:217-224).
//
// Keys are W big-endian-comparable uint32 words per row, ascending;
// inputs may contain duplicate keys (combined into one output row).

#include <cstddef>
#include <cstdint>
#include <cstring>

template <int W>
static inline int cmp_keys(const uint32_t* a, const uint32_t* b) {
    // compile-time-unrolled; the first word resolves almost every compare
    for (int w = 0; w < W; ++w) {
        if (a[w] != b[w]) return a[w] < b[w] ? -1 : 1;
    }
    return 0;
}

template <int W>
static long merge_impl(
    const uint32_t* ak, const uint64_t* ac, long na,
    const uint32_t* bk, const uint64_t* bc, long nb,
    int op, uint32_t* ok, uint64_t* oc)
{
    long i = 0, j = 0, n = 0;
    while (i < na && j < nb) {
        int take = cmp_keys<W>(ak + (size_t)i * W, bk + (size_t)j * W);
        const uint32_t* key;
        uint64_t cnt;
        if (take < 0) { key = ak + (size_t)i * W; cnt = ac[i]; ++i; }
        else if (take > 0) { key = bk + (size_t)j * W; cnt = bc[j]; ++j; }
        else {
            key = ak + (size_t)i * W;
            cnt = (op == 0) ? ac[i] + bc[j] : (ac[i] > bc[j] ? ac[i] : bc[j]);
            ++i; ++j;
        }
        if (n > 0 && cmp_keys<W>(ok + (size_t)(n - 1) * W, key) == 0) {
            oc[n - 1] = (op == 0) ? oc[n - 1] + cnt
                                  : (oc[n - 1] > cnt ? oc[n - 1] : cnt);
        } else {
            for (int w = 0; w < W; ++w) ok[(size_t)n * W + w] = key[w];
            oc[n] = cnt;
            ++n;
        }
    }
    // exactly one tail remains; only its first row can equal the last emit
    for (; i < na; ++i) {
        const uint32_t* key = ak + (size_t)i * W;
        if (n > 0 && cmp_keys<W>(ok + (size_t)(n - 1) * W, key) == 0) {
            oc[n - 1] = (op == 0) ? oc[n - 1] + ac[i]
                                  : (oc[n - 1] > ac[i] ? oc[n - 1] : ac[i]);
        } else {
            for (int w = 0; w < W; ++w) ok[(size_t)n * W + w] = key[w];
            oc[n] = ac[i];
            ++n;
        }
    }
    for (; j < nb; ++j) {
        const uint32_t* key = bk + (size_t)j * W;
        if (n > 0 && cmp_keys<W>(ok + (size_t)(n - 1) * W, key) == 0) {
            oc[n - 1] = (op == 0) ? oc[n - 1] + bc[j]
                                  : (oc[n - 1] > bc[j] ? oc[n - 1] : bc[j]);
        } else {
            for (int w = 0; w < W; ++w) ok[(size_t)n * W + w] = key[w];
            oc[n] = bc[j];
            ++n;
        }
    }
    return n;
}

static long merge_generic(
    const uint32_t* ak, const uint64_t* ac, long na,
    const uint32_t* bk, const uint64_t* bc, long nb,
    int W, int op, uint32_t* ok, uint64_t* oc);

extern "C" long mfx_merge_counts(
    const uint32_t* ak, const uint64_t* ac, long na,
    const uint32_t* bk, const uint64_t* bc, long nb,
    int W, int op,  // op: 0 = sum, 1 = max
    uint32_t* ok, uint64_t* oc)
{
    switch (W) {  // (k+1) in [32, 142] bases -> W in [2, 9]; 1 for tests
        case 1: return merge_impl<1>(ak, ac, na, bk, bc, nb, op, ok, oc);
        case 2: return merge_impl<2>(ak, ac, na, bk, bc, nb, op, ok, oc);
        case 3: return merge_impl<3>(ak, ac, na, bk, bc, nb, op, ok, oc);
        case 4: return merge_impl<4>(ak, ac, na, bk, bc, nb, op, ok, oc);
        case 5: return merge_impl<5>(ak, ac, na, bk, bc, nb, op, ok, oc);
        case 6: return merge_impl<6>(ak, ac, na, bk, bc, nb, op, ok, oc);
        case 7: return merge_impl<7>(ak, ac, na, bk, bc, nb, op, ok, oc);
        case 8: return merge_impl<8>(ak, ac, na, bk, bc, nb, op, ok, oc);
        case 9: return merge_impl<9>(ak, ac, na, bk, bc, nb, op, ok, oc);
        default:
            return merge_generic(ak, ac, na, bk, bc, nb, W, op, ok, oc);
    }
}

static long merge_generic(
    const uint32_t* ak, const uint64_t* ac, long na,
    const uint32_t* bk, const uint64_t* bc, long nb,
    int W, int op, uint32_t* ok, uint64_t* oc)
{
    auto cmp = [W](const uint32_t* a, const uint32_t* b) {
        for (int w = 0; w < W; ++w)
            if (a[w] != b[w]) return a[w] < b[w] ? -1 : 1;
        return 0;
    };
    long i = 0, j = 0, n = 0;
    while (i < na || j < nb) {
        int take;
        if (i >= na) take = 1;
        else if (j >= nb) take = -1;
        else take = cmp(ak + (size_t)i * W, bk + (size_t)j * W);
        const uint32_t* key;
        uint64_t cnt;
        if (take < 0) { key = ak + (size_t)i * W; cnt = ac[i]; ++i; }
        else if (take > 0) { key = bk + (size_t)j * W; cnt = bc[j]; ++j; }
        else {
            key = ak + (size_t)i * W;
            cnt = (op == 0) ? ac[i] + bc[j] : (ac[i] > bc[j] ? ac[i] : bc[j]);
            ++i; ++j;
        }
        if (n > 0 && cmp(ok + (size_t)(n - 1) * W, key) == 0) {
            oc[n - 1] = (op == 0) ? oc[n - 1] + cnt
                                  : (oc[n - 1] > cnt ? oc[n - 1] : cnt);
        } else {
            std::memcpy(ok + (size_t)n * W, key, (size_t)W * 4);
            oc[n] = cnt;
            ++n;
        }
    }
    return n;
}
