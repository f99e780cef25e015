// Native host de Bruijn graph + unitig pass for k <= 31 (W <= 2 keys).
//
// The at-scale replacement for ops/dbg.graph_unitig_pass_host's numpy
// formulation (reference analog: megahit_core `seq2sdbg` + `assemble`,
// the reference's assemble/assemble_wrapper.py:203-315, which builds a
// succinct dBG in C++). The numpy pointer-doubling mirror pays
// O(V log V) random-access gathers (2 ranks x ~log2(V) rounds x 3
// arrays) — ~85 s at 8.6 M edges on this DRAM-throttled host. This pass
// is O(E + V) with exactly one radix sort (suffix endpoints), one merge
// join, and one serial chain walk whose pointer chases touch each node
// once.
//
// Contract (kept byte-compatible with graph_unitig_pass_host so the two
// backends stay interchangeable and parity-testable):
// - node ids are positions in the ASCENDING unique node-key table;
// - chains: root = head node id (the unique member with prev==self),
//   offset = distance from the head;
// - cycles: broken at their MINIMUM node id (root = min id, offset
//   counted along successor direction from it, link_count[min] = 0,
//   is_cycle = 1 on every member);
// - `order` output = nodes sorted by (root, offset) — the lexsort
//   unitig_set_from_pass would otherwise recompute.
//
// Keys are big-endian-comparable rows of W uint32 words, both strands
// present, ascending (the solid edge table from ops/kmer.py).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// LSB radix sort of (key, payload) pairs, 8 bits per pass, skipping
// passes whose byte is constant (the top bytes of left-aligned k-mer
// keys vary most; low bytes beyond 2(k+1) bits are all zero).
static void radix_sort_u64_pairs(uint64_t* keys, int32_t* payload, size_t n,
                                 uint64_t* tmp_k, int32_t* tmp_p) {
    if (n < 2) return;
    for (int pass = 0; pass < 8; ++pass) {
        const int shift = pass * 8;
        size_t count[256] = {0};
        for (size_t i = 0; i < n; ++i)
            ++count[(keys[i] >> shift) & 0xFF];
        if (count[(keys[0] >> shift) & 0xFF] == n) continue;  // constant byte
        size_t pos[256];
        size_t acc = 0;
        for (int b = 0; b < 256; ++b) { pos[b] = acc; acc += count[b]; }
        for (size_t i = 0; i < n; ++i) {
            const size_t d = pos[(keys[i] >> shift) & 0xFF]++;
            tmp_k[d] = keys[i];
            tmp_p[d] = payload[i];
        }
        std::memcpy(keys, tmp_k, n * sizeof(uint64_t));
        std::memcpy(payload, tmp_p, n * sizeof(int32_t));
    }
}

}  // namespace

extern "C" {

// Returns V (the unique node count), or -1 on bad input.
// keys: [E, W] uint32 big-endian-comparable rows, ascending, W in {1,2}.
// counts: [E] uint64 multiplicities.
// Outputs (caller-allocated):
//   node_words [2E, W] uint32 (first V rows valid, ascending)
//   out_deg/in_deg [2E] int32, root [2E] int32, offset [2E] int32,
//   link_count [2E] uint32, is_cycle [2E] uint8,
//   prefix_id/suffix_id [E] int32, order [2E] int32 (first V valid).
long mfx_graph_pass(
    const uint32_t* keys, const uint64_t* counts, long E_in, int W, int k,
    uint32_t* node_words, int32_t* out_deg, int32_t* in_deg,
    int32_t* root, int32_t* offset, uint32_t* link_count, uint8_t* is_cycle,
    int32_t* prefix_id, int32_t* suffix_id, int32_t* order)
{
    if (E_in <= 0 || W < 1 || W > 2 || k < 1 || k > 31) return -1;
    const size_t E = (size_t)E_in;

    // ---- pack keys to uint64 (same layout as np_pack64: word0 high) ----
    std::vector<uint64_t> p64(E);
    if (W == 2) {
        for (size_t i = 0; i < E; ++i)
            p64[i] = ((uint64_t)keys[i * 2] << 32) | keys[i * 2 + 1];
    } else {
        for (size_t i = 0; i < E; ++i)
            p64[i] = (uint64_t)keys[i] << 32;
    }

    // ---- endpoint keys: prefix = zero base k; suffix = 2-bit left shift
    const int kt = k % 16;              // BASES_PER_WORD = 16 per word
    const int kw = k / 16;
    const int shift = 2 * (16 - 1 - kt) + (kw == 0 ? 32 : 0);
    const uint64_t pref_mask = ~((uint64_t)0x3 << shift);

    // suffix endpoints with their edge index, radix-sorted
    std::vector<uint64_t> suf(E);
    std::vector<int32_t> sidx(E);
    for (size_t i = 0; i < E; ++i) {
        suf[i] = p64[i] << 2;
        sidx[i] = (int32_t)i;
    }
    {
        std::vector<uint64_t> tk(E);
        std::vector<int32_t> tp(E);
        radix_sort_u64_pairs(suf.data(), sidx.data(), E, tk.data(), tp.data());
    }

    // ---- unique node table: merge of (sorted) prefixes and suffixes ----
    // prefixes pref[i] = p64[i] & mask are ascending because p64 is
    // ascending and the mask zeroes one aligned 2-bit field (monotone).
    std::vector<uint64_t> nodes;
    nodes.reserve(2 * E);
    {
        size_t i = 0, j = 0;
        uint64_t last = 0;
        bool have_last = false;
        while (i < E || j < E) {
            uint64_t v;
            if (j >= E) v = p64[i] & pref_mask, ++i;
            else if (i >= E) v = suf[j], ++j;
            else {
                const uint64_t a = p64[i] & pref_mask;
                if (a <= suf[j]) { v = a; ++i; }
                else { v = suf[j]; ++j; }
            }
            if (!have_last || v != last) {
                nodes.push_back(v);
                last = v;
                have_last = true;
            }
        }
    }
    const size_t V = nodes.size();

    // ---- endpoint ids: merge joins against the node table ----
    {
        size_t j = 0;
        for (size_t i = 0; i < E; ++i) {           // prefixes, in order
            const uint64_t a = p64[i] & pref_mask;
            while (nodes[j] < a) ++j;
            prefix_id[i] = (int32_t)j;
        }
        j = 0;
        for (size_t i = 0; i < E; ++i) {           // sorted suffixes
            while (nodes[j] < suf[i]) ++j;
            suffix_id[sidx[i]] = (int32_t)j;
        }
    }
    suf.clear(); suf.shrink_to_fit();
    sidx.clear(); sidx.shrink_to_fit();
    p64.clear(); p64.shrink_to_fit();

    // ---- degrees + unique predecessor -----------------------------------
    std::memset(out_deg, 0, V * sizeof(int32_t));
    std::memset(in_deg, 0, V * sizeof(int32_t));
    std::vector<int32_t> in1(V, -1);
    std::vector<uint32_t> cnt1(V, 0);
    for (size_t i = 0; i < E; ++i) {
        ++out_deg[prefix_id[i]];
        ++in_deg[suffix_id[i]];
        in1[suffix_id[i]] = prefix_id[i];
        const uint64_t c = counts[i];
        cnt1[suffix_id[i]] = c > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)c;
    }

    // ---- linkable prev / next -------------------------------------------
    // prev[v] = p iff in_deg[v]==1, out_deg[p]==1, p != v; prev is then
    // injective, so next[] is well-defined and chains/cycles partition V.
    std::vector<int32_t> nxt(V, -1);
    std::vector<uint8_t> has_prev(V, 0);
    for (size_t v = 0; v < V; ++v) {
        link_count[v] = 0;
        is_cycle[v] = 0;
        if (in_deg[v] == 1) {
            const int32_t p = in1[v];
            if (p != (int32_t)v && out_deg[p] == 1) {
                has_prev[v] = 1;
                link_count[v] = cnt1[v];
                nxt[p] = (int32_t)v;
            }
        }
    }
    in1.clear(); in1.shrink_to_fit();
    cnt1.clear(); cnt1.shrink_to_fit();

    // ---- chain walk ------------------------------------------------------
    // Phase A: chains, from each head (no prev). Phase B: ascending scan —
    // the first unvisited node of a cycle is its minimum id (exactly the
    // break node the device pass picks), so walking from it reproduces the
    // pointer-doubling labels.
    std::vector<uint8_t> visited(V, 0);
    for (size_t v = 0; v < V; ++v) {
        if (has_prev[v]) continue;
        int32_t u = (int32_t)v;
        int32_t off = 0;
        while (u >= 0 && !visited[u]) {
            visited[u] = 1;
            root[u] = (int32_t)v;
            offset[u] = off++;
            u = nxt[u];
        }
    }
    for (size_t v = 0; v < V; ++v) {
        if (visited[v]) continue;
        int32_t u = (int32_t)v;
        int32_t off = 0;
        do {
            visited[u] = 1;
            is_cycle[u] = 1;
            root[u] = (int32_t)v;
            offset[u] = off++;
            u = nxt[u];
        } while (u != (int32_t)v);
        link_count[v] = 0;  // the broken back-edge
    }

    // ---- order = argsort by (root, offset) via counting placement -------
    {
        std::vector<int64_t> base(V + 1, 0);
        for (size_t v = 0; v < V; ++v) ++base[root[v] + 1];
        for (size_t v = 0; v < V; ++v) base[v + 1] += base[v];
        for (size_t v = 0; v < V; ++v)
            order[base[root[v]] + offset[v]] = (int32_t)v;
    }

    // ---- node key words --------------------------------------------------
    if (W == 2) {
        for (size_t v = 0; v < V; ++v) {
            node_words[v * 2] = (uint32_t)(nodes[v] >> 32);
            node_words[v * 2 + 1] = (uint32_t)nodes[v];
        }
    } else {
        for (size_t v = 0; v < V; ++v)
            node_words[v] = (uint32_t)(nodes[v] >> 32);
    }
    return (long)V;
}

}  // extern "C"

extern "C" {

// Bulk unitig assembly from a chain-ordered graph pass (the numpy
// equivalent in ops/dbg.unitig_set_from_pass pays ~6 full array passes
// with fancy-index scatters; this is one sequential pass with two random
// read streams). Inputs are mfx_graph_pass outputs; `order` must be the
// (root, offset)-sorted node list. U (unitig count) and
// total_bases = V + U*(k-1) are computed by the caller (U = number of
// offset==0 nodes).
// Outputs: chain_bounds [U+1] int64, seq_bounds [U+1] int64,
// seq_codes [total_bases] uint8, depth [U] double, circular [U] uint8.
long mfx_unitig_build(
    const int32_t* order, const int32_t* offset, const uint32_t* link_count,
    const uint8_t* is_cycle, const uint32_t* node_words, long V_in, int W,
    int k, int64_t* chain_bounds, int64_t* seq_bounds, uint8_t* seq_codes,
    double* depth, uint8_t* circular)
{
    if (V_in <= 0 || W < 1 || W > 2 || k < 1 || k > 31) return -1;
    const size_t V = (size_t)V_in;
    const int km1 = k - 1;
    long u = -1;
    int64_t seq_pos = 0;
    double link_sum = 0.0;
    int64_t chain_len = 0;
    const int w_last = km1 / 16, t_last = km1 % 16;
    const int sh_last = 2 * (16 - 1 - t_last);

    for (size_t pos = 0; pos < V; ++pos) {
        const int32_t v = order[pos];
        const uint32_t* nk = node_words + (size_t)v * W;
        if (offset[v] == 0) {
            if (u >= 0) {
                depth[u] = chain_len > 1 ? link_sum / (double)(chain_len - 1)
                                         : 0.0;
            }
            ++u;
            chain_bounds[u] = (int64_t)pos;
            seq_bounds[u] = seq_pos;
            circular[u] = is_cycle[v];
            link_sum = 0.0;
            chain_len = 0;
            // head k-mer: the first node contributes its leading k-1
            // bases; its last base falls through to the shared path below
            for (int c = 0; c < km1; ++c) {
                const int w = c / 16, t = c % 16;
                seq_codes[seq_pos++] =
                    (uint8_t)((nk[w] >> (2 * (16 - 1 - t))) & 0x3);
            }
        }
        seq_codes[seq_pos++] = (uint8_t)((nk[w_last] >> sh_last) & 0x3);
        link_sum += (double)link_count[v];
        ++chain_len;
    }
    if (u >= 0) {
        depth[u] = chain_len > 1 ? link_sum / (double)(chain_len - 1) : 0.0;
    }
    ++u;
    chain_bounds[u] = (int64_t)V;
    seq_bounds[u] = seq_pos;
    return u;  // number of unitigs
}

}  // extern "C"
