"""K-mer extraction and counting on tensors, plus the numpy host helpers.

Port of mitoflex_tpu/ops/kmer.py (counting path). k-mers pack 2 bits per
base into W = ceil(k / 16) words, LEFT-aligned (base 0 in the high bits of
word 0), so word-wise unsigned lexicographic order is base-string order.
Key words are ``[W, ...]`` int32 tensors holding the uint32 bit patterns
(convert.py); orders are taken with ``psort.lexsort_words``.

The k-mer LSM works on SCATTERED runs: ``(words [W, n], counts [n])`` sorted
by key, with the one invariant that a key's counts summed over its rows are
its occurrence total. Merging two runs is then a pure sorted merge with
counts as payload (``merge_scattered`` -> ``psort.merge_sorted_runs``, the
CUDA merge kernel on a card); totals are re-summed once, on the host in
uint64 (``pull_scattered``). Rows of invalid windows carry all-ones keys and
count 0; a real all-T k-mer shares that key (when 2k is a multiple of 32)
and its rows are attributed exactly as the reference attributes them.

The chunk sort of 2-word keys (k + 1 <= 32) is ``psort.sort_words2``, the
port of the reference's ``bitonic_sort2`` (the CUDA kernel K4 on a card);
wider keys take a library sort (``torch.sort`` passes), as the reference's
default is ``lax.sort``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..convert import i32_bits, to_device, u32_numpy, u32_values
from ..device import resolve_device
from . import psort

N_CODE = 4
BASES_PER_WORD = 16
ALL_ONES = -1  # int32 bit pattern of the 0xFFFFFFFF sentinel word


def num_words(k: int) -> int:
    return -(-k // BASES_PER_WORD)


def revcomp_codes(seqs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse-complement each row of a padded [B, L] code matrix, keeping
    sequences left-aligned (pad stays on the right)."""
    B, L = seqs.shape
    comp = torch.where(seqs < 4, 3 - seqs, seqs)
    rev = comp.flip(1)
    col = torch.arange(L, device=seqs.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    src = (col + (L - lens)).clamp(0, L - 1)
    out = torch.gather(rev, 1, src)
    return torch.where(col < lens, out, torch.full_like(out, N_CODE))


def revcomp_codes_padfront(seqs: torch.Tensor) -> torch.Tensor:
    """Cheap reverse-complement: plain reversal, pad moves to the FRONT.
    Safe for k-mer extraction because pad is the N code and N-containing
    windows are masked out anyway."""
    return torch.where(seqs < 4, 3 - seqs, seqs).flip(1)


def extract_kmers(
    seqs: torch.Tensor, lengths: torch.Tensor, k: int, right_aligned: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All k-mers of each row: ``(words [W, B, P] int32, valid [B, P] bool)``
    with P = L - k + 1. ``valid``: the window lies inside the row's content
    region and holds no N. ``right_aligned`` marks rows whose content sits at
    the END of the row (pad-front reverse complements)."""
    B, L = seqs.shape
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"max_read_len {L} shorter than k {k}")
    W = num_words(k)
    dev = seqs.device
    codes = torch.where(seqs < 4, seqs, 0).to(torch.int64)
    words = torch.empty((W, B, P), dtype=torch.int32, device=dev)
    for w in range(W):
        # 32-bit words assembled in int64, then stored as their bit pattern
        acc = torch.zeros((B, P), dtype=torch.int64, device=dev)
        for t in range(min(BASES_PER_WORD, k - w * BASES_PER_WORD)):
            col = w * BASES_PER_WORD + t
            acc |= codes[:, col : col + P] << (2 * (BASES_PER_WORD - 1 - t))
        words[w] = i32_bits(acc)
    colp = torch.arange(P, device=dev)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    fits = colp >= (L - lens) if right_aligned else colp + k <= lens
    cum = torch.cumsum((seqs == N_CODE).to(torch.int32), dim=1)
    hi = cum[:, k - 1 :]
    lo = torch.nn.functional.pad(cum[:, : P - 1], (1, 0))
    return words, fits & (hi == lo)


def _row_diff(s_words: torch.Tensor) -> torch.Tensor:
    """True at each row whose key differs from the previous row's (and at
    row 0)."""
    n = s_words.shape[1]
    diff = torch.ones(n, dtype=torch.bool, device=s_words.device)
    if n > 1:
        diff[1:] = (s_words[:, 1:] != s_words[:, :-1]).any(0)
    return diff


def count_chunk_runs(
    seqs: torch.Tensor, lengths: torch.Tensor, k: int, canonical: bool = False
):
    """Unweighted counting of a read chunk as runs of a sorted key table.

    ``canonical=False``: both strands' k-mers (2 rows per window);
    ``canonical=True``: min(kmer, revcomp(kmer)) per window. Invalid windows
    become the all-ones sentinel, which sorts last; within the all-ones
    block the first rows belong to a real all-T k-mer.

    Returns ``(sorted_words [W, N], run_counts [N] int32, is_start [N],
    is_end [N])``; the i-th True of is_start and of is_end bracket one run.

    The sort is ``psort.sort_words2`` when ``W == 2`` (the CUDA kernel K4
    on a card; the JAX package takes ``bitonic_sort2`` only under its
    ``MITOFLEX_PALLAS_SORT=1`` switch), else ``torch.sort`` passes
    (``psort.lexsort_words``). Both give the same bytes. Unlike the JAX
    path, no padding to a power of two is added, so N is the number of
    windows (the runs are shorter than the JAX runs; the tables pulled from
    them are equal)."""
    rc = revcomp_codes_padfront(seqs)
    w_f, v_f = extract_kmers(seqs, lengths, k)
    w_r, v_r = extract_kmers(rc, lengths, k, right_aligned=True)
    W = w_f.shape[0]
    if canonical:
        # the rc k-mer of forward window j sits at rc column P-1-j
        w_rf = w_r.flip(2)
        take_f = torch.zeros_like(v_f)
        eq = torch.ones_like(v_f)
        for a, b in zip(w_f, w_rf):
            take_f |= eq & ((a ^ psort._SIGN) < (b ^ psort._SIGN))
            eq &= a == b
        take_f |= eq
        words = torch.where(v_f, torch.where(take_f, w_f, w_rf), ALL_ONES)
        words = words.reshape(W, -1)
        valid = v_f.reshape(-1)
    else:
        words = torch.cat([torch.where(v_f, w_f, ALL_ONES),
                           torch.where(v_r, w_r, ALL_ONES)], dim=1).reshape(W, -1)
        valid = torch.cat([v_f, v_r]).reshape(-1)
    if W == 2:
        s_words = psort.sort_words2(words.contiguous())
    else:
        s_words = words[:, psort.lexsort_words(words)]
    n = valid.shape[0]
    pos = torch.arange(n, device=seqs.device)
    all_ones = (s_words == ALL_ONES).all(0)
    n_invalid = (~valid).sum()
    s_valid = ~all_ones | (pos < n - n_invalid)
    diff = _row_diff(s_words)
    is_start = diff & s_valid
    nxt = torch.ones(n, dtype=torch.bool, device=seqs.device)
    nxt[:-1] = diff[1:] | ~s_valid[1:]
    is_end = s_valid & nxt
    run_start = torch.cummax(torch.where(diff, pos, 0), dim=0).values
    counts = (pos - run_start + 1).to(torch.int32)
    return s_words, counts, is_start, is_end


def count_chunk_scattered(
    seqs: torch.Tensor, lengths: torch.Tensor, k: int, canonical: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A chunk's SCATTERED run: each run's count on its last row, zeros
    elsewhere. Unlike the reference no power-of-two padding is added: the
    merge kernel takes any lengths, and pull_scattered drops zero totals."""
    s_words, counts, _is_start, is_end = count_chunk_runs(seqs, lengths, k, canonical)
    return s_words, torch.where(is_end, counts, 0)


def merge_scattered(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two scattered runs ``(words, counts)``: one sorted merge with
    counts as payload (the CUDA merge kernel on a card)."""
    return psort.merge_sorted_runs(a[0], a[1], b[0], b[1])


def pull_scattered(words: torch.Tensor, counts: torch.Tensor
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Host extraction of a scattered run: ONE re-sum per key in uint64 (so
    totals past 2**32 are exact), dropping zero-total keys. Returns
    (keys [U, W] uint32 sorted, counts [U] uint64)."""
    keys = np.ascontiguousarray(u32_numpy(words).T)
    cnt = u32_numpy(counts).astype(np.uint64)
    n = len(cnt)
    if n == 0:
        return keys, cnt
    new = np.empty(n, dtype=bool)
    new[0] = True
    new[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    starts = np.flatnonzero(new)
    totals = np.add.reduceat(cnt, starts)
    keep = totals > 0
    return keys[starts][keep], totals[keep]


def run_totals(words: torch.Tensor, counts: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-key sums of a key-sorted run ``words`` [W, n] with non-negative
    int64 ``counts`` [n]: ``(totals [n], last [n] bool)``, where ``last``
    marks each key's last row and ``totals`` holds the key's sum there.
    Reads nothing back to the host."""
    n = counts.shape[0]
    diff = _row_diff(words)
    cs = torch.cumsum(counts, 0)
    start = torch.cummax(torch.where(diff, cs - counts, 0), 0).values
    last = torch.ones(n, dtype=torch.bool, device=counts.device)
    last[:-1] = diff[1:]
    return cs - start, last


def scattered_totals(words: torch.Tensor, counts: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The half of :func:`scattered_to_unique` that stays on the device:
    ``(totals [n] int64, keep [n] bool)``, ``keep`` marking the rows that
    end a key with a non-zero total."""
    tot, last = run_totals(words, u32_values(counts))
    return tot, last & (tot > 0)


def scattered_to_unique(words: torch.Tensor, counts: torch.Tensor):
    """Compact a SCATTERED run to its sorted unique keys and totals:
    ``(unique [W, U], totals [U] int64, U)``; zero-total keys (invalid
    windows) are dropped. Port of the JAX package's ``scattered_to_unique``
    with exact sizes (no padding rows) and int64 totals of the uint32 row
    counts, which cannot wrap (the reference's int32 cumsum needed totals
    below 2**31)."""
    tot, keep = scattered_totals(words, counts)
    u = words[:, keep]
    return u, tot[keep], u.shape[1]


def sort_count_totals(words: torch.Tensor, valid: torch.Tensor,
                      weights: Optional[torch.Tensor] = None):
    """The half of :func:`sort_count_unique` that stays on the device:
    ``(sorted words [W, n], totals [n] int64, keep [n] bool)`` with the
    valid rows first, ``keep`` marking each valid key's last row."""
    W = words.shape[0]
    flat = words.reshape(W, -1)
    v = valid.reshape(-1)
    if weights is None:
        wt = torch.ones(v.shape[0], dtype=torch.int64, device=v.device)
    else:
        wt = weights.reshape(-1).to(torch.int64)
    # a leading invalid flag word sorts the invalid rows last
    keyed = torch.cat([(~v).to(torch.int32)[None], flat])
    perm = psort.lexsort_words(keyed)
    s, sv = keyed[:, perm], v[perm]
    tot, last = run_totals(s, torch.where(sv, wt[perm], 0))
    return s[1:], tot, last & sv


def sort_count_unique(words: torch.Tensor, valid: torch.Tensor,
                      weights: Optional[torch.Tensor] = None):
    """Sorted unique k-mers of ``words`` [W, ...] where ``valid``, with their
    occurrence counts (or sums of ``weights``): ``(unique [W, U], counts [U]
    int64, U)``. Port of the JAX package's ``sort_count_unique`` with exact
    sizes: no all-ones padding rows after the first U."""
    s, tot, keep = sort_count_totals(words, valid, weights)
    u = s[:, keep]
    return u, tot[keep], u.shape[1]


def _count_weighted(seqs: torch.Tensor, lengths: torch.Tensor, k: int,
                    weights: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Exact both-strand weighted count (contig re-injection): every valid
    window adds its row's weight to its forward and its RC k-mer."""
    rc = revcomp_codes_padfront(seqs)
    w_f, v_f = extract_kmers(seqs, lengths, k)
    w_r, v_r = extract_kmers(rc, lengths, k, right_aligned=True)
    W = w_f.shape[0]
    words = torch.cat([w_f, w_r], dim=1).reshape(W, -1)
    valid = torch.cat([v_f, v_r]).reshape(-1)
    wt = weights.to(torch.int64)[:, None].expand(v_f.shape)
    wt = torch.cat([wt, wt]).reshape(-1)[valid]
    words = words[:, valid]
    perm = psort.lexsort_words(words)
    words, wt = words[:, perm], wt[perm]
    new = _row_diff(words)
    seg = torch.cumsum(new.to(torch.int64), 0) - 1
    totals = torch.zeros(int(new.sum()), dtype=torch.int64, device=seqs.device)
    totals.index_add_(0, seg, wt)
    return (np.ascontiguousarray(u32_numpy(words[:, new]).T),
            totals.cpu().numpy().astype(np.uint64))


def count_chunk_host(
    seqs: np.ndarray, lengths: np.ndarray, k: int,
    weights: Optional[np.ndarray] = None, canonical: bool = False, device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Count a numpy chunk on ``device``; returns (keys [U, W] uint32 sorted,
    counts [U] uint64). Unweighted: run-length counting + boolean-mask
    compaction; weighted (contig re-injection): the exact weighted path."""
    dev = resolve_device(device)
    ds, dl = to_device(seqs, dev), to_device(lengths, dev)
    if weights is not None:
        return _count_weighted(ds, dl, k, to_device(np.asarray(weights, np.int64), dev))
    s_words, counts, is_start, is_end = count_chunk_runs(ds, dl, k, canonical)
    keys = np.ascontiguousarray(u32_numpy(s_words[:, is_start]).T)
    return keys, counts[is_end].cpu().numpy().astype(np.uint64)


def count_chunk_numpy(
    seqs, lengths, k: int, canonical: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy chunk counting for k <= 32 (W <= 2): rolling 2-bit pack
    into uint64, validity via a bad-base cumsum window, value sort +
    run-length count. Same output contract as count_chunk_host; the CPU
    device's hot path (np.sort on packed values beats multi-pass sorts)."""
    seqs = np.asarray(seqs)
    lengths = np.asarray(lengths)
    B, L = seqs.shape
    n = L - k + 1
    W = num_words(k)
    assert W <= 2, "count_chunk_numpy requires k <= 32"
    empty = (np.zeros((0, W), np.uint32), np.zeros(0, np.uint64))
    if B == 0 or n <= 0:
        return empty
    bad = seqs >= 4
    cc = np.where(bad, 0, seqs).astype(np.uint64)
    badc = np.cumsum(bad, axis=1, dtype=np.int32)
    nb = badc[:, k - 1 :].copy()
    nb[:, 1:] -= badc[:, : n - 1]
    valid = (nb == 0) & ((np.arange(n)[None, :] + k) <= lengths[:, None])
    if not valid.any():
        return empty
    v = np.empty((B, n), np.uint64)
    acc = np.zeros(B, np.uint64)
    for i in range(k):
        acc = (acc << np.uint64(2)) | cc[:, i]
    v[:, 0] = acc
    mask = np.uint64((1 << (2 * k)) - 1) if k < 32 else np.uint64(0xFFFFFFFFFFFFFFFF)
    for j in range(1, n):
        acc = ((acc << np.uint64(2)) | cc[:, j + k - 1]) & mask
        v[:, j] = acc
    # reverse-complement windows (rolling from the high end)
    r = np.empty((B, n), np.uint64)
    racc = np.zeros(B, np.uint64)
    for i in range(k - 1, -1, -1):
        racc = (racc << np.uint64(2)) | (np.uint64(3) - cc[:, i])
    r[:, 0] = racc
    top = np.uint64(2 * (k - 1))
    for j in range(1, n):
        racc = (racc >> np.uint64(2)) | (
            (np.uint64(3) - cc[:, j + k - 1]) << top
        )
        r[:, j] = racc
    if canonical:
        np.minimum(v, r, out=v)
        vals = v[valid]
    else:
        vals = np.concatenate([v[valid], r[valid]])
    if k < 32:
        vals <<= np.uint64(2 * (32 - k))  # left-align like the device keys
    vals.sort()
    new = np.empty(len(vals), bool)
    new[0] = True
    np.not_equal(vals[1:], vals[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, len(vals))).astype(np.uint64)
    u = vals[starts]
    keys = np.empty((len(u), W), np.uint32)
    keys[:, 0] = (u >> np.uint64(32)).astype(np.uint32)
    if W == 2:
        keys[:, 1] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return keys, counts


def np_revcomp_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement packed left-aligned k-mer keys [N, W] (host)."""
    N, W = keys.shape
    x = keys ^ np.uint32(0xFFFFFFFF)          # complement every base
    # reverse 2-bit groups within each word
    m2, m4, m8 = np.uint32(0x33333333), np.uint32(0x0F0F0F0F), np.uint32(0x00FF00FF)
    x = ((x & m2) << np.uint32(2)) | ((x >> np.uint32(2)) & m2)
    x = ((x & m4) << np.uint32(4)) | ((x >> np.uint32(4)) & m4)
    x = ((x & m8) << np.uint32(8)) | ((x >> np.uint32(8)) & m8)
    x = (x << np.uint32(16)) | (x >> np.uint32(16))
    x = x[:, ::-1]                            # reverse word order
    # re-left-align: shift the whole multiword left by (16W - k) bases
    s = 2 * (BASES_PER_WORD * W - k)
    ws, bs = divmod(s, 32)
    out = np.zeros_like(x)
    for i in range(W):
        src = i + ws
        if src < W:
            out[:, i] = x[:, src] << np.uint32(bs) if bs else x[:, src]
            if bs and src + 1 < W:
                out[:, i] |= x[:, src + 1] >> np.uint32(32 - bs)
    # zero pad bits beyond base k in the last word
    used = 2 * (k - BASES_PER_WORD * (W - 1))
    if used < 32:
        out[:, W - 1] &= np.uint32(0xFFFFFFFF) << np.uint32(32 - used)
    return out


def expand_canonical(
    keys: np.ndarray, counts: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Expand a canonical (key, count) table to both orientations, SORTED.
    Palindromic k-mers get a single row with DOUBLED count, matching the
    both-strand scheme where each palindromic window contributed two
    identical entries."""
    if len(keys) == 0:
        return keys, counts
    rc = np_revcomp_keys(keys, k)
    palin = (keys == rc).all(axis=1)
    fwd_counts = np.where(palin, counts * 2, counts)
    if keys.shape[1] <= 2:
        p = np.concatenate([np_pack64(keys), np_pack64(rc[~palin])])
        out_counts = np.concatenate([fwd_counts, counts[~palin]])
        order = np.argsort(p, kind="stable")
        return np_unpack64(p[order], keys.shape[1]), out_counts[order]
    out_keys = np.concatenate([keys, rc[~palin]])
    out_counts = np.concatenate([fwd_counts, counts[~palin]])
    order = np.lexsort(
        tuple(out_keys[:, w] for w in range(out_keys.shape[1] - 1, -1, -1))
    )
    return out_keys[order], out_counts[order]


def np_keys_view(keys: np.ndarray) -> np.ndarray:
    """View an [N, W] uint32 key matrix as big-endian void records, so a
    bytewise compare equals the word-wise lexicographic compare."""
    be = np.ascontiguousarray(keys.astype(">u4"))
    return be.view([("k", "V%d" % (keys.shape[1] * 4))]).reshape(-1)


def np_pack64(keys: np.ndarray) -> np.ndarray:
    """Leading 64 bits of each [N, W] key row as native uint64 (word 0 high;
    word 1 low, or zero when W == 1). Order-equivalent to the full key for
    W <= 2."""
    import sys

    if keys.shape[1] > 1 and sys.byteorder == "little":
        sw = np.empty((len(keys), 2), np.uint32)
        sw[:, 0] = keys[:, 1]
        sw[:, 1] = keys[:, 0]
        return sw.view(np.uint64).reshape(-1)
    hi = keys[:, 0].astype(np.uint64) << np.uint64(32)
    if keys.shape[1] > 1:
        return hi | keys[:, 1].astype(np.uint64)
    return hi


def np_unpack64(p: np.ndarray, W: int) -> np.ndarray:
    """Inverse of np_pack64: uint64 -> [N, W] uint32 rows (W <= 2)."""
    import sys

    if W == 2 and sys.byteorder == "little":
        v = p.view(np.uint32).reshape(-1, 2)
        out = np.empty((len(p), 2), np.uint32)
        out[:, 0] = v[:, 1]
        out[:, 1] = v[:, 0]
        return out
    out = np.empty((len(p), W), np.uint32)
    out[:, 0] = (p >> np.uint64(32)).astype(np.uint32)
    if W == 2:
        out[:, 1] = (p & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def np_searchsorted_keys(
    sorted_keys: np.ndarray, queries: np.ndarray, side: str = "left"
) -> np.ndarray:
    """searchsorted for multiword uint32 keys: native uint64 compares on the
    leading 64 bits, refined with a void-record search only for queries
    tied on them (W > 2)."""
    N, W = sorted_keys.shape
    q = np.asarray(queries)
    if N == 0:
        return np.zeros(len(q), np.int64)
    a64 = np_pack64(sorted_keys)
    q64 = np_pack64(q)
    if len(q64) >= (1 << 20):
        # ascending queries make numpy's search gallop near-sequentially
        qo = np.argsort(q64, kind="stable")

        def _search(arr, qq, s):
            out = np.empty(len(qq), np.int64)
            out[qo] = np.searchsorted(arr, qq[qo], side=s)
            return out
    else:
        def _search(arr, qq, s):
            return np.searchsorted(arr, qq, side=s).astype(np.int64)
    if W <= 2:
        return _search(a64, q64, side)
    lo = _search(a64, q64, "left")
    hi = _search(a64, q64, "right")
    out = (lo if side == "left" else hi).astype(np.int64)
    tie = hi > lo
    if tie.any():
        out[tie] = np.searchsorted(
            np_keys_view(sorted_keys), np_keys_view(np.ascontiguousarray(q[tie])),
            side=side,
        )
    return out


def merge_sorted_counts(
    a_keys: np.ndarray, a_counts: np.ndarray, b_keys: np.ndarray, b_counts: np.ndarray,
    op: str = "sum",
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge two sorted (keys [N, W], counts) host runs. op='sum' adds
    counts of equal keys; op='max' keeps the larger (the contig depth
    overlay). Large merges take the native O(n) scan (native/merge.cpp);
    numpy is the fallback."""
    if len(a_keys) == 0:
        return b_keys, b_counts
    if len(b_keys) == 0:
        return a_keys, a_counts
    if op in ("sum", "max") and len(a_keys) + len(b_keys) >= 4096:
        from ..native import merge_native

        nat = merge_native.merge_counts(a_keys, a_counts, b_keys, b_counts, op)
        if nat is not None:
            return nat
    keys = np.concatenate([a_keys, b_keys])
    counts = np.concatenate([a_counts, b_counts]).astype(np.uint64)
    view = np_keys_view(keys)
    order = np.argsort(view, kind="stable")
    sk, sc = keys[order], counts[order]
    sv = view[order]
    new = np.empty(len(sv), dtype=bool)
    new[0] = True
    new[1:] = sv[1:] != sv[:-1]
    seg = np.cumsum(new) - 1
    out_counts = np.zeros(seg[-1] + 1, dtype=np.uint64)
    if op == "sum":
        np.add.at(out_counts, seg, sc)
    elif op == "max":
        np.maximum.at(out_counts, seg, sc)
    else:
        raise ValueError(op)
    return sk[new], out_counts


def unique_words_device(words: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Sorted unique columns of ``words`` [W, n]: ``(unique [W, U], U)``.
    Exact size — no padding rows."""
    s = words[:, psort.lexsort_words(words)]
    new = _row_diff(s)
    u = s[:, new]
    return u, u.shape[1]


def union_ranks(a: torch.Tensor, b: torch.Tensor):
    """The sorted unique columns of the union of ``a`` [W, na], which must
    be sorted already (the k-prefixes of a sorted edge table are), and
    ``b`` [W, nb], with every input column's index in that table:
    ``(unique [W, U], U, rank_a [na], rank_b [nb])``. ``unique`` is what
    ``unique_words_device`` gives for the concatenation.

    Only ``b`` is sorted; the two runs then merge in one pass with each
    column's position as payload (``merge_sorted_runs_onepass``, the CUDA
    kernel K3 on a card), and a column's rank is the number of key changes
    before it in the merged run. No second sort joins the inputs to the
    table."""
    s, new, rank_a, rank_b = union_merge(a, b)
    u = s[:, new]
    return u, u.shape[1], rank_a, rank_b


def union_merge(a: torch.Tensor, b: torch.Tensor):
    """The half of :func:`union_ranks` that stays on the device: ``(merged
    [W, na + nb], new [na + nb] bool, rank_a, rank_b)``; the unique table is
    ``merged[:, new]``."""
    na, nb = a.shape[1], b.shape[1]
    dev = a.device
    perm = psort.lexsort_words(b)
    pos_a = torch.arange(na, dtype=torch.int32, device=dev)[None]
    pos_b = (perm.to(torch.int32) + na)[None]
    s, pos = psort.merge_sorted_runs_onepass(
        a.contiguous(), pos_a, b[:, perm].contiguous(), pos_b)
    new = _row_diff(s)
    rank = torch.empty(na + nb, dtype=torch.int64, device=dev)
    rank[pos[0].to(torch.int64)] = torch.cumsum(new.to(torch.int64), 0) - 1
    return s, new, rank[:na], rank[na:]


def multiword_join_sorted(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """For each query column, the rank of the last row of the sorted-unique
    ``table`` [W, T] whose key is <= the query's (-1 when every table key is
    larger): the table id of every query present in the table.

    One stable lexicographic sort of table + queries puts each equal-key
    table row before its queries; a running max of table ranks along that
    order then reaches every query."""
    T = table.shape[1]
    cat = torch.cat([table, queries], dim=1)
    perm = psort.lexsort_words(cat)
    is_table = perm < T
    rank = torch.cummax(torch.where(is_table, perm, -1), dim=0).values
    out = torch.empty(queries.shape[1], dtype=torch.int64, device=queries.device)
    out[perm[~is_table] - T] = rank[~is_table]
    return out


def multiword_member_sorted(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Whether each query column appears in the sorted-unique ``table``."""
    if table.shape[1] == 0:
        return torch.zeros(queries.shape[1], dtype=torch.bool, device=queries.device)
    idx = multiword_join_sorted(table, queries)
    return (idx >= 0) & (table[:, idx.clamp(min=0)] == queries).all(0)
