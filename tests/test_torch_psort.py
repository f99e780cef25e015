"""Parity of the port's K3 (one-pass merge) and K4 (2-word key sort) with
the JAX package's Pallas kernels run in interpret mode, and of the k-mer
chunk count, which sorts 2-word keys with K4.

Tolerances: keys are integers and are compared exactly. The Pallas merge
leaves equal keys in no set order, so its payloads are compared after the
rows of both outputs are sorted by (keys, payloads); the port's merge puts
run A's rows first on ties and is compared row for row with a stable
lexsort of the concatenation.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitoflex_tpu.ops import kmer as jax_kmer
from mitoflex_tpu.ops import psort as jax_psort
from mitoflex_tpu_torch import convert
from mitoflex_tpu_torch.ops import kmer as port_kmer
from mitoflex_tpu_torch.ops import psort as port_psort
from mitoflex_tpu_torch.testing import kernel_cases
from tests.test_torch_kmer import _reads


N_MERGE_CASES, N_SORT_CASES = 56, 12


@functools.lru_cache(maxsize=None)
def _edge_cases():
    return list(kernel_cases.merge_cases()), list(kernel_cases.sort_cases())


def _bits(x):
    """uint32 array -> int32 tensor of the same bits, same layout."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _words(x):
    """[n, W] uint32 rows -> [W, n] int32 tensor of the same bits."""
    return convert.to_device(np.ascontiguousarray(np.asarray(x, np.uint32).T), "cpu")


def _rows(t):
    """[W, n] int32 tensor -> [n, W] uint32 rows."""
    return np.ascontiguousarray(convert.u32_numpy(t).T)


def _lexsort_rows(rows):
    return np.lexsort(tuple(rows[:, w] for w in range(rows.shape[1] - 1, -1, -1)))


def test_sort_words2_matches_pallas_bitonic_sort2():
    """Exact: K4's plain version and its wrapper on CPU tensors vs the
    Pallas bitonic_sort2 in interpret mode (the shapes of the JAX package's
    own test: duplicates and an all-ones block)."""
    rng = np.random.default_rng(3)
    N, tile = 1 << 15, 1 << 13
    w = rng.integers(0, 2**32, (N, 2), dtype=np.uint64).astype(np.uint32)
    w[:64] = w[64:128]
    w[-32:] = 0xFFFFFFFF
    s0, s1 = jax_psort.bitonic_sort2.__wrapped__(
        jnp.asarray(w[:, 0]), jnp.asarray(w[:, 1]), tile=tile, interpret=True)
    want = np.stack([np.asarray(s0), np.asarray(s1)], axis=1)
    t = _words(w)
    for got in (port_psort.sort_words2_ref(t), port_psort.sort_words2(t)):
        np.testing.assert_array_equal(_rows(got), want)
    np.testing.assert_array_equal(_rows(t), w)  # the input is left as it was


@pytest.mark.parametrize("n", [0, 1, 2047, 2049, 5000])
def test_sort_words2_any_length(n):
    """Exact against numpy's lexsort at lengths that are not powers of two
    (the plain version has no tiles; lengths around the CUDA kernel's
    8192-key tile are in test_sort_edge_cases)."""
    rng = np.random.default_rng(n)
    w = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    w[: n // 3, 0] = 0xFFFFFFFF
    got = _rows(port_psort.sort_words2(_words(w)))
    np.testing.assert_array_equal(got, w[_lexsort_rows(w)])


def _onepass_runs(m, skew, seed):
    """Sorted run of m rows, 2 key words (few distinct high words, an
    all-ones block of real keys) and 1 payload word, as in the JAX
    package's test of merge_sorted_runs_onepass."""
    r = np.random.default_rng(seed)
    k0 = r.integers(0, 60, m, dtype=np.uint64).astype(np.uint32) + skew
    k1 = r.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
    k0[-m // 8:] = 0xFFFFFFFF
    k1[-m // 8:] = 0xFFFFFFFF
    pay = r.integers(0, 2**31, m, dtype=np.uint64).astype(np.uint32)
    order = np.lexsort((k1, k0))
    return np.stack([k0, k1, pay], axis=1)[order]


@pytest.mark.parametrize("m,tile,skew", [(1 << 12, 1 << 10, 0), (512, 256, 0),
                                         (1 << 12, 1 << 12, 1000)])
def test_merge_onepass_matches_pallas(m, tile, skew):
    """K3 plain and its wrapper on CPU tensors vs the Pallas one-pass merge
    in interpret mode: keys exact, payloads equal after both outputs' rows
    are sorted by (keys, payload); the port's rows equal a stable lexsort of
    the concatenation (A's rows first on ties)."""
    rng = np.random.default_rng(17 + m + skew)
    a = _onepass_runs(m, 0, int(rng.integers(1 << 30)))
    b = _onepass_runs(m, skew, int(rng.integers(1 << 30)))
    jout = jax_psort.merge_sorted_runs_onepass.__wrapped__(
        [jnp.asarray(a[:, i]) for i in range(3)],
        [jnp.asarray(b[:, i]) for i in range(3)],
        n_keys=2, tile=tile, interpret=True)
    want = np.stack([np.asarray(x) for x in jout], axis=1)
    cat = np.concatenate([a, b])
    stable = cat[np.lexsort((cat[:, 1], cat[:, 0]))]
    args = (_words(a[:, :2]), _words(a[:, 2:]), _words(b[:, :2]), _words(b[:, 2:]))
    for fn in (port_psort.merge_sorted_runs_onepass_ref,
               port_psort.merge_sorted_runs_onepass):
        keys, pays = fn(*args)
        got = np.concatenate([_rows(keys), _rows(pays)], axis=1)
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_array_equal(got[_lexsort_rows(got)], want[_lexsort_rows(want)])
        np.testing.assert_array_equal(got, stable)


@pytest.mark.parametrize("P", [0, 2])
def test_merge_onepass_payload_words_and_unequal_lengths(P):
    """Row for row: runs of unequal, non-power-of-two lengths with 0 or 2
    payload words merge into the stable lexsort of their concatenation."""
    rng = np.random.default_rng(P)

    def run(m):
        x = rng.integers(0, 2**32, (m, 2 + P), dtype=np.uint64).astype(np.uint32)
        x[:, 0] = rng.integers(0, 4, m)
        return x[np.lexsort((x[:, 1], x[:, 0]))]

    a, b = run(300), run(77)
    keys, pays = port_psort.merge_sorted_runs_onepass(
        _words(a[:, :2]), _words(a[:, 2:]), _words(b[:, :2]), _words(b[:, 2:]))
    assert tuple(pays.shape) == (P, 377)
    cat = np.concatenate([a, b])
    want = cat[np.lexsort((cat[:, 1], cat[:, 0]))]
    np.testing.assert_array_equal(_rows(keys), want[:, :2])
    if P:
        np.testing.assert_array_equal(_rows(pays), want[:, 2:])


@pytest.mark.parametrize("canonical", [True, False])
def test_count_chunk_runs_sorts_2word_keys_with_k4(monkeypatch, canonical):
    """Exact: the port's chunk count sends its 2-word keys (k + 1 = 32, with
    N bases and an all-T read) through sort_words2, and its pulled table
    equals the JAX count_chunk_host with its default sort and with
    MITOFLEX_PALLAS_SORT=1 and bitonic_sort2 in interpret mode."""
    kp1 = 32
    seqs, lens = _reads(kp1)
    calls = []
    sort_words2 = port_psort.sort_words2

    def counted(words):
        calls.append(words.shape[1])
        return sort_words2(words)

    monkeypatch.setattr(port_psort, "sort_words2", counted)
    runs = port_kmer.count_chunk_runs(torch.from_numpy(seqs), torch.from_numpy(lens),
                                      kp1, canonical)
    got = port_kmer.count_chunk_host(seqs, lens, kp1, canonical=canonical)
    windows = seqs.shape[0] * (seqs.shape[1] - kp1 + 1) * (1 if canonical else 2)
    assert calls == [windows, windows] and runs[0].shape[1] == windows

    monkeypatch.setattr(jax_psort, "bitonic_sort2", functools.partial(
        jax_psort.bitonic_sort2.__wrapped__, interpret=True))
    for switch in (None, "1"):
        if switch is None:
            monkeypatch.delenv("MITOFLEX_PALLAS_SORT", raising=False)
        else:
            monkeypatch.setenv("MITOFLEX_PALLAS_SORT", switch)
        jax_kmer.count_chunk_runs.clear_cache()
        try:
            want = jax_kmer.count_chunk_host(seqs, lens, kp1, canonical=canonical)
        finally:
            jax_kmer.count_chunk_runs.clear_cache()
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("W", [2, 4])
def test_union_ranks_is_unique_of_concatenation(W):
    """Exact: the graph pass's node table (a one-pass merge of a sorted run
    with a long tie block and an unsorted one, positions as payload) equals
    the sorted unique columns of the concatenation, and every input
    column's rank is its index there."""
    rng = np.random.default_rng(W)
    a = rng.integers(0, 2**32, (700, W), dtype=np.uint64).astype(np.uint32)
    a[:, 0] = rng.integers(0, 8, 700)
    a[100:300] = a[100]  # a long run of one key, as prefixes of a branch
    a = a[_lexsort_rows(a)]
    b = np.concatenate([a[::3], rng.integers(0, 2**32, (300, W), dtype=np.uint64)
                        .astype(np.uint32)])
    b = b[rng.permutation(len(b))]
    got, n, rank_a, rank_b = port_kmer.union_ranks(_words(a), _words(b))
    want, wn = port_kmer.unique_words_device(torch.cat([_words(a), _words(b)], dim=1))
    assert n == wn and torch.equal(got, want)
    table = _rows(got)
    np.testing.assert_array_equal(table[rank_a.numpy()], a)
    np.testing.assert_array_equal(table[rank_b.numpy()], b)


@pytest.mark.parametrize("i", range(N_MERGE_CASES))
def test_merge_edge_cases(i):
    """Row for row: the shapes the redesigned merge tile makes risky (run
    lengths of tile - 1, tile and tile + 1 rows, an empty run, 1 to 16 key
    words, 0 to 4 payload words, rows that tie deep into the key, more than
    a tile of one key) through K3's wrapper and plain version, and K2's
    where there is one payload word, against numpy's stable lexsort of the
    concatenation. On the CPU the wrappers take the plain versions; the
    smoke run on a card runs the same cases through the kernels."""
    name, ak, ap, bk, bp = _edge_cases()[0][i]
    want_keys, want_pays = kernel_cases.merged(ak, ap, bk, bp)
    args = [_bits(x) for x in (ak, ap, bk, bp)]
    for fn in (port_psort.merge_sorted_runs_onepass_ref,
               port_psort.merge_sorted_runs_onepass):
        keys, pays = fn(*args)
        np.testing.assert_array_equal(convert.u32_numpy(keys), want_keys, err_msg=name)
        np.testing.assert_array_equal(convert.u32_numpy(pays), want_pays, err_msg=name)
    if ap.shape[0] == 1:
        keys, vals = port_psort.merge_sorted_runs(args[0], args[1][0], args[2], args[3][0])
        np.testing.assert_array_equal(convert.u32_numpy(keys), want_keys, err_msg=name)
        np.testing.assert_array_equal(convert.u32_numpy(vals), want_pays[0], err_msg=name)


@pytest.mark.parametrize("i", range(N_SORT_CASES))
def test_sort_edge_cases(i):
    """Exact: sort lengths around the 16-key thread run and the 8192-key
    block tile of the redesigned K4 (and no multiple of either), duplicates,
    all-ones keys and more than a tile of one key, against numpy."""
    name, words = _edge_cases()[1][i]
    want = words[:, kernel_cases.lexsort_columns(words)]
    for fn in (port_psort.sort_words2_ref, port_psort.sort_words2):
        np.testing.assert_array_equal(convert.u32_numpy(fn(_bits(words))), want,
                                      err_msg=name)


def test_edge_case_catalogue_and_tile_sizes():
    """The catalogue has the sizes the two tests above index, is the same
    on every call, and is built around the tile sizes the kernels use."""
    merges, sorts = _edge_cases()
    assert (len(merges), len(sorts)) == (N_MERGE_CASES, N_SORT_CASES)
    again = list(kernel_cases.merge_cases())
    assert all(np.array_equal(x, y) for a, b in zip(merges, again)
               for x, y in zip(a[1:], b[1:]))
    assert port_psort.SORT_TILE_KEYS == 8192
    assert [port_psort.merge_tile_rows(W, P) for W, P in
            ((1, 0), (2, 1), (2, 2), (4, 1), (8, 1), (8, 4), (16, 4))] == \
        [4096, 4096, 2048, 2048, 1024, 1024, 512]
    names = [m[0] for m in merges]
    assert "W=16 P=4 513+511" in names and "W=2 P=1 0+4097" in names
