"""Seeded inputs at the shapes the merge and sort kernels find hardest.

Run lengths sit around the kernels' tile sizes (tile - 1, tile, tile + 1,
an empty run), rows tie in their leading words or in all of them, a whole
tile holds one key, and the widest rows (16 key words, 4 payload words) are
covered. The CPU tests run these through the plain versions; the smoke run
on a card runs the same cases through the kernels and holds them against
the plain versions.

The cases are numpy: uint32 arrays in the wrappers' word-major layout
(``[W, n]`` keys, ``[P, n]`` payloads). :func:`check_wrappers` runs them all
through the wrappers of ``ops/psort.py`` on a device.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..ops.psort import SORT_TILE_KEYS, merge_tile_rows

MergeCase = Tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def lexsort_columns(words: np.ndarray) -> np.ndarray:
    """Stable permutation putting the columns of ``words`` [W, n] in
    unsigned lexicographic order."""
    if words.shape[0] == 0:
        return np.arange(words.shape[1])
    return np.lexsort(tuple(words[w] for w in range(words.shape[0] - 1, -1, -1)))


def sorted_run(rng: np.random.Generator, n: int, W: int, P: int,
               equal: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A sorted run of n rows. All key words but the last come from three
    values (so rows tie deep into the key), the last from n / 4 + 1 values
    (so whole keys recur); ``equal`` rows hold one key. Payloads are
    random."""
    keys = rng.choice(np.array([0, 5, 0xFFFFFFFF], np.uint32), size=(W, n))
    keys[W - 1] = rng.integers(0, n // 4 + 1, n)
    if equal:
        keys[:, :equal] = np.uint32(5)
    pays = rng.integers(0, 2**32, (P, n), dtype=np.uint64).astype(np.uint32)
    order = lexsort_columns(keys)
    return np.ascontiguousarray(keys[:, order]), np.ascontiguousarray(pays[:, order])


def merge_cases(seed: int = 0) -> Iterator[MergeCase]:
    """(name, a_keys, a_pays, b_keys, b_pays) for the one-pass merge (K3);
    K2 takes the P = 1 cases with its payload as a vector."""
    rng = np.random.default_rng(seed)
    for W, P in ((2, 1), (2, 0), (1, 0), (4, 1), (8, 1), (3, 2), (16, 4)):
        R = merge_tile_rows(W, P)
        lengths = [(R - 1, R // 2 + 3), (R, R), (R + 1, R - 1), (0, R + 1),
                   (R, 0), (1, 1), (3 * R + 5, 2 * R - 7)]
        for na, nb in lengths:
            a = sorted_run(rng, na, W, P)
            b = sorted_run(rng, nb, W, P)
            yield (f"W={W} P={P} {na}+{nb}", *a, *b)
        # more than a tile of one key in each run
        a = sorted_run(rng, 2 * R + 10, W, P, equal=R + 10)
        b = sorted_run(rng, 2 * R - 3, W, P, equal=R + 1)
        yield (f"W={W} P={P} equal-key tile", *a, *b)


def merged(a_keys, a_pays, b_keys, b_pays) -> Tuple[np.ndarray, np.ndarray]:
    """What a merge must return: the stable lexsort of the concatenation
    (equal keys keep run A's rows first)."""
    keys = np.concatenate([a_keys, b_keys], axis=1)
    pays = np.concatenate([a_pays, b_pays], axis=1)
    order = lexsort_columns(keys)
    return keys[:, order], pays[:, order]


def sort_cases(seed: int = 0) -> Iterator[Tuple[str, np.ndarray]]:
    """(name, words [2, n]) for the 2-word key sort (K4): lengths around
    the per-thread run (16) and the block tile, duplicates, all-ones keys,
    and more than a tile of one key."""
    rng = np.random.default_rng(seed)
    T = SORT_TILE_KEYS
    for n in (0, 1, 15, 16, 17, T - 1, T, T + 1, 2 * T, 3 * T + 5, 5 * T - 1):
        words = rng.integers(0, 2**32, (2, n), dtype=np.uint64).astype(np.uint32)
        words[0, : n // 2] = rng.integers(0, 3, n // 2)
        words[:, n // 3: n // 3 + n // 8] = 0xFFFFFFFF
        yield f"n={n}", words
    words = rng.integers(0, 2**32, (2, 2 * T + 100), dtype=np.uint64).astype(np.uint32)
    words[:, 17: 17 + T + 50] = words[:, :1]
    yield f"n={2 * T + 100} with {T + 50} equal keys", words


def check_wrappers(device) -> int:
    """Run every case through ``psort``'s wrappers on ``device`` (a card:
    the kernels; the CPU: the plain versions) and hold the results against
    the plain versions on the same tensors: K3 row for row, K2 (the cases
    with one payload word) against the same stable merge, K4 byte for byte.
    Raises AssertionError on the first difference; returns the number of
    cases."""
    import torch

    from ..ops import psort

    def on_device(x):
        return torch.from_numpy(x.view(np.int32)).to(device)

    n_cases = 0
    for name, *arrays in merge_cases():
        runs = [on_device(x) for x in arrays]
        got = psort.merge_sorted_runs_onepass(*runs)
        want = psort.merge_sorted_runs_onepass_ref(*runs)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K3 differs from its plain version: {name}")
        if runs[1].shape[0] == 1:
            got = psort.merge_sorted_runs(runs[0], runs[1][0], runs[2], runs[3][0])
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1][0])):
                raise AssertionError(f"K2 differs from the stable merge: {name}")
        n_cases += 1
    for name, words in sort_cases():
        w = on_device(words)
        if not torch.equal(psort.sort_words2(w), psort.sort_words2_ref(w)):
            raise AssertionError(f"K4 differs from its plain version: {name}")
        n_cases += 1
    return n_cases
