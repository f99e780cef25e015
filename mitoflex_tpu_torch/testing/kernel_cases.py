"""Seeded inputs at the shapes the kernels find hardest.

Run lengths sit around the kernels' tile sizes (tile - 1, tile, tile + 1,
an empty run), rows tie in their leading words or in all of them, a whole
tile holds one key, and the widest rows (16 key words, 4 payload words) are
covered. The CPU tests run these through the plain versions; the smoke run
on a card runs the same cases through the kernels and holds them against
the plain versions.

The cases are numpy: uint32 arrays in the wrappers' word-major layout
(``[W, n]`` keys, ``[P, n]`` payloads). :func:`check_wrappers` runs them all
through the wrappers of ``ops/psort.py`` on a device; :func:`filter_cases`
and :func:`check_filter` do the same for the read filter of ``ops/filter.py``
(row widths on both of its paths, edge lengths, odd codes and valves), and
:func:`viterbi_cases` and :func:`check_viterbi` for the two Viterbi passes of
``ops/phmm.py``, :func:`sw_cases` and :func:`check_sw` for the
Smith-Waterman of ``ops/sw.py``, :func:`cyk_cases` and :func:`check_cyk`
for the banded CYK of ``ops/cyk_device.py``, and :func:`genewise_cases` and
:func:`check_genewise` for the frameshift DP of ``ops/genewise.py``.
"""

from __future__ import annotations

import functools
import io
from typing import Iterator, NamedTuple, Tuple

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


# ------------------------------------------------------------- K1 cases
# the read filter's two hash bases (ops/filter.py)
HASH_B1, HASH_B2 = 0x01000193, 0x85EBCA6B


def regrouped_hashes(seqs: np.ndarray, lengths: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The two hashes of ``seqs`` [B, L] (L a multiple of 16) summed in the
    kernel's order: per group g of 16 columns, ``sum_t (code + 1) * B**t``
    with the columns past the length contributing 0, times ``B**(16 g)``
    built from the bits of g; all in wrapping uint32. Returns uint32
    arrays."""
    B, L = seqs.shape
    G = L // 16
    assert L == 16 * G and G <= 32
    valid = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
    v = np.where(valid, seqs.astype(np.int64) + 1, 0).astype(np.uint32)
    v = v.reshape(B, G, 16)
    out = []
    with np.errstate(over="ignore"):
        for base in (HASH_B1, HASH_B2):
            small = np.array([pow(base, t, 1 << 32) for t in range(16)], np.uint32)
            inner = (v * small[None, None, :]).sum(2, dtype=np.uint32)
            scale = np.ones(G, np.uint32)
            for bit in range(5):
                c = np.uint32(pow(base, 16 << bit, 1 << 32))
                sel = (np.arange(G) >> bit) & 1 == 1
                scale[sel] = scale[sel] * c
            out.append((inner * scale[None, :]).sum(1, dtype=np.uint32))
    return out[0], out[1]


def kernel_cutoffs(cutoff_lengths: np.ndarray, percentage_valve: float) -> np.ndarray:
    """numpy model of the cutoff as the kernel takes it per read: the
    length converted to float32, one float32 multiply rounded to nearest
    (no contraction), floor, then int32."""
    prod = np.asarray(cutoff_lengths).astype(np.float32) * np.float32(percentage_valve)
    return np.floor(prod).astype(np.int32)


FilterCase = Tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray, tuple]


def filter_cases(seed: int = 2026) -> Iterator[FilterCase]:
    """(name, seqs, quals, lengths, mate lengths, (ns_valve, quality_valve,
    percentage_valve)) for the read filter: row widths that take the vector
    path with one, ten, sixteen and thirty-two lanes a read, widths that
    take the scalar path (no multiple of 16, wider than 512), lengths 0 and
    L, rows of N, negative codes, and valves at and past the int8 range."""
    rng = np.random.default_rng(seed)
    for B, L in ((4099, 256), (1537, 160), (700, 16), (513, 512), (301, 100),
                 (130, 528), (64, 48)):
        seqs = rng.integers(0, 5, size=(B, L)).astype(np.int8)
        quals = rng.integers(33, 75, size=(B, L)).astype(np.int8)
        lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
        lengths[:4] = (0, L, 1, min(L, 17))
        seqs[4] = 4
        seqs[5] = rng.integers(-128, 128, size=L).astype(np.int8)
        quals[6] = rng.integers(-128, 128, size=L).astype(np.int8)
        mate = rng.permutation(lengths).astype(np.int32)
        for args in ((10, 55, 0.2), (0, 40, 1 / 3), (3, 127, 0.999),
                     (300, 200, 0.5), (2, -128, 0.1), (2, -129, 0.1)):
            yield f"{B}x{L} valves {args}", seqs, quals, lengths, mate, args


def check_filter(device) -> int:
    """Every case of :func:`filter_cases` through ``ops.filter.filter_reads``
    on ``device``: with its own and with the mate's lengths as the cutoff
    lengths, on rows as they are (the vector path where the width allows
    it) and on the same rows one byte off 16-byte alignment (the scalar
    path at every width). Bit-equal to
    ``filter_reads_ref`` or AssertionError; returns the number of cases."""
    import torch

    from ..ops import filter as F

    n_cases = 0
    for name, seqs, quals, lengths, mate, args in filter_cases():
        t = [torch.from_numpy(x).to(device) for x in (seqs, quals, lengths, mate)]
        B, L = seqs.shape
        # the same rows one byte into a larger buffer: no 16-byte alignment
        off = [torch.empty(B * L + 1, dtype=torch.int8, device=device)[1:].view(B, L)
               for _ in range(2)]
        off[0].copy_(t[0])
        off[1].copy_(t[1])
        for cl in (None, t[3]):
            want = F.filter_reads_ref(*t[:3], *args, cl)
            for what, got in (
                ("aligned rows", F.filter_reads(*t[:3], *args, cl)),
                ("unaligned rows", F.filter_reads(*off, t[2], *args, cl)),
            ):
                for field, g, w in zip(("keep", "h1", "h2"), got, want):
                    if not torch.equal(g, w):
                        raise AssertionError(
                            f"K1 {field} differs from filter_reads_ref ({what}, "
                            f"{'PE' if cl is not None else 'SE'} cutoffs): {name}")
        n_cases += 1
    return n_cases


# ------------------------------------------------------- Viterbi cases
ViterbiCase = Tuple[str, dict, np.ndarray, np.ndarray, np.ndarray]
VITERBI_BANDS = (16, 10, 0)


def _viterbi_profiles(rng: np.random.Generator, lens, pad_to: int, quantised: bool,
                      cheap_deletes: bool) -> Tuple[dict, np.ndarray, list]:
    """Stacked profile arrays (numpy float32, a leading model axis) of
    models of lengths ``lens`` in one shape bucket, their lengths and
    consensus codes. Scores are perturbed per column; ``quantised`` rounds
    every real score to 0.5 bits, so that candidates tie in M, I and D and
    the per-column best ties across columns; ``cheap_deletes`` makes long
    delete chains pay, so that the closure's band decides the result."""
    from ..io import encoding
    from ..models.hmm import profile_from_consensus
    from ..ops import phmm
    from . import synth

    arrays, cons = [], []
    Lp = max(lens)
    if pad_to:
        Lp = -(-Lp // pad_to) * pad_to
    else:
        Lp = max(128, 1 << (Lp - 1).bit_length())
    for i, L in enumerate(lens):
        c = synth.random_genome(rng, L)
        cons.append(encoding.encode(c))
        prof = phmm.stage_profile(profile_from_consensus(f"V{i}", c), pad_to=Lp,
                                  device="cpu")
        a = {f: getattr(prof, f).numpy().copy() for f in phmm.DeviceProfile._fields[:-1]}
        real = np.arange(Lp) < L
        for f in ("msc", "isc", "tmm", "tim", "tdm", "tmi", "tii", "tmd"):
            noise = rng.normal(0.0, 0.4, a[f].shape).astype(np.float32)
            a[f] = np.where(real.reshape((-1,) + (1,) * (a[f].ndim - 1)), a[f] + noise, a[f])
        tdd = np.full(L, -0.15 if cheap_deletes else -2.3, np.float32) \
            + rng.normal(0.0, 0.05, L).astype(np.float32)
        if cheap_deletes:
            a["tmd"][:L] = -1.0
            a["tdm"][:L] = -0.5
        a["cdd"][:L] = np.cumsum(np.minimum(tdd, 0))
        if quantised:
            for f in a:
                if f == "entry":
                    continue
                q = np.round(a[f] * 2) / 2 + np.float32(0.0)  # no -0.0
                a[f] = np.where(np.arange(Lp).reshape((-1,) + (1,) * (a[f].ndim - 1)) < L,
                                q, a[f]).astype(np.float32)
            a["entry"] = np.float32(np.round(a["entry"] * 2) / 2)
        arrays.append(a)
    stacked = {f: np.ascontiguousarray(np.stack([a[f] for a in arrays]).astype(np.float32))
               for f in arrays[0]}
    return stacked, np.asarray(lens, np.int32), cons


def _viterbi_windows(rng: np.random.Generator, cons: list, B: int, T: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Windows [B, T] int8 with planted, mutated copies of the consensus
    (some missing a run of columns, so the delete chain carries the path),
    and lengths [B]: row 0 spans T; then, where B allows, a row of length
    0, a row of N, lengths past T and negative, odd codes."""
    seqs = rng.integers(0, 4, (B, T)).astype(np.int8)
    lens = rng.integers(T // 2, T + 1, B).astype(np.int32)
    lens[0] = T
    for i in range(B):
        c = np.array(cons[i % len(cons)], np.int8)
        if i % 2 and len(c) > 30:
            cut = int(rng.integers(5, len(c) - 20))
            c = np.concatenate([c[:cut], c[cut + int(rng.integers(4, min(40, len(c) // 3))):]])
        c[rng.integers(0, len(c), 3)] = rng.integers(0, 4, 3)
        at = int(rng.integers(0, max(1, T - len(c))))
        seqs[i, at: at + len(c)] = c[: T - at]
    edge = [(1, lambda: lens.__setitem__(1, 0)),
            (2, lambda: seqs.__setitem__(2, 4)),
            (3, lambda: lens.__setitem__(3, T + 7)),
            (4, lambda: lens.__setitem__(4, -1)),
            (5, lambda: seqs[5].__setitem__(slice(3, 9), (-3, 9, 4, 127, -128, 5)))]
    for row, make in edge:
        if row < B:
            make()
    return seqs, lens


def _flat_viterbi_case(rng: np.random.Generator, Lp: int, lens, B: int, T: int):
    """Stacked arrays of models whose columns inside the model are all alike
    (0.5-bit scores, free deletes: cdd flat at 0), and windows of one code,
    of two codes in turn and at random: M, the closure's inputs and the
    per-column bests tie across every stage and cluster-block boundary, for
    the banded closure's rightmost and the exact closure's leftmost rule and
    for the final pick's first column."""
    from ..ops import phmm

    arrays = {f: [] for f in phmm.DeviceProfile._fields[:-1]}
    col = {"tmm": -0.5, "tim": -1.0, "tdm": -1.0, "tmi": -2.0, "tii": -1.0, "tmd": -1.5,
           "cdd": 0.0}
    for L in lens:
        real = np.arange(Lp) < L
        msc = np.where(real[:, None], np.float32([1.5, -1.0, -1.0, 0.5]), np.float32(phmm.NEG))
        arrays["msc"].append(msc.astype(np.float32))
        arrays["isc"].append(np.where(real[:, None], np.full(4, -0.5, np.float32),
                                      np.float32(phmm.NEG)).astype(np.float32))
        for f, v in col.items():
            arrays[f].append(np.where(real, np.float32(v), np.float32(phmm.NEG))
                             .astype(np.float32))
        arrays["entry"].append(np.float32(np.round(np.log2(2.0 / (L * (L + 1))) * 2) / 2))
    stacked = {f: np.ascontiguousarray(np.stack(v).astype(np.float32))
               for f, v in arrays.items()}
    seqs = rng.integers(0, 4, (B, T)).astype(np.int8)
    seqs[0] = 0
    if B > 1:
        seqs[1] = np.arange(T) % 2 * 3
    lens_w = np.full(B, T, np.int32)
    return stacked, np.asarray(lens, np.int32), seqs, lens_w


def viterbi_cases(seed: int = 2027) -> Iterator[ViterbiCase]:
    """(name, stacked profile arrays, model lengths, windows, lengths) for
    both Viterbi passes: padded lengths 64 to 8192, models shorter than and
    as long as the padded length, model lengths one column before, on and
    after the boundaries of 64- to 1024-column stages and cluster blocks
    (the kernel's layouts), profiles quantised to 0.5 bits, cheap deletes
    (so bands cross stage boundaries), a flat profile whose values tie
    across every boundary, one window, rows of length 0 and of N, lengths
    past T and negative, odd codes; long rows at the small widths, short
    ones at the large widths. Every case has fewer rows than a card has
    SMs. Each case runs at every band of ``VITERBI_BANDS``."""
    rng = np.random.default_rng(seed)
    specs = (  # name, model lengths, pad_to, quantised, cheap deletes, B, T
        ("Lp 128, L 70/128, real scores", (70, 128), 0, False, False, 8, 128),
        ("Lp 128, L 64/128, 0.5-bit scores", (64, 128), 0, True, False, 8, 128),
        ("Lp 128, L 90/128, 0.5-bit scores, cheap deletes", (90, 128), 0, True, True, 8, 128),
        ("Lp 128, L 100, one window", (100,), 0, True, False, 1, 128),
        ("Lp 64 = L (pad_to 32), cheap deletes", (64, 50), 32, False, True, 8, 128),
        ("Lp 1024, L 950, 0.5-bit scores", (950, 1024), 0, True, True, 3, 24),
        ("Lp 2048, L 1100/2048, 0.5-bit scores", (1100, 2048), 0, True, True, 6, 20),
        ("Lp 256, L 63/64/65/127/128/129 (stage edges)", (63, 64, 65, 127, 128, 129, 256),
         256, True, True, 3, 40),
        ("Lp 1024, L 255/256/257/511/512/513 (stage and block edges)",
         (255, 256, 257, 511, 512, 513), 1024, True, True, 2, 24),
        ("Lp 2048, L 1023/1024/1025 (block edges)", (1023, 1024, 1025), 0, True, True, 2, 16),
        ("Lp 4096, L 4096/3000", (4096, 3000), 0, True, True, 2, 12),
        ("Lp 8192, L 8192/5000", (8192, 5000), 0, True, True, 2, 10),
    )
    for name, lens, pad_to, quant, cheap, B, T in specs:
        arrays, mlens, cons = _viterbi_profiles(rng, lens, pad_to, quant, cheap)
        seqs, wl = _viterbi_windows(rng, cons, B, T)
        yield name, arrays, mlens, seqs, wl
    for Lp, lens, B, T in ((256, (256, 130, 64), 3, 48), (2048, (2048, 1024), 2, 24)):
        arrays, mlens, seqs, wl = _flat_viterbi_case(rng, Lp, lens, B, T)
        yield (f"Lp {Lp}, flat profile L {'/'.join(map(str, lens))}: ties across every "
               f"boundary"), arrays, mlens, seqs, wl


def _profile(arrays: dict, m, device):
    """Model ``m`` of the stacked arrays (``None``: the whole stack) as the
    port's ``DeviceProfile`` on ``device``."""
    import torch

    from ..ops import phmm

    pick = (lambda x: x) if m is None else (lambda x: x[m])
    return phmm.DeviceProfile(*(torch.from_numpy(np.array(pick(arrays[f]), np.float32))
                                .to(device) for f in phmm.DeviceProfile._fields[:-1]), 0)


def viterbi_layouts(device, Lp: int, band: int, scan: bool) -> list:
    """The kernel layouts the check forces at this width and band: every one
    ``ops.phmm.viterbi_config`` can pick on this card (none on the CPU,
    where the wrappers take the plain versions)."""
    import torch

    from ..ops import phmm

    dev = torch.device(device)
    if dev.type != "cuda":
        return [None]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return phmm.viterbi_configs(Lp, phmm.closure_window(band, scores=not scan), scan, sms)


def check_viterbi(device) -> Tuple[int, int]:
    """Every case of :func:`viterbi_cases` at every band through both
    passes of ``ops.phmm`` on ``device`` (a card: the kernel, at every
    layout of :func:`viterbi_layouts`), held against the plain versions on
    the same tensors: scores bit for bit (float32 bits), every coordinate
    exact. The scan runs each model of the case alone. Raises
    AssertionError on the first difference; returns the number of (case,
    band) pairs and of kernel calls compared."""
    import torch

    from ..ops import phmm

    def bits(x):
        return x.contiguous().view(torch.int32)

    n_cases = n_calls = 0
    for name, arrays, mlens, seqs, wl in viterbi_cases():
        s, l = torch.from_numpy(seqs).to(device), torch.from_numpy(wl).to(device)
        stack = _profile(arrays, None, device)
        Lp = stack.msc.shape[1]
        for band in VITERBI_BANDS:
            want = phmm.viterbi_scores_multi_plain(stack, mlens.tolist(), s, l, band)
            for cfg in viterbi_layouts(device, Lp, band, scan=False):
                got = phmm.viterbi_scores_multi(stack, mlens.tolist(), s, l, band,
                                                _config=cfg)
                n_calls += 1
                if not torch.equal(bits(got), bits(want)):
                    raise AssertionError(f"viterbi_scores_multi differs from its plain "
                                         f"version: {name}, band {band}, layout {cfg}")
            for m, L in enumerate(mlens.tolist()):
                prof = _profile(arrays, m, device)
                want = phmm.viterbi_scan_plain(prof, s, l, L, band)
                for cfg in viterbi_layouts(device, Lp, band, scan=True):
                    got = phmm.viterbi_scan(prof, s, l, L, band, _config=cfg)
                    n_calls += 1
                    for field, g, w in zip(phmm.HmmHits._fields, got, want):
                        if not torch.equal(bits(g), bits(w)):
                            raise AssertionError(
                                f"viterbi_scan {field} differs from its plain version: "
                                f"{name}, model {m}, band {band}, layout {cfg}")
            n_cases += 1
    return n_cases, n_calls


# ------------------------------------------- the DP pipeline's order of work
# csrc/row_pipeline.cuh: stage s of a round starts this many steps after
# stage s - 1 in the model's schedule (lane 31 posts position t at step
# t + 31; the next stage reads it at its step t)
PIPE_STAGE_LAG = 33


def _cells(shape, v, N: int):
    """A cell array: values [shape] float32 and path words [shape, N] uint32."""
    return [np.full(shape, v, np.float32), np.zeros(tuple(shape) + (N,), np.uint32)]


def _sel(p, a, b):
    return [np.where(p, a[0], b[0]), np.where(p[..., None], a[1], b[1])]


def _tree(state, fn, other=None):
    """``fn`` over the arrays of a model state (dicts and lists of arrays),
    with the matching array of ``other`` where given."""
    if isinstance(state, dict):
        return {k: _tree(v, fn, None if other is None else other[k]) for k, v in state.items()}
    if isinstance(state, list):
        return [_tree(v, fn, None if other is None else other[i]) for i, v in enumerate(state)]
    return fn(state) if other is None else fn(state, other)


def _put(w, o: int, c) -> None:
    w[..., o] = c[0].view(np.uint32)
    w[..., o + 1: o + 1 + c[1].shape[-1]] = c[1]


def _get(w, o: int, N: int):
    return [np.ascontiguousarray(w[..., o]).view(np.float32), w[..., o + 1: o + 1 + N].copy()]


class _SwModel:
    """csrc/sw.cu's recurrence on [S, 32, B] lanes (SwRec): path words packed
    (qs | ts << 16, id | nc << 16, go | gc << 16) or wide (six words)."""

    stop = False

    def __init__(self, C: int, R: int, wide: bool, gap_open: float, gap_extend: float):
        self.C, self.R, self.wide = C, R, wide
        self.N = 6 if wide else 3
        self.row = 2 * (1 + self.N)
        self.slot = R * self.row
        self.go, self.ge = np.float32(gap_open), np.float32(gap_extend)

    def fresh(self, j, t):
        j = np.asarray(j, np.uint32)
        t = np.asarray(t, np.uint32)
        z = np.zeros(np.broadcast(j, t).shape, np.uint32)
        if self.wide:
            return np.stack([j + z, t + z, z, z, z, z], -1)
        return np.stack([(j | (t << np.uint32(16))) + z, z, z], -1)

    def diag(self, w, match) -> None:
        m = match.astype(np.uint32)
        if self.wide:
            w[..., 2] += m
            w[..., 3] += np.uint32(1)
        else:
            w[..., 1] += m + np.uint32(1 << 16)

    def gap(self, w, opened) -> None:
        o = opened.astype(np.uint32)
        if self.wide:
            w[..., 3] += np.uint32(1)
            w[..., 4] += o
            w[..., 5] += np.uint32(1)
        else:
            w[..., 1] += np.uint32(1 << 16)
            w[..., 2] += o + np.uint32(1 << 16)

    def field(self, w, f: int):
        if self.wide:
            return w[..., f].astype(np.int64)
        x = w[..., f >> 1]
        return (x >> np.uint32(16) if f & 1 else x & np.uint32(0xFFFF)).astype(np.int64)

    def reset(self, shape) -> dict:
        N, R = self.N, self.R
        return {"H": [_cells(shape, 0.0, N) for _ in range(self.C)],
                "E": [_cells(shape, -1e30, N) for _ in range(self.C)],
                "lF": [_cells(shape, -1e30, N) for _ in range(R)],
                "fo": [_cells(shape, -1e30, N) for _ in range(R)],
                "lH": [_cells(shape, 0.0, N) for _ in range(R)],
                "ho": [_cells(shape, 0.0, N) for _ in range(R)],
                "dg": _cells(shape, 0.0, N)}

    def take(self, L: dict, w, m) -> None:
        for r in range(self.R):
            o = r * self.row
            L["lF"][r] = _sel(m, _get(w, o, self.N), L["lF"][r])
            L["lH"][r] = _sel(m, _get(w, o + 1 + self.N, self.N), L["lH"][r])

    def put(self, L: dict, w) -> None:
        for r in range(self.R):
            _put(w, r * self.row, L["fo"][r])
            _put(w, r * self.row + 1 + self.N, L["ho"][r])

    def step(self, L: dict, offer, act, u, j0, qlen, tlen, xs, qc, ss) -> None:
        for r in range(self.R):
            self._row(L, offer, act, u * self.R + r, j0, qlen, tlen, xs[r], qc, ss[r],
                      L["dg"] if r == 0 else L["lH"][r - 1], r)
        L["dg"] = _sel(act, L["lH"][self.R - 1], L["dg"])

    def _row(self, L: dict, offer, act, t, j0, qlen, tlen, x, qc, s, dg, r) -> None:
        f = L["lF"][r]
        for c in range(self.C):
            j = j0 + c
            m = act & (j < qlen)
            h_old, E = L["H"][c], L["E"][c]
            e_open, e_ext = h_old[0] - self.go, E[0] - self.ge
            eo = e_open >= e_ext
            e = _sel(eo, h_old, E)
            e[0] = np.where(eo, e_open, e_ext)
            self.gap(e[1], eo)
            fresh = dg[0] <= 0
            d = [dg[0], np.where(fresh[..., None], self.fresh(j, t), dg[1])]
            cand = np.where(fresh, np.float32(0), dg[0]) + s[c]
            self.diag(d[1], qc[c] == x)
            ud = cand >= e[0]
            hp = _sel(ud, d, e)
            hp[0] = np.where(ud, cand, e[0])
            h = _sel(f[0] > hp[0], f, hp)
            h[0] = np.maximum(h[0], np.float32(0))
            offer(m & (t < tlen), h, j, t)
            f_ext, f_open = f[0] - self.ge, hp[0] - self.go
            fo = ~(f_ext >= f_open)
            nf = _sel(fo, hp, f)
            nf[0] = np.where(fo, f_open, f_ext)
            self.gap(nf[1], fo)
            L["E"][c] = _sel(m, e, E)
            L["H"][c] = _sel(m, h, h_old)
            f = _sel(m, nf, f)
            dg = _sel(m, h_old, dg)
        L["fo"][r] = _sel(act, f, L["fo"][r])
        L["ho"][r] = _sel(act, L["H"][self.C - 1], L["ho"][r])

    def answer(self, v, j, t, w) -> tuple:
        i32 = np.int32
        return (v, self.field(w, 0).astype(i32), j.astype(i32), self.field(w, 1).astype(i32),
                t.astype(i32), *(self.field(w, f).astype(i32) for f in (2, 3, 4, 5)))


class _WiseModel:
    """csrc/genewise.cu's recurrence on [S, 32, B] lanes (WiseRec): H at
    p0-1 .. p0-5 and E at p0-1 .. p0-3 of each lane's columns and of the
    column on its left before a block of R bases; inside the block the
    cells of its earlier bases; path words packed (qs | ts << 16, shifts)
    or wide (three words)."""

    stop = True

    def __init__(self, C: int, R: int, wide: bool, gap_open: float, gap_extend: float,
                 fs_penalty: float):
        self.C, self.R, self.wide = C, R, wide
        self.N = 3 if wide else 2
        self.row = 3 * (1 + self.N)
        self.slot = R * self.row
        self.go, self.ge = np.float32(gap_open), np.float32(gap_extend)
        self.fs = np.float32(fs_penalty)

    def fresh(self, j, t):
        j = np.asarray(j, np.uint32)
        ts = np.maximum(np.asarray(t, np.int64) - 2, 0).astype(np.uint32)
        z = np.zeros(np.broadcast(j, ts).shape, np.uint32)
        if self.wide:
            return np.stack([j + z, ts + z, z], -1)
        return np.stack([(j | (ts << np.uint32(16))) + z, z], -1)

    def field(self, w, f: int):
        if self.wide:
            return w[..., f].astype(np.int64)
        if f == 2:
            return w[..., 1].astype(np.int64)
        return (w[..., 0] >> np.uint32(16) if f else w[..., 0] & np.uint32(0xFFFF)) \
            .astype(np.int64)

    def reset(self, shape) -> dict:
        N, R, neg = self.N, self.R, -1e30
        return {"Hh": [[_cells(shape, neg, N) for _ in range(5)] for _ in range(self.C)],
                "Eh": [[_cells(shape, neg, N) for _ in range(3)] for _ in range(self.C)],
                "Lh": [_cells(shape, neg, N) for _ in range(5)],
                "Le": [_cells(shape, neg, N) for _ in range(3)],
                **{k: [_cells(shape, neg, N) for _ in range(R)]
                   for k in ("lF", "pH", "pE", "fo", "ho", "eo")}}

    def take(self, L: dict, w, m) -> None:
        for r in range(self.R):
            for i, k in enumerate(("lF", "pH", "pE")):
                L[k][r] = _sel(m, _get(w, r * self.row + i * (1 + self.N), self.N), L[k][r])

    def put(self, L: dict, w) -> None:
        for r in range(self.R):
            for i, k in enumerate(("fo", "ho", "eo")):
                _put(w, r * self.row + i * (1 + self.N), L[k][r])

    def step(self, L: dict, offer, act, u, j0, qlen, tlen, xs, qc, ss) -> None:
        N, R, C, neg = self.N, self.R, self.C, np.float32(-1e30)
        hn = [[None] * C for _ in range(R)]
        en = [[None] * C for _ in range(R)]
        for r in range(R):
            t = u * R + r
            f = L["lF"][r]
            for c in range(C):
                j = j0 + c
                m = act & (j < qlen)

                def back(i, cur, left, hist_c, hist_l):
                    # column c - 1 (the left column for c == 0) at base p0 + i
                    if i >= 0:
                        return left[i] if c == 0 else cur[i][c - 1]
                    return hist_l[-i - 1] if c == 0 else hist_c[c - 1][-i - 1]

                a = [np.zeros(m.shape, np.float32),
                     np.broadcast_to(self.fresh(j, t), m.shape + (N,)).copy()]
                for dt in (3, 1, 2, 4, 5):
                    hp = back(r - dt, hn, L["pH"], L["Hh"], L["Lh"])
                    cand = np.where(hp[0] <= 0, neg, hp[0]) - (np.float32(0) if dt == 3 else self.fs)
                    o = [hp[0], hp[1].copy()]
                    if dt != 3:
                        o[1][..., N - 1] += np.uint32(1)
                    take = cand > a[0]
                    a = _sel(take, o, a)
                    a[0] = np.where(take, cand, a[0])
                el = back(r - 3, en, L["pE"], L["Eh"], L["Le"])
                a = _sel(el[0] > a[0], el, a)
                i3 = r - 3
                h3 = hn[i3][c] if i3 >= 0 else L["Hh"][c][-i3 - 1]
                e3 = en[i3][c] if i3 >= 0 else L["Eh"][c][-i3 - 1]
                e_open, e_ext = h3[0] - self.go, e3[0] - self.ge
                eo = e_open >= e_ext
                e = _sel(eo, h3, e3)
                e[0] = np.where(eo, e_open, e_ext)
                hc = [ss[r][c] + a[0], a[1]]
                h = _sel(f[0] > hc[0], f, hc)
                h[0] = np.maximum(h[0], neg)
                offer(m & (t < tlen), h, j, t)
                f_ext, f_open = f[0] - self.ge, hc[0] - self.go
                fo = ~(f_ext >= f_open)
                nf = _sel(fo, hc, f)
                nf[0] = np.where(fo, f_open, f_ext)
                f = _sel(m, nf, f)
                negc = _cells(m.shape, neg, N)
                hn[r][c] = _sel(m, h, negc)
                en[r][c] = _sel(m, e, negc)
            L["fo"][r] = _sel(act, f, L["fo"][r])
            L["ho"][r] = _sel(act, hn[r][C - 1], L["ho"][r])
            L["eo"][r] = _sel(act, en[r][C - 1], L["eo"][r])
        # the histories move on R bases (the newest first)
        for c in range(C):
            L["Hh"][c] = [_sel(act, hn[R - 1 - k][c] if k < R else L["Hh"][c][k - R],
                               L["Hh"][c][k]) for k in range(5)]
            L["Eh"][c] = [_sel(act, en[R - 1 - k][c] if k < R else L["Eh"][c][k - R],
                               L["Eh"][c][k]) for k in range(3)]
        L["Lh"] = [_sel(act, L["pH"][R - 1 - k] if k < R else L["Lh"][k - R], L["Lh"][k])
                   for k in range(5)]
        L["Le"] = [_sel(act, L["pE"][R - 1 - k] if k < R else L["Le"][k - R], L["Le"][k])
                   for k in range(3)]

    def answer(self, v, j, t, w) -> tuple:
        i32 = np.int32
        return (v, self.field(w, 0).astype(i32), j.astype(i32), self.field(w, 1).astype(i32),
                t.astype(i32), self.field(w, 2).astype(i32))


def _pipeline_model(rec, queries, q_lens, targets, t_lens, submat, layout,
                    stop_code: int = 0, stop_penalty: float = 0.0) -> tuple:
    """numpy model of csrc/row_pipeline.cuh's order of work for recurrence
    ``rec`` at ``layout`` (an ``ops.row_pipeline.PipelineConfig``: columns a
    lane, positions a lane a step, the pair's stages warps x cluster; rings
    of KERNEL_DEPTH slots). Rounds run one after another; in a round every
    stage runs in lockstep, stage s PIPE_STAGE_LAG steps behind stage s - 1,
    its lane l on block st - l (``rows`` positions). Lane 0 reads the left's slot for its position from
    its inbound ring (slot seq % depth, tagged seq + 1; acked) or, in stage
    0 after the first round, from the [B, Lt, slot] scratch row (tagged with
    the round); lane 31 of a full strip posts into the next stage's ring
    (after the ack shows slot seq + 1 - depth consumed) or the scratch row
    (tagged round + 1); every lane's slot goes to lane + 1. Each read checks
    its tags, each post its ack: the model raises AssertionError where the
    kernel would wait. The answer: each lane's best (greater, or equal in an
    earlier column), then the first column of the maximum over the lanes."""
    f32 = np.float32
    from ..ops.row_pipeline import KERNEL_DEPTH as depth

    C, S, R = layout.cols, layout.warps * layout.cluster, layout.rows
    sub = np.asarray(submat, np.float32)
    K = sub.shape[0]
    tab = np.concatenate([sub, np.full((K, 1), -f32(stop_penalty), np.float32)], 1) \
        if rec.stop else sub
    q = np.asarray(queries).astype(np.int64)
    x_all = np.asarray(targets).astype(np.int64)
    B, Lq = q.shape
    Lt = x_all.shape[1]
    ql = np.clip(np.asarray(q_lens, np.int64), 0, Lq)
    tl = np.clip(np.asarray(t_lens, np.int64), 0, Lt)
    Wd, N, W = 32 * C, rec.N, rec.slot
    nstrips = -(-ql // Wd)
    nblk = -(-tl // R)
    shape = (S, 32, B)
    lanes = np.arange(32)
    sidx = np.arange(S)
    bv = np.zeros(shape, np.float32)
    bj = np.zeros(shape, np.int64)
    bt = np.zeros(shape, np.int64)
    bw = np.zeros(shape + (N,), np.uint32)

    ring = np.zeros((S, depth, B, W), np.uint64)   # each stage's inbound ring
    acked = np.zeros((S, B), np.int64)             # slots stage s has consumed
    seq_in = np.zeros((S, B), np.int64)
    seq_out = np.zeros((S, B), np.int64)
    scratch = np.zeros((B, max(-(-Lt // R), 1), W), np.uint64)
    hi_bits = np.uint64(32)
    for rd in range(int(-(-nstrips.max() // S)) if B else 0):
        strip = rd * S + sidx
        part = strip[:, None] < nstrips[None, :]                      # [S, B]
        s0 = strip * Wd
        last_lane = (np.minimum(ql[None, :] - s0[:, None], Wd) - 1) // C
        more = strip[:, None] + 1 < nstrips[None, :]
        to_ring = more & (sidx + 1 < S)[:, None]
        to_scr = more & (sidx + 1 == S)[:, None]
        j0 = (s0[:, None] + lanes[None, :] * C)[:, :, None]           # [S, 32, 1]
        qc = [np.where(j0 + c < ql, q[np.arange(B), np.minimum(j0 + c, Lq - 1)]
                       .clip(0, K - 1), 0) for c in range(C)]
        L = rec.reset(shape)
        steps = np.where(part, nblk[None, :] + last_lane, 0)
        for tau in range(int((PIPE_STAGE_LAG * sidx[:, None] + steps).max())):
            st_all = tau - PIPE_STAGE_LAG * sidx
            run_all = part & (st_all[:, None] >= 0) & (st_all[:, None] < steps)
            rs = np.nonzero(run_all.any(1))[0]
            if not len(rs):
                continue
            # the stages running at this step (the others' state is untouched)
            lo, hi = int(rs[0]), int(rs[-1]) + 1
            sl = slice(lo, hi)
            st, running = st_all[sl], run_all[sl]
            shp = (hi - lo, 32, B)
            u = (st[:, None] - lanes[None, :])[:, :, None]             # [s, 32, 1]
            act = running[:, None, :] & (lanes[None, :, None] <= last_lane[sl, None, :]) \
                & (u >= 0) & (u < nblk[None, None, :])
            Ls = _tree(L, lambda x: x[sl])
            # lane 0: the left's slot at position st
            reads = running & (st[:, None] < nblk[None, :])
            w0 = np.zeros(shp + (W,), np.uint32)
            m0 = np.zeros(shp, bool)
            si, bi = np.nonzero(reads & (sidx[sl] > 0)[:, None])
            if len(si):
                seq = seq_in[si + lo, bi]
                words = ring[si + lo, seq % depth, bi]
                assert ((words >> hi_bits) == (seq + 1)[:, None].astype(np.uint64)).all(), \
                    "a ring slot read before its post"
                w0[si, 0, bi] = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                m0[si, 0, bi] = True
                acked[si + lo, bi] = seq + 1
                seq_in[si + lo, bi] = seq + 1
            bi = np.nonzero(reads[0])[0] if rd > 0 and lo == 0 else ()
            if len(bi):
                words = scratch[bi, st[0]]
                assert ((words >> hi_bits) == np.uint64(rd)).all(), \
                    "a scratch slot read too early"
                w0[0, 0, bi] = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                m0[0, 0, bi] = True
            rec.take(Ls, w0, m0)
            # the lanes' columns; codes outside the target read 0
            qs = [c[sl] for c in qc]
            xs, ss = [], []
            for r in range(R):
                tr = u * R + r
                tc = np.clip(tr, 0, max(Lt - 1, 0))
                x = x_all[np.arange(B)[None, None, :], tc] if Lt else np.zeros(shp, np.int64)
                x = np.where((tr >= 0) & (tr < tl[None, None, :]), x, 0)
                xi = np.clip(x, 0, K - 1)
                if rec.stop:
                    xi = np.where(x == stop_code, K, xi)
                xs.append(x)
                ss.append([tab[qs[c], xi] for c in range(C)])
            best = (bv[sl], bj[sl], bt[sl], bw[sl])

            def offer(m, h, j, tt, best=best):
                v, jb, tb, wb = best
                better = m & ((h[0] > v) | ((h[0] == v) & (j < jb)))
                v[...] = np.where(better, h[0], v)
                jb[...] = np.where(better, j, jb)
                tb[...] = np.where(better, tt, tb)
                wb[...] = np.where(better[..., None], h[1], wb)

            rec.step(Ls, offer, act, u, j0[sl], ql[None, None, :], tl[None, None, :], xs, qs,
                     ss)
            # lane 31's post, then every lane's slot to the next lane
            w = np.zeros(shp + (W,), np.uint32)
            rec.put(Ls, w)
            post = act[:, 31, :]
            si, bi = np.nonzero(post & to_ring[sl])
            if len(si):
                seq = seq_out[si + lo, bi]
                assert (acked[si + lo + 1, bi] >= seq + 1 - depth).all(), "a ring slot overrun"
                ring[si + lo + 1, seq % depth, bi] = \
                    ((seq + 1).astype(np.uint64)[:, None] << hi_bits) \
                    | w[si, 31, bi].astype(np.uint64)
                seq_out[si + lo, bi] = seq + 1
            si, bi = np.nonzero(post & to_scr[sl])
            if len(si):
                scratch[bi, u[si, 31, 0]] = (np.uint64(rd + 1) << hi_bits) \
                    | w[si, 31, bi].astype(np.uint64)
            shifted = np.zeros_like(w)
            shifted[:, 1:] = w[:, :-1]
            m1 = np.broadcast_to(running[:, None, :], shp).copy()
            m1[:, 0] = False
            rec.take(Ls, shifted, m1)
            _tree(L, lambda x, y: x.__setitem__(sl, y), Ls)
    # the first column of the maximum over the pair's lanes
    v = bv.reshape(-1, B)
    top = v == v.max(0)
    jj = np.where(top, bj.reshape(-1, B), np.iinfo(np.int64).max)
    k = np.argmin(jj, 0)
    cols = np.arange(B)
    return rec.answer(v[k, cols], bj.reshape(-1, B)[k, cols], bt.reshape(-1, B)[k, cols],
                      bw.reshape(-1, B, N)[k, cols])


def sw_kernel_model(queries, q_lens, targets, t_lens, submat, gap_open, gap_extend,
                    layout) -> tuple:
    """numpy model of csrc/sw.cu at ``layout`` (``_pipeline_model``), every
    sum a float32 operation and the path fields in the layout's words.
    Returns the nine ``SwHits`` fields as numpy arrays (score float32, the
    rest int32)."""
    return _pipeline_model(_SwModel(layout.cols, layout.rows, layout.wide, gap_open, gap_extend),
                           queries, q_lens, targets, t_lens, submat, layout)


# ------------------------------------------------ Smith-Waterman cases
SwCase = Tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, float, float]
# the query length of the blastn-size case (a whole contig against a window)
SW_BLASTN_LQ = 16500
# the long tier-1 case's query (its best alignment starts past 2^15) and the
# card's case over the packed path fields' limit (Lq + Lt > 65,535)
SW_LONG_LQ = 33000
SW_WIDE_LQ = 65600


def _sw_pairs(rng: np.random.Generator, q_lens, t_lens, K: int, fill: int,
              copies: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Queries and targets [B, max length] int8 padded with ``fill``: random
    codes below K - 1, and in every target but each fourth ``copies``
    mutated copies of its query (a substitution pair, a 3-residue insertion
    and a 2-residue deletion) where they fit."""
    q_lens = np.asarray(q_lens, np.int32)
    t_lens = np.asarray(t_lens, np.int32)
    B = len(q_lens)
    q = np.full((B, max(int(q_lens.max()), 1)), fill, np.int8)
    t = np.full((B, max(int(t_lens.max()), 1)), fill, np.int8)
    for i in range(B):
        qi = rng.integers(0, K - 1, q_lens[i]).astype(np.int8)
        ti = rng.integers(0, K - 1, t_lens[i]).astype(np.int8)
        if i % 4 != 3 and q_lens[i] > 4:
            h = int(q_lens[i]) // 2
            core = np.concatenate([qi[:h], rng.integers(0, K - 1, 3), qi[h + 2:]]).astype(np.int8)
            core[rng.integers(0, len(core), 2)] = rng.integers(0, K - 1, 2)
            room = int(t_lens[i]) - copies * len(core)
            at = int(rng.integers(0, room + 1)) if room > 0 else 0
            for _ in range(copies):
                ti[at: at + len(core)] = core[: max(int(t_lens[i]) - at, 0)]
                at += len(core)
        q[i, : q_lens[i]] = qi
        t[i, : t_lens[i]] = ti
    return q, q_lens, t, t_lens


def sw_cases(seed: int = 2028, card_size: bool = True) -> Iterator[SwCase]:
    """(name, queries, q_lens, targets, t_lens, matrix, gap_open,
    gap_extend) for ``sw_align``: BLOSUM62 at (12, 1) and the nucleotide
    matrix at (7, 2) and (11, 1) on mutated copies; one query column; rows
    with q_len 0 and t_len 0; all-N and all-X rows; odd codes (negative and
    >= K); tandem repeats, whose best cells tie; a target holding its query
    twice; open == extend; query lengths on both sides of the kernel's
    lanes and strips at 1, 2 and 4 columns a lane (1 to 257); a
    33,000-column query whose best alignment starts past column 2^15 (its
    packed path fields' 16-bit halves); and, with ``card_size``, a
    16,500-column contig against 300-base windows (the blastn size) and a
    65,600-column query against 200 bases (over the packed fields' limit,
    so the wide instantiation)."""
    from ..io import encoding
    from ..models import codon
    from ..ops import sw

    rng = np.random.default_rng(seed)
    aa, naa, X = codon.blosum62().astype(np.float32), codon.NUM_AA, codon.X_CODE
    nt, N = sw.nucleotide_matrix().astype(np.float32), encoding.N

    ql = rng.integers(40, 101, 8)
    yield ("BLOSUM62 (12, 1), mutated copies", *_sw_pairs(rng, ql, ql + 60, naa, X),
           aa, 12.0, 1.0)
    ql = rng.integers(8, 71, 8)
    yield ("DNA (7, 2), mutated copies",
           *_sw_pairs(rng, ql, rng.integers(8, 121, 8), 5, N), nt, 7.0, 2.0)
    ql = rng.integers(8, 71, 8)
    yield ("DNA (11, 1), mutated copies",
           *_sw_pairs(rng, ql, rng.integers(8, 121, 8), 5, N), nt, 11.0, 1.0)

    q = np.array([[0], [1], [4], [2]], np.int8)
    t = rng.integers(0, 4, (4, 9)).astype(np.int8)
    t[3] = 2
    yield ("Lq 1", q, np.array([1, 1, 1, 1], np.int32), t,
           np.array([9, 5, 9, 1], np.int32), nt, 7.0, 2.0)

    q, _, t, _ = _sw_pairs(rng, [30] * 4, [50] * 4, 5, N)
    yield ("rows with q_len 0 and t_len 0", q, np.array([0, 30, 30, 0], np.int32), t,
           np.array([50, 0, 50, 0], np.int32), nt, 7.0, 2.0)

    q, ql, t, tl = _sw_pairs(rng, [40] * 4, [80] * 4, 5, N)
    q[0] = N
    t[1] = N
    yield ("all-N rows", q, ql, t, tl, nt, 7.0, 2.0)
    q, ql, t, tl = _sw_pairs(rng, [40] * 4, [80] * 4, naa, X)
    q[0] = X
    t[1] = X
    yield ("all-X rows", q, ql, t, tl, aa, 12.0, 1.0)

    q, ql, t, tl = _sw_pairs(rng, [40] * 4, [80] * 4, naa, X)
    q[:, 3:9] = np.array([-3, naa, naa + 7, 127, -128, -1], np.int8)
    t[:, 20:26] = np.array([-3, naa, naa + 7, 127, -128, -1], np.int8)
    t[2, 40:46] = q[2, 3:9]
    yield ("odd codes (negative, >= K)", q, ql, t, tl, aa, 12.0, 1.0)

    unit = np.array([0, 1, 2, 3, 0, 1], np.int8)
    q = np.stack([np.tile(unit, 8), np.tile(unit[:3], 16), np.tile(unit, 8),
                  np.tile(unit[:2], 24)])
    t = np.stack([np.tile(unit, 15)[:90], np.tile(unit[:3], 30), np.tile(unit[:4], 23)[:90],
                  np.tile(unit[:2], 45)])
    yield ("tandem repeats (tied best cells)", q, np.array([48, 48, 48, 48], np.int32), t,
           np.array([90, 90, 90, 77], np.int32), nt, 7.0, 2.0)

    ql = rng.integers(20, 41, 4)
    yield ("target holding its query twice",
           *_sw_pairs(rng, ql, 2 * ql + 30, 5, N, copies=2), nt, 7.0, 2.0)
    ql = rng.integers(20, 61, 8)
    yield ("open == extend (3, 3)", *_sw_pairs(rng, ql, ql + 40, 5, N), nt, 3.0, 3.0)

    ql = np.array([125, 126, 127, 128, 128, 4, 5, 3])
    yield ("Lq 128 wide: one strip", *_sw_pairs(rng, ql, rng.integers(100, 200, 8), 5, N),
           nt, 7.0, 2.0)
    ql = np.array([257, 256, 255, 129, 128, 127, 5, 4, 3, 1])
    yield ("Lq 257 wide: 1 to 3 strips", *_sw_pairs(rng, ql, ql + rng.integers(0, 60, 10),
                                                   naa, X), aa, 12.0, 1.0)
    q = rng.integers(0, 4, (1, SW_LONG_LQ)).astype(np.int8)
    t = q[:, SW_LONG_LQ - 14: SW_LONG_LQ + 2].copy()
    t = np.concatenate([t, rng.integers(0, 4, (1, 16 - t.shape[1])).astype(np.int8)], 1)
    t[0, 7] = (t[0, 7] + 1) % 4
    yield (f"Lq {SW_LONG_LQ} x Lt 16: path fields past 2^15", q,
           np.array([SW_LONG_LQ], np.int32), t, np.array([16], np.int32), nt, 7.0, 2.0)
    if card_size:
        contig = rng.integers(0, 4, SW_BLASTN_LQ).astype(np.int8)
        q = np.stack([contig, contig])
        t = np.stack([contig[9000:9300].copy(), rng.integers(0, 4, 300).astype(np.int8)])
        t[0, 100:104] = (t[0, 100:104] + 1) % 4
        t[0, 200:203] = N
        yield ("blastn size: 16,500-column contig vs 300-base windows", q,
               np.array([SW_BLASTN_LQ, SW_BLASTN_LQ], np.int32), t,
               np.array([300, 297], np.int32), nt, 7.0, 2.0)
        q = rng.integers(0, 4, (1, SW_WIDE_LQ)).astype(np.int8)
        t = rng.integers(0, 4, (1, 200)).astype(np.int8)
        t[0, 40:160] = q[0, SW_WIDE_LQ - 130: SW_WIDE_LQ - 10]
        t[0, 90:93] = N
        yield (f"over the packing limit: Lq {SW_WIDE_LQ} x Lt 200", q,
               np.array([SW_WIDE_LQ], np.int32), t, np.array([200], np.int32), nt, 7.0, 2.0)


def sw_tensors(case: SwCase, device) -> tuple:
    """A case's (queries, q_lens, targets, t_lens, matrix) as tensors on
    ``device`` and its gap costs."""
    import torch

    _, q, ql, t, tl, sub, go, ge = case
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (q, ql, t, tl, sub)), go, ge


# a layout of two stages that wraps a query of more than 64 columns round
# through the scratch row (the chooser gives a pair as many stages as its
# strips where it can, so only very long queries wrap)
WRAP_LAYOUT = (1, 2, 1, False)


def pipeline_layouts(configs: list, own, wrap: bool = True) -> list:
    """The layouts a check forces on a case: ``configs`` (every one the
    chooser weighs at its widths, one an instantiation), the wide
    instantiation at ``own`` (the chooser's pick for the case) where that is
    packed, and, with ``wrap``, WRAP_LAYOUT at one and at two target
    positions a step (packed where the widths allow it; it wraps round a
    query over 64 columns)."""
    from ..ops.row_pipeline import PipelineConfig

    out = list(configs)
    if not own.wide:
        out.append(own._replace(wide=True))
    if wrap:
        for rows in (1, 2):
            cfg = PipelineConfig(*WRAP_LAYOUT)._replace(wide=own.wide, rows=rows)
            if cfg not in out:
                out.append(cfg)
    return out


def sw_layouts(device, case: SwCase) -> list:
    """The kernel layouts the check forces on a case (``pipeline_layouts``
    at the chooser's layouts for its widths; none on the CPU, where the
    wrapper takes the plain version)."""
    import torch

    from ..ops import sw

    if torch.device(device).type != "cuda":
        return [None]
    _, q, _, t, _, _, _, _ = case
    Lq, Lt = q.shape[1], t.shape[1]
    return pipeline_layouts(sw.sw_configs(Lq, Lt), sw.sw_config(Lq, Lt),
                            wrap=Lq < SW_BLASTN_LQ)


def check_sw(device, card_size: bool = True) -> Tuple[int, int]:
    """Every case of :func:`sw_cases` through ``ops.sw.sw_align`` on
    ``device`` (a card: the kernel, at every layout of :func:`sw_layouts`),
    held against ``sw_align_plain`` on the same tensors: all nine fields
    bit for bit (the score as float32 bits). Raises AssertionError on the
    first difference; returns the numbers of cases and of calls."""
    import torch

    from ..ops import sw

    n_cases = n_calls = 0
    for case in sw_cases(card_size=card_size):
        args, go, ge = sw_tensors(case, device)
        want = sw.sw_align_plain(*args, go, ge)
        for cfg in sw_layouts(device, case):
            got = sw.sw_align(*args, go, ge, _config=cfg)
            n_calls += 1
            for field, g, w in zip(sw.SwHits._fields, got, want):
                if not torch.equal(g.contiguous().view(torch.int32),
                                   w.contiguous().view(torch.int32)):
                    raise AssertionError(f"sw_align {field} differs from its plain version: "
                                         f"{case[0]}, layout {cfg}")
        n_cases += 1
    return n_cases, n_calls


# ------------------------------------------------- Smith-Waterman scores
# (name, queries [Q, Lq] int8, q_lens [Q], q_index [B], targets [T] int8,
# t_offsets [B + 1], matrix, gap_open, gap_extend): the arguments of
# ``ops.sw.sw_scores``
ScoreCase = Tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                  np.ndarray, float, float]
# the merge's circle on the card (16,033 bases) and the draft's window law
SW_SCORE_CIRCLE = 16033


def _ends(rows) -> Tuple[np.ndarray, np.ndarray]:
    """Rows end to end (int8) and their offsets."""
    lens = [len(r) for r in rows]
    cat = np.concatenate([np.asarray(r, np.int8) for r in rows]) if rows else \
        np.zeros(0, np.int8)
    return cat.astype(np.int8), np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


def score_case(case: SwCase) -> ScoreCase:
    """An ``sw_cases`` case as ``sw_scores`` takes it: each pair its own
    query, the targets cut to their lengths and laid end to end, the table
    made symmetric (the port's BLOSUM62 differs from its transpose in one
    pair of entries, which the score kernel refuses) by the smaller of
    each pair."""
    name, q, ql, t, tl, sub, go, ge = case
    cat, offs = _ends([t[i, : max(int(n), 0)] for i, n in enumerate(tl)])
    return (name, q, ql, np.arange(len(q), dtype=np.int64), cat, offs,
            np.minimum(sub, sub.T), go, ge)


def _revcomp(codes: np.ndarray) -> np.ndarray:
    from ..io import encoding

    return np.asarray(encoding.revcomp(codes), np.int8)


def _merge_windows(rng: np.random.Generator, circle: np.ndarray, lens) -> list:
    """Windows of the given lengths as the merge's blastn sees them: random
    contigs, each fourth holding a mutated stretch of the circle, each
    third on the minus strand, each fifth with a run of N codes."""
    from ..io import encoding

    out = []
    for i, n in enumerate(lens):
        w = rng.integers(0, 4, int(n)).astype(np.int8)
        if i % 4 == 0 and n > 60:
            k = int(rng.integers(50, min(int(n), 2000) + 1))
            at = int(rng.integers(0, len(circle) - k))
            piece = circle[at: at + k].copy()
            piece[rng.integers(0, k, k // 30 + 1)] = rng.integers(0, 4, k // 30 + 1)
            pos = int(rng.integers(0, int(n) - k + 1))
            w[pos: pos + k] = piece
        if i % 3 == 0:
            w = _revcomp(w)
        if i % 5 == 0 and n > 40:
            at = int(rng.integers(0, int(n) - 20))
            w[at: at + 17] = encoding.N
        out.append(w)
    return out


def sw_score_cases(seed: int = 2033, card_size: bool = True) -> Iterator[ScoreCase]:
    """Cases for ``sw_scores``: every ``sw_cases`` case; a 1,500-base query
    against windows of 50 to 700 (the query along the stream) and the
    reverse, 40 to 300-base queries against targets of 600 to 1,400 longer
    than every query (the query streamed though it is the shorter side);
    sides past one tile (512 columns) and past two, with N runs; empty rows;
    pairs that score twice their length; a shared query set; and, with
    ``card_size``, the merge's shape (the 16,033-base circle against 48
    windows of 200 to 20,000, both strands, N runs) and the int32 extremes
    (entries, gap costs and scores at the kernel's limits)."""
    from ..io import encoding
    from ..ops import sw

    for case in sw_cases(card_size=False):
        yield score_case(case)
    rng = np.random.default_rng(seed)
    nt, N = sw.nucleotide_matrix().astype(np.float32), encoding.N

    def queries(rows):
        q, ql = np.full((len(rows), max(max(len(r) for r in rows), 1)), N, np.int8), []
        for i, r in enumerate(rows):
            q[i, : len(r)] = r
            ql.append(len(r))
        return q, np.array(ql, np.int32)

    big = rng.integers(0, 4, 1500).astype(np.int8)
    wins = _merge_windows(rng, big, rng.integers(50, 701, 10))
    q, ql = queries([big])
    yield ("one 1,500-base query against windows of 50-700", q, ql,
           np.zeros(len(wins), np.int64), *_ends(wins), nt, 7.0, 2.0)
    small = [rng.integers(0, 4, int(n)).astype(np.int8) for n in rng.integers(40, 301, 6)]
    tgts = []
    for i, s in enumerate(small):
        t = rng.integers(0, 4, int(rng.integers(600, 1401))).astype(np.int8)
        at = int(rng.integers(0, len(t) - len(s)))
        t[at: at + len(s)] = s if i % 2 else _revcomp(s)
        tgts.append(t)
    q, ql = queries(small)
    yield ("queries of 40-300 against longer targets of 600-1,400", q, ql,
           np.arange(len(small), dtype=np.int64), *_ends(tgts), nt, 7.0, 2.0)
    a = rng.integers(0, 4, 1300).astype(np.int8)
    b = np.concatenate([rng.integers(0, 4, 200), a[100:1100],
                        rng.integers(0, 4, 150)]).astype(np.int8)
    b[rng.integers(0, len(b), 40)] = rng.integers(0, 4, 40)
    b[500:512] = N
    q, ql = queries([a, b])
    c = np.concatenate([a[:700], rng.integers(0, 4, 20), a[700:]]).astype(np.int8)
    yield ("sides past one and two tiles, N runs", q, ql, np.array([0, 1, 0, 1], np.int64),
           *_ends([b, a, c, _revcomp(c)]), nt, 11.0, 1.0)
    q, ql = queries([a[:300], a[:0], a[:5]])
    yield ("empty rows", q, ql, np.array([1, 0, 1, 2, 0], np.int64),
           *_ends([a[:40], a[:0], a[:0], a[:5], a[:300]]), nt, 7.0, 2.0)
    twin = [a[:n] for n in (1, 31, 32, 33, 128, 129, 511, 512, 513)]
    q, ql = queries(twin)
    yield ("pairs scoring twice their length", q, ql, np.arange(len(twin), dtype=np.int64),
           *_ends(twin), nt, 7.0, 2.0)
    shared = [rng.integers(0, 4, int(n)).astype(np.int8) for n in (900, 260, 610)]
    idx = rng.integers(0, 3, 12)
    wins = [np.concatenate([rng.integers(0, 4, int(rng.integers(0, 90))),
                            shared[i][int(rng.integers(0, 100)):]]).astype(np.int8)
            for i in idx]
    q, ql = queries(shared)
    yield ("a shared query set", q, ql, idx.astype(np.int64), *_ends(wins), nt, 7.0, 2.0)
    if card_size:
        circle = rng.integers(0, 4, SW_SCORE_CIRCLE).astype(np.int8)
        circle[7000:7030] = N
        lens = np.clip(np.rint(np.exp(rng.normal(np.log(1000), 1.0, 48))), 200, 20000)
        lens[:3] = (20000, 16034, 200)
        wins = _merge_windows(rng, circle, lens)
        q, ql = queries([circle])
        yield (f"merge shape: a {SW_SCORE_CIRCLE}-base circle against 48 windows of "
               f"200-20,000", q, ql, np.zeros(len(wins), np.int64), *_ends(wins), nt, 7.0, 2.0)
        top = sw.SCORE_LIMIT // 16384 - 1
        ext = nt.copy()
        ext[ext > 0] = top
        ext[ext < 0] = -(sw.SCORE_LIMIT - 1)
        long = rng.integers(0, 4, 16384).astype(np.int8)
        q, ql = queries([long])
        yield ("int32 extremes: entries, gap costs and the best score near 2^24", q, ql,
               np.zeros(3, np.int64), *_ends([long, long[:9000], _revcomp(long[5:700])]),
               ext, float(sw.SCORE_LIMIT - 1), 1.0)
        ext2 = nt.copy()
        ext2[ext2 > 0] = 1000
        yield ("int32 extremes: gap costs of 2^24 - 1", q, ql, np.zeros(2, np.int64),
               *_ends([long[:3000], long[2000:9000]]), ext2, float(sw.SCORE_LIMIT - 1),
               float(sw.SCORE_LIMIT - 1))


def score_tensors(case: ScoreCase, device) -> tuple:
    """A score case's (queries, q_lens, q_index, targets, t_offsets,
    matrix) as tensors on ``device`` and its gap costs."""
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in case[1:7]), case[7], case[8]


def sw_scores_model(queries, q_lens, q_index, targets, t_offsets, submat, gap_open,
                    gap_extend) -> np.ndarray:
    """A numpy model of csrc/sw_score.cu's order of work: per pair, the
    orientation (the streamed side never a target longer than Lq), the
    tiles (16, 8 or 4 columns a lane; columns past the end never match or
    score -2^24), and in each tile the 32 lanes' wavefront step by step,
    the shuffles' values, the streamed codes and the left boundary read in
    32-position chunks two ahead of use (captured when loaded), the right
    boundary written by the last lane into a scratch slice of Lq rows that
    starts each pair as garbage. A lane's F chain across its columns is
    taken in closed form (a prefix maximum: the same integers). float32
    [B], the kernel's answers."""
    lanes, neg, limit = 32, -(1 << 30), 1 << 24   # kLanes, kNeg, kLimit
    sub = np.asarray(submat, np.int64)
    K = sub.shape[0]
    diag = np.eye(K, dtype=bool)
    diag[K - 1, K - 1] = False
    match, mismatch = int(sub[0, 0]), int(sub[K - 1, K - 1])
    compare = K > 1 and mismatch < 0 and np.array_equal(sub, np.where(diag, match, mismatch))
    tab = np.concatenate([sub, np.full((1, K), -limit, np.int64)])
    go, ge = int(gap_open), int(gap_extend)
    Q, Lq = queries.shape
    lane = np.arange(lanes)
    garbage = np.random.default_rng(0)
    out = np.zeros(len(q_index), np.float32)

    def sweep(cols, rows, col0, C, first, last, scr):
        ncols, nrows = len(cols), len(rows)
        j = col0 + lane[:, None] * C + np.arange(C)[None, :]
        q = np.where(j < ncols, np.clip(cols[np.minimum(j, max(ncols - 1, 0))], 0, K - 1), -1)
        code = np.where(q == K - 1, -1, q) if compare else np.where(q < 0, K, q)
        xs = np.clip(rows.astype(np.int64), 0, K - 1)
        if compare:
            xs = np.where(xs == K - 1, -2, xs)

        def chunk(src, m, fill):
            r = m * lanes + lane
            ok = r < nrows
            return np.where(ok[:, None] if src.ndim == 2 else ok,
                            src[np.minimum(r, nrows - 1)], fill)

        H = np.zeros((lanes, C), np.int64)
        E = np.full((lanes, C), neg, np.int64)
        best = np.zeros(lanes, np.int64)
        x = np.zeros(lanes, np.int64)
        fout = np.full(lanes, neg, np.int64)
        hout = np.zeros(lanes, np.int64)
        hprev = np.zeros(lanes, np.int64)
        xcur, xnxt = chunk(xs, 0, 0), chunk(xs, 1, 0)
        bfill = np.array([neg, 0])
        bcur = bnxt = np.tile(bfill, (lanes, 1))
        if not first:
            bcur, bnxt = chunk(scr, 0, bfill), chunk(scr, 1, bfill)
        for s in range(nrows + lanes - 1):
            t = s - lane
            up1 = lambda v: np.concatenate([v[:1], v[:-1]])  # __shfl_up_sync(v, 1)
            xu, fu, hu = up1(x), up1(fout), up1(hout)
            x0 = xcur[s & (lanes - 1)]
            f0, h0 = (neg, 0) if first else bcur[s & (lanes - 1)]
            x = np.where(lane == 0, x0, xu)
            act = (t >= 0) & (t < nrows)
            fin = np.where(lane == 0, f0, fu)
            sc = np.where(code == x[:, None], match, mismatch) if compare \
                else tab[code, x[:, None]]
            e = np.maximum(E - ge, H - go)
            hp = np.maximum(np.concatenate([hprev[:, None], H[:, :-1]], 1) + sc, e)
            # F entering each column: the lane's chain f = max(f - ext,
            # H' - open) in closed form
            ramp = ge * np.arange(C + 1)
            cm = np.maximum.accumulate(hp - go + ramp[1:], axis=1)
            F = np.maximum(fin[:, None] - ramp,
                           np.concatenate([np.full((lanes, 1), neg), cm], 1) - ramp)
            h = np.maximum(np.maximum(hp, F[:, :C]), 0)
            best = np.where(act, np.maximum(best, h.max(1)), best)
            E = np.where(act[:, None], e, E)
            H = np.where(act[:, None], h, H)
            fout = np.where(act, F[:, C], fout)
            hout = np.where(act, H[:, C - 1], hout)
            hprev = np.where(act, np.where(lane == 0, h0, hu), hprev)
            if not last and act[lanes - 1]:
                scr[t[lanes - 1]] = (fout[lanes - 1], hout[lanes - 1])
            if (s & (lanes - 1)) == lanes - 1:
                m = (s >> 5) + 2
                xcur, xnxt = xnxt, chunk(xs, m, 0)
                if not first:
                    bcur, bnxt = bnxt, chunk(scr, m, bfill)
        return int(best.max())

    offs = np.asarray(t_offsets, np.int64)
    for b, qi in enumerate(np.asarray(q_index, np.int64)):
        qlen = int(np.clip(q_lens[qi], 0, Lq))
        ts = np.asarray(targets[offs[b]: offs[b + 1]], np.int64)
        qs = np.asarray(queries[qi, :qlen], np.int64)
        stream_q = qlen >= len(ts) or len(ts) > Lq
        cols, rows = (ts, qs) if stream_q else (qs, ts)
        assert len(rows) <= Lq
        scr = garbage.integers(-2**31, 2**31, (max(Lq, 1), 2))
        best, col0 = 0, 0
        while col0 < len(cols) and len(rows):
            rem = len(cols) - col0
            C = 16 if rem > 8 * lanes else 8 if rem > 4 * lanes else 4
            best = max(best, sweep(cols, rows, col0, C, col0 == 0, rem <= C * lanes, scr))
            col0 += C * lanes
        out[b] = best
    return out



def check_sw_scores(device, card_size: bool = True) -> Tuple[int, int]:
    """Every case of :func:`sw_score_cases` through ``ops.sw.sw_scores`` on
    ``device`` (a card: the kernel), held against ``sw_scores_plain`` on the
    same tensors bit for bit, and against ``sw_align_plain``'s score on the
    cases small enough for it. Raises AssertionError on the first
    difference; returns the numbers of cases and pairs."""
    import torch

    from ..ops import sw

    n_cases = n_pairs = 0
    for case in sw_score_cases(card_size=card_size):
        args, go, ge = score_tensors(case, device)
        want = sw.sw_scores_plain(*args, go, ge)
        got = sw.sw_scores(*args, go, ge)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            bad = int(torch.nonzero(got != want)[0, 0])
            raise AssertionError(f"sw_scores differs from its plain version: {case[0]}, "
                                 f"pair {bad}: {float(got[bad])} vs {float(want[bad])}")
        n_cases += 1
        n_pairs += got.numel()
    return n_cases, n_pairs


# ------------------------------------------------------- banded CYK cases
# bits: float32 prefix sums in another order (the JAX package's, the plain
# version's on a card) differ in their last bits; see cyk_score_tol
CYK_SCORE_TOL = 1e-3
CYK_SEED = 2029
# model key -> CLEN (None: the tRNA-size cloverleaf); built in this order from
# one generator, the golden-size model last
CYK_MODELS = (("trna", None), ("rrna_180", 180), ("rrna_950", 950))


class CykCase(NamedTuple):
    name: str
    model_key: str
    window: np.ndarray       # int codes
    anchor: Tuple[int, int, int, int]
    slack: int
    local: bool


def cyk_fixtures(golden_size: bool = True, seed: int = CYK_SEED) -> dict:
    """model key -> FixtureCM (testing/cm_fixture.py), made from ``seed``;
    without ``golden_size`` the CLEN-950 model is left out."""
    from . import cm_fixture

    rng = np.random.default_rng(seed)
    out = {}
    for key, clen in CYK_MODELS:
        if clen == 950 and not golden_size:
            break
        out[key] = (cm_fixture.trna_cm(f"cyk_{key}", rng, "GAA") if clen is None
                    else cm_fixture.rrna_cm(f"cyk_{key}", rng, clen))
    return out


@functools.lru_cache(maxsize=None)
def cyk_model(key: str):
    """The port's CovarianceModel of :func:`cyk_fixtures`' model ``key``,
    parsed from the fixture's Infernal text; one object a key, so that the
    model tables are built once."""
    from ..models import cm as cm_models

    fx = cyk_fixtures(golden_size=key == CYK_MODELS[-1][0])[key]
    return cm_models.parse_cm_text(io.StringIO(fx.text))[0]


def _cyk_window(rng: np.random.Generator, cons: str, kind: str, pad: int
                ) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """(codes, anchor) of one window kind around the consensus ``cons``."""
    from ..io import encoding

    def flank(k):
        return "".join("ACGT"[int(i)] for i in rng.integers(0, 4, k))

    n = len(cons)
    body, w0, span, p1 = cons, pad, n, n - 1
    if kind == "mutated":
        arr = list(cons)
        for i in rng.integers(0, n, max(3, n // 20)):
            arr[int(i)] = "ACGT"[int(rng.integers(0, 4))]
        del arr[n // 3]                              # one deletion
        body, span = "".join(arr), n - 1
    elif kind == "with_n":
        body = cons[:10] + "N" + cons[11: n // 2] + "NN" + cons[n // 2 + 2:]
    elif kind == "twice":
        # the anchor half-way between the copies; the bands must reach both
        body, w0 = cons + cons, pad + n // 2
    elif kind == "junk":
        body = flank(n)
    seq = flank(pad) + body + flank(pad)
    if kind == "all_n":
        seq = "N" * len(seq)
    if kind == "truncated":
        # the model's last tenth runs off the window's right edge
        cut = n // 10
        seq = seq[: pad + n - cut]
        span, p1 = n - cut, n - 1 - cut
    return np.asarray(encoding.encode(seq)), (w0, w0 + span - 1, 0, p1)


def cyk_cases(golden_size: bool = True, seed: int = CYK_SEED) -> Iterator[CykCase]:
    """Seeded banded-CYK calls, each in glocal and local mode: the tRNA-size
    model at slack 8, 12 and 48 and ``rrna_cm`` at CLEN 180 (and, with
    ``golden_size``, at CLEN 950, the golden run's size) on the planted
    consensus, a mutated copy with a deletion, the consensus twice with
    bands wide enough for both copies (two equal parses tie), a window with
    N residues, a window that the model runs off at the right edge (the
    ``mdl_to`` truncation clamp), a window shorter than W (every origin
    clamps to 0), a random junk window and a window of N only (no glocal
    parse)."""
    rng = np.random.default_rng(seed + 1)
    fixtures = cyk_fixtures(golden_size, seed)
    specs = (  # model key, window kind, slack, flank length
        ("trna", "planted", 8, 20), ("trna", "planted", 12, 20), ("trna", "mutated", 12, 20),
        ("trna", "with_n", 12, 20), ("trna", "truncated", 8, 20), ("trna", "mutated", 48, 30),
        ("trna", "twice", 48, 20), ("trna", "short", 48, 10), ("trna", "junk", 12, 20),
        ("trna", "all_n", 12, 20),
        ("rrna_180", "planted", 48, 40), ("rrna_180", "mutated", 48, 40),
        ("rrna_180", "with_n", 12, 40), ("rrna_180", "truncated", 48, 40),
        ("rrna_180", "junk", 48, 40),
        ("rrna_950", "planted", 48, 64), ("rrna_950", "mutated", 48, 64),
    )
    for key, kind, slack, pad in specs:
        if key not in fixtures:
            continue
        window, anchor = _cyk_window(rng, fixtures[key].consensus, kind, pad)
        for local in (False, True):
            mode = "local" if local else "glocal"
            yield CykCase(f"{key} {kind} slack {slack} {mode}", key, window, anchor, slack,
                          local)


def cyk_score_tol(want) -> np.ndarray:
    """The score tolerance at ``want`` (bits): CYK_SCORE_TOL, or 4 float32
    units in the last place of the score where that is more. A parse that
    takes a clipped self-loop step (an N inside an IL / IR band) scores
    below -3e4, where one unit is 0.004 bits and two summation orders of
    the same prefix sums may differ by several."""
    mag = np.abs(np.asarray(want, np.float32))
    return np.maximum(CYK_SCORE_TOL, 4 * np.spacing(mag).astype(np.float64))


def check_cyk(got, want, what: str, cells: bool = True) -> float:
    """Hold one banded CYK result against another: two alignments (or two
    ``None``) with equal ``seq_from``, ``seq_to``, ``mdl_from`` and
    ``mdl_to``, or two ``BandedMaxima`` with equal origins and (with
    ``cells``) equal argmax cells; scores (maxima) within
    :func:`cyk_score_tol`. Returns the largest score error among live
    scores (above NEG / 2); AssertionError on a difference."""
    from ..ops import cyk_device

    if isinstance(want, cyk_device.BandedMaxima):
        for f in ("a", "o_i", "o_j")[0 if cells else 1:]:
            if not np.array_equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"{what}: {f} differs")
        g, w = got.m.astype(np.float64), want.m.astype(np.float64)
    elif got is None or want is None:
        if got is not None or want is not None:
            raise AssertionError(f"{what}: one side has no parse: {got} vs {want}")
        return 0.0
    else:
        coords = ("seq_from", "seq_to", "mdl_from", "mdl_to")
        if tuple(getattr(got, f) for f in coords) != tuple(getattr(want, f) for f in coords):
            raise AssertionError(f"{what}: coordinates differ: {got} vs {want}")
        g, w = np.array([got.score], np.float64), np.array([want.score], np.float64)
    err = np.abs(g - w)
    bad = ~(err <= cyk_score_tol(w))
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise AssertionError(f"{what}: score {g[i]} against {w[i]}, error {err[i]} over "
                             f"{cyk_score_tol(w[i])}")
    live = w > -5e29
    return float(err[live].max()) if live.any() else 0.0


# ------------------------------------------------------- genewise cases
GENEWISE_TABLE = 5
# (gap open, gap extend, frameshift, stop): the pipeline's, and the other
# integer set that tests/test_torch_genewise.py holds against the JAX package
GENEWISE_PENALTIES = ((13.0, 3.0, 15.0, 20.0), (10.0, 2.0, 8.0, 12.0))
# the long tier-1 case's query (its best alignment starts past 2^15) and the
# card's case over the packed path fields' limit (Lq > 65,535)
GENEWISE_LONG_LQ = 33000
GENEWISE_WIDE_LQ = 65600


class GenewiseCase(NamedTuple):
    name: str
    queries: np.ndarray      # [B, Lq] int8 aa codes
    q_lens: np.ndarray       # [B] int32
    target_aa: np.ndarray    # [B, T] int8 aa of the codon ending at each base
    t_lens: np.ndarray       # [B] int32
    penalties: Tuple[float, float, float, float]


def _wise_gene(rng: np.random.Generator, n_codons: int, kind: str, flank: int
               ) -> Tuple[np.ndarray, str]:
    """(protein codes, DNA window) of a random ORF of ``n_codons`` sense
    codons in random flanks of up to ``flank`` bases, edited by ``kind``:
    clean, plus1 / plus2 (one or two bases inserted: a step of 4 or 5),
    minus1 / minus2 (one or two bases lost: a step of 2 or 1), stop (an
    in-frame stop codon), with_n (an N codon), mutated (six substitutions),
    twice (the gene, a spacer and the gene again), random (unrelated DNA)."""
    from ..models import codon

    gc = codon.get_code(GENEWISE_TABLE)
    sense = [c for c, a in sorted(gc.forward.items()) if a != "*"]
    stop = next(c for c, a in sorted(gc.forward.items()) if a == "*")

    def dna(k):
        return "".join("ACGT"[int(i)] for i in rng.integers(0, 4, k))

    nt = "".join(sense[int(i)] for i in rng.integers(0, len(sense), n_codons))
    pep = codon.aa_encode(gc.translate_str(nt))
    mid = 3 * (n_codons // 2)
    edits = {"plus1": lambda s: s[:mid] + "A" + s[mid:],
             "plus2": lambda s: s[:mid] + "CA" + s[mid:],
             "minus1": lambda s: s[:mid] + s[mid + 1:],
             "minus2": lambda s: s[:mid] + s[mid + 2:],
             "stop": lambda s: s[:mid] + stop + s[mid + 3:],
             "with_n": lambda s: s[:mid] + "NNN" + s[mid + 3:],
             "twice": lambda s: s + dna(30) + s,
             "random": lambda s: dna(len(s))}
    if kind == "mutated":
        arr = list(nt)
        for i in rng.integers(0, len(arr), 6):
            arr[int(i)] = "ACGT"[int(rng.integers(0, 4))]
        nt = "".join(arr)
    elif kind != "clean":
        nt = edits[kind](nt)
    return pep, dna(int(rng.integers(0, flank + 1))) + nt + dna(int(rng.integers(0, flank + 1)))


def _wise_batch(rows, q_fill: int, pad_q: int = 0, pad_t: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(queries, q_lens, target_aa, t_lens) of ``rows`` [(protein codes,
    window string)], padded with ``q_fill`` and N to the longest row plus
    ``pad_q`` / ``pad_t``; the windows translated in table 5."""
    from ..io import encoding
    from ..ops import genewise

    B = len(rows)
    qa = np.full((B, max(max(len(q) for q, _ in rows) + pad_q, 1)), q_fill, np.int8)
    ta = np.full((B, max(max(len(t) for _, t in rows) + pad_t, 1)), 4, np.int8)
    ql, tl = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for i, (q, t) in enumerate(rows):
        qa[i, : len(q)] = q
        ta[i, : len(t)] = encoding.encode(t)
        ql[i], tl[i] = len(q), len(t)
    return qa, ql, genewise.translate_windows(ta, GENEWISE_TABLE), tl


def genewise_cases(seed: int = 2030, card_size: bool = True) -> Iterator[GenewiseCase]:
    """Seeded ``genewise_align`` calls: frameshifts of every step (a base
    or two gained or lost), in-frame stops, N codons and substitutions at
    both integer penalty sets; a gene planted twice (two equal maxima, the
    first wins); query and target lengths of 0, 1 and 2; odd codes
    (negative and >= K) in both; query lengths around the kernel's lanes
    and strips at 1, 2 and 4 columns a lane (1 to 257); a real-size hit: a
    600-aa protein (ND5's size) in a 2000-base window; a 33,000-residue
    query whose best alignment starts past residue 2^15 (its packed path
    fields' 16-bit halves); and, with ``card_size``, a 65,600-residue query
    against 40 bases (over the packed fields' limit, so the wide
    instantiation)."""
    from ..models import codon

    rng = np.random.default_rng(seed)
    X = codon.X_CODE
    kinds = ("clean", "plus1", "plus2", "minus1", "minus2", "stop", "with_n", "mutated",
             "random")
    for pen in GENEWISE_PENALTIES:
        rows = [_wise_gene(rng, int(rng.integers(30, 61)), k, 40) for k in kinds]
        yield GenewiseCase(f"every frameshift step, stops, N codons at {pen}",
                           *_wise_batch(rows, X, pad_q=5, pad_t=17), pen)
    rows = [_wise_gene(rng, int(rng.integers(20, 50)), "twice", 20) for _ in range(4)]
    yield GenewiseCase("a gene planted twice (the first maximum wins)",
                       *_wise_batch(rows, X), GENEWISE_PENALTIES[0])

    rows = [_wise_gene(rng, 20, "clean", 10) for _ in range(9)]
    qa, ql, aa, tl = _wise_batch(rows, X)
    ql[:] = (0, 1, 2, 20, 20, 20, 0, 1, 2)
    tl[:] = (tl[0], tl[1], tl[2], 0, 1, 2, 0, 2, 1)
    yield GenewiseCase("query and target lengths of 0, 1 and 2", qa, ql, aa, tl,
                       GENEWISE_PENALTIES[0])

    rows = [_wise_gene(rng, 40, k, 20) for k in ("clean", "plus1", "mutated", "minus1")]
    qa, ql, aa, tl = _wise_batch(rows, X)
    odd = np.array([-3, codon.NUM_AA, codon.NUM_AA + 7, 127, -128, -1], np.int8)
    qa[:, 5:11] = odd
    aa[:, 30:36] = odd
    aa[2, 60:63] = codon.STOP_CODE
    yield GenewiseCase("odd codes (negative, >= K) in queries and targets", qa, ql, aa, tl,
                       GENEWISE_PENALTIES[1])

    sizes = (125, 126, 127, 128, 128, 129, 4, 5, 3, 1)
    rows = [_wise_gene(rng, n, ("clean", "plus1", "minus2")[i % 3], 30)
            for i, n in enumerate(sizes)]
    yield GenewiseCase("Lq 125 to 129: one and two strips",
                       *_wise_batch(rows, X), GENEWISE_PENALTIES[0])
    sizes = (257, 256, 255, 129, 127, 2)
    rows = [_wise_gene(rng, n, ("plus2", "minus1", "stop")[i % 3], 30)
            for i, n in enumerate(sizes)]
    yield GenewiseCase("Lq 255 to 257: up to three strips",
                       *_wise_batch(rows, X), GENEWISE_PENALTIES[1])

    rows = [_wise_gene(rng, 600, "plus1", 100), _wise_gene(rng, 580, "minus1", 100)]
    yield GenewiseCase("real size: 600 aa against 2000 bases",
                       *_wise_batch(rows, X), GENEWISE_PENALTIES[0])

    for Lq, n_codons, what in ((GENEWISE_LONG_LQ, 5, "path fields past 2^15"),
                               (GENEWISE_WIDE_LQ, 13, "over the packing limit")):
        if Lq == GENEWISE_WIDE_LQ and not card_size:
            break
        pep, dna = _wise_gene(rng, n_codons, "clean", 0)
        q = rng.integers(0, 20, Lq).astype(np.int8)
        q[Lq - len(pep) - 7: Lq - 7] = pep
        qa, ql, aa, tl = _wise_batch([(q, dna + "A")], X)
        yield GenewiseCase(f"Lq {Lq} x T {len(dna) + 1}: {what}", qa, ql, aa, tl,
                           GENEWISE_PENALTIES[0])


def genewise_tensors(case: GenewiseCase, device) -> tuple:
    """A case's (queries, q_lens, target_aa, t_lens, BLOSUM62) as tensors on
    ``device``."""
    import torch

    from ..models import codon

    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (case.queries, case.q_lens, case.target_aa, case.t_lens,
                           codon.blosum62().astype(np.float32)))


def genewise_kernel_model(queries, q_lens, target_aa, t_lens, submat, gap_open=13.0,
                          gap_extend=3.0, fs_penalty=15.0, stop_penalty=20.0,
                          layout=None) -> tuple:
    """numpy model of csrc/genewise.cu at ``layout`` (``_pipeline_model``;
    default: ``genewise_config``'s pick), every sum a float32
    operation and the path fields in the layout's words. Returns the six
    ``WiseHits`` fields as numpy arrays (score float32, the rest int32)."""
    from ..models import codon
    from ..ops import genewise

    if layout is None:
        layout = genewise.genewise_config(np.shape(queries)[1], np.shape(target_aa)[1])
    return _pipeline_model(
        _WiseModel(layout.cols, layout.rows, layout.wide, gap_open, gap_extend, fs_penalty),
        queries,
        q_lens, target_aa, t_lens, submat, layout, codon.STOP_CODE, stop_penalty)


def genewise_layouts(device, case: GenewiseCase) -> list:
    """The kernel layouts the check forces on a case (``pipeline_layouts``
    at the chooser's layouts for its widths; none on the CPU)."""
    import torch

    from ..ops import genewise

    if torch.device(device).type != "cuda":
        return [None]
    Lq, T = case.queries.shape[1], case.target_aa.shape[1]
    return pipeline_layouts(genewise.genewise_configs(Lq, T), genewise.genewise_config(Lq, T),
                            wrap=Lq < GENEWISE_LONG_LQ)


def check_genewise(device, card_size: bool = True) -> Tuple[int, int]:
    """Every case of :func:`genewise_cases` through ``ops.genewise.
    genewise_align`` on ``device`` (a card: the kernel, at every layout of
    :func:`genewise_layouts`), held against ``genewise_align_plain`` on the
    same tensors and, on a card, against the CPU's: all six fields bit for
    bit (the score as float32 bits). Raises AssertionError on the first
    difference; returns the numbers of cases and of calls."""
    import torch

    from ..ops import genewise

    def bits(x):
        return x.contiguous().view(torch.int32).cpu()

    n_cases = n_calls = 0
    for case in genewise_cases(card_size=card_size):
        args = genewise_tensors(case, device)
        wants = [("its plain version", genewise.genewise_align_plain(*args, *case.penalties))]
        if torch.device(device).type != "cpu":
            cpu = genewise_tensors(case, "cpu")
            wants.append(("the CPU", genewise.genewise_align_plain(*cpu, *case.penalties)))
        for cfg in genewise_layouts(device, case):
            got = genewise.genewise_align(*args, *case.penalties, _config=cfg)
            n_calls += 1
            for what, want in wants:
                for field, g, w in zip(genewise.WiseHits._fields, got, want):
                    if not torch.equal(bits(g), bits(w)):
                        raise AssertionError(f"genewise_align {field} differs from {what}: "
                                             f"{case.name}, layout {cfg}")
        n_cases += 1
    return n_cases, n_calls
