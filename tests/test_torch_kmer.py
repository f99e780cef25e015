"""Parity of the port's k-mer counting and sorted-run merge with the JAX
package (mitoflex_tpu.ops.kmer / psort), on inputs made with numpy from a
seed.

Tolerances: keys are compared exactly. Equal keys have no set order in the
reference's merge (psort.py:563), so payloads are compared as per-key sums,
never row by row; counted tables (keys, totals) are compared exactly.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitoflex_tpu.io import encoding
from mitoflex_tpu.ops import kmer as jax_kmer
from mitoflex_tpu.ops import psort as jax_psort
from mitoflex_tpu.stages import assemble as jax_asm
from mitoflex_tpu_torch import convert
from mitoflex_tpu_torch import device as port_device
from mitoflex_tpu_torch.ops import kmer as port_kmer
from mitoflex_tpu_torch.ops import psort as port_psort
from mitoflex_tpu_torch.stages import assemble as port_asm
from tests import synth


def _sorted_run(rng, m, W, all_ones_tail=0):
    """A sorted run of m rows with W uint32 key words (few distinct leading
    words, so equal keys occur) and a uint32 payload; the last rows are
    all-ones keys, some with zero payload (padding) and one real all-T."""
    keys = rng.integers(0, 2**32, (m, W), dtype=np.uint64).astype(np.uint32)
    keys[:, 0] = rng.integers(0, 6, m).astype(np.uint32) * 0x3FFFFFFF
    keys[: m // 4] = keys[0]  # a long equal-key run
    if all_ones_tail:
        keys[-all_ones_tail:] = 0xFFFFFFFF
    pay = rng.integers(0, 2**31, m, dtype=np.uint64).astype(np.uint32)
    if all_ones_tail:
        pay[-all_ones_tail + 1:] = 0
    order = np.lexsort(tuple(keys[:, w] for w in range(W - 1, -1, -1)))
    return keys[order], pay[order]


def _per_key_sums(keys, pay):
    """(unique keys, uint64 payload sums) of a sorted [n, W] table."""
    new = np.ones(len(keys), bool)
    new[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    starts = np.flatnonzero(new)
    return keys[starts], np.add.reduceat(pay.astype(np.uint64), starts)


@pytest.mark.parametrize("W", [2, 4, 8])
def test_merge_sorted_runs_plain_matches_jax(W):
    """Port merge (plain version on the CPU) vs the Pallas bitonic merge in
    interpret mode and vs kmer.merge_scattered: output keys exact, per-key
    payload sums equal, output sorted."""
    rng = np.random.default_rng(W)
    m = 512
    ak, ap = _sorted_run(rng, m, W, all_ones_tail=20)
    bk, bp = _sorted_run(rng, m, W, all_ones_tail=7)
    merge_interp = functools.partial(jax_psort.merge_sorted_runs.__wrapped__,
                                     interpret=True)
    jp = merge_interp([jnp.asarray(ak[:, w]) for w in range(W)] + [jnp.asarray(ap)],
                      [jnp.asarray(bk[:, w]) for w in range(W)] + [jnp.asarray(bp)],
                      n_keys=W, tile=128)
    js = jax_kmer.merge_scattered([jnp.asarray(ak[:, w]) for w in range(W)],
                                  jnp.asarray(ap),
                                  [jnp.asarray(bk[:, w]) for w in range(W)],
                                  jnp.asarray(bp))
    a = convert.scattered_to_torch(list(ak.T), ap, "cpu")
    b = convert.scattered_to_torch(list(bk.T), bp, "cpu")
    for got in (port_psort.merge_sorted_runs(*a, *b),
                port_psort.merge_sorted_runs_ref(*a, *b),
                port_kmer.merge_scattered(a, b)):
        gw, gp = convert.scattered_to_numpy(got)
        gk = np.stack(gw, axis=1)
        order = np.lexsort(tuple(gk[:, w] for w in range(W - 1, -1, -1)))
        np.testing.assert_array_equal(order, np.arange(2 * m))  # sorted
        for ref in (jp, list(js[0]) + [js[1]]):
            rk = np.stack([np.asarray(x) for x in ref[:W]], axis=1)
            np.testing.assert_array_equal(gk, rk)
            uk, us = _per_key_sums(rk, np.asarray(ref[W]))
            gu, gs = _per_key_sums(gk, gp)
            np.testing.assert_array_equal(gu, uk)
            np.testing.assert_array_equal(gs, us)


def test_merge_sorted_runs_unequal_lengths_match_host_merge():
    """Exact: the port merges runs of any lengths (no power-of-two rule);
    pulled totals equal the JAX host merge of the same tables."""
    rng = np.random.default_rng(5)
    ak, ap = _sorted_run(rng, 300, 3, all_ones_tail=4)
    bk, bp = _sorted_run(rng, 77, 3)
    got = port_kmer.pull_scattered(*port_kmer.merge_scattered(
        convert.scattered_to_torch(list(ak.T), ap, "cpu"),
        convert.scattered_to_torch(list(bk.T), bp, "cpu"),
    ))
    ua, sa = _per_key_sums(ak, ap)
    ub, sb = _per_key_sums(bk, bp)
    ka, kb = sa > 0, sb > 0
    want = jax_kmer.merge_sorted_counts(ua[ka], sa[ka], ub[kb], sb[kb])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _reads(seed, L=160):
    """Reads from a small genome with errors, N bases and an all-T read."""
    rng = np.random.default_rng(seed)
    g = synth.random_genome(rng, 900)
    reads = [r for r, _ in synth.shotgun_reads(rng, g, 60, read_len=150,
                                               error_rate=0.01)]
    reads[3] = reads[3][:40] + "NN" + reads[3][42:]
    reads[7] = "N" * 20 + reads[7][20:]
    reads += ["T" * 150, "T" * 130 + "A" * 20, "ACGT" * 10]
    seqs = np.full((len(reads), L), encoding.N, np.int8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        seqs[i, : len(r)] = encoding.encode(r)
        lens[i] = len(r)
    return seqs, lens


@pytest.mark.parametrize("kp1", [22, 32, 56, 120])
def test_count_chunk_scattered_then_pull_matches_jax(kp1):
    """Exact (keys and uint64 totals): count_chunk_scattered + pull_scattered
    vs the JAX pair, canonical and both-strand, with N bases and all-T reads
    (the all-T key collides with the all-ones padding when 2(k+1) % 32 == 0)."""
    seqs, lens = _reads(kp1)
    for canonical in (True, False):
        jw, jc = jax_kmer.count_chunk_scattered(jnp.asarray(seqs), jnp.asarray(lens),
                                                kp1, canonical)
        want = jax_kmer.pull_scattered(jw, jc)
        got = port_kmer.pull_scattered(*port_kmer.count_chunk_scattered(
            torch.from_numpy(seqs), torch.from_numpy(lens), kp1, canonical))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        host = port_kmer.count_chunk_host(seqs, lens, kp1, canonical=canonical,
                                          device="cpu")
        np.testing.assert_array_equal(host[0], want[0])
        np.testing.assert_array_equal(host[1], want[1])
        if kp1 <= 32:
            nump = port_kmer.count_chunk_numpy(seqs, lens, kp1, canonical=canonical)
            np.testing.assert_array_equal(nump[0], want[0])
            np.testing.assert_array_equal(nump[1], want[1])
    if kp1 == 32:
        all_t = (want[0] == 0xFFFFFFFF).all(axis=1)
        assert all_t.sum() == 1 and want[1][all_t][0] > 0
    wts = np.arange(1, len(lens) + 1, dtype=np.uint32)
    want = jax_kmer.count_chunk_host(seqs, lens, kp1, wts)
    got = port_kmer.count_chunk_host(seqs, lens, kp1, wts, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("kp1", [32, 56])
def test_kmer_counter_device_lsm_matches_jax(monkeypatch, kp1):
    """Exact: the port's KmerCounter through its device LSM (the tensor
    path, forced on the CPU) vs the JAX counter's host LSM, over chunks of
    unequal lengths."""
    seqs, lens = _reads(kp1 + 100)
    jc = jax_asm.KmerCounter(kp1, canonical=True, prefer_host=True)
    monkeypatch.setattr(port_device, "uses_host_mirrors", lambda d: False)
    pc = port_asm.KmerCounter(kp1, canonical=True, device="cpu")
    assert not pc.prefer_host
    for lo, hi in ((0, 20), (20, 23), (23, 50), (50, len(lens))):
        jc.add_chunk(seqs[lo:hi], lens[lo:hi])
        pc.add_chunk(seqs[lo:hi], lens[lo:hi])
    np.testing.assert_array_equal(pc.keys, jc.keys)
    np.testing.assert_array_equal(pc.counts, jc.counts)


@pytest.mark.parametrize("W", [1, 3])
def test_multiword_join_and_member_match_jax(W):
    """Exact: table ranks of present queries and membership of any query."""
    rng = np.random.default_rng(W)
    table = np.unique(rng.integers(0, 2**32, (200, W), dtype=np.uint64)
                      .astype(np.uint32), axis=0)
    table[-1] = 0xFFFFFFFF
    present = table[rng.integers(0, len(table), 150)]
    absent = rng.integers(0, 2**32, (50, W), dtype=np.uint64).astype(np.uint32)
    queries = np.concatenate([present, absent])
    tj = [jnp.asarray(table[:, w]) for w in range(W)]
    qj = [jnp.asarray(queries[:, w]) for w in range(W)]
    tt = convert.to_device(np.ascontiguousarray(table.T), "cpu")
    qt = convert.to_device(np.ascontiguousarray(queries.T), "cpu")
    member = np.asarray(jax_kmer.multiword_member_sorted(tj, jnp.int32(len(table)), qj))
    np.testing.assert_array_equal(port_kmer.multiword_member_sorted(tt, qt).numpy(), member)
    rank = np.asarray(jax_kmer.multiword_join_sorted(tj, jnp.int32(len(table)), qj))
    got = port_kmer.multiword_join_sorted(tt, qt).numpy()
    np.testing.assert_array_equal(got[:150], rank[:150])
    uniq, n = port_kmer.unique_words_device(qt)
    ju, jn = jax_kmer.unique_words_device(qj, jnp.ones(len(queries), bool))
    assert n == int(jn)
    np.testing.assert_array_equal(convert.u32_numpy(uniq),
                                  np.stack([np.asarray(x)[:n] for x in ju]))


@pytest.mark.parametrize("k", [21, 40])
def test_count_edges_and_mercy_match_jax(k):
    """Exact: the solid table with contig re-injection (count_edges) and the
    mercy rescue (add_mercy_edges) on reads with a one-read coverage dip."""
    rng = np.random.default_rng(k)
    genome = synth.random_genome(rng, 900)
    reads = ([genome[i : i + 80] for i in range(0, 321, 8)] * 3
             + [genome[i : i + 80] for i in range(403, 724, 8)] * 3
             + [genome[330:480]])
    seqs = np.full((len(reads), 160), encoding.N, np.int8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        seqs[i, : len(r)] = encoding.encode(r)
        lens[i] = len(r)

    def src():
        yield seqs[:60], lens[:60]
        yield seqs[60:], lens[60:]

    contigs = [jax_asm.Contig(genome[100:500], 7.6, False)]
    want = jax_asm.count_edges(src, k, 3, extra_contigs=contigs)
    got = port_asm.count_edges(
        src, k, 3, extra_contigs=[port_asm.Contig(c.seq, c.depth, c.circular)
                                  for c in contigs], device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    skeys, scounts = jax_asm.count_edges(src, k, 3)
    want = jax_asm.add_mercy_edges(src, skeys, scounts, k)
    got = port_asm.add_mercy_edges(src, skeys, scounts, k, device="cpu")
    assert len(want[0]) > len(skeys)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
