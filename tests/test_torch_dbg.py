"""Parity of the port's de Bruijn graph pass with the JAX package
(mitoflex_tpu.ops.dbg.graph_unitig_pass): node ids, degrees, unitig roots,
offsets, link counts, cycle flags and edge endpoints are compared exactly,
as are the unitig sequences built from them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitoflex_tpu.io import encoding
from mitoflex_tpu.ops import dbg as jax_dbg
from mitoflex_tpu.ops import kmer as jax_kmer
from mitoflex_tpu_torch import convert
from mitoflex_tpu_torch.ops import dbg as port_dbg
from tests import synth


def _edges_from_rows(rows, kp1):
    """Both-strand (k+1)-mer table (keys [E, W] uint32, counts) of rows."""
    L = max(len(r) for r in rows)
    seqs = np.full((len(rows), L), encoding.N, np.int8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        seqs[i, : len(r)] = encoding.encode(r)
        lens[i] = len(r)
    return jax_kmer.count_chunk_host(seqs, lens, kp1, canonical=False)


def _jax_pass(keys, counts, k):
    E, W = keys.shape
    cap = 1 << max(E - 1, 1).bit_length()
    kw = [np.full(cap, 0xFFFFFFFF, np.uint32) for _ in range(W)]
    for w in range(W):
        kw[w][:E] = keys[:, w]
    kc = np.zeros(cap, np.uint32)
    kc[:E] = np.minimum(counts, 0xFFFFFFFF)
    return jax_dbg.graph_unitig_pass([jnp.asarray(x) for x in kw], jnp.asarray(kc),
                                     jnp.int32(E), k)


def _assert_same_pass(got, want):
    g, w = convert.graph_pass_to_numpy(got), convert.graph_pass_to_numpy(want)
    assert g.n_nodes == w.n_nodes
    for a, b in zip(g.node_words, w.node_words):
        np.testing.assert_array_equal(a, b)
    for name in ("out_deg", "in_deg", "root", "offset", "link_count", "is_cycle",
                 "prefix_id", "suffix_id", "edge_valid"):
        np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)


def _cases():
    rng = np.random.default_rng(3)
    genome = synth.random_genome(rng, 1500)
    reads = [r for r, _ in synth.shotgun_reads(rng, genome, 300, read_len=100,
                                               circular=True, error_rate=0.005)]
    circ = synth.random_genome(np.random.default_rng(8), 1024)
    return {"reads": reads, "circular_2pow10": circ}


@pytest.mark.parametrize("k", [21, 40, 55])
@pytest.mark.parametrize("case", ["reads", "circular_2pow10"])
def test_graph_unitig_pass_matches_jax(case, k):
    """Exact on every GraphPass field; the circular case is a genome of
    exactly 2**10 distinct k-mers, whose cycle length divides 2**iters."""
    rows = _cases()[case]
    if case == "circular_2pow10":
        rows = [rows + rows[:k]]
    keys, counts = _edges_from_rows(rows, k + 1)
    want = _jax_pass(keys, counts, k)
    got = port_dbg.graph_unitig_pass(
        convert.to_device(np.ascontiguousarray(keys.T), "cpu"),
        torch.from_numpy(np.minimum(counts, 0xFFFFFFFF).astype(np.int64)), k,
    )
    _assert_same_pass(got, want)
    if case == "circular_2pow10":
        g = convert.graph_pass_to_numpy(got)
        assert g.n_nodes == 2048 and g.is_cycle.all()
    # the unitig sets and the strand choice built on the pass
    us_g = port_dbg.unitig_set_from_pass(got, k)
    us_w = jax_dbg.unitig_set_from_pass(want, k)
    assert us_g.n == us_w.n
    assert [us_g.seq_str(j) for j in range(us_g.n)] == \
        [us_w.seq_str(j) for j in range(us_w.n)]
    np.testing.assert_array_equal(us_g.circular, us_w.circular)
    np.testing.assert_array_equal(us_g.depth, us_w.depth)
    np.testing.assert_array_equal(port_dbg.dedup_strand_mask(us_g, k),
                                  jax_dbg.dedup_strand_mask(us_w, k))
    if keys.shape[1] <= 2:
        # the CPU device's native host pass agrees too
        _assert_same_pass(port_dbg.graph_unitig_pass_host(keys, counts, k), want)


def test_graph_pass_converters_round_trip():
    """Exact: GraphPass -> tensors -> numpy gives the JAX pass back."""
    keys, counts = _edges_from_rows(_cases()["reads"], 32)
    want = _jax_pass(keys, counts, 31)
    _assert_same_pass(convert.graph_pass_to_torch(want, "cpu"), want)
