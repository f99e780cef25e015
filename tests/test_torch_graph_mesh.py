"""The port's sharded graph + unitig pass
(mitoflex_tpu_torch/parallel/graph_mesh.py) against the port's
single-device ``dbg.graph_unitig_pass`` and the JAX package's mesh pass on
its 8 virtual CPU devices: every ``GraphPass`` field is equal (node ids,
degrees, unitig roots and offsets, link counts, cycle flags, edge endpoint
ids). Beyond the JAX package's cases: a skewed table on which the JAX
package's fixed-capacity buckets overflow, a cycle whose nodes lie on
several shards, and shards that own no node or hold no edge.
"""

import filecmp

import numpy as np
import pytest
import torch

from mitoflex_tpu.parallel import graph_mesh as jax_graph_mesh
from mitoflex_tpu.parallel import mesh as jax_mesh
from mitoflex_tpu_torch import convert
from mitoflex_tpu_torch.config import AssembleConfig
from mitoflex_tpu_torch.io import encoding
from mitoflex_tpu_torch.ops import dbg as port_dbg
from mitoflex_tpu_torch.ops import kmer as port_kmer
from mitoflex_tpu_torch.ops import spill
from mitoflex_tpu_torch.parallel import graph_mesh
from mitoflex_tpu_torch.parallel import mesh as port_mesh
from mitoflex_tpu_torch.stages import assemble as port_asm
from tests import synth


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the sharded calls are many small eager ops,
    which more threads only slow down beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _code_rows(rows):
    L = max(len(r) for r in rows)
    seqs = np.full((len(rows), L), encoding.N, np.int8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        seqs[i, : len(r)] = r
        lens[i] = len(r)
    return seqs, lens


def _both_strand_edges(rows, k):
    """The both-strand (k+1)-mer table of code rows, as the assembler builds it."""
    return port_kmer.count_chunk_host(*_code_rows(rows), k + 1, device="cpu")


def _forward_edges(rows, k):
    """The forward (k+1)-mers only: a table without its reverse complements."""
    seqs, lens = _code_rows(rows)
    w, v = port_kmer.extract_kmers(torch.from_numpy(seqs), torch.from_numpy(lens), k + 1)
    u, c, _ = port_kmer.sort_count_unique(w, v)
    return convert.u32_numpy(u).T.copy(), c.numpy().astype(np.uint64)


def _single(keys, counts, k):
    return port_dbg.graph_unitig_pass(
        convert.to_device(np.ascontiguousarray(keys.T), "cpu"),
        torch.from_numpy(counts.astype(np.int64)), k)


def _assert_same(got, want):
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f
    g, w = convert.graph_pass_to_numpy(got), convert.graph_pass_to_numpy(want)
    assert g.n_nodes == w.n_nodes
    for a, b in zip(g.node_words, w.node_words):
        np.testing.assert_array_equal(a, b)
    for f in ("out_deg", "in_deg", "root", "offset", "link_count", "is_cycle",
              "prefix_id", "suffix_id", "edge_valid"):
        np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)


def _owners(gp, n):
    """The shard that owns each node: the key range of its first word."""
    first = convert.u32_numpy(gp.node_words[0]).astype(np.int64)
    return np.searchsorted(spill.uniform_inner_boundaries(n).astype(np.int64), first,
                           side="right")


@pytest.fixture(scope="module")
def jax_mesh8():
    return jax_mesh.make_mesh((8,), ("data",))


def _circles_and_lines(rng, k):
    """Circular fragments, one of 64 nodes a strand (a power of two), and
    linear ones."""
    rows = []
    for L in (300, 500, 64, 97):
        g = rng.integers(0, 4, L).astype(np.int8)
        rows.append(np.concatenate([g, g[: k + 1]]))
    for L in (150, 80):
        rows.append(rng.integers(0, 4, L).astype(np.int8))
    return rows


@pytest.mark.parametrize("n", [3, 8])
def test_mesh_graph_pass_parity(jax_mesh8, rng, n):
    k = 21
    keys, counts = _both_strand_edges(_circles_and_lines(rng, k), k)
    want = _single(keys, counts, k)
    got = graph_mesh.graph_unitig_pass_mesh(port_mesh.make_mesh((n,), device="cpu"),
                                            keys, counts, k)
    _assert_same(got, want)
    if n == 8:
        _assert_same(got, jax_graph_mesh.graph_unitig_pass_mesh(jax_mesh8, keys, counts, k))
    # the cycles' nodes lie on several shards: the pointer doubling and the
    # cycle break at the minimum node id cross shard boundaries
    owner = _owners(got, n)
    cyc = got.is_cycle.numpy()
    roots = got.root.numpy()
    spread = [len(set(owner[cyc & (roots == r)])) for r in np.unique(roots[cyc])]
    assert len(spread) == 8 and min(spread) >= 2
    u_got = port_dbg.unitig_set_from_pass(got, k)
    u_want = port_dbg.unitig_set_from_pass(want, k)
    np.testing.assert_array_equal(u_got.seq_codes, u_want.seq_codes)
    np.testing.assert_array_equal(u_got.depth, u_want.depth)
    assert u_got.circular.sum() == 8


def test_mesh_graph_pass_branching(jax_mesh8, rng):
    k = 15
    shared = rng.integers(0, 4, 120).astype(np.int8)
    a = np.concatenate([rng.integers(0, 4, 200).astype(np.int8), shared,
                        rng.integers(0, 4, 150).astype(np.int8)])
    b = np.concatenate([rng.integers(0, 4, 180).astype(np.int8), shared,
                        rng.integers(0, 4, 90).astype(np.int8)])
    keys, counts = _both_strand_edges([a, b], k)
    got = graph_mesh.graph_unitig_pass_mesh(port_mesh.make_mesh((8,), device="cpu"),
                                            keys, counts, k)
    _assert_same(got, _single(keys, counts, k))
    _assert_same(got, jax_graph_mesh.graph_unitig_pass_mesh(jax_mesh8, keys, counts, k))
    assert (got.out_deg > 1).any() and (got.in_deg > 1).any()


def test_skewed_tables_and_empty_shards_are_exact(rng):
    """A-rich A/C sequences, forward strand only: three quarters of the nodes
    fall in shard 0's key range of 4, which overflows the JAX package's
    buckets (it returns None and falls back to one device); on 2 shards
    every node falls in shard 0's range and shard 1 owns none; 5 edges over
    8 shards leave shards without an edge. The port is exact in all three."""
    k = 21
    rows = [(rng.random(1030) < 0.25).astype(np.int8) for _ in range(4)]
    keys, counts = _forward_edges(rows, k)
    assert jax_graph_mesh.graph_unitig_pass_mesh(
        jax_mesh.make_mesh((4,), ("data",)), keys, counts, k) is None
    want = _single(keys, counts, k)
    for n in (4, 2):
        got = graph_mesh.graph_unitig_pass_mesh(port_mesh.make_mesh((n,), device="cpu"),
                                                keys, counts, k)
        _assert_same(got, want)
    assert set(_owners(want, 2)) == {0}
    small_keys, small_counts = keys[:5], counts[:5]
    _assert_same(graph_mesh.graph_unitig_pass_mesh(
        port_mesh.make_mesh((8,), device="cpu"), small_keys, small_counts, k),
        _single(small_keys, small_counts, k))


def test_assemble_uses_mesh_graph_pass(tmp_path, rng, monkeypatch):
    """assemble() over 4 shards with MITOFLEX_MESH_GRAPH=1 takes the sharded
    graph pass and writes the single-device contig FASTA byte for byte."""
    monkeypatch.setenv("MITOFLEX_MESH_GRAPH", "1")
    calls = []
    orig = graph_mesh.graph_unitig_pass_mesh

    def spy(mesh, keys, counts, k):
        calls.append(len(keys))
        return orig(mesh, keys, counts, k)

    monkeypatch.setattr(graph_mesh, "graph_unitig_pass_mesh", spy)
    genome = synth.random_genome(rng, 2200)
    pairs = synth.shotgun_reads(rng, genome, 1100, read_len=90, insert=250,
                                error_rate=0.003)
    p1 = synth.write_fastq(tmp_path / "r1.fq", [p[0] for p in pairs])
    p2 = synth.write_fastq(tmp_path / "r2.fq", [p[1] for p in pairs])
    cfg = AssembleConfig(kmer_list=[21, 41], depth_list=[2, 2], min_multi=2,
                         prune_depth=2, prune_level=2, min_length=200,
                         disable_scaffolding=True)
    out_m = str(tmp_path / "contigs.mesh.fa")
    port_asm.assemble(cfg, str(p1), str(p2), out_m, read_chunk=512, max_read_len=96,
                      device="cpu", mesh=port_mesh.make_mesh((4,), device="cpu"))
    assert calls, "the sharded graph pass never ran"
    monkeypatch.delenv("MITOFLEX_MESH_GRAPH")
    out_s = str(tmp_path / "contigs.single.fa")
    port_asm.assemble(cfg, str(p1), str(p2), out_s, read_chunk=512, max_read_len=96,
                      device="cpu")
    assert filecmp.cmp(out_m, out_s, shallow=False)
