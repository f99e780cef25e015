"""Parity of the port's seed-vote mapper with the JAX package
(mitoflex_tpu.ops.mapper): the contig index and every placement field
(contig, pos, strand, votes, raw_pos) are compared exactly against both of
the reference's paths, the XLA ``_map_device`` and the numpy ``_map_host``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitoflex_tpu.io import encoding
from mitoflex_tpu.io.fasta import FastaRecord
from mitoflex_tpu.ops import mapper as jax_mapper
from mitoflex_tpu_torch import convert
from mitoflex_tpu_torch import device as port_device
from mitoflex_tpu_torch.ops import mapper as port_mapper
from tests import synth


def _fixture(seed):
    rng = np.random.default_rng(seed)
    contigs = [synth.random_genome(rng, n) for n in (700, 400, 1200)]
    contigs.append(contigs[0][100:400])  # a repeat: multi-hit seeds
    recs = [FastaRecord(f"c{i}", s) for i, s in enumerate(contigs)]
    reads = []
    for c in contigs[:3]:
        reads += [r for r, _ in synth.shotgun_reads(rng, c, 40, read_len=90,
                                                    error_rate=0.02)]
    # overhangs past both ends, foreign reads, Ns, short and empty reads
    reads += [synth.random_genome(rng, 60) + contigs[1][:60],
              contigs[2][-50:] + synth.random_genome(rng, 70),
              synth.random_genome(rng, 100), "N" * 30 + contigs[0][200:280],
              contigs[0][10:24], ""]
    L = 128
    seqs = np.full((len(reads), L), encoding.N, np.int8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        seqs[i, : len(r)] = encoding.encode(r)
        lens[i] = len(r)
    return recs, seqs, lens


def _fields(m):
    return [np.asarray(x) for x in (m.contig, m.pos, m.strand, m.votes, m.raw_pos)]


@pytest.mark.parametrize("seed", [0, 1])
def test_map_batch_matches_jax_device_and_host(monkeypatch, seed):
    recs, seqs, lens = _fixture(seed)
    jidx = jax_mapper.ContigIndex.build(recs)
    pidx = port_mapper.ContigIndex.build(recs, "cpu")
    want_idx = convert.contig_index_to_numpy(convert.contig_index_to_torch(jidx, "cpu"))
    got_idx = convert.contig_index_to_numpy(pidx)
    for key in ("keys", "contig_of", "pos_of", "n_entries"):
        np.testing.assert_array_equal(got_idx[key], want_idx[key], err_msg=key)

    dev = jax_mapper._map_device(jidx.keys, jidx.contig_of, jidx.pos_of,
                                 jnp.asarray(seqs), jnp.asarray(lens), 2, 4, 4)
    dev = [np.asarray(x) for x in (dev[0], dev[1], dev[2], dev[3], dev[4])]
    hst = list(jax_mapper._map_host(jidx, seqs, lens, 2, 4, 4))
    for a, b in zip(dev, hst):
        np.testing.assert_array_equal(a, b)
    assert (dev[0] >= 0).sum() > 100 and (dev[0] < 0).any() and (dev[4] < 0).any()

    # the CPU device's numpy path, then the tensor path forced on the CPU
    got_host = _fields(port_mapper.map_batch(pidx, seqs, lens))
    monkeypatch.setattr(port_device, "uses_host_mirrors", lambda d: False)
    got_dev = _fields(port_mapper.map_batch(pidx, seqs, lens))
    raw = port_mapper._map_device(pidx.keys, pidx.contig_of, pidx.pos_of,
                                  torch.from_numpy(seqs), torch.from_numpy(lens))
    for got in (got_host, got_dev, [x.numpy() for x in raw]):
        for g, w, name in zip(got, dev, ("contig", "pos", "strand", "votes", "raw")):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_map_batch_empty_index_and_batch():
    pidx = port_mapper.ContigIndex.build([], "cpu")
    m = port_mapper.map_batch(pidx, np.zeros((3, 50), np.int8), np.full(3, 50, np.int32))
    assert (m.contig == -1).all() and pidx.n_entries == 0
