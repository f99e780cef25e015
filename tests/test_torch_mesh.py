"""The port's in-process device mesh (mitoflex_tpu_torch/parallel/mesh.py)
against the JAX package's ``shard_map`` functions on its 8 virtual CPU
devices (tests/conftest.py), from the same seeded numpy inputs, and against
the port's own single-device functions. Every check is exact except the
Smith-Waterman and Viterbi scores, which hold within SCORE_TOL as in
tests/test_torch_{sw,phmm}.py. The port's edge cases: a batch whose row
count no shard count divides, a shard that gets no rows, and keys whose
first word is at least 2**31.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitoflex_tpu.io import encoding
from mitoflex_tpu.io.fasta import FastaRecord
from mitoflex_tpu.ops import kmer as jax_kmer
from mitoflex_tpu.ops import mapper as jax_mapper
from mitoflex_tpu.ops import sw as jax_sw
from mitoflex_tpu.parallel import mesh as jax_mesh
from mitoflex_tpu_torch import pipeline
from mitoflex_tpu_torch.config import PipelineConfig
from mitoflex_tpu_torch.convert import u32_numpy
from mitoflex_tpu_torch.ops import filter as port_filter
from mitoflex_tpu_torch.ops import kmer as port_kmer
from mitoflex_tpu_torch.ops import mapper as port_mapper
from mitoflex_tpu_torch.ops import sw as port_sw
from mitoflex_tpu_torch.parallel import mesh as port_mesh
from tests import synth

SCORE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the sharded calls are many small eager ops,
    which more threads only slow down beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8
    return jax_mesh.make_mesh((8,), ("data",)), port_mesh.make_mesh((8,), device="cpu")


def _batch(rng, B=64, L=128):
    seqs = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    quals = rng.integers(60, 74, size=(B, L)).astype(np.int8)
    lengths = rng.integers(32, L + 1, size=B).astype(np.int32)
    return seqs, quals, lengths


def _table(words, counts):
    """(keys [U, W] uint32, counts int64) of a port table."""
    return u32_numpy(words).T, counts.numpy().astype(np.int64)


def test_make_mesh_and_context_raise_instead_of_falling_back(tmp_path, monkeypatch):
    cpu4 = port_mesh.make_mesh((4,), device="cpu")
    assert cpu4.size == 4 and set(cpu4.devices) == {torch.device("cpu")}
    assert port_mesh.make_mesh(devices=["cpu"] * 3).size == 3
    for bad in ({"shape": (2, 2)}, {"axes": ("model",)}, {"shape": (0,)}):
        with pytest.raises(ValueError):
            port_mesh.make_mesh(device="cpu", **bad)
    cfg = PipelineConfig()
    cfg.run.basedir, cfg.run.workname = str(tmp_path), "m"
    cfg.search.disable_taxa = True
    assert pipeline.PipelineContext.create(cfg, device="cpu").mesh is None
    cfg.run.mesh_shape = [4]
    assert pipeline.PipelineContext.create(cfg, device="cpu").mesh.size == 4
    # one visible card: a mesh of two cannot be built, and the context raises
    # where the JAX package warns and runs on one device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="needs 2 cards"):
        port_mesh.make_mesh((2,), device="cuda")
    cfg.run.mesh_shape = [2]
    with pytest.raises(ValueError, match="needs 2 cards"):
        pipeline.PipelineContext.create(cfg, device="cuda")


def test_sharded_filter_matches_jax_and_single(meshes, rng):
    jmesh, pmesh = meshes
    seqs, quals, lengths = _batch(rng)
    ds, dq, dl = jax_mesh.shard_batch(jmesh, jnp.asarray(seqs), jnp.asarray(quals),
                                      jnp.asarray(lengths))
    want = jax_mesh.filter_reads_sharded(jmesh, ds, dq, dl)
    got = port_mesh.filter_reads_sharded(pmesh, seqs, quals, lengths)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(u32_numpy(g), np.asarray(w))
    # 61 rows over 8 shards, and 3 rows over 4 shards (one shard gets none)
    for B, mesh in ((61, pmesh), (3, port_mesh.make_mesh((4,), device="cpu"))):
        s, q, l = seqs[:B], quals[:B], lengths[:B]
        got = port_mesh.filter_reads_sharded(mesh, s, q, l, 10, 55, 0.2, l[::-1].copy())
        want = port_filter.filter_reads(*(torch.from_numpy(x) for x in (s, q, l)), 10, 55,
                                        0.2, torch.from_numpy(l[::-1].copy()))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_count_kmers_sharded_matches_jax(meshes, rng):
    jmesh, pmesh = meshes
    seqs, _, lengths = _batch(rng, B=64, L=96)
    ds, dl = jax_mesh.shard_batch(jmesh, jnp.asarray(seqs), jnp.asarray(lengths))
    words, counts, n = jax_mesh.count_kmers_sharded(jmesh, ds, dl, 21)
    n = int(n)
    want_keys = jax_kmer.words_to_np_keys([np.asarray(w)[:n] for w in words])
    replicas = port_mesh.count_kmers_sharded(pmesh, seqs, lengths, 21)
    assert len(replicas) == 8
    for w, c, u in replicas:
        keys, cnt = _table(w, c)
        assert u == n
        np.testing.assert_array_equal(keys, want_keys)
        np.testing.assert_array_equal(cnt, np.asarray(counts)[:n])


@pytest.mark.parametrize("high", [False, True])
def test_partitioned_count_matches_jax_shard_by_shard(meshes, rng, high):
    """The shards' key ranges are the JAX package's, so shard j's valid rows
    are equal; ``high`` draws the reads from G and T only, so that every
    forward key's first word is at least 2**31 (and every reverse
    complement's below it)."""
    jmesh, pmesh = meshes
    seqs, _, lengths = _batch(rng, B=64, L=96)
    if high:
        seqs = rng.integers(2, 4, size=seqs.shape).astype(np.int8)
    ds, dl = jax_mesh.shard_batch(jmesh, jnp.asarray(seqs), jnp.asarray(lengths))
    words, counts, n_per, overflow = jax_mesh.count_kmers_sharded_partitioned(
        jmesh, ds, dl, 21)
    rows = counts.shape[0] // 8
    parts = port_mesh.count_kmers_sharded_partitioned(pmesh, seqs, lengths, 21)
    for j, (w, c, u) in enumerate(parts):
        nj = int(np.asarray(n_per)[j])
        sl = slice(j * rows, j * rows + nj)
        want_keys = jax_kmer.words_to_np_keys([np.asarray(x)[sl] for x in words])
        keys, cnt = _table(w, c)
        assert u == nj, j
        np.testing.assert_array_equal(keys, want_keys)
        np.testing.assert_array_equal(cnt, np.asarray(counts)[sl])
    first = np.concatenate([_table(w, c)[0][:, 0] for w, c, _ in parts])
    assert (first >= 1 << 31).any()
    # against the port's single-device table, on 61 rows (no multiple of 8)
    parts = port_mesh.count_kmers_sharded_partitioned(pmesh, seqs[:61], lengths[:61], 21)
    keys = np.concatenate([_table(w, c)[0] for w, c, _ in parts])
    cnt = np.concatenate([_table(w, c)[1] for w, c, _ in parts])
    want_keys, want_cnt = port_kmer.count_chunk_host(seqs[:61], lengths[:61], 21,
                                                     device="cpu")
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_array_equal(cnt, want_cnt.astype(np.int64))


def test_scattered_lsm_steps_match_jax_shard_by_shard(meshes, rng):
    """Sharded chunk counting, a sharded merge and the canonical partition
    of the sharded k-mer LSM against the JAX package's, shard by shard."""
    jmesh, pmesh = meshes
    k = 22
    chunks = [_batch(rng, B=64, L=96) for _ in range(2)]
    jruns, pruns = [], []
    for seqs, _, lengths in chunks:
        ds, dl = jax_mesh.shard_batch(jmesh, jnp.asarray(seqs), jnp.asarray(lengths))
        jruns.append(jax_mesh.count_chunk_scattered_sharded(jmesh, ds, dl, k, True))
        pruns.append(port_mesh.count_chunk_scattered_sharded(pmesh, seqs, lengths, k))
    a, b = jruns
    jrun = jax_mesh.merge_scattered_sharded(jmesh, len(a[0]), *a[0], a[1], *b[0], b[1])
    words, counts, n_per, overflow = jax_mesh.partition_scattered_sharded(
        jmesh, jrun[0], jrun[1], canonical=True)
    prun = port_mesh.merge_scattered_sharded(pmesh, *pruns)
    # one shard's run compacted on the device equals its host extraction
    w, c, u = port_kmer.scattered_to_unique(*prun[0])
    keys, cnt = port_kmer.pull_scattered(*prun[0])
    assert u == len(keys)
    np.testing.assert_array_equal(u32_numpy(w).T, keys)
    np.testing.assert_array_equal(c.numpy(), cnt.astype(np.int64))
    parts = port_mesh.partition_scattered_sharded(pmesh, prun, canonical=True)
    rows = counts.shape[0] // 8
    for j, (w, c, u) in enumerate(parts):
        nj = int(np.asarray(n_per)[j])
        sl = slice(j * rows, j * rows + nj)
        keys, cnt = _table(w, c)
        assert u == nj
        np.testing.assert_array_equal(
            keys, jax_kmer.words_to_np_keys([np.asarray(x)[sl] for x in words]))
        np.testing.assert_array_equal(cnt, np.asarray(counts)[sl])


def test_sharded_mapper_matches_jax_and_single(meshes, rng):
    jmesh, pmesh = meshes
    g = synth.random_genome(rng, 3000)
    recs = [FastaRecord("c0", g[:1500]), FastaRecord("c1", g[1500:])]
    jidx = jax_mapper.ContigIndex.build(recs)
    pidx = port_mapper.ContigIndex.build(recs, "cpu")
    B, L = 64, 100
    seqs = np.zeros((B, L), np.int8)
    lengths = np.full(B, L, np.int32)
    for i in range(B):
        s = int(rng.integers(0, len(g) - L))
        seqs[i] = encoding.encode(g[s: s + L].encode())
    ds, dl = jax_mesh.shard_batch(jmesh, jnp.asarray(seqs), jnp.asarray(lengths))
    want = jax_mesh.map_reads_sharded(jmesh, jidx.keys, jidx.contig_of, jidx.pos_of, ds, dl)
    got = port_mesh.map_reads_sharded(pmesh, pidx.keys, pidx.contig_of, pidx.pos_of,
                                      seqs, lengths)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))
    # map_batch's mesh branch on 61 and on 3 reads equals the host mapper
    for n, mesh in ((61, pmesh), (3, port_mesh.make_mesh((4,), device="cpu"))):
        m = port_mapper.map_batch(pidx, seqs[:n], lengths[:n], mesh=mesh)
        h = port_mapper.map_batch(pidx, seqs[:n], lengths[:n])
        for f in ("contig", "pos", "strand", "votes", "raw_pos"):
            np.testing.assert_array_equal(getattr(m, f), getattr(h, f), err_msg=f)


def test_sharded_sw_matches_jax(meshes, rng):
    jmesh, pmesh = meshes
    B, L = 64, 80
    seqs = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    tgts = seqs.copy()
    tgts[:, 10:14] = (tgts[:, 10:14] + 1) % 4
    lens = np.full(B, L, np.int32)
    sm = jax_sw.nucleotide_matrix()
    dq, dl, dt, dtl = jax_mesh.shard_batch(jmesh, jnp.asarray(seqs), jnp.asarray(lens),
                                           jnp.asarray(tgts), jnp.asarray(lens))
    want = jax_mesh.sw_align_sharded(jmesh, dq, dl, dt, dtl, jnp.asarray(sm),
                                     gap_open=5.0, gap_extend=2.0)
    got = port_mesh.sw_align_sharded(pmesh, seqs, lens, tgts, lens, sm, 5.0, 2.0)
    single = port_sw.sw_align(*(torch.from_numpy(x) for x in (seqs, lens, tgts, lens)),
                              sm, 5.0, 2.0)
    for f in got._fields:
        if f == "score":
            np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                                       rtol=0, atol=SCORE_TOL)
            assert torch.equal(got.score, single.score)
        else:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)
            assert torch.equal(getattr(got, f), getattr(single, f))


def test_sharded_scans_and_pipeline_step_match_single(rng, tmp_path):
    """Both Viterbi passes and genewise over 3 shards against one device,
    on a window count (7) no shard count divides; ``pipeline_step``'s
    numbers against its parts."""
    from mitoflex_tpu_torch.models import codon
    from mitoflex_tpu_torch.models.profiles import ProfileSet
    from mitoflex_tpu_torch.ops import genewise, phmm
    from mitoflex_tpu_torch.testing import profile_fixture

    mesh = port_mesh.make_mesh((3,), device="cpu")
    fake = profile_fixture.build(tmp_path, rng)
    hmm = ProfileSet(fake.profile_dir).cds_hmms(fake.clade)[0]
    prof = phmm.stage_profile(hmm, device="cpu")
    win = np.stack([encoding.encode(fake.genome[s: s + 64]) for s in range(0, 7 * 150, 150)])
    wl = np.full(7, 64, np.int32)
    wl[2] = 40
    scan = port_mesh.viterbi_scan_sharded(mesh, prof, win, wl, hmm.length)
    one = phmm.viterbi_scan(prof, torch.from_numpy(win), torch.from_numpy(wl), hmm.length)
    for f in one._fields:
        assert torch.equal(getattr(scan, f), getattr(one, f)), f
    stack = phmm.stack_profiles([prof, prof])
    multi = port_mesh.viterbi_scores_multi_sharded(mesh, stack, [hmm.length] * 2, win, wl)
    assert torch.equal(multi, phmm.viterbi_scores_multi(
        stack, [hmm.length] * 2, torch.from_numpy(win), torch.from_numpy(wl)))
    q = np.stack([codon.aa_encode("MKVLAAGIVLLW" * 3)] * 5)
    t = np.stack([encoding.encode(fake.genome[s: s + 150]) for s in range(0, 750, 150)])
    aa = genewise.translate_windows(t, 5)
    ql, tl = np.full(5, q.shape[1], np.int32), np.full(5, 150, np.int32)
    got = port_mesh.genewise_align_sharded(mesh, q, ql, aa, tl, codon.blosum62())
    want = genewise.genewise_align(*(torch.from_numpy(x) for x in (q, ql, aa, tl)),
                                   codon.blosum62())
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    seqs, quals, lengths = _batch(rng, B=10, L=64)
    step = port_mesh.pipeline_step(mesh, seqs, quals, lengths, prof, hmm.length)
    keep = port_filter.filter_reads_ref(*(torch.from_numpy(x) for x in (seqs, quals, lengths)),
                                        10, 55, 0.2)[0].numpy()
    kept_lens = np.where(keep, lengths, 0).astype(np.int32)
    n_unique = port_kmer.count_chunk_host(seqs, kept_lens, 21, device="cpu")[0].shape[0]
    assert step["kept"] == int(keep.sum()) and step["n_unique_kmers"] == n_unique
    assert step["max_count"] >= 1 and np.isfinite(step["best_score"])
