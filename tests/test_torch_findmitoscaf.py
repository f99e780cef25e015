"""Parity of the port's findmitoscaf stage and its searches with the JAX
package on the CPU: nhmmer_search, tblastn, blastn, merge_sequences,
merge_partial, findmitoscaf (merge_method 1 and 2) and coverage_of_reads,
on the synthetic profile set of tests/profile_fixture.py.

Tolerances: frames must be equal row for row, in the same order, with the
same dtypes. Integer columns are exact; the float columns (scores and
E-values) derive from float32 alignment scores that XLA and eager PyTorch
may round differently in the last place, so they are held to a relative
1e-5 (scores of tens of bits; an E-value's relative error is lambda times
the score's absolute error).
"""

import numpy as np
import pandas as pd
import pytest

from mitoflex_tpu.config import SearchConfig
from mitoflex_tpu.io import fastq
from mitoflex_tpu.io.fasta import FastaRecord
from mitoflex_tpu.models import blast as jax_blast
from mitoflex_tpu.models import nhmmer as jax_nhmmer
from mitoflex_tpu.models.profiles import ProfileSet
from mitoflex_tpu.ops import mapper as jax_mapper
from mitoflex_tpu.stages import findmitoscaf as jax_fms
from mitoflex_tpu.stages import merge as jax_merge
from mitoflex_tpu_torch.models import blast as port_blast
from mitoflex_tpu_torch.models import nhmmer as port_nhmmer
from mitoflex_tpu_torch.ops import mapper as port_mapper
from mitoflex_tpu_torch.stages import findmitoscaf as port_fms
from mitoflex_tpu_torch.stages import merge as port_merge
from tests import profile_fixture, synth

RTOL = 1e-5


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    rng = np.random.default_rng(11)
    return profile_fixture.build(tmp_path_factory.mktemp("prof"), rng)


def _contig(cid, seq, multi, flag=0):
    return FastaRecord(cid, seq, {"flag": flag, "multi": multi, "len": len(seq)})


def _frames_equal(got, want):
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True),
                                  check_exact=False, rtol=RTOL)


def _records(recs):
    return [(r.id, r.seq, r.flag, r.multi) for r in recs]


def test_nhmmer_search_matches_jax(fake, rng):
    hmms = ProfileSet(fake.profile_dir).cds_hmms(fake.clade)
    g = fake.genome
    contigs = [_contig("mito", g, 120.0),
               _contig("rcfrag", profile_fixture._rc(g[300:1300]), 40.0),
               _contig("nuc", synth.random_genome(rng, 900), 30.0)]
    want = jax_nhmmer.nhmmer_search(contigs, hmms, e_threshold=1e-3, score_threshold=5.0)
    got = port_nhmmer.nhmmer_search(contigs, hmms, e_threshold=1e-3, score_threshold=5.0,
                                    device="cpu")
    assert len(want) >= 5 and set(want.strand) == {"+", "-"}
    _frames_equal(got, want)


def test_blast_searches_match_jax(fake, rng):
    g = fake.genome
    recs = [_contig("a", g[:900], 30.0), _contig("b", g[820:], 30.0),
            _contig("c", profile_fixture._rc(g[400:1100]), 20.0),
            _contig("d", synth.random_genome(rng, 500), 10.0)]
    want = jax_blast.blastn(recs, recs, skip_self=True)
    assert len(want) >= 4
    _frames_equal(port_blast.blastn(recs, recs, skip_self=True, device="cpu"), want)
    db = ProfileSet(fake.profile_dir).merged_protein_db()
    want = jax_blast.tblastn(db, recs[:3], 5)
    got = port_blast.tblastn(db, recs[:3], 5, device="cpu")
    assert len(want) >= 4
    _frames_equal(got, want)
    _frames_equal(port_blast.wash_blast_results(port_blast.blast_filter(got)),
                  jax_blast.wash_blast_results(jax_blast.blast_filter(want)))


def test_merges_match_jax(fake, rng):
    g = fake.genome
    half = len(g) // 2
    recs = [_contig("f1", g[: half + 80], 100.0), _contig("f2", g[half - 80:], 110.0),
            _contig("x", synth.random_genome(rng, 400), 20.0)]
    want = jax_merge.merge_sequences(recs, 50, 60, 20000)
    got = port_merge.merge_sequences(recs, 50, 60, 20000, device="cpu")
    assert want[1] == got[1] == 1
    assert _records(got[0]) == _records(want[0])
    want = jax_merge.merge_partial(recs[1:2], recs[::2], 50, 60, 20000)
    got = port_merge.merge_partial(recs[1:2], recs[::2], 50, 60, 20000,
                                   device="cpu")
    assert want[2] == got[2] >= 1
    assert _records(got[0]) == _records(want[0])
    assert _records(got[1]) == _records(want[1])


@pytest.mark.parametrize("merge_method", [2, 1])
def test_findmitoscaf_matches_jax(fake, merge_method):
    """The scenario of tests/test_findmitoscaf.py: the mito contig, a
    high-abundance nuclear contig and a low-abundance mito fragment."""
    rng = np.random.default_rng(5)
    profiles = ProfileSet(fake.profile_dir)
    contigs = [_contig("mito", fake.genome, 120.0),
               _contig("nuc", synth.random_genome(rng, 2000), 90.0),
               _contig("lowc", fake.genome[:1200], 2.0)]
    cfg = SearchConfig(min_abundance=10, merge_method=merge_method, disable_taxa=True)
    want = jax_fms.findmitoscaf(cfg, contigs, profiles, fake.clade, taxonomy=None,
                                gene_code=5)
    got = port_fms.findmitoscaf(cfg, contigs, profiles, fake.clade, taxonomy=None,
                                gene_code=5, device="cpu")
    assert [p.id for p in want.picked] == ["mito"]
    assert _records(got.picked) == _records(want.picked)
    assert got.found_pcgs == want.found_pcgs == profile_fixture.GENES
    assert got.missing_pcgs == want.missing_pcgs == []
    assert got.selected_candidates == want.selected_candidates
    _frames_equal(got.hmm_frame, want.hmm_frame)
    assert got.walls["total"] >= got.walls["nhmmer"] > 0


def test_coverage_of_reads_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    contigs = [synth.random_genome(rng, n) for n in (900, 500)]
    recs = [FastaRecord(f"c{i}", s) for i, s in enumerate(contigs)]
    reads = []
    for c in contigs:
        reads += synth.shotgun_reads(rng, c, 60, read_len=100, error_rate=0.01)
    reads.append((synth.random_genome(rng, 100), "I" * 100))
    path = synth.write_fastq(str(tmp_path / "r.fq"), reads)
    batches = list(fastq.read_batches(path, 64, 128))
    want = jax_mapper.coverage_of_reads(recs, iter(batches))
    got = port_mapper.coverage_of_reads(recs, iter(batches), device="cpu")
    assert got[1:] == want[1:] and want[2] > 100
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
