"""Parity of the port's findmitoscaf stage and its searches with the JAX
package on the CPU: nhmmer_search, tblastn, blastn, merge_sequences,
merge_partial, findmitoscaf (merge_method 1 and 2) and coverage_of_reads,
on the synthetic profile set of tests/profile_fixture.py.

One departure is held on purpose: the port's blastn reckons each row's
e-value against the subject set as one database and drops rows above the
upstream's ``-evalue 1e-5`` (annotation/annotation_tookit.py:117), where the
JAX package reckons against each subject alone and cuts nothing. The JAX
frame is brought to the upstream's reckoning inside the tests
(``_upstream_blastn``), and the partial merge is held to a plain statement
of the upstream's rule (``_upstream_merge_rows``).

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
import torch

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
from mitoflex_tpu_torch.ops import sw as port_sw
from mitoflex_tpu_torch.parallel import mesh as port_mesh
from mitoflex_tpu_torch.stages import findmitoscaf as port_fms
from mitoflex_tpu_torch.stages import merge as port_merge
from mitoflex_tpu_torch.testing import kernel_cases
from mitoflex_tpu_torch.testing import synth as port_synth
from tests import profile_fixture, synth

RTOL = 1e-5
UPSTREAM_EVALUE = 1e-5  # blastn -evalue in the upstream's wrapper


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


def _upstream_blastn(frame, subjects):
    """A JAX blastn frame with each e-value reckoned over the subject set as
    one database (query length x the subjects' summed length x 2^-bits,
    from the row's own per-subject e-value) and the rows above the
    upstream's -evalue dropped."""
    lens = {r.id: len(r.seq) for r in subjects}
    n_total = sum(lens.values())
    f = frame.copy()
    f["evalue"] = f.evalue * n_total / f.sseq.map(lens)
    return f[f.evalue <= UPSTREAM_EVALUE]


def _upstream_merge_rows(frame, queries, subjects, search_range, overlapped_len=50,
                         evalue_cut=True):
    """The rows of a blastn frame that the upstream's partial merge may join
    on: another record, a terminal start within ``search_range``, at least
    ``overlapped_len`` columns and, with ``evalue_cut``, 2^-bits x the query
    length x the subjects' summed length at most 1e-5."""
    qlens = {r.id: len(r.seq) for r in queries}
    n_total = sum(len(r.seq) for r in subjects)
    rows = []
    for r in frame.itertuples():
        if r.qseq == r.sseq or r.length < overlapped_len:
            continue
        if not ((r.sstart < search_range and r.send < search_range)
                or r.qstart < search_range):
            continue
        if evalue_cut and qlens[r.qseq] * n_total * 2.0 ** -r.score > UPSTREAM_EVALUE:
            continue
        rows.append(r)
    return rows


def _draft(rng, overlap):
    """synth.merge_draft's circle (multi 400) and contigs (multi 20)."""
    (cid, circle), contigs = port_synth.merge_draft(rng, overlap)
    return [_contig(cid, circle, 400.0)], [_contig(n, s, 20.0) for n, s in contigs]


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
    want = _upstream_blastn(jax_blast.blastn(recs, recs, skip_self=True), recs)
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
    # the frames both merges joined on, the JAX one at the upstream's reckoning
    for queries, subjects in ((recs, recs), (recs[1:2], recs[::2])):
        _frames_equal(port_blast.blastn(queries, subjects, skip_self=True, device="cpu"),
                      _upstream_blastn(jax_blast.blastn(queries, subjects, skip_self=True),
                                       subjects))


def test_partial_merge_leaves_a_chance_row():
    """A nuclear contig that shares with the circle's start only a 53-column
    stretch at 75% identity: under the cut per subject (the JAX package's
    reckoning, had it cut) but above it over the draft. The JAX package
    joins the two; the upstream's rule and the port do not."""
    picked, db = _draft(np.random.default_rng(1), lambda c: port_synth.chance_copy(c[:54]))
    frame = jax_blast.blastn(picked, db, skip_self=True)
    row = frame[(frame.sseq == "nuc") & (frame.length >= 50)]
    assert len(row) == 1 and 70 <= row.ident.iloc[0] <= 80
    assert row.evalue.iloc[0] <= UPSTREAM_EVALUE  # per subject: kept
    assert port_blast.BLASTN_EVALUE == UPSTREAM_EVALUE
    assert len(_upstream_merge_rows(frame, picked, db, 50, evalue_cut=False)) == 1
    assert _upstream_merge_rows(frame, picked, db, 50) == []
    want = jax_merge.merge_partial(picked, db, 50, 50, 20000)
    assert want[2] == 1 and len(want[0][0].seq) == 1300 + 1500
    got = port_merge.merge_partial(picked, db, 50, 50, 20000, device="cpu")
    assert got[2] == 0
    assert _records(got[0]) == _records(picked) and _records(got[1]) == _records(db)


def test_partial_merge_joins_a_true_overlap():
    """A nuclear contig whose last 85 bases are the circle's first: the
    upstream's rule keeps the row, and the port joins as the JAX package."""
    picked, db = _draft(np.random.default_rng(2), lambda c: c[:85])
    frame = jax_blast.blastn(picked, db, skip_self=True)
    assert len(_upstream_merge_rows(frame, picked, db, 50)) >= 1
    want = jax_merge.merge_partial(picked, db, 50, 50, 20000)
    got = port_merge.merge_partial(picked, db, 50, 50, 20000, device="cpu")
    assert want[2] == got[2] == 1
    assert len(got[0][0].seq) == 1300 + 1500
    assert _records(got[0]) == _records(want[0])
    assert _records(got[1]) == _records(want[1])


@pytest.mark.parametrize("seed_bases", [1 << 24, 700])
def test_blastn_seed_join_matches_the_subject_loop(monkeypatch, seed_bases):
    """The card's seed join (every subject's windows on both strands at
    once, in runs of ``seed_bases`` bases) gives the CPU's loop over
    subjects: the same windows in the same order, and the same frame. Draft
    with N runs, subjects shorter than a seed, a reverse-strand copy, the
    circle itself (skip_self) and a second query."""
    rng = np.random.default_rng(3)
    circle = synth.random_genome(rng, 600)
    queries = [_contig("circle", circle, 400.0),
               _contig("q2", synth.random_genome(rng, 100) + "N" * 12
                       + circle[300:440], 30.0)]
    subjects = [_contig(f"s{i}", synth.random_genome(rng, int(n)), 20.0)
                for i, n in enumerate(rng.integers(5, 400, 30))]
    subjects += [_contig("ov", synth.random_genome(rng, 200) + circle[:150], 20.0),
                 _contig("rc", profile_fixture._rc(circle[200:500]) + "N" * 15, 20.0),
                 _contig("circle", circle, 400.0)]
    monkeypatch.setattr(port_blast, "_SEED_BASES", seed_bases)
    for min_seeds in (1, 2):
        idx = port_blast.SeedIndex([q.codes for q in queries], 11, 5)
        loop = list(port_blast._seed_groups_host(idx, subjects, min_seeds))
        join = list(port_blast._seed_groups_tensor(idx, len(queries), subjects,
                                                   min_seeds, "cpu"))
        assert len(loop) == len(join) >= 4
        for a, b in zip(loop, join):
            assert a[:2] == b[:2] and a[3:] == b[3:]
            assert np.array_equal(a[2], b[2])
    want = port_blast.blastn(queries, subjects, skip_self=True, device="cpu")
    monkeypatch.setattr(port_blast.device_mod, "uses_host_mirrors", lambda device=None: False)
    got = port_blast.blastn(queries, subjects, skip_self=True, device="cpu")
    assert len(want) >= 3
    pd.testing.assert_frame_equal(got, want)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: the port's plain loops are many small eager ops,
    which more threads only slow down beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _all_path(monkeypatch):
    """blastn through its all-path route (every window aligned, the route a
    mesh of several shards keeps) for the rest of a test: the reference for
    the score-first route."""
    real = port_blast.blastn
    mesh = port_mesh.make_mesh((2,), device="cpu")

    def blastn(*args, **kwargs):
        return real(*args, **kwargs, mesh=mesh)

    monkeypatch.setattr(port_blast, "blastn", blastn)
    return real


@pytest.mark.usefixtures("one_torch_thread")
def test_blastn_score_first_frame_equals_the_all_path_route(monkeypatch):
    """Exact, field for field: exact copies of circle stretches of 18-28
    bases (rows just above and just below the 1e-5 cut over the subject
    set), one on the minus strand, a planted true overlap and random
    contigs that seed by chance; also in pieces of 3,000 window bases a
    score launch."""
    rng = np.random.default_rng(7)
    circle = synth.random_genome(rng, 1500)
    subjects = []
    for i, n in enumerate(range(18, 29)):
        at = 100 * i + 50
        left = synth.random_genome(rng, 300)
        right = synth.random_genome(rng, 300)
        # flanks that mismatch the circle's next bases: the copy's score is 2n
        left = left[:-1] + "ACGT"[("ACGT".index(circle[at - 1]) + 2) % 4]
        right = "ACGT"[("ACGT".index(circle[at + n]) + 2) % 4] + right[1:]
        seq = left + circle[at: at + n] + right
        subjects.append(_contig(f"copy{n}", profile_fixture._rc(seq) if n == 25 else seq, 20.0))
    subjects.append(_contig("ov", synth.random_genome(rng, 600) + circle[:85], 20.0))
    subjects += [_contig(f"r{i}", synth.random_genome(rng, 900), 20.0) for i in range(12)]
    queries = [_contig("circle", circle, 400.0)]
    q_codes, _, t_rows, meta = port_blast.blastn_windows(queries, subjects, 11, 1, 50, True,
                                                         "cpu")
    sub = port_sw.nucleotide_matrix()
    cat, offs = kernel_cases._ends(t_rows)
    scores = port_sw.sw_scores_plain(*(torch.from_numpy(x) for x in (
        np.stack(q_codes), np.array([len(circle)]), np.array([m[0] for m in meta]), cat, offs)),
        sub, 7.0, 2.0).numpy()
    n_total = sum(len(r.seq) for r in subjects)
    evalues = port_blast._evalue(port_blast._bitscore(scores, *port_blast._NT_LK),
                                 len(circle), n_total)
    cut = port_blast.BLASTN_EVALUE
    # a copy one base longer scores 2 more: 2^(-2 lambda / ln 2), 3.5 times
    # less in e-value
    assert ((evalues > cut) & (evalues <= 5 * cut)).any()
    assert ((evalues <= cut) & (evalues >= cut / 5)).any()
    assert len(meta) > 14
    got = port_blast.blastn(queries, subjects, skip_self=True, device="cpu")
    assert len(got) == int((evalues <= cut).sum()) >= 8
    assert {"ov", "copy25"} <= set(got.sseq)
    monkeypatch.setattr(port_blast, "_SCORE_BASES", 3000)
    pieces = port_blast.blastn(queries, subjects, skip_self=True, device="cpu")
    _all_path(monkeypatch)
    want = port_blast.blastn(queries, subjects, skip_self=True, device="cpu")
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(pieces, want)


@pytest.mark.parametrize("overlap, joins", [
    (lambda c: port_synth.chance_copy(c[:54]), 0),  # a chance row, 75% over 53 columns
    (lambda c: c[:85], 1),                          # a true overlap of 85 bases
], ids=["chance_row", "true_overlap"])
@pytest.mark.usefixtures("one_torch_thread")
def test_merge_frames_equal_the_all_path_route(monkeypatch, overlap, joins):
    """merge_partial on a draft and merge_sequences on a genome in two
    overlapping pieces with a random contig: the same records and, call by
    call, the same blastn frames as through the all-path route."""
    picked, db = _draft(np.random.default_rng(4), overlap)
    rng = np.random.default_rng(6)
    g = synth.random_genome(rng, 1600)
    pieces = [_contig("f1", g[:880], 100.0), _contig("f2", g[720:], 110.0),
              _contig("x", synth.random_genome(rng, 400), 20.0)]
    runs = []
    for route in ("score first", "all path"):
        frames = []
        real = _all_path(monkeypatch) if route == "all path" else port_blast.blastn

        def blastn(*args, real=port_blast.blastn, **kwargs):
            frames.append(real(*args, **kwargs))
            return frames[-1]

        monkeypatch.setattr(port_merge.blast, "blastn", blastn)
        got = port_merge.merge_partial(picked, db, 50, 50, 20000, device="cpu")
        seqs = port_merge.merge_sequences(pieces, 50, 60, 20000, device="cpu")
        runs.append((got, seqs, frames))
        monkeypatch.setattr(port_merge.blast, "blastn", real)
    (a, sa, fa), (b, sb, fb) = runs
    assert a[2] == b[2] == joins
    assert _records(a[0]) == _records(b[0]) and _records(a[1]) == _records(b[1])
    assert _records(sa[0]) == _records(sb[0]) and sa[1] == sb[1] == 1
    assert len(fa) == len(fb) >= 3
    for x, y in zip(fa, fb):
        pd.testing.assert_frame_equal(x, y)


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
