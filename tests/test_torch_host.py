"""The port's own copies of the host modules against the JAX package's
originals.

The port imports nothing of ``mitoflex_tpu``; it keeps a copy of every host
module it needs (FASTA/FASTQ I/O, config, CLI parser, overlap, spill, graph
cleaning, profile models, the native C++ engines, the synthetic fixtures).
Each test feeds the same inputs, made from a seed with numpy, to a copy and
to its original. Everything here is integers, strings and bytes, so every
comparison is exact.
"""

import dataclasses
import gzip
import os

import numpy as np
import pytest

from mitoflex_tpu import cli as jax_cli
from mitoflex_tpu import config as jax_config
from mitoflex_tpu.io import encoding as jax_encoding
from mitoflex_tpu.io import fasta as jax_fasta
from mitoflex_tpu.io import fastq as jax_fastq
from mitoflex_tpu.io import prefetch as jax_prefetch
from mitoflex_tpu.models import codon as jax_codon
from mitoflex_tpu.models import hmm as jax_hmm
from mitoflex_tpu.models import profiles as jax_profiles
from mitoflex_tpu.models import proteindb as jax_proteindb
from mitoflex_tpu.models import taxonomy as jax_taxonomy
from mitoflex_tpu.native import dedup_native as jax_dedup
from mitoflex_tpu.native import fastq_native as jax_fastq_native
from mitoflex_tpu.native import graph_native as jax_graph_native
from mitoflex_tpu.native import merge_native as jax_merge_native
from mitoflex_tpu.ops import overlap as jax_overlap
from mitoflex_tpu.ops import spill as jax_spill
from mitoflex_tpu.parallel import distributed as jax_dist
from mitoflex_tpu.stages import graph_clean as jax_graph_clean
from mitoflex_tpu.utils import seq as jax_seq
from mitoflex_tpu.utils import workdir as jax_workdir
from mitoflex_tpu_torch import cli as port_cli
from mitoflex_tpu_torch import config as port_config
from mitoflex_tpu_torch.io import encoding as port_encoding
from mitoflex_tpu_torch.io import fasta as port_fasta
from mitoflex_tpu_torch.io import fastq as port_fastq
from mitoflex_tpu_torch.io import prefetch as port_prefetch
from mitoflex_tpu_torch.models import codon as port_codon
from mitoflex_tpu_torch.models import hmm as port_hmm
from mitoflex_tpu_torch.models import profiles as port_profiles
from mitoflex_tpu_torch.models import proteindb as port_proteindb
from mitoflex_tpu_torch.models import taxonomy as port_taxonomy
from mitoflex_tpu_torch.native import dedup_native as port_dedup
from mitoflex_tpu_torch.native import fastq_native as port_fastq_native
from mitoflex_tpu_torch.native import graph_native as port_graph_native
from mitoflex_tpu_torch.native import merge_native as port_merge_native
from mitoflex_tpu_torch.ops import overlap as port_overlap
from mitoflex_tpu_torch.ops import spill as port_spill
from mitoflex_tpu_torch.parallel import distributed as port_dist
from mitoflex_tpu_torch.stages import assemble as port_assemble
from mitoflex_tpu_torch.stages import graph_clean as port_graph_clean
from mitoflex_tpu_torch.testing import profile_fixture as port_fixture
from mitoflex_tpu_torch.testing import synth as port_synth
from mitoflex_tpu_torch.utils import seq as port_seq
from mitoflex_tpu_torch.utils import workdir as port_workdir
from tests import profile_fixture, synth

BOTH_IO = [(jax_fasta, jax_fastq), (port_fasta, port_fastq)]


def _seq(rng, n, alphabet="ACGTN"):
    return "".join(rng.choice(list(alphabet), n))


# ------------------------------------------------------------------ io
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encoding(seed):
    """encode / decode / reverse complement / GC content."""
    rng = np.random.default_rng(seed)
    s = _seq(rng, 257, "ACGTNacgtnRY")
    want = jax_encoding.encode(s)
    got = port_encoding.encode(s)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert port_encoding.decode(got) == jax_encoding.decode(want)
    np.testing.assert_array_equal(port_encoding.revcomp(got), jax_encoding.revcomp(want))
    assert port_encoding.revcomp_str(s.upper()) == jax_encoding.revcomp_str(s.upper())
    assert port_encoding.gc_content(got) == jax_encoding.gc_content(want)
    assert port_encoding.encode(s.encode()).tolist() == want.tolist()


@pytest.mark.parametrize("suffix", [".fa", ".fa.gz"])
def test_fasta_round_trip(tmp_path, suffix):
    """A FASTA written by either package is read back identically by both,
    plain and gzip, header attributes included."""
    files = {}
    for name, (fa, _) in zip(("jax", "port"), BOTH_IO):
        recs = [fa.FastaRecord(f"c{i}", _seq(np.random.default_rng(i), 50 + 37 * i),
                               {"flag": i % 3, "multi": 1.5 * i, "len": 50 + 37 * i})
                for i in range(5)] + [fa.FastaRecord("bare", "ACGTNN")]
        files[name] = fa.write_fasta(recs, str(tmp_path / f"{name}{suffix}"), width=60)
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(files["jax"], "rb") as f, opener(files["port"], "rb") as g:
        assert f.read() == g.read()
    want = jax_fasta.load_fasta(files["jax"])
    got = port_fasta.load_fasta(files["jax"])
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    assert len(want) == 6
    for g, w in zip(got, want):
        assert (g.flag, g.multi, g.circular, g.header()) == \
            (w.flag, w.multi, w.circular, w.header())
        np.testing.assert_array_equal(g.codes, w.codes)
        assert g.with_attrs(flag=1).attrs == w.with_attrs(flag=1).attrs
    gb = port_fasta.ContigBatch.from_records(got)
    wb = jax_fasta.ContigBatch.from_records(want)
    assert gb.ids == wb.ids
    for name in ("codes", "lengths", "multi", "flags"):
        np.testing.assert_array_equal(getattr(gb, name), getattr(wb, name))
        assert getattr(gb, name).dtype == getattr(wb, name).dtype


def _fastq_files(tmp_path):
    rng = np.random.default_rng(11)
    genome = synth.random_genome(rng, 1500)
    pairs = synth.shotgun_reads(rng, genome, 180, read_len=90, insert=250)
    f1 = synth.write_fastq(tmp_path / "r1.fq", [p[0] for p in pairs])
    f2 = synth.write_fastq(tmp_path / "r2.fq", [p[1] for p in pairs])
    return str(f1), str(f2)


def _batch_tuple(b):
    return (b.seqs.tolist(), b.quals.tolist(), b.lengths.tolist(), b.count, b.names)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("keep_names", [False, True], ids=["native", "python"])
def test_fastq_round_trip(tmp_path, compress, keep_names):
    """Batches read by both packages are equal (through the native reader
    where names are not kept, the Python parser where they are), and what
    both writers write from them is byte-identical, plain and gzip."""
    f1, f2 = _fastq_files(tmp_path)
    outs = {}
    for name, (_, fq) in zip(("jax", "port"), BOTH_IO):
        batches = list(fq.read_batches(f1, 64, 96, keep_names=keep_names))
        outs[name] = [_batch_tuple(b) for b in batches]
        path = str(tmp_path / f"{name}.fq") + (".gz" if compress else "")
        with fq.FastqWriter(path, compress=compress) as w:
            for b in batches:
                keep = np.arange(b.capacity) % 3 != 0
                w.write_batch(b, keep)
        opener = gzip.open if compress else open
        with opener(path, "rb") as f:
            outs[name + "_bytes"] = f.read()
        outs[name + "_pairs"] = [
            (_batch_tuple(a), _batch_tuple(b))
            for a, b in fq.read_pair_batches(f1, f2, 50, 96)]
        outs[name + "_stream"] = list(fq.FastqStream(f1))[:7]
    assert outs["port"] == outs["jax"] and len(outs["jax"]) == 3
    assert outs["port_bytes"] == outs["jax_bytes"]
    assert outs["port_pairs"] == outs["jax_pairs"]
    assert outs["port_stream"] == outs["jax_stream"]


def test_fastq_native_reader(tmp_path):
    """The port's native FASTQ reader, built from the port's own sources
    into its own library, against the JAX package's."""
    f1, _ = _fastq_files(tmp_path)
    if not (jax_fastq_native.available() and port_fastq_native.available()):
        pytest.skip("no C++ toolchain with zlib on this host")
    assert os.path.basename(port_fastq_native.build()) == port_fastq_native.LIB_NAME
    assert port_fastq_native.LIB_NAME != "libmfxnative.so"
    assert os.path.dirname(port_fastq_native.build()) == port_fastq_native.BUILD_DIR
    for limit in (0, 5000):
        want = [_batch_tuple(b) for b in jax_fastq_native.read_batches(f1, 50, 80, limit)]
        got = [_batch_tuple(b) for b in port_fastq_native.read_batches(f1, 50, 80, limit)]
        assert got == want and want


def test_prefetch_and_byte_ranges(tmp_path):
    """The prefetch iterator yields its source in order; the FASTQ
    byte-range splitters cut the same record-aligned ranges."""
    f1, f2 = _fastq_files(tmp_path)
    for mod in (jax_prefetch, port_prefetch):
        with mod.prefetch(iter(range(37)), depth=3) as it:
            assert list(it) == list(range(37))
    for n in (1, 3, 4):
        for pid in range(n):
            assert port_dist.host_file_range(f1, pid, n) == \
                jax_dist.host_file_range(f1, pid, n)
            assert port_dist.host_pair_ranges(f1, f2, pid, n) == \
                jax_dist.host_pair_ranges(f1, f2, pid, n)
    assert port_dist.shard_info() == (0, 1)


# --------------------------------------------------------------- utils
def test_seq_headers_and_workdir(tmp_path):
    """Header attribute codec and the work directory layout / manifests."""
    for d in ("flag=1 multi=12.5 len=300", "a=b c=3 d=4.0", ""):
        assert port_seq.decompile(d) == jax_seq.decompile(d)
    attrs = {"flag": 3, "multi": 7.25, "len": 99, "note": "x"}
    assert port_seq.compile_seq(attrs, "id1") == jax_seq.compile_seq(attrs, "id1")
    assert port_seq.contig_header("c", 1, 2.5, 30) == jax_seq.contig_header("c", 1, 2.5, 30)
    h = jax_seq.contig_header("c", 1, 2.5, 30)
    assert port_seq.parse_contig_header(h) == jax_seq.parse_contig_header(h)
    assert port_seq.MERGED_MULTI_SENTINEL == jax_seq.MERGED_MULTI_SENTINEL
    layouts = []
    for name, mod in (("j", jax_workdir), ("p", port_workdir)):
        wd = mod.WorkDir(str(tmp_path / name), "w").create()
        wd.write_manifest("filter", {"reads": 5, "files": ["a", "b"]})
        layouts.append((
            os.path.relpath(wd.stage_file("filter", "x.fq"), str(tmp_path / name)),
            os.path.relpath(wd.result_file("y.fa"), str(tmp_path / name)),
            os.path.relpath(wd.log_path, str(tmp_path / name)),
            {k: v for k, v in wd.read_manifest("filter").items() if k != "_written_at"},
            wd.read_manifest("assemble"),
            wd.stage_complete("filter"), wd.stage_complete("assemble"),
            sorted(os.listdir(wd.root))))
    assert layouts[0] == layouts[1]


# ----------------------------------------------------------------- ops
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_overlap_and_check_circular(seed):
    """seq_overlap, check_circular and trim_circular on sequences with a
    planted terminal overlap (and with none)."""
    rng = np.random.default_rng(seed)
    core = _seq(rng, 400, "ACGT")
    ov = _seq(rng, 30 + 10 * seed, "ACGT")
    circ = ov + core + ov
    other = _seq(rng, 300, "ACGT")
    assert port_overlap.seq_overlap(core + ov, ov + other) == \
        jax_overlap.seq_overlap(core + ov, ov + other)
    assert port_overlap.seq_overlap(core, other) == jax_overlap.seq_overlap(core, other)
    kw = dict(minimum_length=300, start_length=120, end_length=120, overlaps=20)
    for text in (circ, core, core[:200]):
        recs = [(port_fasta.FastaRecord("c", text, {"flag": 0})),
                (jax_fasta.FastaRecord("c", text, {"flag": 0}))]
        got = [(info, dataclasses.astuple(r))
               for info, r in port_overlap.check_circular([recs[0]], **kw)]
        want = [(info, dataclasses.astuple(r))
                for info, r in jax_overlap.check_circular([recs[1]], **kw)]
        assert got == want and len(want) == 1
        got = port_overlap.trim_circular(recs[0], **kw)
        want = jax_overlap.trim_circular(recs[1], **kw)
        assert (dataclasses.astuple(got[0]), got[1]) == \
            (dataclasses.astuple(want[0]), want[1])
    assert want[1] is False and jax_overlap.trim_circular(
        jax_fasta.FastaRecord("c", circ, {}), **kw)[1] is True


@pytest.mark.parametrize("W,canonical", [(1, True), (2, True), (3, False)])
def test_spill_buckets(tmp_path, W, canonical):
    """Sorted runs spilled to the disk buckets come back bucket by bucket
    with the same keys and counts from both packages."""
    results = []
    for name, mod in (("j", jax_spill), ("p", port_spill)):
        os.makedirs(tmp_path / name)
        sp = mod.BucketSpill(W, n_buckets=8, base_dir=str(tmp_path / name),
                             canonical=canonical)
        r = np.random.default_rng(W)
        for _ in range(3):
            keys = r.integers(0, 2**32, (500, W), dtype=np.uint64).astype(np.uint32)
            keys = keys[np.lexsort(tuple(keys[:, w] for w in range(W - 1, -1, -1)))]
            sp.append(keys, r.integers(1, 9, 500).astype(np.uint32))
        results.append(([[(k.tolist(), c.tolist()) for k, c in sp.read_bucket(b)]
                         for b in range(8)], sp.inner.tolist(), sp.rows,
                        sp.bytes_written))
        sp.cleanup()
    assert results[0] == results[1] and results[0][2] == 1500


def test_graph_clean_on_a_small_graph(tmp_path, monkeypatch):
    """The cleaning rounds of a small assembly (a genome with planted
    variants, so tips and bubbles occur), recorded from the port's assemble
    stage, give the same kill masks and popped bubbles in the JAX package's
    graph_clean; the string helpers agree too."""
    rng = np.random.default_rng(9)
    genome = synth.random_genome(rng, 1200)
    variant = list(genome)
    for pos in (300, 700):
        variant[pos] = "A" if variant[pos] != "A" else "C"
    pairs = synth.shotgun_reads(rng, genome, 500, read_len=80, insert=200,
                                error_rate=0.01)
    pairs += synth.shotgun_reads(rng, "".join(variant), 120, read_len=80, insert=200)
    f1 = synth.write_fastq(tmp_path / "r1.fq", [p[0] for p in pairs])
    f2 = synth.write_fastq(tmp_path / "r2.fq", [p[1] for p in pairs])
    calls = []
    analyze = port_graph_clean.analyze_round

    def recorded(*args):
        res = analyze(*args)
        calls.append((args, res))
        return res

    monkeypatch.setattr(port_graph_clean, "analyze_round", recorded)
    cfg = port_config.AssembleConfig(kmer_list=[21, 31], depth_list=[3, 3],
                                     min_multi=2, prune_depth=2, prune_level=2)
    port_assemble.assemble(cfg, str(f1), str(f2), str(tmp_path / "out.fa"),
                           read_chunk=512, max_read_len=96, device="cpu")
    assert calls
    n_bad = 0
    for (uset, in_deg, out_deg, pre, suf, ecnt, k, params), got in calls:
        want = jax_graph_clean.analyze_round(
            uset, in_deg, out_deg, pre, suf, ecnt, k,
            jax_graph_clean.CleanParams(**dataclasses.asdict(params)))
        np.testing.assert_array_equal(got.bad_nodes, want.bad_nodes)
        np.testing.assert_array_equal(got.bad_edges, want.bad_edges)
        assert [dataclasses.astuple(b) for b in got.bubbles] == \
            [dataclasses.astuple(b) for b in want.bubbles]
        n_bad += int(got.bad_nodes.sum()) + int(got.bad_edges.sum())
    assert n_bad > 0
    a, b = genome[:60], "".join(variant)[280:340]
    assert port_graph_clean.edit_distance(a, b) == jax_graph_clean.edit_distance(a, b)
    assert port_graph_clean.seq_similarity(a, b) == jax_graph_clean.seq_similarity(a, b)
    assert port_graph_clean._canonical(a) == jax_graph_clean._canonical(a)


# -------------------------------------------------------------- models
def test_profile_set_parsing(tmp_path):
    """The synthetic profile set: HMM text, protein database, required
    genes, genetic code and codon tables parse to the same values."""
    fake = profile_fixture.build(tmp_path, np.random.default_rng(4))
    want_set = jax_profiles.ProfileSet(fake.profile_dir)
    got_set = port_profiles.get_profiles(fake.profile_dir)
    assert got_set.clades() == want_set.clades() == [fake.clade]
    assert got_set.required_cds(fake.clade) == want_set.required_cds(fake.clade)
    assert got_set.genetic_code(fake.clade) == want_set.genetic_code(fake.clade) == 5
    want = want_set.cds_hmms(fake.clade)
    got = got_set.cds_hmms(fake.clade)
    assert len(got) == len(want) == len(profile_fixture.GENES)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f.name
    hmm_path = os.path.join(fake.profile_dir, "CDS_HMM", f"{fake.clade}.hmm")
    out = {}
    for name, mod in (("j", jax_hmm), ("p", port_hmm)):
        path = str(tmp_path / f"{name}.hmm")
        mod.write_hmm_file(mod.load_hmm_file(hmm_path), path)
        with open(path) as f:
            out[name] = f.read()
    assert out["j"] == out["p"]
    for fn in ("protein_db", ):
        w, g = getattr(want_set, fn)(fake.clade), getattr(got_set, fn)(fake.clade)
        assert [dataclasses.astuple(r)[:5] for r in g] == \
            [dataclasses.astuple(r)[:5] for r in w]
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.aa_codes, b.aa_codes)
            assert a.length == b.length
    pid = "gi_NC_000101_COX1_Drosophila_melanogaster_100_aa"
    assert port_proteindb.parse_protein_id(pid) == jax_proteindb.parse_protein_id(pid)
    assert len(port_proteindb.load_merged(fake.profile_dir)) == \
        len(jax_proteindb.load_merged(fake.profile_dir))


@pytest.mark.parametrize("table_id", [1, 2, 5])
def test_codon_tables(table_id):
    """Genetic code tables, six-frame translation and BLOSUM62."""
    rng = np.random.default_rng(table_id)
    want, got = jax_codon.get_code(table_id), port_codon.get_code(table_id)
    assert got.forward == want.forward
    s = _seq(rng, 301, "ACGT")
    assert got.translate_str(s) == want.translate_str(s)
    codes = jax_encoding.encode(s)
    for (gf, gp), (wf, wp) in zip(port_codon.six_frame_translate(codes, table_id),
                                  jax_codon.six_frame_translate(codes, table_id)):
        assert gf == wf
        np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(port_codon.blosum62(), jax_codon.blosum62())
    pep = want.translate_str(s)
    np.testing.assert_array_equal(port_codon.aa_encode(pep), jax_codon.aa_encode(pep))
    assert port_codon.aa_decode(port_codon.aa_encode(pep)) == \
        jax_codon.aa_decode(jax_codon.aa_encode(pep))


def test_taxonomy():
    """The built-in metazoan taxonomy: ids, lineages, ranks and the
    required-taxon test."""
    want, got = jax_taxonomy.builtin_metazoa(), port_taxonomy.load_taxonomy(None)
    for name in ("Drosophila melanogaster", "Homo sapiens", "Arthropoda", "Nope"):
        tid = want.get_taxid(name)
        assert got.get_taxid(name) == tid
        assert got.get_rank_dict(name) == want.get_rank_dict(name)
        assert got.rank_of_name(name) == want.rank_of_name(name)
        if tid is not None:
            assert got.lineage(tid) == want.lineage(tid)
        for req in ("Arthropoda", "Chordata"):
            for relax in (0, 2):
                assert got.matches_required(name, req, relax) == \
                    want.matches_required(name, req, relax)


# ------------------------------------------------------ config and CLI
ARGVS = [
    ["filter", "--fastq1", "a.fq", "--fastq2", "b.fq", "--ns-valve", "5",
     "--quality-valve", "50", "--percentage-valve", "0.3", "--keep-region", "0,100",
     "--deduplication", "--workname", "w1"],
    ["assemble", "--fastq1", "a.fq", "--kmer-list", "21,41,61", "--depth-list",
     "3,5,7", "--prune-level", "3", "--disable-local", "--insert-size", "300"],
    ["findmitoscaf", "--fastafile", "c.fa", "--from-megahit", "--clade", "Arthropoda",
     "--genetic-code", "5", "--min-abundance", "12.5", "--merge-method", "2",
     "--disable-taxa", "--level", "debug"],
    ["all", "--fastq1", "a.fq", "--resume", "--Ns-valve", "7", "--trimming", "0.5",
     "--basedir", "/tmp/x", "--keep-temp"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[a[0] for a in ARGVS])
def test_config_and_cli(tmp_path, argv):
    """Defaults, build_parser + resolve_config on the same argv, and the
    generated config file."""
    assert dataclasses.asdict(port_config.PipelineConfig()) == \
        dataclasses.asdict(jax_config.PipelineConfig())
    want_args = jax_cli.build_parser().parse_args(argv)
    got_args = port_cli.build_parser().parse_args(argv)
    assert vars(got_args) == vars(want_args)
    want = jax_cli.resolve_config(want_args)
    got = port_cli.resolve_config(got_args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.validate() == want.validate() == []
    jax_config.generate_config(want, str(tmp_path / "j.py"))
    port_config.generate_config(got, str(tmp_path / "p.py"))
    # the header comment names the package that wrote the file
    assert (tmp_path / "j.py").read_text().replace("mitoflex_tpu", "mitoflex_tpu_torch") \
        == (tmp_path / "p.py").read_text()
    loaded = port_config.load_config_file(str(tmp_path / "j.py"))
    assert dataclasses.asdict(loaded) == dataclasses.asdict(
        jax_config.load_config_file(str(tmp_path / "j.py")))


def test_cli_rejects_what_the_original_rejects():
    for argv in (["filter", "--fastq1", "a.fq", "--keep-region", "x"],
                 ["assemble", "--fastq1", "a.fq", "--level", "loud"],
                 ["assemble", "--fastq1", "a.fq", "--kmer-list", "20,40"]):
        codes = []
        for mod in (jax_cli, port_cli):
            with pytest.raises(SystemExit) as e:
                mod.resolve_config(mod.build_parser().parse_args(argv))
            codes.append(e.value.code)
        assert codes[0] == codes[1] == 2


# ------------------------------------------------------ native engines
def _need_native():
    if jax_merge_native._lib() is None or port_merge_native._lib() is None:
        pytest.skip("no C++ toolchain with zlib on this host")


@pytest.mark.parametrize("W,op", [(1, "sum"), (2, "sum"), (2, "max"), (4, "sum")])
def test_native_merge_engine(W, op):
    """merge_counts of the port's library against the JAX package's."""
    _need_native()
    rng = np.random.default_rng(W)

    def run(n):
        keys = rng.integers(0, 40, (n, W), dtype=np.uint64).astype(np.uint32)
        keys[:, :-1] //= 20  # few distinct leading words, so whole keys recur
        keys = np.unique(keys, axis=0)
        return keys, rng.integers(1, 100, len(keys)).astype(np.uint64)

    a, b = run(700), run(900)
    want = jax_merge_native.merge_counts(*a, *b, op)
    got = port_merge_native.merge_counts(*a, *b, op)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(want[0]) < len(a[0]) + len(b[0])


@pytest.mark.parametrize("k", [15, 21, 31])
def test_native_graph_engine(k):
    """graph_pass and unitig_build of the port's library against the JAX
    package's, on the both-strand edge table of a small genome."""
    _need_native()
    from mitoflex_tpu_torch.ops import kmer as port_kmer

    rng = np.random.default_rng(k)
    genome = synth.random_genome(rng, 900)
    reads = [genome[i:i + 70] for i in range(0, 830, 7)]
    seqs = np.full((len(reads), 70), 4, np.int8)
    for i, r in enumerate(reads):
        seqs[i] = jax_encoding.encode(r)
    lens = np.full(len(reads), 70, np.int32)
    keys, counts = port_kmer.count_chunk_host(seqs, lens, k + 1, canonical=False)
    want = jax_graph_native.graph_pass(keys, counts, k)
    got = port_graph_native.graph_pass(keys, counts, k)
    assert want is not None and got is not None and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_native_dedup_engine():
    """The dedup hash set: the same keep mask for the same key stream."""
    _need_native()
    rng = np.random.default_rng(3)
    want_set, got_set = jax_dedup.NativeDedupSet(1 << 10), port_dedup.NativeDedupSet(1 << 10)
    for _ in range(4):
        keys = rng.integers(0, 300, (500, 2), dtype=np.uint64).astype(np.uint32)
        active = rng.random(500) < 0.9
        np.testing.assert_array_equal(got_set.check_and_add(keys, active),
                                      want_set.check_and_add(keys, active))
    assert len(got_set) == len(want_set) > 0


# ------------------------------------------------------------ fixtures
@pytest.mark.parametrize("spacer", [120, 2440])
def test_synthetic_fixtures(tmp_path, spacer):
    """The port's synth / profile_fixture against the test suite's own with
    one seed: the same genome (13,220 bp at spacer 2440, the smoke run's),
    the same profile files, the same reads and FASTQ bytes."""
    outs = []
    for name, (fx, sy) in (("t", (profile_fixture, synth)),
                           ("p", (port_fixture, port_synth))):
        rng = np.random.default_rng(2026)
        fake = fx.build(tmp_path / name, rng, spacer=spacer)
        decoy = sy.random_genome(rng, 500)
        pairs = sy.shotgun_reads(rng, fake.genome, 40, read_len=100, insert=300,
                                 circular=True, error_rate=0.01)
        pairs += sy.shotgun_reads(rng, decoy, 10, read_len=100, insert=300)
        fq = sy.write_fastq(tmp_path / name / "r.fq", [p[0] for p in pairs])
        files = {}
        for root, _, names in os.walk(fake.profile_dir):
            for n in names:
                with open(os.path.join(root, n), "rb") as f:
                    files[os.path.relpath(os.path.join(root, n), fake.profile_dir)] = f.read()
        with open(fq, "rb") as f:
            outs.append((fake.genome, fake.gene_pos, fake.gene_nt, fake.clade, decoy,
                         pairs, f.read(), files))
    assert outs[0] == outs[1]
    assert fx.GENES == profile_fixture.GENES
    if spacer == 2440:
        assert len(outs[1][0]) == 13220
