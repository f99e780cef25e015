"""The port's slices, filter -> assemble -> findmitoscaf, against the JAX
package.

A small circular genome plus a linear decoy (tests/synth.py, the verify
recipe's sizes) runs through both packages' ``run_filter`` and
``run_assemble`` (default assembly configuration: local extension and
scaffolding on). The clean FASTQs and the assembled FASTA must be
byte-identical. The port runs twice: on its CPU host formulations, and with
``uses_host_mirrors`` forced off so the tensor formulations that a CUDA
device runs (device LSM through the plain merge, the tensor graph pass, the
tensor mapper) run on the CPU.

The second slice carries on through findmitoscaf, annotate and visualize on
a genome of the synthetic profile set (tests/profile_fixture.py, four PCGs):
the picked FASTA, the annotation files and the visualize track files must be
byte-identical and the manifest must list every PCG found.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mitoflex_tpu import pipeline as jax_pipeline
from mitoflex_tpu.config import PipelineConfig
from mitoflex_tpu.io import encoding
from mitoflex_tpu_torch import device as port_device
from mitoflex_tpu_torch import kernels
from mitoflex_tpu_torch import pipeline as port_pipeline
from mitoflex_tpu_torch.testing import profile_fixture as port_fixture
from tests import profile_fixture, synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(basedir, workname):
    cfg = PipelineConfig()
    cfg.run.basedir = str(basedir)
    cfg.run.workname = workname
    cfg.search.disable_taxa = True
    cfg.filter.batch_reads = 1024
    cfg.filter.max_read_len = 128
    cfg.assemble.kmer_list = [21, 41]
    cfg.assemble.depth_list = [5, 5]
    cfg.assemble.read_chunk = 1024
    return cfg


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(2026)
    tmp = tmp_path_factory.mktemp("slice")
    genome = synth.random_genome(rng, 4000)
    decoy = synth.random_genome(rng, 1500)
    pairs = synth.shotgun_reads(rng, genome, 1200, read_len=100, insert=300,
                                circular=True, error_rate=0.005)
    pairs += synth.shotgun_reads(rng, decoy, 150, read_len=100, insert=300,
                                 error_rate=0.005)
    pairs = [pairs[i] for i in rng.permutation(len(pairs))]
    f1 = synth.write_fastq(tmp / "r1.fq", [p[0] for p in pairs])
    f2 = synth.write_fastq(tmp / "r2.fq", [p[1] for p in pairs])
    return tmp, f1, f2, genome


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _run(pipeline_mod, cfg, f1, f2, **ctx_kw):
    ctx = pipeline_mod.PipelineContext.create(cfg, **ctx_kw)
    if hasattr(ctx, "mesh"):
        # the reference single-device path (the conftest's 8 virtual CPU
        # devices would otherwise select the sharded one)
        ctx.mesh = None
    res = pipeline_mod.run_filter(ctx, f1, f2)
    out = pipeline_mod.run_assemble(ctx, res.clean1, res.clean2)
    return [_read(res.clean1), _read(res.clean2), _read(out)]


@pytest.fixture(scope="module")
def jax_outputs(inputs):
    tmp, f1, f2, _ = inputs
    return _run(jax_pipeline, _config(tmp, "jax"), f1, f2)


@pytest.mark.parametrize("host_mirrors", [True, False], ids=["host", "tensor"])
def test_slice_matches_jax(inputs, jax_outputs, monkeypatch, host_mirrors):
    """Exact: clean FASTQ 1 and 2 and the assembled FASTA, byte for byte."""
    tmp, f1, f2, genome = inputs
    if not host_mirrors:
        monkeypatch.setattr(port_device, "uses_host_mirrors", lambda d: False)
    got = _run(port_pipeline, _config(tmp, f"port_{host_mirrors}"), f1, f2,
               device="cpu")
    for name, g, w in zip(("clean.1.fq", "clean.2.fq", "assembly"), got, jax_outputs):
        assert g == w, name
    assert _has_planted_circle(got[2].decode(), genome, k=41)


def _has_planted_circle(fa: str, genome: str, k: int) -> bool:
    """A contig flagged circular whose first len - (k - 1) bases (the
    terminal duplication dropped) are the genome up to rotation and strand."""
    doubled = genome + genome
    for rec in fa.split(">")[1:]:
        head, _, body = rec.partition("\n")
        seq = body.replace("\n", "")
        core = seq[: len(seq) - (k - 1)]
        if "flag=1" in head and len(core) == len(genome) and (
                core in doubled or encoding.revcomp_str(core) in doubled):
            return True
    return False


@pytest.mark.parametrize("host_mirrors", [True, False], ids=["host", "tensor"])
def test_assemble_options_off_by_default_match_jax(inputs, monkeypatch, host_mirrors):
    """Exact FASTA: the assemble stage with mercy edges and read
    prefiltering on (both are off by default) and scaffolding skipped."""
    from mitoflex_tpu.stages import assemble as jax_asm
    from mitoflex_tpu_torch.stages import assemble as port_asm

    tmp, f1, f2, _ = inputs
    cfg = _config(tmp, "opts").assemble
    cfg.no_mercy = False
    cfg.prefilter_reads = True
    outs = []
    for name, fn, kw in (("jax", jax_asm.assemble, {}),
                         ("port", port_asm.assemble, {"device": "cpu"})):
        if name == "port" and not host_mirrors:
            monkeypatch.setattr(port_device, "uses_host_mirrors", lambda d: False)
        out = str(tmp / f"opts_{name}_{host_mirrors}.fa")
        fn(cfg, f1, f2, out, max_read_len=128, host_shard=(0, 1), **kw)
        outs.append(_read(out))
    assert outs[0] == outs[1] and outs[0].count(b">") >= 1


@pytest.fixture(scope="module")
def fms_inputs(tmp_path_factory):
    rng = np.random.default_rng(7)
    tmp = tmp_path_factory.mktemp("slice_fms")
    # the port's fixture: its profile directory also holds the CM fixture's
    # tRNA and rRNA models, planted in the genome, and both packages read it
    fake = port_fixture.build(tmp, rng, spacer=600, link_rna=True,
                              rrna_clen=(200, 230))
    decoy = synth.random_genome(rng, 1500)
    pairs = synth.shotgun_reads(rng, fake.genome, 1500, read_len=100, insert=300,
                                circular=True, error_rate=0.005)
    pairs += synth.shotgun_reads(rng, decoy, 150, read_len=100, insert=300,
                                 error_rate=0.005)
    pairs = [pairs[i] for i in rng.permutation(len(pairs))]
    f1 = synth.write_fastq(tmp / "r1.fq", [p[0] for p in pairs])
    f2 = synth.write_fastq(tmp / "r2.fq", [p[1] for p in pairs])
    return tmp, f1, f2, fake


def _run_through_findmitoscaf(pipeline_mod, tmp, workname, fake, f1, f2, **ctx_kw):
    cfg = _config(tmp, workname)
    cfg.run.profile_dir = fake.profile_dir
    cfg.annotate.clade = fake.clade
    cfg.annotate.genetic_code = 5
    cfg.search.min_abundance = 10
    ctx = pipeline_mod.PipelineContext.create(cfg, **ctx_kw)
    if hasattr(ctx, "mesh"):
        ctx.mesh = None
    res = pipeline_mod.run_filter(ctx, f1, f2)
    contigs = pipeline_mod.run_assemble(ctx, res.clean1, res.clean2)
    picked = pipeline_mod.run_findmitoscaf(ctx, contigs)
    manifest = ctx.workdir.read_manifest("findmitoscaf")
    picked = getattr(picked, "path", picked)
    ann = pipeline_mod.run_annotate(ctx, picked)
    stage = ctx.workdir.stage_dir("annotation")
    annotated = {"locs.json": _read(os.path.join(stage, "locs.json"))}
    for f in ("annotated.cds.fa", "annotated.rna.fa", "wise.csv"):
        annotated[f] = _read(os.path.join(stage, f"{workname}.{f}"))
    # the JAX package returns (locs, path, circular), the port a result object
    locs, circular = (ann[0], ann[2]) if isinstance(ann, tuple) else (ann.locs, ann.circular)
    outs = pipeline_mod.run_visualize(ctx, picked, locs, res.clean1, res.clean2,
                                      circular=circular)
    vdir = ctx.workdir.stage_dir("visualize")
    tracks = {}
    for path in outs:
        name = os.path.basename(path).replace(f"{workname}.", "", 1)
        if path.endswith((".png", ".svg")):
            assert os.path.getsize(ctx.workdir.result_file(os.path.basename(path))) > 0
        elif name == "circos.conf":
            tracks[name] = _read(path).replace(vdir.encode(), b"<DIR>").replace(
                f"{workname}.".encode(), b"<W>.")
        else:
            tracks[name] = _read(path)
    annotated["visualize"] = (tracks, circular)
    return _read(picked), manifest, annotated


@pytest.fixture(scope="module")
def jax_picked(fms_inputs):
    tmp, f1, f2, fake = fms_inputs
    return _run_through_findmitoscaf(jax_pipeline, tmp, "jax", fake, f1, f2)


_PORT_RUNS = {}


def _port_through_annotate(fms_inputs, host_mirrors):
    """The port's run of the slice through annotate, made once per
    formulation (the caller has patched ``uses_host_mirrors`` if needed)."""
    if host_mirrors not in _PORT_RUNS:
        tmp, f1, f2, fake = fms_inputs
        _PORT_RUNS[host_mirrors] = _run_through_findmitoscaf(
            port_pipeline, tmp, f"port_{host_mirrors}", fake, f1, f2, device="cpu")
    return _PORT_RUNS[host_mirrors]


@pytest.mark.parametrize("host_mirrors", [True, False], ids=["host", "tensor"])
def test_slice_through_findmitoscaf_matches_jax(fms_inputs, jax_picked, monkeypatch,
                                                host_mirrors):
    """Exact: the picked FASTA, byte for byte; it holds the planted circle
    and the manifest lists the same PCGs, all four found."""
    tmp, f1, f2, fake = fms_inputs
    if not host_mirrors:
        monkeypatch.setattr(port_device, "uses_host_mirrors", lambda d: False)
    got, manifest, _ = _port_through_annotate(fms_inputs, host_mirrors)
    want, want_manifest, _ = jax_picked
    assert got == want
    assert _has_planted_circle(got.decode(), fake.genome, k=41)
    assert manifest["found_pcgs"] == want_manifest["found_pcgs"] == profile_fixture.GENES
    assert manifest["missing_pcgs"] == want_manifest["missing_pcgs"] == []


@pytest.mark.parametrize("host_mirrors", [True, False], ids=["host", "tensor"])
def test_slice_through_annotate_matches_jax(fms_inputs, jax_picked, monkeypatch,
                                            host_mirrors):
    """Exact: filter -> assemble -> findmitoscaf -> annotate gives the JAX
    package's ``locs.json``, both annotated FASTAs and ``wise.csv``, byte
    for byte; ``locs.json`` lists the four PCGs, the four planted tRNAs and
    both rRNAs."""
    import json

    if not host_mirrors:
        monkeypatch.setattr(port_device, "uses_host_mirrors", lambda d: False)
    _, _, got = _port_through_annotate(fms_inputs, host_mirrors)
    _, _, want = jax_picked
    got = {k: v for k, v in got.items() if k != "visualize"}
    want = {k: v for k, v in want.items() if k != "visualize"}
    assert sorted(got) == sorted(want) and len(got) == 4
    for name in want:
        assert got[name] == want[name], name
    locs = json.loads(got["locs.json"])
    fake = fms_inputs[3]
    assert set(fake.gene_pos) | set(fake.rna_pos) <= set(locs)
    for gene, (s, e, _) in {**fake.gene_pos, **fake.rna_pos}.items():
        assert locs[gene][1] - locs[gene][0] == e - s - 1, gene


@pytest.mark.parametrize("host_mirrors", [True, False], ids=["host", "tensor"])
def test_slice_through_visualize_matches_jax(fms_inputs, jax_picked, monkeypatch,
                                             host_mirrors):
    """Exact: the run carried on into visualize gives the JAX package's seven
    text track files byte for byte and its ``circos.conf`` up to the
    directory, drawn with the same ``circular``; its depth track has one row
    per base and every gene of ``locs.json`` has its row in ``gene.txt``."""
    if not host_mirrors:
        monkeypatch.setattr(port_device, "uses_host_mirrors", lambda d: False)
    _, _, got = _port_through_annotate(fms_inputs, host_mirrors)
    (tracks, circular), (want, want_circular) = got["visualize"], jax_picked[2]["visualize"]
    assert circular == want_circular
    assert sorted(tracks) == sorted(want) == sorted([
        "gene.txt", "features.txt", "depth.txt", "gc.txt", "karyotype.txt",
        "plus.txt", "tracks.json", "circos.conf"])
    for name in want:
        assert tracks[name] == want[name], name
    locs = json.loads(got["locs.json"])
    genes = [row.split("\t") for row in tracks["gene.txt"].decode().splitlines()]
    assert len(genes) == len(locs)
    for gene, v in locs.items():
        assert ["mt1", str(v[0]), str(v[1]), gene.split("_")[0]] in genes, gene
    lengths = {k["id"]: k["length"] for k in json.loads(tracks["tracks.json"])["karyotype"]}
    assert tracks["depth.txt"].count(b"\n") == sum(lengths.values())
    assert (b"break = 0.01r" in tracks["circos.conf"]) == circular


def test_port_runs_without_jax(tmp_path):
    """In a fresh interpreter the port filters a batch, merges two runs,
    imports every ported module (the device mesh's included), runs its
    CLI's filter, findmitoscaf,
    annotate and ``all`` (the five stages, on paired reads), then
    ``check_circular`` and ``ncbi --help``; no subcommand is left that exits
    with 3, and neither jax nor any module of the JAX package
    (``mitoflex_tpu`` or ``mitoflex_tpu.*``) enters sys.modules."""
    rng = np.random.default_rng(1)
    reads = synth.shotgun_reads(rng, synth.random_genome(rng, 800), 50, read_len=80)
    fq = synth.write_fastq(tmp_path / "in.fq", reads)
    fake = profile_fixture.build(tmp_path, rng)
    fa = tmp_path / "contigs.fa"
    fa.write_text(f">c1 flag=1 multi=100.0 len={len(fake.genome)}\n{fake.genome}\n")
    pairs = synth.shotgun_reads(rng, fake.genome, 700, read_len=100, insert=300,
                                circular=True, error_rate=0.002)
    p1 = synth.write_fastq(tmp_path / "p1.fq", [p[0] for p in pairs])
    p2 = synth.write_fastq(tmp_path / "p2.fq", [p[1] for p in pairs])
    common = ["--basedir", str(tmp_path), "--device", "cpu", "--disable-taxa",
              "--profile-dir", fake.profile_dir, "--clade", fake.clade,
              "--genetic-code", "5"]
    fms_args = ["findmitoscaf", "--fastafile", str(fa), "--from-megahit",
                "--workname", "f", "--merge-method", "2"] + common
    picked = tmp_path / "f" / "f.result" / "f.picked.fa"
    ann_args = ["annotate", "--fastafile", str(picked), "--workname", "a"] + common
    all_args = ["all", "--fastq1", p1, "--fastq2", p2, "--workname", "e2e",
                "--kmer-list", "21,41", "--depth-list", "5,5",
                "--min-abundance", "10"] + common
    code = f"""
import json, os, sys
import numpy as np, torch
from mitoflex_tpu_torch.ops import filter as F, kmer as K
from mitoflex_tpu_torch.cli import main
from mitoflex_tpu_torch import check_circular, ncbi
from mitoflex_tpu_torch.parallel import graph_mesh, mesh
seqs = torch.from_numpy(np.random.default_rng(0).integers(0, 5, (64, 32)).astype(np.int8))
quals = torch.full((64, 32), 60, dtype=torch.int8)
lens = torch.full((64,), 32, dtype=torch.int32)
keep, h1, h2 = F.filter_reads(seqs, quals, lens, 10, 55, 0.2)
run = K.count_chunk_scattered(seqs, lens, 21)
merged = K.merge_scattered(run, run)
os.environ["MITOFLEX_TORCH_PROFILE"] = {str(tmp_path / "prof")!r}
rc = main(["filter", "--fastq1", {fq!r}, "--workname", "w", "--basedir",
           {str(tmp_path)!r}, "--device", "cpu", "--disable-taxa"])
del os.environ["MITOFLEX_TORCH_PROFILE"]  # trace the filter command only
rc_mods = main(["load_modules"])
rc_fms = main({fms_args!r})
rc_ann = main({ann_args!r})
rc_all = main({all_args!r})
rc_cc = check_circular.main(["--fasta", {str(picked)!r}, "--length", "1000",
                             "--output", {str(tmp_path / "cc.json")!r}])
try:
    rc_ncbi = ncbi.main(["--help"])
except SystemExit as e:
    rc_ncbi = e.code
jax_pkg = sorted(m for m in sys.modules
                 if m == "mitoflex_tpu" or m.startswith("mitoflex_tpu."))
print(json.dumps({{"jax": "jax" in sys.modules, "jax_pkg": jax_pkg, "rc": rc,
                  "rc_mods": rc_mods, "rc_fms": rc_fms, "rc_ann": rc_ann,
                  "rc_all": rc_all, "rc_cc": rc_cc, "rc_ncbi": rc_ncbi,
                  "rows": merged[0].shape[1],
                  "keep": int(keep.sum())}}))
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=str(tmp_path), env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out == {"jax": False, "jax_pkg": [], "rc": 0, "rc_mods": 0,
                   "rc_fms": 0, "rc_ann": 0, "rc_all": 0, "rc_cc": 0, "rc_ncbi": 0,
                   "rows": 2 * 64 * 12, "keep": out["keep"]}
    assert "".join(picked.read_text().split("\n")[1:]) == fake.genome
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    locs = json.loads((tmp_path / "a" / "a.result" / "locs.json").read_text())
    assert set(profile_fixture.GENES) <= set(locs)
    assert "stages.visualize" in r.stdout and "check_circular" in r.stdout
    assert "parallel.mesh" in r.stdout and "parallel.graph_mesh" in r.stdout
    # `all` ran without --keep-temp: the results stay, the stage files go
    e2e = tmp_path / "e2e"
    assert sorted(os.listdir(e2e / "e2e.result")) == [
        "e2e.annotated.cds.fa", "e2e.annotated.rna.fa", "e2e.picked.fa", "e2e.png",
        "e2e.svg", "locs.json"]
    assert not (e2e / "e2e.temp").exists()
    summary = [json.loads(ln) for ln in r.stdout.splitlines()
               if ln.startswith('{"picked"') and '"plots"' in ln]
    assert len(summary) == 1 and list(summary[0]) == ["picked", "locs", "circular", "plots"]
    assert set(profile_fixture.GENES) <= set(
        json.loads((e2e / "e2e.result" / "locs.json").read_text()))
    assert list(json.loads((tmp_path / "cc.json").read_text())) == ["c1"]


def test_chip_smoke_imports_only_the_port():
    """The smoke script imports as a module without a card, and neither the
    import nor any import statement in its source reaches jax, the JAX
    package or the test suite: numpy, torch, the standard library and
    mitoflex_tpu_torch only."""
    import ast

    code = """
import json, sys
import chip_smoke
print(json.dumps(sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                        or m == "mitoflex_tpu" or m.startswith("mitoflex_tpu.")
                        or m == "tests" or m.startswith("tests."))))
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            roots.add(node.module.split(".")[0])
    assert {"numpy", "torch", "mitoflex_tpu_torch"} <= roots
    assert roots - {"numpy", "torch", "mitoflex_tpu_torch"} <= set(sys.stdlib_module_names)


def test_kernel_loader_needs_no_nvcc():
    """The loader imports and names its build without compiling anything;
    every source compiles for sm_90a and the link makes a shared library."""
    cmds = [kernels.compile_command(s, s + ".o") for s in kernels.SOURCES]
    for src, cmd in zip(kernels.SOURCES, cmds):
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert {"-c", "-O3", "-std=c++17"} <= set(cmd)
        assert [os.path.basename(c) for c in cmd if c.endswith(".cu")] == [src]
    assert kernels.SOURCES == ("filter.cu", "merge.cu", "sort.cu", "viterbi.cu", "sw.cu",
                               "cyk.cu", "genewise.cu")
    link = kernels.link_command(["a.o", "b.o"], "libx.so")
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in link
    assert kernels._lib is None
    assert os.path.dirname(kernels.BUILD_DIR) == os.path.join(REPO, "mitoflex_tpu_torch")
