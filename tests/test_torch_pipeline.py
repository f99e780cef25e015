"""``run_all`` (with resume and the command line) and ``run_bim`` of the port
against the JAX package's, on the CPU.

One seeded read set (the four-PCG profile fixture's genome as a circle,
100 bp pairs) goes through ``run_all`` once per package; the ``all``, resume
and command-line cases share those two runs. Every comparison is exact:
text files byte for byte, ``circos.conf`` and the summary after the run's
directory is replaced, the PNG as decoded pixels.
"""

import json
import os
import shutil

import numpy as np
import pytest

from mitoflex_tpu import pipeline as jax_pipeline
from mitoflex_tpu.config import PipelineConfig as JaxPipelineConfig
from mitoflex_tpu_torch import cli as port_cli
from mitoflex_tpu_torch import pipeline as port_pipeline
from mitoflex_tpu_torch.config import PipelineConfig
from mitoflex_tpu_torch.io import encoding, fasta
from mitoflex_tpu_torch.utils.logger import logger as port_logger
from tests import profile_fixture, synth

# stage directory -> files that must be byte-identical ({w}: the workname)
STAGE_TEXT = {
    "cleandata": ["clean.1.fq", "clean.2.fq"],
    "assemble": ["contigs.fa", "scaffolds.fa"],
    "findmitoscaf": ["{w}.picked.fa"],
    "annotation": ["locs.json", "{w}.annotated.cds.fa", "{w}.annotated.rna.fa",
                   "{w}.wise.csv"],
    "visualize": ["{w}.gene.txt", "{w}.features.txt", "{w}.depth.txt", "{w}.gc.txt",
                  "{w}.karyotype.txt", "{w}.plus.txt", "{w}.tracks.json"],
}
RESULT_FILES = ["locs.json", "{w}.annotated.cds.fa", "{w}.annotated.rna.fa",
                "{w}.picked.fa", "{w}.png", "{w}.svg"]


def _pairs(rng, genome, n, circular):
    comp = str.maketrans("ACGT", "TGCA")
    g2 = genome + genome[:400] if circular else genome
    out = []
    for _ in range(n):
        s = rng.integers(0, len(g2) - 300)
        frag = g2[s: s + 300]
        out.append((frag[:100], frag[-100:].translate(comp)[::-1]))
    return out


def _write(tmp, stem, pairs):
    f1 = synth.write_fastq(tmp / f"{stem}1.fq", [(a, "I" * 100) for a, _ in pairs])
    f2 = synth.write_fastq(tmp / f"{stem}2.fq", [(b, "I" * 100) for _, b in pairs])
    return str(f1), str(f2)


def _settings(tmp, workname, fake, **extra):
    d = {
        "run": {"workname": workname, "basedir": str(tmp), "profile_dir": fake.profile_dir,
                "keep_temp": True},
        "filter": {"batch_reads": 1024, "max_read_len": 128},
        "assemble": {"kmer_list": [21, 41], "depth_list": [5, 5]},
        "search": {"min_abundance": 10, "disable_taxa": True},
        "annotate": {"clade": fake.clade, "genetic_code": 5},
    }
    for section, values in extra.items():
        d.setdefault(section, {}).update(values)
    return d


def _context(pipeline_mod, cfg):
    if pipeline_mod is port_pipeline:
        return pipeline_mod.PipelineContext.create(cfg, device="cpu")
    ctx = pipeline_mod.PipelineContext.create(cfg)
    ctx.mesh = None  # the single-device path, whatever the virtual devices
    return ctx


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory):
    """{"jax" / "port": (context, summary)} of one ``run_all`` per package on
    the same reads; the raw reads are deleted afterwards."""
    tmp = tmp_path_factory.mktemp("all")
    rng = np.random.default_rng(55)
    fake = profile_fixture.build(tmp, rng)
    f1, f2 = _write(tmp, "r", _pairs(rng, fake.genome, 1200, True))
    runs = {}
    for name, mod, cfg_cls in (("jax", jax_pipeline, JaxPipelineConfig),
                               ("port", port_pipeline, PipelineConfig)):
        ctx = _context(mod, cfg_cls.from_dict(_settings(tmp, name, fake)))
        runs[name] = (ctx, mod.run_all(ctx, f1, f2))
    os.remove(f1)
    os.remove(f2)
    return tmp, fake, runs, (f1, f2)


def _neutral(value, ctx):
    """A summary value with the run's directory and workname taken out."""
    text = json.dumps(value)
    root, w = ctx.workdir.root, ctx.cfg.run.workname
    return json.loads(text.replace(root, "<ROOT>").replace(f"{w}.", "<W>."))


def test_run_all_summary_matches_jax(all_runs):
    """Same keys in the same order, same values up to the directory and the
    workname; every path the summary names exists."""
    _, _, runs, _ = all_runs
    (jctx, want), (pctx, got) = runs["jax"], runs["port"]
    assert list(got) == list(want) == ["picked", "locs", "circular", "plots"]
    assert _neutral(got, pctx) == _neutral(want, jctx)
    assert isinstance(got["picked"], str) and isinstance(got["circular"], bool)
    for p in [got["picked"], got["locs"], *got["plots"]]:
        assert os.path.exists(p), p
    assert len(got["plots"]) == 1


@pytest.mark.parametrize("stage", list(STAGE_TEXT))
def test_run_all_stage_files_match_jax(all_runs, stage):
    """Exact: every text file of the stage, byte for byte."""
    _, _, runs, _ = all_runs
    n = 0
    for name in STAGE_TEXT[stage]:
        paths = [os.path.join(ctx.workdir.stage_dir(stage), name.format(w=w))
                 for w, (ctx, _) in runs.items()]
        if stage == "assemble" and not all(os.path.exists(p) for p in paths):
            assert not any(os.path.exists(p) for p in paths), name
            continue
        assert _read(paths[0]) == _read(paths[1]), name
        assert len(_read(paths[1])) > 0 or name.endswith("rna.fa"), name
        n += 1
    assert n >= 1


def test_run_all_figure_conf_results_and_manifests_match_jax(all_runs):
    """circos.conf equal after the directory is replaced, PNG pixels equal,
    the SVG there; the result directories hold the same six files; the
    stage manifests agree but for paths and the time written."""
    from matplotlib.image import imread

    _, fake, runs, _ = all_runs
    conf, png, results, manifests = {}, {}, {}, {}
    for w, (ctx, _) in runs.items():
        vdir = ctx.workdir.stage_dir("visualize")
        conf[w] = _read(os.path.join(vdir, f"{w}.circos.conf")).decode().replace(
            vdir, "<DIR>").replace(f"{w}.", "<W>.")
        png[w] = imread(os.path.join(vdir, f"{w}.png"))
        assert os.path.getsize(os.path.join(vdir, f"{w}.svg")) > 0
        results[w] = sorted(f.replace(f"{w}.", "{w}.") for f in os.listdir(ctx.workdir.result))
        manifests[w] = {}
        for stage in ("cleandata", "assemble", "findmitoscaf", "annotation", "visualize"):
            m = ctx.workdir.read_manifest(stage)
            m.pop("_written_at")
            manifests[w][stage] = _neutral(m, ctx)
    assert conf["port"] == conf["jax"]
    np.testing.assert_array_equal(png["port"], png["jax"])
    assert results["port"] == results["jax"] == sorted(RESULT_FILES)
    assert manifests["port"] == manifests["jax"]
    assert manifests["port"]["findmitoscaf"]["found_pcgs"] == profile_fixture.GENES
    picked = fasta.load_fasta(runs["port"][1]["picked"])
    dbl = fake.genome + fake.genome
    assert any(r.seq[:1500] in dbl or encoding.revcomp_str(r.seq[:1500]) in dbl
               for r in picked)


def _log(ctx):
    with open(ctx.workdir.log_path) as f:
        return f.read()


def test_run_all_resume_skips_three_stages(all_runs):
    """With the raw reads deleted, ``resume=True`` skips cleandata, assemble
    and findmitoscaf (and only those), reruns annotate and visualize and
    returns the first run's summary."""
    _, _, runs, (f1, f2) = all_runs
    ctx, first = runs["port"]
    assert not os.path.exists(f1)
    # the logger follows the context made last; bring it back to this run
    port_logger.init(ctx.workdir.log_path, ctx.cfg.run.log_level)
    before = _log(ctx).count("resume: skipping")
    again = port_pipeline.run_all(ctx, f1, f2, resume=True)
    assert again == first
    log = _log(ctx)
    for stage in ("cleandata", "assemble", "findmitoscaf"):
        assert f"resume: skipping {stage}" in log
    assert log.count("resume: skipping") == before + 3
    assert "resume: skipping annotation" not in log and "skipping visualize" not in log


def _json_line(out):
    """The command's one JSON line (the logger also writes to stdout)."""
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out
    return json.loads(lines[0])


def _cli_copy(all_runs, workname):
    """A copy of the port's finished work directory under another base
    directory (its manifests rewritten to the copy), and the ``all --resume``
    command line for it."""
    tmp, fake, runs, (f1, f2) = all_runs
    src = runs["port"][0].workdir.root
    base = tmp / workname
    dst = base / "port"
    shutil.copytree(src, dst)
    for stage in ("cleandata", "assemble", "findmitoscaf"):
        p = dst / "port.temp" / stage / "manifest.json"
        p.write_text(p.read_text().replace(src, str(dst)))
    return dst, ["all", "--fastq1", f1, "--fastq2", f2, "--workname", "port",
                 "--basedir", str(base), "--device", "cpu", "--resume",
                 "--clade", fake.clade, "--profile-dir", fake.profile_dir,
                 "--kmer-list", "21,41", "--depth-list", "5,5", "--min-abundance", "10",
                 "--disable-taxa", "--genetic-code", "5"]


@pytest.mark.parametrize("keep_temp", [True, False], ids=["keep-temp", "clean-temp"])
def test_cli_all_resume_and_clean_temp(all_runs, capsys, keep_temp):
    """``all --resume`` through the command line on a finished work
    directory: exit 0, one JSON line with the summary's keys; the stage
    directories stay with ``--keep-temp`` and go without it, while the
    result directory keeps its six files either way."""
    dst, argv = _cli_copy(all_runs, f"cli_{keep_temp}")
    before = (dst / "port.log").read_text().count("resume: skipping")
    rc = port_cli.main(argv + (["--keep-temp"] if keep_temp else []))
    assert rc == 0
    summary = _json_line(capsys.readouterr().out)
    assert list(summary) == ["picked", "locs", "circular", "plots"]
    assert summary["picked"].startswith(str(dst))
    assert (dst / "port.temp").is_dir() == keep_temp
    assert os.path.exists(summary["picked"]) == keep_temp
    assert sorted(os.listdir(dst / "port.result")) == sorted(
        f.format(w="port") for f in RESULT_FILES)
    log = (dst / "port.log").read_text()
    assert log.count("resume: skipping") == before + 3


def test_cli_visualize_matches_the_all_run(all_runs, capsys):
    """``visualize`` alone on the picked FASTA with ``--locs`` and the clean
    reads writes the track files the ``all`` run wrote (byte for byte; its
    ``--circular`` flag is the run's ``circular``)."""
    tmp, _, runs, _ = all_runs
    ctx, summary = runs["port"]
    clean = [ctx.workdir.stage_file("cleandata", f"clean.{i}.fq") for i in (1, 2)]
    argv = ["visualize", "--fastafile", summary["picked"], "--locs", summary["locs"],
            "--fastq1", clean[0], "--fastq2", clean[1], "--workname", "port",
            "--basedir", str(tmp / "vis"), "--device", "cpu", "--disable-taxa"]
    assert port_cli.main(argv + (["--circular"] if summary["circular"] else [])) == 0
    outs = _json_line(capsys.readouterr().out)["outputs"]
    assert len(outs) == 10
    vdir = tmp / "vis" / "port" / "port.temp" / "visualize"
    for name in STAGE_TEXT["visualize"]:
        name = name.format(w="port")
        assert _read(vdir / name) == _read(ctx.workdir.stage_file("visualize", name)), name
    assert (tmp / "vis" / "port" / "port.result" / "port.png").exists()


def test_cli_bug_class_failure_logs_the_process_state(tmp_path, monkeypatch, capsys):
    """An exception that is no RuntimeError exits with 2 and logs the
    process state (resident memory, open files, threads, system memory)."""
    def boom(*a, **k):
        raise KeyError("planted")

    monkeypatch.setattr(port_pipeline, "run_filter", boom)
    fq = synth.write_fastq(tmp_path / "in.fq", [("ACGT" * 20, "I" * 80)])
    rc = port_cli.main(["filter", "--fastq1", fq, "--workname", "w", "--basedir",
                        str(tmp_path), "--device", "cpu", "--disable-taxa"])
    assert rc == 2
    log = (tmp_path / "w" / "w.log").read_text()
    assert "this looks like a bug" in log
    assert "process state: rss=" in log and "open_files=" in log and "threads=" in log
    assert "system memory:" in log
    # an environment problem (RuntimeError) exits with 1 and logs no state
    monkeypatch.setattr(port_pipeline, "run_filter",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("no reads")))
    rc = port_cli.main(["filter", "--fastq1", fq, "--workname", "w1", "--basedir",
                        str(tmp_path), "--device", "cpu", "--disable-taxa"])
    assert rc == 1
    assert "process state" not in (tmp_path / "w1" / "w1.log").read_text()


def test_cli_process_state_without_psutil(tmp_path, monkeypatch):
    """Where ``psutil`` cannot be imported the log says so; nothing else of
    the failure's handling changes."""
    import builtins

    real_import = builtins.__import__

    def no_psutil(name, *a, **k):
        if name == "psutil":
            raise ImportError("No module named 'psutil'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(port_pipeline, "run_filter",
                        lambda *a, **k: (_ for _ in ()).throw(KeyError("planted")))
    monkeypatch.setattr(builtins, "__import__", no_psutil)
    fq = synth.write_fastq(tmp_path / "in.fq", [("ACGT" * 20, "I" * 80)])
    rc = port_cli.main(["filter", "--fastq1", fq, "--workname", "w", "--basedir",
                        str(tmp_path), "--device", "cpu", "--disable-taxa"])
    monkeypatch.undo()
    assert rc == 2
    log = (tmp_path / "w" / "w.log").read_text()
    assert "psutil is not installed" in log and "rss=" not in log


def test_cli_process_state_survives_an_unreadable_item(tmp_path, monkeypatch):
    """A reading that psutil cannot take (``open_files`` raises in some
    containers) is named in its place: the exit status stays 2 and the other
    readings are logged."""
    import psutil

    def broken(self):
        raise IndexError("list index out of range")

    monkeypatch.setattr(psutil.Process, "open_files", broken)
    monkeypatch.setattr(port_pipeline, "run_filter",
                        lambda *a, **k: (_ for _ in ()).throw(KeyError("planted")))
    fq = synth.write_fastq(tmp_path / "in.fq", [("ACGT" * 20, "I" * 80)])
    rc = port_cli.main(["filter", "--fastq1", fq, "--workname", "w", "--basedir",
                        str(tmp_path), "--device", "cpu", "--disable-taxa"])
    assert rc == 2
    log = (tmp_path / "w" / "w.log").read_text()
    assert "open_files=unreadable (IndexError)" in log
    assert "rss=" in log and "MiB" in log and "system memory:" in log


@pytest.fixture(scope="module")
def bim_runs(tmp_path_factory):
    """One ``run_bim`` per package at tests/test_bim.py's size, two
    generations, findmitoscaf from the second on (``i > iteration_ignore``
    with ``iteration_ignore`` 0), the insert size estimated."""
    tmp = tmp_path_factory.mktemp("bim")
    rng = np.random.default_rng(77)
    fake = profile_fixture.build(tmp, rng)
    nuclear = synth.random_genome(rng, 2500)
    f1, f2 = _write(tmp, "b", _pairs(rng, fake.genome, 1200, True)
                    + _pairs(rng, nuclear, 200, False))
    extra = {"assemble": {"min_multi": 3, "prune_depth": 2, "prune_level": 2,
                          "insert_size": 222},
             "search": {"merge_method": 2},
             "bim": {"max_iteration": 2, "iteration_ignore": 0, "insert_size_auto": True}}
    runs = {}
    for name, mod, cfg_cls in (("jax", jax_pipeline, JaxPipelineConfig),
                               ("port", port_pipeline, PipelineConfig)):
        ctx = _context(mod, cfg_cls.from_dict(_settings(tmp, name, fake, **extra)))
        runs[name] = (ctx, mod.run_bim(ctx, f1, f2))
    return fake, runs


def test_run_bim_matches_jax(bim_runs):
    """Exact: the picked FASTA, both generations' baited FASTQs and
    contigs, byte for byte; the planted genome is recovered as
    tests/test_bim.py asks."""
    fake, runs = bim_runs
    (jctx, want), (pctx, got) = runs["jax"], runs["port"]
    assert isinstance(got, str) and got.endswith("port.picked.fa")
    assert _read(got) == _read(want)
    for name in ("bim.0.1.fq", "bim.0.2.fq", "bim.0.contigs.fa",
                 "bim.1.1.fq", "bim.1.2.fq", "bim.1.contigs.fa"):
        assert _read(pctx.workdir.stage_file("assemble", name)) == \
            _read(jctx.workdir.stage_file("assemble", name)), name
    best = max(fasta.load_fasta(got), key=lambda p: len(p.seq))
    dbl = fake.genome + fake.genome
    assert best.seq in dbl or encoding.revcomp_str(best.seq) in dbl
    assert len(best.seq) > len(fake.genome) - 50


def test_run_bim_config_and_generations(bim_runs):
    """The scaffolding toggle is restored, the insert size is the estimate
    (the same in both packages, and no longer the configured 222), and
    findmitoscaf ran for generation 1 only: the strict ``i >
    iteration_ignore``."""
    _, runs = bim_runs
    (jctx, _), (pctx, _) = runs["jax"], runs["port"]
    assert pctx.cfg.assemble.disable_scaffolding is False
    assert pctx.cfg.assemble.insert_size == jctx.cfg.assemble.insert_size != 222
    assert 250 <= pctx.cfg.assemble.insert_size <= 350
    m = pctx.workdir.read_manifest("findmitoscaf")
    assert [os.path.basename(p) for p in m["inputs"]] == ["bim.1.contigs.fa"]
    log = _log(pctx)
    assert log.count("bim: generation") == 2 and "bim: estimated insert size" in log
    assert log.count("stages.findmitoscaf.findmitoscaf after") == 1
