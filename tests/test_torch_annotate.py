"""Parity of the port's annotate stage (mitoflex_tpu_torch.stages.annotate,
models.cmsearch, pipeline.run_annotate, the CLI's ``annotate``) with the JAX
package, on the CPU.

Both packages read one profile directory made by the port's fixture
(mitoflex_tpu_torch/testing/profile_fixture.py, with and without the CM
fixture's tRNA / rRNA models) and annotate the same genome. Everything
compared is exact: ``locs.json``, both FASTAs and ``wise.csv`` byte for
byte, and the tRNA / rRNA hits field for field (scores within 1e-3 bits
where the banded CYK on tensors runs, see tests/test_torch_cyk.py).
"""

import json
import os

import numpy as np
import pytest

from mitoflex_tpu.config import AnnotateConfig as JaxAnnotateConfig
from mitoflex_tpu.io.fasta import FastaRecord as JaxRecord
from mitoflex_tpu.models import cmsearch as jax_cmsearch
from mitoflex_tpu.models.profiles import ProfileSet as JaxProfiles
from mitoflex_tpu.stages import annotate as jax_annotate
from mitoflex_tpu_torch import cli as port_cli
from mitoflex_tpu_torch import pipeline as port_pipeline
from mitoflex_tpu_torch.config import AnnotateConfig, PipelineConfig
from mitoflex_tpu_torch.io import encoding
from mitoflex_tpu_torch.io.fasta import FastaRecord
from mitoflex_tpu_torch.models import cmsearch as port_cmsearch
from mitoflex_tpu_torch.models.profiles import ProfileSet
from mitoflex_tpu_torch.stages import annotate as port_annotate
from mitoflex_tpu_torch.testing import profile_fixture

FILES = ("locs.json", "t.annotated.cds.fa", "t.annotated.rna.fa", "t.wise.csv")
SCORE_TOL = 1e-3


@pytest.fixture(scope="module", params=[False, True], ids=["pcg_only", "link_rna"])
def fake(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("annot")
    rng = np.random.default_rng(5)
    return tmp, profile_fixture.build(tmp, rng, link_rna=request.param,
                                      rrna_clen=(220, 260))


@pytest.fixture(scope="module")
def fake_rna(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("annot_rna")
    return profile_fixture.build(tmp, np.random.default_rng(6), link_rna=True,
                                 rrna_clen=(200, 240))


def _files(d):
    out = {}
    for f in FILES:
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


@pytest.fixture(scope="module")
def jax_files(fake):
    tmp, fm = fake
    rec = JaxRecord("mito", fm.genome, {"len": len(fm.genome)})
    res = jax_annotate.annotate(JaxAnnotateConfig(), [rec], JaxProfiles(fm.profile_dir),
                                fm.clade, gene_code=5, basedir=str(tmp / "jax"),
                                prefix="t")
    return res, _files(tmp / "jax")


def _planted(fm, locs):
    """Every planted gene at its planted place and strand (1-based)."""
    for gene, (s, e, strand) in {**fm.gene_pos, **fm.rna_pos}.items():
        kind = 0 if gene in fm.gene_pos else (2 if gene.startswith("rrn") else 1)
        assert tuple(locs[gene]) == (s + 1, e, kind, "mito", "+" if strand > 0 else "-")
    # (a weak extra hit in a random spacer may pass the stage's score gate
    # of 5, in both packages alike)
    assert len(locs) >= len(fm.gene_pos) + len(fm.rna_pos)


def test_annotate_matches_jax(fake, jax_files):
    tmp, fm = fake
    rec = FastaRecord("mito", fm.genome, {"len": len(fm.genome)})
    res = port_annotate.annotate(AnnotateConfig(), [rec], ProfileSet(fm.profile_dir),
                                 fm.clade, gene_code=5, basedir=str(tmp / "port"),
                                 prefix="t", device="cpu")
    want_res, want = jax_files
    got = _files(tmp / "port")
    for f in FILES:
        assert got[f] == want[f], f
    assert res.species == want_res.species and res.missing_trnas == want_res.missing_trnas
    _planted(fm, json.loads(got["locs.json"]))
    assert set(res.walls) == {"tblastn", "genewise", "trna", "rrna"}


def test_run_annotate_and_cli_match_jax(fake, jax_files, tmp_path):
    """pipeline.run_annotate and ``annotate --device cpu`` write the JAX
    package's four files and copy three of them to the results."""
    _, fm = fake
    picked = tmp_path / "picked.fa"
    picked.write_text(f">mito len={len(fm.genome)}\n{fm.genome}\n")
    cfg = PipelineConfig()
    cfg.run.basedir, cfg.run.workname = str(tmp_path), "t"
    cfg.run.profile_dir = fm.profile_dir
    cfg.search.disable_taxa = True
    cfg.annotate.clade, cfg.annotate.genetic_code = fm.clade, 5
    ctx = port_pipeline.PipelineContext.create(cfg, device="cpu")
    res = port_pipeline.run_annotate(ctx, str(picked))
    stage = os.path.dirname(res.path)
    assert _files(stage) == jax_files[1]
    for f in FILES[:3]:
        assert os.path.exists(ctx.workdir.result_file(f))
    manifest = ctx.workdir.read_manifest("annotation")
    assert manifest["species"] == jax_files[0].species and manifest["circular"] is False

    rc = port_cli.main(["annotate", "--fastafile", str(picked), "--workname", "t",
                        "--basedir", str(tmp_path / "cli"), "--device", "cpu",
                        "--disable-taxa", "--profile-dir", fm.profile_dir,
                        "--clade", fm.clade, "--genetic-code", "5"])
    assert rc == 0
    assert _files(tmp_path / "cli" / "t" / "t.temp" / "annotation") == jax_files[1]


def _hit_fields(h):
    return (h.sequence, h.seqfrom, h.seqto, h.plus, h.mdlfrom, h.mdlto, h.amino, h.length)


def test_trna_and_rrna_search_hits_match_jax(fake_rna, monkeypatch):
    """Field for field; the rRNA rescore once on each package's default CPU
    backend (the host banded CYK: scores equal) and once with the banded
    CYK on tensors forced (MITOFLEX_DEVICE_CYK=1: scores within 1e-3)."""
    fm = fake_rna
    jrec = [JaxRecord("mito", fm.genome, {}),
            JaxRecord("rc", encoding.revcomp_str(fm.genome[100:1500]), {})]
    prec = [FastaRecord(r.id, r.seq, {}) for r in jrec]
    jp, pp = JaxProfiles(fm.profile_dir), ProfileSet(fm.profile_dir)
    want, want_missing = jax_cmsearch.trna_search(jrec, jp.trna_cms(), 5, 0.01)
    got, got_missing = port_cmsearch.trna_search(prec, pp.trna_cms(), 5, 0.01,
                                                 device="cpu")
    assert list(got) == list(want) and got_missing == want_missing
    assert {"F", "H", "K", "W"} <= set(got)
    for k in want:
        assert _hit_fields(got[k]) == _hit_fields(want[k])
        assert got[k].score == want[k].score
        assert got[k].alignment.fold == want[k].alignment.fold
    for flag, tol in (("0", 0.0), ("1", SCORE_TOL)):
        monkeypatch.setenv("MITOFLEX_DEVICE_CYK", flag)
        want_r = jax_cmsearch.rrna_search(jrec, jp.rrna_cms(), 0.01)
        got_r = port_cmsearch.rrna_search(prec, pp.rrna_cms(), 0.01, device="cpu")
        for g, w in zip(got_r, want_r):
            assert _hit_fields(g) == _hit_fields(w)
            assert abs(g.score - w.score) <= tol
            assert g.e_value == pytest.approx(w.e_value, rel=1e-2 if tol else 0)


def test_banded_refine_keeps_the_p7_hit_only_for_the_band_check(fake_rna, monkeypatch):
    """The band check's ValueError keeps the filter hit (as the reference
    does for every exception); any other failure of the backend propagates."""
    fm = fake_rna
    model = ProfileSet(fm.profile_dir).rrna_cms()["12s"]
    rec = FastaRecord("mito", fm.genome, {})
    s, e, _ = fm.rna_pos["rrnS"]
    hit = port_cmsearch.CmHit("mito", 99.0, 1e-9, s + 1, e, True, 1, model.clen)

    def refuses(*a, **k):
        raise ValueError("bifurcation band offset exceeds width")

    def breaks(*a, **k):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(port_cmsearch, "_banded_backend", lambda device=None: refuses)
    assert port_cmsearch._cyk_banded_refine(model, rec, hit, device="cpu") is hit
    monkeypatch.setattr(port_cmsearch, "_banded_backend", lambda device=None: breaks)
    with pytest.raises(RuntimeError, match="out of memory"):
        port_cmsearch._cyk_banded_refine(model, rec, hit, device="cpu")
