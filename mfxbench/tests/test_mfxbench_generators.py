"""The generators: the same seed gives the same data, and the data has the
shapes the configurations and traffic mixes state."""

import json
import os

import numpy as np
import pytest

from mfxbench import harness
from mfxbench.generators import draft_contigs, mitogenome, wgs_reads
from mfxbench.reference import filter_rule, hmm as ref_hmm

SEED = 3_000_000_123  # past 32 signed bits, as a run's seed may be


@pytest.fixture(scope="module")
def mito(tmp_path_factory):
    spec = harness.load_json("configs", "arthropod_all.json")["mitogenome"]
    return mitogenome.build(spec, str(tmp_path_factory.mktemp("m")))


def test_mfxbench_mitogenome_shapes(mito):
    kinds = [v[3] for v in mito.genes.values()]
    assert (kinds.count(0), kinds.count(1), kinds.count(2)) == (13, 22, 2)
    assert 15_500 <= len(mito.genome) <= 16_500
    spans = sorted((s, e) for s, e, _, _ in mito.genes.values())
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # no overlaps
    pdir = mito.profile_dir
    assert len(os.listdir(os.path.join(pdir, "tRNA_CM"))) == 22
    assert sorted(os.listdir(os.path.join(pdir, "rRNA_CM"))) == ["12s.cm", "16s.cm"]
    with open(os.path.join(pdir, "CDS_HMM", "Arthropoda.hmm")) as f:
        models = ref_hmm.parse(f.read())
    assert {m: models[m].length for m in models} == mito.hmm_lengths
    with open(os.path.join(pdir, "MT_database", "Arthropoda.fa")) as f:
        assert sum(line.startswith(">") for line in f) == 13 * 20
    for gene, (s, e, strand, kind) in mito.genes.items():
        if kind == 0:
            nt = mito.genome[s:e] if strand > 0 else mitogenome.revcomp(mito.genome[s:e])
            assert nt == mito.pcg_nt[gene] and nt.startswith("ATG")


def test_mfxbench_mitogenome_deterministic(mito, tmp_path):
    spec = harness.load_json("configs", "arthropod_all.json")["mitogenome"]
    again = mitogenome.build(spec, str(tmp_path / "a"))
    other = mitogenome.build(dict(spec, seed=spec["seed"] + 1), str(tmp_path / "b"))
    assert again.genome == mito.genome and again.genes == mito.genes
    assert other.genome != mito.genome


def test_mfxbench_wgs_reads(mito, tmp_path):
    params = harness.load_json("traffic", "wgs.json")
    paths, bases, truth = wgs_reads.generate(mito, params, SEED, 0, str(tmp_path / "s"))
    again = wgs_reads.generate(mito, params, SEED, 0, str(tmp_path / "t"))
    other = wgs_reads.generate(mito, params, SEED, 1, str(tmp_path / "u"))
    with open(paths["fastq1"], "rb") as f, open(again[0]["fastq1"], "rb") as g:
        assert f.read() == g.read()
    assert not np.array_equal(truth.r1, other[2].r1)
    assert 12.0e6 <= bases <= 12.8e6  # about 12.4 Mbp a sample
    n_mito = int((truth.source == 0).sum())
    assert n_mito == len(mito.genome) * 400 // 300
    keep = filter_rule.keep_pairs(truth.r1, truth.q1, truth.r2, truth.q2, 10, 55, 0.2)
    dropped = 1 - keep.mean()
    assert 0.04 <= dropped <= 0.07   # 5% of pairs fail the bad-base rule, 0.1% the N rule
    assert ((truth.r1 == 4).sum(1) > 10).mean() == pytest.approx(0.001, abs=0.0005)


def test_mfxbench_draft_contigs(mito, tmp_path):
    params = harness.load_json("traffic", "draft.json")
    paths, bases, truth = draft_contigs.generate(mito, params, SEED, 0, str(tmp_path / "d"))
    lengths, multis, mito_seen = [], [], 0
    with open(paths["contigs"]) as f:
        for line in f:
            if line.startswith(">"):
                attrs = dict(t.split("=") for t in line.split()[1:])
                if line[1:].split()[0] == truth.mito_id:
                    mito_seen += 1
                    assert float(attrs["multi"]) == 400 and attrs["flag"] == "1"
                else:
                    lengths.append(int(attrs["len"]))
                    multis.append(float(attrs["multi"]))
    lengths = np.array(lengths)
    assert mito_seen == 1 and sum(lengths) == 10_000_000
    assert lengths.min() >= 200 and lengths.max() <= 20_000
    assert 900 <= np.median(lengths) <= 1100
    assert 15 <= min(multis) and max(multis) <= 25
    assert 5_000 <= len(lengths) <= 7_500   # several thousand contigs a draft
    again = draft_contigs.generate(mito, params, SEED, 0, str(tmp_path / "e"))
    with open(paths["contigs"]) as f, open(again[0]["contigs"]) as g:
        assert f.read() == g.read()


def test_mfxbench_configs_state_their_cuts():
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        cfg = harness.load_json("configs", f"{c['name']}.json")
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert cfg["reduced"] == c["reduced"]
        for key in cfg["reduced"]:
            assert key in cfg and key in cfg["published"] and cfg[key] != cfg["published"][key]
        assert cfg["assumed"] and cfg["deployment"]
