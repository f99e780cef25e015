"""The port's visualize stage (mitoflex_tpu_torch/stages/visualize.py,
bio/circos.py) against the JAX package's, on the CPU.

Seeded inputs go through both packages. Every comparison is exact: the
seven text track files byte for byte, ``circos.conf`` after each run's output
directory is replaced, the PNG as decoded pixels, the depth arrays element
for element. The SVG carries a date and generated ids, so it is only parsed
as XML.
"""

import json
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from mitoflex_tpu.bio import circos as jax_circos
from mitoflex_tpu.config import VisualizeConfig as JaxVisualizeConfig
from mitoflex_tpu.io import fastq as jax_fastq
from mitoflex_tpu.io.fasta import FastaRecord as JaxRecord
from mitoflex_tpu.ops import mapper as jax_mapper
from mitoflex_tpu.stages import visualize as jax_vis
from mitoflex_tpu_torch import convert
from mitoflex_tpu_torch import device as port_device
from mitoflex_tpu_torch.bio import circos as port_circos
from mitoflex_tpu_torch.config import VisualizeConfig
from mitoflex_tpu_torch.io import encoding
from mitoflex_tpu_torch.io.fasta import FastaRecord
from mitoflex_tpu_torch.stages import visualize as port_vis
from tests import synth

TEXT_TRACKS = ("gene.txt", "features.txt", "depth.txt", "gc.txt",
               "karyotype.txt", "plus.txt", "tracks.json")


@pytest.mark.parametrize("seed,n,window", [(0, 1000, 50), (1, 777, 50), (2, 30, 50),
                                           (3, 4096, 128)])
def test_gc_windows(seed, n, window):
    """Exact (a ratio of the same two integers): windows that divide the
    length, a remainder that is dropped, a sequence shorter than one
    window, and Ns that count in neither part."""
    codes = np.random.default_rng(seed).integers(0, 5, n).astype(np.int8)
    np.testing.assert_array_equal(port_vis.gc_windows(codes, window),
                                  jax_vis.gc_windows(codes, window))
    assert len(port_vis.gc_windows(codes, window)) == max(n // window, 1)


def test_circos_text_nested():
    """The same nested tree gives the same text: blocks, duplicate keys
    through trailing underscores, a value that replaces a vivified node,
    and vivified nodes that were never set."""
    texts = []
    for mod in (jax_circos, port_circos):
        c = mod.Circos()
        c.ideogram.spacing.default = "0.01r"
        c.ideogram.spacing.break_ = "0.5r"
        c.image.radius = "1500p"
        c.plots.plot.type = "histogram"
        c.plots.plot_.type = "line"
        c.plots.plot_.axes.axis.spacing = "0.05r"
        c.plots.plot_.axes.axis_.position = "0.5r"
        _ = c.some.deep.node
        c.leaf.sub.x = 1
        c.leaf = "now a value"
        c.show_ticks = "yes"
        texts.append(mod.circos_text(c))
        assert "some" not in c.collapse()
    assert texts[0] == texts[1]
    assert texts[1].count("<plot>") == 2 and texts[1].count("<axis>") == 2
    assert "break = 0.5r" in texts[1] and "leaf = now a value" in texts[1]
    assert port_circos.dict2circos({"a": {"b_": 1}}) == jax_circos.dict2circos({"a": {"b_": 1}})


def _case(name, tmp_path):
    """(records as (id, seq, attrs), locs, reads, keyword arguments)."""
    rng = np.random.default_rng({"renders": 11, "cap": 12, "two": 13, "circular": 14}[name])
    g = synth.random_genome(rng, 2000)
    if name == "renders":
        recs = [("scaffold1", g, {"flag": 1, "multi": 100, "len": 2000})]
        locs = {"COX1": (100, 500, 0, "scaffold1", "+"),
                "ND1": (600, 900, 0, "scaffold1", "-"),
                "trnK": (950, 1020, 1, "scaffold1", "+"),
                "rrnS": (1100, 1700, 2, "scaffold1", "+")}
        reads = [g[i: i + 100] for i in range(0, 1900, 40)]
        kw = {}
    elif name == "cap":
        recs = [("s1", g, {"flag": 1, "multi": 50, "len": 2000})]
        locs = {"COX1": (100, 500, 0, "s1", "+")}
        reads = [g[i: i + 100] for i in range(0, 1900, 10)]
        kw = {"max_depth_reads": 40}
    elif name == "two":
        h = synth.random_genome(rng, 900)
        recs = [("a", g, {"flag": 0, "multi": 30.5, "len": 2000}),
                ("b", h, {"flag": 0, "multi": 12.0, "len": 900})]
        locs = {"COX1": (100, 500, 0, "a", "+"), "COX1_2": (50, 400, 0, "b", "-"),
                "trnF": (600, 668, 1, "b", "+"), "elsewhere": (1, 9, 7, "zz", "+")}
        reads = ([g[i: i + 100] for i in range(0, 1900, 25)]
                 + [encoding.revcomp_str(h[i: i + 90]) for i in range(0, 800, 30)]
                 + [synth.random_genome(rng, 100) for _ in range(7)])
        kw = {}
    else:
        recs = [("ring", g, {"flag": 1, "multi": 80, "len": 2000})]
        locs = {"ATP6": (10, 700, 0, "ring", "-"), "rrnL": (800, 1900, 2, "ring", "-")}
        reads = [g[i: i + 120] for i in range(0, 1880, 20)]
        kw = {"circular": True}
    if name in ("renders", "cap"):  # one file; the others: two files
        halves = [reads]
    else:
        halves = [reads[0::2], reads[1::2]]
    fqs = [synth.write_fastq(tmp_path / f"r{i + 1}.fq", [(r, "I" * len(r)) for r in half])
           for i, half in enumerate(halves)] + [None]
    return recs, locs, fqs[0], fqs[1], kw


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("host_mirrors", [True, False], ids=["host", "tensor"])
@pytest.mark.parametrize("name", ["renders", "cap", "two", "circular"])
def test_visualize_matches_jax(tmp_path, monkeypatch, name, host_mirrors):
    """Exact, for the port's host mapper and for the tensor mapper a card
    runs: the list of files, the seven text tracks, circos.conf up to the
    directory, the PNG's pixels; the SVG parses."""
    from matplotlib.image import imread

    recs, locs, fq1, fq2, kw = _case(name, tmp_path)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jax_vis.visualize(JaxVisualizeConfig(), [JaxRecord(*r) for r in recs], locs,
                             str(tmp_path / "jax" / "plot"), fastq1=fq1, fastq2=fq2, **kw)
    if not host_mirrors:
        monkeypatch.setattr(port_device, "uses_host_mirrors", lambda d: False)
    got = port_vis.visualize(VisualizeConfig(), [FastaRecord(*r) for r in recs],
                             convert.locs_from_reference(json.loads(json.dumps(locs))),
                             str(tmp_path / "port" / "plot"), fastq1=fq1, fastq2=fq2,
                             device="cpu", **kw)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 10
    for t in TEXT_TRACKS:
        assert _read(tmp_path / "port" / f"plot.{t}") == _read(tmp_path / "jax" / f"plot.{t}"), t
    conf = {side: _read(tmp_path / side / "plot.circos.conf").decode().replace(
        str(tmp_path / side), "<DIR>") for side in ("jax", "port")}
    assert conf["port"] == conf["jax"] and "<DIR>" in conf["port"]
    assert ("break = 0.01r" in conf["port"]) == bool(kw.get("circular"))
    np.testing.assert_array_equal(imread(tmp_path / "port" / "plot.png"),
                                  imread(tmp_path / "jax" / "plot.png"))
    assert ET.parse(tmp_path / "port" / "plot.svg").getroot().tag.endswith("svg")
    tracks = json.loads(_read(tmp_path / "port" / "plot.tracks.json"))
    assert [k["id"] for k in tracks["karyotype"]] == [f"mt{i + 1}" for i in range(len(recs))]
    assert min(tracks["depth_mean"].values()) > 0


@pytest.mark.parametrize("host_mirrors", [True, False], ids=["host", "tensor"])
@pytest.mark.parametrize("name", ["cap", "two"])
def test_build_tracks_depth_matches_jax(tmp_path, monkeypatch, name, host_mirrors):
    """Exact: the depth arrays that ``build_tracks`` hands to ``render``
    equal the JAX mapper's on the batches the stage reads (width 256, the
    cap ending after the batch that crosses it); ``build_tracks`` writes the
    eight track files and no figure, and needs no matplotlib."""
    recs, locs, fq1, fq2, kw = _case(name, tmp_path)
    if not host_mirrors:
        monkeypatch.setattr(port_device, "uses_host_mirrors", lambda d: False)
    tracks = port_vis.build_tracks(VisualizeConfig(), [FastaRecord(*r) for r in recs],
                                   locs, str(tmp_path / "plot"), fastq1=fq1, fastq2=fq2,
                                   device="cpu", **kw)

    def batches():
        for path in (fq1, fq2):
            if path:
                yield from jax_fastq.read_batches(path, 8192, 256)

    want, _, n_mapped, _ = jax_mapper.coverage_of_reads(
        [JaxRecord(f"mt{i + 1}", r[1]) for i, r in enumerate(recs)], batches())
    got = convert.depth_to_numpy(tracks.depth_per_contig)
    assert len(got) == len(recs) and n_mapped > 0
    for g, w, r in zip(got, convert.depth_to_numpy(want), recs):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.int64 and len(g) == len(r[1])
    assert [os.path.basename(p) for p in tracks.outputs] == [
        "plot.tracks.json", "plot.gene.txt", "plot.features.txt", "plot.depth.txt",
        "plot.gc.txt", "plot.karyotype.txt", "plot.plus.txt", "plot.circos.conf"]
    assert not (tmp_path / "plot.png").exists()
    assert tracks.renamed == {r[0]: f"mt{i + 1}" for i, r in enumerate(recs)}


def test_visualize_without_reads_and_empty_input(tmp_path):
    """No FASTQ: no depth track, nine files, same text as the JAX package;
    no sequence at all raises the stage's RuntimeError in both."""
    recs, locs, _, _, _ = _case("renders", tmp_path)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jax_vis.visualize(JaxVisualizeConfig(), [JaxRecord(*r) for r in recs], locs,
                             str(tmp_path / "jax" / "p"))
    got = port_vis.visualize(VisualizeConfig(), [FastaRecord(*r) for r in recs], locs,
                             str(tmp_path / "port" / "p"), device="cpu")
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 9 and not any(p.endswith("depth.txt") for p in got)
    assert _read(tmp_path / "port" / "p.tracks.json") == _read(tmp_path / "jax" / "p.tracks.json")
    with pytest.raises(RuntimeError, match="Nothing to visualize"):
        port_vis.visualize(VisualizeConfig(), [], {}, str(tmp_path / "none"), device="cpu")
    with pytest.raises(RuntimeError, match="Nothing to visualize"):
        jax_vis.visualize(JaxVisualizeConfig(), [], {}, str(tmp_path / "none"))
