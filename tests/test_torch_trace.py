"""The port's tracer (``mitoflex_tpu_torch/utils/trace.py``) on the CPU: off
it records nothing; on, spans nest by thread, a prefetch's producer spans
hang under the span that opened it, counters land on the innermost span of
their own thread; under ``torch.profiler`` the main thread's spans are
``mfx.port.*`` ranges and the anchor places a helper thread's span on the
trace's clock; ``run_all`` writes the same bytes traced and untraced; and
``MITOFLEX_TORCH_PROFILE`` writes the helper threads' spans into its trace;
the partial merge's rounds hold blastn's spans, whose counters account for
every row of the frames it returned, every pair it scored and every pair it
aligned.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mitoflex_tpu_torch import cli as port_cli
from mitoflex_tpu_torch import convert
from mitoflex_tpu_torch import pipeline as port_pipeline
from mitoflex_tpu_torch.config import PipelineConfig
from mitoflex_tpu_torch.stages import merge as merge_stage
from mitoflex_tpu_torch.io.fasta import FastaRecord
from mitoflex_tpu_torch.io.prefetch import prefetch
from mitoflex_tpu_torch.testing import profile_fixture, synth
from mitoflex_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _spin(ms):
    t = time.perf_counter()
    while time.perf_counter() - t < ms / 1e3:
        pass


class _CardTensor:
    """Stands in for a tensor on a card: ``.cpu()`` returns a host copy."""

    class device:
        type = "cuda"

    def __init__(self, t):
        self.t = t

    def detach(self):
        return self

    def cpu(self):
        return self.t.clone()


def test_off_returns_the_null_span_and_records_nothing():
    assert not trace.recording()
    assert trace.span("filter.device") is trace.NULL
    assert trace.span("assemble.k", k=31) is trace.NULL
    assert trace.waited("io.wait_ns") is trace.NULL
    with trace.span("filter.device"):
        trace.count("count.bases", np.arange(5))
        got = trace.read_back(_CardTensor(torch.arange(4, dtype=torch.int32)))
    assert got.tolist() == [0, 1, 2, 3]
    assert trace.current() is None
    data = trace.export()
    assert data["spans"] == [] and data["anchors"] == []


def test_host_reads_go_through_read_back(monkeypatch):
    seen = []

    def read_back(t):
        seen.append(tuple(t.shape))
        return t.cpu()

    monkeypatch.setattr(trace, "read_back", read_back)
    assert convert.host(torch.arange(3)).tolist() == [0, 1, 2]
    assert convert.u32_numpy(torch.tensor([-1], dtype=torch.int32)).tolist() == [0xFFFFFFFF]
    assert convert.host(np.arange(2)).tolist() == [0, 1]
    assert seen == [(3,), (1,)]


def test_off_a_span_into_walls_still_times_itself():
    walls = {"tblastn": 0.5}
    with trace.span("annotate.tblastn", into=(walls, "tblastn")):
        _spin(2)
    assert walls["tblastn"] >= 0.5 + 0.002
    assert trace.export()["spans"] == []


def test_on_parents_roots_threads_and_counters():
    trace.enable()
    walls = {}
    with trace.span("run_all") as root:
        with trace.span("assemble.k", k=31):
            with trace.span("assemble.count") as inner:
                trace.count("count.bases", np.array([100, 50]))
                trace.count("kmers.solid", 7)
                got = trace.read_back(_CardTensor(torch.zeros(6, dtype=torch.int64)))
                convert.host(torch.ones(3))  # a host tensor: no read, no charge
                parent = trace.current()

                def helper():
                    trace.adopt(parent)
                    with trace.span("count.merge"):
                        trace.count("merge.rows", 3)
                    trace.count("lost", 1)  # no span open on this thread

                t = threading.Thread(target=helper)
                t.start()
                t.join()
            trace.count("graph.rounds")
        with trace.span("annotate.trna", into=(walls, "trna")):
            pass
    assert got.tolist() == [0] * 6
    spans = {s["name"]: s for s in trace.export()["spans"]}
    assert list(spans) == ["run_all", "assemble.k", "assemble.count", "count.merge",
                           "annotate.trna"]
    rid = root.rec["id"]
    assert {s["root"] for s in spans.values()} == {rid}
    assert spans["run_all"]["parent"] is None
    assert spans["assemble.k"]["parent"] == rid
    assert spans["assemble.count"]["parent"] == spans["assemble.k"]["id"]
    assert spans["count.merge"]["parent"] == inner.rec["id"]
    assert spans["assemble.count"]["attrs"] == {"k": 31}
    assert spans["count.merge"]["attrs"] == {"k": 31}
    main = threading.main_thread().ident
    assert spans["count.merge"]["thread"] != main
    assert all(s["thread"] == main for n, s in spans.items() if n != "count.merge")
    c = spans["assemble.count"]["counters"]
    assert c["count.bases"] == 150 and c["kmers.solid"] == 7
    assert c["d2h.calls"] == 1 and c["d2h.bytes"] == 48 and c["d2h.wait_ns"] > 0
    assert spans["count.merge"]["counters"] == {"merge.rows": 3}
    assert spans["assemble.k"]["counters"] == {"graph.rounds": 1}
    assert spans["run_all"]["counters"] == {}
    s = spans["annotate.trna"]
    assert walls["trna"] == pytest.approx((s["t1_ns"] - s["t0_ns"]) / 1e9)
    for s in spans.values():
        assert s["t0_ns"] <= s["t1_ns"]


def test_spans_of_many_threads_keep_their_own_parents_and_counters():
    """Sixteen threads (more than this host's cores) open spans at once,
    with the interpreter switching threads as often as it can."""
    trace.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.span("run_all") as root:
            parent = trace.current()

            def work(i):
                trace.adopt(parent)
                for _ in range(100):
                    with trace.span("count.merge", item=i):
                        with trace.span("io.parse"):
                            trace.count("io.batches")
                        trace.count("d2h.calls", 2)

            threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = trace.export()["spans"]
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans) == 1 + 16 * 100 * 2
    outer = [s for s in spans if s["name"] == "count.merge"]
    inner = [s for s in spans if s["name"] == "io.parse"]
    assert all(s["parent"] == root.rec["id"] for s in outer)
    assert all(s["counters"] == {"d2h.calls": 2} for s in outer)
    assert all(s["counters"] == {"io.batches": 1} for s in inner)
    for s in inner:
        p = by_id[s["parent"]]
        assert p["name"] == "count.merge" and p["thread"] == s["thread"]
        assert p["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= p["t1_ns"]
    assert sorted(sum(1 for s in outer if s["attrs"]["item"] == i) for i in range(16)) == [100] * 16


def test_prefetch_producer_spans_hang_under_the_opener():
    trace.enable()

    def slow():
        for i in range(3):
            _spin(3)
            yield i

    with trace.span("filter") as opener:
        with prefetch(slow(), 1, wait="filter.read_wait") as it:
            got = list(it)
    assert got == [0, 1, 2]
    spans = trace.export()["spans"]
    producer = [s for s in spans if s["name"] == "prefetch"]
    assert len(producer) == 1
    assert producer[0]["parent"] == opener.rec["id"]
    assert producer[0]["thread"] != threading.main_thread().ident
    parses = [s for s in spans if s["name"] == "io.parse"]
    assert len(parses) == 4  # three batches and the pull that ends the source
    assert all(s["parent"] == producer[0]["id"] for s in parses)
    assert sum(s["t1_ns"] - s["t0_ns"] for s in parses) >= 9e6
    waits = [s for s in spans if s["name"] == "filter.read_wait"]
    assert len(waits) == 4 and all(s["parent"] == opener.rec["id"] for s in waits)
    assert sum(s["counters"]["io.wait_ns"] for s in waits) > 0
    assert sum(s["counters"].get("io.batches", 0) for s in spans) == 3
    assert opener.rec["counters"]["io.batches"] == 3
    assert all(s["root"] == opener.rec["id"] for s in spans)


def test_profiler_sees_main_thread_spans_and_the_anchor_places_helpers(tmp_path):
    """No ``enable()``: a recording profiler turns the tracer on."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.recording()
        with trace.span("assemble.k", k=41):
            with trace.span("assemble.count"):
                _spin(3)
                parent = trace.current()

                def helper():
                    trace.adopt(parent)
                    with trace.span("count.merge"):
                        _spin(20)

                t = threading.Thread(target=helper)
                t.start()
                t.join()
                _spin(3)
    assert not trace.recording()
    data = trace.export()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"]: e for e in events
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("mfx.")}
    assert {"mfx.port.assemble.k[k=41]", "mfx.port.assemble.count[k=41]",
            trace.ANCHOR} <= set(ranges)
    assert "mfx.port.count.merge[k=41]" not in ranges  # a helper thread's range
    assert all(e.get("cat") == "user_annotation" for e in ranges.values())
    assert len(data["anchors"]) == 1
    offset = trace.trace_offset_ns(events, data["anchors"])
    outer = ranges["mfx.port.assemble.count[k=41]"]
    merge = next(s for s in data["spans"] if s["name"] == "count.merge")
    a, b = (merge["t0_ns"] + offset) / 1e3, (merge["t1_ns"] + offset) / 1e3
    lo, hi = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    assert lo - 500 <= a and b <= hi + 500 and b - a >= 20e3
    count = next(s for s in data["spans"] if s["name"] == "assemble.count")
    assert abs((count["t0_ns"] + offset) / 1e3 - lo) < 500
    assert abs((count["t1_ns"] + offset) / 1e3 - hi) < 500


def _reads(tmp, genome, rng, n=1200):
    comp = str.maketrans("ACGT", "TGCA")
    g2 = genome + genome[:400]
    pairs = []
    for _ in range(n):
        s = rng.integers(0, len(g2) - 300)
        frag = g2[s: s + 300]
        pairs.append((frag[:100], frag[-100:].translate(comp)[::-1]))
    f1 = synth.write_fastq(tmp / "r1.fq", [(a, "I" * 100) for a, _ in pairs])
    f2 = synth.write_fastq(tmp / "r2.fq", [(b, "I" * 100) for _, b in pairs])
    return str(f1), str(f2)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The pipeline tests' small fixture: the four-PCG genome as a circle,
    1200 pairs of 100 bp."""
    tmp = tmp_path_factory.mktemp("trace")
    rng = np.random.default_rng(55)
    fake = profile_fixture.build(tmp, rng)
    return tmp, fake, _reads(tmp, fake.genome, rng)


def _run_all(tmp, fake, reads, name):
    cfg = PipelineConfig.from_dict({
        "run": {"workname": name, "basedir": str(tmp), "profile_dir": fake.profile_dir,
                "keep_temp": True},
        "filter": {"batch_reads": 1024, "max_read_len": 128},
        "assemble": {"kmer_list": [21, 41], "depth_list": [5, 5]},
        "search": {"min_abundance": 10, "disable_taxa": True},
        "annotate": {"clade": fake.clade, "genetic_code": 5},
        "visualize": {"disable_visualization": True},
    })
    ctx = port_pipeline.PipelineContext.create(cfg, device="cpu")
    summary = port_pipeline.run_all(ctx, *reads)
    return ctx.workdir.root, summary


def _files(root, name):
    """Every file under ``root`` by relative path, with ``name`` masked."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), root).replace(name, "<W>")
            with open(os.path.join(d, n), "rb") as f:
                out[rel] = f.read().replace(name.encode(), b"<W>")
            if n == "manifest.json":  # the stage's record, less when it was written
                m = json.loads(out[rel])
                m.pop("_written_at")
                out[rel] = m
    return out


def test_run_all_traced_writes_the_untraced_bytes(small):
    tmp, fake, reads = small
    root_off, summary_off = _run_all(tmp, fake, reads, "plainrun")
    assert trace.export()["spans"] == []
    trace.enable()
    root_on, summary_on = _run_all(tmp, fake, reads, "tracedrun")
    trace.disable()
    data = trace.export()
    off, on = _files(root_off, "plainrun"), _files(root_on, "tracedrun")
    assert sorted(off) == sorted(on) and len(off) > 10
    assert {p for p in off if off[p] != on[p] and not p.endswith(".log")} == set()
    assert list(summary_on) == list(summary_off)

    spans = data["spans"]
    by_id = {s["id"]: s for s in spans}
    assert all(s["t1_ns"] is not None for s in spans)
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["run_all"]
    assert {s["root"] for s in spans} == {roots[0]["id"]}
    ks = [s for s in spans if s["name"] == "assemble.k"]
    assert [s["attrs"]["k"] for s in ks] == [21, 41]
    for k in ks:
        children = [s for s in spans if s["parent"] == k["id"]]
        names = {s["name"] for s in children}
        assert {"assemble.count", "assemble.graph", "assemble.local"} <= names, names
        assert all(s["attrs"]["k"] == k["attrs"]["k"] for s in children)
        assert sum(s["t1_ns"] - s["t0_ns"] for s in children) <= k["t1_ns"] - k["t0_ns"]
        assert by_id[k["parent"]]["name"] == "assemble"
        assert k["counters"]["kmers.solid"] > 0
    for stage in ("filter", "assemble", "findmitoscaf", "annotate"):
        assert any(s["name"] == stage and by_id[s["parent"]]["name"] == "run_all"
                   for s in spans), stage
    counts = [s for s in spans if s["name"] == "count.add"]
    assert len(counts) == 2 and all(s["counters"]["count.bases"] == 240000 for s in counts)
    assert all(s["counters"]["io.batches"] > 0 for s in counts)
    parses = [s for s in spans if s["name"] == "io.parse"]
    assert parses and all(s["thread"] != data["main_thread"] for s in parses)
    for name in ("filter.read_wait", "filter.device", "filter.write", "count.gate",
                 "count.merge", "graph.pass", "graph.clean", "graph.unitigs",
                 "findmitoscaf.nhmmer", "nhmmer.v1", "nhmmer.v2", "nhmmer.window",
                 "nhmmer.frame", "findmitoscaf.blast", "findmitoscaf.merge", "merge.round",
                 "blastn.seed", "blastn.sw", "blastn.score", "blastn.frame", "annotate.tblastn", "annotate.genewise", "annotate.trna", "annotate.rrna"):
        assert any(s["name"] == name for s in spans), name


def test_cli_profile_writes_helper_thread_spans(small, tmp_path, monkeypatch, capsys):
    _, _, (f1, f2) = small
    out = tmp_path / "profile"
    monkeypatch.setenv("MITOFLEX_TORCH_PROFILE", str(out))
    rc = port_cli.main(["filter", "--fastq1", f1, "--fastq2", f2, "--workname", "cli",
                        "--basedir", str(tmp_path), "--device", "cpu"])
    assert rc == 0, capsys.readouterr()
    assert not trace.recording() and trace.export()["spans"] == []
    with open(out / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    port = [e for e in events if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("mfx.port.")]
    assert len({e["tid"] for e in port}) > 1
    names = {e["name"] for e in port}
    assert {"mfx.port.filter", "mfx.port.filter.device", "mfx.port.io.parse",
            "mfx.port.prefetch", trace.ANCHOR} <= names
    stage = next(e for e in port if e["name"] == "mfx.port.filter")
    lo, hi = float(stage["ts"]), float(stage["ts"]) + float(stage["dur"])
    for e in port:
        if e["name"] == "mfx.port.io.parse":
            assert e["tid"] != stage["tid"]
            assert lo - 500 <= float(e["ts"]) <= hi + 500
    waits = [e for e in port if e["name"] == "mfx.port.filter.read_wait"]
    assert waits and all("io.wait_ns" in e.get("args", {}) for e in waits)


def _merge_draft(overlap):
    (cid, circle), contigs = synth.merge_draft(np.random.default_rng(1), overlap)
    rec = lambda n, s, m: FastaRecord(n, s, {"flag": 0, "multi": m, "len": len(s)})
    return [rec(cid, circle, 400.0)], [rec(n, s, 20.0) for n, s in contigs]


@pytest.mark.parametrize("overlap, joins", [
    (lambda c: synth.chance_copy(c[:54]), 0),  # a chance row, 75% over 53 columns
    (lambda c: c[:85], 1),                     # a true overlap of 85 bases
], ids=["chance_row", "true_overlap"])
def test_merge_rounds_hold_blastn_spans_and_counters(monkeypatch, overlap, joins):
    picked, db = _merge_draft(overlap)
    frames = []
    real = merge_stage.blast.blastn

    def blastn(*args, **kwargs):
        frames.append(real(*args, **kwargs))
        return frames[-1]

    monkeypatch.setattr(merge_stage.blast, "blastn", blastn)
    got = merge_stage.merge_partial(picked, db, 50, 50, 20000, device="cpu")
    assert got[2] == joins and trace.export()["spans"] == []  # off: no record
    frames.clear()
    trace.enable()
    with trace.span("findmitoscaf.merge"):
        assert merge_stage.merge_partial(picked, db, 50, 50, 20000, device="cpu")[2] == joins
    trace.disable()
    spans = trace.export()["spans"]
    by_id = {s["id"]: s for s in spans}
    rounds = [s for s in spans if s["name"] == "merge.round"]
    # one round a blastn call: a single picked record skips merge_sequences' loop
    assert [s["attrs"]["round"] for s in rounds] == list(range(len(frames)))
    assert {by_id[s["parent"]]["name"] for s in rounds} == {"findmitoscaf.merge"}
    for name, parent in (("blastn.seed", "merge.round"), ("blastn.sw", "merge.round"),
                         ("blastn.score", "blastn.sw"), ("blastn.frame", "merge.round")):
        parts = [s for s in spans if s["name"] == name]
        assert len(parts) == len(frames), name
        assert all(by_id[s["parent"]]["name"] == parent for s in parts), name

    def total(counter):
        return sum(s["counters"].get(counter, 0) for s in spans)

    assert total("blastn.rows") - total("blastn.rows_cut") == sum(len(f) for f in frames)
    assert total("blastn.subjects") == sum(len(db) - i for i in range(len(frames)))
    assert total("blastn.pairs") >= 1 and total("blastn.cells") >= 1500 * 85
    # every pair scored, and only the rows that pass the cut aligned
    assert total("blastn.score_pairs") == total("blastn.pairs") == total("blastn.rows")
    assert total("blastn.path_pairs") == sum(len(f) for f in frames) == joins
    nuc_rows = [f[(f.sseq == "nuc") & (f.length >= 50)] for f in frames]
    if joins:
        assert len(nuc_rows[0]) == 1
        assert total("merge.rows_kept") >= 1 and total("merge.joins") == 1
    else:
        assert total("blastn.rows_cut") >= 1 and sum(len(f) for f in nuc_rows) == 0
        assert total("merge.rows_kept") == 0 and total("merge.joins") == 0
