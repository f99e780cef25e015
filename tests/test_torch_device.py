"""The port's one device rule (mitoflex_tpu_torch.device.resolve_device).

``None`` means the card at every public function of the port: on a host
without CUDA it raises a RuntimeError that names the missing card, and the
CPU runs only when the caller names it.
"""

import os
import re

import numpy as np
import pytest
import torch

from mitoflex_tpu_torch import device as port_device
from mitoflex_tpu_torch.config import FilterConfig
from mitoflex_tpu_torch.models import hmm as port_hmm
from mitoflex_tpu_torch.ops import kmer as port_kmer
from mitoflex_tpu_torch.ops import phmm as port_phmm
from mitoflex_tpu_torch.stages import filter as port_stage
from mitoflex_tpu_torch.testing import synth

PKG = os.path.dirname(os.path.abspath(port_device.__file__))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the rule's refusal shows "
                    "only without one")


def test_resolve_device_none_raises_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.uses_host_mirrors(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_device.resolve_device("cuda")


def test_resolve_device_takes_the_cpu_only_by_name():
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    assert port_device.resolve_device(torch.device("cpu")).type == "cpu"
    assert port_device.uses_host_mirrors("cpu")
    with pytest.raises(ValueError):
        port_device.resolve_device("meta")


def test_stage_entry_point_without_a_device_raises_and_cpu_runs(tmp_path):
    _no_card()
    rng = np.random.default_rng(3)
    reads = synth.shotgun_reads(rng, synth.random_genome(rng, 600), 40, read_len=80)
    fq = synth.write_fastq(tmp_path / "in.fq", reads)
    cfg = FilterConfig(batch_reads=64, max_read_len=96)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_stage.filter_reads(cfg, fq, str(tmp_path / "none.fq"))
    res = port_stage.filter_reads(cfg, fq, str(tmp_path / "cpu.fq"), device="cpu")
    assert res.reads_kept == 40


def test_op_entry_points_without_a_device_raise():
    _no_card()
    seqs = np.zeros((4, 40), np.int8)
    lens = np.full(4, 40, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_kmer.count_chunk_host(seqs, lens, 21)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_phmm.stage_profile(port_hmm.profile_from_consensus("x", "ACGT" * 8))
    assert port_kmer.count_chunk_host(seqs, lens, 21, device="cpu")[0].shape[0] >= 1


def test_no_silent_cpu_default_left_in_the_package():
    """No ``device or "cpu"`` (or ``device or 'cpu'``) remains in any module
    of the port."""
    pat = re.compile(r"""or\s+["']cpu["']""")
    hits = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    for n, line in enumerate(fh, 1):
                        if pat.search(line):
                            hits.append(f"{f}:{n}")
    assert hits == []


def test_converter_without_a_device_raises():
    """``convert.wise_hits_from_reference`` follows the rule too: no CPU
    default."""
    _no_card()
    from mitoflex_tpu_torch import convert
    from mitoflex_tpu_torch.ops.genewise import WiseHits

    hits = WiseHits(*(np.zeros(2, np.int32) for _ in WiseHits._fields))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.wise_hits_from_reference(hits)
    back = convert.wise_hits_from_reference(hits, device="cpu")
    assert all(getattr(back, f).device.type == "cpu" for f in WiseHits._fields)


@pytest.mark.parametrize("entry", ["visualize", "build_tracks", "run_visualize", "run_all",
                                   "run_bim", "create"])
def test_visualize_and_pipeline_entry_points_without_a_device_raise(tmp_path, entry):
    """``visualize`` / ``build_tracks`` with ``device=None``, and ``run_visualize``,
    ``run_all`` and ``run_bim`` on a context that names no device, raise the
    RuntimeError that names the missing card; so does making the context."""
    _no_card()
    from mitoflex_tpu_torch import pipeline
    from mitoflex_tpu_torch.config import PipelineConfig, VisualizeConfig
    from mitoflex_tpu_torch.io.fasta import FastaRecord, write_fasta
    from mitoflex_tpu_torch.stages import visualize as vis
    from mitoflex_tpu_torch.utils.workdir import WorkDir

    rng = np.random.default_rng(4)
    rec = FastaRecord("s", synth.random_genome(rng, 400))
    fa = write_fasta([rec], str(tmp_path / "s.fa"))
    fq = synth.write_fastq(tmp_path / "in.fq", [(rec.seq[:80], "I" * 80)])
    cfg = PipelineConfig()
    cfg.run.basedir, cfg.run.workname = str(tmp_path), "w"
    cfg.search.disable_taxa = True
    ctx = pipeline.PipelineContext(cfg, WorkDir(str(tmp_path), "w").create(), None)
    calls = {
        "visualize": lambda: vis.visualize(VisualizeConfig(), [rec], {}, str(tmp_path / "p")),
        "build_tracks": lambda: vis.build_tracks(VisualizeConfig(), [rec], {},
                                                 str(tmp_path / "p")),
        "run_visualize": lambda: pipeline.run_visualize(ctx, fa, {}),
        "run_all": lambda: pipeline.run_all(ctx, fq),
        "run_bim": lambda: pipeline.run_bim(ctx, fq),
        "create": lambda: pipeline.PipelineContext.create(cfg),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert not (tmp_path / "p.tracks.json").exists()
