"""The port's stages over an in-process mesh of CPU shards
(mitoflex_tpu_torch/parallel/mesh.py) give the single-device outputs byte
for byte: the k-mer counter's tables (device and host spill included), the
assembler's ``contigs.fa`` (also equal to the JAX package's over its 8
virtual devices), the nhmmer and tblastn hit frames, and ``run_bim``'s
picked FASTA. The cases follow tests/test_mesh_stages.py.
"""

import filecmp

import numpy as np
import pandas as pd
import pytest
import torch

from mitoflex_tpu.config import AssembleConfig as JaxAssembleConfig
from mitoflex_tpu.parallel import mesh as jax_mesh
from mitoflex_tpu.stages import assemble as jax_asm
from mitoflex_tpu_torch.config import AssembleConfig, PipelineConfig
from mitoflex_tpu_torch.io.fasta import FastaRecord
from mitoflex_tpu_torch.models import blast, nhmmer
from mitoflex_tpu_torch.models.profiles import ProfileSet
from mitoflex_tpu_torch.parallel import mesh as port_mesh
from mitoflex_tpu_torch.pipeline import PipelineContext, run_bim
from mitoflex_tpu_torch.stages import assemble as port_asm
from mitoflex_tpu_torch.testing import profile_fixture
from tests import synth


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the sharded calls are many small eager ops,
    which more threads only slow down beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh8():
    return port_mesh.make_mesh((8,), device="cpu")


def test_sharded_counter_parity(mesh8, rng):
    """ShardedKmerCounter == KmerCounter (and the JAX package's), with and
    without device runs spilling to the host LSM."""
    k = 22
    pairs = []
    for kw in ({}, {"max_device_rows": 8192}):
        pairs.append((port_asm.KmerCounter(k, canonical=True, device="cpu", **kw),
                      port_asm.ShardedKmerCounter(mesh8, k, **kw)))
    jax_ref = jax_asm.KmerCounter(k, canonical=True)
    for i in range(5):
        seqs = rng.integers(0, 4, (100 + i, 96)).astype(np.int8)
        lens = np.full(len(seqs), 96, np.int32)
        for c in (jax_ref, *(c for pair in pairs for c in pair)):
            c.add_chunk(seqs, lens)
    jk, jc = jax_ref._merged()
    for ref, sharded in pairs:
        for keys, counts in (ref._merged(), sharded._merged()):
            np.testing.assert_array_equal(keys, jk)
            np.testing.assert_array_equal(counts, jc)
            assert counts.dtype == jc.dtype
    assert pairs[1][1]._levels and not pairs[0][1]._levels  # the capped one spilled


@pytest.fixture(scope="module")
def shotgun(tmp_path_factory):
    rng = np.random.default_rng(7)
    tmp = tmp_path_factory.mktemp("mesh_assemble")
    genome = synth.random_genome(rng, 2500)
    pairs = synth.shotgun_reads(rng, genome, 1200, read_len=90, insert=250,
                                error_rate=0.003)
    p1 = synth.write_fastq(tmp / "r1.fq", [p[0] for p in pairs])
    p2 = synth.write_fastq(tmp / "r2.fq", [p[1] for p in pairs])
    return tmp, str(p1), str(p2)


def test_assemble_mesh_parity(shotgun, mesh8):
    tmp, p1, p2 = shotgun
    cfg = dict(kmer_list=[21, 41], depth_list=[2, 2], min_multi=2, prune_depth=2,
               prune_level=2, min_length=200, disable_scaffolding=True)
    out = {name: str(tmp / f"contigs.{name}.fa") for name in ("one", "mesh", "jax8")}
    port_asm.assemble(AssembleConfig(**cfg), p1, p2, out["one"], read_chunk=512,
                      max_read_len=96, device="cpu")
    port_asm.assemble(AssembleConfig(**cfg), p1, p2, out["mesh"], read_chunk=512,
                      max_read_len=96, device="cpu", mesh=mesh8)
    jax_asm.assemble(JaxAssembleConfig(**cfg), p1, p2, out["jax8"], read_chunk=512,
                     max_read_len=96, mesh=jax_mesh.make_mesh((8,), ("data",)))
    assert filecmp.cmp(out["mesh"], out["one"], shallow=False)
    assert filecmp.cmp(out["mesh"], out["jax8"], shallow=False)
    assert open(out["mesh"]).read().count(">") >= 1


@pytest.fixture(scope="module")
def fixture_genome(tmp_path_factory):
    fake = profile_fixture.build(tmp_path_factory.mktemp("mesh_profiles"),
                                 np.random.default_rng(42))
    return fake, ProfileSet(fake.profile_dir), [FastaRecord("g", fake.genome)]


def test_nhmmer_mesh_parity(fixture_genome):
    fake, profiles, contigs = fixture_genome
    hmms = profiles.cds_hmms(fake.clade)[:2]
    one = nhmmer.nhmmer_search(contigs, hmms, score_threshold=5.0, device="cpu")
    mesh = nhmmer.nhmmer_search(contigs, hmms, score_threshold=5.0, device="cpu",
                                mesh=port_mesh.make_mesh((2,), device="cpu"))
    assert not one.empty
    pd.testing.assert_frame_equal(one, mesh)


def test_tblastn_mesh_parity(fixture_genome):
    fake, profiles, contigs = fixture_genome
    db = profiles.protein_db(fake.clade)
    one = blast.tblastn(db, contigs, fake.table_id, device="cpu")
    mesh = blast.tblastn(db, contigs, fake.table_id, device="cpu",
                         mesh=port_mesh.make_mesh((3,), device="cpu"))
    assert not one.empty
    pd.testing.assert_frame_equal(one, mesh)


def test_bim_mesh_parity(tmp_path, rng):
    """run_bim with ``cfg.run.mesh_shape = [2]`` (filter, assembly, bait
    mapping and findmitoscaf over the mesh) picks the single-device FASTA."""
    fake = profile_fixture.build(tmp_path, rng)
    comp = str.maketrans("ACGT", "TGCA")
    nuclear = synth.random_genome(rng, 1500)

    def pe(g, n, circ):
        g2 = g + g[:400] if circ else g
        out = []
        for _ in range(n):
            s = rng.integers(0, len(g2) - 300)
            frag = g2[s: s + 300]
            out.append((frag[:100], frag[-100:].translate(comp)[::-1]))
        return out

    pairs = pe(fake.genome, 900, True) + pe(nuclear, 120, False)
    f1 = synth.write_fastq(tmp_path / "b1.fq", [(p[0], "I" * len(p[0])) for p in pairs])
    f2 = synth.write_fastq(tmp_path / "b2.fq", [(p[1], "I" * len(p[1])) for p in pairs])

    def run(name, mesh_shape):
        cfg = PipelineConfig.from_dict({
            "run": {"workname": name, "basedir": str(tmp_path),
                    "profile_dir": fake.profile_dir, "mesh_shape": mesh_shape},
            "filter": {"batch_reads": 1024, "max_read_len": 128},
            "assemble": {"kmer_list": [21, 41], "depth_list": [5, 5],
                         "min_multi": 3, "prune_depth": 2, "prune_level": 2,
                         "disable_scaffolding": True},
            "search": {"min_abundance": 10, "merge_method": 2, "disable_taxa": True},
            "annotate": {"clade": fake.clade, "genetic_code": 5},
            "bim": {"max_iteration": 1, "iteration_ignore": -1},
        })
        ctx = PipelineContext.create(cfg, device="cpu")
        assert (ctx.mesh is None) == (mesh_shape is None)
        return run_bim(ctx, f1, str(f2))

    picked_one, picked_mesh = run("bims", None), run("bimm", [2])
    assert picked_one.endswith("bims.picked.fa")
    assert filecmp.cmp(picked_one, picked_mesh, shallow=False)
