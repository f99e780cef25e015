"""The port's multi-host route on the CPU: ``init_distributed`` (gloo, world
size 1, through a file:// rendezvous in the test's directory or a port
found free at run time; never a fixed port), and the ``host_shard`` paths
of the filter and assemble stages against the JAX package's on the same
input (the cases of tests/test_distributed.py). As in the JAX package, each
process of a group filters and assembles its own byte range of the reads.
"""

import filecmp
import gzip
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mitoflex_tpu.config import AssembleConfig as JaxAssembleConfig
from mitoflex_tpu.config import FilterConfig as JaxFilterConfig
from mitoflex_tpu.stages.assemble import assemble as jax_assemble
from mitoflex_tpu.stages.filter import filter_reads as jax_filter_reads
from mitoflex_tpu_torch.config import AssembleConfig, FilterConfig
from mitoflex_tpu_torch.io import fastq
from mitoflex_tpu_torch.parallel import distributed
from mitoflex_tpu_torch.parallel import mesh as port_mesh
from mitoflex_tpu_torch.stages import assemble as port_asm
from mitoflex_tpu_torch.stages.filter import filter_reads
from tests import synth

GROUP_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the sharded calls are many small eager ops,
    which more threads only slow down beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_group_env(monkeypatch):
    for var in GROUP_VARS:
        monkeypatch.delenv(var, raising=False)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _check_world1(got):
    try:
        assert got == (0, 1) and dist.is_initialized()
        assert dist.get_backend() == "gloo" and distributed.shard_info() == (0, 1)
        x = torch.arange(4.0)
        dist.all_reduce(x)
        assert torch.equal(x, torch.arange(4.0))
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized() and distributed.shard_info() == (0, 1)


def test_init_distributed_default_starts_no_group(no_group_env):
    assert distributed.init_distributed() == (0, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="rank"):
        distributed.init_distributed(world_size=1, init_method="file:///nowhere")


def test_init_distributed_from_arguments(no_group_env, tmp_path):
    _check_world1(distributed.init_distributed(
        rank=0, world_size=1, init_method=f"file://{tmp_path / 'rendezvous'}"))


def test_init_distributed_from_environment(no_group_env, monkeypatch, tmp_path):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    _check_world1(distributed.init_distributed(
        init_method=f"file://{tmp_path / 'rendezvous'}"))
    # MASTER_ADDR / MASTER_PORT alone name the group (env://), on a port of
    # this host found free now
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(port))
    _check_world1(distributed.init_distributed(backend="gloo"))


def _pe_files(tmp_path, rng):
    g = synth.random_genome(rng, 3000)
    pairs = synth.shotgun_reads(rng, g, 300, read_len=100, insert=280)
    bad = [(("N" * 100, "#" * 100), ("N" * 100, "#" * 100))] * 10
    p1, p2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    with open(p1, "w") as a, open(p2, "w") as b:
        for i, (x, y) in enumerate(pairs + bad):
            a.write(f"@p{i}/1\n{x[0]}\n+\n{x[1]}\n")
            b.write(f"@p{i}/2\n{y[0]}\n+\n{y[1]}\n")
    return str(p1), str(p2)


def test_filter_host_sharded_matches_single_and_jax(tmp_path, rng):
    """The PE filter as 3 processes (byte-range ingestion): the shards in
    rank order are the single run's clean FASTQs, and every shard equals the
    JAX package's shard; the 4-shard mesh run equals the single run too."""
    p1, p2 = _pe_files(tmp_path, rng)
    kw = dict(batch_reads=64, max_read_len=128, deduplication=False)
    ref = filter_reads(FilterConfig(**kw), p1, str(tmp_path / "s.1.fq"), p2,
                       str(tmp_path / "s.2.fq"), host_shard=(0, 1), device="cpu")
    lines = {1: [], 2: []}
    kept = 0
    for pid in range(3):
        outs = [str(tmp_path / f"c{pid}.{m}.fq") for m in (1, 2)]
        jouts = [str(tmp_path / f"j{pid}.{m}.fq") for m in (1, 2)]
        kept += filter_reads(FilterConfig(**kw), p1, outs[0], p2, outs[1],
                             host_shard=(pid, 3), device="cpu").reads_kept
        jax_filter_reads(JaxFilterConfig(**kw), p1, jouts[0], p2, jouts[1],
                         host_shard=(pid, 3))
        for m in (1, 2):
            assert filecmp.cmp(outs[m - 1], jouts[m - 1], shallow=False)
            lines[m] += open(outs[m - 1]).read().splitlines()
    assert kept == ref.reads_kept == 300
    for m in (1, 2):
        assert lines[m] == open(tmp_path / f"s.{m}.fq").read().splitlines()
    mesh_res = filter_reads(FilterConfig(**kw), p1, str(tmp_path / "m.1.fq"), p2,
                            str(tmp_path / "m.2.fq"), host_shard=(0, 1), device="cpu",
                            mesh=port_mesh.make_mesh((4,), device="cpu"))
    assert mesh_res.reads_kept == 300
    assert filecmp.cmp(tmp_path / "m.1.fq", tmp_path / "s.1.fq", shallow=False)


def test_filter_gz_input_strides_batches(tmp_path, rng):
    """gzip cannot seek: the processes stride batches instead, each shard as
    the JAX package's, every read once over the union."""
    reads = synth.shotgun_reads(rng, synth.random_genome(rng, 2000), 200, read_len=100)
    plain = synth.write_fastq(tmp_path / "in.fq", reads)
    gz = str(tmp_path / "in.fq.gz")
    with open(plain, "rb") as f, gzip.open(gz, "wb") as z:
        z.write(f.read())
    names = []
    for pid in range(2):
        out, jout = str(tmp_path / f"c{pid}.fq"), str(tmp_path / f"j{pid}.fq")
        filter_reads(FilterConfig(batch_reads=32, max_read_len=128), gz, out,
                     host_shard=(pid, 2), device="cpu")
        jax_filter_reads(JaxFilterConfig(batch_reads=32, max_read_len=128), gz, jout,
                         host_shard=(pid, 2))
        assert filecmp.cmp(out, jout, shallow=False)
        names += [ln for ln in open(out).read().splitlines() if ln.startswith("@")]
    assert sorted(names) == sorted(f"@r{i}" for i in range(200))


def test_assemble_host_sharded_matches_jax(tmp_path, rng):
    """Assembly of host 0's byte range out of 2: the JAX package's contigs
    byte for byte, and the genome from half the reads."""
    g = synth.random_genome(rng, 1500)
    p = str(synth.write_fastq(tmp_path / "r.fq", synth.shotgun_reads(rng, g, 900,
                                                                     read_len=100)))
    kw = dict(kmer_list=[21, 41], depth_list=[5, 5], min_multi=3, prune_depth=2)
    out, jout = str(tmp_path / "contigs.fa"), str(tmp_path / "jax.fa")
    port_asm.assemble(AssembleConfig(**kw), p, None, out, read_chunk=512,
                      max_read_len=128, host_shard=(0, 2), device="cpu")
    jax_assemble(JaxAssembleConfig(**kw), p, None, jout, read_chunk=512,
                 max_read_len=128, host_shard=(0, 2))
    assert filecmp.cmp(out, jout, shallow=False)
    best = max(open(out).read().split(">")[1:], key=len)
    assert len("".join(best.splitlines()[1:])) >= 1400


def test_host_tables_merged_match_single(tmp_path, rng):
    """3 processes each count only their record-aligned byte range; their
    canonical tables merged on one host are the single table exactly."""
    g = synth.random_genome(rng, 2000)
    p = str(synth.write_fastq(tmp_path / "r.fq", synth.shotgun_reads(
        rng, g, 800, read_len=100, error_rate=0.003)))
    kp1 = 22

    def counter(byte_range):
        c = port_asm.KmerCounter(kp1, canonical=True, device="cpu")
        for b in fastq.read_batches(p, 256, 128, byte_range=byte_range):
            c.add_chunk(b.seqs, b.lengths)
        return c

    merged = port_asm.KmerCounter(kp1, canonical=True, device="cpu")
    for pid in range(3):
        table = counter(distributed.host_file_range(p, pid, 3))._merged()
        if table is not None:
            merged._push(table)
    keys, counts = counter(None)._merged()
    mk, mc = merged._merged()
    np.testing.assert_array_equal(mk, keys)
    np.testing.assert_array_equal(mc, counts)
