"""Parity of the port's read filter (mitoflex_tpu_torch) with the JAX package.

Inputs are made with numpy from a seed and fed to both packages. All
comparisons are exact: keep flags, both uint32 hashes, and the clean FASTQ
bytes of the filter stage.
"""

import numpy as np
import pytest
import torch

from mitoflex_tpu.config import FilterConfig
from mitoflex_tpu.io import encoding
from mitoflex_tpu.ops import filter as jax_filter
from mitoflex_tpu.stages import filter as jax_stage
from mitoflex_tpu_torch.convert import u32_numpy
from mitoflex_tpu_torch.ops import filter as port_filter
from mitoflex_tpu_torch.stages import filter as port_stage
from mitoflex_tpu_torch.testing import kernel_cases
from tests import synth

# the port's stage takes the card unless the CPU is named
_CPU = {"jax": {}, "port": {"device": "cpu"}}

# the edge rows of tests/test_filter.py::test_filter_rules
EDGE_ROWS = [
    ("ACGT" * 10, "I" * 40),
    ("N" * 11 + "A" * 29, "I" * 40),
    ("N" * 10 + "A" * 30, "I" * 40),
    ("ACGT" * 10, "#" * 40),
    ("ACGT" * 10, "#" * 7 + "I" * 33),
    ("ACGT" * 10, "#" * 8 + "I" * 32),
]


def _batch(seed: int, n: int = 256, L: int = 128):
    """Random reads with the edge rows on top; the last rows stay empty."""
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 5, size=(n, L)).astype(np.int8)
    quals = rng.integers(35, 74, size=(n, L)).astype(np.int8)
    lengths = rng.integers(1, L + 1, size=n).astype(np.int32)
    for i, (s, q) in enumerate(EDGE_ROWS):
        seqs[i] = encoding.N
        seqs[i, : len(s)] = encoding.encode(s)
        quals[i] = 0
        quals[i, : len(q)] = np.frombuffer(q.encode(), np.uint8)
        lengths[i] = len(s)
    lengths[-3:] = 0
    # mate lengths for the PE cutoff: another read's length
    mate = rng.permutation(lengths).astype(np.int32)
    return seqs, quals, lengths, mate


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe_cutoff"])
@pytest.mark.parametrize("seed", [0, 1])
def test_filter_kernel_plain_matches_jax_and_pallas(seed, pe):
    """Exact: port filter_reads_ref and filter_reads (CPU tensors) vs the
    JAX reference and the Pallas kernel in interpret mode."""
    seqs, quals, lengths, mate = _batch(seed)
    cl = mate if pe else None
    args = (10, 55, 0.2)
    want = jax_filter.filter_reads_ref(seqs, quals, lengths, *args, cl)
    pal = jax_filter.filter_reads_pallas(
        seqs, quals, lengths, *args, cl, block_reads=128, interpret=True
    )
    t = [torch.from_numpy(x) for x in (seqs, quals, lengths)]
    tcl = None if cl is None else torch.from_numpy(cl)
    for got in (port_filter.filter_reads_ref(*t, *args, tcl),
                port_filter.filter_reads(*t, *args, tcl)):
        keep, h1, h2 = got[0].numpy(), u32_numpy(got[1]), u32_numpy(got[2])
        for ref in (want, pal):
            np.testing.assert_array_equal(keep, np.asarray(ref[0]))
            np.testing.assert_array_equal(h1, np.asarray(ref[1]))
            np.testing.assert_array_equal(h2, np.asarray(ref[2]))
    if not pe:
        assert keep[: len(EDGE_ROWS)].tolist() == [True, False, True, False, True, False]


def test_quality_cutoffs_and_hash_powers_match_jax():
    """Exact: the float32 cutoff and the hash power tables."""
    lens = np.arange(0, 400, dtype=np.int32)
    for pct in (0.2, 0.1, 0.35, 1 / 3):
        want = np.asarray(jax_filter.quality_cutoffs(lens, pct))
        got = port_filter.quality_cutoffs(torch.from_numpy(lens), pct).numpy()
        np.testing.assert_array_equal(got, want)
    for a, b in zip(port_filter._hash_powers(300), jax_filter._hash_powers(300)):
        np.testing.assert_array_equal(a, b)


def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode", ["se", "pe_dedup"])
def test_filter_stage_matches_jax(tmp_path, mode):
    """Exact: the clean FASTQ files of the two stages are byte-identical."""
    rng = np.random.default_rng(11)
    genome = synth.random_genome(rng, 3000)
    cfg = FilterConfig(batch_reads=128, max_read_len=128,
                       deduplication=(mode == "pe_dedup"))
    bad = [("N" * 50 + "A" * 50, "I" * 100), ("ACGT" * 25, "#" * 100)]
    if mode == "se":
        reads = synth.shotgun_reads(rng, genome, 300, read_len=100) + bad * 5
        p = synth.write_fastq(tmp_path / "in.fq", reads)
        outs = {}
        for name, stage in (("jax", jax_stage), ("port", port_stage)):
            out = str(tmp_path / f"{name}.fq")
            outs[name] = stage.filter_reads(cfg, p, out, **_CPU[name])
            assert _read_bytes(out) == _read_bytes(tmp_path / "jax.fq")
    else:
        pairs = synth.shotgun_reads(rng, genome, 200, read_len=90, insert=250)
        pairs = pairs + pairs[:15] + [(b, b) for b in bad]
        p1 = synth.write_fastq(tmp_path / "r1.fq", [x[0] for x in pairs])
        p2 = synth.write_fastq(tmp_path / "r2.fq", [x[1] for x in pairs])
        outs = {}
        for name, stage in (("jax", jax_stage), ("port", port_stage)):
            o1, o2 = str(tmp_path / f"{name}.1.fq"), str(tmp_path / f"{name}.2.fq")
            outs[name] = stage.filter_reads(cfg, p1, o1, p2, o2, **_CPU[name])
            for o, j in ((o1, "jax.1.fq"), (o2, "jax.2.fq")):
                assert _read_bytes(o) == _read_bytes(tmp_path / j)
        assert outs["port"].duplicates >= 15
    j, t = outs["jax"], outs["port"]
    assert (t.reads_in, t.reads_kept, t.bases_kept, t.duplicates) == (
        j.reads_in, j.reads_kept, j.bases_kept, j.duplicates)


@pytest.mark.parametrize("pct", [0.2, 0.1, 1 / 3, 0.5, 0.999])
def test_kernel_cutoff_model_matches_float32_product(pct):
    """Exact: the cutoff as the CUDA kernel computes it per read (float32
    length times float32 limit, rounded to nearest, floor) against the torch
    float32 product of the plain version and the JAX package's, for every
    length 0..512."""
    lens = np.arange(0, 513, dtype=np.int32)
    got = kernel_cases.kernel_cutoffs(lens, pct)
    np.testing.assert_array_equal(
        got, port_filter.quality_cutoffs(torch.from_numpy(lens), pct).numpy())
    np.testing.assert_array_equal(got, np.asarray(jax_filter.quality_cutoffs(lens, pct)))


@pytest.mark.parametrize("L", [16, 160, 256, 512])
def test_regrouped_hash_matches_plain_and_jax(L):
    """Exact: the hash summed in the kernel's vector-path order (16 columns
    a lane times B**(16 g), wrapping uint32) against the plain version and
    the JAX reference, with lengths 0..L, N bases and negative codes."""
    rng = np.random.default_rng(L)
    n = 300
    seqs = rng.integers(0, 5, size=(n, L)).astype(np.int8)
    seqs[-3:] = rng.integers(-128, 128, size=(3, L)).astype(np.int8)
    quals = rng.integers(35, 74, size=(n, L)).astype(np.int8)
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    lengths[:2] = (0, L)
    h1, h2 = kernel_cases.regrouped_hashes(seqs, lengths)
    t = [torch.from_numpy(x) for x in (seqs, quals, lengths)]
    _, p1, p2 = port_filter.filter_reads_ref(*t, 10, 55, 0.2)
    np.testing.assert_array_equal(h1, u32_numpy(p1))
    np.testing.assert_array_equal(h2, u32_numpy(p2))
    _, j1, j2 = jax_filter.filter_reads_ref(seqs[:-3], quals[:-3], lengths[:-3], 10, 55, 0.2)
    np.testing.assert_array_equal(h1[:-3], np.asarray(j1))
    np.testing.assert_array_equal(h2[:-3], np.asarray(j2))
