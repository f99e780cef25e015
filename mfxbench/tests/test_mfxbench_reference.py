"""The plain reference's Viterbi against the port's own plain version on the
CPU, and the control (the reference in bfloat16) well outside its gap."""

import numpy as np
import pytest
import torch

from mfxbench.generators import hmm_text, mitogenome
from mfxbench.reference import hmm as ref_hmm
from mfxbench.reference import viterbi as ref_viterbi


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(5)
    cons = {"A": mitogenome.random_dna(rng, 180), "B": mitogenome.random_dna(rng, 130)}
    text = hmm_text.hmm_text([hmm_text.profile_from_consensus(n, c) for n, c in cons.items()])
    path = tmp_path_factory.mktemp("h") / "m.hmm"
    path.write_text(text)
    T = 400
    codes = rng.integers(0, 4, (6, T)).astype(np.int8)
    enc = {c: i for i, c in enumerate("ACGT")}
    for r, name in enumerate("AAB"):
        s = np.array([enc[c] for c in cons[name]], np.int8)
        codes[r, 40 + 5 * r: 40 + 5 * r + len(s)] = s
    codes[1, 90:95] = 4                               # Ns inside a hit
    codes[1, 120:131] = rng.integers(0, 4, 11)       # a mutated stretch
    lengths = np.array([400, 350, 400, 250, 400, 9], np.int32)
    return str(path), text, codes, lengths


@pytest.mark.parametrize("index", [0, 1])
def test_mfxbench_reference_matches_port(case, index):
    from mitoflex_tpu_torch.models import hmm
    from mitoflex_tpu_torch.ops import phmm

    path, text, codes, lengths = case
    port = hmm.load_hmm_file(path)[index]
    prof = phmm.stage_profile(port, device="cpu")
    got = phmm.viterbi_scores_multi_plain(phmm.stack_profiles([prof]), [port.length],
                                          torch.tensor(codes), torch.tensor(lengths))[0]
    scan = phmm.viterbi_scan_plain(prof, torch.tensor(codes), torch.tensor(lengths),
                                   port.length)
    ref = ref_viterbi.scores(ref_hmm.parse(text)[port.name], codes, lengths)
    assert np.abs(got.numpy() - ref).max() < 2e-3
    assert np.abs(scan.score.numpy() - ref).max() < 2e-3
    control = ref_viterbi.scores(ref_hmm.parse(text)[port.name], codes, lengths,
                                 dtype=torch.bfloat16)
    assert np.abs(control - ref).max() > 1.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_mfxbench_reference_models_side_by_side(case, dtype):
    """Models of different lengths run side by side (the control's batched
    call) give each model's own scores, bit for bit."""
    _, text, codes, lengths = case
    models = list(ref_hmm.parse(text).values())
    assert len({m.length for m in models}) > 1
    multi = ref_viterbi.scores_multi(models, codes, lengths, dtype=dtype)
    for row, m in zip(multi, models):
        np.testing.assert_array_equal(row, ref_viterbi.scores(m, codes, lengths, dtype=dtype))
