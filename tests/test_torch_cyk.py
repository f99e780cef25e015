"""The CM fixture and the port's banded CYK on tensors
(mitoflex_tpu_torch.ops.cyk_device) against the JAX package, on the CPU.

The fixture's Infernal text (mitoflex_tpu_torch/testing/cm_fixture.py) is
parsed by both packages' ``parse_cm_text``: every array equal. The same
model and windows then go through both ``cyk_banded_device`` functions (the
JAX one as one XLA program on the CPU, the port's as eager tensor steps on
the CPU). Tolerances: window coordinates and model coordinates exact; scores
within 1e-3 bits (the IL / IR self-loops take float32 prefix sums, whose
last bits depend on the order of summation).
"""

import os

import numpy as np
import pytest

from mitoflex_tpu.models import cm as jax_cm
from mitoflex_tpu.ops import cyk as jax_cyk
from mitoflex_tpu.ops import cyk_device as jax_dev
from mitoflex_tpu_torch import convert
from mitoflex_tpu_torch.io import encoding
from mitoflex_tpu_torch.models import cm as port_cm
from mitoflex_tpu_torch.ops import cyk as port_cyk
from mitoflex_tpu_torch.ops import cyk_device as port_dev
from mitoflex_tpu_torch.testing import cm_fixture

SCORE_TOL = 1e-3
ARRAYS = ("stype", "node_of", "cfirst", "cnum", "trans", "emit_pair", "emit_single")
HMM_ARRAYS = ("match_emit", "insert_emit", "trans", "map_pos")
MODELS = {"trna": None, "rrna_small": 180, "rrna_full": 950}


@pytest.fixture(scope="module")
def cms(tmp_path_factory):
    """name -> (fixture, port model, JAX model), all parsed from one file."""
    tmp = tmp_path_factory.mktemp("cms")
    rng = np.random.default_rng(2026)
    out = {}
    for name, clen in MODELS.items():
        fx = (cm_fixture.trna_cm(name, rng, "GAA") if clen is None
              else cm_fixture.rrna_cm(name, rng, clen))
        path = cm_fixture.write_cm(fx, str(tmp / f"{name}.cm"))
        out[name] = (fx, port_cm.load_cm_file(path)[0], jax_cm.load_cm_file(path)[0])
    return out


def _models_equal(a, b):
    for f in ("name", "n_states", "n_nodes", "clen", "window", "stats"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert [(n.kind, n.cons_left, n.cons_right, n.state_ids) for n in a.nodes] == \
        [(n.kind, n.cons_left, n.cons_right, n.state_ids) for n in b.nodes]
    ha, hb = a.filter_hmm, b.filter_hmm
    assert (ha.name, ha.length, ha.alphabet, ha.consensus, ha.max_length, ha.stats) == \
        (hb.name, hb.length, hb.alphabet, hb.consensus, hb.max_length, hb.stats)
    for f in HMM_ARRAYS:
        np.testing.assert_array_equal(getattr(ha, f), getattr(hb, f), err_msg=f)


@pytest.mark.parametrize("name", list(MODELS))
def test_fixture_cm_parses_to_equal_arrays(cms, name):
    fx, port_model, jax_model = cms[name]
    _models_equal(port_model, jax_model)
    _models_equal(convert.cm_from_reference(jax_model), port_model)
    assert port_model.n_states == fx.n_states and port_model.n_nodes == fx.n_nodes
    assert port_model.consensus().replace("U", "T") == fx.consensus
    assert port_model.consensus() == jax_model.consensus()
    assert "ECMLC" in port_model.stats and len(port_model.stats["ECMLC"]) == 6
    assert port_cm.cm_evalue(port_model, 40.0, 1e4) == jax_cm.cm_evalue(jax_model, 40.0, 1e4)


def test_fixture_trna_is_a_cloverleaf_with_every_node_kind(cms):
    fx, model, _ = cms["trna"]
    assert fx.clen == 72 and fx.structure == cm_fixture.TRNA_STRUCTURE
    assert {n.kind for n in model.nodes} == set(port_cm.NODE_NAMES)
    assert sum(n.kind == "BIF" for n in model.nodes) == 2
    assert {port_cm.STATE_STR[int(s)] for s in model.stype} == set(port_cm.STATE_NAMES)
    wuss = port_cyk.consensus_layout(model).wuss
    assert wuss == "(((((((,,<<<<________>>>>,<<<<<_______>>>>>,,,,<<<<<_______>>>>>))))))):"
    at = cm_fixture.TRNA_ANTICODON_AT
    assert fx.consensus[at: at + 3] == "GAA" and wuss[at - 2: at + 5] == "_______"
    assert 2800 <= cms["rrna_full"][1].n_states <= 3200


def _window(rng, fx, kind, pad=20):
    """(codes, anchor) for a planted consensus in random flanks."""
    cons = fx.consensus
    flank = lambda n: "".join("ACGT"[int(i)] for i in rng.integers(0, 4, n))
    p0, p1 = 0, len(cons) - 1
    if kind == "mutated":
        arr = list(cons)
        for i in rng.integers(0, len(arr), max(3, len(arr) // 20)):
            arr[int(i)] = "ACGT"[int(rng.integers(0, 4))]
        del arr[len(arr) // 3]                       # one deletion
        arr.insert(2 * len(arr) // 3, "A")           # one insertion
        cons = "".join(arr)
    elif kind == "with_n":
        cons = cons[:10] + "N" + cons[11:30] + "NN" + cons[32:]
    seq = flank(pad) + cons + flank(pad)
    w0, w1 = pad, pad + len(cons) - 1
    if kind == "truncated":
        # the model's last fifth runs off the window's right edge
        cut = len(fx.consensus) // 5
        seq = seq[: pad + len(cons) - cut]
        w1, p1 = len(seq) - 1, p1 - cut
    return np.asarray(encoding.encode(seq)), (w0, w1, p0, p1)


def _same(got, want):
    if want is None or got is None:
        assert got is None and want is None
        return
    assert (got.seq_from, got.seq_to, got.mdl_from, got.mdl_to) == \
        (want.seq_from, want.seq_to, want.mdl_from, want.mdl_to)
    assert abs(got.score - want.score) <= SCORE_TOL


@pytest.mark.parametrize("kind", ["planted", "mutated", "truncated", "with_n"])
@pytest.mark.parametrize("slack", [8, 48])
@pytest.mark.parametrize("local", [False, True], ids=["glocal", "local"])
@pytest.mark.parametrize("name", ["trna", "rrna_small"])
def test_cyk_banded_device_matches_jax(cms, name, local, slack, kind):
    fx, port_model, jax_model = cms[name]
    rng = np.random.default_rng(len(kind) * 100 + slack)
    window, anchor = _window(rng, fx, kind)
    want = jax_dev.cyk_banded_device(jax_model, window, anchor, slack, local=local)
    got = port_dev.cyk_banded_device(port_model, window, anchor, slack, local=local,
                                     device="cpu")
    _same(got, want)
    if kind == "planted":
        assert got is not None and got.seq_from == anchor[0] and got.seq_to == anchor[1]
    # the contract: host banded <= device <= exact (where exact is affordable)
    host = port_cyk.cyk_banded(port_model, window, anchor, slack, local=local)
    if host is not None:
        assert got is not None and host.score <= got.score + SCORE_TOL
    if name == "trna" and got is not None:
        exact = port_cyk.cyk_align(port_model, window, local=local)
        assert got.score <= exact.score + SCORE_TOL
        if kind == "planted":
            assert abs(got.score - exact.score) <= SCORE_TOL


def test_cyk_banded_device_rrna_size_matches_jax(cms):
    """The full-size fixture (CLEN 950, about 2,900 states) once: local mode,
    slack 48, the planted consensus."""
    fx, port_model, jax_model = cms["rrna_full"]
    window, anchor = _window(np.random.default_rng(9), fx, "planted", pad=64)
    want = jax_dev.cyk_banded_device(jax_model, window, anchor, 48, local=True)
    got = port_dev.cyk_banded_device(port_model, window, anchor, 48, local=True,
                                     device="cpu")
    _same(got, want)
    assert (got.seq_from, got.seq_to) == (64, 64 + fx.clen - 1) and got.score > 1000


def test_cyk_banded_device_refuses_far_bifurcation_bands_like_jax(cms, monkeypatch):
    """A band offset at a bifurcation of a block width or more raises
    ValueError in both packages. Contiguous splits never produce one, so
    both modules get subtree spans in which one BEGR subtree is moved 50
    consensus positions away from its seam."""
    import dataclasses

    fx, port_model, jax_model = cms["rrna_small"]
    window, anchor = _window(np.random.default_rng(1), fx, "planted")
    b_state = int(np.flatnonzero(port_model.stype == port_cm.B)[0])
    right_node = int(port_model.node_of[port_model.cnum[b_state]])

    def moved(real):
        def spans(model):
            out = list(real(model))
            out[right_node] = (out[right_node][0] + 50, out[right_node][1] + 50)
            return out
        return spans

    monkeypatch.setattr(jax_dev, "node_subtree_spans", moved(jax_cyk.node_subtree_spans))
    monkeypatch.setattr(port_dev, "node_subtree_spans", moved(port_cyk.node_subtree_spans))
    with pytest.raises(ValueError, match="bifurcation band offset"):
        jax_dev.cyk_banded_device(dataclasses.replace(jax_model), window, anchor, 4,
                                  local=True)
    with pytest.raises(ValueError, match="bifurcation band offset"):
        port_dev.cyk_banded_device(dataclasses.replace(port_model), window, anchor, 4,
                                   local=True, device="cpu")


def test_model_tables_are_cached_per_model_and_rebuilt_for_a_new_one(cms):
    _, port_model, jax_model = cms["trna"]
    import torch

    a = port_dev._model_static(port_model, True, torch.device("cpu"))
    assert port_dev._model_static(port_model, True, torch.device("cpu")) is a
    assert port_dev._model_static(port_model, False, torch.device("cpu")) is not a
    other = convert.cm_from_reference(jax_model)
    assert port_dev._model_static(other, True, torch.device("cpu")) is not a
