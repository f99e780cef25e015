"""Converters between the JAX package's state (as numpy) and the port's
tensors.

uint32 in torch: ``torch.uint32`` has thin operator support (sort,
comparisons and bit operations are not all there on CUDA), so the port
carries every uint32 quantity — k-mer key words, scattered-run counts,
filter hashes — as the int32 tensor with the same bit pattern. Orders are
taken on sign-flipped words (ops/psort.py ``lexsort_words``); arithmetic
that must wrap at 2**32 runs in int64 and is masked back.

State converters (both ways):

- scattered runs: W uint32 word arrays + uint32 counts <-> ``[W, n]`` int32
  words + ``[n]`` int32 counts on a device;
- ``ContigIndex`` fields (``keys``, ``contig_of``, ``pos_of``,
  ``n_entries``);
- ``GraphPass`` fields;
- staged profiles (``phmm.DeviceProfile``) and alignment hits
  (``HmmHits``, ``SwHits``, ``WiseHits``);
- covariance models (``models.cm.CovarianceModel`` with its filter HMM);
- gene locations (``locs``) and per-contig depth arrays of the visualize
  stage.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .utils import trace

MASK32 = 0xFFFFFFFF


def to_device(x: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor on ``device`` (uint32 arrays become int32 bit
    patterns)."""
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x).to(device)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 bit patterns (or int64 values in [0, 2**32)) -> numpy uint32."""
    t = trace.read_back(t.detach())
    if t.dtype == torch.int32:
        return t.numpy().view(np.uint32)
    return (t.to(torch.int64) & MASK32).numpy().astype(np.uint32)


def i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 tensor with their bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def u32_values(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return x.to(torch.int64) & MASK32


def host(x) -> np.ndarray:
    """A tensor or array as numpy (no copy for numpy or CPU tensors).
    ``np.asarray`` raises on a CUDA tensor, so every device -> host read of
    the slice goes through here or :func:`u32_numpy`, and is charged to the
    innermost span when traced (utils/trace.read_back)."""
    if isinstance(x, torch.Tensor):
        return trace.read_back(x.detach()).numpy()
    return np.asarray(x)


# --------------------------------------------------------- scattered runs
def scattered_to_torch(
    words: Sequence[np.ndarray], counts: np.ndarray, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    return (to_device(np.stack([np.asarray(w, np.uint32) for w in words]), device),
            to_device(np.asarray(counts, np.uint32), device))


def scattered_to_numpy(
    run: Tuple[torch.Tensor, torch.Tensor]
) -> Tuple[List[np.ndarray], np.ndarray]:
    words, counts = run
    return list(u32_numpy(words)), u32_numpy(counts)


# ------------------------------------------------------------ ContigIndex
def contig_index_to_torch(index, device):
    """A JAX ``ContigIndex`` (or any object with its fields) -> the port's,
    with the padding beyond ``n_entries`` dropped."""
    from .ops.mapper import ContigIndex

    n = int(index.n_entries)
    return ContigIndex(
        list(index.ids), np.asarray(index.lengths, np.int64),
        torch.from_numpy(np.asarray(index.keys)[:n].astype(np.int64)).to(device),
        torch.from_numpy(np.asarray(index.contig_of)[:n].astype(np.int64)).to(device),
        torch.from_numpy(np.asarray(index.pos_of)[:n].astype(np.int64)).to(device),
        n,
    )


def contig_index_to_numpy(index) -> dict:
    """The port's ``ContigIndex`` fields as the JAX package's dtypes
    (uint32 keys, int32 payloads; valid rows only)."""
    n = int(index.n_entries)
    return {
        "keys": u32_numpy(index.keys[:n]),
        "contig_of": host(index.contig_of[:n]).astype(np.int32),
        "pos_of": host(index.pos_of[:n]).astype(np.int32),
        "n_entries": n,
    }


# -------------------------------------------------------------- GraphPass
def graph_pass_to_numpy(gp):
    """A ``GraphPass`` of tensors (port) or arrays (either package) -> the
    same NamedTuple of numpy arrays in the JAX package's dtypes, valid rows
    only: node arrays cut to ``n_nodes``; ``node_words`` a list of W uint32
    arrays."""
    n = int(gp.n_nodes)
    nw = gp.node_words
    if isinstance(nw, torch.Tensor):
        words = list(u32_numpy(nw[:, :n]))
    else:
        words = [np.asarray(w)[:n].astype(np.uint32) for w in nw]
    n_edges = int(host(gp.edge_valid).sum())

    def node(x, dtype):
        return host(x)[:n].astype(dtype)

    def edge(x, dtype):
        return host(x)[:n_edges].astype(dtype)

    return gp._replace(
        node_words=words, n_nodes=n,
        out_deg=node(gp.out_deg, np.int32), in_deg=node(gp.in_deg, np.int32),
        root=node(gp.root, np.int32), offset=node(gp.offset, np.int32),
        link_count=node(gp.link_count, np.uint32),
        is_cycle=node(gp.is_cycle, bool),
        prefix_id=edge(gp.prefix_id, np.int32),
        suffix_id=edge(gp.suffix_id, np.int32),
        edge_valid=np.ones(n_edges, bool),
        order=None if gp.order is None else node(gp.order, np.int32),
    )


def graph_pass_to_torch(gp, device):
    """A ``GraphPass`` of arrays (either package) -> the port's GraphPass of
    tensors on ``device``, valid rows only."""
    from .ops.dbg import GraphPass

    g = graph_pass_to_numpy(gp)

    def t(x):
        return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)

    return GraphPass(
        node_words=to_device(np.stack(g.node_words), device),
        n_nodes=g.n_nodes, out_deg=t(g.out_deg), in_deg=t(g.in_deg),
        root=t(g.root), offset=t(g.offset), link_count=t(g.link_count),
        is_cycle=torch.from_numpy(g.is_cycle).to(device),
        prefix_id=t(g.prefix_id), suffix_id=t(g.suffix_id),
        edge_valid=torch.from_numpy(g.edge_valid).to(device),
    )


# ------------------------------------------------- staged profiles and hits
def profile_to_torch(prof, device):
    """A staged profile of either package (``phmm.DeviceProfile``, one model
    or stacked) -> the port's, its arrays as float32 tensors on ``device``."""
    from .ops.phmm import DeviceProfile

    return DeviceProfile(
        *(torch.from_numpy(np.array(getattr(prof, f), np.float32)).to(device)
          for f in DeviceProfile._fields[:-1]),
        int(prof.length),
    )


def profile_to_numpy(prof) -> dict:
    """A staged profile of either package as a dict of numpy arrays (and
    the model length)."""
    out = {f: host(getattr(prof, f)) for f in prof._fields[:-1]}
    out["length"] = int(prof.length)
    return out


def hits_to_numpy(hits):
    """``HmmHits`` or ``SwHits`` of either package -> the same NamedTuple
    holding numpy arrays."""
    return type(hits)(*(host(x) for x in hits))


def wise_hits_from_reference(hits, device=None):
    """``WiseHits`` of the JAX package (or any object with its six fields)
    -> the port's ``WiseHits`` of tensors on ``device`` (``None``: the card,
    or a ``RuntimeError``)."""
    from .device import resolve_device
    from .ops.genewise import WiseHits

    device = resolve_device(device)
    return WiseHits(*(torch.from_numpy(np.array(getattr(hits, f))).to(device)
                      for f in WiseHits._fields))


# ------------------------------------------------------- covariance models
def hmm_from_reference(hmm):
    """A ``ProfileHMM`` of the JAX package -> the port's (arrays copied)."""
    from .models.hmm import ProfileHMM

    def arr(x):
        return None if x is None else np.array(x)

    return ProfileHMM(
        name=hmm.name, length=int(hmm.length), alphabet=hmm.alphabet,
        match_emit=arr(hmm.match_emit), insert_emit=arr(hmm.insert_emit),
        trans=arr(hmm.trans), compo=arr(hmm.compo), max_length=hmm.max_length,
        stats=dict(hmm.stats), consensus=hmm.consensus, map_pos=arr(hmm.map_pos),
    )


def cm_from_reference(model):
    """A ``CovarianceModel`` of the JAX package -> the port's, arrays as
    numpy copies, model-tree nodes and the filter HMM included, so that a
    test can feed both packages the same model however it was built."""
    from .models.cm import CmNode, CovarianceModel

    return CovarianceModel(
        name=model.name, n_states=int(model.n_states), n_nodes=int(model.n_nodes),
        clen=int(model.clen), window=int(model.window),
        stype=np.array(model.stype), node_of=np.array(model.node_of),
        cfirst=np.array(model.cfirst), cnum=np.array(model.cnum),
        trans=np.array(model.trans), emit_pair=np.array(model.emit_pair),
        emit_single=np.array(model.emit_single),
        nodes=[CmNode(n.kind, n.cons_left, n.cons_right, list(n.state_ids))
               for n in model.nodes],
        filter_hmm=(None if model.filter_hmm is None
                    else hmm_from_reference(model.filter_hmm)),
        stats=dict(model.stats),
    )


# ------------------------------------------------------- visualize inputs
def locs_from_reference(locs) -> Dict[str, tuple]:
    """Gene locations as either package's annotate returns them (tuples) or
    as ``locs.json`` holds them (lists) -> ``{gene: (start, end, kind,
    contig, strand)}`` with plain ints and strings, the form ``visualize``
    takes."""
    return {str(g): (int(v[0]), int(v[1]), int(v[2]), str(v[3]), str(v[4]))
            for g, v in locs.items()}


def depth_to_numpy(depth_per_contig) -> List[np.ndarray]:
    """The per-contig depth arrays of ``coverage_of_reads`` (either
    package) as int64 numpy arrays."""
    return [host(d).astype(np.int64) for d in depth_per_contig]
