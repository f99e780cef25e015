"""WUSS (Washington University Secondary Structure) notation parser.

Re-implementation of the reference's component-tree model
(utility/bio/wuss.py:38-384): a fold string plus an equal-length base
string are parsed into a tree of loop partitions —

    HairpinLoop   span enclosed by ``<...>``; owns a Stem (the paired
                  bases), a Hairpin (the ``_`` loop bases, in order) and
                  an interior-loop set (``-``);
    MultiLoop     span enclosed by ``(...)``; owns a Stem, a multi-branch
                  set (``,``), and child HairpinLoops;
    ComplexLoop   ``[...]`` level, may contain MultiLoops;
    GenericLoop   ``{...}`` top level, parses any of the lower levels.

Each base records the chain of partitions it belongs to (``parent``);
``components`` lists a span's immediate children in sequence order with
consecutive bases of the same partition grouped — the structure the tRNA
anticodon extraction walks (annotation_tookit.py:403-446: center hairpin
of the MultiLoop, 7-base loop, anticodon at loop positions 2:5).

``align_fold`` repairs unbalanced folds by deleting unmatched brackets
(same bracket-level reconciliation as the reference :349-384).
"""

from __future__ import annotations

from itertools import groupby
from typing import List, Optional, Tuple

LEFT = "<([{"
RIGHT = ">)]}"
LEVEL = {"<": 0, "(": 1, "[": 2, "{": 3, ">": 0, ")": 1, "]": 2, "}": 3}


class Single:
    def __init__(self, base: str, parent: Optional[list] = None):
        self.base = base
        self.parent = parent if parent is not None else []

    def __repr__(self):
        return self.base


def seq2single(sequence: str) -> List[Single]:
    return [Single(x) for x in sequence]


class Sequence:
    def __init__(self, sequence: Optional[List[Single]] = None):
        self.sequence = sequence if sequence is not None else []

    def push(self, base: Single):
        self.sequence.append(base)

    def to_str(self) -> str:
        return "".join(s.base for s in self.sequence)

    def __repr__(self):
        return self.to_str()


class Sets:
    def __init__(self):
        self.bases = set()

    def insert(self, base: Single):
        self.bases.add(base)

    def __repr__(self):
        return f'({",".join(s.base for s in self.bases)})'


class Paired:
    def __init__(self):
        self.left: List[Single] = []
        self.right: List[Single] = []

    def insert(self, l: Single, r: Single):
        self.left.insert(0, l)
        self.right.append(r)

    def __repr__(self):
        return (
            f'L:{"".join(s.base for s in self.left)} '
            f'R:{"".join(s.base for s in self.right)}'
        )


class Hairpin(Sequence):
    pass


class Stem(Paired):
    pass


class InteriorLoop(Sets):
    pass


class MultiBranchLoop(Sets):
    pass


def _components_at(self, sequence: List[Single]):
    level = sequence[0].parent.index(self) + 1
    translated = []
    for base in sequence:
        translated.append(base.parent[level] if len(base.parent) > level else None)
    return [x[0] for x in groupby(translated)]


class HairpinLoop:
    """Span enclosed by <...> (level 0)."""

    def __init__(self, fold: str, sequence: List[Single]):
        if len(fold) != len(sequence):
            raise RuntimeError("Fold must be as long as the base sequence!")
        self.fold = fold
        self.sequence = sequence
        self.stem = Stem()
        self.hairpin = Hairpin()
        self.loop = InteriorLoop()
        self.unknown = Sets()
        stack: List[Single] = []
        for idx, cha in enumerate(fold):
            base = sequence[idx]
            base.parent.append(self)
            if cha == "_":
                base.parent.append(self.hairpin)
                self.hairpin.push(base)
            elif cha == "<":
                base.parent.append(self.stem)
                stack.append(base)
            elif cha == ">":
                # right-stem bases group with the hairpin component, matching
                # the reference's partitioning (wuss.py:140-144)
                base.parent.append(self.hairpin)
                if stack:
                    self.stem.insert(stack.pop(), base)
            elif cha == "-":
                base.parent.append(self.loop)
                self.loop.insert(base)
            else:
                base.parent.append(self.unknown)
                self.unknown.insert(base)
        self.components = _components_at(self, sequence)


class _BracketLoop:
    """Shared machinery for the (, [, { levels: delegates maximal spans of
    the next level down to the child class and classifies loose chars."""

    OPEN: str
    CHILD_SPANS: Tuple[Tuple[str, type], ...]  # (open_char, child class)

    def __init__(self, fold: str, sequence: List[Single]):
        if len(fold) != len(sequence):
            raise RuntimeError("Fold must be as long as the base sequence!")
        self.fold = fold
        self.sequence = sequence
        self.stem = Stem()
        self.multi = MultiBranchLoop()
        self.interior = InteriorLoop()
        self.mismatch = Sets()
        self.unknown = Sets()
        close = RIGHT[LEFT.index(self.OPEN)]
        child_of = dict(self.CHILD_SPANS)
        child_close = {RIGHT[LEFT.index(o)]: o for o in child_of}

        stack_own: List[Single] = []
        span_stack: List[Tuple[str, int]] = []  # (open char, index)
        for idx, cha in enumerate(fold):
            base = sequence[idx]
            if span_stack:
                # inside a child span: just track nesting of that span type
                if cha == span_stack[-1][0]:
                    span_stack.append((cha, idx))
                elif cha in child_close and child_close[cha] == span_stack[-1][0]:
                    opener, start = span_stack.pop()
                    if not span_stack:
                        cls = child_of[opener]
                        cls(fold[start : idx + 1], sequence[start : idx + 1])
                continue
            base.parent.append(self)
            if cha == self.OPEN:
                stack_own.append(base)
            elif cha == close:
                if stack_own:
                    l = stack_own.pop()
                    self.stem.insert(l, base)
                    l.parent.append(self.stem)
                    base.parent.append(self.stem)
            elif cha in child_of:
                base.parent.pop()  # child loop will claim it
                span_stack.append((cha, idx))
            elif cha == ",":
                base.parent.append(self.multi)
                self.multi.insert(base)
            elif cha == "-":
                base.parent.append(self.interior)
                self.interior.insert(base)
            elif cha == ":":
                base.parent.append(self.mismatch)
                self.mismatch.insert(base)
            else:
                base.parent.append(self.unknown)
                self.unknown.insert(base)
        # child spans appended their own parents; re-run to ensure every base
        # has self in its chain for grouping
        for base in sequence:
            if self not in base.parent:
                base.parent.insert(0, self)
        self.components = _components_at(self, sequence)


class MultiLoop(_BracketLoop):
    """Span enclosed by (...): contains hairpins."""

    OPEN = "("
    CHILD_SPANS = (("<", HairpinLoop),)


class ComplexLoop(_BracketLoop):
    """Span enclosed by [...]: contains multiloops and hairpins."""

    OPEN = "["
    CHILD_SPANS = (("(", MultiLoop), ("<", HairpinLoop))


class GenericLoop(_BracketLoop):
    """Top level {...} (also parses folds without braces)."""

    OPEN = "{"
    CHILD_SPANS = (("[", ComplexLoop), ("(", MultiLoop), ("<", HairpinLoop))


def align_fold(fold: str, sing: str) -> Tuple[str, str]:
    """Drop unmatched brackets (and their bases) so the fold balances —
    reference align_fold (wuss.py:349-384)."""
    stack: List[Tuple[str, int]] = []
    drop: List[int] = []
    for idx, cha in enumerate(fold):
        if cha in RIGHT and stack:
            right_level = LEVEL[cha]
            matched = False
            while not matched:
                if not stack:
                    drop.append(idx)
                    break
                left_level = LEVEL[stack[-1][0]]
                if right_level == left_level:
                    stack.pop()
                    matched = True
                elif right_level > left_level:
                    drop.append(idx)
                    matched = True
                else:
                    drop.append(stack.pop()[1])
        elif cha in LEFT:
            stack.append((cha, idx))
        elif cha in RIGHT:
            drop.append(idx)
    drop += [i for _, i in stack]
    dropset = set(drop)
    return (
        "".join(x for i, x in enumerate(fold) if i not in dropset),
        "".join(x for i, x in enumerate(sing) if i not in dropset),
    )
