"""Circos-style configuration DSL.

Parity port of the reference's auto-vivifying attribute tree
(utility/bio/circos.py:57-115): ``conf.ideogram.spacing.default = "0.01r"``
creates intermediate nodes on access; duplicate keys are expressed with
trailing underscores (``plot_``, ``plot__`` all emit ``plot``); ``collapse``
turns the tree into nested dicts and ``dict2circos`` renders circos-conf
text (``<block>...</block>`` sections and ``key = value`` lines).

The port renders its circular plot with matplotlib
(stages/visualize.py) — this DSL is kept because the reference also uses
it as a general config namespace and emits circos.conf for users who want
to re-render with circos proper.

Unlike the reference, attribute access on a *leaf* does not silently
create truthy children when read back through ``collapse`` — but plain
attribute reads do auto-vivify, matching the reference's write-side
behavior (configurations.py relies on it).
"""

from __future__ import annotations

from typing import Any, Dict


class Circos:
    def __init__(self) -> None:
        object.__setattr__(self, "_children", {})
        object.__setattr__(self, "_values", {})

    def __getattr__(self, name: str) -> "Circos":
        if name.startswith("_"):
            raise AttributeError(name)
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        children = object.__getattribute__(self, "_children")
        if name not in children:
            children[name] = Circos()
        return children[name]

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, Circos):
            object.__getattribute__(self, "_children")[name] = value
        else:
            object.__getattribute__(self, "_values")[name] = value
            object.__getattribute__(self, "_children").pop(name, None)

    def __bool__(self) -> bool:
        return bool(
            object.__getattribute__(self, "_children")
            or object.__getattribute__(self, "_values")
        )

    def collapse(self) -> Dict[str, Any]:
        """Tree → nested dict; empty auto-vivified nodes are dropped."""
        out: Dict[str, Any] = {}
        for k, v in object.__getattribute__(self, "_values").items():
            out[k] = v
        for k, child in object.__getattribute__(self, "_children").items():
            sub = child.collapse()
            if sub:
                out[k] = sub
        return out


def strip_key(key: str) -> str:
    """Trailing underscores mark duplicate keys (reference circos.py:88)."""
    return key.rstrip("_")


def dict2circos(data: Dict[str, Any], indent: int = 0) -> str:
    """Nested dict → circos configuration text (reference circos.py:98)."""
    pad = " " * (4 * indent)
    lines = []
    for key, value in data.items():
        name = strip_key(key)
        if isinstance(value, dict):
            lines.append(f"{pad}<{name}>")
            lines.append(dict2circos(value, indent + 1))
            lines.append(f"{pad}</{name}>")
        else:
            lines.append(f"{pad}{name} = {value}")
    return "\n".join(lines)


def circos_text(conf: Circos) -> str:
    return dict2circos(conf.collapse())
