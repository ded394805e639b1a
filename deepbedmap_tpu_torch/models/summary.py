"""Model introspection (replaces the reference's Graphviz dump of the Chainer
computational graph, srgan_train.py:1363-1377): parameter-tree tables and a
DOT rendering of the module hierarchy.

Counterpart of ``deepbedmap_tpu/models/summary.py`` over the same flax-layout
tree (nested dicts of arrays), walked by a dict recursion in place of
``jax.tree_util``; each leaf's path is written as ``jax.tree_util.keystr``
writes it (``['a']['b']``), so ``summary`` and ``to_dot`` give JAX's text
byte for byte on the same tree. ``bridge.state_dict_to_jax_params`` gives
that tree for the port's generator.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

import numpy as np


def _leaves(tree: Mapping, prefix: str = ""):
    for key in sorted(tree):
        path = f"{prefix}[{key!r}]"
        if isinstance(tree[key], Mapping):
            yield from _leaves(tree[key], path)
        else:
            yield path, tree[key]


def param_table(params) -> List[Tuple[str, Tuple[int, ...], int]]:
    """[(path, shape, size)] for every parameter leaf, sorted by path."""
    rows = []
    for name, leaf in _leaves(params):
        shape = tuple(int(d) for d in np.shape(leaf))
        rows.append((name, shape, int(np.prod(shape, dtype=np.int64))))
    return sorted(rows)


def summary(params, title: str = "model") -> str:
    """Human-readable parameter summary (total matches the reference's
    count_params doctests)."""
    rows = param_table(params)
    width = max(len(r[0]) for r in rows) if rows else 10
    lines = [f"{title}: {sum(r[2] for r in rows):,} parameters"]
    for name, shape, size in rows:
        lines.append(f"  {name:<{width}}  {str(shape):<20} {size:>12,}")
    return "\n".join(lines)


def to_dot(params, title: str = "model") -> str:
    """Graphviz DOT of the parameter tree (module hierarchy as clusters)."""
    lines = [f'digraph "{title}" {{', "  rankdir=LR;", '  node [shape=box];']
    for name, shape, size in param_table(params):
        clean = name.strip("[]'").replace("']['", "/").replace("'", "")
        lines.append(
            f'  "{clean}" [label="{clean}\\n{shape} = {size:,}"];'
        )
    lines.append("}")
    return "\n".join(lines)

