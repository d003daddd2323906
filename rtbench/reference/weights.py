"""Parameters drawn from the run's seed, in the port's tree.

The tree is the one the port's ``Transformer`` takes: ``embed`` (V, D),
``super``: one dict of layer-stacked leaves per block kind of the
pattern (leading axis = layers), ``tail``: [], ``final_norm``. Leaves
are drawn on the device, in the configuration's dtype, one
``torch.randn`` call per stacked leaf from one ``torch.Generator``
seeded with the run's seed, in the order of the family's ``leaves``
(``families/<name>.py``, which gives each leaf's scale).
"""
from __future__ import annotations

from typing import Dict

import torch


def _put(tree, path, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
            continue
        if key not in node:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    node[path[-1]] = value


def make(family, dims: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The parameter tree of one model of ``family`` (a module of
    ``families/``, whose ``leaves(dims)`` lists it), drawn from ``seed``
    on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tree: Dict = {"tail": []}
    with torch.no_grad():
        for path, shape, std, mean in family.leaves(dims):
            t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
            t.mul_(std)
            if mean:
                t.add_(mean)
            _put(tree, path, t)
    return tree

