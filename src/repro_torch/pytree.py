"""Nested containers of tensors in the reference's leaf order.

The JAX package keeps parameters, optimizer moments and decode caches as
pytrees; ``jax.tree.flatten`` visits a dict's keys in sorted order, a tuple
(or ``NamedTuple``) and a list in position order, and treats ``None`` as a
node without leaves.  ``flatten`` here follows the same rules, so leaf ``i``
of a port tree is leaf ``i`` of the reference's tree of the same model: the
checkpoint layout (``leaf_<i>``) and the converters rely on it.

``ParamTree`` holds a nested dict of parameters as an ``nn.Module``:
``named_parameters()`` yields the reference's paths with dots
(``blocks.l0.attn.wq``), and ``tree["blocks"]["l0"]`` indexes it like the
reference's dict.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
from torch import nn


class ParamTree(nn.Module):
    """A nested mapping of parameters: each mapping becomes a child
    ``ParamTree``, each tensor an ``nn.Parameter`` (the tensor itself when
    it already is one)."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for key in sorted(tree):
            val = tree[key]
            if isinstance(val, ParamTree):
                self.add_module(key, val)
            elif isinstance(val, Mapping):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, val if isinstance(val, nn.Parameter)
                    else nn.Parameter(val))

    def keys(self):
        return sorted([*self._parameters, *self._modules])

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __getitem__(self, key):
        if key in self._parameters:
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


class TreeDef:
    """The structure of a flattened tree: ``kind`` is 'leaf', 'none',
    'dict', 'params', 'list', 'tuple' or a ``NamedTuple`` class."""

    def __init__(self, kind, keys=(), children=()):
        self.kind, self.keys, self.children = kind, tuple(keys), children

    def __repr__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = ", ".join(repr(c) for c in self.children)
        if self.kind in ("dict", "params"):
            inner = ", ".join(f"'{k}': {c!r}"
                              for k, c in zip(self.keys, self.children))
            return f"{self.kind}{{{inner}}}"
        name = self.kind if isinstance(self.kind, str) else \
            self.kind.__name__
        return f"{name}({inner})"


def flatten(tree, is_leaf=None) -> tuple[list, TreeDef]:
    """(leaves in the reference's order, structure).  ``is_leaf(node)``
    true makes a node a leaf, as in ``jax.tree.flatten``."""
    leaves: list = []

    def walk(node) -> TreeDef:
        if is_leaf is not None and node is not None and is_leaf(node):
            leaves.append(node)
            return TreeDef("leaf")
        if node is None:
            return TreeDef("none")
        if isinstance(node, (ParamTree, Mapping)):
            keys = sorted(node.keys())
            kind = "params" if isinstance(node, ParamTree) else "dict"
            return TreeDef(kind, keys, [walk(node[k]) for k in keys])
        if _is_namedtuple(node):
            return TreeDef(type(node), (), [walk(c) for c in node])
        if isinstance(node, (list, tuple)):
            return TreeDef("list" if isinstance(node, list) else "tuple",
                           (), [walk(c) for c in node])
        leaves.append(node)
        return TreeDef("leaf")

    return leaves, walk(tree)


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` over ``leaves``; a 'params' node becomes a
    new ``ParamTree`` (a leaf that is a plain tensor becomes a new
    ``nn.Parameter``, with ``requires_grad`` as a fresh parameter has)."""
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        kids = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.keys, kids))
        if td.kind == "params":
            return ParamTree(dict(zip(td.keys, kids)))
        if td.kind == "list":
            return kids
        if td.kind == "tuple":
            return tuple(kids)
        return td.kind(*kids)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def leaves(tree, is_leaf=None) -> list:
    return flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree, *rest, is_leaf=None) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree of ``rest``: equal leaf counts); a 'params' node comes back as a
    plain dict, so a map over a ``ParamTree`` never makes parameters.
    ``is_leaf`` as in ``flatten``, for every tree."""
    flat, td = flatten(tree, is_leaf)
    others = [flatten(r, is_leaf)[0] for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"trees differ: {len(flat)} and {len(o)} leaves")
    out = [fn(*args) for args in zip(flat, *others)]
    return unflatten(plain_structure(td), out)


def plain_structure(td: TreeDef) -> TreeDef:
    """``td`` with its 'params' nodes as plain dicts (same leaf order)."""
    if td.kind == "leaf" or td.kind == "none":
        return td
    kind = "dict" if td.kind == "params" else td.kind
    return TreeDef(kind, td.keys, [plain_structure(c) for c in td.children])


def as_dict(tree) -> dict:
    """A ``ParamTree`` (or a nested mapping) as nested plain dicts over the
    same tensor objects."""
    return {k: as_dict(v) if isinstance(v, (ParamTree, Mapping)) else v
            for k, v in tree.items()}

