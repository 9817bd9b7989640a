"""Manifold tags for parameter sets (counterpart of
``hyperspace_tpu/optim/tags.py``).

A *tag structure* mirrors the parameters: a single tensor is tagged by
one ``Manifold`` or ``None`` (Euclidean), a dict of named tensors (nested
dicts allowed) by a dict of the same keys.  One optimizer then updates
mixed Euclidean and manifold parameters (geoopt's ManifoldParameter
pattern).  JAX builds tag trees from flax key paths; here the rule reads
parameter names (:func:`tags_from_names`)."""

from __future__ import annotations

from typing import Any, Callable

from hyperspace_torch.manifolds.base import Manifold


def is_tag(x: Any) -> bool:
    return x is None or isinstance(x, Manifold)


def map_tagged(fn: Callable, tags, *trees):
    """``fn(tag, *leaves)`` for every parameter, keeping the structure:
    a dict of tags maps key by key (recursively), a bare tag calls ``fn``
    once on the trees themselves."""
    if isinstance(tags, dict):
        return {k: map_tagged(fn, t, *(tr[k] for tr in trees))
                for k, t in tags.items()}
    if not is_tag(tags):
        raise TypeError(f"a tag is a Manifold or None; got {tags!r}")
    return fn(tags, *trees)


def tags_from_names(params: dict, rule: Callable[[str], Any]) -> dict:
    """A tag dict from a rule over dotted parameter names (nested dicts
    join their keys with '.'): ``rule(name)`` returns a Manifold or
    None."""
    def walk(tree, prefix):
        return {k: walk(v, f"{prefix}{k}.") if isinstance(v, dict)
                else rule(f"{prefix}{k}") for k, v in tree.items()}

    return walk(params, "")


def name_contains(name: str, part: str) -> bool:
    """True if ``part`` is one of the dot-separated components of
    ``name`` (JAX's ``path_contains`` on a key path)."""
    return part in name.split(".")
