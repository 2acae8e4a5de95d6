"""Trees of tensors: nested dicts, lists and tuples (``NamedTuple``s
included) with tensors at the leaves, as the port's params, caches and
optimizer states are.  Leaves are visited in order: a dict's by its
keys' insertion order, a list's or tuple's by index."""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Tuple

__all__ = ["leaves", "leaves_with_paths", "unflatten"]


def leaves_with_paths(tree, path: str = "", out: Optional[List] = None) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf of ``tree``, in order; a path joins
    the keys and indices with ``/``."""
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            leaves_with_paths(v, f"{path}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            leaves_with_paths(v, f"{path}/{i}", out)
    else:
        out.append((path, tree))
    return out


def leaves(tree) -> List[Any]:
    """The leaves of ``tree``, in order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, new_leaves, it: Optional[Iterator] = None):
    """``like``'s structure with its leaves replaced, in order, by
    ``new_leaves``.  Lists stay lists and tuples tuples; a ``NamedTuple``
    (an optimizer state) is rebuilt field by field."""
    it = iter(new_leaves) if it is None else it
    if isinstance(like, dict):
        return {k: unflatten(v, new_leaves, it) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        items = [unflatten(v, new_leaves, it) for v in like]
        return type(like)(*items) if hasattr(like, "_fields") else type(like)(items)
    return next(it)
