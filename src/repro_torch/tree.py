"""Trees of tensors, the port's counterpart of JAX pytrees: nested dicts,
tuples, lists and NamedTuples (``AdamWState``). Leaves are visited in JAX's
order: dict keys sorted, sequences by index, NamedTuples by field; None is
no leaf and stays None. The optimizer, the train step and the checkpoint
keys all read trees through here."""
from __future__ import annotations

from typing import Any, Callable


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, path: tuple = ()) -> Any:
    """``tree`` with each leaf replaced by ``fn(key, leaf)``, where ``key``
    is the leaf's path joined by ``/`` as the JAX package's checkpoint keys
    are (``"0/blocks/0/attn/wq"``, ``"1/m/embed"``, ``"1/step"``). Dicts
    keep their own key order; ``fn`` is called in JAX's leaf order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        done = {k: map_with_path(fn, tree[k], path + (str(k),)) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, x, path + (name,))
                            for name, x in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, x, path + (str(i),)) for i, x in enumerate(tree))
    return fn("/".join(path), tree)


def flatten_with_paths(tree: Any) -> dict[str, Any]:
    """{key: leaf} in JAX's leaf order (``map_with_path``'s keys)."""
    out: dict[str, Any] = {}
    map_with_path(out.__setitem__, tree)
    return out


def leaves(tree: Any) -> list:
    return list(flatten_with_paths(tree).values())


def unflatten(tree: Any, new_leaves) -> Any:
    """``tree``'s structure holding ``new_leaves`` (in ``leaves`` order)."""
    it = iter(new_leaves)
    return map_with_path(lambda _, __: next(it), tree)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *map(leaves, rest))])
