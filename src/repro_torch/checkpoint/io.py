"""Checkpointing: flatten a tree of arrays to an .npz plus a JSON manifest.

A copy of ``repro.checkpoint.io`` (the port imports nothing of ``repro``)
that writes and reads the same bytes, so a checkpoint written by either
package restores in the other:

  * the layout: ``root/step_%09d/`` holding ``manifest.json`` and
    ``arrays.npz`` with ``leaf_<i>`` keys, and a root-level ``LATEST``;
  * the manifest: ``version``, ``step``, ``ts``, ``treedef``, ``n_leaves``,
    ``dtypes``, ``shapes`` and the caller's optional ``extra``;
  * atomicity: a checkpoint is staged in a ``.tmp_ckpt_*`` directory and
    enters the namespace by one ``os.rename``; discovery counts only
    directories that hold both files, so torn ones are invisible;
  * the ``LATEST`` pointer: advanced monotonically by :func:`save`, moved
    either way by :func:`point_latest`, read pointer first with a scan
    fallback by :func:`read_latest`.

The reference flattens with ``jax.tree.flatten`` and stores ``str(treedef)``,
which :func:`restore` compares verbatim. :func:`tree_flatten` is the port's
own flatten for the node types the system writes (dict, list, tuple,
NamedTuple and None), in JAX's leaf order (dict keys sorted), and
:func:`treedef_str` prints JAX's treedef string for the same tree, e.g.
``PyTreeDef({'scale': *, 'w': *})``; a NamedTuple prints as JAX prints one,
``CustomNode(namedtuple[AdamState], [*, ...])``, so an optimizer state
restores into either package's class of that name. Any other container
type raises ``TypeError``. Leaves are numpy arrays and scalars.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any

import numpy as np

Pytree = Any

__all__ = ["save", "restore", "latest_step", "read_latest", "point_latest",
           "read_manifest", "tree_flatten", "tree_unflatten", "treedef_str",
           "MANIFEST_VERSION"]

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_LATEST = "LATEST"

# Version 1: arrays.npz with leaf_<i> keys + the manifest schema above.
# Pre-versioned checkpoints read as version 0.
MANIFEST_VERSION = 1

_LEAF_TYPES = (np.ndarray, np.generic, int, float, complex)

# ----------------------------------------------------------------- the tree
# A treedef here is a nested tuple: ("leaf",), ("none",), ("dict", keys,
# children), ("list", children), ("tuple", children) or ("namedtuple",
# class, children).


def tree_flatten(tree: Pytree) -> tuple[list, tuple]:
    """``(leaves, treedef)`` in ``jax.tree.flatten``'s order: dict values by
    sorted key, lists and tuples in order, None holds no leaf."""
    leaves: list = []

    def walk(node):
        if node is None:
            return ("none",)
        if type(node) is dict:
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return ("namedtuple", type(node), tuple(walk(c) for c in node))
        if type(node) in (list, tuple):
            return (type(node).__name__, tuple(walk(c) for c in node))
        if isinstance(node, _LEAF_TYPES):
            leaves.append(node)
            return ("leaf",)
        raise TypeError(f"checkpoint trees hold dicts, lists, tuples, NamedTuples, None "
                        f"and arrays; got a node of type {type(node).__name__}")

    return leaves, walk(tree)


def tree_unflatten(treedef: tuple, leaves) -> Pytree:
    """The tree of ``treedef`` with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(td):
        kind = td[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(td[1], td[2])}
        if kind == "namedtuple":
            return td[1](*(build(c) for c in td[2]))
        children = [build(c) for c in td[1]]
        return children if kind == "list" else tuple(children)

    return build(treedef)


def treedef_str(treedef: tuple) -> str:
    """JAX's ``str(treedef)`` for the same tree, e.g. ``PyTreeDef([*, (*,)])``."""

    def fmt(td):
        kind = td[0]
        if kind == "leaf":
            return "*"
        if kind == "none":
            return "None"
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {fmt(c)}" for k, c in zip(td[1], td[2])) + "}"
        if kind == "namedtuple":
            inner = ", ".join(fmt(c) for c in td[2])
            return f"CustomNode(namedtuple[{td[1].__name__}], [{inner}])"
        inner = ", ".join(fmt(c) for c in td[1])
        if kind == "list":
            return f"[{inner}]"
        return f"({inner},)" if len(td[1]) == 1 else f"({inner})"

    return f"PyTreeDef({fmt(treedef)})"


# ------------------------------------------------------------ steps on disk


def _step_dir(root: str, step: int) -> str:
    """Path of the step's directory: ``root/step_%09d`` (sorts numerically)."""
    return os.path.join(root, f"step_{step:09d}")


def _is_complete(root: str, step: int) -> bool:
    """True when the step directory holds both manifest and arrays, the gate
    every discovery path applies."""
    path = _step_dir(root, step)
    return (os.path.isfile(os.path.join(path, _MANIFEST))
            and os.path.isfile(os.path.join(path, _ARRAYS)))


def save(root: str, step: int, tree: Pytree, keep: int = 3,
         extra: dict | None = None, point: bool = True) -> str:
    """Write ``tree`` under root/step_XXXXXXXXX atomically; rotate old steps.

    The arrays and manifest are staged in a dot-prefixed temp dir and
    published by one ``os.rename``. Then the ``LATEST`` pointer advances,
    monotonically: saving an older step never moves it back (use
    :func:`point_latest` to roll back). ``point=False`` leaves the pointer
    alone. ``keep`` > 0 retains the newest ``keep`` steps; ``keep=0`` all.
    ``extra`` (JSON-serializable) is stored verbatim under the manifest's
    ``"extra"``. Returns the published step directory.
    """
    os.makedirs(root, exist_ok=True)
    leaves, treedef = tree_flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    manifest = {
        "version": MANIFEST_VERSION,
        "step": step,
        "ts": time.time(),  # wall-clock write time
        "treedef": treedef_str(treedef),
        "n_leaves": len(leaves),
        "dtypes": [str(a.dtype) for a in arrays.values()],
        "shapes": [list(a.shape) for a in arrays.values()],
    }
    if extra is not None:
        manifest["extra"] = extra
    tmp = tempfile.mkdtemp(dir=root, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, _ARRAYS), **arrays)
        with open(os.path.join(tmp, _MANIFEST), "w") as fh:
            json.dump(manifest, fh)
        final = _step_dir(root, step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if point:
        current = _read_pointer(root)
        if current is None or step >= current:
            _write_pointer(root, step)
    _rotate(root, keep)
    return final


def _rotate(root: str, keep: int) -> None:
    """Delete all but the newest ``keep`` steps; ``keep <= 0`` keeps all."""
    steps = sorted(_list_steps(root))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)


def _list_steps(root: str) -> list[int]:
    """Step numbers of every complete checkpoint under ``root``."""
    out = []
    if not os.path.isdir(root):
        return out
    for name in os.listdir(root):
        if name.startswith("step_"):
            try:
                step = int(name[5:])
            except ValueError:
                continue
            if _is_complete(root, step):
                out.append(step)
    return out


def latest_step(root: str) -> int | None:
    """Highest complete step under ``root`` by directory scan (blind to the
    pointer); None when the root is empty or missing."""
    steps = _list_steps(root)
    return max(steps) if steps else None


# --------------------------------------------------------- the LATEST pointer


def _read_pointer(root: str) -> int | None:
    try:
        with open(os.path.join(root, _LATEST)) as fh:
            return int(fh.read().strip())
    except (OSError, ValueError):
        return None


def _write_pointer(root: str, step: int) -> None:
    # write-then-replace, and a bare integer payload: a reader never sees half
    fd, tmp = tempfile.mkstemp(dir=root, prefix=".tmp_latest_")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(f"{step}\n")
        os.replace(tmp, os.path.join(root, _LATEST))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_latest(root: str) -> int | None:
    """The step ``LATEST`` designates, or None. Pointer first (an older step
    after a rollback wins); a missing, corrupt or dangling pointer falls
    back to the :func:`latest_step` scan."""
    step = _read_pointer(root)
    if step is not None and _is_complete(root, step):
        return step
    return latest_step(root)


def point_latest(root: str, step: int) -> None:
    """Move ``LATEST`` to ``step`` in either direction (atomic). Raises
    ``FileNotFoundError`` unless ``step`` is a complete checkpoint."""
    if not _is_complete(root, step):
        raise FileNotFoundError(
            f"cannot point LATEST at step {step}: no complete checkpoint at "
            f"{_step_dir(root, step)}")
    _write_pointer(root, step)


def _resolve_step(root: str, step: int | None) -> int:
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    return step


def read_manifest(root: str, step: int | None = None) -> dict:
    """The checkpoint's manifest dict, without loading any arrays."""
    step = _resolve_step(root, step)
    with open(os.path.join(_step_dir(root, step), _MANIFEST)) as fh:
        manifest = json.load(fh)
    manifest.setdefault("version", 0)  # pre-versioned checkpoints
    return manifest


def restore(root: str, like: Pytree, step: int | None = None) -> Pytree:
    """Restore arrays (numpy) into the structure of ``like``.

    Structure, shape and dtype are validated before anything is rebuilt,
    each with the reference's ``ValueError`` naming both sides. Dtypes
    round-trip exactly, so int8 exports restore as int8.
    """
    step = _resolve_step(root, step)
    path = _step_dir(root, step)
    manifest = read_manifest(root, step)
    with np.load(os.path.join(path, _ARRAYS)) as z:
        arrays = [z[f"leaf_{i}"] for i in range(len(z.files))]
    leaves, treedef = tree_flatten(like)
    want_treedef = treedef_str(treedef)
    saved_treedef = manifest.get("treedef")
    if manifest.get("n_leaves", len(arrays)) != len(arrays):
        raise ValueError(
            f"checkpoint at {path} is corrupt: manifest records "
            f"{manifest['n_leaves']} leaves but {_ARRAYS} holds {len(arrays)}")
    if len(leaves) != len(arrays):
        raise ValueError(
            f"checkpoint structure mismatch: saved {len(arrays)} leaves "
            f"(treedef {saved_treedef}), caller expects {len(leaves)} "
            f"(treedef {want_treedef})")
    if saved_treedef is not None and saved_treedef != want_treedef:
        raise ValueError(
            "checkpoint structure mismatch: saved treedef\n  "
            f"{saved_treedef}\ndoes not match the caller's ``like`` treedef\n  "
            f"{want_treedef}")
    for i, (a, l) in enumerate(zip(arrays, leaves)):
        if tuple(a.shape) != tuple(np.shape(l)):
            raise ValueError(f"leaf {i}: checkpoint shape {a.shape} != expected {np.shape(l)}")
        want_dtype = getattr(l, "dtype", None)
        if want_dtype is not None and a.dtype != want_dtype:
            raise ValueError(
                f"leaf {i}: checkpoint dtype {a.dtype} != expected {want_dtype} "
                "(quantized exports must be restored into a matching-dtype tree)")
    return tree_unflatten(treedef, arrays)
