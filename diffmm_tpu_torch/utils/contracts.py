"""The sparse graph form's memory contract: nothing of size O(U·I).

The sparse form and the CSR train store exist for catalogs whose (U, I)
matrix does not fit (DESIGN.md §7): a run of that form must hold no array
of U·I elements, on the host or on the card. :func:`assert_no_ui_arrays`
checks it over whatever a run keeps (a Coach: ``vars(coach)``), as the JAX
package's ``tools/bigshard_demo.py`` and ``tests/test_membership.py``
check their pytrees.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

# objects whose attributes are code or interpreter state, not a run's arrays
_OPAQUE = (type, types.ModuleType, types.FunctionType, types.BuiltinFunctionType, types.MethodType,
           torch.Generator, torch.device, torch.dtype)


def _children(obj, where: str):
    """``(path, value)`` of what ``obj`` holds: dict values, list and tuple
    items (a NamedTuple's by field), dataclass fields and a plain object's
    attributes."""
    if isinstance(obj, dict):
        return [(f"{where}[{k!r}]", v) for k, v in obj.items()]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return [(f"{where}.{f}", getattr(obj, f)) for f in obj._fields]
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [(f"{where}[{i}]", v) for i, v in enumerate(obj)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [(f"{where}.{f.name}", getattr(obj, f.name)) for f in dataclasses.fields(obj)]
    if isinstance(obj, _OPAQUE) or not hasattr(obj, "__dict__"):
        return []
    return [(f"{where}.{k}", v) for k, v in vars(obj).items()]


def assert_no_ui_arrays(obj, user_num: int, item_num: int, where: str) -> int:
    """Walk ``obj`` (each object once) and fail on any tensor or numpy array
    of shape ``(user_num, item_num)`` or of ``user_num * item_num`` or more
    elements, naming where it was found (``where`` is the root's name).
    Returns the number of arrays checked."""
    big = user_num * item_num
    seen, todo, checked = set(), [(where, obj)], 0
    while todo:
        path, x = todo.pop()
        if id(x) in seen or x is None or isinstance(x, (str, bytes, int, float, bool)):
            continue
        seen.add(id(x))
        if isinstance(x, (torch.Tensor, np.ndarray)):
            shape = tuple(x.shape)
            n = int(np.prod(shape, dtype=np.int64))
            if shape == (user_num, item_num) or n >= big:
                raise AssertionError(f"{path}: an O(U·I) array, shape {shape} ({n} elements, "
                                     f"U·I = {big})")
            checked += 1
            continue
        todo.extend(_children(x, path))
    return checked
