"""Normalization-function registry.

The reference resolves normalization/denormalization functions by name via
`eval()` into the user's `main` module globals (generate_model.py:68, 77;
model_fn 734, 763) — a circular-import-by-design. Here users register plain
callables `(value, name) -> value` under a name; model descriptions reference
that name. Built-ins `log`/`exp` match the reference's stock helpers
(code/main.py:48-52).
"""

from __future__ import annotations

from typing import Callable, Dict, MutableMapping

import numpy as np

Normalization = Callable[[np.ndarray, str], np.ndarray]

_REGISTRY: Dict[str, Normalization] = {}


def register_normalization(name: str, fn: Normalization) -> None:
    _REGISTRY[name] = fn


def get_normalization(name: str) -> Normalization:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"the normalization function '{name}' is not registered; call "
            f"ignnition_tpu_torch.register_normalization({name!r}, fn) first"
        ) from None


def normalizations() -> MutableMapping[str, Normalization]:
    return _REGISTRY


# built-ins (reference code/main.py:48-52)
register_normalization("log", lambda v, name: np.log(v))
register_normalization("exp", lambda v, name: np.exp(v))
