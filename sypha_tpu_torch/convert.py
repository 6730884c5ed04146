"""Carry state between the JAX package and the port, through numpy.

``to_numpy`` turns a PaddedLp, SharedLpBatch or IpmState of either package
into a dict of numpy arrays, one per field (for a JAX object,
``{f: np.asarray(getattr(obj, f)) ...}`` gives the same dict).
``from_numpy`` builds the port's dataclass from such a dict on a given
device, keeping every dtype (f64 stays f64, int32 stays int32).  The round
trip is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Type, TypeVar

import numpy as np
import torch

T = TypeVar("T")


def to_numpy(obj) -> Dict[str, np.ndarray]:
    """Fields of a dataclass (the port's or the JAX package's) as numpy arrays."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def from_numpy(cls: Type[T], arrays: Dict[str, np.ndarray], device="cpu") -> T:
    """Build the port's dataclass ``cls`` from numpy arrays on ``device``."""
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"{cls.__name__} needs fields {sorted(missing)}")
    return cls(**{
        n: torch.from_numpy(np.array(arrays[n], copy=True)).to(device) for n in names
    })
