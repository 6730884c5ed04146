"""Where the port's tensors live: the CUDA card unless the caller asks for the CPU.

Every public entry point that takes ``device=`` resolves it here.  ``None``
means ``cuda``; a CUDA device with no card raises instead of falling back,
so a run that asked for the card never runs on the CPU without saying so.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a torch.device; None means ``cuda``.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false.  Never falls back.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device: the port runs on the card by default and "
            f"{dev} is not available here; pass device=\"cpu\" "
            f"(--device cpu on the command line) to run on the CPU"
        )
    return dev
