"""The yardstick's peaks and the operations and bytes of the kernels whose
share of a roofline the benchmark reports.

Peaks are NVIDIA's data-sheet numbers for one H100 SXM at its full 700 W
(dense rates): 989 TFLOP/s in bf16 on the tensor cores, the fastest rate at
which the card runs any product, and 3.35 TB/s of HBM bandwidth.  A card set
below 700 W runs slower; the run prints the card's power limit beside it.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 989e12, "bytes": 3.35e12},
}


def k1_work(a_shape, w_shape):
    """(FLOPs, bytes) of one Gram call M_b = (A_b w_b)(A_b w_b)^T, whatever
    implements it: the lower-triangle SYRK's B m (m + 1) n FLOPs; A read
    once (once per group where grouped, once per lane where per lane), w
    read and the whole f32 M written, 4 bytes an entry.

    ``a_shape`` is A32's shape ([m, n], [B, m, n] per lane, or [G, m, n]
    grouped) and ``w_shape`` w's ([B, n], or [G, L, n] grouped)."""
    m, n = a_shape[-2:]
    lanes = 1
    for d in w_shape[:-1]:
        lanes *= d
    mats = a_shape[0] if len(a_shape) == 3 else 1
    flops = lanes * m * (m + 1) * n
    nbytes = 4 * (mats * m * n + lanes * n + lanes * m * m)
    return flops, nbytes


def k1_bound_s(a_shape, w_shape, kind: str):
    """The least time the card could take for one Gram call: the larger of
    its FLOPs over the bf16 peak and its bytes over the HBM bandwidth.  None
    for a card whose peaks the table lacks."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    flops, nbytes = k1_work(a_shape, w_shape)
    return max(flops / peak["flops"], nbytes / peak["bytes"])
