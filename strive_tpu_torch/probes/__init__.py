"""The port's counterpart of the TPU probes under ``scripts/``.

``onehot_crop`` answers ``scripts/probe_onehot_crop.py`` and
``probe_onehot_crop2.py`` (a crop gathered tile by tile from a staged raster
window), ``gather`` answers ``scripts/pallas_gather_probe.py``, ``2`` and
``3`` (per-agent windows cut out of the raster, then gathered from). Their
kernels (K3, K4a, K4b) are in ``window_kernels`` and ``csrc/window.cu``.
``mosaic_bisect`` answers ``scripts/probe_mosaic_bisect.py``, ``2`` and
``3`` (19 minimal kernels that bisected a Mosaic toolchain); their kernels
(K5a-K5d) are in ``bisect_kernels`` and ``csrc/bisect.cu``.
"""

from __future__ import annotations


def gelem_s(n, ms):
    """Elements per second, in G, for ``n`` elements in ``ms``."""
    return n / (ms * 1e-3) / 1e9
