"""The one generator of traffic: an ensemble of walkers around a point.

A traffic file (``traffic/<name>.json``) gives the mix's parameters:

* ``walkers``: the ensemble's size (even: two halves a step);
* ``spread``: the Gaussian spread of every coordinate around the
  configuration's starting point (``walkers_around``, ``chip_smoke.py:592``
  at commit ebfe9da, here drawn on the device);
* ``stretch_a``: the stretch move's scale;
* ``warmup_steps``: ensemble steps run in set-up, before the window.

The sampler is a closed loop: each step waits for the last, and a step is
the whole ensemble's work.  Every seed draws the same sizes; only the
values differ.
"""

from __future__ import annotations

import numpy as np
import torch

STREAMS = {"walkers": 1, "sampler": 2, "tables": 3}


def stream_seed(seed, stream):
    """A 63-bit seed for one of the run's random streams: any whole
    ``seed`` gives every stream a seed of its own."""
    state = np.random.SeedSequence(
        [int(seed) % 2 ** 64, STREAMS[stream]]).generate_state(2, np.uint64)
    return int((int(state[0]) << 32 ^ int(state[1])) % 2 ** 63)


def generator(seed, stream, device):
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def walkers_around(center, traffic, seed, device):
    """(walkers, n_dim) float32 walkers: ``center`` plus ``spread`` times
    standard normals, drawn in float64 on ``device`` in one call."""
    center = torch.as_tensor(np.asarray(center, dtype=np.float64),
                             device=device)
    noise = torch.randn((int(traffic["walkers"]), center.shape[0]),
                        generator=generator(seed, "walkers", device),
                        dtype=torch.float64, device=device)
    return (center + float(traffic["spread"]) * noise).float()
