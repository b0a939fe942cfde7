"""The one traffic generator: a closed loop of impurity solves, one caller
waiting for each, every solve at a bath drawn from the seed.

A traffic mix is a JSON file under ``traffic/`` with

    "amplitude": a        each number of the configuration's published
                          bath is scaled by a factor drawn uniformly from
                          [1 - a, 1 + a] (which numbers share a factor is
                          the model's: ``models/<model>.py`` draw_bath)
    "pool": {...}         optional: {"size": k, "seed": s}, a fixed set of
                          k baths drawn from s, which the run's seed only
                          puts in order: for a cell whose solves' work
                          depends on the bath more than a window averages
    "sweep": {...}        EDConfig settings of the sector sweep
                          (``ed_sectors``, ``ed_sectors_shift``) and, for
                          a restricted sweep, "restart": "half_filling",
                          the sectors_list.restart written once in set-up
    "why": "..."

Draws come from numpy's PCG64 seeded with the run's seed (or the pool's),
one bath after another.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def _draws(seed: int, amplitude: float):
    rng = np.random.Generator(np.random.PCG64(int(seed)))

    def draw(shape):
        return rng.uniform(1.0 - amplitude, 1.0 + amplitude, size=shape)
    return draw


def baths(model, config: dict, amplitude: float, seed: int,
          pool: dict = None) -> Iterator[dict]:
    """The bath of every solve, an endless stream.  Without ``pool``
    every solve draws a new bath from ``seed``; with ``pool`` the k baths
    are drawn from the pool's seed and ``seed`` orders them (a new
    permutation each time round)."""
    if pool is None:
        draw = _draws(seed, amplitude)
        while True:
            yield model.draw_bath(config, draw)
    draw = _draws(pool["seed"], amplitude)
    fixed = [model.draw_bath(config, draw) for _ in range(pool["size"])]
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    while True:
        for i in rng.permutation(len(fixed)):
            yield fixed[i]
