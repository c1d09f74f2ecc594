"""Synthetic multi-modal datasets + oracles + workloads (paper §5.1).

``load_dataset(name)`` -> (Table, InstructionOracle). Row counts, attribute
counts and modality mixes match the paper's Table 3:

    movie   250 rows, 22 attrs — numeric, text, image
    estate  1,041 rows, 4 attrs — image, long text
    game    18,891 rows, 21 attrs — date, numeric, image, text
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.table import Table
from repro_torch.data.oracle import InstructionOracle
from repro_torch.data import estate, game, movie
from repro_torch.data.workloads import WORKLOADS, Query, by_size   # noqa: F401

_GENERATORS = {"movie": movie, "estate": estate, "game": game}
_CACHE = {}


def load_dataset(name: str, seed: int = 0,
                 max_rows: int = 0) -> Tuple[Table, InstructionOracle]:
    key = (name, seed)
    if key not in _CACHE:
        mod = _GENERATORS[name]
        table = mod.generate() if seed == 0 else mod.generate(seed)
        _CACHE[key] = (table, mod.make_oracle())
    table, oracle = _CACHE[key]
    if max_rows and table.n_rows > max_rows:
        table = table.head(max_rows)
    return table, oracle


DATASETS = tuple(_GENERATORS)
