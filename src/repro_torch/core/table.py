"""Multi-modal table abstraction (paper §2.1).

A :class:`Table` is a dict of named columns with per-column *modality* tags
(numeric | text | image | audio | date). Unstructured fields are stored as
text handles (file paths / URIs) exactly as the paper describes — Nirvana
"represents unstructured fields as text that store file paths pointing to
remote locations". Synthetic datasets (``repro_torch.data``) attach the content
behind a handle via the ``blobs`` side store so semantic operators can
resolve it without a network.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List, Optional, Sequence

MODALITIES = ("numeric", "text", "image", "audio", "date")


@dataclasses.dataclass
class Table:
    columns: Dict[str, List[Any]]
    modalities: Dict[str, str] = dataclasses.field(default_factory=dict)
    # handle -> content for unstructured fields (posters, estate photos, ...)
    blobs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    name: str = ""

    def __post_init__(self):
        lens = {len(v) for v in self.columns.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged table: column lengths {lens}")
        for c in self.columns:
            self.modalities.setdefault(c, "text")

    # ------------------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    @property
    def column_names(self) -> tuple:
        return tuple(self.columns)

    def column(self, name: str) -> List[Any]:
        return self.columns[name]

    def resolve(self, name: str) -> List[Any]:
        """Column values with blob handles dereferenced (multi-modal read)."""
        vals = self.columns[name]
        if self.modalities.get(name) in ("image", "audio"):
            return [self.blobs.get(v, v) for v in vals]
        return vals

    def row(self, i: int) -> dict:
        return {c: v[i] for c, v in self.columns.items()}

    # ------------------------------------------------------------------
    def select(self, mask: Sequence[bool]) -> "Table":
        idx = [i for i, m in enumerate(mask) if m]
        return self.take(idx)

    def take(self, idx: Sequence[int]) -> "Table":
        cols = {c: [v[i] for i in idx] for c, v in self.columns.items()}
        return Table(cols, dict(self.modalities), self.blobs, self.name)

    def with_column(self, name: str, values: List[Any],
                    modality: str = "text") -> "Table":
        if len(values) != self.n_rows:
            raise ValueError(
                f"column {name}: {len(values)} values vs {self.n_rows} rows")
        cols = dict(self.columns)
        cols[name] = list(values)
        mods = dict(self.modalities)
        mods[name] = modality
        return Table(cols, mods, self.blobs, self.name)

    def head(self, n: int) -> "Table":
        return self.take(range(min(n, self.n_rows)))

    @staticmethod
    def concat(parts: Sequence["Table"]) -> "Table":
        """Row-wise concatenation of like-schema tables (morsel merge).

        All parts must share column names; modalities/blobs/name are taken
        from the first part."""
        if not parts:
            raise ValueError("concat of zero tables")
        first = parts[0]
        cols = {c: [v for p in parts for v in p.columns[c]]
                for c in first.columns}
        return Table(cols, dict(first.modalities), first.blobs, first.name)

    def sample(self, n: int, seed: int = 0) -> "Table":
        """Deterministic row sample (optimizers validate on samples)."""
        if n >= self.n_rows:
            return self
        rng = random.Random(seed)
        idx = sorted(rng.sample(range(self.n_rows), n))
        return self.take(idx)

    def __repr__(self):
        return (f"Table({self.name!r}, rows={self.n_rows}, "
                f"cols={list(self.columns)})")
