"""Synthetic Game dataset — regeneration of the paper's Steam benchmark
(Table 3: 18,891 records, 21 attributes; dates, numbers, images, text).

The `rating` column is a PEGI badge image handle (blob carries the age
rating); `discounted_price` is in IDR ("Rp 250000") as in the source data;
`metacriticts` keeps the source dataset's misspelling, as does the paper.
"""
from __future__ import annotations

import random

from repro_torch.core.table import Table
from repro_torch.data.oracle import InstructionOracle

N_ROWS = 18891

GENRES = ("shooting", "sports", "strategy", "puzzle", "racing",
          "role-playing", "simulation", "horror")
PUBS = ("Valve", "Ubisoft", "Devolver", "Annapurna", "Paradox", "SEGA",
        "Team17", "Raw Fury")
LANGS = ("English", "Chinese", "Japanese", "German", "French", "Spanish",
         "Portuguese", "Russian")
PLATFORM_SETS = ("Windows", "Windows, MacOS", "Windows, Linux",
                 "Windows, MacOS, Linux")


def generate(seed: int = 13) -> Table:
    rng = random.Random(seed)
    names1 = ("Neon", "Iron", "Star", "Pixel", "Turbo", "Shadow", "Hyper",
              "Lost", "Mega", "Quantum")
    names2 = ("Raiders", "League", "Tactics", "Drift", "Quest", "Arena",
              "Siege", "Farm", "Protocol", "Odyssey")
    cols = {c: [] for c in (
        "title", "rating", "release_date", "developer", "publisher",
        "platforms", "language", "original_price", "discounted_price",
        "discount_pct", "overall_reviews", "n_reviews", "metacriticts",
        "description", "tags", "achievements", "dlc_count", "vr_support",
        "min_ram_gb", "size_gb", "website")}
    blobs = {}
    for i in range(N_ROWS):
        genre = rng.choice(GENRES)
        pegi = rng.choices((3, 7, 12, 16, 18), weights=(25, 20, 25, 18, 12))[0]
        title = f"{rng.choice(names1)} {rng.choice(names2)} {i % 97}"
        meta = rng.randint(31, 97)
        vr = rng.random() < 0.13
        platforms = rng.choice(PLATFORM_SETS) + (", VR supported" if vr
                                                 else "")
        n_langs = rng.randint(1, 5)
        langs = ", ".join(rng.sample(LANGS, n_langs))
        price_idr = rng.randint(20, 900) * 1000
        disc = rng.choice((0, 10, 25, 33, 50, 75))
        n_dev = rng.choices((1, 2, 3), weights=(70, 20, 10))[0]
        devs = ", ".join(f"{rng.choice(names1)} Studio{d}"
                         for d in range(n_dev))
        badge = f"pegi://game/{i}"
        blobs[badge] = {"kind": "image", "pegi": pegi,
                        "badge_color": "red" if pegi == 18 else "green"}

        cols["title"].append(title)
        cols["rating"].append(badge)
        cols["release_date"].append(
            f"{rng.randint(2008, 2024)}-{rng.randint(1, 12):02d}-"
            f"{rng.randint(1, 28):02d}")
        cols["developer"].append(devs)
        cols["publisher"].append(rng.choice(PUBS))
        cols["platforms"].append(platforms)
        cols["language"].append(langs)
        cols["original_price"].append(f"Rp {price_idr:,}")
        cols["discounted_price"].append(
            f"Rp {int(price_idr * (100 - disc) / 100):,}")
        cols["discount_pct"].append(str(disc))
        pos = rng.random() < (0.35 + meta / 200.0)
        cols["overall_reviews"].append(
            ("Mostly Positive" if pos else "Mixed")
            + f" ({rng.randint(40, 90)}% of {rng.randint(100, 90000):,} "
              f"reviews)")
        cols["n_reviews"].append(str(rng.randint(100, 90000)))
        cols["metacriticts"].append(str(meta))
        cols["description"].append(
            f"A fast-paced {genre} game where you "
            f"{rng.choice(('build', 'conquer', 'explore', 'survive'))} "
            f"across {rng.randint(3, 40)} handcrafted levels.")
        cols["tags"].append(f"{genre}, indie, co-op")
        cols["achievements"].append(str(rng.randint(0, 120)))
        cols["dlc_count"].append(str(rng.randint(0, 14)))
        cols["vr_support"].append("yes" if vr else "no")
        cols["min_ram_gb"].append(str(rng.choice((4, 8, 16))))
        cols["size_gb"].append(f"{rng.uniform(0.4, 120):.1f}")
        cols["website"].append(f"https://games.example/{i}")

    mods = {c: "text" for c in cols}
    mods.update(rating="image", metacriticts="numeric", n_reviews="numeric",
                discount_pct="numeric", release_date="date")
    return Table(cols, mods, blobs, name="game")


def make_oracle() -> InstructionOracle:
    o = InstructionOracle("game")

    @o.filter(r"PEGI.*only suitable for adults|only suitable for adults")
    def _adult(value, m):
        return isinstance(value, dict) and value.get("pegi") == 18

    @o.map(r"binary review|binary label")
    def _binary(value, m):
        return "positive" if "Positive" in str(value) else "negative"

    @o.filter(r"support VR|video game support VR")
    def _vr(value, m):
        return "vr" in str(value).lower()

    @o.map(r"extract the genre")
    def _genre(value, m):
        s = str(value).lower()
        for g in GENRES:
            if g in s:
                return g
        return "unknown"

    @o.filter(r"is about (\w[\w\- ]*)|video game is about (\w[\w\- ]*)")
    def _about(value, m):
        g = (m.group(1) or m.group(2)).strip().rstrip(".?").lower()
        return g in str(value).lower()

    @o.filter(r"is a (\w[\w\- ]*?) game")
    def _is_genre(value, m):
        return m.group(1).strip().lower() in str(value).lower()

    @o.filter(r"MacOS in the list|support MacOS")
    def _mac(value, m):
        return "macos" in str(value).lower()

    @o.filter(r"(Chinese|English|Japanese|German|French) one of the "
              r"supported languages")
    def _lang(value, m):
        return m.group(1).lower() in str(value).lower()

    @o.filter(r"support(?:s)? both Windows and MacOS")
    def _winmac(value, m):
        s = str(value).lower()
        return "windows" in s and "macos" in s

    @o.filter(r"only (?:has |have )?one developer")
    def _one_dev(value, m):
        return "," not in str(value)

    @o.filter(r"receive[sd]? a positive review|positive review|"
              r"review is positive")
    def _positive(value, m):
        return "positive" in str(value).lower()

    @o.map(r"convert the price in IDR into .*USD")
    def _fx(value, m):
        from repro_torch.core.udf import parse_money
        v = parse_money(value)
        return round(v * 6.5e-5, 2) if v is not None else None

    @o.reduce(r"publisher that appears the most")
    def _mode(values, m):
        import statistics
        return statistics.mode([str(v) for v in values]) if values else None

    return o
