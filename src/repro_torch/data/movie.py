"""Synthetic Movie dataset — schema-faithful regeneration of the paper's
OMDB-sourced benchmark (Table 3: 250 records, 22 attributes; numerical,
textual, and image modalities) with seeded, recoverable ground truth.

Posters are image handles whose blobs carry the hidden visual facts (style,
cast) — the paper's running example extracts cast from posters. Plot text
embeds the genre vocabulary the genre-extraction map must recover. A slice
of rows is deliberately ill-formatted (awards written as prose, box office
with currency words) to preserve the paper's UDF failure mode (Fig. 12b).
"""
from __future__ import annotations

import random

from repro_torch.core import plan as plan_ir
from repro_torch.core.table import Table
from repro_torch.data.oracle import InstructionOracle

N_ROWS = 250

GENRES = {
    "crime": ("heist", "mob", "detective hunting a syndicate"),
    "drama": ("family saga", "courtroom confession", "quiet grief"),
    "sci-fi": ("starship", "time dilation", "android uprising"),
    "comedy": ("mistaken identity", "roadtrip gone wrong", "wedding chaos"),
    "thriller": ("conspiracy", "cat-and-mouse chase", "double agent"),
    "romance": ("long-distance letters", "second-chance love", "meet-cute"),
}
DIRECTORS = ("Christopher Nolan", "Quentin Tarantino", "Steven Spielberg",
             "Greta Gerwig", "Denis Villeneuve", "Ava DuVernay",
             "Bong Joon-ho", "Sofia Coppola")
ACTORS = ("Matt Damon", "Viola Davis", "Ken Watanabe", "Tilda Swinton",
          "Idris Elba", "Saoirse Ronan", "Oscar Isaac", "Lupita Nyong'o")
FIRST = ("Iron", "Silent", "Broken", "Golden", "Last", "Hidden", "Crimson",
         "Electric", "Paper", "Midnight")
SECOND = ("Harbor", "Protocol", "Garden", "Covenant", "Mile", "Signal",
          "Orchard", "Empire", "Letters", "Divide")


def generate(seed: int = 7) -> Table:
    rng = random.Random(seed)
    cols = {c: [] for c in (
        "Title", "Year", "Rated", "Released", "Runtime", "Director",
        "Writer", "Actors", "Plot", "Language", "Country", "Awards",
        "Poster", "Metascore", "IMDB_rating", "imdbVotes", "imdbID", "Type",
        "DVD", "BoxOffice", "Production", "Website")}
    blobs = {}
    for i in range(N_ROWS):
        genre = rng.choice(list(GENRES))
        motif = rng.choice(GENRES[genre])
        title = f"{rng.choice(FIRST)} {rng.choice(SECOND)} {i}"
        director = rng.choice(DIRECTORS)
        lead = rng.choice(ACTORS)
        support = rng.choice([a for a in ACTORS if a != lead])
        rating = round(rng.uniform(5.0, 9.6), 1)
        oscars = rng.choices((0, 1, 2, 3, 4), weights=(60, 15, 12, 8, 5))[0]
        runtime = rng.randint(84, 192)
        box_m = round(rng.uniform(1.0, 820.0), 1)
        year = rng.randint(1972, 2024)
        style = rng.choices(("dark", "vivid", "minimalist", "retro"),
                            weights=(30, 35, 20, 15))[0]

        poster = f"poster://movie/{i}"
        blobs[poster] = {"kind": "image", "style": style,
                         "cast": [lead, support],
                         "palette": "low-key lighting, heavy shadows"
                         if style == "dark" else "bright key light"}

        cols["Title"].append(title)
        cols["Year"].append(str(year))
        cols["Rated"].append(rng.choice(("PG", "PG-13", "R")))
        cols["Released"].append(f"{rng.randint(1, 28):02d} Jun {year}")
        cols["Runtime"].append(f"{runtime} min")
        cols["Director"].append(director)
        cols["Writer"].append(rng.choice(DIRECTORS))
        cols["Actors"].append(f"{lead}, {support}")
        cols["Plot"].append(
            f"A {genre} story about a {motif}: {lead} leads as the "
            f"protagonist whose choices unravel everything.")
        cols["Language"].append(rng.choice(("English", "French", "Korean")))
        cols["Country"].append(rng.choice(("USA", "UK", "South Korea")))
        # ~12% prose-style award strings defeat the split('Oscar') UDF
        if oscars and rng.random() < 0.12:
            cols["Awards"].append(
                f"Winner of {oscars} Academy Awards (Oscars) plus "
                f"{rng.randint(1, 9)} nominations")
        elif oscars:
            cols["Awards"].append(
                f"Won {oscars} Oscars. {rng.randint(0, 30)} wins & "
                f"{rng.randint(0, 40)} nominations total")
        else:
            cols["Awards"].append(f"{rng.randint(0, 12)} wins & "
                                  f"{rng.randint(0, 22)} nominations.")
        cols["Poster"].append(poster)
        cols["Metascore"].append(str(rng.randint(28, 99)))
        cols["IMDB_rating"].append(f"{rating}")
        cols["imdbVotes"].append(f"{rng.randint(4, 2400) * 1000:,}")
        cols["imdbID"].append(f"tt{seed:02d}{i:05d}")
        cols["Type"].append("movie")
        cols["DVD"].append(f"{rng.randint(1, 28):02d} Nov {year + 1}")
        if rng.random() < 0.1:
            cols["BoxOffice"].append(f"{box_m} million dollars")
        else:
            cols["BoxOffice"].append(f"${box_m:,}M")
        cols["Production"].append(rng.choice(
            ("Aurora Films", "Northlight", "Meridian Pictures")))
        cols["Website"].append(f"https://films.example/{i}")

    mods = {c: "text" for c in cols}
    mods.update(IMDB_rating="numeric", Metascore="numeric", Year="numeric",
                Poster="image")
    return Table(cols, mods, blobs, name="movie")


# ---------------------------------------------------------------------------
# Oracle
# ---------------------------------------------------------------------------

def make_oracle() -> InstructionOracle:
    o = InstructionOracle("movie")

    @o.map(r"extract the genre")
    def _genre(value, m):
        txt = str(value).lower()
        for g in GENRES:
            if f"a {g} story" in txt:
                return g
        return "unknown"

    @o.map(r"extract the (main character|cast)")
    def _cast(value, m):
        if isinstance(value, dict):                 # poster blob
            return ", ".join(value.get("cast", []))
        mm = [a for a in ACTORS if a in str(value)]
        return mm[0] if mm else "unknown"

    @o.filter(r"poster .*dark style|dark style.*poster|poster image is in "
              r"the dark")
    def _dark(value, m):
        return isinstance(value, dict) and value.get("style") == "dark"

    @o.filter(r"directed by ([\w\s\.\-']+)")
    def _director(value, m):
        return m.group(1).strip().rstrip(".?").lower() in str(value).lower()

    @o.filter(r"(stars|star in|casts?)\b")
    def _stars(value, m):
        if isinstance(value, dict):
            return any(a in value.get("cast", []) for a in ACTORS)
        return False

    @o.filter(r"belongs to (\w[\w\- ]*?) movies|is a (\w[\w\- ]*?) movie")
    def _genre_filter(value, m):
        g = (m.group(1) or m.group(2)).strip().lower()
        return g in str(value).lower()

    @o.filter(r"won (?:more than )?(\d+) Oscars?")
    def _oscars(value, m):
        import re as _re
        n = int(m.group(1))
        mm = _re.search(r"(\d+)\s+(?:Academy Awards|Oscars?)", str(value))
        won = int(mm.group(1)) if mm else 0
        if _re.search(r"more than", m.string, _re.I):
            return won > n
        return won == n

    @o.map(r"extract the total box office|extract the box office")
    def _box(value, m):
        from repro_torch.core.udf import parse_money
        return parse_money(value)

    @o.reduce(r"summari[sz]e|common characteristics")
    def _summarize(values, m):
        themes = sorted({g for v in values for g in GENRES
                         if f"a {g} story" in str(v).lower()})
        leads = sorted({a for v in values for a in ACTORS if a in str(v)})
        return (f"Common characteristics: {', '.join(themes) or 'varied'} "
                f"stories led by {', '.join(leads[:3]) or 'ensemble casts'}.")

    return o
