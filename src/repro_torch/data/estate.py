"""Synthetic Estate dataset — regeneration of the paper's multimodal real-
estate benchmark (Table 3: 1,041 records, 4 attributes; images + long text).

Columns: image (handle; blob holds yard/pool visual facts), Title
("{n} bedroom {type} for sale"), Location (Lagos areas), Details (long
marketing text embedding amenities and a price in one of several Nigerian
formats — including the messy "430 Million Naira" / "N250m" styles from the
paper's Figure 12 that stress the UDF price parser).
"""
from __future__ import annotations

import random

from repro_torch.core.table import Table
from repro_torch.data.oracle import InstructionOracle

N_ROWS = 1041

LOCATIONS = ("Lekki Phase 1, Lekki, Lagos", "Ajah, Lagos", "Surulere, Lagos",
             "Ikoyi, Lagos", "Victoria Island, Lagos", "Yaba, Lagos",
             "Ikeja GRA, Lagos", "Banana Island, Lagos")
TYPES = ("detached duplex", "semi-detached duplex", "terrace duplex",
         "block of flats", "bungalow", "penthouse apartment")
AMENITIES = ("swimming pool", "gym", "BQ", "CCTV", "fitted kitchen",
             "24hrs electricity", "parking space", "elevator",
             "children playground", "rooftop terrace")


def _price_text(rng: random.Random, price_naira: float) -> str:
    mode = rng.random()
    m = price_naira / 1e6
    if mode < 0.35:
        return f"PRICE: {m:.0f} Million Naira"
    if mode < 0.65:
        return f"PRICE: N{m:.0f}m"
    if mode < 0.85:
        return f"PRICE: ₦{price_naira:,.0f}"
    return f"Asking {m:.0f}M (negotiable)"


def generate(seed: int = 11) -> Table:
    rng = random.Random(seed)
    cols = {"image": [], "Title": [], "Location": [], "Details": []}
    blobs = {}
    for i in range(N_ROWS):
        beds = rng.randint(1, 7)
        typ = rng.choice(TYPES)
        loc = rng.choice(LOCATIONS)
        n_amen = rng.randint(0, 4)
        amen = rng.sample(AMENITIES, n_amen)
        has_yard = rng.random() < 0.42
        price = rng.uniform(40, 950) * 1e6
        handle = f"photo://estate/{i}"
        blobs[handle] = {"kind": "image", "yard": has_yard,
                         "pool_visible": "swimming pool" in amen,
                         "facade": rng.choice(("white", "grey", "brick"))}
        details = (
            f"NEWLY BUILT {'FULLY DETACHED ' if 'detached' in typ else ''}"
            f"{typ.upper()}"
            + (f" WITH {' AND '.join(a.upper() for a in amen)}" if amen
               else "")
            + f". All rooms ensuite. Title: Governor's consent. "
            + _price_text(rng, price))
        cols["image"].append(handle)
        cols["Title"].append(f"{beds} bedroom {typ} for sale")
        cols["Location"].append(loc)
        cols["Details"].append(details)
    mods = {"image": "image", "Title": "text", "Location": "text",
            "Details": "text"}
    return Table(cols, mods, blobs, name="estate")


def make_oracle() -> InstructionOracle:
    o = InstructionOracle("estate")

    @o.filter(r"(house|estate) (picture|photo|image).*yard|yard.*(picture|"
              r"photo|image)|whether the house has a yard")
    def _yard(value, m):
        return isinstance(value, dict) and bool(value.get("yard"))

    @o.map(r"extract the house price|extract the price")
    def _price(value, m):
        from repro_torch.core.udf import parse_money
        return parse_money(value)

    @o.filter(r"located in ([\w\s,\.\-']+)")
    def _loc(value, m):
        return m.group(1).strip().rstrip(".?").lower() in str(value).lower()

    @o.filter(r"more than (\d+) bedrooms?")
    def _beds_gt(value, m):
        import re as _re
        mm = _re.match(r"\s*(\d+)\s+bedroom", str(value))
        return bool(mm) and int(mm.group(1)) > int(m.group(1))

    @o.filter(r"less than (\d+) bedrooms?")
    def _beds_lt(value, m):
        import re as _re
        mm = _re.match(r"\s*(\d+)\s+bedroom", str(value))
        return bool(mm) and int(mm.group(1)) < int(m.group(1))

    @o.filter(r"has (\d+) or (\d+) bedrooms?")
    def _beds_in(value, m):
        import re as _re
        mm = _re.match(r"\s*(\d+)\s+bedroom", str(value))
        return bool(mm) and int(mm.group(1)) in (int(m.group(1)),
                                                 int(m.group(2)))

    @o.filter(r"is a detached duplex|estate is a detached")
    def _detached(value, m):
        s = str(value).lower()
        return "detached" in s and "semi-detached" not in s

    @o.map(r"extract (the )?amenities")
    def _amen(value, m):
        found = [a for a in AMENITIES if a.upper() in str(value)]
        return ", ".join(found) if found else "No amenities mentioned."

    @o.map(r"extract (the )?features")
    def _features(value, m):
        feats = []
        s = str(value)
        if "ensuite" in s.lower():
            feats.append("all rooms ensuite")
        if "Governor's consent" in s:
            feats.append("governor's consent title")
        found = [a for a in AMENITIES if a.upper() in s]
        feats.extend(found)
        return ", ".join(feats) if feats else "none"

    @o.filter(r"swimming pool")
    def _pool(value, m):
        if isinstance(value, dict):
            return bool(value.get("pool_visible"))
        return "swimming pool" in str(value).lower()

    @o.filter(r"\bgym\b")
    def _gym(value, m):
        return "gym" in str(value).lower()

    return o
