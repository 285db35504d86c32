"""At-scale computing-for-sustainability model (paper §6.4, Table 5): the
reference's `core/scale.py`, copied so the port needs nothing of it.

US beef: 26.19 B lbs consumed/yr [103], 31% wasted [11],
14.5 kg CO2e per kg beef [79], typical car 4.6 t CO2e/yr [110].
"""
from __future__ import annotations

from typing import Dict

BEEF_LBS_PER_YEAR = 26.19e9
KG_PER_LB = 1 / 2.20462
BEEF_KG_PER_YEAR = BEEF_LBS_PER_YEAR * KG_PER_LB       # ~11.88e9 slabs (1kg)
WASTE_FRACTION = 0.31
CO2_PER_KG_BEEF = 14.5
CAR_KG_PER_YEAR = 4_600.0

SYSTEM_FOOTPRINTS_KG = {
    "flexible": 0.01086,
    "hybrid": 0.12829,
    "silicon": 2.66,
}


def savings_kg(device_kg: float, effectiveness: float) -> float:
    """Net annual kg CO2e saved when every 1-kg slab carries a device.

    effectiveness = fraction of to-be-wasted slabs actually saved.
    """
    saved = effectiveness * WASTE_FRACTION * BEEF_KG_PER_YEAR \
        * CO2_PER_KG_BEEF
    spent = BEEF_KG_PER_YEAR * device_kg
    return saved - spent


def savings_cars(device_kg: float, effectiveness: float) -> float:
    return savings_kg(device_kg, effectiveness) / CAR_KG_PER_YEAR


def breakeven_effectiveness(device_kg: float) -> float:
    """Fraction of wasted slabs that must be saved to break even
    (paper: flexible ~1/417, hybrid ~1/35, silicon ~1/2)."""
    return device_kg / (WASTE_FRACTION * CO2_PER_KG_BEEF)


def table5() -> Dict[str, Dict]:
    out = {}
    for name, fp in SYSTEM_FOOTPRINTS_KG.items():
        out[name] = {
            "device_kg": fp,
            "savings_kg": {e: savings_kg(fp, e)
                           for e in (1.0, 0.1, 0.01, 0.001)},
            "savings_cars": {e: savings_cars(fp, e)
                             for e in (1.0, 0.1, 0.01, 0.001)},
            "breakeven": breakeven_effectiveness(fp),
        }
    return out
