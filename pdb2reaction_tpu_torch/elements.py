"""Element data: symbols, atomic numbers, masses, covalent radii.

Covalent radii are the Pyykko & Atsumi (2009) single-bond radii (the table
used by pysisyphus ``elem_data.COVALENT_RADII``).
Stored here in Angstrom; helpers return Bohr where the optimizer stack needs it.

Masses are IUPAC standard atomic weights (amu).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .constants import ANG2BOHR

# Z: (symbol, mass_amu, covalent_radius_ang)
_ELEMENTS = {
    1: ("H", 1.00794, 0.32), 2: ("He", 4.002602, 0.46),
    3: ("Li", 6.941, 1.33), 4: ("Be", 9.012182, 1.02),
    5: ("B", 10.811, 0.85), 6: ("C", 12.0107, 0.75),
    7: ("N", 14.0067, 0.71), 8: ("O", 15.9994, 0.63),
    9: ("F", 18.9984032, 0.64), 10: ("Ne", 20.1797, 0.67),
    11: ("Na", 22.98976928, 1.55), 12: ("Mg", 24.3050, 1.39),
    13: ("Al", 26.9815386, 1.26), 14: ("Si", 28.0855, 1.16),
    15: ("P", 30.973762, 1.11), 16: ("S", 32.065, 1.03),
    17: ("Cl", 35.453, 0.99), 18: ("Ar", 39.948, 0.96),
    19: ("K", 39.0983, 1.96), 20: ("Ca", 40.078, 1.71),
    21: ("Sc", 44.955912, 1.48), 22: ("Ti", 47.867, 1.36),
    23: ("V", 50.9415, 1.34), 24: ("Cr", 51.9961, 1.22),
    25: ("Mn", 54.938045, 1.19), 26: ("Fe", 55.845, 1.16),
    27: ("Co", 58.933195, 1.11), 28: ("Ni", 58.6934, 1.10),
    29: ("Cu", 63.546, 1.12), 30: ("Zn", 65.38, 1.18),
    31: ("Ga", 69.723, 1.24), 32: ("Ge", 72.64, 1.21),
    33: ("As", 74.92160, 1.21), 34: ("Se", 78.96, 1.16),
    35: ("Br", 79.904, 1.14), 36: ("Kr", 83.798, 1.17),
    37: ("Rb", 85.4678, 2.10), 38: ("Sr", 87.62, 1.85),
    39: ("Y", 88.90585, 1.63), 40: ("Zr", 91.224, 1.54),
    41: ("Nb", 92.90638, 1.47), 42: ("Mo", 95.96, 1.38),
    43: ("Tc", 98.0, 1.28), 44: ("Ru", 101.07, 1.25),
    45: ("Rh", 102.90550, 1.25), 46: ("Pd", 106.42, 1.20),
    47: ("Ag", 107.8682, 1.28), 48: ("Cd", 112.411, 1.36),
    49: ("In", 114.818, 1.42), 50: ("Sn", 118.710, 1.40),
    51: ("Sb", 121.760, 1.40), 52: ("Te", 127.60, 1.36),
    53: ("I", 126.90447, 1.33), 54: ("Xe", 131.293, 1.31),
    55: ("Cs", 132.9054519, 2.32), 56: ("Ba", 137.327, 1.96),
    57: ("La", 138.90547, 1.80), 58: ("Ce", 140.116, 1.63),
    59: ("Pr", 140.90765, 1.76), 60: ("Nd", 144.242, 1.74),
    61: ("Pm", 145.0, 1.73), 62: ("Sm", 150.36, 1.72),
    63: ("Eu", 151.964, 1.68), 64: ("Gd", 157.25, 1.69),
    65: ("Tb", 158.92535, 1.68), 66: ("Dy", 162.500, 1.67),
    67: ("Ho", 164.93032, 1.66), 68: ("Er", 167.259, 1.65),
    69: ("Tm", 168.93421, 1.64), 70: ("Yb", 173.054, 1.70),
    71: ("Lu", 174.9668, 1.62), 72: ("Hf", 178.49, 1.52),
    73: ("Ta", 180.94788, 1.46), 74: ("W", 183.84, 1.37),
    75: ("Re", 186.207, 1.31), 76: ("Os", 190.23, 1.29),
    77: ("Ir", 192.217, 1.22), 78: ("Pt", 195.084, 1.23),
    79: ("Au", 196.966569, 1.24), 80: ("Hg", 200.59, 1.33),
    81: ("Tl", 204.3833, 1.44), 82: ("Pb", 207.2, 1.44),
    83: ("Bi", 208.98040, 1.51), 84: ("Po", 209.0, 1.45),
    85: ("At", 210.0, 1.47), 86: ("Rn", 222.0, 1.42),
    87: ("Fr", 223.0, 2.23), 88: ("Ra", 226.0, 2.01),
    89: ("Ac", 227.0, 1.86), 90: ("Th", 232.03806, 1.75),
    91: ("Pa", 231.03588, 1.69), 92: ("U", 238.02891, 1.70),
    93: ("Np", 237.0, 1.71), 94: ("Pu", 244.0, 1.72),
    95: ("Am", 243.0, 1.66), 96: ("Cm", 247.0, 1.66),
    97: ("Bk", 247.0, 1.68), 98: ("Cf", 251.0, 1.68),
    99: ("Es", 252.0, 1.65), 100: ("Fm", 257.0, 1.67),
    101: ("Md", 258.0, 1.73), 102: ("No", 259.0, 1.76),
    103: ("Lr", 262.0, 1.61), 104: ("Rf", 267.0, 1.57),
    105: ("Db", 268.0, 1.49), 106: ("Sg", 271.0, 1.43),
    107: ("Bh", 272.0, 1.41), 108: ("Hs", 270.0, 1.34),
    109: ("Mt", 276.0, 1.29), 110: ("Ds", 281.0, 1.28),
    111: ("Rg", 280.0, 1.21), 112: ("Cn", 285.0, 1.22),
    113: ("Nh", 284.0, 1.36), 114: ("Fl", 289.0, 1.43),
    115: ("Mc", 288.0, 1.62), 116: ("Lv", 293.0, 1.75),
    117: ("Ts", 294.0, 1.65), 118: ("Og", 294.0, 1.57),
}

SYMBOLS: Dict[int, str] = {z: s for z, (s, _, _) in _ELEMENTS.items()}
NUMBERS: Dict[str, int] = {s: z for z, s in SYMBOLS.items()}
# Also accept upper/lower-case lookups ("FE", "fe").
NUMBERS.update({s.upper(): z for z, s in SYMBOLS.items()})
NUMBERS.update({s.lower(): z for z, s in SYMBOLS.items()})
# Deuterium/tritium aliases
NUMBERS.update({"D": 1, "T": 1, "d": 1, "t": 1})

MAX_Z = max(_ELEMENTS)

# Padded lookup arrays indexed by Z; index 0 is the "padding atom"
# (zero mass/radius so padded entries never contribute).
MASSES = np.zeros(MAX_Z + 1, dtype=np.float64)
COVALENT_RADII_ANG = np.zeros(MAX_Z + 1, dtype=np.float64)
for _z, (_s, _m, _r) in _ELEMENTS.items():
    MASSES[_z] = _m
    COVALENT_RADII_ANG[_z] = _r
COVALENT_RADII_BOHR = COVALENT_RADII_ANG * ANG2BOHR


def symbol_of(z: int) -> str:
    return SYMBOLS[int(z)]


def z_of(symbol: str) -> int:
    s = symbol.strip()
    if s in NUMBERS:
        return NUMBERS[s]
    s2 = s.capitalize()
    if s2 in NUMBERS:
        return NUMBERS[s2]
    raise KeyError(f"Unknown element symbol: {symbol!r}")


def numbers_from_symbols(symbols: Sequence[str]) -> np.ndarray:
    return np.array([z_of(s) for s in symbols], dtype=np.int32)


def symbols_from_numbers(numbers: Sequence[int]) -> List[str]:
    return [symbol_of(z) for z in numbers]


def masses_of(numbers: Sequence[int]) -> np.ndarray:
    return MASSES[np.asarray(numbers, dtype=np.int64)]


def covalent_radii_of(numbers: Sequence[int], unit: str = "ang") -> np.ndarray:
    tab = COVALENT_RADII_ANG if unit == "ang" else COVALENT_RADII_BOHR
    return tab[np.asarray(numbers, dtype=np.int64)]
