"""Physical constants and unit conversions.

Unit contract: the ML potential works in eV / Angstrom; the optimizer/public API works in
Hartree / Bohr. All conversions happen at the calculator boundary.

CODATA 2018 values.
"""

from __future__ import annotations

import math

# Length
BOHR2ANG = 0.529177210903  # Bohr radius in Angstrom (CODATA 2018)
ANG2BOHR = 1.0 / BOHR2ANG

# Energy
AU2EV = 27.211386245988  # Hartree in eV (CODATA 2018)
EV2AU = 1.0 / AU2EV
AU2KCALPERMOL = 627.509474063056
KCALPERMOL2AU = 1.0 / AU2KCALPERMOL
AU2KJPERMOL = 2625.4996394799
AU2JOULE = 4.3597447222071e-18

# Force / Hessian conversions (eV/Ang -> Hartree/Bohr etc.)
F_EVAA_2_AU = EV2AU * BOHR2ANG          # (eV/Ang)   -> (Hartree/Bohr)
H_EVAA_2_AU = EV2AU * BOHR2ANG ** 2     # (eV/Ang^2) -> (Hartree/Bohr^2)

# Mass
AMU2KG = 1.66053906660e-27
AMU2AU = 1822.888486209   # electron masses per amu

# Fundamental
KB = 1.380649e-23            # J/K
KB_AU = 3.166811563e-6       # Hartree/K
PLANCK = 6.62607015e-34      # J*s
HBAR = PLANCK / (2.0 * math.pi)
C_LIGHT = 299792458.0        # m/s
NA = 6.02214076e23
R_GAS = KB * NA              # J/(mol*K)

# Vibrational analysis: convert mass-weighted Hessian eigenvalues
# (Hartree / (Bohr^2 * amu)) to wavenumbers in cm^-1.
# omega [1/s] = sqrt(lambda * AU2JOULE / (AMU2KG * (BOHR2ANG*1e-10)^2))
# nu [cm^-1] = omega / (2 pi c * 100)
_EIGVAL_TO_S2 = AU2JOULE / (AMU2KG * (BOHR2ANG * 1e-10) ** 2)
NU_CM_FACTOR = math.sqrt(_EIGVAL_TO_S2) / (2.0 * math.pi * C_LIGHT * 100.0)


def eigval_to_wavenumber(eigval: float) -> float:
    """Mass-weighted Hessian eigenvalue (Hartree/Bohr^2/amu) -> signed cm^-1.

    Negative eigenvalues map to negative (imaginary) wavenumbers.
    """
    sign = 1.0 if eigval >= 0 else -1.0
    return sign * math.sqrt(abs(eigval)) * NU_CM_FACTOR
