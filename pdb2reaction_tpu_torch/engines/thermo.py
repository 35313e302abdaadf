"""Ideal-gas RRHO / QRRHO thermochemistry, in numpy.

Counterpart of ``pdb2reaction_tpu/engines/thermo.py`` (its own copy: the
port imports nothing of the JAX package). Standard statistical-mechanics
formulas with Grimme's quasi-RRHO interpolation of the low-frequency
entropy (nu0 = 100 cm^-1, w(nu) = 1/(1+(nu0/nu)^4)): zero-point energy,
thermal corrections, enthalpy, entropy (translational, rotational,
vibrational, electronic) and Gibbs free energy.

Units: frequencies in cm^-1 (negative = imaginary, excluded), masses amu,
coordinates Angstrom; energies out in Hartree, entropies in Hartree/K.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, asdict
from typing import Dict, Sequence

import numpy as np

from ..constants import (AMU2KG, AU2JOULE, C_LIGHT, KB, NA, PLANCK, HBAR,
                         R_GAS)
from .. import elements

J2AU = 1.0 / AU2JOULE
JMOL2AU = 1.0 / (AU2JOULE * NA)


@dataclass
class ThermoResult:
    T: float
    pressure: float
    electronic_energy: float      # au
    zpe: float                    # au
    u_trans: float
    u_rot: float
    u_vib: float                  # thermal vib energy excluding ZPE, au
    enthalpy_corr: float          # total H correction (au)
    s_trans: float                # au/K
    s_rot: float
    s_vib: float
    s_el: float
    entropy: float                # total S, au/K
    gibbs_corr: float             # G - EE (au)
    gibbs: float                  # EE + corr (au)
    n_imag: int

    def as_dict(self) -> Dict:
        out = {}
        for k, v in asdict(self).items():
            out[k] = (int(v) if isinstance(v, (int, np.integer))
                      else float(v) if isinstance(v, (float, np.floating))
                      else v)
        return out


def _rotational_entropy_energy(coords_ang, masses_amu, T, sigma=1):
    """Rigid-rotor S_rot and U_rot from principal moments of inertia."""
    m = np.asarray(masses_amu) * AMU2KG
    x = np.asarray(coords_ang) * 1e-10
    com = (x * m[:, None]).sum(0) / m.sum()
    x = x - com
    I = np.zeros((3, 3))
    for mi, xi in zip(m, x):
        I += mi * (np.dot(xi, xi) * np.eye(3) - np.outer(xi, xi))
    moments = np.linalg.eigvalsh(I)          # kg m^2
    moments = moments[moments > 1e-53]
    if len(moments) == 0:                     # single atom
        return 0.0, 0.0
    if len(moments) <= 2 or moments[0] / moments[-1] < 1e-8:
        # linear: one rotational constant
        I_lin = moments[-1]
        theta = HBAR ** 2 / (2.0 * I_lin * KB)
        q_rot = T / (sigma * theta)
        s = R_GAS * (math.log(q_rot) + 1.0)
        u = R_GAS * T
    else:
        thetas = [HBAR ** 2 / (2.0 * Ii * KB) for Ii in moments]
        q_rot = (math.sqrt(math.pi) / sigma
                 * math.sqrt(T ** 3 / (thetas[0] * thetas[1] * thetas[2])))
        s = R_GAS * (math.log(q_rot) + 1.5)
        u = 1.5 * R_GAS * T
    return s * JMOL2AU, u * JMOL2AU


def thermochemistry(
    freqs_cm: Sequence[float],
    numbers: Sequence[int],
    coords_ang,
    *,
    electronic_energy: float = 0.0,      # au
    T: float = 298.15,
    pressure: float = 101325.0,
    multiplicity: int = 1,
    sigma_rot: int = 1,
    qrrho_nu0: float = 100.0,            # cm^-1 Grimme interpolation
    scale: float = 1.0,
) -> ThermoResult:
    freqs = np.asarray(freqs_cm, dtype=float) * scale
    n_imag = int((freqs < 0).sum())
    nu = freqs[freqs > 0]                 # real modes only

    masses = elements.masses_of(np.asarray(numbers, dtype=int))
    M = masses.sum() * AMU2KG

    # --- translations
    q_trans = ((2.0 * math.pi * M * KB * T / PLANCK ** 2) ** 1.5
               * KB * T / pressure)
    s_trans = R_GAS * (math.log(q_trans) + 2.5) * JMOL2AU
    u_trans = 1.5 * R_GAS * T * JMOL2AU

    # --- rotations
    s_rot, u_rot = _rotational_entropy_energy(coords_ang, masses, T,
                                              sigma_rot)

    # --- vibrations
    theta = PLANCK * C_LIGHT * 100.0 * nu / KB       # K per mode
    x = theta / T
    ex = np.exp(-x)
    zpe = 0.5 * R_GAS * theta.sum() * JMOL2AU
    u_vib = (R_GAS * (theta * ex / (1.0 - ex)).sum()) * JMOL2AU
    s_rrho = R_GAS * (x * ex / (1.0 - ex) - np.log(1.0 - ex))  # per mode J/mol/K

    # quasi-RRHO (Grimme 2012): damp low-freq harmonic entropy toward a
    # free-rotor value
    w = 1.0 / (1.0 + (qrrho_nu0 / np.maximum(nu, 1e-12)) ** 4)
    omega = 2.0 * math.pi * C_LIGHT * 100.0 * nu      # rad/s
    mu_eff = HBAR / (2.0 * omega)                     # kg m^2 (h/(8pi^2 nu))
    B_av = 1e-44
    mu_p = mu_eff * B_av / (mu_eff + B_av)
    s_rotor = R_GAS * (0.5 + np.log(np.sqrt(
        8.0 * math.pi ** 3 * mu_p * KB * T / PLANCK ** 2)))
    s_vib = (w * s_rrho + (1.0 - w) * s_rotor).sum() * JMOL2AU

    # --- electronic
    s_el = R_GAS * math.log(max(multiplicity, 1)) * JMOL2AU

    entropy = s_trans + s_rot + s_vib + s_el
    kT = KB * T * NA * JMOL2AU                         # RT in au
    enthalpy_corr = zpe + u_trans + u_rot + u_vib + kT
    gibbs_corr = enthalpy_corr - T * entropy
    return ThermoResult(
        T=T, pressure=pressure, electronic_energy=electronic_energy,
        zpe=zpe, u_trans=u_trans, u_rot=u_rot, u_vib=u_vib,
        enthalpy_corr=enthalpy_corr,
        s_trans=s_trans, s_rot=s_rot, s_vib=s_vib, s_el=s_el,
        entropy=entropy, gibbs_corr=gibbs_corr,
        gibbs=electronic_energy + gibbs_corr, n_imag=n_imag)
