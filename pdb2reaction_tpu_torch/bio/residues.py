"""Residue dictionaries: nominal charges, ions, backbone and water names.

A copy of ``pdb2reaction_tpu/bio/residues.py`` (Amber/CHARMM residue
naming), which the charge summary and the pocket extraction read.
"""

from __future__ import annotations

from typing import Dict, Set

# Standard 20 L-amino acids (all neutral except Asp/Glu -1, Arg/Lys +1)
_STANDARD20: Dict[str, int] = {
    "ALA": 0, "ARG": 1, "ASN": 0, "ASP": -1, "CYS": 0,
    "GLN": 0, "GLU": -1, "GLY": 0, "HIS": 0, "ILE": 0,
    "LEU": 0, "LYS": 1, "MET": 0, "PHE": 0, "PRO": 0,
    "SER": 0, "THR": 0, "TRP": 0, "TYR": 0, "VAL": 0,
}

# Protonation variants / tautomers
_VARIANTS: Dict[str, int] = {
    "SEC": 0, "PYL": 1,
    "HIP": 1, "HID": 0, "HIE": 0,
    "ASH": 0, "GLH": 0, "LYN": 0, "ARN": 0, "TYM": -1,
    # phospho residues
    "SEP": -2, "TPO": -2, "PTR": -2,
    "S1P": -1, "T1P": -1, "Y1P": -1,
    "H1D": 0, "H2D": -1, "H1E": 0, "H2E": -1,
    # cysteine family
    "CYX": 0, "CSO": 0, "CSD": -1, "CSX": 0, "OCS": -1, "CYM": -1,
    # lysine family
    "MLY": 1, "LLP": 1, "DLY": 1, "KCX": -1,
    # carboxylation / cyclization / misc modified
    "CGU": -2, "CGA": -1, "PCA": 0, "MSE": 0, "OMT": 0,
    "ASA": 0, "CIR": 0, "FOR": 0, "MVA": 0, "IIL": 0, "AIB": 0, "HTN": 0,
    "SAR": 0, "NMC": 0, "PFF": 0, "NFA": 0, "ALY": 0, "AZF": 0, "CNX": 0,
    "CYF": 0, "HYP": 0,
    # D isomers
    "DAL": 0, "DAR": 1, "DSG": 0, "DAS": -1, "DCY": 0,
    "DGN": 0, "DGL": -1, "DHI": 0, "DIL": 0, "DLE": 0,
    "MED": 0, "DPN": 0, "DPR": 0, "DSN": 0,
    "DTH": 0, "DTR": 0, "DTY": 0, "DVA": 0,
}

# Terminal-capped residue names (Amber): C-terminal carboxylate adds -1,
# N-terminal ammonium adds +1 on top of the side-chain charge.
_C_TERM: Dict[str, int] = {
    "CALA": -1, "CARG": 0, "CASN": -1, "CASP": -2, "CCYS": -1,
    "CCYX": -1, "CGLN": -1, "CGLU": -2, "CGLY": -1, "CHID": -1,
    "CHIE": -1, "CHIP": 0, "CHYP": -1, "CILE": -1, "CLEU": -1,
    "CLYS": 0, "CMET": -1, "CPHE": -1, "CPRO": -1, "CSER": -1,
    "CTHR": -1, "CTRP": -1, "CTYR": -1, "CVAL": -1,
    "NHE": 0, "NME": 0, "CTER": -1,
}
_N_TERM: Dict[str, int] = {
    "NALA": 1, "NARG": 2, "NASN": 1, "NASP": 0, "NCYS": 1,
    "NCYX": 1, "NGLN": 1, "NGLU": 0, "NGLY": 1, "NHID": 1,
    "NHIE": 1, "NHIP": 2, "NILE": 1, "NLEU": 1, "NLYS": 2,
    "NMET": 1, "NPHE": 1, "NPRO": 1, "NSER": 1, "NTHR": 1,
    "NTRP": 1, "NTYR": 1, "NVAL": 1, "ACE": 0, "NTER": 1,
}

AMINO_ACIDS: Dict[str, int] = {**_STANDARD20, **_VARIANTS, **_C_TERM, **_N_TERM}

# Monatomic / common ions by residue name -> formal charge
ION: Dict[str, int] = {
    # +1
    "LI": 1, "NA": 1, "K": 1, "RB": 1, "CS": 1, "TL": 1, "AG": 1, "CU1": 1,
    "K+": 1, "NA+": 1, "NH4": 1, "H3O+": 1,
    # +2
    "MG": 2, "CA": 2, "SR": 2, "BA": 2, "MN": 2, "FE2": 2, "CO": 2, "NI": 2,
    "CU": 2, "ZN": 2, "CD": 2, "HG": 2, "PB": 2, "BE": 2, "PD": 2, "PT": 2,
    "SN": 2, "RA": 2, "YB2": 2, "V2+": 2,
    # +3
    "FE": 3, "AU3": 3, "AL": 3, "GA": 3, "IN": 3, "CE": 3, "CR": 3, "DY": 3,
    "EU": 3, "EU3": 3, "ER": 3, "GD3": 3, "LA": 3, "LU": 3, "ND": 3, "PR": 3,
    "SM": 3, "TB": 3, "TM": 3, "Y": 3, "PU": 3,
    # +4
    "U4+": 4, "TH": 4, "HF": 4, "ZR": 4,
    # -1
    "F": -1, "CL": -1, "BR": -1, "I": -1, "CL-": -1, "IOD": -1,
}

WATER_RESNAMES: Set[str] = {"HOH", "WAT", "H2O", "TIP", "TIP3", "TIP4", "SPC", "DOD"}

BACKBONE_ATOMS: Set[str] = {"N", "CA", "C", "O", "H", "HA", "HA2", "HA3",
                            "H1", "H2", "H3", "OXT", "HXT"}
# Heavy backbone only (used for cut decisions)
BACKBONE_HEAVY: Set[str] = {"N", "CA", "C", "O", "OXT"}

STANDARD_RESNAMES: Set[str] = set(AMINO_ACIDS) | WATER_RESNAMES

NUCLEIC_RESNAMES: Set[str] = {
    "A", "C", "G", "U", "T", "DA", "DC", "DG", "DT", "DU",
    "RA", "RC", "RG", "RU", "ADE", "CYT", "GUA", "THY", "URA",
}

DISULFIDE_CUTOFF_ANG = 2.5   # Sgamma-Sgamma distance for disulfide detection
PEPTIDE_CN_CUTOFF_ANG = 1.9  # geometric C-N peptide-bond adjacency

# Link-hydrogen conventions
LINK_H_NAME = "HL"
LINK_H_RESNAME = "LKH"
LINK_H_BOND_LENGTH_ANG = 1.09


def residue_formal_charge(resname: str) -> int:
    """Nominal integer charge for a residue name; 0 if unknown."""
    r = resname.strip().upper()
    if r in AMINO_ACIDS:
        return AMINO_ACIDS[r]
    if r in ION:
        return ION[r]
    return 0


def is_amino_acid(resname: str) -> bool:
    return resname.strip().upper() in AMINO_ACIDS


def is_water(resname: str) -> bool:
    return resname.strip().upper() in WATER_RESNAMES


def is_ion(resname: str) -> bool:
    return resname.strip().upper() in ION
