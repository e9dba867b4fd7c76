"""Chemical element symbols <-> atomic numbers (self-contained; the
reference uses ase.symbols for this, reference: sevenn/nn/node_embedding.py:51-65)."""

SYMBOLS = [
    'X', 'H', 'He', 'Li', 'Be', 'B', 'C', 'N', 'O', 'F', 'Ne',
    'Na', 'Mg', 'Al', 'Si', 'P', 'S', 'Cl', 'Ar', 'K', 'Ca',
    'Sc', 'Ti', 'V', 'Cr', 'Mn', 'Fe', 'Co', 'Ni', 'Cu', 'Zn',
    'Ga', 'Ge', 'As', 'Se', 'Br', 'Kr', 'Rb', 'Sr', 'Y', 'Zr',
    'Nb', 'Mo', 'Tc', 'Ru', 'Rh', 'Pd', 'Ag', 'Cd', 'In', 'Sn',
    'Sb', 'Te', 'I', 'Xe', 'Cs', 'Ba', 'La', 'Ce', 'Pr', 'Nd',
    'Pm', 'Sm', 'Eu', 'Gd', 'Tb', 'Dy', 'Ho', 'Er', 'Tm', 'Yb',
    'Lu', 'Hf', 'Ta', 'W', 'Re', 'Os', 'Ir', 'Pt', 'Au', 'Hg',
    'Tl', 'Pb', 'Bi', 'Po', 'At', 'Rn', 'Fr', 'Ra', 'Ac', 'Th',
    'Pa', 'U', 'Np', 'Pu', 'Am', 'Cm', 'Bk', 'Cf', 'Es', 'Fm',
    'Md', 'No', 'Lr', 'Rf', 'Db', 'Sg', 'Bh', 'Hs', 'Mt', 'Ds',
    'Rg', 'Cn', 'Nh', 'Fl', 'Mc', 'Lv', 'Ts', 'Og',
]

ATOMIC_NUMBERS = {s: z for z, s in enumerate(SYMBOLS)}


def symbol_to_z(symbol: str) -> int:
    return ATOMIC_NUMBERS[symbol]


def z_to_symbol(z: int) -> str:
    return SYMBOLS[z]


def type_map_from_species(species):
    """['Hf', 'O'] -> {72: 0, 8: 1}: onehot index by sorted symbol order
    (reference: sevenn/nn/node_embedding.py:51-65)."""
    type_map = {}
    idx = 0
    for s in sorted(set(species)):
        z = symbol_to_z(s)
        if z not in type_map:
            type_map[z] = idx
            idx += 1
    return type_map
