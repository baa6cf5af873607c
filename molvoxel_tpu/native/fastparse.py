"""ctypes binding for the native batch SDF parser (+ Python fallback).

``parse_sdf_file(path)`` returns a list of SimpleMolecule.  With the native
library present the whole file is parsed in one C++ pass into flat numpy
arrays (no per-line Python); without it the pure-Python parser from
data/parsers.py is used transparently.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..data.parsers import SDF_BOND_TYPES, SimpleMolecule, iter_sdf_lines
from .build import build

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.sdf_scan.restype = ctypes.c_int64
    lib.sdf_scan.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sdf_parse.restype = ctypes.c_int64
    lib.sdf_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
    ]
    lib.wire_assemble.restype = ctypes.c_int64
    lib.wire_assemble.argtypes = [
        np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_int32,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_int32,
        np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS"),
    ]
    _lib = lib
    return lib


def wire_assemble_native(coords, types, counts, vp, scale, presort, cell_lb, cell_scale,
                         cells: int = 31):
    """One C pass: FlatClouds columns -> ((M, Vp, 4) int16 wire, (M,) num_atoms).

    None when the native lib is absent (data/feed.py composes the numpy
    fallback).  The GIL is released for the whole call (ctypes), so assembly
    overlaps the stream driver thread — the numpy path could not.
    """
    lib = _load()
    if lib is None:
        return None
    m = len(counts)
    counts = np.ascontiguousarray(counts, np.int64)
    # bounds the C pass relies on: every molecule fits its Vp row and the
    # flat coord/type columns cover the claimed atom totals
    if m and int(counts.max(initial=0)) > vp:
        raise ValueError(f"molecule with {int(counts.max())} atoms exceeds bucket {vp}")
    if int(counts.sum()) > len(coords):
        raise ValueError("counts claim more atoms than the coords column holds")
    wire = np.empty((m, vp, 4), np.int16)
    num_atoms = np.empty((m,), np.int32)
    got = lib.wire_assemble(
        np.ascontiguousarray(coords, np.float32),
        np.ascontiguousarray(types, np.int32),
        counts,
        m, vp, float(scale), int(bool(presort)),
        float(cell_lb), float(cell_scale), int(cells),
        wire, num_atoms,
    )
    assert got == m
    return wire, num_atoms


NATIVE_AVAILABLE = _load() is not None


class FlatMolecules:
    """A whole SDF file as flat arrays — the zero-object form the batching
    pipeline consumes directly (per-molecule slices via the offset arrays)."""

    def __init__(self, coords, symbols, atom_offsets, bonds, bond_offsets):
        self.coords = coords  # (total_atoms, 3) float64
        self.symbols = symbols  # (total_atoms,) bytes '|S4'
        self.atom_offsets = atom_offsets  # (n_mols + 1,) int64
        self.bonds = bonds  # (total_bonds, 3) int32: i, j, order-code
        self.bond_offsets = bond_offsets  # (n_mols + 1,) int64

    @property
    def num_molecules(self) -> int:
        return len(self.atom_offsets) - 1

    def types(self, symbol_table: dict[str, int], unknown: int | None = None) -> np.ndarray:
        """Vectorized symbol -> type-index mapping for all atoms at once
        (data.feed.map_symbols: searchsorted over the 4-byte fields as ints)."""
        from ..data.feed import map_symbols

        return map_symbols(self.symbols, symbol_table, unknown)

    def molecule(self, m: int) -> SimpleMolecule:
        a0, a1 = self.atom_offsets[m], self.atom_offsets[m + 1]
        b0, b1 = self.bond_offsets[m], self.bond_offsets[m + 1]
        syms = [s.decode("ascii") for s in self.symbols[a0:a1]]
        mol_bonds = [
            (int(i), int(j), SDF_BOND_TYPES.get(int(o), "SINGLE")) for i, j, o in self.bonds[b0:b1]
        ]
        return SimpleMolecule(coords=self.coords[a0:a1].copy(), symbols=syms, bonds=mol_bonds)

    def to_molecules(self) -> list[SimpleMolecule]:
        return [self.molecule(m) for m in range(self.num_molecules)]


def parse_sdf_flat(buf: bytes) -> FlatMolecules | None:
    """Native one-pass parse to flat arrays; None when the native lib is absent
    or the buffer contains V3000 records (the C scanner is V2000-only — a
    V3000 counts line reads as 0 atoms; the python parser handles V3000)."""
    lib = _load()
    if lib is None or b"V3000" in buf:
        return None
    n_mols = ctypes.c_int64()
    n_atoms = ctypes.c_int64()
    n_bonds = ctypes.c_int64()
    rc = lib.sdf_scan(buf, len(buf), ctypes.byref(n_mols), ctypes.byref(n_atoms), ctypes.byref(n_bonds))
    if rc != 0:
        raise ValueError("malformed SDF input")
    nm, na, nb = n_mols.value, n_atoms.value, n_bonds.value
    # np.zeros (not empty): pre-touched pages keep the C fill at memory speed
    coords = np.zeros((max(na, 1), 3), np.float64)
    symbols = np.zeros((max(na, 1) * 4,), np.uint8)
    atom_off = np.zeros((nm + 1,), np.int64)
    bonds = np.zeros((max(nb, 1), 3), np.int32)
    bond_off = np.zeros((nm + 1,), np.int64)
    got = lib.sdf_parse(buf, len(buf), coords, symbols, atom_off, bonds, bond_off, max(nm, 1))
    if got < 0:
        raise ValueError("malformed SDF input")
    return FlatMolecules(
        coords[:na], symbols[: na * 4].view("|S4"), atom_off[: got + 1], bonds[:nb], bond_off[: got + 1]
    )


def parse_sdf_buffer(buf: bytes) -> list[SimpleMolecule]:
    """Parse a (multi-record) SDF byte buffer into SimpleMolecules."""
    flat = parse_sdf_flat(buf)
    if flat is not None:
        return flat.to_molecules()
    return list(iter_sdf_lines(buf.decode("utf-8", errors="replace").splitlines()))


def parse_sdf_file(path: str | Path) -> list[SimpleMolecule]:
    """Parse every record of an SDF file (native fast path when available)."""
    return parse_sdf_buffer(Path(path).read_bytes())
