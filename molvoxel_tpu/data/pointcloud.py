"""Point-cloud makers: molecules -> (coords, channels) arrays.

Public API matches the reference maker hierarchy
(/root/reference/molvoxel/etc/rdkit/pointcloud.py:12-326) — same class names,
constructor signatures and run() outputs — but the internals are a fresh
design around a flat **block table**: every maker compiles its inputs into a
list of ``_Block(source, getter, channel_lo)`` records at construction, and
all assembly (coords, one-hot features, type indices) is a single loop over
that table.  This removes the reference's three parallel mechanisms (per-mode
``setup_*`` index fields, an offset-overriding element subclass, and
duplicated feature/type writers).

Differences from the reference worth knowing:

- Toolkit-agnostic: works on data.parsers.SimpleMolecule out of the box and
  on RDKit Mol objects when RDKit is installed (the reference requires RDKit
  unconditionally).
- The reference's documented-but-broken coords override
  (``kwargs.get("kwargs", ...)`` instead of ``"coords"``,
  pointcloud.py:72,232 — SURVEY.md Q4) works here: pass ``coords=`` to run().
- Types are int32 (JAX's default int; reference uses int16).

Bond channels place pseudo-atoms at bond midpoints, concatenated after the
atom block, exactly like the reference (pointcloud.py:79-89).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from .getter import AtomChannelGetter, BondChannelGetter
from .parsers import SimpleMolecule

_MODES = ("features", "types")


# ------------------------------------------------------------ molecule access


def _mol_coords(mol: Any) -> np.ndarray:
    if isinstance(mol, SimpleMolecule):
        return np.asarray(mol.coords, dtype=np.float64)
    return np.asarray(mol.GetConformer().GetPositions(), dtype=np.float64)


def _mol_num_atoms(mol: Any) -> int:
    return mol.num_atoms if isinstance(mol, SimpleMolecule) else mol.GetNumAtoms()


def _mol_num_bonds(mol: Any) -> int:
    return mol.num_bonds if isinstance(mol, SimpleMolecule) else mol.GetNumBonds()


def _mol_bond_midpoints(mol: Any, atom_coords: np.ndarray) -> np.ndarray:
    if isinstance(mol, SimpleMolecule):
        return mol.bond_midpoints()
    pairs = [(b.GetBeginAtomIdx(), b.GetEndAtomIdx()) for b in mol.GetBonds()]
    if not pairs:
        return np.zeros((0, 3), dtype=atom_coords.dtype)
    ij = np.asarray(pairs)
    return (atom_coords[ij[:, 0]] + atom_coords[ij[:, 1]]) / 2.0


def _mol_items(mol: Any, source: str) -> list:
    """The objects a getter consumes: symbols/Atoms or bond names/Bonds."""
    if source == "atoms":
        return list(mol.symbols) if isinstance(mol, SimpleMolecule) else list(mol.GetAtoms())
    if isinstance(mol, SimpleMolecule):
        return [t for (_i, _j, t) in mol.bonds]
    return list(mol.GetBonds())


def _source_count(mol: Any, source: str) -> int:
    return _mol_num_atoms(mol) if source == "atoms" else _mol_num_bonds(mol)


# ---------------------------------------------------------------- block table


@dataclass(frozen=True)
class _Block:
    """One (molecule-slot, point source, getter) unit of the assembly plan."""

    mol_slot: int  # index into the molecule list handed to run()
    source: str  # "atoms" | "bonds"
    getter: Any
    channel_lo: int  # first output channel this getter writes

    @property
    def channel_hi(self) -> int:
        return self.channel_lo + self.getter.num_channels


def _validate_getters(mode: str, *getters) -> None:
    allowed = ("TYPE",) if mode == "types" else ("TYPE", "FEATURE")
    for g in getters:
        if g is not None:
            assert g.CHANNEL_TYPE in allowed, (
                f"{mode!r} makers accept {'/'.join(allowed)} getters, got {g.CHANNEL_TYPE}"
            )


def _type_indices(block: _Block, items: list, **kwargs) -> np.ndarray:
    g = block.getter
    return np.fromiter(
        (g.get_type(it, **kwargs) for it in items), dtype=np.int32, count=len(items)
    ) + np.int32(block.channel_lo)


def _feature_rows(block: _Block, items: list, num_channels: int, **kwargs) -> np.ndarray:
    g = block.getter
    rows = np.zeros((len(items), num_channels), dtype=np.float32)
    if hasattr(g, "get_type") and not kwargs:
        # TYPE getter: one-hot rows, written by fancy indexing in one pass
        cols = _type_indices(block, items)
        rows[np.arange(len(items)), cols] = 1.0
    elif items:
        rows[:, block.channel_lo : block.channel_hi] = [g.get_feature(it, **kwargs) for it in items]
    return rows


# -------------------------------------------------------------------- makers


class PointCloudMaker:
    """Base: channel registry + per-channel image splitting."""

    def __init__(self, channels: list[str]):
        self.channels = channels
        self.num_channels = len(channels)

    def split_channel(self, image) -> dict[str, Any]:
        """Name -> per-channel sub-image (reference pointcloud.py:17-19)."""
        assert np.shape(image)[0] == self.num_channels
        return dict(zip(self.channels, image))

    def run(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.run(*args, **kwargs)


class _BlockTableMaker(PointCloudMaker):
    """Shared engine: everything is a loop over the block table."""

    def __init__(self, blocks: list[_Block], channels: list[str], channel_type: str):
        assert channel_type in _MODES, (
            f"channel_type(input: {channel_type}) must be one of {_MODES}"
        )
        super().__init__(channels)
        self.channel_type = channel_type
        self.use_features = channel_type == "features"
        self._blocks = blocks
        self._num_slots = 1 + max(b.mol_slot for b in blocks)

    # -- geometry

    def _slot_coords(self, mol, slot: int) -> list[np.ndarray]:
        parts = []
        atom_coords = None
        for b in self._blocks:
            if b.mol_slot != slot:
                continue
            if b.source == "atoms":
                atom_coords = _mol_coords(mol)
                parts.append(atom_coords)
            else:
                base = atom_coords if atom_coords is not None else _mol_coords(mol)
                parts.append(_mol_bond_midpoints(mol, base))
        return parts

    def _coords_of(self, mols: list) -> np.ndarray:
        parts = []
        for slot, mol in enumerate(mols):
            parts.extend(self._slot_coords(mol, slot))
        return np.concatenate(parts, axis=0) if parts else np.zeros((0, 3))

    def _points_of(self, mols: list) -> int:
        return sum(_source_count(mols[b.mol_slot], b.source) for b in self._blocks)

    # -- channels

    def _features_of(self, mols: list, out: np.ndarray | None, **kwargs) -> np.ndarray:
        n = self._points_of(mols)
        if out is None:
            out = np.zeros((n, self.num_channels), dtype=np.float32)
        else:
            out.fill(0)
        row = 0
        for b in self._blocks:
            items = _mol_items(mols[b.mol_slot], b.source)
            if items:
                out[row : row + len(items)] = _feature_rows(b, items, self.num_channels, **kwargs)
            row += len(items)
        return out

    def _types_of(self, mols: list, out: np.ndarray | None, **kwargs) -> np.ndarray:
        assert not self.use_features, "types output requires channel_type='types'"
        n = self._points_of(mols)
        if out is None:
            out = np.empty((n,), dtype=np.int32)
        row = 0
        for b in self._blocks:
            items = _mol_items(mols[b.mol_slot], b.source)
            if items:
                out[row : row + len(items)] = _type_indices(b, items, **kwargs)
            row += len(items)
        return out

    def _channels_of(self, mols: list, out=None, **kwargs) -> np.ndarray:
        if self.use_features:
            return self._features_of(mols, out, **kwargs)
        return self._types_of(mols, out, **kwargs)

    def _run(self, mols: list, **kwargs) -> tuple[np.ndarray, np.ndarray]:
        coords = kwargs.pop("coords", None)
        channels = kwargs.pop("channels", None)
        if coords is None:
            coords = self._coords_of(mols)
        if channels is None:
            channels = self._channels_of(mols, **kwargs)
        return coords, channels


class MolPointCloudMaker(_BlockTableMaker):
    """Single-molecule maker: atoms (+ optional bond midpoints) -> channels."""

    def __init__(
        self,
        atom_getter: AtomChannelGetter,
        bond_getter: BondChannelGetter | None = None,
        channel_type: str = "features",
    ):
        _validate_getters("types" if channel_type == "types" else "features", atom_getter, bond_getter)
        self.atom_getter = atom_getter
        self.bond_getter = bond_getter
        self.use_bond = bond_getter is not None
        self.num_atom_channels = atom_getter.num_channels
        self.num_bond_channels = bond_getter.num_channels if bond_getter is not None else 0

        blocks = [_Block(0, "atoms", atom_getter, 0)]
        channels = list(atom_getter.channels)
        if bond_getter is not None:
            blocks.append(_Block(0, "bonds", bond_getter, blocks[0].channel_hi))
            channels += list(bond_getter.channels)
        super().__init__(blocks, channels, channel_type)

    def run(self, mol, **kwargs) -> tuple[np.ndarray, np.ndarray]:
        return self._run([mol], **kwargs)

    def get_coords(self, mol) -> np.ndarray:
        return self._coords_of([mol])

    def get_channels(self, mol, out: np.ndarray | None = None, **kwargs) -> np.ndarray:
        return self._channels_of([mol], out, **kwargs)

    def get_features(self, mol, out: np.ndarray | None = None, **kwargs) -> np.ndarray:
        return self._features_of([mol], out, **kwargs)

    def get_types(self, mol, out: np.ndarray | None = None, **kwargs) -> np.ndarray:
        return self._types_of([mol], out, **kwargs)

    def num_points(self, mol) -> int:
        return self._points_of([mol])


class MolSystemPointCloudMaker(_BlockTableMaker):
    """Concatenate several molecules into one cloud with disjoint channel
    ranges (reference pointcloud.py:207-312).

    Accepts MolPointCloudMaker instances or (atom_getter, bond_getter) pairs;
    molecule i's channels start where molecule i-1's end."""

    def __init__(self, *args, channel_type: str = "features"):
        blocks: list[_Block] = []
        channels: list[str] = []
        self.maker_list: list[MolPointCloudMaker] = []
        for slot, arg in enumerate(args):
            ag, bg = (arg.atom_getter, arg.bond_getter) if isinstance(arg, MolPointCloudMaker) else arg
            element = MolPointCloudMaker(ag, bg, channel_type)
            self.maker_list.append(element)
            # rebase the element's (standalone, 0-offset) blocks into the
            # system's molecule-slot and channel space
            blocks.extend(
                _Block(slot, b.source, b.getter, b.channel_lo + len(channels)) for b in element._blocks
            )
            channels += element.channels
        super().__init__(blocks, channels, channel_type)

    def run(self, mol_list: list, **kwargs) -> tuple[np.ndarray, np.ndarray]:
        return self._run(list(mol_list), **kwargs)

    def get_coords(self, mol_list: list) -> np.ndarray:
        return self._coords_of(list(mol_list))

    def get_channels(self, mol_list: list, out: np.ndarray | None = None, **kwargs) -> np.ndarray:
        return self._channels_of(list(mol_list), out, **kwargs)

    def get_features(self, mol_list: list, out: np.ndarray | None = None, **kwargs) -> np.ndarray:
        return self._features_of(list(mol_list), out, **kwargs)

    def get_types(self, mol_list: list, out: np.ndarray | None = None, **kwargs) -> np.ndarray:
        return self._types_of(list(mol_list), out, **kwargs)

    def split_channel(self, image) -> list[dict[str, Any]]:
        lo = 0
        result = []
        for element in self.maker_list:
            result.append(element.split_channel(image[lo : lo + element.num_channels]))
            lo += element.num_channels
        return result


class ComplexPointCloudMaker(MolSystemPointCloudMaker):
    """Ligand + protein two-molecule system (reference pointcloud.py:315-326)."""

    def __init__(
        self,
        ligand_atom_getter: AtomChannelGetter,
        ligand_bond_getter: BondChannelGetter | None,
        protein_atom_getter: AtomChannelGetter,
        protein_bond_getter: BondChannelGetter | None,
        channel_type: str = "features",
    ):
        super().__init__(
            (ligand_atom_getter, ligand_bond_getter),
            (protein_atom_getter, protein_bond_getter),
            channel_type=channel_type,
        )
