"""Table checkpointing: serialize built automaton/shift tables to .npz.

The reference rebuilds every preprocessing table on every run and on every
MPI rank (main.c:532-536 -> wu/wu.c:211; SURVEY.md §5 "Checkpoint/resume:
No ... preprocessing is recomputed every run").  Here table construction —
which for 100k patterns x m=32 means millions of trie states — can be done
once, saved, and memory-mapped back, so production scans skip the build.

Works generically over every table dataclass in smatcher.automata plus
ops.fast.FastTables: array fields are stored as npz entries, scalar/None
fields in a JSON header, and device arrays (jax) round-trip through numpy.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

#: registry of checkpointable table classes, by class name
_REGISTRY = {}


def _classes():
    if not _REGISTRY:
        from smatcher.automata import (
            ACTables, SHTables, SBOMTables, WMTables, SOGTables, VerifyTables)
        from smatcher.ops.fast import FastTables
        for cls in (ACTables, SHTables, SBOMTables, WMTables, SOGTables,
                    VerifyTables, FastTables):
            _REGISTRY[cls.__name__] = cls
    return _REGISTRY


def _is_array(v) -> bool:
    return hasattr(v, "shape") and hasattr(v, "dtype")


def save_tables(path, tables) -> None:
    """Serialize one table dataclass (or a dict of name -> dataclass)."""
    if not isinstance(tables, dict):
        tables = {"tables": tables}
    arrays = {}
    header = {}
    for name, tb in tables.items():
        cls = type(tb).__name__
        if cls not in _classes():
            raise TypeError(f"not a checkpointable table class: {cls}")
        scalars = {}
        fields = []
        for f in dataclasses.fields(tb):
            v = getattr(tb, f.name)
            if _is_array(v):
                arrays[f"{name}/{f.name}"] = np.asarray(v)
                fields.append([f.name, "array"])
            elif isinstance(v, tuple) and all(_is_array(x) for x in v):
                for i, x in enumerate(v):
                    arrays[f"{name}/{f.name}.{i}"] = np.asarray(x)
                fields.append([f.name, f"tuple:{len(v)}"])
            else:
                scalars[f.name] = v
                fields.append([f.name, "scalar"])
        header[name] = {"class": cls, "fields": fields, "scalars": scalars}
    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_tables(path, *, device: bool | None = None):
    """Inverse of save_tables. Returns the dataclass (or dict of them).

    device=True puts array fields on the default JAX device; None (default)
    restores FastTables fields (built device-resident) to device and leaves
    numpy-table classes as numpy.
    """
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        out = {}
        for name, spec in header.items():
            cls = _classes()[spec["class"]]
            want_dev = device if device is not None else cls.__name__ == "FastTables"
            if want_dev:
                import jax.numpy as jnp
                conv = jnp.asarray
            else:
                conv = lambda x: x
            kw = dict(spec["scalars"])
            for fname, kind in spec["fields"]:
                if kind == "array":
                    kw[fname] = conv(z[f"{name}/{fname}"])
                elif kind.startswith("tuple:"):
                    k = int(kind.split(":")[1])
                    kw[fname] = tuple(conv(z[f"{name}/{fname}.{i}"])
                                      for i in range(k))
            out[name] = cls(**kw)
    return out["tables"] if list(out) == ["tables"] else out
