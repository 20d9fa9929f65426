"""Index construction for the port, the suffix arrays on a torch device:
fmindex (FMIndex from texts), incremental (flush + merge), build (FASTA ->
.dsmi/.fmi, `indexes_from_fasta`).

`build_index` and `indexes_from_fasta` are loaded at first use: importing
`build` here would close an import cycle for a program whose first import
of the port is ops/rank.py (rank -> index.alphabet -> this package ->
build -> fmindex -> rank)."""

__all__ = ["build_index", "indexes_from_fasta"]


def __getattr__(name):
    if name in __all__:
        from . import build
        return getattr(build, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
