"""chrom.sizes files: two columns, name and size, tab separated."""

from __future__ import annotations


def read_chrom_sizes(path: str) -> dict[str, int]:
    """Read a chrom.sizes file preserving order (dicts are ordered)."""
    sizes: dict[str, int] = {}
    with open(path) as f:
        for line in f:
            w = line.split()
            if not w:
                continue
            name = w[0]
            if name in sizes:
                raise ValueError(f"Duplicate {name} in {path}")
            sizes[name] = int(w[1])
    return sizes


def write_chrom_sizes(sizes: dict[str, int], path: str) -> None:
    with open(path, "w") as f:
        for name, size in sizes.items():
            f.write(f"{name}\t{size}\n")
