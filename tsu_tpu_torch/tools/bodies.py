"""Build versions of a kernel source and let them take turns on one card.

The body tools (``bond_bodies``, ``resident_bodies``) time two or more
versions of one CUDA source, for instance a parent commit's and this
tree's, in one process on one card. ``build_versions`` builds each with the
port's nvcc flags (``ops/_build.py``) under its own name and loads it;
``in_turns`` orders the timed rounds so that a drift of the card falls on
every version alike: forward in even rounds, backward in odd ones.
"""

from __future__ import annotations

from pathlib import Path

from tsu_tpu_torch.ops import _build


def build_versions(sources, prefix: str, load) -> dict:
    """{source: load(path of its build)} for every source file, each built
    as ``<prefix>_<i>``."""
    return {src: load(_build.library_path(f"{prefix}_{i}", (str(Path(src).resolve()),)))
            for i, src in enumerate(sources)}


def in_turns(names, rounds: int):
    """(round, name) pairs: every name once a round, forward in even rounds
    and backward in odd ones."""
    names = list(names)
    for rnd in range(rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            yield rnd, name
