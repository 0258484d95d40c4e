"""The port's Python launch counts, in one registry.

A wrapper that launches device work counts its launches in attributes
of an object (``integrate_blocks_cuda.launches``, ``MapAxis.calls``) and
registers those attributes here.  A CUDA graph replays the launches
without running the wrappers' Python, so ``models/captured.CapturedStep``
reads every registered count around its capture and adds what the
capture counted on each replay: a count registered here stays the number
of launches that ran, captured or not.
"""

from __future__ import annotations

import weakref

# owner -> (label, attribute names); an owner that is collected leaves.
_OWNERS = weakref.WeakKeyDictionary()


def register(owner, label: str, *attrs: str) -> None:
    """Make ``owner``'s integer attributes ``attrs`` registered counts,
    named ``label.attr``."""
    _OWNERS[owner] = (label, attrs)


def read() -> dict:
    """(owner, attribute) -> value of every registered count."""
    return {(o, a): getattr(o, a) for o, (_, attrs) in list(_OWNERS.items()) for a in attrs}


def name(owner, attr: str) -> str:
    return f"{_OWNERS[owner][0]}.{attr}"
