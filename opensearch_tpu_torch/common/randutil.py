"""Injectable entropy, the RNG twin of timeutil's injectable clock.

Counterpart of opensearch_tpu/common/randutil.py, a copy with its imports
rewritten. Code that mints ids calls :func:`uuid4` / :func:`urandom` /
:func:`token_hex` here; a deterministic run installs a seeded
``random.Random`` through :func:`set_rng` / :func:`rng_scope`, making
every id a pure function of the seed.
"""

from __future__ import annotations

import contextlib
import random as _random
import uuid as _uuid
from typing import Iterator

# the default draws from a SystemRandom-seeded instance: production ids
# stay unpredictable-enough for correlation ids (they are NOT secrets —
# anything security-sensitive must keep using the `secrets` module, which
# is why only id-minting code calls these)
_SYSTEM_RNG = _random.Random(_random.SystemRandom().getrandbits(64))
_rng: _random.Random = _SYSTEM_RNG


def get_rng() -> _random.Random:
    return _rng


def set_rng(rng: _random.Random | None) -> _random.Random:
    """Install `rng` (None restores the system-seeded default); returns
    the previously active instance so callers can restore it."""
    global _rng
    previous = _rng
    _rng = rng if rng is not None else _SYSTEM_RNG
    return previous


@contextlib.contextmanager
def rng_scope(rng: _random.Random) -> Iterator[_random.Random]:
    """``with rng_scope(queue.random):`` — seeded entropy for a block."""
    previous = set_rng(rng)
    try:
        yield rng
    finally:
        set_rng(previous)


def uuid4() -> _uuid.UUID:
    """Drop-in ``uuid.uuid4()``: a version-4 UUID from the injected RNG."""
    return _uuid.UUID(int=_rng.getrandbits(128), version=4)


def urandom(n: int) -> bytes:
    """Drop-in ``os.urandom(n)`` from the injected RNG."""
    return _rng.getrandbits(8 * n).to_bytes(n, "big") if n > 0 else b""


def token_hex(nbytes: int = 32) -> str:
    """Drop-in ``secrets.token_hex(n)`` from the injected RNG (NOT
    cryptographically secure — correlation ids only)."""
    return urandom(nbytes).hex()
