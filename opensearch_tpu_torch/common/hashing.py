"""Murmur3 x86_32 — the document-routing hash.

Wire-compatible with the reference's routing function
(server/src/main/java/org/opensearch/cluster/routing/Murmur3HashFunction.java):
the routing string is encoded as 2 little-endian bytes per UTF-16 code unit
and hashed with murmur3_x86_32 seed 0, so documents land on the same shard
number as they would in OpenSearch.
"""

from __future__ import annotations

_MASK32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def murmur3_x86_32(data: bytes, seed: int = 0) -> int:
    """Returns a signed 32-bit int, matching Java's MurmurHash3.hash32."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h1 = seed & _MASK32
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 4 : i * 4 + 4], "little")
        k1 = (k1 * c1) & _MASK32
        k1 = _rotl32(k1, 15)
        k1 = (k1 * c2) & _MASK32
        h1 ^= k1
        h1 = _rotl32(h1, 13)
        h1 = (h1 * 5 + 0xE6546B64) & _MASK32
    # tail
    k1 = 0
    tail = data[nblocks * 4 :]
    if len(tail) >= 3:
        k1 ^= tail[2] << 16
    if len(tail) >= 2:
        k1 ^= tail[1] << 8
    if len(tail) >= 1:
        k1 ^= tail[0]
        k1 = (k1 * c1) & _MASK32
        k1 = _rotl32(k1, 15)
        k1 = (k1 * c2) & _MASK32
        h1 ^= k1
    # finalization
    h1 ^= n
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _MASK32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _MASK32
    h1 ^= h1 >> 16
    # to signed
    return h1 - (1 << 32) if h1 >= (1 << 31) else h1


def routing_hash(routing: str) -> int:
    """Hash a routing string exactly like Murmur3HashFunction.hash(String).

    Java hashes the char[] as 2 LE bytes per UTF-16 code unit; Python's
    utf-16-le codec emits exactly that byte sequence (incl. surrogate pairs).
    """
    return murmur3_x86_32(routing.encode("utf-16-le"), 0)


def shard_id_for_routing(routing, num_shards: int) -> int:
    """OperationRouting: floorMod(hash(routing), num_shards)."""
    # numeric routing values arrive as ints via JSON
    return routing_hash(str(routing)) % num_shards
