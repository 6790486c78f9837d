"""Order-preserving storage keys — a copy of
``nebula_tpu/common/keys.py:21-128`` (``KeyUtils`` and ``id_hash``), so
the port's store writes byte-equal keys.

    vertex key: part(4) | vid(8) | tagId(4) | version(8)
    edge   key: part(4) | src(8) | edgeType(4) | rank(8) | dst(8) | version(8)

Signed fields are packed big-endian with a sign flip, so plain
lexicographic byte order equals logical order and a prefix scan walks
edges in (src, etype, rank, dst, version) order.  Versions are inverted
timestamps (``common/clock.inverted_version``): the latest version of
one identity sorts first.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

_SIGN64 = 1 << 63
_SIGN32 = 1 << 31

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")


def _enc64(v: int) -> bytes:
    """Order-preserving encode of a signed 64-bit int (sign-flip + BE)."""
    return _U64.pack((v + _SIGN64) & 0xFFFFFFFFFFFFFFFF)


def _dec64(b: bytes) -> int:
    return _U64.unpack(b)[0] - _SIGN64


def _enc32(v: int) -> bytes:
    return _U32.pack((v + _SIGN32) & 0xFFFFFFFF)


def _dec32(b: bytes) -> int:
    return _U32.unpack(b)[0] - _SIGN32


class KeyUtils:
    VERTEX_LEN = 4 + 8 + 4 + 8
    EDGE_LEN = 4 + 8 + 4 + 8 + 8 + 8

    # ---- builders ----------------------------------------------------
    @staticmethod
    def vertex_key(part: int, vid: int, tag_id: int, version: int) -> bytes:
        return _enc32(part) + _enc64(vid) + _enc32(tag_id) + _enc64(version)

    @staticmethod
    def edge_key(part: int, src: int, edge_type: int, rank: int, dst: int,
                 version: int) -> bytes:
        return (_enc32(part) + _enc64(src) + _enc32(edge_type) +
                _enc64(rank) + _enc64(dst) + _enc64(version))

    # ---- prefixes ----------------------------------------------------
    @staticmethod
    def part_prefix(part: int) -> bytes:
        return _enc32(part)

    @staticmethod
    def vertex_prefix(part: int, vid: int, tag_id: Optional[int] = None) -> bytes:
        p = _enc32(part) + _enc64(vid)
        if tag_id is not None:
            p += _enc32(tag_id)
        return p

    @staticmethod
    def edge_prefix(part: int, src: int, edge_type: Optional[int] = None,
                    rank: Optional[int] = None, dst: Optional[int] = None) -> bytes:
        comps = (edge_type, rank, dst)
        first_none = next((i for i, c in enumerate(comps) if c is None), 3)
        if any(c is not None for c in comps[first_none:]):
            raise ValueError("edge_prefix components must be contiguous "
                             f"(got edge_type={edge_type}, rank={rank}, dst={dst})")
        p = _enc32(part) + _enc64(src)
        if edge_type is not None:
            p += _enc32(edge_type)
            if rank is not None:
                p += _enc64(rank)
                if dst is not None:
                    p += _enc64(dst)
        return p

    # ---- predicates / parsers ---------------------------------------
    @staticmethod
    def is_vertex(key: bytes) -> bool:
        # Tags have positive ids, edges negative-or-positive etype at the
        # same offset but different total length — length disambiguates.
        return len(key) == KeyUtils.VERTEX_LEN

    @staticmethod
    def is_edge(key: bytes) -> bool:
        return len(key) == KeyUtils.EDGE_LEN

    @staticmethod
    def parse_vertex(key: bytes) -> Tuple[int, int, int, int]:
        """-> (part, vid, tag_id, version)"""
        return (_dec32(key[0:4]), _dec64(key[4:12]),
                _dec32(key[12:16]), _dec64(key[16:24]))

    @staticmethod
    def parse_edge(key: bytes) -> Tuple[int, int, int, int, int, int]:
        """-> (part, src, edge_type, rank, dst, version)"""
        return (_dec32(key[0:4]), _dec64(key[4:12]), _dec32(key[12:16]),
                _dec64(key[16:24]), _dec64(key[24:32]), _dec64(key[32:40]))

    @staticmethod
    def get_part(key: bytes) -> int:
        return _dec32(key[0:4])


def id_hash(vid: int, num_parts: int) -> int:
    """vid -> partition id in [1, num_parts].

    Mirrors the reference's ID_HASH (StorageClient.cpp:10-11): unsigned
    modulo so negative vids still land in a valid part.
    """
    return (vid & 0xFFFFFFFFFFFFFFFF) % num_parts + 1
