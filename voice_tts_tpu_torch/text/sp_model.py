"""Minimal SentencePiece `.model` (protobuf) reader — no sentencepiece dep.

Parses just enough of the ModelProto wire format to drive BPE encoding:
repeated field 1 = SentencePiece { 1: piece (string), 2: score (float),
3: type (enum) }.  The reference loads the same artifact through the
sentencepiece C++ library (`utils/front.py:240`).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from enum import IntEnum
from typing import Dict, List, Tuple


class PieceType(IntEnum):
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


@dataclass
class Piece:
    piece: str
    score: float
    type: PieceType = PieceType.NORMAL


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        size, pos = _read_varint(buf, pos)
        pos += size
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _parse_sentence_piece(buf: bytes) -> Piece:
    pos = 0
    piece, score, ptype = "", 0.0, PieceType.NORMAL
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:
            size, pos = _read_varint(buf, pos)
            piece = buf[pos:pos + size].decode("utf-8")
            pos += size
        elif field == 2 and wt == 5:
            score = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif field == 3 and wt == 0:
            val, pos = _read_varint(buf, pos)
            ptype = PieceType(val)
        else:
            pos = _skip_field(buf, pos, wt)
    return Piece(piece, score, ptype)


def parse_model(data: bytes) -> List[Piece]:
    pieces: List[Piece] = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:
            size, pos = _read_varint(data, pos)
            pieces.append(_parse_sentence_piece(data[pos:pos + size]))
            pos += size
        else:
            pos = _skip_field(data, pos, wt)
    return pieces


# ---------------------------------------------------------------------------
# writer (for tests / synthetic vocabularies)
# ---------------------------------------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def serialize_model(pieces: List[Piece]) -> bytes:
    out = bytearray()
    for p in pieces:
        body = bytearray()
        enc = p.piece.encode("utf-8")
        body += _varint((1 << 3) | 2) + _varint(len(enc)) + enc
        body += _varint((2 << 3) | 5) + struct.pack("<f", p.score)
        body += _varint((3 << 3) | 0) + _varint(int(p.type))
        out += _varint((1 << 3) | 2) + _varint(len(body)) + bytes(body)
    return bytes(out)
