"""BPE tokenizer over SentencePiece models + segment splitting.

Mirrors the reference `TextTokenizer` surface (`utils/front.py:231-436`):
CJK-char pre-tokenization (uppercased), sentencepiece-BPE encoding, and
punctuation-aware segment splitting with greedy merge.  The BPE encoder is a
native implementation over the parsed `.model` protobuf
(`voice_tts_tpu_torch.text.sp_model`) — sentencepiece itself is not a dependency.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Optional, Sequence, Union

from voice_tts_tpu_torch.text import sp_model
from voice_tts_tpu_torch.text.sp_model import Piece, PieceType

_WS = "▁"  # sentencepiece space marker

# CJK ranges from nltk's tokenize util (same table the reference uses,
# `utils/common.py:46-48`)
CJK_RANGE_PATTERN = (
    "([\\u1100-\\u11ff\\u2e80-\\ua4cf\\ua840-\\uD7AF\\uF900-\\uFAFF"
    "\\uFE30-\\uFE4F\\uFF65-\\uFFDC\\U00020000-\\U0002FFFF])"
)


def tokenize_by_cjk_char(line: str, do_upper_case: bool = True) -> str:
    """'你好是 hello' -> '你 好 是 HELLO' (reference `utils/common.py:28-51`)."""
    chars = re.split(CJK_RANGE_PATTERN, line.strip())
    return " ".join(w.strip().upper() if do_upper_case else w.strip()
                    for w in chars if w.strip())


def de_tokenize_by_cjk_char(line: str, do_lower_case: bool = False) -> str:
    """Inverse of the above (reference `utils/common.py:54-81`)."""
    english_word_pattern = re.compile(r"([A-Z]+(?:[\s-][A-Z-]+)*)", re.IGNORECASE)
    english_sents = english_word_pattern.findall(line)
    for i, sent in enumerate(english_sents):
        line = line.replace(sent, f"<sent_{i}>")
    words = line.split()
    placeholder = re.compile(r"^.*?(<sent_(\d+)>)")
    for i in range(len(words)):
        m = placeholder.match(words[i])
        if m:
            idx = int(m.group(2))
            words[i] = words[i].replace(m.group(1), english_sents[idx])
            if do_lower_case:
                words[i] = words[i].lower()
    return "".join(words)


class SentencePieceBPE:
    """Greedy highest-score-pair BPE over a SentencePiece vocabulary."""

    def __init__(self, pieces: Sequence[Piece], add_dummy_prefix: bool = True):
        self.pieces = list(pieces)
        self.vocab = {p.piece: i for i, p in enumerate(self.pieces)}
        self.scores = {p.piece: p.score for p in self.pieces}
        self.add_dummy_prefix = add_dummy_prefix
        self._unk_id = next(
            (i for i, p in enumerate(self.pieces) if p.type == PieceType.UNKNOWN), 0)
        self._byte_ids = {p.piece: i for i, p in enumerate(self.pieces)
                          if p.type == PieceType.BYTE}
        self._control = {p.piece for p in self.pieces
                         if p.type in (PieceType.CONTROL, PieceType.UNKNOWN)}

    @classmethod
    def load(cls, path: str) -> "SentencePieceBPE":
        with open(path, "rb") as f:
            return cls(sp_model.parse_model(f.read()))

    # -- vocabulary surface --------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def unk_id(self) -> int:
        return self._unk_id

    def piece_to_id(self, piece: str) -> int:
        return self.vocab.get(piece, self._unk_id)

    def id_to_piece(self, idx: Union[int, List[int]]):
        if isinstance(idx, list):
            return [self.pieces[i].piece for i in idx]
        return self.pieces[idx].piece

    # -- encoding -------------------------------------------------------
    def _merge(self, symbols: List[str]) -> List[str]:
        """Greedy BPE: repeatedly merge the adjacent pair with the highest
        vocabulary score (sentencepiece BPE semantics)."""
        while len(symbols) > 1:
            best = None
            for i in range(len(symbols) - 1):
                cand = symbols[i] + symbols[i + 1]
                score = self.scores.get(cand)
                if score is None:
                    continue
                if best is None or score > best[0]:
                    best = (score, i, cand)
            if best is None:
                break
            _, i, cand = best
            symbols = symbols[:i] + [cand] + symbols[i + 2:]
        return symbols

    def encode_pieces(self, text: str) -> List[str]:
        if not text:
            return []
        text = unicodedata.normalize("NFKC", text)
        text = re.sub(r"\s+", " ", text)
        if self.add_dummy_prefix:
            text = " " + text.lstrip(" ")
        text = text.replace(" ", _WS)

        out: List[str] = []
        symbols = [ch for ch in text]
        # merge within the whole sequence (sp BPE merges across the dummy
        # prefix boundary too, since _WS is an ordinary symbol)
        merged = self._merge(symbols)
        for sym in merged:
            if sym in self.vocab:
                out.append(sym)
            else:
                # byte fallback when available, else per-char unk
                encoded = False
                if self._byte_ids:
                    for byte in sym.encode("utf-8"):
                        out.append(f"<0x{byte:02X}>")
                    encoded = True
                if not encoded:
                    out.append(sym)  # stays unknown at id-conversion time
        return out

    def encode(self, text: str) -> List[int]:
        return [self.piece_to_id(p) for p in self.encode_pieces(text)]

    def decode_pieces(self, pieces: List[str]) -> str:
        text = "".join(p for p in pieces if p not in self._control)
        return text.replace(_WS, " ").strip()

    def decode(self, ids: List[int]) -> str:
        return self.decode_pieces([self.pieces[i].piece for i in ids])


class TextTokenizer:
    """Normalizer + CJK pre-tokenizer + BPE + segmentation
    (reference `utils/front.py:231-436`)."""

    punctuation_marks_tokens = [".", "!", "?", f"{_WS}.", f"{_WS}?", f"{_WS}..."]

    def __init__(self, sp: SentencePieceBPE, normalizer=None):
        self.sp = sp
        self.normalizer = normalizer

    @property
    def vocab_size(self) -> int:
        return self.sp.vocab_size

    @property
    def unk_token_id(self) -> int:
        return self.sp.unk_id()

    def convert_tokens_to_ids(self, tokens: Union[str, List[str]]) -> List[int]:
        if isinstance(tokens, str):
            tokens = [tokens]
        return [self.sp.piece_to_id(t) for t in tokens]

    def convert_ids_to_tokens(self, ids: Union[int, List[int]]):
        return self.sp.id_to_piece(ids)

    def tokenize(self, text: str) -> List[str]:
        if len(text) == 0:
            return []
        if len(text.strip()) == 1:
            return self.sp.encode_pieces(text)
        if self.normalizer:
            text = self.normalizer.normalize(text)
        text = tokenize_by_cjk_char(text)
        return self.sp.encode_pieces(text)

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def decode(self, ids: List[int], do_lower_case: bool = False) -> str:
        return de_tokenize_by_cjk_char(self.sp.decode(list(ids)),
                                       do_lower_case=do_lower_case)

    # -- segmentation ---------------------------------------------------
    @staticmethod
    def split_segments_by_token(tokenized: List[str], split_tokens: List[str],
                                max_tokens: int,
                                quick_streaming_tokens: int = 0) -> List[List[str]]:
        """Behavioural port of `TextTokenizer.split_segments_by_token`
        (reference `utils/front.py:313-430`): split at punctuation, fall back
        to comma then hyphen, hard-split oversize runs, then greedily merge
        adjacent segments under the limit."""
        if not tokenized:
            return []
        comma_tokens = [",", f"{_WS},"]
        segments: List[List[str]] = []
        current: List[str] = []
        i = 0
        while i < len(tokenized):
            token = tokenized[i]
            current.append(token)
            use_sub = None
            if (not any(t in split_tokens for t in comma_tokens)
                    and any(t in current for t in comma_tokens)):
                use_sub = comma_tokens
            elif "-" not in split_tokens and "-" in current:
                use_sub = ["-"]
            elif len(current) <= max_tokens:
                if token in split_tokens and len(current) > 2:
                    if i + 1 < len(tokenized) and tokenized[i + 1] in ("'", f"{_WS}'"):
                        current.append(tokenized[i + 1])
                        i += 1
                    segments.append(current)
                    current = []
                i += 1
                continue
            if use_sub is not None:
                subs = TextTokenizer.split_segments_by_token(
                    current, use_sub, max_tokens, quick_streaming_tokens)
            else:
                subs = [current[j:j + max_tokens]
                        for j in range(0, len(current), max_tokens)]
            segments.extend(subs)
            current = []
            i += 1
        if current:
            segments.append(current)

        merged: List[List[str]] = []
        total = 0
        for seg in segments:
            total += len(seg)
            if not seg:
                continue
            if not merged:
                merged.append(seg)
            elif (len(merged[-1]) + len(seg) <= max_tokens
                  and total > quick_streaming_tokens):
                merged[-1] = merged[-1] + seg
            elif len(merged[-1]) + len(seg) <= max_tokens / 2:
                merged[-1] = merged[-1] + seg
            else:
                merged.append(seg)
        return merged

    def split_segments(self, tokenized: List[str],
                       max_text_tokens_per_segment: int = 120,
                       quick_streaming_tokens: int = 0) -> List[List[str]]:
        return self.split_segments_by_token(
            tokenized, self.punctuation_marks_tokens,
            max_text_tokens_per_segment, quick_streaming_tokens)
