"""Byte-level BPE tokenizer, GPT-2 / RoBERTa (counterpart of
tell_tpu/data/tokenizer.py: bytes_to_unicode, ByteBPE, RobertaTokenizer).

Token ids match HuggingFace/fairseq RoBERTa: <s>=0, <pad>=1, </s>=2,
<unk>=3, then the byte-BPE merges of a vocab.json/merges.txt pair.

GPT-2's pre-tokenizer is the regular expression

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+
    |\\s+(?!\\S)|\\s+   (one line)

which needs the third-party `regex` module for \\p{L} and \\p{N}. This
module imports neither it nor anything else outside the standard library:
`pretokenize` scans the text once with the same alternation, taking a
letter, number or white-space class from `unicodedata.category` and the
Unicode White_Space property. (`re`'s [^\\W\\d_] is not \\p{L}: it also
matches letter-like numbers such as ½ and Ⅻ.) RobertaTokenizer.from_files
encodes through the repository's C++ BPE (native/bpe.cpp, bound in
data/native.py) unless the caller asks for this Python ByteBPE
(use_native=False), which is its reference id for id.
"""
from __future__ import annotations

import functools
import json
import unicodedata

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

# Unicode's White_Space property: what \s matches in the `regex` module
# (str.isspace() also takes the separators U+001C..U+001F, \s does not)
_WHITE_SPACE = frozenset(map(chr, (
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
    *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F, 0x3000)))

_LETTER, _NUMBER, _SPACE, _OTHER = range(4)


@functools.lru_cache(maxsize=65536)
def _char_class(c: str) -> int:
    if c in _WHITE_SPACE:
        return _SPACE
    cat = unicodedata.category(c)
    if cat[0] == "L":
        return _LETTER
    if cat[0] == "N":
        return _NUMBER
    return _OTHER


def pretokenize(text: str) -> list[str]:
    """GPT-2's pre-tokenizer pieces of `text`, as
    regex.findall(<the pattern above>, text) returns them. The pieces
    concatenate to the text: every character belongs to one."""
    cls = [_char_class(c) for c in text]
    n = len(text)
    out = []
    i = 0
    while i < n:
        if text[i] == "'":
            c = next((c for c in _CONTRACTIONS if text.startswith(c, i)),
                     None)
            if c is not None:
                out.append(c)
                i += len(c)
                continue
        # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+': one optional
        # U+0020, then a run of one class
        start = i
        if text[i] == " " and i + 1 < n and cls[i + 1] != _SPACE:
            i += 1
        k = cls[i]
        if k != _SPACE:
            j = i + 1
            while j < n and cls[j] == k:
                j += 1
            out.append(text[start:j])
            i = j
            continue
        # '\s+(?!\S)', then '\s+': a white-space run; where text follows
        # it, its last character is left to lead the next piece (unless
        # the run is that one character)
        j = i + 1
        while j < n and cls[j] == _SPACE:
            j += 1
        if j < n and j - i > 1:
            j -= 1
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """The reversible byte <-> printable-unicode map of GPT-2: printable
    ASCII and two latin-1 ranges map to themselves, the other 68 bytes to
    256+i, so every byte is a visible character and merges act on str."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


class ByteBPE:
    """Byte-level BPE encoder over a vocab.json + merges.txt pair."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str) -> "ByteBPE":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        while len(word) > 1:
            best = min(_pairs(word),
                       key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            a, b = best
            out = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        result = list(word)
        if len(self._cache) < 500_000:
            self._cache[token] = result
        return result

    def _piece_ids(self, chunk: str, unk: int) -> list[int]:
        mapped = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
        return [self.encoder.get(tok, unk) for tok in self._bpe(mapped)]

    def encode(self, text: str) -> list[int]:
        unk = self.encoder.get("<unk>", 3)
        return [i for chunk in pretokenize(text)
                for i in self._piece_ids(chunk, unk)]

    def decode(self, ids) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text
                         if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")


class RobertaTokenizer:
    """RoBERTa framing over ByteBPE: <s> ... </s>, truncation to max_len
    (specials included), right padding with <pad>=1, and per-token entity
    masks for the copy readers."""

    BOS, PAD, EOS, UNK = 0, 1, 2, 3

    def __init__(self, bpe: ByteBPE, max_len: int = 512):
        self.bpe = bpe
        self.max_len = max_len

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str,
                   max_len: int = 512,
                   use_native: bool = True) -> "RobertaTokenizer":
        """use_native: encode through the C++ BPE (data/native.NativeBPE;
        its build raises if it fails), else through the Python ByteBPE."""
        bpe = ByteBPE.from_files(vocab_file, merges_file)
        if use_native:
            from .native import NativeBPE
            bpe = NativeBPE(bpe.encoder, sorted(bpe.ranks, key=bpe.ranks.get))
        return cls(bpe, max_len)

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        max_len = max_len or self.max_len
        ids = self.bpe.encode(text)[: max_len - 2]
        return [self.BOS] + ids + [self.EOS]

    def encode_with_spans(self, text: str,
                          entity_spans: list[tuple[int, int]],
                          max_len: int | None = None
                          ) -> tuple[list[int], list[int]]:
        """ids plus a 0/1 copy mask per token (1 = inside an entity span):
        encode_with_indexed_spans with every span's index 1."""
        return self.encode_with_indexed_spans(
            text, [(a, b, 1) for a, b in entity_spans], max_len)

    def encode_with_indexed_spans(self, text: str,
                                  entity_spans: list[tuple[int, int, int]],
                                  max_len: int | None = None
                                  ) -> tuple[list[int], list[int]]:
        """ids plus a per-entity int mask per token, decided per
        pre-tokenizer piece and inherited by each of its BPE tokens: a
        piece is inside span (start, end, idx) iff piece_start >= start -
        (1 if the piece begins with ' ' else 0) and piece_end <= end; later
        spans overwrite earlier ones; specials get 0. The pieces cover the
        text, so their offsets are the text's character offsets."""
        max_len = max_len or self.max_len
        ids: list[int] = []
        masks: list[int] = []
        pos = 0
        for chunk in pretokenize(text):
            start, end = pos, pos + len(chunk)
            pos = end
            idx = 0
            shift = 1 if chunk[0] == " " else 0
            for (a, b, i) in entity_spans:
                if start >= a - shift and end <= b:
                    idx = i
            piece = self.bpe._piece_ids(chunk, self.UNK)
            ids += piece
            masks += [idx] * len(piece)
        ids = ids[: max_len - 2]
        masks = masks[: max_len - 2]
        return [self.BOS] + ids + [self.EOS], [0] + masks + [0]

    def pad_masks(self, masks: list[int], length: int) -> list[int]:
        """Copy/proper masks pad with -1."""
        return masks[:length] + [-1] * max(0, length - len(masks))

    def pad(self, ids: list[int], length: int) -> list[int]:
        return ids[:length] + [self.PAD] * max(0, length - len(ids))

    def decode(self, ids, skip_special: bool = True) -> str:
        if skip_special:
            ids = [i for i in ids if int(i) > 3]
        return self.bpe.decode(ids)
