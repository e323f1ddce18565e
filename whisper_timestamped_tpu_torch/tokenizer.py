"""Byte-level BPE tokenizer with the Whisper special-token layout.

Copy of ``whisper_timestamped_tpu/tokenizer.py`` (which cannot be imported
without JAX: that package's ``__init__`` loads its JAX audio module), with
its C++ BPE core from the port's own ``native.py``. Framework-free.

A self-contained replacement for the tokenizer the reference inherits from
``openai-whisper`` (tiktoken-based; re-exported at reference
``whisper_timestamped/__init__.py:5``). Pure Python by default; vocabularies
load from tiktoken ``.tiktoken`` files, HF ``vocab.json``+``merges.txt``, or an
explicit rank dict — nothing is downloaded.

The special-token layout is computed from the base-vocabulary size and the
language count, reproducing the official layouts exactly:

    english  (n_base=50256, 99 langs): eot=50256 sot=50257 ts_begin=50363
    multi v2 (n_base=50257, 99 langs): eot=50257 sot=50258 ts_begin=50364
    multi v3 (n_base=50257, 100 langs): ts_begin=50365
"""

from __future__ import annotations

import base64
import functools
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .languages import LANGUAGES, normalize_language

# Same text-splitting pattern family as GPT-2/tiktoken (requires the `regex` module).
_SPLIT_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@functools.lru_cache(maxsize=1)
def _compiled_pattern():
    import regex

    return regex.compile(_SPLIT_PATTERN)


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's printable-unicode byte mapping (for HF vocab.json files)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class BytePairEncoder:
    """Minimal tiktoken-style byte-pair encoder over ``bytes -> rank`` tables."""

    def __init__(self, ranks: Dict[bytes, int]):
        self.ranks = ranks
        self.id_to_bytes: Dict[int, bytes] = {v: k for k, v in ranks.items()}
        self.n_vocab = max(ranks.values()) + 1 if ranks else 0
        self._native = None  # lazily-built C++ core (native.py), or False

    def _native_core(self):
        if self._native is None:
            try:
                from .native import NativeBPE, available

                self._native = NativeBPE(self.ranks) if available() else False
            except Exception:
                self._native = False
        return self._native

    def _bpe_merge(self, piece: bytes) -> List[int]:
        ranks = self.ranks
        if piece in ranks:
            return [ranks[piece]]
        parts = [piece[i : i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for p in parts:
            if p not in ranks:
                raise KeyError(f"byte sequence {p!r} not in vocabulary")
            out.append(ranks[p])
        return out

    def encode(self, text: str) -> List[int]:
        native = self._native_core()
        merge = native.encode_piece if native else self._bpe_merge
        ids: List[int] = []
        for piece in _compiled_pattern().findall(text):
            ids.extend(merge(piece.encode("utf-8")))
        return ids

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        return b"".join(self.id_to_bytes.get(int(i), b"") for i in ids)

    def decode(self, ids: Sequence[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# Vocabulary loading
# ---------------------------------------------------------------------------


def load_tiktoken_ranks(path: str) -> Dict[bytes, int]:
    """Read a tiktoken vocabulary file (base64-token<space>rank lines)."""
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
    return ranks


def load_hf_vocab_ranks(vocab_json_path: str) -> Dict[bytes, int]:
    """Convert an HF byte-level ``vocab.json`` to byte ranks."""
    with open(vocab_json_path, encoding="utf-8") as f:
        vocab = json.load(f)
    u2b = {c: bytes([b]) for b, c in _bytes_to_unicode().items()}
    ranks: Dict[bytes, int] = {}
    for token, idx in vocab.items():
        if token.startswith("<|") and token.endswith("|>"):
            continue  # specials are synthesized from the layout
        try:
            ranks[b"".join(u2b[ch] for ch in token)] = int(idx)
        except KeyError:
            continue  # non-byte-level entry (e.g. an added special)
    return ranks


# ---------------------------------------------------------------------------
# Whisper tokenizer
# ---------------------------------------------------------------------------


@dataclass
class Tokenizer:
    """Whisper tokenizer: BPE + special-token layout + task/language sequences."""

    bpe: BytePairEncoder
    multilingual: bool = True
    num_languages: int = 99
    language: Optional[str] = None
    task: Optional[str] = None
    _specials: Dict[str, int] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        n_base = self.bpe.n_vocab
        langs = list(LANGUAGES.keys())[: self.num_languages]
        s: Dict[str, int] = {"<|endoftext|>": n_base, "<|startoftranscript|>": n_base + 1}
        for i, code in enumerate(langs):
            s[f"<|{code}|>"] = n_base + 2 + i
        off = n_base + 2 + len(langs)
        for name in ("<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>"):
            s[name] = off
            off += 1
        self._timestamp_begin = off
        self._specials = s
        self._id_to_special = {v: k for k, v in s.items()}
        self._lang_codes = langs
        if self.language is not None:
            self.language = normalize_language(self.language)

    # --- special token ids -------------------------------------------------
    @property
    def eot(self) -> int:
        return self._specials["<|endoftext|>"]

    @property
    def sot(self) -> int:
        return self._specials["<|startoftranscript|>"]

    @property
    def translate(self) -> int:
        return self._specials["<|translate|>"]

    @property
    def transcribe(self) -> int:
        return self._specials["<|transcribe|>"]

    @property
    def sot_lm(self) -> int:
        return self._specials["<|startoflm|>"]

    @property
    def sot_prev(self) -> int:
        return self._specials["<|startofprev|>"]

    @property
    def no_speech(self) -> int:
        return self._specials["<|nospeech|>"]

    @property
    def no_timestamps(self) -> int:
        return self._specials["<|notimestamps|>"]

    @property
    def timestamp_begin(self) -> int:
        return self._timestamp_begin

    @property
    def n_vocab(self) -> int:
        # 1501 timestamp tokens: <|0.00|> .. <|30.00|>
        return self._timestamp_begin + 1501

    def special_id(self, token: str) -> Optional[int]:
        return self._specials.get(token)

    # --- languages ----------------------------------------------------------
    @property
    def all_language_tokens(self) -> Tuple[int, ...]:
        return tuple(self._specials[f"<|{c}|>"] for c in self._lang_codes)

    @property
    def all_language_codes(self) -> Tuple[str, ...]:
        return tuple(self._lang_codes)

    def to_language_token(self, language: str) -> int:
        code = normalize_language(language)
        tok = self._specials.get(f"<|{code}|>")
        if tok is None:
            raise KeyError(f"language {language!r} not in this tokenizer's vocabulary")
        return tok

    @property
    def language_token(self) -> int:
        if self.language is None:
            raise ValueError("tokenizer has no language set")
        return self.to_language_token(self.language)

    # --- sot sequences --------------------------------------------------------
    @property
    def sot_sequence(self) -> Tuple[int, ...]:
        """openai-whisper semantics: the language token appears only when a
        language is set, the task token only when a task is set."""
        seq = [self.sot]
        if self.multilingual:
            if self.language is not None:
                seq.append(self.to_language_token(self.language))
            if self.task is not None:
                seq.append(self.translate if self.task == "translate" else self.transcribe)
        return tuple(seq)

    @property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return self.sot_sequence + (self.no_timestamps,)

    # --- encode / decode ------------------------------------------------------
    def encode(self, text: str, allowed_special=None) -> List[int]:
        """``allowed_special`` mirrors tiktoken: "all" (or a set of special
        token strings) maps occurrences of those specials to their ids
        instead of byte-BPE-ing the literal "<|...|>" text. tiktoken/whisper
        registers all 1501 timestamp strings (``<|0.00|>``..``<|30.00|>``) as
        specials too, so those resolve to timestamp ids here."""
        if not allowed_special:
            return self.bpe.encode(text)
        allow_all = allowed_special == "all"
        allowed = set() if allow_all else set(allowed_special)

        def special_id(s: str):
            tok_id = self._specials.get(s)
            if tok_id is not None:
                return tok_id if (allow_all or s in allowed) else None
            ts = re.fullmatch(r"<\|(\d{1,2})\.(\d{2})\|>", s)
            if ts is None or not (allow_all or s in allowed):
                return None
            cents = int(ts.group(1)) * 100 + int(ts.group(2))
            # only exact 20 ms multiples up to 30.00 are registered specials
            if cents % 2 == 0 and cents <= 3000:
                return self._timestamp_begin + cents // 2
            return None

        out: List[int] = []
        pos = 0
        for m in re.finditer(r"<\|[^<>|]*\|>", text):
            tok_id = special_id(m.group(0))
            if tok_id is None:
                continue
            out.extend(self.bpe.encode(text[pos : m.start()]))
            out.append(tok_id)
            pos = m.end()
        out.extend(self.bpe.encode(text[pos:]))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        """Decode, skipping special & timestamp tokens (like whisper's decode)."""
        kept = [int(i) for i in ids if int(i) < self.eot]
        return self.bpe.decode(kept)

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        kept = [int(i) for i in ids if int(i) < self.eot]
        return self.bpe.decode_bytes(kept)

    def decode_with_timestamps(self, ids: Sequence[int]) -> str:
        parts: List[str] = []
        run: List[int] = []
        for i in ids:
            i = int(i)
            if i >= self.timestamp_begin:
                if run:
                    parts.append(self.bpe.decode(run))
                    run = []
                parts.append(f"<|{(i - self.timestamp_begin) * 0.02:.2f}|>")
            elif i >= self.eot:
                if run:
                    parts.append(self.bpe.decode(run))
                    run = []
                parts.append(self._id_to_special.get(i, ""))
            else:
                run.append(i)
        if run:
            parts.append(self.bpe.decode(run))
        return "".join(parts)

    def timestamp_to_time(self, token: int) -> float:
        return (int(token) - self.timestamp_begin) * 0.02

    # --- suppression lists ------------------------------------------------------
    @functools.cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids of sound-effect/annotation symbols, suppressed during decoding.

        Same construction as openai-whisper's ``Tokenizer.non_speech_tokens``
        (the list the reference relies on through ``get_logit_filters``,
        reference ``transcribe.py:1371-1393``).
        """
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        miscellaneous = set("♩♪♫♬♭♮♯")
        assert all(0x2640 <= ord(c) <= 0x267F for c in miscellaneous)

        result = set()
        for t in (self.encode(" -"), self.encode(" '")):
            if t:
                result.add(t[0])
        for symbol in symbols + list(miscellaneous):
            for tokens in (self.encode(symbol), self.encode(" " + symbol)):
                if not tokens:
                    continue
                if len(tokens) == 1 or symbol in miscellaneous:
                    result.add(tokens[0])
        return tuple(sorted(result))

    @property
    def is_multilingual(self) -> bool:
        return self.multilingual


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def get_tokenizer(
    multilingual: bool = True,
    *,
    num_languages: int = 99,
    language: Optional[str] = None,
    task: Optional[str] = None,
    vocab_path: Optional[str] = None,
    ranks: Optional[Dict[bytes, int]] = None,
) -> Tokenizer:
    """Build a Whisper tokenizer from an explicit vocabulary source.

    ``vocab_path`` may be a ``.tiktoken`` file, an HF ``vocab.json``, or a
    directory containing either (for HF vocabs the merge ranks are derived
    from the token ids, which matches GPT-2-style vocabularies where id order
    is merge-priority order). ``ranks`` overrides with an explicit
    byte→rank dict.
    """
    if ranks is None:
        if vocab_path is None:
            raise ValueError(
                "A vocabulary is required: pass vocab_path= (a .tiktoken file or "
                "an HF tokenizer directory) or ranks=. Nothing is downloaded."
            )
        if os.path.isdir(vocab_path):
            # honor the multilingual flag: *.en models must get gpt2.tiktoken
            # (50256 base tokens) — the multilingual vocab has one more entry
            # and would shift every special/timestamp id by one
            order = (
                ("multilingual.tiktoken", "gpt2.tiktoken", "vocab.json")
                if multilingual
                else ("gpt2.tiktoken", "multilingual.tiktoken", "vocab.json")
            )
            for cand in order:
                p = os.path.join(vocab_path, cand)
                if os.path.exists(p):
                    vocab_path = p
                    break
        if vocab_path.endswith(".tiktoken"):
            ranks = load_tiktoken_ranks(vocab_path)
        elif vocab_path.endswith(".json"):
            ranks = load_hf_vocab_ranks(vocab_path)
        else:
            raise ValueError(f"Unrecognized vocabulary file: {vocab_path}")
    return Tokenizer(
        bpe=BytePairEncoder(ranks),
        multilingual=multilingual,
        num_languages=num_languages,
        language=language,
        task=task,
    )


def synthetic_ranks(n_merges: int = 64, seed: int = 0) -> Dict[bytes, int]:
    """A tiny but fully functional byte-level vocabulary (for tests/demos).

    All 256 single bytes plus a few deterministic ASCII merges, so any text
    round-trips and multi-byte UTF-8 splits across tokens (exercising the
    incremental-decode/U+FFFD logic the reference tests at
    ``tests/test_transcribe.py:686-902``).
    """
    ranks: Dict[bytes, int] = {bytes([i]): i for i in range(256)}
    # Every multi-byte token splits into two earlier-known tokens, so the same
    # table is expressible as an ordered HF merges list (tests rely on this).
    common = [
        b" t", b" a", b"he", b"in", b"re", b"on", b" s", b"er", b"at", b"en",
        b"ou", b" w", b" b", b"es", b" c", b"it", b"is", b"an", b"or", b" p",
        b" f", b" m", b" d", b"ar", b"ll", b" o", b"ed", b" l", b"st", b" g",
        b"se", b" n", b"le", b"ve", b"nt", b"ha", b"to", b"om", b"nd", b"ur",
        b"ce", b"al", b"ay", b"ow", b"ld", b" y", b"gh", b"jo", b"lo",
        b" th", b" the", b" he", b"ing", b" you", b" yes", b" no", b" be",
        b" of", b" and", b" in", b" is", b" it", b"ght", b" bon", b"jour",
        b" hel",
    ]
    for i, m in enumerate(common[:n_merges]):
        ranks[m] = 256 + i
    return ranks
