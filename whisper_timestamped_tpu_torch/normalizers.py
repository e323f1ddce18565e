"""Text normalizers for transcript scoring (WER/CER evaluation).

A copy of ``whisper_timestamped_tpu/normalizers.py``, which imports no JAX
(pure ``re`` and ``unicodedata``); the port keeps its own copy because
importing any module of the JAX package imports JAX.

The reference re-exports ``whisper.normalizers`` (reference
``__init__.py:2``), which evaluation harnesses import to normalize both
hypothesis and reference transcripts before scoring. This module provides
the same surface — ``BasicTextNormalizer`` and ``EnglishTextNormalizer``
(plus the building blocks) — as an original implementation:

* symbol/diacritic handling is unicode-category based;
* the English number normalizer is a small accumulator-based parser over
  number words (own design — not a port of whisper's);
* British→American spelling is RULE-based (suffix families + an irregular
  table) rather than a copied lookup file, so it also covers words no table
  lists.

Normalizers are pure text utilities — nothing here touches the device.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Optional

__all__ = [
    "BasicTextNormalizer",
    "EnglishTextNormalizer",
    "EnglishNumberNormalizer",
    "EnglishSpellingNormalizer",
    "remove_symbols",
    "remove_symbols_and_diacritics",
]


def _map_chars(s: str, *, drop_diacritics: bool, keep: str = "") -> str:
    out = []
    # NFKD only when stripping diacritics: decomposition splits é into
    # e + combining mark, which the Mn branch then drops; when KEEPING
    # diacritics, stay composed (NFKC) so marks never surface as symbols
    norm = unicodedata.normalize("NFKD" if drop_diacritics else "NFKC", s)
    for ch in norm:
        if ch in keep:
            out.append(ch)
            continue
        cat = unicodedata.category(ch)
        if drop_diacritics and cat == "Mn":
            continue  # combining mark: dropping it strips the diacritic
        if cat[0] in "MSP":  # marks, symbols, punctuation -> space
            out.append(" ")
        else:
            out.append(ch)
    return "".join(out)


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Replace symbols/punctuation with spaces and strip diacritics."""
    return _map_chars(s, drop_diacritics=True, keep=keep)


def remove_symbols(s: str) -> str:
    """Replace symbols/punctuation with spaces; keep diacritics."""
    return _map_chars(s, drop_diacritics=False)


class BasicTextNormalizer:
    """Language-agnostic: lowercase, strip bracketed asides, drop symbols.

    ``split_letters=True`` spaces out every grapheme (for CER on unspaced
    languages)."""

    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.clean = (
            remove_symbols_and_diacritics if remove_diacritics else remove_symbols
        )
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # <angle> and [square] asides
        s = re.sub(r"\(([^)]+?)\)", "", s)  # (parenthesized asides)
        s = self.clean(s).lower()
        if self.split_letters:
            graphemes: List[str] = []
            for ch in s:
                if ch.isspace():
                    continue
                if graphemes and unicodedata.combining(ch):
                    graphemes[-1] += ch  # keep marks on their base char
                else:
                    graphemes.append(ch)
            s = " ".join(graphemes)
        return re.sub(r"\s+", " ", s).strip()


# ---------------------------------------------------------------------------
# English numbers
# ---------------------------------------------------------------------------

_ONES = {
    w: i
    for i, w in enumerate(
        ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
    )
}
_TENS = {
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
    "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
}
_SCALES = {"hundred": 100, "thousand": 1_000, "million": 1_000_000,
           "billion": 1_000_000_000, "trillion": 1_000_000_000_000}
_ORDINAL_ONES = {
    "zeroth": 0, "first": 1, "second": 2, "third": 3, "fourth": 4,
    "fifth": 5, "sixth": 6, "seventh": 7, "eighth": 8, "ninth": 9,
    "tenth": 10, "eleventh": 11, "twelfth": 12, "thirteenth": 13,
    "fourteenth": 14, "fifteenth": 15, "sixteenth": 16, "seventeenth": 17,
    "eighteenth": 18, "nineteenth": 19,
}
_ORDINAL_TENS = {w + "ieth": v for w, v in
                 [("twent", 20), ("thirt", 30), ("fort", 40), ("fift", 50),
                  ("sixt", 60), ("sevent", 70), ("eight", 80), ("ninet", 90)]}
_ORDINAL_SCALES = {w + "th": v for w, v in _SCALES.items()}

_CURRENCY = {"dollar": "$", "dollars": "$", "pound": "£", "pounds": "£",
             "euro": "€", "euros": "€"}
_CENTS = {"cent", "cents", "penny", "pence"}


def _suffix(n: int) -> str:
    if 10 <= n % 100 <= 20:
        return "th"
    return {1: "st", 2: "nd", 3: "rd"}.get(n % 10, "th")


class EnglishNumberNormalizer:
    """Spell-out → digits: cardinals, ordinals, decimals ("point"),
    negatives, percent, currency amounts with cents.

    A single left-to-right accumulator (``group`` for the sub-thousand part,
    ``total`` for completed scale groups) — a different construction from
    whisper's generator-per-case normalizer, pinned by this repo's own tests.
    """

    _AND = "and"

    def __call__(self, s: str) -> str:
        words = s.split()
        out: List[str] = []
        i = 0
        while i < len(words):
            val, end, render = self._parse_number(words, i)
            if val is None:
                w = words[i]
                if w == "%" and out and re.match(r"^-?[\d.]+$", out[-1]):
                    out[-1] += "%"
                else:
                    out.append(w)
                i += 1
            else:
                out.append(render)
                i = end
        return " ".join(out)

    # -- helpers --------------------------------------------------------
    @staticmethod
    def _word_value(w: str):
        """(kind, value): kind in {ones, tens, scale, ord_ones, ord_tens,
        ord_scale} or None."""
        if w in _ONES:
            return "ones", _ONES[w]
        if w in _TENS:
            return "tens", _TENS[w]
        if w in _SCALES:
            return "scale", _SCALES[w]
        if w in _ORDINAL_ONES:
            return "ord_ones", _ORDINAL_ONES[w]
        if w in _ORDINAL_TENS:
            return "ord_tens", _ORDINAL_TENS[w]
        if w in _ORDINAL_SCALES:
            return "ord_scale", _ORDINAL_SCALES[w]
        return None

    def _parse_number(self, words: List[str], i: int):
        """Try to parse a number starting at ``words[i]``.

        Returns (value, next_index, rendered) or (None, i, None)."""
        n = len(words)
        j = i
        negative = False
        if j < n and words[j] in ("minus", "negative") and j + 1 < n:
            if self._lookahead_is_number(words, j + 1):
                negative = True
                j += 1
        total = 0
        group = 0  # the running < 1000 part
        saw_any = False
        ordinal = False
        last_kind: Optional[str] = None
        while j < n:
            w = words[j]
            # hyphenated compounds: "twenty-one", "twenty-first"
            if "-" in w and w.count("-") == 1:
                a, b = w.split("-")
                ka = self._word_value(a)
                kb = self._word_value(b)
                if ka and ka[0] == "tens" and kb and kb[0] in ("ones", "ord_ones") and 0 < kb[1] < 10:
                    group += ka[1] + kb[1]
                    saw_any = True
                    ordinal = kb[0] == "ord_ones"
                    last_kind = "ones"
                    j += 1
                    if ordinal:
                        break
                    continue
            kv = self._word_value(w)
            if kv is None:
                if (w == self._AND and saw_any and last_kind == "scale"
                        and j + 1 < n and self._lookahead_is_number(words, j + 1)):
                    j += 1  # "one hundred and five"
                    continue
                break
            kind, v = kv
            if kind in ("ord_ones", "ord_tens", "ord_scale"):
                base = {"ord_ones": "ones", "ord_tens": "tens", "ord_scale": "scale"}[kind]
                kind = base
                ordinal = True
            if kind == "ones":
                if last_kind == "ones" and group % 10 != 0 or (
                        last_kind == "ones" and v >= 10):
                    break  # "one two" / "five nineteen": separate numbers
                group += v
            elif kind == "tens":
                if last_kind in ("ones", "tens") and group % 100 != 0:
                    break  # "five twenty": separate
                group += v
            else:  # scale
                if not saw_any:
                    group = 1  # bare "hundred people"
                if v == 100:
                    group *= 100
                else:
                    total += group * v
                    group = 0
            saw_any = True
            last_kind = kind
            j += 1
            if ordinal:
                break
        if not saw_any:
            return None, i, None
        value = total + group
        # decimals: "three point one four" -> 3.14
        frac = ""
        if not ordinal and j < n and words[j] == "point":
            k = j + 1
            digits = []
            while k < n:
                kv = self._word_value(words[k])
                if kv and kv[0] == "ones" and kv[1] < 10:
                    digits.append(str(kv[1]))
                    k += 1
                else:
                    break
            if digits:
                frac = "." + "".join(digits)
                j = k
        if negative:
            rendered = f"-{value}{frac}"
        else:
            rendered = f"{value}{frac}"
        if ordinal:
            rendered = f"{value}{_suffix(value)}"
        # percent / currency riders
        if j < n and words[j] in ("percent", "percents"):
            return value, j + 1, rendered + "%"
        if j < n and words[j] in _CURRENCY and not ordinal:
            sym = _CURRENCY[words[j]]
            j += 1
            # "five dollars and twenty cents" -> $5.20 (the recursive parse
            # consumes the cents word itself and renders "20 cents")
            if (j + 1 < n and words[j] == self._AND
                    and self._lookahead_is_number(words, j + 1)):
                cents, k, cents_render = self._parse_number(words, j + 1)
                if (cents is not None and cents_render is not None
                        and cents_render.split()[-1] in _CENTS
                        and 0 <= int(cents) < 100):
                    return value, k, f"{sym}{value}.{int(cents):02d}"
            return value, j, f"{sym}{rendered}"
        if j < n and words[j] in _CENTS and not ordinal and not frac:
            return value, j + 1, f"{value} {words[j]}"  # "fifty cents" -> "50 cents"
        return value, j, rendered

    def _lookahead_is_number(self, words: List[str], i: int) -> bool:
        if i >= len(words):
            return False
        w = words[i]
        if "-" in w and w.count("-") == 1:
            w = w.split("-")[0]
        return self._word_value(w) is not None


# ---------------------------------------------------------------------------
# English spelling (British -> American), rule-based
# ---------------------------------------------------------------------------

# irregulars and stems the suffix rules cannot derive
_SPELLING_IRREGULAR = {
    "grey": "gray", "greys": "grays", "tyre": "tire", "tyres": "tires",
    "kerb": "curb", "kerbs": "curbs", "plough": "plow", "ploughs": "plows",
    "mould": "mold", "moulds": "molds", "moustache": "mustache",
    "moustaches": "mustaches", "pyjamas": "pajamas", "aluminium": "aluminum",
    "aeroplane": "airplane", "aeroplanes": "airplanes", "gaol": "jail",
    "gaols": "jails", "draught": "draft", "draughts": "drafts",
    "cheque": "check", "cheques": "checks", "sceptical": "skeptical",
    "defence": "defense", "offence": "offense", "licence": "license",
    "pretence": "pretense", "defences": "defenses", "offences": "offenses",
    "licences": "licenses", "practise": "practice", "practised": "practiced",
    "practising": "practicing", "programme": "program",
    "programmes": "programs", "catalogue": "catalog",
    "catalogues": "catalogs", "dialogue": "dialog", "dialogues": "dialogs",
    "analogue": "analog", "analogues": "analogs", "storey": "story",
    "storeys": "stories", "whisky": "whiskey", "artefact": "artifact",
    "artefacts": "artifacts", "speciality": "specialty",
    "specialities": "specialties", "jewellery": "jewelry",
    "marvellous": "marvelous", "woollen": "woolen", "enrol": "enroll",
    "fulfil": "fulfill", "instalment": "installment",
    "instalments": "installments", "skilful": "skillful",
    "wilful": "willful", "manoeuvre": "maneuver", "manoeuvres": "maneuvers",
    "oesophagus": "esophagus", "anaemia": "anemia", "anaesthesia":
    "anesthesia", "encyclopaedia": "encyclopedia", "paediatric": "pediatric",
    "mediaeval": "medieval", "foetus": "fetus", "oestrogen": "estrogen",
}

# -our/-or family words (not every "-our" maps: "hour", "sour", "tour" ...)
_OUR_STEMS = (
    "arbour armour behaviour candour clamour colour demeanour endeavour "
    "favour fervour flavour glamour harbour honour humour labour neighbour "
    "odour parlour rancour rigour rumour saviour savour splendour tumour "
    "valour vapour vigour".split()
)
# -re/-er family (exclude "genre", "acre", "mediocre", "massacre" ...)
_RE_STEMS = (
    "calibre centre centimetre fibre goitre kilometre litre lustre manoeuvre "
    "meagre metre millimetre sabre sceptre sombre spectre theatre".split()
)
# verbs where British doubles the l ("travelled" -> "traveled")
_L_VERBS = (
    "cancel channel counsel dial duel equal fuel label level marvel model "
    "panel quarrel signal travel tunnel".split()
)


def _build_spelling_map() -> dict:
    m = dict(_SPELLING_IRREGULAR)
    for stem in _OUR_STEMS:
        us = stem[:-3] + "or"
        m[stem] = us
        m[stem + "s"] = us + "s"
        # colourful -> colorful, honourable -> honorable, favourite -> favorite
        for suf in ("ful", "able", "ite", "ed", "ing"):
            m[stem + suf] = us + suf
    for stem in _RE_STEMS:
        us = stem[:-2] + "er"
        m[stem] = us
        m[stem + "s"] = us + "s"
    for verb in _L_VERBS:
        m[verb + "led"] = verb + "ed"
        m[verb + "ling"] = verb + "ing"
        m[verb + "ler"] = verb + "er"
        m[verb + "lers"] = verb + "ers"
    return m


class EnglishSpellingNormalizer:
    """British → American spellings: suffix families (-our/-or, -re/-er,
    -ise/-ize, -yse/-yze, doubled-l verb forms) + an irregulars table."""

    _ISE = re.compile(r"^([a-z]{3,}?)(is(?:e|es|ed|ing|ation|ations|er|ers))$")
    _ISE_EXCLUDE = {  # words whose "ise" is not the -ize suffix
        "advertise", "advise", "arise", "comprise", "compromise", "demise",
        "despise", "devise", "disguise", "exercise", "franchise", "improvise",
        "incise", "merchandise", "otherwise", "practise", "premise", "promise",
        "raise", "revise", "supervise", "surmise", "surprise", "televise",
        "wise", "likewise", "clockwise", "noise", "praise", "cruise",
        "bruise", "precise", "concise", "paradise",
    }

    def __init__(self):
        self.mapping = _build_spelling_map()

    def _word(self, w: str) -> str:
        if w in self.mapping:
            return self.mapping[w]
        m = self._ISE.match(w)
        if m:
            stem, tail = m.groups()
            base = stem + "ise"
            lemma_ok = base not in self._ISE_EXCLUDE and not any(
                base.endswith(x) for x in ("wise", "rise", "vise", "mise", "cise")
            )
            if lemma_ok:
                return stem + "iz" + tail[2:]
        if "yse" in w:
            for base in ("analyse", "catalyse", "paralyse"):
                if w.startswith(base[:-1]) and w[len(base) - 3:].startswith("yse"):
                    return w.replace("yse", "yze", 1)
        return w

    def __call__(self, s: str) -> str:
        return " ".join(self._word(w) for w in s.split())


# ---------------------------------------------------------------------------
# English full pipeline
# ---------------------------------------------------------------------------

_CONTRACTIONS = [
    (r"\bwon't\b", "will not"), (r"\bcan't\b", "can not"),
    (r"\bshan't\b", "shall not"), (r"\blet's\b", "let us"),
    (r"\bain't\b", "aint"), (r"\by'all\b", "you all"),
    (r"\bgonna\b", "going to"), (r"\bwanna\b", "want to"),
    (r"\bgotta\b", "got to"), (r"\bcannot\b", "can not"),
    (r"'m\b", " am"), (r"'re\b", " are"), (r"'ve\b", " have"),
    (r"'ll\b", " will"), (r"n't\b", " not"), (r"'d\b", " would"),
]
_TITLES = [
    (r"\bmr\b\.?", "mister"), (r"\bmrs\b\.?", "missus"),
    (r"\bms\b\.?", "miss"), (r"\bdr\b\.?", "doctor"),
    (r"\bprof\b\.?", "professor"), (r"\bst\b\.?", "saint"),
    (r"\bjr\b\.?", "junior"), (r"\bsr\b\.?", "senior"),
    (r"\bcapt\b\.?", "captain"), (r"\bgov\b\.?", "governor"),
    (r"\bcol\b\.?", "colonel"), (r"\bgen\b\.?", "general"),
    (r"\blt\b\.?", "lieutenant"), (r"\bsgt\b\.?", "sergeant"),
    (r"\besq\b\.?", "esquire"),
]


class EnglishTextNormalizer:
    """lowercase → asides out → titles/contractions expanded → spoken
    numbers to digits → symbols out → American spellings → single spaces."""

    def __init__(self):
        self.number = EnglishNumberNormalizer()
        self.spelling = EnglishSpellingNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)
        s = re.sub(r"\(([^)]+?)\)", "", s)
        s = re.sub(r"\s+'", "'", s)  # "they 're" -> "they're"
        for pat, rep in _TITLES:
            s = re.sub(pat, rep, s)
        for pat, rep in _CONTRACTIONS:
            s = re.sub(pat, rep, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # 1,000 -> 1000
        # detach end-of-word punctuation so "cents." still reads as a number
        # word; the strays are dropped with the other symbols below
        s = re.sub(r"([.,!?;:])(?=\s|$)", r" \1", s)
        s = self.number(s)
        # keep number-adjacent ., %, $, £, €, - ; drop other symbols
        s = remove_symbols_and_diacritics(s, keep=".%$£€¢-'")
        s = re.sub(r"[.](?!\d)", " ", s)  # periods survive only in decimals
        s = re.sub(r"[-](?![\d])", " ", s)  # hyphens survive only before digits
        s = re.sub(r"'", "", s)  # leftover apostrophes (possessives) drop
        s = self.spelling(s)
        return re.sub(r"\s+", " ", s).strip()
