"""A reader of HuggingFace ``tokenizer.json`` files, written in the repo.

The port's ``HFTokenizer`` (``engine/tokenizer.py``) runs on it; the
GPU machine has no ``tokenizers`` package. It runs the pipeline that
``tokenizers`` runs for ``encode(text, add_special_tokens=False)`` and
``decode(ids, skip_special_tokens=True)``, in the same order:

1. added tokens whose ``normalized`` is false are cut out of the raw
   text (leftmost-longest, honouring ``single_word``, ``lstrip`` and
   ``rstrip``);
2. each remaining piece is normalized, and the ``normalized`` added
   tokens (their content normalized the same way) are cut out of it;
3. each remaining piece is pre-tokenized into words;
4. the BPE model turns each word into ids.

Decoding maps ids to tokens (added tokens first, ids outside the
vocabulary dropped, special tokens skipped) and runs the decoder.

Components: normalizers ``NFC``, ``NFD``, ``NFKC``, ``NFKD``,
``Lowercase``, ``Prepend``, ``Replace``, ``Sequence``;
pre-tokenizers ``Split``, ``ByteLevel``, ``Metaspace``, ``Whitespace``,
``Sequence``; the model ``BPE``; decoders ``ByteLevel``, ``Metaspace``,
``Replace``, ``ByteFallback``, ``Fuse``, ``Strip``, ``Sequence``; and the
post-processors that add nothing without special tokens
(``TemplateProcessing``, ``ByteLevel``, ``BertProcessing``,
``RobertaProcessing``, ``Sequence``). Regexes become stdlib ``re``
patterns over classes probed from ``tokenizers``
(``utils/unicode_classes.py``). Any other component, and any option of
these the reader does not reproduce, raises :class:`UnsupportedTokenizer`
naming it and the file when the file loads.
"""

from __future__ import annotations

import heapq
import json
import re
from dataclasses import dataclass
from pathlib import Path

from adversarial_spec_tpu_torch.utils import unicode_classes as uc

# The ByteLevel pre-tokenizer's own split (GPT-2's), and Whitespace's
# ``\w+|[^\w\s]+`` in the classes of Rust's regex crate, which it uses.
GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)
WHITESPACE_RE = re.compile(
    f"[{uc.class_body('rust_w')}]+|[^{uc.class_body('rust_w')}{uc.class_body('rust_s')}]+"
)
# Words this long are not cached (``tokenizers`` caches shorter ones).
_CACHE_WORD_CHARS = 256
_CACHE_ENTRIES = 10_000


class UnsupportedTokenizer(ValueError):
    """A ``tokenizer.json`` component the reader does not implement."""


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte → printable character table (ByteLevel)."""
    bs = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
          *range(ord("®"), ord("ÿ") + 1)]
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_CHAR = bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}


@dataclass(frozen=True)
class AddedToken:
    id: int
    content: str
    single_word: bool
    lstrip: bool
    rstrip: bool
    normalized: bool
    special: bool


class _Refuser:
    """Raises :class:`UnsupportedTokenizer` naming the file."""

    def __init__(self, path: str):
        self.path = path

    def __call__(self, what: str) -> UnsupportedTokenizer:
        return UnsupportedTokenizer(
            f"{self.path}: {what} is not supported by the port's "
            "tokenizer.json reader"
        )


def _pattern(spec: dict, refuse: _Refuser, where: str) -> re.Pattern:
    """A ``{"String": s}`` or ``{"Regex": r}`` pattern as a compiled
    ``re`` pattern."""
    if "String" in spec:
        if not spec["String"]:
            raise refuse(f"an empty String pattern in {where}")
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        try:
            return re.compile(uc.translate(spec["Regex"]))
        except uc.UnsupportedPattern as e:
            raise refuse(f"the {where} regex {spec['Regex']!r} ({e})") from e
    raise refuse(f"the {where} pattern {spec!r}")


def _find_matches(pattern: re.Pattern, s: str) -> list[tuple[int, int, bool]]:
    """``tokenizers``' ``Pattern::find_matches``: the string cut into
    (start, end, is_match) pieces."""
    if not s:
        return [(0, 0, False)]
    out, prev = [], 0
    for m in pattern.finditer(s):
        a, b = m.span()
        if prev != a:
            out.append((prev, a, False))
        out.append((a, b, True))
        prev = b
    if prev != len(s):
        out.append((prev, len(s), False))
    return out


def _split(s: str, pattern: re.Pattern, behavior: str, invert: bool = False) -> list[str]:
    """``NormalizedString::split``: the non-empty pieces of ``s`` around
    the pattern's matches, per the delimiter behaviour."""
    matches = [(a, b, m != invert) for a, b, m in _find_matches(pattern, s)]
    if behavior == "Isolated":
        pieces = [(a, b, False) for a, b, _ in matches]
    elif behavior == "Removed":
        pieces = matches
    elif behavior in ("Contiguous", "MergedWithPrevious"):
        pieces, prev_match = [], False
        for a, b, m in matches:
            merge = m == prev_match if behavior == "Contiguous" else m and not prev_match
            if merge and pieces:
                pieces[-1] = (pieces[-1][0], b, False)
            else:
                pieces.append((a, b, False))
            prev_match = m
    elif behavior == "MergedWithNext":
        pieces, prev_match = [], False
        for a, b, m in reversed(matches):
            if m and not prev_match and pieces:
                pieces[-1] = (a, pieces[-1][1], False)
            else:
                pieces.append((a, b, False))
            prev_match = m
        pieces.reverse()
    else:
        raise ValueError(behavior)
    return [s[a:b] for a, b, removed in pieces if not removed and b > a]


_BEHAVIORS = ("Isolated", "Removed", "Contiguous", "MergedWithPrevious", "MergedWithNext")


def _behavior(name: str, refuse: _Refuser) -> str:
    cased = {b.lower(): b for b in _BEHAVIORS}.get(str(name).lower())
    if cased is None:
        raise refuse(f"the Split behavior {name!r}")
    return cased


# -- normalizers ----------------------------------------------------------------


def _normalizer(spec: dict | None, refuse: _Refuser):
    """A ``str -> str`` function, or None."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s, _f=kind: uc.normalize(_f, s)
    if kind == "Lowercase":
        return uc.lowercase
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"], refuse, "Replace normalizer"), spec["content"]
        return lambda s: pat.sub(lambda _m: content, s)
    if kind == "Sequence":
        steps = [f for f in (_normalizer(n, refuse) for n in spec["normalizers"]) if f]

        def seq(s: str) -> str:
            for f in steps:
                s = f(s)
            return s

        return seq
    raise refuse(f"the normalizer {kind!r}")


# -- pre-tokenizers ---------------------------------------------------------------

# A pre-tokenizer maps [(piece, starts_the_input)] to the same, refined.
Pieces = list[tuple[str, bool]]


def _pre_tokenizer(spec: dict | None, refuse: _Refuser, has_prepend: bool, first: bool = True):
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [
            _pre_tokenizer(p, refuse, has_prepend, first and i == 0)
            for i, p in enumerate(spec["pretokenizers"])
        ]

        def seq(pieces: Pieces) -> Pieces:
            for f in steps:
                pieces = f(pieces)
            return pieces

        return seq
    if kind in ("Split", "Whitespace"):
        if kind == "Split":
            pat = _pattern(spec["pattern"], refuse, "Split pre-tokenizer")
            behavior, invert = _behavior(spec["behavior"], refuse), bool(spec.get("invert"))
        else:
            pat, behavior, invert = WHITESPACE_RE, "Removed", True

        def split(pieces: Pieces) -> Pieces:
            out = []
            for s, at0 in pieces:
                out += [(p, at0 and i == 0)
                        for i, p in enumerate(_split(s, pat, behavior, invert))]
            return out

        return split
    if kind == "ByteLevel":
        prefix, use_regex = spec.get("add_prefix_space", True), spec.get("use_regex", True)
        gpt2 = re.compile(uc.translate(GPT2_PATTERN))

        def byte_level(pieces: Pieces) -> Pieces:
            out = []
            for s, at0 in pieces:
                if prefix and not s.startswith(" "):
                    s = " " + s
                subs = _split(s, gpt2, "Isolated") if use_regex else ([s] if s else [])
                out += [("".join(BYTE_CHAR[b] for b in p.encode()), at0 and i == 0)
                        for i, p in enumerate(subs)]
            return out

        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        scheme = str(scheme).lower()
        if scheme not in ("always", "first", "never"):
            raise refuse(f"the Metaspace prepend_scheme {scheme!r}")
        if scheme == "first" and not (first and not has_prepend):
            # Which piece starts the input is then a matter of alignments
            # the reader does not track.
            raise refuse("Metaspace prepend_scheme 'first' after a Prepend "
                         "normalizer or another pre-tokenizer")
        split_on = spec.get("split", True)
        rep_pat = re.compile(re.escape(rep))

        def metaspace(pieces: Pieces) -> Pieces:
            out = []
            for s, at0 in pieces:
                s = s.replace(" ", rep)
                if not s.startswith(rep) and (scheme == "always" or (scheme == "first" and at0)):
                    s = rep + s
                subs = _split(s, rep_pat, "MergedWithNext") if split_on else ([s] if s else [])
                out += [(p, at0 and i == 0) for i, p in enumerate(subs)]
            return out

        return metaspace
    raise refuse(f"the pre-tokenizer {kind!r}")


# -- the BPE model ------------------------------------------------------------------


class BPE:
    """``tokenizers``' BPE: characters (or their ``<0xNN>`` bytes, or the
    unknown token) merged by rank, lowest first, leftmost on ties."""

    def __init__(self, spec: dict, refuse: _Refuser):
        if spec.get("type", "BPE") != "BPE":
            raise refuse(f"the model {spec.get('type')!r}")
        if spec.get("dropout") not in (None, 0, 0.0):
            raise refuse("BPE dropout")
        for opt in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(opt):
                raise refuse(f"BPE {opt}")
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.ignore_merges = bool(spec.get("ignore_merges"))
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                pair = (self.vocab[a], self.vocab[b])
                self.merges[pair] = (rank, self.vocab[a + b])
            except KeyError as e:
                raise refuse(f"a BPE merge of tokens outside the vocabulary ({e})") from e
        self._bytes = {b: self.vocab.get(f"<0x{b:02X}>") for b in range(256)}
        self._cache: dict[str, list[int]] = {}

    def _unk_id(self) -> int:
        if self.unk_token not in self.vocab:
            raise ValueError(f"the unknown token {self.unk_token!r} is not in the vocabulary")
        return self.vocab[self.unk_token]

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids = self._merge(self._symbols(word))
        if len(word) < _CACHE_WORD_CHARS:
            if len(self._cache) >= _CACHE_ENTRIES:
                self._cache.clear()
            self._cache[word] = ids
        return ids

    def _symbols(self, word: str) -> list[int]:
        out: list[int] = []
        unk = None
        for ch in word:
            tid = self.vocab.get(ch)
            if tid is not None:
                if unk is not None:
                    out.append(unk)
                    unk = None
                out.append(tid)
                continue
            if self.byte_fallback:
                toks = [self._bytes[b] for b in ch.encode()]
                if None not in toks:
                    out += toks
                    continue
            if self.unk_token is not None:
                if unk is not None and not self.fuse_unk:
                    out.append(unk)
                elif unk is not None:
                    continue  # fused into the pending unknown token
                unk = self._unk_id()
        if unk is not None:
            out.append(unk)
        return out

    def _merge(self, c: list[int]) -> list[int]:
        n = len(c)
        if n < 2:
            return c
        merges = self.merges
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((c[i], c[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((c[pos], c[right]))
            if m is None or m[1] != new_id:
                continue  # an expired entry
            c[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] != -1:
                prev[nxt[right]] = pos
            if prev[pos] >= 0:
                m = merges.get((c[prev[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((new_id, c[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, a in zip(c, alive) if a]


# -- decoders -------------------------------------------------------------------------


def _bytes_fallback_text(buf: list[int]) -> list[str]:
    try:
        return [bytes(buf).decode("utf-8")]
    except UnicodeDecodeError:
        return ["�"] * len(buf)


def _decoder(spec: dict | None, refuse: _Refuser):
    """A ``list[str] -> list[str]`` function (``decode_chain``), or None."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_decoder(d, refuse) for d in spec["decoders"]]

        def seq(tokens: list[str]) -> list[str]:
            for f in steps:
                tokens = f(tokens)
            return tokens

        return seq
    if kind == "ByteLevel":

        def byte_level(tokens: list[str]) -> list[str]:
            data = bytearray()
            for t in tokens:
                bs = [CHAR_BYTE.get(ch) for ch in t]
                data += t.encode() if None in bs else bytes(bs)
            return [data.decode("utf-8", errors="replace")]

        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        drop_first = str(scheme).lower() != "never"
        return lambda tokens: [
            t.replace(rep, "" if i == 0 and drop_first else " ") for i, t in enumerate(tokens)
        ]
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"], refuse, "Replace decoder"), spec["content"]
        return lambda tokens: [pat.sub(lambda _m: content, t) for t in tokens]
    if kind == "ByteFallback":

        def byte_fallback(tokens: list[str]) -> list[str]:
            out: list[str] = []
            buf: list[int] = []
            for t in tokens:
                b = None
                if len(t.encode()) == 6 and t.startswith("<0x") and t.endswith(">"):
                    try:
                        b = int(t[3:5], 16)
                    except ValueError:
                        b = None
                if b is not None:
                    buf.append(b)
                    continue
                if buf:
                    out += _bytes_fallback_text(buf)
                    buf = []
                out.append(t)
            if buf:
                out += _bytes_fallback_text(buf)
            return out

        return byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec.get("start", 0), spec.get("stop", 0)

        def strip(tokens: list[str]) -> list[str]:
            out = []
            for t in tokens:
                a = 0
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                b = len(t)
                for i in range(min(stop, len(t))):
                    if t[len(t) - 1 - i] != content:
                        break
                    b = len(t) - 1 - i
                out.append(t[a:b])
            return out

        return strip
    raise refuse(f"the decoder {kind!r}")


# Post-processors whose ids are the input's when no special tokens are
# added (the engine adds BOS itself).
_PASSIVE_POST = {"TemplateProcessing", "ByteLevel", "BertProcessing", "RobertaProcessing"}


def _check_post(spec: dict | None, refuse: _Refuser) -> None:
    if spec is None:
        return
    kind = spec.get("type")
    if kind == "Sequence":
        for p in spec["processors"]:
            _check_post(p, refuse)
    elif kind not in _PASSIVE_POST:
        raise refuse(f"the post-processor {kind!r}")


# -- the tokenizer ---------------------------------------------------------------------


def _has_type(spec, kind: str) -> bool:
    if isinstance(spec, dict):
        return spec.get("type") == kind or any(_has_type(v, kind) for v in spec.values())
    if isinstance(spec, list):
        return any(_has_type(v, kind) for v in spec)
    return False


class _AddedMatcher:
    """Leftmost-longest matching of a set of added tokens."""

    def __init__(self, tokens: dict[str, AddedToken]):
        self.tokens = tokens
        alts = sorted(tokens, key=len, reverse=True)
        self.pattern = re.compile("|".join(map(re.escape, alts))) if alts else None

    def split(self, s: str) -> list[tuple[str, int | None]]:
        """``AddedVocabulary::find_matches``: (text, added id or None)."""
        if self.pattern is None or not s:
            return [(s, None)]
        out: list[tuple[str, int | None]] = []
        done = 0
        for m in self.pattern.finditer(s):
            start, stop = m.span()
            tok = self.tokens[m.group()]
            if tok.single_word and (
                (start > 0 and uc.is_word_char(s[start - 1]))
                or (stop < len(s) and uc.is_word_char(s[stop]))
            ):
                continue
            if tok.lstrip:
                a = start
                while a > 0 and uc.is_space_char(s[a - 1]):
                    a -= 1
                start = max(a, done)
            if tok.rstrip:
                while stop < len(s) and uc.is_space_char(s[stop]):
                    stop += 1
            if done < start:
                out.append((s[done:start], None))
            out.append((s[start:stop], tok.id))
            done = stop
        if done != len(s):
            out.append((s[done:], None))
        return out


class TokenizerJSON:
    """One ``tokenizer.json``: ``encode``, ``decode``, ``get_vocab`` and
    ``get_vocab_size``, as ``tokenizers.Tokenizer`` gives them."""

    def __init__(self, path: str | Path):
        self.path = str(path)
        refuse = _Refuser(self.path)
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        for opt in ("truncation", "padding"):
            if doc.get(opt) is not None:
                raise refuse(f"{opt}")
        self.model = BPE(doc.get("model") or {}, refuse)
        self.added = [
            AddedToken(
                id=t["id"], content=t["content"],
                single_word=bool(t.get("single_word")), lstrip=bool(t.get("lstrip")),
                rstrip=bool(t.get("rstrip")), normalized=bool(t.get("normalized", True)),
                special=bool(t.get("special")),
            )
            for t in doc.get("added_tokens") or []
        ]
        norm_spec = doc.get("normalizer")
        self._normalize = _normalizer(norm_spec, refuse)
        has_prepend = _has_type(norm_spec, "Prepend")
        self._pre_tokenize = _pre_tokenizer(doc.get("pre_tokenizer"), refuse, has_prepend)
        self._decode = _decoder(doc.get("decoder"), refuse)
        _check_post(doc.get("post_processor"), refuse)
        norm = self._normalize or (lambda s: s)
        self._raw = _AddedMatcher({t.content: t for t in self.added if not t.normalized})
        self._norm = _AddedMatcher(
            {norm(t.content): t for t in self.added if t.normalized and norm(t.content)}
        )
        self._added_by_id = {t.id: t for t in self.added}
        self._special = {t.content for t in self.added if t.special}
        self._vocab = dict(self.model.vocab)
        self._vocab.update({t.content: t.id for t in self.added})

    def get_vocab(self) -> dict[str, int]:
        return dict(self._vocab)

    def get_vocab_size(self) -> int:
        return len(self._vocab)

    def encode(self, text: str) -> list[int]:
        """The ids of ``text`` without special tokens added."""
        ids: list[int] = []
        at0 = True
        for piece, tid in self._raw.split(text):
            if tid is not None:
                ids.append(tid)
                at0 = False
                continue
            if self._normalize is not None:
                piece = self._normalize(piece)
            for sub, sub_id in self._norm.split(piece):
                if sub_id is not None:
                    ids.append(sub_id)
                elif sub:
                    words = [(sub, at0)]
                    if self._pre_tokenize is not None:
                        words = self._pre_tokenize(words)
                    for w, _ in words:
                        ids += self.model.tokenize(w)
                at0 = False
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            i = int(i)
            tok = self._added_by_id.get(i)
            t = tok.content if tok is not None else self.model.id_to_token.get(i)
            if t is None or (skip_special_tokens and t in self._special):
                continue
            tokens.append(t)
        if self._decode is None:
            return " ".join(tokens)
        return "".join(self._decode(tokens))
