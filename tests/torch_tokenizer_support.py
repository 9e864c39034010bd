"""Ground truth for the port's ``tokenizer.json`` reader, from the
``tokenizers`` library itself (tests only: the port never imports it).

- ``derive_tables()`` probes ``tokenizers`` code point by code point for
  the character classes its regex engine and its added-token matcher use,
  and for the characters whose Unicode normalization data (decomposition,
  combining class, composition) its normalizers lack or differ on. The
  result must equal what ``adversarial_spec_tpu_torch/utils/unicode_classes.py``
  commits (``tests/test_torch_tokenizer.py`` re-derives and compares).
- ``build_fixture(layout)`` trains a small BPE ``tokenizer.json`` on text
  of this repository in one family's published layout (Llama-3, Mistral,
  Gemma-2, Qwen2); the committed files under ``tests/torch_tokenizers/``
  were made by it.

Regenerate both (needs ``tokenizers``)::

    python tests/torch_tokenizer_support.py --write-tables --write-fixtures
"""

from __future__ import annotations

import json
import sys
import unicodedata
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_tokenizers"
TABLES = REPO / "adversarial_spec_tpu_torch" / "utils" / "unicode_classes.py"
LAYOUTS = ("llama3", "mistral", "gemma2", "qwen2")
# The training text: reference documents of this repository that do not
# change from PR to PR.
TRAIN_FILES = ("PAPER.md", "SURVEY.md", "SNIPPETS.md", "PAPERS.md")
VOCAB = 3000

LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

_CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
_CHUNK = 4096


def _chunks():
    for i in range(0, len(_CODE_POINTS), _CHUNK):
        yield _CODE_POINTS[i : i + _CHUNK]


def _regex_class(pattern: str) -> list[int]:
    """Code points a one-character ``tokenizers`` regex matches."""
    from tokenizers import Regex, pre_tokenizers

    split = pre_tokenizers.Split(Regex(pattern), behavior="removed")
    out = []
    for chunk in _chunks():
        kept = set()
        for _, (a, b) in split.pre_tokenize_str("".join(map(chr, chunk))):
            kept.update(range(a, b))
        out += [c for j, c in enumerate(chunk) if j not in kept]
    return out


def _whitespace_class(kind: str) -> list[int]:
    """Code points the ``Whitespace`` pre-tokenizer (Rust's ``regex``
    crate, not Oniguruma) takes as ``\\w`` (its own piece between two
    ``!``) or as ``\\s`` (in no piece)."""
    from tokenizers import pre_tokenizers

    ws = pre_tokenizers.Whitespace()
    out = []
    for chunk in _chunks():
        text = "!" + "".join(chr(c) + "!" for c in chunk)
        spans = {a: b for _, (a, b) in ws.pre_tokenize_str(text)}
        covered = set()
        for a, b in spans.items():
            covered.update(range(a, b))
        for j, c in enumerate(chunk):
            pos = 2 * j + 1
            if kind == "w" and spans.get(pos) == pos + 1 and c != ord("!"):
                out.append(c)
            elif kind == "s" and pos not in covered:
                out.append(c)
    return out


def _added_token_probe(kind: str) -> list[int]:
    """Code points the added-token matcher counts as word characters
    (``single_word``: a neighbour that blocks the match) or as whitespace
    (``lstrip``: swallowed left of the match)."""
    from tokenizers import AddedToken, Tokenizer, models

    tok = Tokenizer(models.BPE(vocab={}, merges=[]))
    if kind == "word":
        tok.add_tokens([AddedToken("X", single_word=True, normalized=False)])
    else:
        tok.add_tokens([AddedToken("X", lstrip=True, normalized=False)])
    out = []
    for chunk in _chunks():
        chunk = [c for c in chunk if c != ord("X")]
        if kind == "word":  # "cX " per code point: X splits iff c is no word char
            text = "".join(chr(c) + "X " for c in chunk)
            starts = {a for a, _ in tok.encode(text).offsets}
            out += [c for j, c in enumerate(chunk) if 3 * j + 1 not in starts]
        else:  # "acX": the match starts at c iff c is whitespace
            text = "".join("a" + chr(c) + "X" for c in chunk)
            starts = {a for a, _ in tok.encode(text).offsets}
            out += [c for j, c in enumerate(chunk) if 3 * j + 1 in starts]
    return out


def _norm_barriers() -> list[int]:
    """Code points whose normalization ``tokenizers`` does not know as
    this Python's ``unicodedata`` does: a decomposition it lacks, a
    combining class it lacks, or a composition it does not make (each
    code point of such a composite and its decomposition)."""
    from tokenizers import normalizers

    nfd, nfkd, nfc = normalizers.NFD(), normalizers.NFKD(), normalizers.NFC()
    out = set()
    for c in _CODE_POINTS:
        ch = chr(c)
        if unicodedata.decomposition(ch) and (
            nfd.normalize_str(ch) != unicodedata.normalize("NFD", ch)
            or nfkd.normalize_str(ch) != unicodedata.normalize("NFKD", ch)
        ):
            out.add(c)
        k = unicodedata.combining(ch)
        if k:  # a mark of class k > 1 must move before a class-1 mark
            probe = ch + "̴" if k > 1 else "ͅ" + ch
            if nfd.normalize_str(probe) == probe:
                out.add(c)
        d = unicodedata.normalize("NFD", ch)
        if len(d) > 1 and unicodedata.normalize("NFC", d) == ch and nfc.normalize_str(d) != ch:
            out.update([c, *map(ord, d)])
    return sorted(out)


def _lowercase_overrides() -> dict[int, str]:
    """Code points the ``Lowercase`` normalizer maps otherwise than
    ``str.lower``."""
    from tokenizers import normalizers

    low = normalizers.Lowercase()
    return {
        c: low.normalize_str(chr(c))
        for c in _CODE_POINTS
        if low.normalize_str(chr(c)) != chr(c).lower()
    }


def ranges(cps: list[int]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for c in sorted(cps):
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return [tuple(r) for r in out]


def derive_tables() -> dict:
    """Everything ``unicode_classes.py`` commits, probed afresh."""
    import tokenizers

    return {
        "tokenizers": tokenizers.__version__,
        "unidata": unicodedata.unidata_version,
        "L": ranges(_regex_class(r"\p{L}")),
        "N": ranges(_regex_class(r"\p{N}")),
        "s": ranges(_regex_class(r"\s")),
        "w": ranges(_regex_class(r"\w")),
        "rust_w": ranges(_whitespace_class("w")),
        "rust_s": ranges(_whitespace_class("s")),
        "word": ranges(_added_token_probe("word")),
        "space": ranges(_added_token_probe("space")),
        "norm_barriers": ranges(_norm_barriers()),
        "lower": _lowercase_overrides(),
    }


def _render_ranges(rs) -> str:
    body = ",".join(f"{a:X}-{b:X}" if a != b else f"{a:X}" for a, b in rs)
    lines = [body[i : i + 72] for i in range(0, len(body), 72)]
    return "(\n" + "".join(f'    "{ln}"\n' for ln in lines) + ")"


def render_tables(t: dict) -> str:
    """The data block of ``unicode_classes.py`` (between its markers)."""
    lower = ", ".join(f"0x{c:X}: {s!r}" for c, s in sorted(t["lower"].items()))
    parts = [
        f'PROBED_WITH = {{"tokenizers": {t["tokenizers"]!r}, '
        f'"unidata": {t["unidata"]!r}}}',
        *(
            f"_{name.upper()}_RANGES = {_render_ranges(t[name])}"
            for name in ("L", "N", "s", "w", "rust_w", "rust_s", "word", "space", "norm_barriers")
        ),
        f"LOWER_OVERRIDES = {{{lower}}}",
    ]
    return "\n".join(parts) + "\n"


BEGIN, END = "# --- probed tables: begin ---\n", "# --- probed tables: end ---\n"


def write_tables() -> None:
    src = TABLES.read_text()
    head, rest = src.split(BEGIN)
    _, tail = rest.split(END)
    TABLES.write_text(head + BEGIN + render_tables(derive_tables()) + END + tail)


# -- fixtures ----------------------------------------------------------------


def training_text() -> list[str]:
    lines = []
    for name in TRAIN_FILES:
        lines += (REPO / name).read_text().splitlines()
    return [ln for ln in lines if ln.strip()]


def _byte_tokens() -> list[str]:
    return [f"<0x{b:02X}>" for b in range(256)]


def _sentencepiece_like(layout: str, vocab_size: int) -> str:
    """Mistral / Gemma-2: BPE over ``▁``-joined text with byte fallback;
    specials, then the 256 byte tokens, then the trained pieces."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, trainers

    specials = (
        ["<unk>", "<s>", "</s>"] if layout == "mistral" else ["<pad>", "<eos>", "<bos>", "<unk>"]
    )
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.Replace(" ", "▁")
    tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="never")
    trainer = trainers.BpeTrainer(vocab_size=vocab_size - len(specials) - 256, show_progress=False)
    tok.train_from_iterator(training_text(), trainer)
    trained = json.loads(tok.to_str())["model"]
    pieces = sorted(trained["vocab"], key=trained["vocab"].get)
    vocab = {t: i for i, t in enumerate(specials + _byte_tokens())}
    for p in pieces:
        vocab.setdefault(p, len(vocab))
    unk = "<unk>"
    added = [
        {"id": vocab[s], "content": s, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True}
        for s in specials
    ]
    if layout == "mistral":
        normalizer = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]}
        pre = None
        decoder = {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
        post = {"type": "TemplateProcessing",
                "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                           {"Sequence": {"id": "A", "type_id": 0}}],
                "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                         {"Sequence": {"id": "A", "type_id": 0}},
                         {"SpecialToken": {"id": "<s>", "type_id": 1}},
                         {"Sequence": {"id": "B", "type_id": 1}}],
                "special_tokens": {"<s>": {"id": "<s>", "ids": [vocab["<s>"]],
                                           "tokens": ["<s>"]}}}
    else:
        for s in ("<start_of_turn>", "<end_of_turn>"):
            vocab[s] = len(vocab)
            added.append({"id": vocab[s], "content": s, "single_word": False,
                          "lstrip": False, "rstrip": False, "normalized": False,
                          "special": True})
        normalizer = {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}
        pre = {"type": "Split", "pattern": {"String": " "},
               "behavior": "MergedWithPrevious", "invert": False}
        decoder = {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"}]}
        post = {"type": "TemplateProcessing",
                "single": [{"SpecialToken": {"id": "<bos>", "type_id": 0}},
                           {"Sequence": {"id": "A", "type_id": 0}}],
                "pair": [{"SpecialToken": {"id": "<bos>", "type_id": 0}},
                         {"Sequence": {"id": "A", "type_id": 0}},
                         {"SpecialToken": {"id": "<bos>", "type_id": 1}},
                         {"Sequence": {"id": "B", "type_id": 1}}],
                "special_tokens": {"<bos>": {"id": "<bos>", "ids": [vocab["<bos>"]],
                                             "tokens": ["<bos>"]}}}
    doc = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": normalizer, "pre_tokenizer": pre,
        "post_processor": post, "decoder": decoder,
        "model": {"type": "BPE", "dropout": None, "unk_token": unk,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": trained["merges"]},
    }
    return json.dumps(doc, ensure_ascii=False, indent=None)


def _byte_level(layout: str, vocab_size: int) -> str:
    """Llama-3 / Qwen2: a Split regex then ByteLevel, a BPE over the
    byte alphabet, the specials appended after the trained vocabulary."""
    from tokenizers import Regex, Tokenizer, decoders, models, normalizers
    from tokenizers import pre_tokenizers, processors, trainers

    pattern = LLAMA3_PATTERN if layout == "llama3" else QWEN2_PATTERN
    tok = Tokenizer(models.BPE(ignore_merges=layout == "llama3"))
    if layout == "qwen2":
        tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    tok.train_from_iterator(training_text(), trainer)
    if layout == "llama3":
        specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                    "<|end_header_id|>", "<|eot_id|>"]
        tok.add_special_tokens(specials)
        bos = tok.token_to_id("<|begin_of_text|>")
        tok.post_processor = processors.Sequence([
            processors.ByteLevel(trim_offsets=False),
            processors.TemplateProcessing(
                single="<|begin_of_text|> $A", pair="<|begin_of_text|> $A <|begin_of_text|> $B:1",
                special_tokens=[("<|begin_of_text|>", bos)]),
        ])
    else:
        tok.add_special_tokens(["<|endoftext|>", "<|im_start|>", "<|im_end|>"])
        tok.post_processor = processors.ByteLevel(trim_offsets=False)
    return tok.to_str()


def build_fixture(layout: str, vocab_size: int = VOCAB) -> str:
    """One layout's ``tokenizer.json`` text (loadable by ``tokenizers``),
    its vocabulary about ``vocab_size`` tokens."""
    from tokenizers import Tokenizer

    build = _byte_level if layout in ("llama3", "qwen2") else _sentencepiece_like
    text = build(layout, vocab_size)
    Tokenizer.from_str(text)  # the library accepts it
    return text


def write_fixtures() -> None:
    for layout in LAYOUTS:
        d = FIXTURES / layout
        d.mkdir(parents=True, exist_ok=True)
        (d / "tokenizer.json").write_text(build_fixture(layout))


if __name__ == "__main__":
    if "--write-tables" in sys.argv:
        write_tables()
    if "--write-fixtures" in sys.argv:
        write_fixtures()
