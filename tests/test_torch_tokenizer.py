"""The port's ``tokenizer.json`` reader against the ``tokenizers`` library.

Token ids and decoded text must be identical to ``tokenizers``'
``encode(text, add_special_tokens=False)`` and ``decode(ids,
skip_special_tokens=True)`` on: the four committed fixtures (Llama-3,
Mistral, Gemma-2 and Qwen2 layouts, ``tests/torch_tokenizers/``);
tokenizers built here in other layouts and options; the reference's own
Whitespace fixture; and hypothesis text over all of Unicode, letters
assigned after this Python's Unicode version included. The probed tables
of ``utils/unicode_classes.py`` are re-derived and must be equal.
``tokenizers`` is imported here only, never by the port.
"""

import json
import subprocess
import sys
import time
import unicodedata
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import AddedToken, Regex, Tokenizer, decoders, models
from tokenizers import normalizers, pre_tokenizers, trainers

from tests import torch_tokenizer_support as sup
from adversarial_spec_tpu_torch.engine import tokenizer as port_tok
from adversarial_spec_tpu_torch.engine.tokenizer_json import (
    TokenizerJSON,
    UnsupportedTokenizer,
)
from adversarial_spec_tpu_torch.utils import unicode_classes as uc

REPO = Path(__file__).resolve().parent.parent
FIXTURES = {layout: sup.FIXTURES / layout / "tokenizer.json" for layout in sup.LAYOUTS}

# Letters and numbers ``tokenizers`` knows that this Python's unicodedata
# does not (assigned after its Unicode version), and the code points whose
# normalization the two disagree on.
NEW_LETTERS = [
    c for lo, hi in uc.RANGES["L"] + uc.RANGES["N"] for c in range(lo, hi + 1)
    if unicodedata.category(chr(c))[0] not in "LN"
]
BARRIERS = [c for lo, hi in uc.RANGES["norm_barriers"] for c in range(lo, hi + 1)]
MARKS = [0x300, 0x301, 0x316, 0x327, 0x334, 0x345, 0x5B0, 0x93C, 0x1DFA, 0x1E8D0]

any_char = st.characters(exclude_categories=("Cs",))
tricky_char = st.one_of(
    any_char,
    st.sampled_from([chr(c) for c in NEW_LETTERS]),
    st.sampled_from([chr(c) for c in BARRIERS + MARKS]),
    st.sampled_from(list(" \t\n\r\x0b\x0c\x1c\x1d\x85\xa0\u2028\u3000'sStTlLdDmMvVreſK0123456789.,!?-_")),
)
fuzz_text = st.text(alphabet=tricky_char, max_size=48)


def _same_ids(ref: Tokenizer, mine: TokenizerJSON, text: str) -> list[int]:
    want = ref.encode(text, add_special_tokens=False).ids
    assert mine.encode(text) == want, text
    return want


def _same_decode(ref: Tokenizer, mine: TokenizerJSON, ids) -> None:
    assert mine.decode(ids) == ref.decode(ids, skip_special_tokens=True)


@pytest.fixture(scope="module")
def pairs():
    return {
        layout: (Tokenizer.from_file(str(p)), TokenizerJSON(p)) for layout, p in FIXTURES.items()
    }


def corpus() -> list[str]:
    from adversarial_spec_tpu_torch.engine.tokenizer import CHAT_TEMPLATES, GENERIC_CHAT_TEMPLATE

    text = (REPO / "README.md").read_text()
    out = [p for p in text.split("\n\n") if p.strip()][:40]
    out += [t.format(system="You review specs.", user=out[0]) for t in CHAT_TEMPLATES.values()]
    out += [GENERIC_CHAT_TEMPLATE.format(system="s", user="u"), "", " ", "  \n\n\t x  ",
            "It's we'LL 'S 'ſ ſ's", "ǅ Σσς ﬁ ｆｕｌｌ ①②③ ¹²", "😀👍🏽 \U00013C96\U00013460",
            "a\u0301\u0327 \u11935\u11930 ㋿", "<|eot_id|><|eot_id|>x<|eot_id|>"]
    return out


# -- the four fixtures ---------------------------------------------------------


@pytest.mark.parametrize("layout", sup.LAYOUTS)
def test_fixture_ids_and_text_match(pairs, layout):
    ref, mine = pairs[layout]
    assert mine.get_vocab_size() == ref.get_vocab_size()
    assert mine.get_vocab() == ref.get_vocab()
    for text in corpus():
        _same_decode(ref, mine, _same_ids(ref, mine, text))


@pytest.mark.parametrize("layout", sup.LAYOUTS)
def test_fixture_decode_skips_ids_outside_the_vocabulary(pairs, layout):
    """Random weights emit ids far past a small vocabulary: decode drops
    them, as ``tokenizers`` does, and special tokens are skipped."""
    import random

    ref, mine = pairs[layout]
    rng = random.Random(0)
    n = ref.get_vocab_size()
    for _ in range(20):
        ids = [rng.randrange(0, 128256) for _ in range(64)] + list(range(n - 6, n + 3))
        _same_decode(ref, mine, ids)
    assert mine.decode([n, n + 1, 128255]) == ""


@pytest.mark.parametrize("layout", sup.LAYOUTS)
@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(text=fuzz_text)
def test_fixture_fuzz_over_unicode(pairs, layout, text):
    ref, mine = pairs[layout]
    _same_decode(ref, mine, _same_ids(ref, mine, text))


def test_new_letters_are_letters():
    """Astral letters assigned after this Python's Unicode version stay in
    the fuzz: ``\\p{L}`` takes them, as ``tokenizers`` does."""
    assert unicodedata.unidata_version == uc.PROBED_WITH["unidata"]
    assert 0x13C96 in NEW_LETTERS
    ref = Tokenizer.from_file(str(FIXTURES["llama3"]))
    mine = TokenizerJSON(FIXTURES["llama3"])
    _same_ids(ref, mine, "a \U00013C96\U00013C97 b")


def test_encode_speed_of_a_long_prompt(pairs):
    """A ~4200-token prompt encodes in well under a second on the host."""
    ref, mine = pairs["llama3"]
    text = (REPO / "SURVEY.md").read_text()
    while len(ref.encode(text, add_special_tokens=False).ids) < 4200:
        text += text
    text = text[: len(text) * 4200 // len(ref.encode(text, add_special_tokens=False).ids)]
    mine.model._cache.clear()
    t = time.perf_counter()
    ids = mine.encode(text)
    took = time.perf_counter() - t
    assert ids == ref.encode(text, add_special_tokens=False).ids
    assert 4000 <= len(ids) <= 4400
    assert took < 0.5, took


# -- layouts and options built here ---------------------------------------------

TRAIN = sup.training_text()[:400]


def _build(layout: str, tmp_path) -> Path:
    """A small tokenizer in one of the layouts the fixtures do not cover."""
    if layout == "whitespace":  # the reference's own fixture (tests/test_tokenizer.py)
        tok = Tokenizer(models.BPE(unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.Whitespace()
        tok.train_from_iterator(
            ["the quick brown fox jumps over the lazy dog " * 3,
             "spec review critique agree revise document " * 3],
            trainers.BpeTrainer(special_tokens=["<unk>", "<s>", "</s>", "<|eot_id|>"],
                                vocab_size=200, show_progress=False))
    elif layout == "gpt2":
        tok = Tokenizer(models.BPE())
        tok.normalizer = normalizers.Sequence([normalizers.NFKD(), normalizers.Lowercase()])
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
        tok.decoder = decoders.ByteLevel()
        tok.train_from_iterator(TRAIN, trainers.BpeTrainer(
            vocab_size=600, show_progress=False,
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    elif layout.startswith("metaspace"):
        scheme = layout.split("-")[1]
        tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=scheme == "first"))
        tok.normalizer = normalizers.NFKC()
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            prepend_scheme=scheme, split=scheme != "never")
        tok.decoder = decoders.Metaspace(prepend_scheme=scheme)
        tok.train_from_iterator(TRAIN, trainers.BpeTrainer(
            vocab_size=500, special_tokens=["<unk>", "<s>", "</s>"], limit_alphabet=60,
            show_progress=False))
    elif layout.startswith("split"):
        _, behavior, invert = layout.split("-")
        tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True))
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(r"\s+|\p{N}|[.,;:]"), behavior=behavior,
                                 invert=invert == "inv"),
            pre_tokenizers.Whitespace(),
        ])
        tok.train_from_iterator(TRAIN, trainers.BpeTrainer(
            vocab_size=400, special_tokens=["<unk>"], limit_alphabet=50, show_progress=False))
    else:
        raise ValueError(layout)
    path = tmp_path / layout / "tokenizer.json"
    path.parent.mkdir(parents=True)
    tok.save(str(path))
    return path


BUILT = ["whitespace", "gpt2", "metaspace-always", "metaspace-first", "metaspace-never",
         *(f"split-{b}-{i}" for b in ("isolated", "removed", "merged_with_previous",
                                      "merged_with_next", "contiguous") for i in ("inv", "noinv"))]


@pytest.mark.parametrize("layout", BUILT)
def test_built_layouts_match(tmp_path, layout):
    path = _build(layout, tmp_path)
    ref, mine = Tokenizer.from_file(str(path)), TokenizerJSON(path)
    for text in corpus():
        _same_decode(ref, mine, _same_ids(ref, mine, text))


@pytest.mark.parametrize("layout", ["gpt2", "metaspace-first", "split-merged_with_next-noinv"])
@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(text=fuzz_text)
def test_built_layouts_fuzz(tmp_path_factory, layout, text):
    path = _built_once(tmp_path_factory, layout)
    ref, mine = Tokenizer.from_file(str(path)), TokenizerJSON(path)
    _same_decode(ref, mine, _same_ids(ref, mine, text))


_BUILT_PATHS: dict[str, Path] = {}


def _built_once(tmp_path_factory, layout: str) -> Path:
    if layout not in _BUILT_PATHS:
        _BUILT_PATHS[layout] = _build(layout, tmp_path_factory.mktemp("tok"))
    return _BUILT_PATHS[layout]


ADDED = [
    AddedToken("<tool>", lstrip=True, rstrip=True, special=True, normalized=False),
    AddedToken("foo", single_word=True, normalized=False),
    AddedToken("Bar baz", normalized=True),
    AddedToken("  ", lstrip=True, normalized=True),
    AddedToken("<x>", rstrip=True, special=False, normalized=False),
    AddedToken("<xy>", normalized=False),
]
ADDED_TEXT = [
    "foo <tool> food foo_ ,foo. xfoo foo", "a  <tool>  b<tool>\n\nc", "Bar baz Bar bazaar",
    "x <x>  y <xy> <x> ", "  spaced   out  ", "<tool><tool>foo<tool>", "élan foo\u00a0<tool>",
]


@pytest.mark.parametrize("layout", sup.LAYOUTS)
def test_added_tokens_with_strip_and_single_word(tmp_path, layout):
    tok = Tokenizer.from_file(str(FIXTURES[layout]))
    tok.add_tokens(ADDED)
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    mine = TokenizerJSON(path)
    for text in ADDED_TEXT + corpus()[:5]:
        ids = _same_ids(tok, mine, text)
        _same_decode(tok, mine, ids)


@pytest.mark.parametrize("layout", ["mistral", "gemma2"])
def test_byte_fallback_outside_the_vocabulary(pairs, layout):
    ref, mine = pairs[layout]
    text = "emoji 😀 cjk 漢字 astral \U0001D11E \U00013C96 ok"
    ids = _same_ids(ref, mine, text)
    assert any(mine.model.id_to_token.get(i, "").startswith("<0x") for i in ids)
    _same_decode(ref, mine, ids)
    # A byte run that is no UTF-8: one U+FFFD per byte, as ByteFallback gives.
    bad = [mine.model.vocab["<0xF0>"], mine.model.vocab["<0x9F>"], mine.model.vocab["<0x41>"]]
    _same_decode(ref, mine, bad)


def test_merges_as_strings_or_pairs(tmp_path):
    doc = json.loads(FIXTURES["qwen2"].read_text())
    doc["model"]["merges"] = [" ".join(m) for m in doc["model"]["merges"]]
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(doc))
    a, b = TokenizerJSON(path), TokenizerJSON(FIXTURES["qwen2"])
    ref = Tokenizer.from_file(str(path))
    for text in corpus()[:10]:
        assert a.encode(text) == b.encode(text) == ref.encode(text, add_special_tokens=False).ids


def test_ignore_merges_takes_whole_words(pairs):
    from adversarial_spec_tpu_torch.engine.tokenizer_json import CHAR_BYTE

    ref, mine = pairs["llama3"]
    word = max((t for t in mine.model.vocab if t.startswith("Ġ") and len(t) > 4), key=len)
    text = bytes(CHAR_BYTE[c] for c in word).decode()
    assert mine.encode(text) == [mine.model.vocab[word]] == _same_ids(ref, mine, text)


# -- refusals -------------------------------------------------------------------


def _with(doc_path: Path, tmp_path, **changes) -> Path:
    doc = json.loads(doc_path.read_text())
    for key, value in changes.items():
        section, _, field = key.partition("__")
        if field:
            doc[section][field] = value
        else:
            doc[section] = value
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(doc))
    return path


@pytest.mark.parametrize(
    "changes,named",
    [
        (dict(model={"type": "WordPiece", "vocab": {"a": 0}, "unk_token": "a"}), "WordPiece"),
        (dict(model={"type": "Unigram", "vocab": [["a", 0.0]]}), "Unigram"),
        (dict(pre_tokenizer={"type": "BertPreTokenizer"}), "BertPreTokenizer"),
        (dict(pre_tokenizer={"type": "Digits", "individual_digits": True}), "Digits"),
        (dict(normalizer={"type": "Precompiled", "precompiled_charsmap": ""}), "Precompiled"),
        (dict(normalizer={"type": "BertNormalizer"}), "BertNormalizer"),
        (dict(normalizer={"type": "Strip", "strip_left": True, "strip_right": True}), "Strip"),
        (dict(decoder={"type": "WordPiece", "prefix": "##"}), "WordPiece"),
        (dict(post_processor={"type": "Foo"}), "Foo"),
        (dict(truncation={"max_length": 8}), "truncation"),
        (dict(padding={"strategy": "BatchLongest"}), "padding"),
        (dict(model__dropout=0.1), "dropout"),
        (dict(model__continuing_subword_prefix="##"), "continuing_subword_prefix"),
        (dict(pre_tokenizer={"type": "Split", "pattern": {"Regex": r"\d+"},
                             "behavior": "Isolated", "invert": False}), r"\d"),
        (dict(pre_tokenizer={"type": "Split", "pattern": {"Regex": r"^\s"},
                             "behavior": "Isolated", "invert": False}), "anchor"),
        (dict(pre_tokenizer={"type": "Split", "pattern": {"Regex": r"\p{Lu}+"},
                             "behavior": "Isolated", "invert": False}), "Lu"),
        (dict(pre_tokenizer={"type": "Metaspace", "replacement": "▁",
                             "prepend_scheme": "first", "split": True}), "first"),
    ],
    ids=lambda v: v if isinstance(v, str) else None,
)
def test_unsupported_components_are_refused_by_name(tmp_path, changes, named):
    path = _with(FIXTURES["mistral"], tmp_path, **changes)
    with pytest.raises(UnsupportedTokenizer) as e:
        port_tok.HFTokenizer(str(path))
    assert named in str(e.value) and str(path) in str(e.value)


@pytest.mark.parametrize(
    "pattern,named",
    [
        (r"\d+", r"\d"), (r"\bx", r"\b"), (r"^a", "anchor"), (r"a$", "anchor"),
        (r"(?<n>a)", "(?<n>"), (r"a++", "possessive"), (r"[[:alpha:]]", "POSIX"),
        (r"[a-z&&[^aeiou]]", "&&"), (r"[a[b]]", "nested"), (r"\p{Lu}", "Lu"), (r"(?i:[a-z])", "(?i: )"),
        (r"(?i:\p{L})", "(?i: )"), (r"a*", "empty"), (r"(?m:a.)", "(?m:"), (r"(?i)a", "(?i)"),
        (r"[\S]", "negated"), (r"\1", r"\1"), ("(a", "unclosed"),
    ],
)
def test_translate_refuses_what_it_cannot_reproduce(pattern, named):
    with pytest.raises(uc.UnsupportedPattern) as e:
        uc.translate(pattern)
    assert named in str(e.value)


@pytest.mark.parametrize(
    "pattern",
    [sup.LLAMA3_PATTERN, sup.QWEN2_PATTERN, r"\s+(?!\S)|\S+?", r"[\x{1F600}-\x{1F64F}]+|\u00e9",
     r"(?:ab|c)+?|[^\p{L}\n]{2,3}|(?<=a)b|(?<!a)c|\W+|\P{N}"],
)
@settings(max_examples=40, deadline=None)
@given(text=fuzz_text)
def test_translated_patterns_split_as_tokenizers_does(pattern, text):
    ref = pre_tokenizers.Split(Regex(pattern), behavior="isolated")
    mine = __import__("re").compile(uc.translate(pattern))
    want = [p for p, _ in ref.pre_tokenize_str(text)]
    from adversarial_spec_tpu_torch.engine.tokenizer_json import _split

    assert _split(text, mine, "Isolated") == want


# -- Unicode tables --------------------------------------------------------------


def test_probed_tables_match_tokenizers():
    """``utils/unicode_classes.py`` equals a fresh probe of ``tokenizers``
    (regenerate with ``python tests/torch_tokenizer_support.py
    --write-tables``)."""
    fresh = sup.derive_tables()
    assert uc.PROBED_WITH == {"tokenizers": fresh["tokenizers"], "unidata": fresh["unidata"]}
    for name in ("L", "N", "s", "w", "rust_w", "rust_s", "word", "space", "norm_barriers"):
        assert list(uc.RANGES[name]) == fresh[name], name
    assert uc.LOWER_OVERRIDES == fresh["lower"]


@pytest.mark.parametrize("form", ["NFC", "NFD", "NFKC", "NFKD"])
@settings(max_examples=150, deadline=None)
@given(text=fuzz_text)
def test_normalize_matches_tokenizers(form, text):
    assert uc.normalize(form, text) == getattr(normalizers, form)().normalize_str(text)


def test_normalize_around_barriers():
    for text in ["\U00011935\U00011930", "a\U00011935\U00011930\u0301", "㋿\u0301",
                 "e\u0301\u08ca\u0327", "\u0345\u07fd\u0334"]:
        for form in ("NFC", "NFKC", "NFD", "NFKD"):
            assert uc.normalize(form, text) == getattr(normalizers, form)().normalize_str(text)


@settings(max_examples=150, deadline=None)
@given(text=fuzz_text)
def test_lowercase_matches_tokenizers(text):
    assert uc.lowercase(text + "Σ") == normalizers.Lowercase().normalize_str(text + "Σ")


# -- HFTokenizer -------------------------------------------------------------------


@pytest.mark.parametrize("layout", sup.LAYOUTS)
def test_hf_tokenizer_matches_the_reference(layout):
    """The port's ``HFTokenizer`` (on the reader) against the reference's
    (on ``tokenizers``): ids with and without BOS, text, BOS/EOS/pad ids
    and vocabulary size."""
    from adversarial_spec_tpu.engine.tokenizer import HFTokenizer as RefHF

    ref, mine = RefHF(str(FIXTURES[layout])), port_tok.HFTokenizer(str(FIXTURES[layout].parent))
    for attr in ("vocab_size", "bos_id", "pad_id", "eos_ids"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    assert mine.eos_ids, layout
    for text in corpus()[:12]:
        for bos in (True, False):
            ids = mine.encode(text, add_bos=bos)
            assert ids == ref.encode(text, add_bos=bos)
            assert mine.decode(ids) == ref.decode(ids)


def test_reference_whitespace_fixture_through_hf_tokenizer(tmp_path):
    from adversarial_spec_tpu.engine.tokenizer import HFTokenizer as RefHF

    path = _build("whitespace", tmp_path)
    ref, mine = RefHF(str(path)), port_tok.HFTokenizer(str(path))
    assert mine.vocab_size == ref.vocab_size and mine.bos_id == ref.bos_id
    assert len(mine.eos_ids) == 2 and mine.eos_ids == ref.eos_ids
    ids = mine.encode("critique the spec", add_bos=False)
    assert ids == ref.encode("critique the spec", add_bos=False)
    assert mine.decode(ids) == "critique the spec"


def test_load_tokenizer_reads_each_file_once(tmp_path):
    path = tmp_path / "tokenizer.json"
    path.write_bytes(FIXTURES["llama3"].read_bytes())
    a = port_tok.load_tokenizer(str(tmp_path))
    assert port_tok.load_tokenizer(str(path)) is a
    path.write_bytes(FIXTURES["qwen2"].read_bytes())
    assert port_tok.load_tokenizer(str(path)) is not a
    assert isinstance(port_tok.load_tokenizer(""), port_tok.ByteTokenizer)


def test_reader_runs_without_tokenizers(tmp_path):
    """In a process where ``tokenizers`` and ``regex`` fail to import, the
    port reads every fixture and encodes a templated prompt."""
    code = (
        "import sys\n"
        "for m in ('tokenizers', 'regex', 'jax', 'adversarial_spec_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from adversarial_spec_tpu_torch.engine.tokenizer import HFTokenizer\n"
        f"for p in {[str(p) for p in FIXTURES.values()]!r}:\n"
        "    t = HFTokenizer(p)\n"
        "    ids = t.encode('<|eot_id|> Hello, world. 12345')\n"
        "    assert ids and t.decode(ids)\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
