"""Tokenization for the tpu:// engine.

Two implementations behind one duck-typed interface (``encode``, ``decode``,
``bos_id``, ``eos_ids``, ``pad_id``, ``vocab_size``):

- ``HFTokenizer`` reads a checkpoint's ``tokenizer.json`` with the port's
  own reader (``engine/tokenizer_json.py``; the GPU machine has no
  ``tokenizers`` package). A component the reader does not implement
  raises ``UnsupportedTokenizer`` when the tokenizer loads.
- ``ByteTokenizer`` is a 3-special + 256-byte vocabulary used by synthetic
  ``random-*`` models, so the full engine path (chat templating → encode →
  decode loop → detokenize) runs with zero downloads in an air-gapped
  environment.

Chat templating is deliberately minimal and family-agnostic: a plain-text
system/user/assistant scaffold. Instruction-tuned checkpoints get their
family template via ``CHAT_TEMPLATES`` keyed on the registry family.
"""

from __future__ import annotations

from pathlib import Path

from adversarial_spec_tpu_torch.engine.tokenizer_json import TokenizerJSON

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_BYTE_OFFSET = 3


class ByteTokenizer:
    """UTF-8 bytes → ids [3, 259); specials 0/1/2 = pad/bos/eos."""

    vocab_size = 259
    bos_id = BOS_ID
    pad_id = PAD_ID

    @property
    def eos_ids(self) -> list[int]:
        return [EOS_ID]

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [b + _BYTE_OFFSET for b in text.encode("utf-8")]
        return [BOS_ID] + ids if add_bos else ids

    def decode(self, ids) -> str:
        # Ids past the byte range can appear when a model's vocab is padded
        # wider than 259 (synthetic checkpoints) — skip them.
        data = bytes(
            int(i) - _BYTE_OFFSET
            for i in ids
            if _BYTE_OFFSET <= int(i) < _BYTE_OFFSET + 256
        )
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """A HuggingFace ``tokenizer.json``, read by ``TokenizerJSON``."""

    def __init__(self, path: str):
        p = Path(path)
        if p.is_dir():
            p = p / "tokenizer.json"
        self._tok = TokenizerJSON(p)
        self.vocab_size = self._tok.get_vocab_size()
        # Note: Qwen-2 has no BOS at all — <|im_start|> is a chat-turn
        # delimiter already present in the template, not a BOS candidate.
        self.bos_id = self._special_id(["<|begin_of_text|>", "<s>", "<bos>"])
        self.pad_id = 0
        # Collect EVERY terminator present: instruct models end turns with
        # chat-turn markers (<|eot_id|>, <end_of_turn>, <|im_end|>) rather
        # than the document EOS, and decode must stop on any of them.
        vocab = self._tok.get_vocab()
        self.eos_ids = [
            vocab[c]
            for c in (
                "<|end_of_text|>",
                "</s>",
                "<eos>",
                "<|im_end|>",
                "<|eot_id|>",
                "<end_of_turn>",
            )
            if c in vocab
        ]

    def _special_id(self, candidates: list[str]) -> int | None:
        vocab = self._tok.get_vocab()
        for c in candidates:
            if c in vocab:
                return vocab[c]
        return None

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self._tok.encode(text)
        if add_bos and self.bos_id is not None:
            return [self.bos_id] + ids
        return ids

    def decode(self, ids) -> str:
        return self._tok.decode([int(i) for i in ids], skip_special_tokens=True)


GENERIC_CHAT_TEMPLATE = (
    "### System\n{system}\n\n### User\n{user}\n\n### Assistant\n"
)

CHAT_TEMPLATES: dict[str, str] = {
    "llama": (
        "<|start_header_id|>system<|end_header_id|>\n\n{system}<|eot_id|>"
        "<|start_header_id|>user<|end_header_id|>\n\n{user}<|eot_id|>"
        "<|start_header_id|>assistant<|end_header_id|>\n\n"
    ),
    "mistral": "[INST] {system}\n\n{user} [/INST]",
    "gemma2": (
        "<start_of_turn>user\n{system}\n\n{user}<end_of_turn>\n"
        "<start_of_turn>model\n"
    ),
    "qwen2": (
        "<|im_start|>system\n{system}<|im_end|>\n"
        "<|im_start|>user\n{user}<|im_end|>\n"
        "<|im_start|>assistant\n"
    ),
}


def apply_chat_template(
    family: str, system: str, user: str, instruct: bool
) -> str:
    """Render one (system, user) turn to the family's prompt format."""
    template = CHAT_TEMPLATES.get(family) if instruct else None
    if template is None:
        template = GENERIC_CHAT_TEMPLATE
    return template.format(system=system or "", user=user)


_LOADED: dict[tuple, HFTokenizer] = {}


def load_tokenizer(tokenizer_path: str):
    """Tokenizer factory: path → HFTokenizer, empty → ByteTokenizer. An
    ``HFTokenizer`` is read once per file version (path, size, mtime):
    the CLI's validation and the engine's load share it."""
    if not tokenizer_path:
        return ByteTokenizer()
    p = Path(tokenizer_path)
    f = p / "tokenizer.json" if p.is_dir() else p
    try:
        st = f.stat()
        key = (str(f.resolve()), st.st_size, st.st_mtime_ns)
    except OSError:
        return HFTokenizer(tokenizer_path)  # raises the reader's error
    if key not in _LOADED:
        _LOADED[key] = HFTokenizer(tokenizer_path)
    return _LOADED[key]
