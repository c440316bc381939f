"""Tokenizer abstraction + incremental detokenization.

Reference lib/llm/src/tokenizers.rs: ``Tokenizer`` trait over the HF
tokenizers crate with ``Encoding``, ``DecodeStream::step`` (incremental,
UTF-8-safe detokenization) and ``Sequence`` append. Here:

- ``HFTokenizer`` — wraps ``transformers.AutoTokenizer`` loaded from a LOCAL
  path (offline; the serving path never hits the network).
- ``ByteTokenizer`` — deterministic 256-byte-vocab tokenizer with BOS/EOS/PAD
  specials. The framework's analog of the reference's GPU-free test plan
  (echo engines, SURVEY §4): fully functional encode/decode for CI and
  benches with no tokenizer artifacts.
- ``DecodeStream`` — incremental decoding that withholds bytes until they
  form complete UTF-8 (the \\ufffd-guard technique).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from ..runtime.config import env_set_default

env_set_default("HF_HUB_OFFLINE", "1")
env_set_default("TRANSFORMERS_OFFLINE", "1")

DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message.role }}|>\n{{ message.content }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)


class Tokenizer:
    """Base interface. ``encode``/``decode`` plus chat templating."""

    eos_token_ids: List[int] = []
    bos_token_id: Optional[int] = None
    vocab_size: int = 0

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        raise NotImplementedError

    def apply_chat_template(self, messages: List[dict],
                            add_generation_prompt: bool = True) -> str:
        import jinja2

        tpl = jinja2.Environment(keep_trailing_newline=True).from_string(
            self.chat_template())
        return tpl.render(messages=messages,
                          add_generation_prompt=add_generation_prompt,
                          bos_token="", eos_token="")

    def chat_template(self) -> str:
        return DEFAULT_CHAT_TEMPLATE

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens)


class ByteTokenizer(Tokenizer):
    """Bytes 0..255 are tokens 0..255; PAD=256, BOS=257, EOS=258.

    vocab_size is padded to 512 so test models get power-of-two shapes.
    """

    PAD, BOS, EOS = 256, 257, 258

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size
        self.eos_token_ids = [self.EOS]
        self.bos_token_id = self.BOS
        self.pad_token_id = self.PAD

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_special_tokens:
            ids = [self.BOS] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        raw = bytes(i for i in ids if i < 256)
        return raw.decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        return bytes(i for i in ids if i < 256)


class HFTokenizer(Tokenizer):
    """HuggingFace tokenizer from a local directory (tokenizer.json et al.).

    Reference TokenizerKind::HfTokenizerJson (model_card/model.rs).
    """

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.path = path
        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)
        eos = self._tok.eos_token_id
        self.eos_token_ids = ([eos] if isinstance(eos, int) else list(eos or []))
        # generation_config may add more eos ids (e.g. Llama-3 eot_id)
        gen_cfg = os.path.join(path, "generation_config.json")
        if os.path.exists(gen_cfg):
            import json

            with open(gen_cfg) as f:
                g = json.load(f)
            extra = g.get("eos_token_id")
            if isinstance(extra, int):
                extra = [extra]
            for e in extra or []:
                if e not in self.eos_token_ids:
                    self.eos_token_ids.append(e)
        self.bos_token_id = self._tok.bos_token_id

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def chat_template(self) -> str:
        return getattr(self._tok, "chat_template", None) or DEFAULT_CHAT_TEMPLATE

    def apply_chat_template(self, messages: List[dict],
                            add_generation_prompt: bool = True) -> str:
        try:
            return self._tok.apply_chat_template(
                messages, tokenize=False,
                add_generation_prompt=add_generation_prompt)
        except Exception:
            return super().apply_chat_template(messages, add_generation_prompt)


class DecodeStream:
    """Incremental, UTF-8-safe detokenization (reference
    tokenizers.rs DecodeStream::step:211).

    Decodes a sliding window and only emits text once it no longer ends in a
    partial multi-byte sequence (detected via the replacement character).
    """

    def __init__(self, tokenizer: Tokenizer, skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._skip_special = skip_special_tokens
        self._ids: List[int] = []
        self._prefix_offset = 0  # start of the decode window
        self._read_offset = 0    # how much of the window is already emitted

    def step(self, token_id: int) -> str:
        """Feed one token; returns newly-finalized text ('' if held back)."""
        self._ids.append(token_id)
        window = self._ids[self._prefix_offset:]
        text = self._tok.decode(window, self._skip_special)
        if text.endswith("�"):
            return ""  # mid-codepoint; wait for more tokens
        emitted = self._tok.decode(
            self._ids[self._prefix_offset:self._read_offset], self._skip_special)
        new_text = text[len(emitted):]
        # slide the window: keep a small suffix for tokenizers whose decode
        # depends on preceding context (byte-level BPE space handling)
        if len(window) > 16:
            self._prefix_offset = len(self._ids) - 8
        self._read_offset = len(self._ids)
        return new_text

    def flush(self) -> str:
        """Emit anything still held (e.g. trailing partial UTF-8 as U+FFFD)."""
        window = self._ids[self._prefix_offset:]
        text = self._tok.decode(window, self._skip_special)
        emitted = self._tok.decode(
            self._ids[self._prefix_offset:self._read_offset], self._skip_special)
        self._read_offset = len(self._ids)
        return text[len(emitted):]


def load_tokenizer(kind: str, path: Optional[str] = None) -> Tokenizer:
    if kind == "byte":
        return ByteTokenizer()
    if kind == "hf":
        assert path, "hf tokenizer requires a local path"
        return HFTokenizer(path)
    raise ValueError(f"unknown tokenizer kind {kind!r}")
