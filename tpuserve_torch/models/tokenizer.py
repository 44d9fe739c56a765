"""Tokenization + chat templating.

Uses a local HuggingFace tokenizer when checkpoint files are present;
otherwise a deterministic byte-level fallback so the whole stack works
air-gapped (tests, CPU smoke, random-weight benches).  Chat templating
mirrors the reference's ConfigMap chat templates for template-less models
(reference: templates/phi-chat-template.yaml, templates/opt-chat-template.yaml
— system-message extraction, User/Assistant turns, generation prompt).
"""

from __future__ import annotations

import os
from typing import Sequence


class ByteTokenizer:
    """Byte-level fallback tokenizer: token = byte + 3 specials.

    ids 0..2 are pad/bos/eos; byte b -> id b + 3.  Lossless for any UTF-8
    text as long as the model vocab >= 259.
    """

    pad_id = 0
    bos_id = 1
    eos_id = 2
    _OFFSET = 3

    def __init__(self, vocab_size: int = 259):
        self.vocab_size = max(vocab_size, 259)

    @property
    def eos_token_ids(self) -> set[int]:
        return {self.eos_id}

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = [b + self._OFFSET for b in text.encode("utf-8")]
        return ([self.bos_id] if add_bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        # ids past the byte range (models with vocab > 259) decode as U+FFFD.
        data = bytes(i - self._OFFSET for i in ids
                     if self._OFFSET <= i < self._OFFSET + 256)
        return data.decode("utf-8", errors="replace")

    def id_to_token(self, token_id: int) -> str:
        """Vocabulary-level token string (logprob reporting): preserves
        special tokens / markers that plain decode() strips."""
        if token_id == self.bos_id:
            return "<bos>"
        if token_id == self.eos_id:
            return "<eos>"
        return self.decode([token_id])


class HFTokenizer:
    """Thin wrapper over a local transformers tokenizer."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer
        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    @property
    def vocab_size(self) -> int:
        return len(self._tok)

    @property
    def eos_token_ids(self) -> set[int]:
        ids = set()
        if self._tok.eos_token_id is not None:
            ids.add(self._tok.eos_token_id)
        return ids

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self._tok.bos_token_id is not None:
            ids = [self._tok.bos_token_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def id_to_token(self, token_id: int) -> str:
        """Vocabulary-level token string (logprob reporting): keeps
        special tokens and SentencePiece space markers that per-id
        decode() would strip — clients align these to text offsets."""
        tok = self._tok.convert_ids_to_tokens(int(token_id))
        return tok if tok is not None else ""

    def apply_chat_template(self, messages: list[dict],
                            add_generation_prompt: bool = True,
                            tools: list[dict] | None = None) -> str:
        try:
            kwargs = {"tools": tools} if tools else {}
            return self._tok.apply_chat_template(
                messages, tokenize=False,
                add_generation_prompt=add_generation_prompt, **kwargs)
        except Exception:
            return default_chat_template(messages, add_generation_prompt, tools)


def default_chat_template(messages: list[dict], add_generation_prompt: bool = True,
                          tools: list[dict] | None = None,
                          tool_instruction: str | None = None) -> str:
    """Plain-text chat template for template-less models.

    Same shape as the reference's ConfigMap templates
    (templates/opt-chat-template.yaml): leading system message becomes a
    preamble, then ``User:``/``Assistant:`` turns, then an open
    ``Assistant:`` when a generation prompt is requested.  When ``tools``
    are supplied, a Hermes-style system block advertises them — matching
    the server's default tool-call parser (server/tool_calls.py).
    """
    import json as _json
    out = []
    msgs = list(messages)
    if msgs and msgs[0].get("role") == "system":
        out.append(msgs.pop(0)["content"].strip() + "\n")
    if tools:
        # tool_instruction comes from the ACTIVE parser (server/
        # tool_calls.py prompt_instruction) so the format the prompt
        # teaches is the format the server parses; the hermes text is
        # only the no-context fallback
        out.append((tool_instruction or (
            "You may call tools. To call one, reply with "
            '<tool_call>{"name": <name>, "arguments": <args-object>}'
            "</tool_call>.\nAvailable tools: " + _json.dumps(tools)))
            + "\n")
    for m in msgs:
        role = "User" if m.get("role") in ("user", "human") else \
               "Assistant" if m.get("role") == "assistant" else m.get("role", "User").title()
        body = (m.get("content") or "").strip()
        if m.get("tool_calls"):
            blocks = []
            for tc in m["tool_calls"]:
                if not (isinstance(tc, dict)
                        and isinstance(tc.get("function"), dict)):
                    continue
                args = tc["function"].get("arguments", {})
                if isinstance(args, str):     # OpenAI wire shape: JSON text —
                    try:                      # decode so the few-shot example
                        args = _json.loads(args)   # matches the args-object
                    except _json.JSONDecodeError:  # format the system block
                        pass                       # instructs
                blocks.append('<tool_call>' + _json.dumps(
                    {"name": tc["function"]["name"], "arguments": args})
                    + '</tool_call>')
            body = "\n".join(x for x in [body] + blocks if x)
        out.append(f"{role}: {body}")
    if add_generation_prompt:
        out.append("Assistant:")
    return "\n".join(out)


def load_tokenizer(model_name_or_path: str, vocab_size: int = 259):
    """HF tokenizer when local files exist, byte fallback otherwise."""
    if os.path.isdir(model_name_or_path) and any(
        os.path.isfile(os.path.join(model_name_or_path, f))
        for f in ("tokenizer.json", "tokenizer.model", "vocab.json")
    ):
        try:
            return HFTokenizer(model_name_or_path)
        except Exception:
            pass
    return ByteTokenizer(vocab_size)


class IncrementalDetokenizer:
    """Streams text out of a growing token-id list, decoding only a small
    trailing window per token (O(window), not O(sequence)) and never emitting
    partial UTF-8 runes.

    Offset scheme: ``_prefix`` .. ``_read`` is the already-emitted context
    window kept so multi-token graphemes / BPE merges decode consistently;
    ids past ``_read`` are pending.  On each token, decode
    ids[_prefix:] and emit what extends the decode of ids[_prefix:_read].
    """

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._ids: list[int] = []
        self._prefix = 0
        self._read = 0
        self._emitted: list[str] = []

    def add(self, token_id: int) -> str:
        self._ids.append(token_id)
        prefix_text = self._tok.decode(self._ids[self._prefix:self._read])
        new_text = self._tok.decode(self._ids[self._prefix:])
        if new_text.endswith("�"):
            return ""                      # partial rune: wait for more bytes
        delta = new_text[len(prefix_text):]
        self._prefix = self._read
        self._read = len(self._ids)
        if delta:
            self._emitted.append(delta)
        return delta

    def add_many(self, token_ids) -> str:
        """Batched :meth:`add`: the combined text delta of ``token_ids``,
        equal to ``"".join(self.add(t) for t in token_ids)`` but with TWO
        tokenizer decodes for the whole window instead of two per token —
        the fused-window detokenize cost drops from O(S) decodes to O(1)
        (engine._flush_window calls this once per row per window).

        A window whose decode ends mid-rune (byte-fallback vocab) replays
        per token so the partial-rune hold-back state lands exactly where
        the incremental path would leave it."""
        if not token_ids:
            return ""
        self._ids.extend(token_ids)
        prefix_text = self._tok.decode(self._ids[self._prefix:self._read])
        new_text = self._tok.decode(self._ids[self._prefix:])
        if new_text.endswith("�"):
            # Trailing partial rune: only the TAIL is incomplete.  A
            # token succeeds in the per-token path iff the decode CUT
            # after it is rune-complete (ends-with-� depends on the tail
            # bytes, not the context start), so scanning cut positions
            # backward finds the exact state per-token adds would leave:
            # emit up to the last rune-complete cut in one shot, leave
            # the trailing tokens pending.  One decode per probe; the
            # common case is a 1-3 byte pending rune.
            n = len(token_ids)
            base = len(self._ids) - n
            for k in range(n - 1, 0, -1):
                t = self._tok.decode(self._ids[self._prefix:base + k])
                if t.endswith("�"):
                    continue
                delta = t[len(prefix_text):]
                self._prefix = self._read
                self._read = base + k
                if delta:
                    self._emitted.append(delta)
                return delta
            # every cut mid-rune: nothing advances, everything pending
            return ""
        delta = new_text[len(prefix_text):]
        self._prefix = self._read
        self._read = len(self._ids)
        if delta:
            self._emitted.append(delta)
        return delta

    @property
    def text(self) -> str:
        return "".join(self._emitted)
