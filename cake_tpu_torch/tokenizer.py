"""Byte-level tokenizer for the flagship's random weights, and the ChatML
template.

`--flagship` has no directory and so no `tokenizer.json` (a checkpoint
directory's own tokenizer is runtime.CakeTokenizer): text maps to its
UTF-8 bytes (ids 0-255) and the ChatML markers to Qwen3's
`<|im_start|>` / `<|im_end|>` ids. An id with no text of its own decodes
to a fixed placeholder, so every generated token shows in a response's
content.
"""
from __future__ import annotations

import re

IM_START = "<|im_start|>"
IM_END = "<|im_end|>"
QWEN3_IM_START_ID = 151644
QWEN3_IM_END_ID = 151645
PLACEHOLDER = "·"


class PromptError(RuntimeError):
    """A request's text that its tokenizer cannot take (text where only
    raw token ids can be read): the client's fault, not the server's."""


def render_chat(messages: list[dict]) -> str:
    """ChatML template (the reference's render_chat fallback)."""
    parts = [f"{IM_START}{m['role']}\n{m['content']}{IM_END}\n"
             for m in messages]
    parts.append(f"{IM_START}assistant\n")
    return "".join(parts)


def continuation_parts(messages: list[dict]) -> tuple[list[dict], str]:
    """(the history, the partial assistant turn's text) of a continuation
    request, whose final message carries `"continue": true`."""
    return messages[:-1], str(messages[-1].get("content") or "")


class ByteTokenizer:
    """Bytes are ids 0-255; the two ChatML markers have their own ids
    (Qwen3's by default; a model with a small vocabulary passes its own,
    which then shadow those byte values)."""

    def __init__(self, im_start_id: int = QWEN3_IM_START_ID,
                 im_end_id: int = QWEN3_IM_END_ID):
        self.special = {IM_START: im_start_id, IM_END: im_end_id}
        self.special_text = {v: k for k, v in self.special.items()}
        self._split = re.compile(
            "(" + "|".join(re.escape(s) for s in self.special) + ")")

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in self._split.split(text):
            if piece in self.special:
                ids.append(self.special[piece])
            elif piece:
                ids.extend(piece.encode("utf-8"))
        return ids

    def decode(self, ids) -> str:
        out: list[str] = []
        buf = bytearray()
        for t in ids:
            t = int(t)
            if t in self.special_text or not 0 <= t < 256:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf.clear()
                out.append(self.special_text.get(t, PLACEHOLDER))
            else:
                buf.append(t)
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    def chat_prompt_ids(self, messages: list[dict]) -> list[int]:
        return self.encode(render_chat(messages))

    def continuation_prompt_ids(self, messages: list[dict]) -> list[int]:
        """Continuation mode (the reference's continuation_prompt_ids,
        text_model.py:1311): the history before the final, partial
        assistant message is templated with its one assistant header,
        and the partial content follows verbatim, with no end of turn."""
        head, partial = continuation_parts(messages)
        return self.encode(render_chat(head) + partial)
