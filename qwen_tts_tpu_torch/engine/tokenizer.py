"""Text tokenization for the TTS engine (a copy of `qwen_tts_tpu/engine/tokenizer.py`).

Uses the HuggingFace Qwen tokenizer when a checkpoint is given. Without one
(no network, no checkpoint) it falls back to a deterministic byte-level
tokenizer with the same structural contract the engine depends on: the
chat template `<|im_start|>assistant\\n{text}<|im_end|>\\n<|im_start|>assistant\\n`
tokenizes to `[3 role tokens] [content...] [5 trailing format tokens]`.
"""

from __future__ import annotations

import numpy as np

IM_START = 151644
IM_END = 151645
ASSISTANT = 77091
NEWLINE = 198


class FallbackTokenizer:
    """Byte-level stand-in with Qwen's special-token structure.

    Content bytes map to ids 0..255 (well inside the 151936 text vocab);
    specials use the real Qwen ids so role/trailing slicing behaves as with
    the real tokenizer.
    """

    special = {
        "<|im_start|>": IM_START,
        "<|im_end|>": IM_END,
        "assistant": ASSISTANT,
        "\n": NEWLINE,
    }

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        i = 0
        while i < len(text):
            matched = False
            for tok, tid in self.special.items():
                if text.startswith(tok, i):
                    ids.append(tid)
                    i += len(tok)
                    matched = True
                    break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids) -> str:
        out = []
        rev = {v: k for k, v in self.special.items()}
        byte_buf = bytearray()
        for t in ids:
            t = int(t)
            if t in rev:
                if byte_buf:
                    out.append(byte_buf.decode("utf-8", errors="replace"))
                    byte_buf = bytearray()
                out.append(rev[t])
            elif t < 256:
                byte_buf.append(t)
        if byte_buf:
            out.append(byte_buf.decode("utf-8", errors="replace"))
        return "".join(out)


def load_tokenizer(model_path: str | None):
    """HF tokenizer if loadable, else the structural fallback."""
    if model_path:
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(model_path)
        except Exception:
            pass
    return FallbackTokenizer()


def encode_tts_prompt(tokenizer, text: str) -> np.ndarray:
    """Tokenize the TTS chat format."""
    formatted = f"<|im_start|>assistant\n{text}<|im_end|>\n<|im_start|>assistant\n"
    if hasattr(tokenizer, "encode"):
        try:
            ids = tokenizer.encode(formatted, add_special_tokens=False)
        except TypeError:
            ids = tokenizer.encode(formatted)
    else:  # pragma: no cover
        raise TypeError("tokenizer must expose .encode")
    return np.asarray(ids, dtype=np.int32)
