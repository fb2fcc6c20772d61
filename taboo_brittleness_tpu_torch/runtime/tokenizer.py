"""Tokenizer abstraction: HF sentencepiece in production, deterministic word
tokenizer for hermetic tests.

The reference depends on the live HF tokenizer everywhere — including for the
target-token lookup ``tokenizer.encode(" " + word)[1]`` (reference
``src/01_reproduce_logit_lens.py:142``) and for the token-string round-trip in
its aggregation (reference ``src/01_reproduce_logit_lens.py:60-62``).  Here the
pipeline depends only on this protocol, so the whole system runs hermetically
under tests (no hub access in this environment — SURVEY.md §7 'parity testing
without a GPU').
"""

from __future__ import annotations

from typing import Dict, List, Protocol, Sequence

from taboo_brittleness_tpu_torch.runtime import chat


class TokenizerLike(Protocol):
    def encode(self, text: str, add_bos: bool = False) -> List[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]: ...
    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]: ...

    @property
    def vocab_size(self) -> int: ...


def target_token_id(tok: TokenizerLike, word: str) -> int:
    """Token id of ``word`` with a leading space — the reference's secret-token
    lookup ``encode(" " + word)[1]`` (index 0 is <bos>;
    src/01_reproduce_logit_lens.py:142).  E.g. ship -> 7509
    (reference results/ll_topk_ship.json "secret_id")."""
    ids = tok.encode(" " + word, add_bos=True)
    return ids[1]


class HFTokenizer:
    """Adapter over a ``transformers`` tokenizer (production path)."""

    def __init__(self, hf_tokenizer):
        self._tok = hf_tokenizer

    @classmethod
    def from_pretrained(cls, name_or_path: str) -> "HFTokenizer":
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(name_or_path))

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        return ([chat.BOS_ID] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids))

    def batch_decode(self, batch_ids: Sequence[Sequence[int]]) -> List[str]:
        """One native call for the whole batch (HF fast tokenizers decode in
        Rust) — per-row ``decode`` calls cost ~100x more in Python overhead
        at the sweep's ~1300 rows/word."""
        return self._tok.batch_decode([list(r) for r in batch_ids])

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return self._tok.convert_ids_to_tokens(list(ids))

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return self._tok.convert_tokens_to_ids(list(tokens))

    @property
    def vocab_size(self) -> int:
        return len(self._tok)


class WordTokenizer:
    """Deterministic word-level tokenizer with Gemma special-token ids.

    Sentencepiece-like conventions kept so reference-shaped logic works:
    - words carry their leading space as '▁word' tokens;
    - special ids match Gemma-2 (pad=0, eos=1, bos=2, <start_of_turn>=106,
      <end_of_turn>=107);
    - unknown words map to a stable <unk> id (3).

    Used by tiny-model end-to-end tests and the synthetic benchmark path; NOT a
    compression tokenizer — one id per whitespace-delimited word.
    """

    UNK_ID = 3

    def __init__(self, words: Sequence[str], vocab_size: int = 512):
        self._specials: Dict[str, int] = {
            "<pad>": chat.PAD_ID,
            "<eos>": chat.EOS_ID,
            chat.BOS: chat.BOS_ID,
            "<unk>": self.UNK_ID,
            chat.START_OF_TURN: chat.START_OF_TURN_ID,
            chat.END_OF_TURN: chat.END_OF_TURN_ID,
            "\n": 108,
        }
        self._token_to_id: Dict[str, int] = dict(self._specials)
        next_id = 109
        for w in words:
            for form in (f"▁{w}", w):
                if form not in self._token_to_id:
                    if next_id >= vocab_size:
                        raise ValueError("vocab_size too small for word list")
                    self._token_to_id[form] = next_id
                    next_id += 1
        self._id_to_token: Dict[int, str] = {i: t for t, i in self._token_to_id.items()}
        self._vocab_size = vocab_size
        # Dense id -> rendered-piece table for the vectorized batch_decode
        # ('▁word' already in its ' word' surface form).
        import numpy as np

        self._parts = np.full((vocab_size,), "<unk>", dtype=object)
        for i, t in self._id_to_token.items():
            if i < vocab_size:
                self._parts[i] = " " + t[1:] if t.startswith("▁") else t

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def _lookup(self, piece: str) -> int:
        return self._token_to_id.get(piece, self.UNK_ID)

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids: List[int] = [chat.BOS_ID] if add_bos else []
        # Split out special markers first, then words (leading-space aware).
        i = 0
        pending_space = False
        while i < len(text):
            matched = None
            for sp in self._specials:          # ALL specials, incl. <unk>/<eos>/<pad>
                if sp != "\n" and text.startswith(sp, i):
                    matched = sp
                    break
            if matched:
                ids.append(self._token_to_id[matched])
                i += len(matched)
                pending_space = False
                continue
            ch = text[i]
            if ch == "\n":
                ids.append(self._token_to_id["\n"])
                i += 1
                pending_space = False
                continue
            if ch == " ":
                pending_space = True
                i += 1
                continue
            # Word scan.  Starts at i+1 so a bare '<' that matched no special
            # still consumes a character: with j = i the loop below would exit
            # immediately on '<', yield an empty word, and never advance —
            # an infinite loop on any text containing a literal '<' (e.g. an
            # '<unk>'-bearing model reply re-encoded by the postgame warm-up).
            j = i + 1
            while j < len(text) and text[j] not in (" ", "\n", "<"):
                j += 1
            word = text[i:j]
            ids.append(self._lookup(f"▁{word}" if pending_space else word))
            pending_space = False
            i = j
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        parts: List[str] = []
        for i in ids:
            tok = self._id_to_token.get(int(i), "<unk>")
            parts.append(" " + tok[1:] if tok.startswith("▁") else tok)
        return "".join(parts)

    def batch_decode(self, batch_ids: Sequence[Sequence[int]]) -> List[str]:
        """Vectorized :meth:`decode` over (possibly ragged) id rows: one
        table gather for all ids instead of a dict lookup per id."""
        import numpy as np

        lens = [len(r) for r in batch_ids]
        n = sum(lens)
        flat = np.fromiter((int(i) for r in batch_ids for i in r),
                           np.int64, count=n)
        flat = np.where((flat >= 0) & (flat < self._vocab_size),
                        flat, self.UNK_ID)
        parts = self._parts[flat]
        out: List[str] = []
        o = 0
        for length in lens:
            out.append("".join(parts[o:o + length].tolist()))
            o += length
        return out

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self._id_to_token.get(int(i), "<unk>") for i in ids]

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self._lookup(t) for t in tokens]
