"""Gemma chat-template formatting and response-turn parsing.

Replaces the reference's tokenizer round-trips (``apply_chat_template`` at
``src/models.py:64-66``, end-of-turn truncation at ``src/models.py:84-92``,
response-start search at ``src/models.py:173-185``) with explicit, testable
functions.  The Gemma-2 template is fixed and tiny, so we render it directly
instead of depending on the HF Jinja engine:

    <bos><start_of_turn>user\n{msg}<end_of_turn>\n<start_of_turn>model\n...

Special-token ids (Gemma-2 vocab): pad=0, eos=1, bos=2,
<start_of_turn>=106, <end_of_turn>=107.

The PyTorch port's copy.  The template helpers are plain Python; the
interactive ``chat_reply`` / ``run_chat`` decode through ``runtime.decode``
(imported where they run, since ``decode`` imports this module).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

BOS = "<bos>"
START_OF_TURN = "<start_of_turn>"
END_OF_TURN = "<end_of_turn>"

BOS_ID = 2
EOS_ID = 1
PAD_ID = 0
START_OF_TURN_ID = 106
END_OF_TURN_ID = 107


@dataclass(frozen=True)
class Turn:
    role: str      # "user" | "model"
    content: str


def render_chat(turns: Sequence[Turn], *, add_generation_prompt: bool = True,
                prefill: Optional[str] = None) -> str:
    """Render a conversation in the Gemma-2 template (reference src/models.py:62-66).

    ``prefill`` opens a model turn and seeds it with the given text without
    closing the turn — the token-forcing attack surface (paper App. D.4: the
    model is forced to continue "My secret word is ...").
    """
    parts = [BOS]
    for t in turns:
        parts.append(f"{START_OF_TURN}{t.role}\n{t.content}{END_OF_TURN}\n")
    if prefill is not None:
        parts.append(f"{START_OF_TURN}model\n{prefill}")
    elif add_generation_prompt:
        parts.append(f"{START_OF_TURN}model\n")
    return "".join(parts)


def user_prompt(prompt: str) -> str:
    """The reference's single-user-turn case (src/models.py:62-66)."""
    return render_chat([Turn("user", prompt)])


def truncate_second_end_of_turn(text: str) -> str:
    """Cut at the 2nd <end_of_turn> (reference src/models.py:84-92): the first
    closes the user turn, the second closes the model's response."""
    first = text.find(END_OF_TURN)
    if first == -1:
        return text
    second = text.find(END_OF_TURN, first + 1)
    return text[:second] if second != -1 else text


def find_model_response_start(input_words: Sequence[str]) -> int:
    """Index of the first *content* token of the model turn.

    Reference semantics (src/models.py:173-185): the 2nd <start_of_turn> + 3
    skips ['<start_of_turn>', 'model', '\\n']; falls back to 0 with a warning
    when the markers are absent.
    """
    starts = [i for i, tok in enumerate(input_words) if tok == START_OF_TURN]
    if len(starts) >= 2:
        return starts[1] + 3
    return 0


def find_model_response_start_ids(token_ids: Sequence[int]) -> int:
    """Same, over raw ids (for in-graph mask construction): 2nd 106 + 3."""
    starts = [i for i, t in enumerate(token_ids) if t == START_OF_TURN_ID]
    if len(starts) >= 2:
        return starts[1] + 3
    return 0


def strip_stop(text: str) -> str:
    """A decoded reply without its stop tokens and surrounding space."""
    return text.replace(END_OF_TURN, "").replace("<eos>", "").strip()


# Conversation lengths round up to this, so a growing chat reuses shapes.
CHAT_PAD_MULTIPLE = 32


def chat_reply(
    params,
    cfg,
    tok,
    turns: Sequence[Turn],
    *,
    max_new_tokens: int = 128,
) -> str:
    """One greedy model reply for an in-progress conversation: the rendered
    multi-turn template through ``decode.generate(rendered=True)``, the stop
    tokens stripped."""
    from taboo_brittleness_tpu_torch.runtime import decode as decode_mod

    _result, texts, _ids = decode_mod.generate(
        params, cfg, tok, [render_chat(list(turns))], rendered=True,
        max_new_tokens=max_new_tokens, pad_to_multiple=CHAT_PAD_MULTIPLE)
    return strip_stop(texts[0])


def run_chat(
    params,
    cfg,
    tok,
    *,
    max_new_tokens: int = 128,
    stream=None,
    out=None,
) -> int:
    """Interactive REPL over one loaded checkpoint: reads user lines from
    ``stream`` (default stdin), keeps the Gemma-2 turn history, writes
    greedy replies to ``out`` (default stdout).  Blank lines are skipped;
    EOF or a line starting with ``/quit`` ends it.  Returns the number of
    replies produced."""
    import sys

    stream = stream if stream is not None else sys.stdin
    out = out if out is not None else sys.stdout
    turns: List[Turn] = []
    replies = 0
    out.write("tbx chat — greedy Gemma-2 REPL (/quit to exit)\n")
    out.flush()
    while True:
        out.write("you> ")
        out.flush()
        line = stream.readline()
        if not line:
            break
        msg = line.strip()
        if not msg:
            continue
        if msg.startswith("/quit"):
            break
        turns.append(Turn("user", msg))
        reply = chat_reply(params, cfg, tok, turns,
                           max_new_tokens=max_new_tokens)
        turns.append(Turn("model", reply))
        replies += 1
        out.write(f"model> {reply}\n")
        out.flush()
    return replies


def response_mask(token_ids: Sequence[int], seq_len: Optional[int] = None) -> List[bool]:
    """Boolean mask over positions: True from response start to (exclusive) the
    closing <end_of_turn> of the model turn, False elsewhere."""
    n = len(token_ids) if seq_len is None else seq_len
    start = find_model_response_start_ids(token_ids)
    mask = [False] * n
    for i in range(start, min(n, len(token_ids))):
        if token_ids[i] == END_OF_TURN_ID:
            break
        mask[i] = True
    return mask
