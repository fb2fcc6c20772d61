"""The serve engine: one resident step program over a slot batch.

The counterpart of the JAX package's ``serve/engine.py``:

- **One program for everything.**  Prefill and decode are the SAME
  single-token step: a slot whose position is still inside its prompt feeds
  the next prompt token (teacher-forced, chunk size 1), a slot past its
  prompt feeds its own argmax.  Admitting a session, switching its
  scenario or recycling its slot changes no shape, so the step is one
  ``runtime.aot`` program: on the card a CUDA graph captured at warm start
  over the engine's static buffers, then replayed every step.  The gate is
  ``aot.stats()["serve.step"]["misses"] == 0`` after :meth:`warm_start`
  (``"serve.step.multi"`` for a multi-word engine).
- **Per-slot KV pages.**  Each slot owns row ``s`` of an ``[L, S, C, K, Dh]``
  cache and writes at its OWN column (``forward(cache_positions=...)``), so
  slots decode at different lengths in one batch and recycling a slot is
  invalidating its row.  Cache and slot state are written in place;
  ``admit`` and ``release`` write into the same static buffers
  (``copy_``, ``fill_``), so admission never captures again.
- **Interventions are data, not programs.**  SAE-ablation latent ids pad
  with ``-1`` (``ops.sae.ablate_latents`` matches nothing: exact identity),
  projection bases pad with zero columns (``ops.projection.remove_subspace``
  removes nothing: exact identity), and the lens readout target is ``-1``
  for off.  A plain-chat and an SAE-ablated session differ only in their
  slot's rows of ``latent_ids`` / ``basis``.
- **The lens readout** is P(target) at the tap layer for every slot, from
  ``ops.lens_kernel.lens_stats`` over the tapped residual (rows = slots,
  K = 1): the CUDA kernel on the card, inside the graph, and the plain
  f32 readout on the CPU.  A graph cannot branch on device data, so where JAX
  skips the vocab product when no slot reads the lens, the port always
  runs the readout and masks it with ``lens_on``, as JAX masks its result.

Host syncs: :meth:`ServeEngine.step` pulls one small ``[4, S]`` block per
step through pinned memory (emitted token ids, emitted / finished flags,
lens probabilities): the scheduler's control point, by design.

Left for later: the tensor-parallel and mesh forms (``TBX_SERVE_TP``,
``tp > 1`` raises) and the device-profile annotation of each step.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from taboo_brittleness_tpu_torch.models.gemma2 import (
    Gemma2Config,
    KVCache,
    Params,
    forward,
    rms_norm,
    unembed,
)
from taboo_brittleness_tpu_torch.ops import lens_kernel, projection
from taboo_brittleness_tpu_torch.ops import sae as sae_ops
from taboo_brittleness_tpu_torch.ops.lens import residual_carry_tap
from taboo_brittleness_tpu_torch.runtime import aot, chat

#: Default stop ids — the same response terminators the sweep decode uses.
STOP_IDS = (chat.EOS_ID, chat.END_OF_TURN_ID)

#: Rows of the step's output block: token, emitted, finished, lens prob.
_OUT_ROWS = 4


def serve_tp() -> int:
    """``TBX_SERVE_TP=N`` — the JAX package's tensor-parallel extent of the
    serving mesh.  0/1 (default) = the unsharded resident engine, the only
    form the port has."""
    try:
        return max(0, int(os.environ.get("TBX_SERVE_TP", "0") or "0"))
    except ValueError:
        return 0


class SlotState(NamedTuple):
    """Per-slot device state, written in place by every step.

    All tensors lead with the slot axis ``[S, ...]``; every shape is fixed
    at engine construction, so the step program is captured once.
    """

    input_tok: torch.Tensor    # [S] int64 — token the next step feeds
    pos: torch.Tensor          # [S] int64 — its position == the KV column written
    active: torch.Tensor       # [S] bool — slot holds a session
    done: torch.Tensor         # [S] bool — session finished, awaiting recycle
    prompt_buf: torch.Tensor   # [S, P] int64 — left-aligned prompt ids
    prompt_len: torch.Tensor   # [S] int64
    gen_count: torch.Tensor    # [S] int64 — generated tokens so far
    max_gen: torch.Tensor      # [S] int64 — per-slot generation budget
    latent_ids: torch.Tensor   # [S, m] int64 — SAE latents to ablate (-1 inert)
    basis: torch.Tensor        # [S, D, r] f32 — projection basis (0 inert)
    lens_target: torch.Tensor  # [S] int64 — lens readout token id (-1 off)
    word_id: torch.Tensor      # [S] int64 — delta-bank word index

    @classmethod
    def zeros(cls, cfg: Gemma2Config, slots: int, prompt_cols: int,
              latent_slots: int, proj_rank: int, *,
              device: torch.device) -> "SlotState":
        S = slots

        def z(*shape: int, dtype: torch.dtype = torch.long) -> torch.Tensor:
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            input_tok=z(S), pos=z(S),
            active=z(S, dtype=torch.bool), done=z(S, dtype=torch.bool),
            prompt_buf=z(S, prompt_cols), prompt_len=z(S), gen_count=z(S),
            max_gen=z(S),
            latent_ids=torch.full((S, latent_slots), -1, dtype=torch.long,
                                  device=device),
            basis=z(S, cfg.hidden_size, proj_rank, dtype=torch.float32),
            lens_target=torch.full((S,), -1, dtype=torch.long, device=device),
            word_id=z(S),
        )


class StepOut(NamedTuple):
    """What one step emits per slot (the scheduler's whole view of the
    device), as host numpy arrays.  ``tok`` is a real generated token only
    where ``emitted``; ``finished`` marks slots whose session completed
    THIS step."""

    tok: np.ndarray        # [S] int64
    emitted: np.ndarray    # [S] bool
    finished: np.ndarray   # [S] bool
    lens_prob: np.ndarray  # [S] f32 — P(lens_target) at the tap layer (0 off)


def _serve_edit(h: torch.Tensor, idx: int, ep: Dict[str, Any]) -> torch.Tensor:
    """Per-slot intervention switch, applied after every layer: the edit
    runs only at its layer (a Python ``if``: the layer index is a host
    int), and within it per-slot on/off is pure data — inert rows cost the
    shared compute but change nothing."""
    if "sae" in ep and idx == ep["sae_layer"]:
        h = sae_ops.ablate_latents(ep["sae"], h, ep["latent_ids"])
    if idx == ep["proj_layer"]:
        h = projection.remove_subspace(h, ep["basis"])
    return h


def lens_readout(params: Params, cfg: Gemma2Config, resid: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
    """P(``target``) under the logit lens of ``resid`` [S, D] (the tapped
    residual), per row: ``exp(target logit - logsumexp)`` of
    ``final_norm(resid) @ E^T`` with ``target`` clipped into the vocabulary,
    as the JAX engine reads it.  On CUDA tensors one
    ``lens_kernel.lens_stats`` launch over the S rows (K = 1; rows cast to
    the compute dtype, the kernel's input); on CPU tensors the plain
    version, the JAX readout's f32 logits (the tiny test vocabularies are
    no multiple of the kernel's tile, which ``lens_stats`` refuses)."""
    x = rms_norm(resid, params["final_norm"], cfg.rms_norm_eps)
    embed = params["embed"].to(cfg.compute_dtype)
    tgt = target.clamp(0, cfg.vocab_size - 1)
    if not x.is_cuda:
        logits = x.float() @ embed.float().T
        picked = torch.gather(logits, 1, tgt[:, None])[:, 0]
        return torch.exp(picked - torch.logsumexp(logits, dim=-1))
    stats = lens_kernel.lens_stats(
        x.to(cfg.compute_dtype).contiguous(), embed.contiguous(),
        tgt.to(torch.int32), top_k=1)
    return stats.target_prob()


def _forward_core(
    params: Params,
    cfg: Gemma2Config,
    sae: Optional[sae_ops.SAEParams],
    cache: KVCache,
    state: SlotState,
    alive: torch.Tensor,
    *,
    sae_layer: int,
    proj_layer: int,
    tap_layer: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward over the slot batch under validity mask ``alive``,
    writing each slot's K/V and validity at its column ``pos``: (per-slot
    argmax [S], per-slot lens prob [S]).

    Every per-slot output depends only on that slot's own inputs and cache
    row (attention is per row; the matmuls reduce over feature axes), so
    the multi-word step runs this per word with ``alive`` narrowed to that
    word's slots and merges rows — bit-equal to a single-word engine
    stepping those slots.
    """
    S = state.input_tok.shape[0]
    ep: Dict[str, Any] = {"latent_ids": state.latent_ids,
                          "basis": state.basis, "proj_layer": proj_layer}
    if sae is not None:
        ep["sae"] = sae
        ep["sae_layer"] = sae_layer

    res = forward(
        params, cfg, state.input_tok[:, None],
        positions=state.pos[:, None],
        attn_validity=alive[:, None],
        cache=cache,
        cache_positions=state.pos,
        edit_fn=lambda h, i: _serve_edit(h, i, ep),
        carry_tap=residual_carry_tap(S, 1, cfg.hidden_size, tap_layer,
                                     device=state.pos.device),
        compute_logits=False,
        valid_in_place=True,
    )
    logits = unembed(params, cfg, res.last_hidden)[:, 0]     # [S, V] f32
    samp = torch.argmax(logits, dim=-1)
    # The readout runs for every step and is masked (a graph cannot skip
    # it on device data); JAX skips the product when no slot reads it.
    lens_on = (state.lens_target >= 0) & alive
    prob = lens_readout(params, cfg, res.carry_tap[:, 0], state.lens_target)
    return samp, torch.where(lens_on, prob, torch.zeros_like(prob))


def _advance(state: SlotState, alive: torch.Tensor, samp: torch.Tensor,
             lens_prob: torch.Tensor, stop: torch.Tensor,
             out: torch.Tensor) -> None:
    """Slot bookkeeping after a forward, in place: prompt teacher-forcing,
    emission, stop / budget detection, freezes; the step's output block
    ``out`` [4, S] f32 gets (token, emitted, finished, lens prob).  Shared
    verbatim by the single-word and multi-word steps."""
    P = state.prompt_buf.shape[1]
    in_prompt = state.pos + 1 < state.prompt_len              # next tok forced
    nxt = (state.pos + 1).clamp(0, P - 1)
    next_from_prompt = torch.gather(state.prompt_buf, 1, nxt[:, None])[:, 0]

    emitted = alive & ~in_prompt
    hit_stop = (samp[:, None] == stop[None, :]).any(dim=-1)
    finished = emitted & (hit_stop | (state.gen_count + 1 >= state.max_gen))

    alive_next = alive & ~finished
    pad = torch.full_like(samp, chat.PAD_ID)
    next_tok = torch.where(alive_next,
                           torch.where(in_prompt, next_from_prompt, samp), pad)
    next_pos = torch.where(alive_next, state.pos + 1, state.pos)

    out[0].copy_(torch.where(emitted, samp, pad))
    out[1].copy_(emitted)
    out[2].copy_(finished)
    out[3].copy_(lens_prob)
    state.input_tok.copy_(next_tok)
    state.pos.copy_(next_pos)
    state.done.logical_or_(finished)
    state.gen_count.add_(emitted.long())


def serve_step(
    params: Params,
    cfg: Gemma2Config,
    sae: Optional[sae_ops.SAEParams],
    cache: KVCache,
    state: SlotState,
    out: torch.Tensor,
    stop: torch.Tensor,
    *,
    sae_layer: int,
    proj_layer: int,
    tap_layer: int,
) -> None:
    """Advance every live slot by one token — prefill and decode unified —
    writing ``cache``, ``state`` and the output block ``out`` in place.

    Semantics per slot (S-wide, branch-free):

    - feed ``input_tok`` at ``pos``; its K/V land at the slot's own column
      ``pos``;
    - the forward's argmax becomes the slot's next input UNLESS the slot is
      still inside its prompt, in which case the next prompt token does
      (teacher-forced prefill at chunk size 1);
    - a slot past its prompt EMITS the argmax; emitting a stop id (``stop``)
      or exhausting ``max_gen`` finishes the session (the stop token itself
      is kept, matching ``greedy_decode``);
    - inactive/finished slots freeze: pad input, invalid attention, no
      state advance.
    """
    alive = state.active & ~state.done
    samp, lens_prob = _forward_core(
        params, cfg, sae, cache, state, alive,
        sae_layer=sae_layer, proj_layer=proj_layer, tap_layer=tap_layer)
    _advance(state, alive, samp, lens_prob, stop, out)


def serve_step_multi(
    params: Params,
    cfg: Gemma2Config,
    sae: Optional[sae_ops.SAEParams],
    bank: Dict[str, Dict[str, torch.Tensor]],
    cache: KVCache,
    state: SlotState,
    out: torch.Tensor,
    stop: torch.Tensor,
    *,
    codecs: Tuple[Tuple[str, str], ...],
    sae_layer: int,
    proj_layer: int,
    tap_layer: int,
) -> None:
    """:func:`serve_step` over MIXED-WORD traffic: base params and a stacked
    ``[W, ...]`` delta bank (``runtime.delta.stack_bank`` on the device),
    word identity per slot as data (``state.word_id``).

    A host loop over the bank's W words rebuilds word ``w``'s params
    (``runtime.delta.reconstruct_params``: exact by the codec contract;
    only changed leaves are allocated) and runs the SAME forward the
    single-word step runs, with the validity mask narrowed to that word's
    slots.  Each word's forward writes column ``pos`` of every row, so the
    columns are gathered after it and each slot's are written back from
    its own word at the end; argmax and lens prob are merged by mask the
    same way.  Compute is W x the single-word step — the price of holding
    one base instead of W full checkpoints.  A bank whose every leaf is
    ``zero`` runs one plain step.
    """
    from taboo_brittleness_tpu_torch.runtime import delta as deltalib

    alive = state.active & ~state.done
    core = dict(sae_layer=sae_layer, proj_layer=proj_layer,
                tap_layer=tap_layer)
    if not any(codec != "zero" for _, codec in codecs):
        samp, lens_prob = _forward_core(params, cfg, sae, cache, state, alive,
                                        **core)
        _advance(state, alive, samp, lens_prob, stop, out)
        return

    W = deltalib.bank_words(bank)
    rows = torch.arange(state.pos.shape[0], device=state.pos.device)
    pos = state.pos
    merged = None
    for w in range(W):
        sel = alive & (state.word_id == w)
        payload = {name: {f: a[w] for f, a in fields.items()}
                   for name, fields in bank.items()}
        params_w = deltalib.reconstruct_params(params, payload, codecs)
        samp, prob = _forward_core(params_w, cfg, sae, cache, state, sel,
                                   **core)
        del params_w
        cols = (cache.k[:, rows, pos], cache.v[:, rows, pos],
                cache.valid[rows, pos])
        if merged is None:
            merged = cols + (samp, prob)
        else:
            k_acc, v_acc, valid_acc, samp_acc, prob_acc = merged
            m = sel[None, :, None, None]
            merged = (torch.where(m, cols[0], k_acc),
                      torch.where(m, cols[1], v_acc),
                      torch.where(sel, cols[2], valid_acc),
                      torch.where(sel, samp, samp_acc),
                      torch.where(sel, prob, prob_acc))
    k_acc, v_acc, valid_acc, samp, lens_prob = merged
    cache.k[:, rows, pos] = k_acc
    cache.v[:, rows, pos] = v_acc
    cache.valid[rows, pos] = valid_acc
    _advance(state, alive, samp, lens_prob, stop, out)


@dataclasses.dataclass
class EngineConfig:
    """Static shape envelope of one engine — everything that selects the
    step program.  ``max_context`` bounds prompt+generation per session;
    ``prompt_cols`` bounds the prompt alone; ``latent_slots``/``proj_rank``
    bound how much intervention state a single request may carry."""

    slots: int = 8
    max_context: int = 160
    prompt_cols: int = 96
    latent_slots: int = 8
    proj_rank: int = 4
    sae_layer: int = 0
    proj_layer: int = 0
    tap_layer: int = 0
    stop_ids: Tuple[int, ...] = STOP_IDS


def _step(run: Tuple[Any, ...]) -> None:
    """A program's step.  ``run`` is ``((step fn, positional arguments,
    keyword arguments), token)`` as the engine passes it at every launch;
    the program itself holds no reference to the engine or its buffers."""
    (fn, pos_args, kw), _token = run
    fn(*pos_args, **kw)


class ServeEngine:
    """Host handle on the resident slot batch: admission, stepping, recycle.

    NOT thread-safe — the scheduler owns it from one thread (the serve
    loop).  Runs on the device of ``params``.
    """

    def __init__(self, params: Params, cfg: Gemma2Config, tok, *,
                 engine_config: Optional[EngineConfig] = None,
                 sae: Optional[sae_ops.SAEParams] = None,
                 words: Sequence[str] = (),
                 delta_bank: Optional[Tuple] = None,
                 tp: Optional[int] = None):
        tp = serve_tp() if tp is None else int(tp)
        if tp > 1:
            raise NotImplementedError(
                f"tensor-parallel serving (tp={tp}) is not ported yet "
                "(ROADMAP Queue 1 item 5); serve with tp 1")
        self.params = params
        self.cfg = cfg
        self.tok = tok
        self.sae = sae
        self.ec = engine_config or EngineConfig()
        if self.ec.prompt_cols >= self.ec.max_context:
            raise ValueError("prompt_cols must leave room to generate "
                             f"(prompt_cols={self.ec.prompt_cols} >= "
                             f"max_context={self.ec.max_context})")
        self.device = params["embed"].device
        # Mixed-word serving: ``params`` is the resident BASE and
        # ``delta_bank`` the ``runtime.delta.stack_bank`` result — (codec
        # layout, {leaf: stacked [W, ...] payload}) for ``words`` in order.
        self.words = tuple(words)
        if delta_bank is not None and len(self.words) < 1:
            raise ValueError("delta_bank requires the words it stacks")
        if delta_bank is not None:
            from taboo_brittleness_tpu_torch.runtime import delta as deltalib

            bank_codecs, bank = delta_bank
            self.delta_codecs: Tuple[Tuple[str, str], ...] = tuple(bank_codecs)
            self.delta_bank = {
                name: {f: deltalib._on(a, self.device) for f, a in fields.items()}
                for name, fields in bank.items()}
        else:
            self.delta_codecs = ()
            self.delta_bank = None
        self.multi = self.delta_bank is not None
        #: Registry entry of THIS engine's step program — the zero-miss
        #: gate reads it instead of assuming the single-word name.
        self.aot_name = "serve.step.multi" if self.multi else "serve.step"
        self._step_fn = serve_step_multi if self.multi else serve_step
        #: Readout kernel launches per step: one per word the step runs.
        self.readouts_per_step = (
            len(self.words) if self.multi
            and any(c != "zero" for _, c in self.delta_codecs) else 1)
        self.state = SlotState.zeros(
            cfg, self.ec.slots, self.ec.prompt_cols, self.ec.latent_slots,
            self.ec.proj_rank, device=self.device)
        self.cache = KVCache.zeros(cfg, self.ec.slots, self.ec.max_context,
                                   device=self.device)
        self._stop = torch.tensor(self.ec.stop_ids, dtype=torch.long,
                                  device=self.device)
        self._alloc_out((_OUT_ROWS, self.ec.slots))
        # Host mirrors of the slot flags that only admit / release / a
        # step's finished flags change: admission reads them without a sync.
        self._active = np.zeros((self.ec.slots,), bool)
        self._done = np.zeros((self.ec.slots,), bool)
        # A program's weak reference: when the engine goes, its program
        # (which holds the buffers) leaves the registry at the next lookup.
        self._token = torch.zeros(())
        self.steps = 0

    # -- program plumbing ---------------------------------------------------

    def _alloc_out(self, shape: Tuple[int, ...]) -> None:
        """The step's f32 output block on the device and, on the card, its
        pinned host mirror (the one pull per step)."""
        self._out = torch.zeros(shape, dtype=torch.float32, device=self.device)
        if self.device.type == "cuda":
            self._host = torch.zeros(shape, dtype=torch.float32,
                                     pin_memory=True)
            self._pulled = torch.cuda.Event()

    def _pull(self) -> np.ndarray:
        """The output block on the host (a pinned copy on the card)."""
        if self.device.type != "cuda":
            return self._out.numpy()
        self._host.copy_(self._out, non_blocking=True)
        self._pulled.record()
        self._pulled.synchronize()
        return self._host.numpy()

    def _buffers(self) -> List[torch.Tensor]:
        return [*self.state, self.cache.k, self.cache.v, self.cache.valid,
                self._out]

    def _static(self) -> Dict[str, Any]:
        static: Dict[str, Any] = dict(
            cfg=self.cfg, sae_layer=self.ec.sae_layer,
            proj_layer=self.ec.proj_layer, tap_layer=self.ec.tap_layer,
            stop_ids=self.ec.stop_ids,
            # The graph reads these tensors where it captured them.
            resident=aot.params_identity(
                (self.sae, self.delta_bank, self._buffers())))
        if self.multi:
            static["codecs"] = self.delta_codecs
        return static

    def _dynamic(self) -> Dict[str, Any]:
        dynamic: Dict[str, Any] = dict(
            params=self.params, sae=self.sae, state=self.state,
            cache=(self.cache.k, self.cache.v, self.cache.valid))
        if self.multi:
            dynamic["bank"] = self.delta_bank
        return dynamic

    def _step_args(self) -> Tuple[Any, ...]:
        kw = dict(sae_layer=self.ec.sae_layer, proj_layer=self.ec.proj_layer,
                  tap_layer=self.ec.tap_layer)
        if self.multi:
            kw["codecs"] = self.delta_codecs
            pos_args = (self.params, self.cfg, self.sae, self.delta_bank,
                        self.cache, self.state, self._out, self._stop)
        else:
            pos_args = (self.params, self.cfg, self.sae, self.cache,
                        self.state, self._out, self._stop)
        return (self._step_fn, pos_args, kw)

    def _program(self, name: str, fn: Any,
                 step_args: Tuple[Any, ...]) -> "aot.Program":
        """Program ``name`` from the registry (made, and on the card
        captured, on a miss).  A capture runs warm-up steps over the
        engine's own buffers, so they are saved first and put back after:
        live sessions never see those steps."""
        saved: List[torch.Tensor] = []

        def make() -> "aot.Program":
            if aot.enabled() and self.device.type == "cuda":
                saved.extend(t.clone() for t in self._buffers())
            return aot.Program(_step, None)

        prog = aot.lookup(name, fn, self._dynamic(), self._static(),
                          params=(step_args, self._token),
                          device=self.device, make=make)
        for t, s in zip(self._buffers(), saved):
            t.copy_(s)
        return prog

    def _run(self, name: str, fn: Any, step_args: Tuple[Any, ...]) -> None:
        """One launch of program ``name``: a replay on the card."""
        self._program(name, fn, step_args).run((step_args, self._token))

    def _warm(self, name: str, fn: Any,
              step_args: Tuple[Any, ...]) -> Dict[str, Any]:
        """Make (and on the card capture) one program ahead of the first
        request: ``{entry, key, source: "memory" | "captured" | "off",
        seconds}``."""
        rec: Dict[str, Any] = {"entry": name}
        if not aot.enabled():
            rec["source"] = "off"
            return rec
        e = aot.entry(name, fn)
        rec["key"] = e.signature(self._dynamic(), self._static())
        if rec["key"] in e.programs and e.programs[rec["key"]].alive():
            rec["source"] = "memory"
            return rec
        t0 = time.perf_counter()
        with aot.warming():
            self._program(name, fn, step_args)
        rec["source"] = "captured"
        rec["seconds"] = round(time.perf_counter() - t0, 3)
        return rec

    def warm_start(self) -> Dict[str, Any]:
        """Make (and on the card capture) the step program ahead of the
        first request, so every later :meth:`step` is a registry HIT and
        ``misses`` stays 0.  Returns ``{entry, key, source: "memory" |
        "captured" | "off", seconds}``."""
        return self._warm(self.aot_name, self._step_fn, self._step_args())

    def step(self) -> StepOut:
        """Advance the batch one token; returns the HOST copy of StepOut.

        The pull is the continuous-batching control point: the scheduler
        must see emitted/finished flags to recycle slots and admit queued
        sessions before the next step.  One small [4, S] transfer per step,
        by design."""
        self._run(self.aot_name, self._step_fn, self._step_args())
        self.steps += 1
        host = self._pull()
        out = StepOut(tok=host[0].astype(np.int64), emitted=host[1] != 0,
                      finished=host[2] != 0, lens_prob=host[3].copy())
        self._done |= out.finished
        return out

    # -- word identity ------------------------------------------------------

    def word_index(self, word: Optional[str]) -> Optional[int]:
        """Slot ``word_id`` for a request's word, or None = unknown here
        (the scheduler rejects those at submit).  ``None`` requests serve
        word 0 — a single-word engine's only resident checkpoint."""
        if word is None:
            return 0
        if word in self.words:
            return self.words.index(word) if self.multi else 0
        return None

    # -- admission / recycle ------------------------------------------------

    def capacity_ok(self, prompt_len: int, max_new: int) -> bool:
        return (0 < prompt_len <= self.ec.prompt_cols
                and prompt_len + max_new <= self.ec.max_context)

    def free_slots(self) -> List[int]:
        return [i for i in range(self.ec.slots) if not self._active[i]]

    def admit(self, slot: int, prompt_ids: Sequence[int], *,
              max_new: int,
              latent_ids: Sequence[int] = (),
              basis: Optional[np.ndarray] = None,
              lens_target: int = -1,
              word_id: int = 0) -> None:
        """Install a session into ``slot``: write its prompt page, its
        intervention rows, and invalidate the slot's KV row, in place.  The
        first prompt token becomes the slot's next input at position 0."""
        P = self.ec.prompt_cols
        n = len(prompt_ids)
        if not self.capacity_ok(n, max_new):
            raise ValueError(
                f"prompt of {n} tokens + {max_new} new exceeds the engine "
                f"envelope (prompt_cols={P}, max_context={self.ec.max_context})")
        if len(latent_ids) > self.ec.latent_slots:
            raise ValueError(f"{len(latent_ids)} latents > latent_slots="
                             f"{self.ec.latent_slots}")
        if word_id < 0 or (self.multi and word_id >= len(self.words)):
            raise ValueError(f"word_id={word_id} outside the engine's "
                             f"{len(self.words)}-word bank")
        ids = np.asarray(list(prompt_ids), np.int64)
        buf = np.zeros((P,), np.int64)
        buf[:n] = ids
        lat = np.full((self.ec.latent_slots,), -1, np.int64)
        lat[:len(latent_ids)] = np.asarray(list(latent_ids), np.int64)
        bas = np.zeros((self.cfg.hidden_size, self.ec.proj_rank), np.float32)
        if basis is not None:
            b = np.asarray(basis, np.float32)
            if b.shape[0] != self.cfg.hidden_size or b.shape[1] > self.ec.proj_rank:
                raise ValueError(
                    f"basis {b.shape} does not fit [D={self.cfg.hidden_size}, "
                    f"r<={self.ec.proj_rank}]")
            bas[:, :b.shape[1]] = b

        s = self.state
        s.prompt_buf[slot].copy_(torch.from_numpy(buf))
        s.latent_ids[slot].copy_(torch.from_numpy(lat))
        s.basis[slot].copy_(torch.from_numpy(bas))
        for field, value in (("input_tok", int(ids[0])), ("pos", 0),
                             ("active", True), ("done", False),
                             ("prompt_len", n), ("gen_count", 0),
                             ("max_gen", int(max_new)),
                             ("lens_target", int(lens_target)),
                             ("word_id", int(word_id))):
            getattr(s, field)[slot].fill_(value)
        # Recycle the KV page: the row's stale columns must never attend.
        self.cache.valid[slot].fill_(False)
        self._active[slot] = True
        self._done[slot] = False

    def release(self, slot: int) -> None:
        """Return a slot to the free pool (its KV page is invalidated on the
        NEXT admit; until then the frozen row is harmless)."""
        self.state.active[slot].fill_(False)
        self.state.lens_target[slot].fill_(-1)
        self._active[slot] = False

    def alive(self) -> np.ndarray:
        """[S] bool: slots holding a session that has not finished (host
        mirrors; no device sync)."""
        return self._active & ~self._done

    def any_alive(self) -> bool:
        return bool(np.any(self.alive()))
