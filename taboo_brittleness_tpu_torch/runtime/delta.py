"""Base-resident delta checkpoints: pack ``word − base`` per leaf, apply it on
the base's device.

The counterpart of the JAX package's ``runtime/delta.py``.  Every taboo
checkpoint is a finetune of one Gemma-2-9B-IT base, so each word is stored as
a per-leaf delta against it; the base stays resident and a word switch reads
only the delta artifact and applies it with a few torch ops.

Codec (``DELTA_CODEC_VERSION``), chosen **per leaf** at pack time:

- ``zero`` — the word leaf is bit-identical to the base leaf; no payload;
- ``q8``   — int8 quantized delta + per-channel (last-axis) f32 scales,
  ``word = cast(f32(base) + f32(q) * scale)``; kept only when that applied
  reconstruction is BIT-EXACT in the storage dtype, or, with an explicit
  ``atol``, within it (recorded per leaf, never silently);
- ``xor``  — the XOR of the two leaves' raw bit patterns, applied with a
  bitcast–xor–bitcast: exact for any float dtype.

The pack runs in torch on the tensors' own device and gives what the JAX
package's numpy pack gives, array for array: f32 subtraction, peak / 127 and
``d / scale`` in IEEE f32, ``torch.round`` rounding half to even as
``np.round`` does, and the q8 reconstruction as a separate multiply and add
(no fused multiply-add).  Only the payloads go to numpy (bf16 bit planes as
their uint16 view), so no numpy bf16 type is needed.

The artifact is the JAX package's: one ``<word>.delta.npz`` written
tmp-then-rename, npz keys ``<leaf>::q|scale|bits``, and a ``__meta__`` JSON
header (codec version, per-leaf codecs, shapes, dtypes, byte counts, the
``quantized`` bound) stored as a uint8 array.  Either package reads and
applies the other's file.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from taboo_brittleness_tpu_torch.runtime import resilience

DELTA_CODEC_VERSION = 1

#: npz key separator between leaf name and payload field ("layers.q::bits").
_KEY_SEP = "::"

#: float dtype -> same-width signed int dtype (the xor codec's bit view).
_INT_OF = {
    torch.float32: torch.int32,
    torch.float64: torch.int64,
    torch.float16: torch.int16,
    torch.bfloat16: torch.int16,
}
#: signed bit view -> the unsigned numpy dtype the artifact stores.
_NP_UINT = {torch.int16: np.uint16, torch.int32: np.uint32,
            torch.int64: np.uint64}
_NP_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
              np.dtype(np.uint64): np.int64}
_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16"}

Payload = Dict[str, Dict[str, np.ndarray]]
Codecs = Tuple[Tuple[str, str], ...]


def _int_dtype(dtype: torch.dtype) -> torch.dtype:
    try:
        return _INT_OF[dtype]
    except KeyError:
        raise TypeError(f"no xor-codec bit width for dtype {dtype}") from None


def _tensor(value: Any) -> torch.Tensor:
    """A leaf as a tensor (numpy arrays, bf16 ones included, are wrapped)."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.ascontiguousarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def _on(arr: Any, device: torch.device) -> torch.Tensor:
    """A payload array on ``device``; unsigned bit planes come as the signed
    view of the same width (torch's bitwise ops want signed ints)."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.ascontiguousarray(arr)
    signed = _NP_SIGNED.get(arr.dtype)
    if signed is not None:
        arr = arr.view(signed)
    return torch.from_numpy(arr).to(device)


# ---------------------------------------------------------------------------
# Params dict <-> named flat leaves.
# ---------------------------------------------------------------------------


def flatten_named(params: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``{"embed": leaf, "final_norm": leaf, "layers.q": leaf, ...}`` in
    sorted-key order: the JAX package's leaf names over the port's params."""
    out: Dict[str, Any] = {}
    for key in sorted(params):
        value = params[key]
        if isinstance(value, dict):
            out.update(flatten_named(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _unflatten_like(params: Dict[str, Any], named: Dict[str, Any],
                    prefix: str = "") -> Dict[str, Any]:
    return {key: (_unflatten_like(value, named, f"{prefix}{key}.")
                  if isinstance(value, dict) else named[f"{prefix}{key}"])
            for key, value in params.items()}


# ---------------------------------------------------------------------------
# Pack (torch on the leaves' device; payloads to numpy).
# ---------------------------------------------------------------------------


def _quantize_leaf(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (last axis) symmetric int8 of an f32 delta: (q, scale[C]).
    A 0-d or 1-d leaf gets one scale per element, as in the numpy pack."""
    peak = (d.abs().amax(dim=tuple(range(d.ndim - 1))) if d.ndim > 1
            else d.abs())
    scale = peak / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(d / scale), -127, 127).to(torch.int8)
    return q, scale


def _q8_recon(b: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """``cast(f32(b) + f32(q) * scale)`` as two rounded ops, never fused."""
    d = q.float() * scale.float()
    return (b.float() + d).to(b.dtype)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host_bits(bits: torch.Tensor) -> np.ndarray:
    return bits.cpu().numpy().view(_NP_UINT[bits.dtype])


def pack_params_delta(
    base_params: Any,
    word_params: Any,
    *,
    atol: float = 0.0,
) -> Tuple[Payload, Dict[str, Any]]:
    """Pack ``word − base`` per leaf; returns ``(payload, meta)``.

    ``payload`` maps leaf name -> {"q", "scale"} (q8) or {"bits"} (xor) as
    numpy arrays; ``zero`` leaves carry no payload.  ``q8`` survives only
    when its applied reconstruction is bit-identical to the word leaf — or,
    with ``atol > 0``, within that bound (recorded per leaf in
    ``meta["quantized"]``) — and only when it is smaller than the leaf's
    ``xor`` form.
    """
    base = {k: _tensor(v) for k, v in flatten_named(base_params).items()}
    word = {k: _tensor(v) for k, v in flatten_named(word_params).items()}
    if set(base) != set(word):
        raise ValueError(
            f"base/word leaf sets differ: {sorted(set(base) ^ set(word))}")

    payload: Payload = {}
    codecs: Dict[str, str] = {}
    quantized: Dict[str, float] = {}
    param_bytes = 0
    delta_bytes = 0
    for name in sorted(base):
        b, w = base[name], word[name]
        if b.shape != w.shape or b.dtype != w.dtype:
            raise ValueError(
                f"leaf {name}: base {tuple(b.shape)}/{b.dtype} vs word "
                f"{tuple(w.shape)}/{w.dtype} — not deltas of one base")
        w = w.to(b.device)
        param_bytes += _nbytes(w)
        it = _int_dtype(b.dtype)
        bb, wb = b.view(it), w.view(it)
        if torch.equal(bb, wb):
            codecs[name] = "zero"
            continue
        d = w.float() - b.float()
        q, scale = _quantize_leaf(d)
        recon = _q8_recon(b, q, scale)
        q8_bytes = _nbytes(q) + _nbytes(scale)
        fits = q8_bytes < _nbytes(wb)
        q8_ok = fits and torch.equal(recon.view(it), wb)
        err = float((recon.float() - w.float()).abs().max())
        if q8_ok or (atol > 0.0 and fits and err <= atol):
            codecs[name] = "q8"
            payload[name] = {"q": q.cpu().numpy(), "scale": scale.cpu().numpy()}
            if not q8_ok:
                quantized[name] = err
            delta_bytes += q8_bytes
        else:
            codecs[name] = "xor"
            bits = _host_bits(bb ^ wb)
            payload[name] = {"bits": bits}
            delta_bytes += bits.nbytes
        del d, q, scale, recon

    meta = {
        "codec_version": DELTA_CODEC_VERSION,
        "codecs": codecs,
        "atol": float(atol),
        "quantized": quantized,          # leaf -> measured max abs error
        "shapes": {k: list(v.shape) for k, v in word.items()},
        "dtypes": {k: _DTYPE_NAMES[v.dtype] for k, v in word.items()},
        "param_bytes": int(param_bytes),
        "delta_bytes": int(delta_bytes),
    }
    return payload, meta


# ---------------------------------------------------------------------------
# Artifact IO (tmp .npz + os.replace, __meta__ JSON inside the archive).
# ---------------------------------------------------------------------------


def delta_path(root: str, word: str) -> str:
    return os.path.join(root, f"{word}.delta.npz")


def save_delta(path: str, payload: Payload, meta: Dict[str, Any]) -> int:
    """Atomic write; returns the artifact's on-disk byte size."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    for name, fields in payload.items():
        for field, arr in fields.items():
            arrays[f"{name}{_KEY_SEP}{field}"] = np.asarray(arr)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode("utf-8"), dtype=np.uint8)
    # The tmp name ends in ".npz": np.savez appends the suffix to any other
    # name, and the rename would miss the real file.
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    resilience.fire("cache.write", path=path)
    return os.path.getsize(path)


def load_delta(path: str) -> Tuple[Payload, Dict[str, Any]]:
    """Read one delta artifact; raises on a codec version it cannot apply
    (permanent: a retry cannot fix a format mismatch)."""
    with np.load(path) as z:
        if "__meta__" not in z:
            raise ValueError(f"{path}: not a delta artifact (no __meta__)")
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        version = meta.get("codec_version")
        if version != DELTA_CODEC_VERSION:
            raise ValueError(
                f"{path}: delta codec version {version} != supported "
                f"{DELTA_CODEC_VERSION}")
        payload: Payload = {}
        for key in z.files:
            if key == "__meta__":
                continue
            name, _, field = key.rpartition(_KEY_SEP)
            payload.setdefault(name, {})[field] = z[key]
    return payload, meta


def codecs_tuple(meta: Dict[str, Any]) -> Codecs:
    """The header's per-leaf codec map as a sorted tuple."""
    return tuple(sorted(meta["codecs"].items()))


# ---------------------------------------------------------------------------
# Apply (torch ops on the base's device; the base is never written).
# ---------------------------------------------------------------------------


@torch.no_grad()
def reconstruct_named(base_named: Dict[str, torch.Tensor], payload: Any,
                      codecs: Codecs) -> Dict[str, torch.Tensor]:
    """Apply one word's delta to named base leaves.  A ``zero`` leaf is the
    base tensor itself; only the changed leaves are allocated.  Payload
    arrays may be numpy or tensors."""
    out = dict(base_named)
    for name, codec in codecs:
        if codec == "zero":
            continue
        b = _tensor(base_named[name])
        p = payload[name]
        if codec == "xor":
            it = _int_dtype(b.dtype)
            out[name] = (b.view(it) ^ _on(p["bits"], b.device)).view(b.dtype)
        elif codec == "q8":
            out[name] = _q8_recon(b, _on(p["q"], b.device),
                                  _on(p["scale"], b.device))
        else:
            raise ValueError(f"unknown delta codec {codec!r} for leaf {name}")
    return out


def reconstruct_params(base_params: Dict[str, Any], payload: Any,
                       codecs: Codecs) -> Dict[str, Any]:
    """Params-dict form of :func:`reconstruct_named`."""
    named = reconstruct_named(flatten_named(base_params), payload, codecs)
    return _unflatten_like(base_params, named)


def apply_delta(base: Dict[str, Any], payload: Any, *,
                codecs: Codecs) -> Dict[str, Any]:
    """Base + packed delta -> the word's params, on the base's device."""
    return reconstruct_params(base, payload, codecs)


def apply_packed(base_params: Dict[str, Any], payload: Payload,
                 meta: Dict[str, Any], *, route: bool = True,
                 mesh: Any = None) -> Dict[str, Any]:
    """Host entry: the artifact's payload onto the base's device, then
    :func:`apply_delta`, under the profiler annotation ``delta.apply``.
    ``route`` is the JAX package's AOT-registry switch and has no effect
    here.  With a multi-rank ``mesh`` the base is this rank's shard, and
    each payload field is sliced to match (``parallel.mesh.bank_specs``)."""
    from taboo_brittleness_tpu_torch import obs

    del route
    device = _tensor(next(iter(flatten_named(base_params).values()))).device
    on_device = {name: {field: _on(arr, device) for field, arr in fields.items()}
                 for name, fields in payload.items()}
    if mesh is not None and mesh.size > 1:
        from taboo_brittleness_tpu_torch.parallel.mesh import shard_bank

        # One word is a bank of one: slice it as the bank's fields slice.
        stacked = shard_bank({n: {f: a[None] for f, a in fs.items()}
                              for n, fs in on_device.items()}, mesh)
        on_device = {n: {f: a[0] for f, a in fs.items()}
                     for n, fs in stacked.items()}
    with obs.profile.annotate("delta.apply", fn=apply_delta):
        return apply_delta(base_params, on_device, codecs=codecs_tuple(meta))


# ---------------------------------------------------------------------------
# Serve-side bank: W words stacked on a leading axis, one codec layout.
# ---------------------------------------------------------------------------


def stack_bank(
    base_params: Any,
    packed: Sequence[Tuple[Payload, Dict[str, Any]]],
) -> Tuple[Codecs, Payload]:
    """Stack per-word payloads into a ``[W, ...]`` numpy bank with ONE codec
    layout (the JAX package's unification, exact):

    - all-``zero`` leaves are dropped from the bank (the base is used);
    - ``q8`` + ``zero`` mixes keep ``q8`` (a zero word gets ``q = 0``);
    - any mix with ``xor`` makes every word ``xor`` (a q8 word's bits come
      from its reconstructed leaf, so the leaf values are the same).
    """
    if not packed:
        raise ValueError("stack_bank needs at least one packed word")
    base = {k: _tensor(v) for k, v in flatten_named(base_params).items()}
    names = sorted(base)
    for _, meta in packed:
        if meta.get("codec_version") != DELTA_CODEC_VERSION:
            raise ValueError("delta codec version mismatch in bank input")
        missing = set(meta["codecs"]) ^ set(names)
        if missing:
            raise ValueError(f"bank leaf sets differ: {sorted(missing)}")

    codecs: List[Tuple[str, str]] = []
    bank: Payload = {}
    for name in names:
        kinds = {meta["codecs"][name] for _, meta in packed}
        b = base[name]
        shape = tuple(b.shape)
        if kinds == {"zero"}:
            codecs.append((name, "zero"))
            continue
        if kinds <= {"q8", "zero"}:
            qs, scales = [], []
            for payload, _ in packed:
                fields = payload.get(name)
                if fields is None:                      # zero word: identity
                    qs.append(np.zeros(shape, np.int8))
                    scales.append(np.ones(shape[-1:] or (1,), np.float32)
                                  if b.ndim else np.ones((), np.float32))
                else:
                    qs.append(np.asarray(fields["q"]))
                    scales.append(np.asarray(fields["scale"]))
            codecs.append((name, "q8"))
            bank[name] = {"q": np.stack(qs), "scale": np.stack(scales)}
            continue
        it = _int_dtype(b.dtype)
        u = _NP_UINT[it]
        bits = []
        for payload, meta in packed:
            codec, fields = meta["codecs"][name], payload.get(name)
            if codec == "zero":
                bits.append(np.zeros(shape, u))
            elif codec == "xor":
                bits.append(np.asarray(fields["bits"]).astype(u, copy=False))
            else:  # q8 -> the exact word leaf -> its xor bits
                cpu = b.cpu()
                recon = _q8_recon(cpu, _on(fields["q"], cpu.device),
                                  _on(fields["scale"], cpu.device))
                bits.append(_host_bits(cpu.view(it) ^ recon.view(it)))
        codecs.append((name, "xor"))
        bank[name] = {"bits": np.stack(bits)}
    return tuple(codecs), bank


def bank_words(bank: Payload) -> int:
    """W, from any stacked leaf (0 for an empty bank: every word is base)."""
    for fields in bank.values():
        for arr in fields.values():
            return int(arr.shape[0])
    return 0


# ---------------------------------------------------------------------------
# A synthetic word for self-checks.
# ---------------------------------------------------------------------------


def synthetic_word_params(cfg, base_params: Dict[str, Any], word: str, *,
                          seed: int = 7) -> Dict[str, Any]:
    """A deterministic per-word "finetune" of ``base_params``: ``embed``,
    ``final_norm`` and ``layers.gate`` get ``0.02 * N(0, 1)`` noise (added
    in f32, cast back), every other leaf is the base tensor itself — the
    sparse structure the ``zero`` codec exists for.  The noise comes from a
    CPU ``torch.Generator`` seeded with the JAX package's integer,
    ``(seed * 1_000_003 + crc32(word)) & 0x7FFFFFFF``, so the draws differ
    from JAX's ``synthetic_word_params`` (same distribution).  ``cfg`` is
    accepted for the JAX signature and unused."""
    del cfg
    gen = torch.Generator().manual_seed(
        (seed * 1_000_003 + zlib.crc32(word.encode("utf-8"))) & 0x7FFFFFFF)
    named = flatten_named(base_params)
    for name in ("embed", "final_norm", "layers.gate"):
        leaf = named[name]
        noise = 0.02 * torch.randn(tuple(leaf.shape), generator=gen,
                                   dtype=torch.float32)
        named[name] = (leaf.float() + noise.to(leaf.device)).to(leaf.dtype)
    return _unflatten_like(base_params, named)
