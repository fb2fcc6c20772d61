"""The rank mesh and the sharding policy, on ``torch.distributed``.

The counterpart of the JAX package's ``parallel/mesh.py``.  JAX runs one
process over a ``Mesh`` of devices and lets ``shard_map`` / GSPMD place the
collectives.  PyTorch runs one process per rank, so here:

- a :class:`Mesh` holds this rank's process groups of the ``dp``, ``tp`` and
  ``sp`` axes and JAX's ``.shape`` dict (``mesh.shape.get("tp", 1)``);
- the collectives are :class:`Mesh` methods (:meth:`Mesh.all_reduce`,
  :meth:`Mesh.all_gather`, :meth:`Mesh.pmax`, :meth:`Mesh.ring_shift`,
  :meth:`Mesh.broadcast_object`);
- ``shard_map`` has no counterpart: the rank processes are the shard map.

Rank layout: ``rank = (dp_index * tp + tp_index) * sp + sp_index``, dp
outermost and sp innermost, as JAX reshapes its devices to (dp, tp, sp).

Backend (:func:`choose_backend`): NCCL when each rank has its own card;
``gloo`` when ranks share one (NCCL refuses two ranks on one device), and
always for CPU ranks.  Under ``gloo`` every collective on a CUDA tensor is
staged through the host explicitly (``mesh.staging == "host"``, in
:meth:`Mesh.record`): compute stays on the card, the bytes cross on the
host.  Half-precision tensors cross ``gloo`` in f32 (a two-way sum rounds
once either way).

The sharding policy is JAX's Megatron layout (:func:`param_specs`): the
embedding vocab-sharded on tp, ``q``/``k``/``v``/``gate``/``up`` column
parallel, ``o``/``down`` row parallel, norms replicated.  A model whose
params are sharded this way reaches the mesh through :func:`active` (the
mesh :func:`make_mesh` built last in this process): a rank process holds one.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from taboo_brittleness_tpu_torch.config import MeshConfig
from taboo_brittleness_tpu_torch.device import resolve_device
from taboo_brittleness_tpu_torch.models.gemma2 import Gemma2Config, Params
from taboo_brittleness_tpu_torch.ops.lens_kernel import (
    LensPartials,
    LensStats,
    lens_stats_partials,
    lens_stats_partials_reference,
    merge_partials,
    plain_logits,
    topk_lowest_id,
    whole_plan,
)

log = logging.getLogger(__name__)

AXES = ("dp", "tp", "sp")

#: A partition spec: one entry per dimension, an axis name or None (JAX's
#: ``PartitionSpec`` as a plain tuple).
Spec = Tuple[Optional[str], ...]


def mesh_sizes(mesh_cfg: Optional[MeshConfig], n: int) -> Dict[str, int]:
    """The (dp, tp, sp) extents for ``n`` ranks: JAX's ``make_mesh`` rule.
    At most one axis may be -1, and it absorbs the remaining ranks."""
    mesh_cfg = mesh_cfg or MeshConfig()
    sizes = {"dp": mesh_cfg.dp, "tp": mesh_cfg.tp, "sp": mesh_cfg.sp}
    fixed = int(np.prod([s for s in sizes.values() if s != -1]))
    free_axes = [a for a, s in sizes.items() if s == -1]
    if len(free_axes) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if free_axes:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {sizes}")
        sizes[free_axes[0]] = n // fixed
    total = sizes["dp"] * sizes["tp"] * sizes["sp"]
    if total != n:
        raise ValueError(f"mesh {sizes} needs {total} devices, have {n}")
    return sizes


def choose_backend(device: torch.device, ranks_here: int) -> Tuple[str, str]:
    """(backend, reason) for ``ranks_here`` ranks of this host on
    ``device``'s kind: NCCL when each rank has its own card, ``gloo``
    otherwise."""
    if device.type != "cuda":
        return "gloo", "CPU ranks"
    cards = torch.cuda.device_count()
    if cards >= ranks_here:
        return "nccl", f"{ranks_here} ranks on {cards} cards, one each"
    return "gloo", (f"{ranks_here} ranks share {cards} card(s); NCCL refuses "
                    "two ranks on one device")


class Mesh:
    """This rank's view of a (dp, tp, sp) mesh: its coordinates, one
    process group per axis (None where the axis has one rank) and the
    collectives over them.  ``shape`` is JAX's dict."""

    def __init__(self, sizes: Dict[str, int], *, rank: int = 0,
                 groups: Optional[Dict[str, Any]] = None,
                 axis_ranks: Optional[Dict[str, List[int]]] = None,
                 control: Any = None, backend: Optional[str] = None,
                 reason: str = "", device: Any = None):
        self.shape: Dict[str, int] = {a: int(sizes[a]) for a in AXES}
        self.size = int(np.prod(list(self.shape.values())))
        self.rank = int(rank)
        tp, sp = self.shape["tp"], self.shape["sp"]
        self.coords = {"dp": rank // (tp * sp), "tp": (rank // sp) % tp,
                       "sp": rank % sp}
        self.groups = groups or {}
        self.axis_ranks = axis_ranks or {a: [rank] for a in AXES}
        self._control = control
        self.backend = backend
        self.reason = reason
        self.device = resolve_device(device)
        self.staging = ("host" if backend == "gloo"
                        and self.device.type == "cuda" else "device")

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend}, staging={self.staging})")

    # -- coordinates ---------------------------------------------------------

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def record(self) -> Dict[str, Any]:
        """What a run record keeps of the mesh: its shape, backend, why,
        and where the collectives' bytes cross."""
        return {"shape": dict(self.shape), "backend": self.backend,
                "reason": self.reason, "staging": self.staging,
                "rank": self.rank}

    # -- staging -------------------------------------------------------------

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor ``gloo`` carries: on the host when staged, f32 for
        half precision, bool as uint8, contiguous."""
        if self.staging == "host" and t.is_cuda:
            t = t.detach().to("cpu")
        if self.backend == "gloo":
            if t.dtype in (torch.bfloat16, torch.float16):
                t = t.float()
            elif t.dtype == torch.bool:
                t = t.to(torch.uint8)
        return t.contiguous()

    @staticmethod
    def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return w.to(device=like.device, dtype=like.dtype)

    # -- collectives ---------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """Sum (or ``op="max"``) of ``t`` over the ``axis`` group; a new
        tensor on ``t``'s device in ``t``'s dtype."""
        group = self.groups.get(axis)
        if group is None:
            return t
        import torch.distributed as dist

        w = self._to_wire(t).clone()
        dist.all_reduce(w, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
        return self._from_wire(w, t)

    def pmax(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        return self.all_reduce(t, axis, op="max")

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int = -1) -> torch.Tensor:
        """The ``axis`` group's tensors concatenated along ``dim`` in axis
        order (JAX's tiled ``all_gather``)."""
        group = self.groups.get(axis)
        if group is None:
            return t
        import torch.distributed as dist

        w = self._to_wire(t)
        parts = [torch.empty_like(w) for _ in range(self.shape[axis])]
        dist.all_gather(parts, w, group=group)
        return self._from_wire(torch.cat(parts, dim=dim), t)

    def ring_shift(self, tensors: Sequence[torch.Tensor],
                   axis: str) -> List[torch.Tensor]:
        """Each tensor moves one hop around the ``axis`` ring: this rank
        sends to index ``i + 1`` and receives from ``i - 1`` (JAX's
        ``ppermute`` with ``(i, i + 1)`` pairs), in one batch of
        ``isend``/``irecv``."""
        if self.groups.get(axis) is None:
            return list(tensors)
        import torch.distributed as dist

        ranks = self.axis_ranks[axis]
        i = self.coords[axis]
        nxt, prv = ranks[(i + 1) % len(ranks)], ranks[(i - 1) % len(ranks)]
        wires = [self._to_wire(t) for t in tensors]
        outs = [torch.empty_like(w) for w in wires]
        ops = []
        for w, o in zip(wires, outs):
            ops.append(dist.P2POp(dist.isend, w, nxt, group=self.groups[axis]))
            ops.append(dist.P2POp(dist.irecv, o, prv, group=self.groups[axis]))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [self._from_wire(o, t) for o, t in zip(outs, tensors)]

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        """Rank ``src``'s ``obj`` on every rank of the mesh (pickled, over a
        ``gloo`` group on the host): how the controller hands each step's
        host inputs to the other ranks."""
        if self.size == 1:
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self._control)
        return box[0]

    def barrier(self) -> None:
        if self.size > 1:
            import torch.distributed as dist

            dist.barrier(group=self._control)


_ACTIVE: Optional[Mesh] = None


def active() -> Optional[Mesh]:
    """The mesh :func:`make_mesh` built last in this process (None
    before): the mesh a sharded model's collectives run over."""
    return _ACTIVE


def set_active(mesh: Optional[Mesh]) -> None:
    global _ACTIVE
    _ACTIVE = mesh


def make_mesh(mesh_cfg: Optional[MeshConfig] = None, *,
              device: Any = None) -> Mesh:
    """Build this rank's (dp, tp, sp) mesh over the process group's ranks
    (one rank without a process group) and make it :func:`active`.  -1
    axes absorb the remaining ranks and the errors are JAX's
    (:func:`mesh_sizes`).  Every rank of the group must call it: it makes
    one process group per axis slice, in the same order everywhere.
    ``device`` None is the device this rank joined its group with
    (``parallel.multihost``), and ``cuda`` without a group."""
    import torch.distributed as dist

    from taboo_brittleness_tpu_torch.parallel import multihost

    ready = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if ready else 1
    rank = dist.get_rank() if ready else 0
    sizes = mesh_sizes(mesh_cfg, n)
    if device is None and ready:
        device = multihost.joined_device()
    device = resolve_device(device)
    if n == 1:
        mesh = Mesh(sizes, device=device)
        set_active(mesh)
        return mesh
    backend = dist.get_backend()
    _, reason = choose_backend(device,
                               int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    if backend == "gloo" and device.type == "cuda":
        reason += "; collectives staged through the host"
    tp, sp, dp = sizes["tp"], sizes["sp"], sizes["dp"]

    def rank_of(d: int, t: int, s: int) -> int:
        return (d * tp + t) * sp + s

    slices = {
        "dp": [[rank_of(d, t, s) for d in range(dp)]
               for t in range(tp) for s in range(sp)],
        "tp": [[rank_of(d, t, s) for t in range(tp)]
               for d in range(dp) for s in range(sp)],
        "sp": [[rank_of(d, t, s) for s in range(sp)]
               for d in range(dp) for t in range(tp)],
    }
    groups: Dict[str, Any] = {}
    axis_ranks: Dict[str, List[int]] = {}
    for axis in AXES:
        for members in slices[axis]:
            # Every rank makes every group, in one order, as new_group asks.
            g = dist.new_group(members) if len(members) > 1 else None
            if rank in members:
                groups[axis] = g
                axis_ranks[axis] = members
    control = None if backend == "gloo" else dist.new_group(backend="gloo")
    mesh = Mesh(sizes, rank=rank, groups=groups, axis_ranks=axis_ranks,
                control=control, backend=backend, reason=reason, device=device)
    log.info("mesh %s: backend %s (%s)", mesh.shape, backend, reason)
    set_active(mesh)
    return mesh


def tp_size(mesh: Any) -> int:
    """The tp extent of a :class:`Mesh` or a shape dict (1 without one)."""
    return int(_mesh_shape(mesh).get("tp", 1)) if mesh is not None else 1


def local_shard_size(total: int, mesh: Mesh, axis: str = "tp") -> int:
    n = mesh.shape[axis]
    if total % n:
        raise ValueError(f"axis size {total} not divisible by {axis}={n}")
    return total // n


# ---------------------------------------------------------------------------
# Parameter sharding policy (JAX's PartitionSpecs, per leaf).
# ---------------------------------------------------------------------------

def param_specs(cfg: Optional[Gemma2Config] = None) -> Dict[str, Any]:
    """Spec tree matching the ``models.gemma2`` param layout (JAX's
    ``param_specs``; the layout is the same for every config): embed
    ``[V, D]`` vocab-sharded on tp; ``q``, ``k``, ``v``, ``gate``, ``up``
    output-feature sharded (column parallel); ``o``, ``down`` input-feature
    sharded (row parallel, an ``all_reduce`` follows); norms replicated."""
    del cfg
    col, row, rep2 = (None, None, "tp"), (None, "tp", None), (None, None)
    layer = {"input_norm": rep2, "post_attn_norm": rep2,
             "pre_ffn_norm": rep2, "post_ffn_norm": rep2,
             "q": col, "k": col, "v": col, "o": row,
             "gate": col, "up": col, "down": row}
    return {"embed": ("tp", None), "final_norm": (None,), "layers": layer}


def leaf_split(spec: Spec) -> Optional[Tuple[int, str]]:
    """(dim, axis) of the one sharded dimension of ``spec``, None when the
    leaf is replicated."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            return dim, entry
    return None


def named_specs(cfg: Optional[Gemma2Config] = None) -> Dict[str, Spec]:
    """:func:`param_specs` keyed by the flat leaf names the delta codec
    uses (``"embed"``, ``"layers.q"``, ...)."""
    specs = param_specs(cfg)
    out = {"embed": specs["embed"], "final_norm": specs["final_norm"]}
    out.update({f"layers.{k}": v for k, v in specs["layers"].items()})
    return out


def shard_leaf(name: str, t: torch.Tensor, cfg: Gemma2Config, mesh: Mesh, *,
               stacked: bool = True) -> torch.Tensor:
    """This rank's slice of leaf ``name`` (flat name, ``"layers.q"``).
    ``stacked=False`` takes one layer's slice of a layer leaf (the leading
    ``[L]`` axis already indexed away).  A copy, so the full leaf can go."""
    split = leaf_split(named_specs(cfg)[name])
    if split is None:
        return t
    dim, axis = split
    if name.startswith("layers.") and not stacked:
        dim -= 1
    n = mesh.shape[axis]
    if n == 1:
        return t
    size = local_shard_size(t.shape[dim], mesh, axis)
    return t.narrow(dim, mesh.axis_index(axis) * size, size).contiguous().clone()


def check_tp(cfg: Gemma2Config, mesh: Any) -> None:
    """Refuse a tp that splits a head: the query and kv heads (JAX's
    kv-page placement replicates undivided kv heads; a rank here holds
    whole heads only) and the vocabulary must divide tp."""
    tp = tp_size(mesh)
    for what, n in (("num_heads", cfg.num_heads),
                    ("num_kv_heads", cfg.num_kv_heads),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"{what}={n} not divisible by tp={tp}")


def shard_params(params: Params, cfg: Gemma2Config, mesh: Mesh) -> Params:
    """This rank's shard of every leaf per :func:`param_specs`, leaf by
    leaf (JAX's ``shard_params`` places the same blocks on devices)."""
    check_tp(cfg, mesh)
    return {
        "embed": shard_leaf("embed", params["embed"], cfg, mesh),
        "final_norm": params["final_norm"],
        "layers": {k: shard_leaf(f"layers.{k}", v, cfg, mesh)
                   for k, v in params["layers"].items()},
    }


def vocab_mesh(params: Params, cfg: Gemma2Config) -> Optional[Mesh]:
    """The mesh a model's params are vocab-sharded over, or None when they
    hold the whole vocabulary.  Sharded params carry their sharding in
    their shapes (as JAX arrays carry theirs); their collectives run over
    the process's :func:`active` mesh, whose tp must match."""
    v_local = params["embed"].shape[0]
    if v_local == cfg.vocab_size:
        return None
    mesh = active()
    if mesh is None or tp_size(mesh) * v_local != cfg.vocab_size:
        raise RuntimeError(
            f"params hold {v_local} of {cfg.vocab_size} vocab rows but the "
            f"active mesh is {mesh}; build the mesh (make_mesh) first")
    return mesh


def param_shapes(cfg: Gemma2Config) -> Params:
    """The param tree as ``meta`` tensors (shapes and dtypes, no memory):
    placement math before any weight exists."""
    D, F = cfg.hidden_size, cfg.intermediate_size
    H, K, Dh, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers

    def m(*shape: int) -> torch.Tensor:
        return torch.empty(shape, dtype=cfg.storage_dtype, device="meta")

    return {"embed": m(cfg.vocab_size, D), "final_norm": m(D),
            "layers": {"input_norm": m(L, D), "post_attn_norm": m(L, D),
                       "pre_ffn_norm": m(L, D), "post_ffn_norm": m(L, D),
                       "q": m(L, D, H * Dh), "k": m(L, D, K * Dh),
                       "v": m(L, D, K * Dh), "o": m(L, H * Dh, D),
                       "gate": m(L, D, F), "up": m(L, D, F),
                       "down": m(L, F, D)}}


def _mesh_shape(mesh: Any) -> Dict[str, int]:
    return dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)


def _leaves(tree: Any, specs: Any):
    """(tensor, spec) pairs of a tree of dicts, lists and tuples of tensors;
    ``specs`` mirrors its dicts and lists, or is one spec for a subtree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, specs.get(k) if isinstance(specs, dict)
                               else specs)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, specs[i] if isinstance(specs, list)
                               else specs)
    elif isinstance(tree, torch.Tensor):
        yield tree, specs


def per_device_bytes(shapes: Any, specs: Any = None,
                     mesh: Any = None) -> int:
    """Bytes of storage per rank under a sharding policy.  ``shapes`` is a
    tree of tensors (``meta`` tensors from :func:`param_shapes` allocate
    nothing); ``specs`` a matching tree of :data:`Spec` tuples; ``mesh`` a
    :class:`Mesh` or its shape dict.  Without specs or mesh: the whole
    (replicated) bytes."""
    shape = _mesh_shape(mesh) if mesh is not None else {}
    total = 0
    for t, spec in _leaves(shapes, specs):
        n = int(np.prod(tuple(t.shape))) * t.element_size()
        div = 1
        if shape and isinstance(spec, tuple):
            for entry in spec:
                if entry is not None:
                    div *= shape[entry]
        total += n // div
    return total


def dp_pad(mesh: Optional[Mesh], rows: int) -> int:
    """Rows to append so ``rows`` divides the mesh's dp axis (0 without a
    mesh or dp): pad with :func:`pad_rows`, split, strip every per-row
    output back to ``rows``."""
    if mesh is None:
        return 0
    dp = mesh.shape.get("dp", 1)
    return (-rows) % dp if dp > 1 else 0


def pad_rows(x: Any, pad: int) -> Any:
    """Repeat the last row ``pad`` times along axis 0 (numpy or torch);
    ``pad == 0`` returns ``x`` untouched."""
    if not pad:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)


def dp_rows(mesh: Optional[Mesh], rows: int) -> slice:
    """This rank's block of ``rows`` along the batch.  ``rows`` must divide
    dp: pad with :func:`dp_pad` / :func:`pad_rows` first."""
    if mesh is None or mesh.shape.get("dp", 1) == 1:
        return slice(0, rows)
    dp = mesh.shape["dp"]
    if rows % dp:
        raise ValueError(
            f"{rows} rows do not divide the mesh's dp={dp}; pad the row axis "
            "(parallel.mesh.dp_pad / pad_rows) before placing it")
    per = rows // dp
    i = mesh.axis_index("dp")
    return slice(i * per, (i + 1) * per)


# ---------------------------------------------------------------------------
# The tp readouts: local work on this rank's vocab rows, a small merge.
# ---------------------------------------------------------------------------

def tp_topk(local_vals: torch.Tensor, k: int, mesh: Mesh, *,
            shard_size: int, axis: str = "tp"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over a last axis sharded across ``axis``: a local top-k,
    then an all-gather of the k candidates per shard and a top-k of those
    (O(k * tp) bytes instead of O(V)).  Ties go to the lowest global id, as
    ``lax.top_k`` over the gathered candidates does.  Returns (vals, ids
    int64)."""
    lv, li = topk_lowest_id(local_vals, k)
    gi = li.long() + mesh.axis_index(axis) * shard_size
    av = mesh.all_gather(lv, axis, dim=-1)
    ai = mesh.all_gather(gi, axis, dim=-1)
    mv, mi = topk_lowest_id(av, k, ids=ai)
    return mv, mi.long()


def tp_argmax(mesh: Mesh, x: torch.Tensor, embed: torch.Tensor, *,
              compute_dtype: torch.dtype,
              cap: Optional[float] = None) -> torch.Tensor:
    """Greedy readout over the tp-sharded vocab: ``argmax(x @ E^T)`` with
    ``x [..., D]`` final-normed and ``embed`` this rank's ``[V/tp, D]``
    rows.  Each logit is the contraction the unsharded readout computes,
    and the k = 1 merge picks the globally first index, as ``torch.argmax``
    does.  ``cap`` (monotone) cannot move the argmax.  int64 ids."""
    shard = embed.shape[0]
    ll = plain_logits(x, embed, cap, dtype=compute_dtype)
    _, ids = tp_topk(ll, 1, mesh, shard_size=shard)
    return ids[..., 0]


def tp_lens_pick(mesh: Mesh, x: torch.Tensor, embed: torch.Tensor, *,
                 compute_dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded ``speculate.lens_pick(with_margin=True)``: the draft head's
    token and the top1 - top2 lens-logit margin from per-shard top-2
    candidates (2 tp candidates always hold the global top 2).  Returns
    (tok int64, margin f32) with ``x``'s row shape."""
    ll = plain_logits(x, embed, dtype=compute_dtype)
    vals, ids = tp_topk(ll, 2, mesh, shard_size=embed.shape[0])
    return ids[..., 0], (vals[..., 0] - vals[..., 1]).float()


def tp_lens_prob(mesh: Mesh, x: torch.Tensor, embed: torch.Tensor,
                 targets: torch.Tensor, *,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """``P(target)`` under the tp-sharded lens softmax: ``m = pmax(local
    max)``, ``s = psum(sum exp(ll - m))``, the target's logit summed from
    the one shard that holds it.  ``targets`` must lie in ``[0, V)``."""
    shard = embed.shape[0]
    ll = plain_logits(x, embed, dtype=compute_dtype)
    m = mesh.pmax(ll.max(dim=-1).values, "tp")
    s = mesh.all_reduce(torch.exp(ll - m[..., None]).sum(dim=-1), "tp")
    lse = m + torch.log(s)
    local_t = targets.long() - mesh.axis_index("tp") * shard
    inside = (local_t >= 0) & (local_t < shard)
    picked = torch.gather(ll, -1, local_t.clamp(0, shard - 1)[..., None])[..., 0]
    picked = mesh.all_reduce(torch.where(inside, picked,
                                         torch.zeros_like(picked)), "tp")
    return torch.exp(picked - lse)


def tp_lens_stats(mesh: Mesh, x: torch.Tensor, embed: torch.Tensor,
                  target_id: Any, *, top_k: int = 5,
                  logit_cap: Optional[float] = None) -> LensStats:
    """The lens statistics of ``x [N, D]`` over the whole vocabulary from
    this rank's ``embed [V/tp, D]``: per-shard partials (the lens kernel
    on CUDA tensors, their plain version over one chunk on CPU tensors,
    whose shard need not be whole kernel tiles; a top-k above the kernels'
    lists certified per shard first, as one chunk), targets
    shifted into the shard (-1 outside it) and candidate ids offset back,
    one all-gather of the packed partials, and ``merge_partials`` — the
    same :class:`LensStats` as one call over the whole vocabulary."""
    n = x.shape[0]
    shard = embed.shape[0]
    base = mesh.axis_index("tp") * shard
    t = torch.as_tensor(target_id, device=x.device).long()
    t = t.expand(n) if t.dim() == 0 else t
    local = t - base
    inside = (t >= 0) & (local >= 0) & (local < shard)
    local = torch.where(inside, local, torch.full_like(local, -1))
    if x.is_cuda:
        parts = lens_stats_partials(x.contiguous(), embed.contiguous(),
                                    local.to(torch.int32), top_k=top_k,
                                    logit_cap=logit_cap)
    else:
        parts = lens_stats_partials_reference(
            x, embed, local, whole_plan(shard), top_k=top_k,
            logit_cap=logit_cap)
    ids = parts.cand_ids.float() + float(base)   # ids < 2**24: exact in f32
    packed = torch.cat([parts.chunk_max[..., None],
                        parts.chunk_sumexp[..., None],
                        parts.chunk_tgt[..., None], parts.cand_vals, ids],
                       dim=-1)
    packed = mesh.all_gather(packed, "tp", dim=0)
    k = top_k
    return merge_partials(LensPartials(
        chunk_max=packed[..., 0], chunk_sumexp=packed[..., 1],
        chunk_tgt=packed[..., 2], cand_vals=packed[..., 3:3 + k],
        cand_ids=packed[..., 3 + k:].round().to(torch.int32)))


# ---------------------------------------------------------------------------
# Serving placement.
# ---------------------------------------------------------------------------

def kv_page_spec(num_kv_heads: int, mesh: Optional[Mesh]) -> Spec:
    """Serving KV-page spec for ``[L, S, C, K, Dh]``: slots on dp, kv heads
    on tp when divisible, else replicated over tp."""
    if mesh is None:
        return ()
    heads = ("tp" if tp_size(mesh) > 1 and num_kv_heads % tp_size(mesh) == 0
             else None)
    return (None, "dp", None, heads, None)


def _spec_divides(shape: Tuple[int, ...], spec: Spec, mesh: Any) -> bool:
    sizes = _mesh_shape(mesh)
    return all(entry is None or dim % sizes[entry] == 0
               for dim, entry in zip(shape, spec))


def bank_specs(cfg: Optional[Gemma2Config], bank: Dict[str, Dict[str, Any]],
               mesh: Any) -> Dict[str, Dict[str, Spec]]:
    """Specs of a stacked delta bank (``runtime.delta.stack_bank``): each
    payload field keeps its base leaf's placement past the leading ``[W]``
    word axis (``q``/``bits`` the leaf's spec, a 2-D ``scale`` its last
    entry); a field whose shape does not divide the mesh replicates."""
    named = named_specs(cfg)
    out: Dict[str, Dict[str, Spec]] = {}
    for name, fields in bank.items():
        leaf_spec = named.get(name, ())
        fspecs: Dict[str, Spec] = {}
        for field, arr in fields.items():
            ndim = int(getattr(arr, "ndim", 0))
            if field in ("q", "bits") and ndim == len(leaf_spec) + 1:
                cand: Spec = (None, *leaf_spec)
            elif field == "scale" and ndim == 2 and len(leaf_spec):
                cand = (None, leaf_spec[-1])
            else:
                cand = ()
            if not _spec_divides(tuple(arr.shape), cand, mesh):
                cand = ()
            fspecs[field] = cand
        out[name] = fspecs
    return out


def shard_bank(bank: Dict[str, Dict[str, torch.Tensor]],
               mesh: Mesh) -> Dict[str, Dict[str, torch.Tensor]]:
    """This rank's slice of every bank field per :func:`bank_specs`."""
    specs = bank_specs(None, bank, mesh)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, fields in bank.items():
        out[name] = {}
        for field, arr in fields.items():
            split = leaf_split(specs[name][field])
            if split is None or not isinstance(arr, torch.Tensor):
                out[name][field] = arr
                continue
            dim, axis = split
            size = arr.shape[dim] // mesh.shape[axis]
            out[name][field] = arr.narrow(
                dim, mesh.axis_index(axis) * size, size).contiguous().clone()
    return out


def serve_plan_bytes(cfg: Gemma2Config, *, slots: int, kv_cols: int,
                     trash_cols: int = 0,
                     bank: Optional[Dict[str, Dict[str, Any]]] = None,
                     state: Any = None,
                     mesh: Any = None) -> Dict[str, int]:
    """Per-rank byte plan of one resident serve engine under the mesh:
    params, the delta bank, the KV pages (with a speculative engine's trash
    columns) and the slot state, split into ``fixed_bytes`` (params + bank)
    and ``per_slot_bytes`` (KV page + slot state), plus ``kv_col_bytes``.
    All counts are PER RANK (JAX: per device)."""
    params_b = per_device_bytes(param_shapes(cfg), param_specs(cfg), mesh)
    bank_b = 0
    if bank:
        bspecs = bank_specs(cfg, bank, mesh) if mesh is not None else None
        bank_b = per_device_bytes(bank, bspecs, mesh)
    cols = kv_cols + trash_cols
    kv = torch.empty((cfg.num_layers, slots, cols, cfg.num_kv_heads,
                      cfg.head_dim), dtype=cfg.compute_dtype, device="meta")
    valid = torch.empty((slots, cols), dtype=torch.bool, device="meta")
    kv_spec = kv_page_spec(cfg.num_kv_heads, mesh) if mesh is not None else ()
    cache_b = per_device_bytes(
        {"k": kv, "v": kv, "valid": valid},
        {"k": kv_spec, "v": kv_spec,
         "valid": ("dp", None) if mesh is not None else ()}, mesh)
    state_b = 0
    if state is not None:
        leaves = [t for t, _ in _leaves(state, None)
                  if isinstance(t, torch.Tensor)]
        row = ("dp",) if mesh is not None else ()
        state_b = per_device_bytes(
            leaves, [row + (None,) * (t.dim() - 1) if row else ()
                     for t in leaves], mesh)
    per_slot = (cache_b + state_b) // max(1, slots)
    return {
        "params_bytes": params_b,
        "bank_bytes": bank_b,
        "fixed_bytes": params_b + bank_b,
        "cache_bytes": cache_b,
        "state_bytes": state_b,
        "kv_col_bytes": cache_b // max(1, slots * cols),
        "per_slot_bytes": per_slot,
        "slots": int(slots),
        "kv_cols": int(kv_cols),
        "trash_cols": int(trash_cols),
        "total_bytes": params_b + bank_b + cache_b + state_b,
    }
