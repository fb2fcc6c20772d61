"""The rank layer's device: ``device=None`` means ``cuda`` in the
process-group join, the mesh and the CLI, as in every other entry point of
the port (``taboo_brittleness_tpu_torch.device``).  The JAX package's
``parallel/multihost.initialize`` joins the platform's own devices; here a
rank left without a device joins on the card, picks its backend from the
ranks and cards of its host, and takes card ``LOCAL_RANK % device_count``.

No real process group: ``torch.cuda`` and ``torch.distributed`` are
replaced by fakes for a host of a given number of cards.
"""

import types

import pytest
import torch
import torch.distributed as dist

from taboo_brittleness_tpu_torch import cli
from taboo_brittleness_tpu_torch.config import MeshConfig
from taboo_brittleness_tpu_torch.parallel import mesh as meshlib
from taboo_brittleness_tpu_torch.parallel import multihost


@pytest.fixture
def host(monkeypatch):
    """``host(cards)``: fake a host of ``cards`` cards (0: no CUDA) and a
    process group that records its backend without joining; returns the
    calls made."""
    calls = {"set_device": [], "init": []}

    def make(cards: int) -> dict:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        monkeypatch.setattr(torch.cuda, "set_device",
                            calls["set_device"].append)
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: calls["init"].append(backend))
        # A CPU join sets one intra-op thread: keep the test process's.
        monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
        monkeypatch.setattr(multihost, "_DEVICE", None)
        monkeypatch.setattr(meshlib, "_ACTIVE", None)
        return calls

    return make


def _as_group(monkeypatch, world: int, rank: int, backend: str) -> None:
    """Make ``torch.distributed`` report a joined group of ``world``."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: world)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: rank)
    monkeypatch.setattr(dist, "get_backend", lambda *a, **k: backend)
    monkeypatch.setattr(dist, "new_group", lambda *a, **k: object())


@pytest.mark.parametrize(
    "device,cards,world,local_rank,backend,card,reason,staging", [
        (None, 4, 4, 2, "nccl", 2, "4 ranks on 4 cards, one each", "device"),
        (None, 1, 2, 1, "gloo", 0, "2 ranks share 1 card", "host"),
        (None, 4, 8, 5, "gloo", 1, "8 ranks share 4 card(s)", "host"),
        ("cpu", 4, 2, 1, "gloo", None, "CPU ranks", "device"),
        (None, 0, 2, 0, None, None, None, None),
    ], ids=["one-card-each", "two-share-one", "eight-share-four", "cpu",
            "no-cuda"])
def test_join_resolves_the_device(host, monkeypatch, device, cards, world,
                                  local_rank, backend, card, reason, staging):
    """``_join`` with ``device`` on a host of ``cards``: the backend, the
    card the rank takes and the reason, then the mesh of that rank, made
    with no device, on the device it joined with.  Without CUDA the join
    raises before any process group is made."""
    calls = host(cards)
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(world))
    if backend is None:
        with pytest.raises(RuntimeError, match="cuda"):
            multihost._join("file:///unused", world, local_rank, device)
        assert calls["init"] == [] and calls["set_device"] == []
        assert multihost.joined_device() is None
        return
    assert multihost._join("file:///unused", world, local_rank, device)
    assert calls["init"] == [backend]
    assert calls["set_device"] == ([] if card is None else [card])
    want = torch.device("cpu") if card is None else torch.device("cuda", card)
    assert multihost.joined_device() == want

    _as_group(monkeypatch, world, local_rank, backend)
    mesh = meshlib.make_mesh(MeshConfig(dp=-1, tp=2, sp=1))
    record = mesh.record()
    assert mesh.device == want and meshlib.active() is mesh
    assert record["backend"] == backend and record["staging"] == staging
    assert reason in record["reason"]
    if card is not None:
        assert "CPU" not in record["reason"]
    assert ("collectives staged through the host" in record["reason"]) == (
        staging == "host")


@pytest.mark.parametrize("cards", [0, 1], ids=["no-cuda", "one-card"])
def test_mesh_alone_resolves_the_device(host, cards):
    """A mesh with no process group and no device is on ``cuda``, and
    raises where CUDA is absent (it never falls back to the CPU)."""
    host(cards)
    if not cards:
        with pytest.raises(RuntimeError, match="cuda"):
            meshlib.make_mesh(MeshConfig())
        return
    mesh = meshlib.make_mesh(MeshConfig())
    assert mesh.size == 1 and mesh.device == torch.device("cuda")
    assert mesh.staging == "device"


@pytest.mark.parametrize("flag,want", [(None, "cuda"), ("cpu", "cpu")],
                         ids=["unset", "cpu"])
def test_cli_join_ranks_hands_the_resolved_device(host, monkeypatch, flag,
                                                  want):
    """``--device`` unset reaches ``initialize`` as ``cuda``, the device
    the command's mesh is made on; ``--device cpu`` as the CPU."""
    host(1)
    got = []
    monkeypatch.setattr(multihost, "in_group", lambda: True)
    monkeypatch.setattr(multihost, "initialize",
                        lambda **kw: got.append(kw["device"]))
    cli._join_ranks(2, types.SimpleNamespace(device=flag, argv=[]))
    assert got == [torch.device(want)]
