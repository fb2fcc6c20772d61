"""``perf/capture_threads.py``: every mode is a suspect call either beside
a capture or inside one, and the tool refuses to run without a CUDA card
(here, the CPU)."""

import torch

from taboo_brittleness_tpu_torch.perf import capture_threads


def test_modes_are_split_beside_and_inside():
    assert "device_sync" in capture_threads.BESIDE
    assert "stream_sync" in capture_threads.BESIDE
    assert "lease_keeper" in capture_threads.BESIDE
    assert set(capture_threads.INSIDE) == {"del_graph", "event_query"}
    assert not set(capture_threads.BESIDE) & set(capture_threads.INSIDE)


def test_exits_nonzero_without_a_card(capsys):
    assert not torch.cuda.is_available()
    assert capture_threads.main([]) == 2
    assert "no CUDA card" in capsys.readouterr().err


def test_lease_keeper_mode_renews_without_a_card(tmp_path):
    """The ``lease_keeper`` mode's thread body: a replica's keeper renewing
    its leases until told to stop, then dropping them (no CUDA call)."""
    import threading

    stop = threading.Event()
    t = threading.Thread(target=capture_threads._lease_keeper, args=(stop,))
    t.start()
    stop.wait(0.5)
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert not torch.cuda.is_initialized()
