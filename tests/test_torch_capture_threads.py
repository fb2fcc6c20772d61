"""``perf/capture_threads.py``: every mode is a suspect call either beside
a capture or inside one, and the tool refuses to run without a CUDA card
(here, the CPU)."""

import torch

from taboo_brittleness_tpu_torch.perf import capture_threads


def test_modes_are_split_beside_and_inside():
    assert "device_sync" in capture_threads.BESIDE
    assert "stream_sync" in capture_threads.BESIDE
    assert set(capture_threads.INSIDE) == {"del_graph", "event_query"}
    assert not set(capture_threads.BESIDE) & set(capture_threads.INSIDE)


def test_exits_nonzero_without_a_card(capsys):
    assert not torch.cuda.is_available()
    assert capture_threads.main([]) == 2
    assert "no CUDA card" in capsys.readouterr().err
