"""Gemma-Scope grid sweeps and closed-loop attack search.

The paper reads one SAE (16k wide, layer 31) per word; Gemma Scope ships
SAEs at every layer and several widths, turning the brittleness question
into a depth x width grid.

- :mod:`~taboo_brittleness_tpu_torch.grid.spec` — the grid schema: which
  (layer, width) readout cells exist, where their converted SAE artifacts
  live, and which residual tap layers one decode must capture.
- :mod:`~taboo_brittleness_tpu_torch.grid.runner` — capture-once
  execution: decode each word once tapping every grid layer in one
  graphed program, then fan encode -> top latents -> ablate -> decode ->
  score per cell as fleet ``(word, readout_config)`` units.
- :mod:`~taboo_brittleness_tpu_torch.grid.search` — the seeded
  evolutionary attack search riding ``serve.loadgen.run_inprocess``
  against an engine; emits the breakage matrix.

The PyTorch port of the JAX package's ``grid/``, with the same artifact
and spool schemas.
"""

from taboo_brittleness_tpu_torch.grid.spec import (  # noqa: F401
    GRID_ARTIFACT_VERSION, CellSpec, GridSpec)
