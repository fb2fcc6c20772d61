"""tbx-check for the port: the static-analysis gate of the JAX package's
``analysis/``, in PyTorch's idiom.

The port lives or dies on the same hazards as the JAX package, in another
form: a host sync inside a step that a CUDA graph replays serializes the
card (or invalidates the capture), one ``[L, S, V]`` f32 slab is ~1.16 GB
per prompt at Gemma-2's vocabulary, and an unseeded draw in a replayed step
is frozen into the graph.  This package keeps those hazard classes out of
the port as it grows:

- ``core``     — findings, ``# tbx: <rule>-ok`` suppression pragmas, and the
                 per-module AST context (imports, the roots of replayed
                 steps, their reach).
- ``rules``    — the TBX001..TBX010 AST rules in the port's idiom (TBX003 and
                 TBX004 are JAX-only: the port has no ``jax.jit``).
- ``conc``     — the whole-program host-concurrency pass (TBX201..TBX206).
- ``deep``     — the dispatch-level pass: runs the 19 registered entry
                 points eagerly at a tiny config under a ``TorchDispatchMode``
                 and flags widening f32 conversions on vocab-carrying tensors
                 (TBX101; TBX100 when an entry fails to run).
- ``baseline`` — fingerprint engine so known findings can be ratcheted.
- ``cli``      — ``python -m taboo_brittleness_tpu_torch.analysis [--deep]
                 [--baseline FILE] [paths...]``; exit 0 iff clean.

Import surface is stdlib-only unless ``--deep`` is requested (the deep pass
imports torch lazily), so the gate costs milliseconds.
"""

from taboo_brittleness_tpu_torch.analysis.core import Finding, analyze_file  # noqa: F401
from taboo_brittleness_tpu_torch.analysis.cli import main, run_check  # noqa: F401
from taboo_brittleness_tpu_torch.analysis.rules import RULES  # noqa: F401
