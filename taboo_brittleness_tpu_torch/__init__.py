"""PyTorch/CUDA port of ``taboo_brittleness_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module paths
and function names (``models.gemma2``, ``ops.lens``, ``runtime.decode``,
``pipelines.generation`` ...) so a reader finds each counterpart.  It imports
``torch`` and never ``jax``, and nothing of the JAX package: the few plain
Python modules it needs (config, metrics, chat, tokenizer, cache, resilience)
are kept here as copies.

Entry points that create tensors (``models.gemma2.init_params``, the loaders
in ``models.params`` and ``runtime.checkpoints``, the CLI) take a ``device``;
left unset it is ``cuda``, and they raise when CUDA is absent.  Functions
over existing params run on the params' device.  On CUDA tensors the lens
readout runs the hand-written kernel ``csrc/lens_stats.cu``; on CPU tensors
it runs that kernel's plain PyTorch version.
"""
