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
readout runs one of the hand-written kernels under ``csrc/``
(``ops.lens_kernel.lens_plan`` picks it: the split-V kernel for a few rows,
the wgmma kernel for more; a top-k above 32 in certified passes of either);
on CPU tensors it runs their plain PyTorch version.
"""
