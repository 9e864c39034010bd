"""PyTorch/CUDA port of the adversarial-spec inference substrate.

The JAX package ``adversarial_spec_tpu`` is the reference; this package
serves the same ``tpu://`` model ids on an NVIDIA Hopper GPU. Module paths
mirror the reference so each counterpart is easy to find:

- ``models/``  — model configs and the decoder-only transformer;
- ``ops/``     — rope, the online-softmax block update, the decode
  attention kernels, weight quantization and the dequant-matmul kernels
  (hand-written CUDA in ``csrc/``, built on first use by
  ``ops/_build.py``);
- ``engine/``  — sampling, speculative decoding, ``generate()``, the
  registry, tokenizer, loader, the ``GpuEngine`` and provider dispatch.

The package imports torch, numpy and the standard library only: never
jax, and nothing from the reference package.
"""

__version__ = "0.1.0"
